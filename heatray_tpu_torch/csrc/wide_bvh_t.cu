// Arity-8 BVH traversal with the leaf test spread across a warp's lanes:
// closest hit and any hit, over leaves of 128 triangles or a multiple of it.
//
// K5a `closest_wide_t_kernel`, K5b `any_wide_t_kernel` replace the Pallas
// TPU kernels `_closest_kernel_t` and `_any_kernel_t` of
// heatray_tpu/ops/wide_bvh.py (`wide_leaf_math="vpu"`).  K4a
// `closest_stream_t_kernel`, K4b `any_stream_t_kernel` replace
// `_closest_stream_kernel_t` and `_any_stream_kernel_t`
// (`stream_leaf_math="vpu"`).  On the TPU, "VPU leaf math" is a layout: a
// ray tile walks the tree in the row layout, and each live leaf is tested as
// one transposed (rays x 3 Tc) broadcast tile with the leaf's triangles
// across the lanes (`_pair_hits_t`), which is why Tc must be a multiple of
// 128.  On the card the transposed layout becomes a warp that tests a leaf
// against the rays that enter it, its triangles spread over the 32 lanes,
// and a ray whose own widened slab misses the leaf (or one of its blocks of
// 32) costs that leaf nothing.
//
// All four run the walk per ray of K1 (wide_bvh_walk.cuh, `closest_walk` /
// `any_walk`: each thread walks its own ray with its own stack of 64, near
// to far by its own direction; for closest hit its pending leaves are
// re-culled against its own best) with `BlockServe`, a leaf of 128 (or 256,
// 384, ...) served block of 32 by block: before each block the warp takes
// the ballot of the offering lanes whose ray enters that block's box (the
// tree's `blocks`, one per run of 32 slots, world coordinates, widened as
// every box is, inverted over padding and over emptied alpha-masked
// triangles, and never entered) before its current best, or for any hit
// before its t_max while it has no hit yet; it skips a block no lane
// enters, and serves the rest with K1's 32-lane block services
// (`serve_cols_closest`: one triangle per lane in registers, a ray at a time
// or ray per lane for groups above kLaneRays; `serve_cols_any`, the service
// of K2 and K7b).  A shadow ray's leaves come in the walk's own order with
// no re-cull (its far end does not move), and a blocked ray ends its walk at
// its first hit.
//
// K5a and K4a run the same loop and service over different trees, and so do
// K5b and K4b.  That is right on this card: the reference's split between
// the `"wide"` and the `"stream"` backends (leaves of 32 against 128, the
// 250k-triangle switch) is a budget of the TPU's vector memory, not a limit
// of the H100, and K1 and K3 already share `closest_walk`.
//
// What K4 replaced, and why: the block walk of the TPU's streaming kernels
// (wide_bvh_block.cuh, which the P3 and P2 probes still run): one block of
// 256 rays walked the tree together, a node visited and each of its live
// leaves staged by cp.async into 8 shared-memory slots (48 KB a block at
// leaf 128, half the SM's occupancy) if any of the 256 rays entered it,
// near to far by the block's summed direction, three barriers a node, and
// each staged leaf tested whole (128 pair tests) on every ray of a warp
// that entered it.  On incoherent bounce rays it visited the union of 256
// rays' paths.  It took 0.9518 ms (K4a) and 1.1003 ms (K4b) on `high_poly`'s
// 2,073,600 primary rays and first-bounce shadow lanes, NVIDIA H100 80GB
// HBM3, 700.00 W (PERF.md section 6), where K3 took 0.6944 and 0.2744 over
// the same tree; the block boxes alone cut K5a 2.7x against the same walk
// without them on the Cornell box's leaf-128 tree.
//
// What K5b replaced: the same group walk at a warp's width (the TPU walks a
// 512-ray tile), its stack in shared memory, the node order from the warp's
// summed direction, a child visited if any of its 32 rays entered it, and
// every live leaf tested whole, one ray at a time across the lanes, on every
// unblocked ray of the warp that entered its box.  It took 0.7591 ms on the
// Cornell box's 1080p first-bounce shadow lanes (PERF.md section 6), three
// times K2 over leaves of 32 on the same rays.
//
// Numerics: the pair test is K1's (`tri_t`, exact f32, IEEE divide, built
// with --fmad=false); the reference's `_recip_fast` is TPU rounding.  Ties
// in t go to the lowest slot, across blocks and leaves too, so a result
// equals the brute force over the same slot rows bit for bit: the plain
// version.
//
// What bounds them on an H100: latency, not bytes or operations.  Every
// warp step (the node's 8 slab tests, a ballot, a block's pair tests and
// the shuffles around them) is a short chain of dependent instructions and
// loads.  No wgmma pair tests, no TMA, no persistent blocks, no ray
// reordering within a warp.

#include <cuda_runtime.h>

#include "wide_bvh_walk.cuh"

namespace {

using namespace wide_bvh;

// K5's and K4's register cap: K1's (at most 64 registers a thread, 8
// blocks of 128 per SM).
constexpr int kMinBlocks = 8;

__global__ void __launch_bounds__(kWalkThreads, kMinBlocks) closest_wide_t_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz, int n_rays,
    const float* __restrict__ blocks, const float* __restrict__ wbox,
    const int* __restrict__ wchild, const int* __restrict__ waxis,
    const float* __restrict__ w, const float* __restrict__ wanchor, int n_chunks, int tc,
    float t_min, Widen widen, float* __restrict__ t_out, int* __restrict__ slot_out) {
  closest_walk<BlockServe>(ox, oy, oz, dx, dy, dz, n_rays, wbox, wchild, waxis, w, wanchor,
                           n_chunks, tc, t_min, widen, t_out, slot_out, blocks, widen);
}

__global__ void __launch_bounds__(kWalkThreads, kMinBlocks) any_wide_t_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ t_max, int n_rays, const float* __restrict__ blocks,
    const float* __restrict__ wbox, const int* __restrict__ wchild,
    const int* __restrict__ waxis, const float* __restrict__ w,
    const float* __restrict__ wanchor, int n_chunks, int tc, float t_min,
    Widen widen, unsigned char* __restrict__ blocked_out) {
  any_walk<BlockServe>(ox, oy, oz, dx, dy, dz, t_max, n_rays, wbox, wchild, waxis, w, wanchor,
                       n_chunks, tc, t_min, widen, blocked_out, blocks, widen);
}

__global__ void __launch_bounds__(kWalkThreads, kMinBlocks) closest_stream_t_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz, int n_rays,
    const float* __restrict__ blocks, const float* __restrict__ wbox,
    const int* __restrict__ wchild, const int* __restrict__ waxis,
    const float* __restrict__ w, const float* __restrict__ wanchor, int n_chunks, int tc,
    float t_min, Widen widen, float* __restrict__ t_out, int* __restrict__ slot_out) {
  closest_walk<BlockServe>(ox, oy, oz, dx, dy, dz, n_rays, wbox, wchild, waxis, w, wanchor,
                           n_chunks, tc, t_min, widen, t_out, slot_out, blocks, widen);
}

__global__ void __launch_bounds__(kWalkThreads, kMinBlocks) any_stream_t_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ t_max, int n_rays, const float* __restrict__ blocks,
    const float* __restrict__ wbox, const int* __restrict__ wchild,
    const int* __restrict__ waxis, const float* __restrict__ w,
    const float* __restrict__ wanchor, int n_chunks, int tc, float t_min,
    Widen widen, unsigned char* __restrict__ blocked_out) {
  any_walk<BlockServe>(ox, oy, oz, dx, dy, dz, t_max, n_rays, wbox, wchild, waxis, w, wanchor,
                       n_chunks, tc, t_min, widen, blocked_out, blocks, widen);
}

}  // namespace

// Plain C entry points for ctypes.  Each launches on `stream`, does not
// synchronise, and returns the first CUDA error (0 = the launch was
// accepted).  The leaf size must be a multiple of 32 (the wrappers ask for
// 128); `blocks` is (C, leaf_size / 32, 6), the boxes of each leaf's runs
// of 32 slots.

extern "C" int wide_t_stack_depth() { return kStackDepth; }

extern "C" int stream_t_stack_depth() { return kStackDepth; }

extern "C" int closest_wide_t(const float* ox, const float* oy, const float* oz,
                              const float* dx, const float* dy, const float* dz,
                              int n_rays, const float* blocks, const float* wbox,
                              const int* wchild, const int* waxis, const float* w,
                              const float* wanchor, int n_chunks, int leaf_size,
                              float t_min, float box_pad, float far_scale,
                              float* t_out, int* slot_out, void* stream) {
  if (n_rays > 0) {
    closest_wide_t_kernel<<<walk_blocks(n_rays), kWalkThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        ox, oy, oz, dx, dy, dz, n_rays, blocks, wbox, wchild, waxis, w, wanchor,
        n_chunks, leaf_size, t_min, Widen{box_pad, far_scale}, t_out, slot_out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int any_wide_t(const float* ox, const float* oy, const float* oz,
                          const float* dx, const float* dy, const float* dz,
                          const float* t_max, int n_rays, const float* blocks,
                          const float* wbox, const int* wchild, const int* waxis,
                          const float* w, const float* wanchor, int n_chunks,
                          int leaf_size, float t_min, float box_pad, float far_scale,
                          unsigned char* blocked_out, void* stream) {
  if (n_rays > 0) {
    any_wide_t_kernel<<<walk_blocks(n_rays), kWalkThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        ox, oy, oz, dx, dy, dz, t_max, n_rays, blocks, wbox, wchild, waxis, w, wanchor,
        n_chunks, leaf_size, t_min, Widen{box_pad, far_scale}, blocked_out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int closest_stream_t(const float* ox, const float* oy, const float* oz,
                                const float* dx, const float* dy, const float* dz,
                                int n_rays, const float* blocks, const float* wbox,
                                const int* wchild, const int* waxis, const float* w,
                                const float* wanchor, int n_chunks, int leaf_size,
                                float t_min, float box_pad, float far_scale,
                                float* t_out, int* slot_out, void* stream) {
  if (n_rays > 0) {
    closest_stream_t_kernel<<<walk_blocks(n_rays), kWalkThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        ox, oy, oz, dx, dy, dz, n_rays, blocks, wbox, wchild, waxis, w, wanchor,
        n_chunks, leaf_size, t_min, Widen{box_pad, far_scale}, t_out, slot_out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int any_stream_t(const float* ox, const float* oy, const float* oz,
                            const float* dx, const float* dy, const float* dz,
                            const float* t_max, int n_rays, const float* blocks,
                            const float* wbox, const int* wchild, const int* waxis,
                            const float* w, const float* wanchor, int n_chunks,
                            int leaf_size, float t_min, float box_pad, float far_scale,
                            unsigned char* blocked_out, void* stream) {
  if (n_rays > 0) {
    any_stream_t_kernel<<<walk_blocks(n_rays), kWalkThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        ox, oy, oz, dx, dy, dz, t_max, n_rays, blocks, wbox, wchild, waxis, w, wanchor,
        n_chunks, leaf_size, t_min, Widen{box_pad, far_scale}, blocked_out);
  }
  return static_cast<int>(cudaGetLastError());
}
