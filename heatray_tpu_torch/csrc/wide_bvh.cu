// Arity-8 BVH traversal: closest hit (K1) and any hit (K2), one walk per
// ray, each leaf test shared by the warp.
//
// Replaces the Pallas TPU kernels `_closest_kernel` and `_any_kernel` of
// heatray_tpu/ops/wide_bvh.py.  Those walk the tree once per 512-ray tile
// with the tile's aggregate direction sign and test a whole leaf against the
// tile as one MXU contraction.  Here every thread walks the tree for its own
// ray (wide_bvh_walk.cuh, the loop K3 runs too: its own stack, its own
// near-to-far order, pending leaves re-culled against its own best), and the
// warp serves the (ray, leaf) pairs its lanes offer with `LaneServe`
// (`lane_serve_closest` / `lane_serve_any`, wide_bvh_common.cuh): lane j
// holds triangle j of each block of 32 of an offered leaf in 12 registers,
// loaded once for all the lanes that offer that leaf in the round.  A small
// group of such rays is tested one ray after the other, one column per
// lane, the (t, column) minimum a `__reduce_min_sync` of an order-preserving
// key and a ballot; a group of more than 24 (coherent rays) has each lane
// test its own ray against the columns in turn, broadcast from the
// registers by shuffles.  The Cornell box's leaves of 32 are one block; a
// wider leaf (`wide_leaf_size` 64 or 128) is served block by block.
//
// What bounded the thread-serial design it replaces (one ray per thread,
// each thread testing all the triangles of every leaf it entered, 12 scalar
// loads each): on bounce rays a leaf is entered by 2-5% of a tile's rays,
// so the warp ran each lane's 32-triangle loop in turn; that walk alone
// (chip_smoke.py phase 17's P1 `nodes`, which still times it) took
// 0.085-0.088 of its 0.46 ms on the primary rays.  Here a leaf costs one
// coalesced load per Woop row per (warp, leaf, block, round) and, per ray
// that enters it, one lane-parallel pair test or, in a large group, that
// ray's own pass over the columns.
//
// What bounds it on an H100 (80GB HBM3, 700 W; chip_smoke.py phase 4, the
// Cornell box's leaf-32 tree): latency, as for K3.  K1 takes 0.39 ms on the
// 2,073,600 primary rays and 0.59 ms on the 1,814,400 lanes of the sorted
// depth-2 head, 20x and 30x its bound (the rays and the tree they reach at
// 3.35 TB/s; the head's pair-test operations at 67 TFLOP/s); K2 0.24 and
// 0.25 ms on their shadow lanes, 13x and 16x.  Each round of a warp is a
// chain of dependent steps (a node's 8 boxes, a match and a ballot, 12 loads,
// then per ray shuffles, the pair test and a reduction), at 63-64 registers
// a thread.  How the time splits between the walk and the leaf service is
// not measured.
// What is left for later: persistent warps, staging the nodes, and the
// launches themselves: a pass is host-bound, so K1/K2 move its kernel time,
// not its wall.
//
// What the card's other features would do here, and why they are not used:
// - tensor cores (`wgmma`, TF32): the pair test is exact float32 with
//   separately rounded products (--fmad=false), which TF32's 10 mantissa
//   bits cannot give;
// - shared memory or TMA staging of leaves: a leaf of 32 is 1,536 bytes,
//   12 registers a lane; the Cornell box's 171 leaves (263 KB) exceed the
//   227 KB a block may take and stay in L1/L2 anyway;
// - persistent warps that fetch a new ray when a lane's walk ends: not
//   tried.
//
// Numerics, layouts and the slab and pair tests: wide_bvh_common.cuh.  Ties
// in t go to the lowest slot, across leaves too, so the result equals the
// brute force over the same slot rows bit for bit: the plain version.

#include <cuda_runtime.h>

#include "wide_bvh_walk.cuh"

namespace {

using namespace wide_bvh;

// At most 64 registers a thread (8 blocks of 128 per SM): uncapped, the
// ray-per-lane branch of `lane_serve_closest` takes 72 and K1 is 3% slower
// (profile_torch_wide.py, variant `uncapped`).
constexpr int kMinBlocks = 8;

__global__ void __launch_bounds__(kWalkThreads, kMinBlocks) closest_wide_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz, int n_rays,
    const float* __restrict__ wbox, const int* __restrict__ wchild,
    const int* __restrict__ waxis, const float* __restrict__ w,
    const float* __restrict__ wanchor, int n_chunks, int tc, float t_min,
    Widen widen, float* __restrict__ t_out, int* __restrict__ slot_out) {
  closest_walk<LaneServe>(ox, oy, oz, dx, dy, dz, n_rays, wbox, wchild, waxis, w, wanchor,
                          n_chunks, tc, t_min, widen, t_out, slot_out);
}

__global__ void __launch_bounds__(kWalkThreads, kMinBlocks) any_wide_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ t_max, int n_rays,
    const float* __restrict__ wbox, const int* __restrict__ wchild,
    const int* __restrict__ waxis, const float* __restrict__ w,
    const float* __restrict__ wanchor, int n_chunks, int tc, float t_min,
    Widen widen, unsigned char* __restrict__ blocked_out) {
  any_walk<LaneServe>(ox, oy, oz, dx, dy, dz, t_max, n_rays, wbox, wchild, waxis, w, wanchor,
                      n_chunks, tc, t_min, widen, blocked_out);
}

}  // namespace

// Plain C entry points for ctypes.  Each launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 = the launch was accepted).

extern "C" int wide_bvh_stack_depth() { return kStackDepth; }

extern "C" int closest_wide(const float* ox, const float* oy, const float* oz,
                            const float* dx, const float* dy, const float* dz,
                            int n_rays, const float* wbox, const int* wchild,
                            const int* waxis, const float* w,
                            const float* wanchor, int n_chunks, int leaf_size,
                            float t_min, float box_pad, float far_scale,
                            float* t_out, int* slot_out, void* stream) {
  if (n_rays > 0) {
    closest_wide_kernel<<<walk_blocks(n_rays), kWalkThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        ox, oy, oz, dx, dy, dz, n_rays, wbox, wchild, waxis, w, wanchor,
        n_chunks, leaf_size, t_min, Widen{box_pad, far_scale}, t_out, slot_out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int any_wide(const float* ox, const float* oy, const float* oz,
                        const float* dx, const float* dy, const float* dz,
                        const float* t_max, int n_rays, const float* wbox,
                        const int* wchild, const int* waxis, const float* w,
                        const float* wanchor, int n_chunks, int leaf_size,
                        float t_min, float box_pad, float far_scale,
                        unsigned char* blocked_out, void* stream) {
  if (n_rays > 0) {
    any_wide_kernel<<<walk_blocks(n_rays), kWalkThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        ox, oy, oz, dx, dy, dz, t_max, n_rays, wbox, wchild, waxis, w,
        wanchor, n_chunks, leaf_size, t_min, Widen{box_pad, far_scale},
        blocked_out);
  }
  return static_cast<int>(cudaGetLastError());
}
