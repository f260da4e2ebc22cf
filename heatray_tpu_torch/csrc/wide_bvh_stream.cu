// Arity-8 BVH traversal over trees with large leaves (the streaming
// backend's 128 triangles): closest hit and any hit, one walk per ray, each
// leaf test shared by the warp.
//
// Replaces the Pallas TPU kernels `_closest_stream_kernel` and
// `_any_stream_kernel` of heatray_tpu/ops/wide_bvh.py.  Those walk the tree
// once per 256-ray tile and copy each leaf chunk the tile enters by DMA into
// VMEM, where the whole tile tests it: on the TPU the leaf test is one wide
// contraction whatever the number of rays that need it.  On the card a block
// that walks together tests every leaf any of its rays enters with all of
// its rays, and pays two to three block barriers per node.  So here each
// thread walks its own ray and only the leaf test is shared (the loops of
// wide_bvh_walk.cuh, which K1/K2 run too): the warp takes the offered (ray,
// leaf) pairs one by one and tests each with the leaf's triangles spread
// over its 32 lanes (`WarpServe`: `warp_serve_closest` / `warp_serve_any`
// of wide_bvh_common.cuh).
//
// The leaf rows are read from device memory: the whole `w` of a
// 300k-triangle scene (about 21 MB) stays in the 50 MB L2.
//
// Numerics: wide_bvh_common.cuh (`tri_t`, exact f32, IEEE divide, built
// with --fmad=false, the widened slab).  Ties in t go to the lowest slot,
// across leaves too, so the result equals the brute force over the same
// slot rows bit for bit: the plain version.
//
// What bounds it on an H100 (80GB HBM3, 700 W; chip_smoke.py phase 7):
// latency.  On a 1080p high_poly pass K3a takes 0.69 ms on the 2,073,600
// primary rays and 0.41 ms on the 518,400 lanes of the sorted depth-2 head,
// 32x and 48x the time its bytes (the rays, and the nodes and leaves they
// reach, once each) take at 3.35 TB/s; K3b 0.27 and 0.16 ms, 13x and 20x.
// The operations are below the bytes.  Each node visit is a chain of
// dependent loads (the node's 8 boxes, then the stack), and each served
// (ray, leaf) pair a chain of shuffles, loads and a 5-step shuffle
// reduction; K3a's 48 and K3b's 56 registers a thread leave room for 40
// and 36 warps per SM.
// What is left for later: no staging of leaves in shared memory, no
// `wgmma` pair tests, no persistent threads.  K1's service (`LaneServe`,
// several rays against one leaf from registers) is not tried here.

#include <cuda_runtime.h>

#include "wide_bvh_walk.cuh"

namespace {

using namespace wide_bvh;

// The walk of wide_bvh_walk.cuh, each offered (ray, leaf) pair tested by
// the whole warp in turn.
__global__ void __launch_bounds__(kWalkThreads) closest_stream_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz, int n_rays,
    const float* __restrict__ wbox, const int* __restrict__ wchild,
    const int* __restrict__ waxis, const float* __restrict__ w,
    const float* __restrict__ wanchor, int n_chunks, int tc, float t_min,
    Widen widen, float* __restrict__ t_out, int* __restrict__ slot_out) {
  closest_walk<WarpServe>(ox, oy, oz, dx, dy, dz, n_rays, wbox, wchild, waxis, w, wanchor,
                          n_chunks, tc, t_min, widen, t_out, slot_out);
}

__global__ void __launch_bounds__(kWalkThreads) any_stream_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ t_max, int n_rays,
    const float* __restrict__ wbox, const int* __restrict__ wchild,
    const int* __restrict__ waxis, const float* __restrict__ w,
    const float* __restrict__ wanchor, int n_chunks, int tc, float t_min,
    Widen widen, unsigned char* __restrict__ blocked_out) {
  any_walk<WarpServe>(ox, oy, oz, dx, dy, dz, t_max, n_rays, wbox, wchild, waxis, w, wanchor,
                      n_chunks, tc, t_min, widen, blocked_out);
}

}  // namespace

// Plain C entry points for ctypes.  Each launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 = the launch was accepted).

extern "C" int wide_bvh_stream_stack_depth() { return kStackDepth; }

extern "C" int closest_stream(const float* ox, const float* oy, const float* oz,
                              const float* dx, const float* dy, const float* dz,
                              int n_rays, const float* wbox, const int* wchild,
                              const int* waxis, const float* w,
                              const float* wanchor, int n_chunks, int leaf_size,
                              float t_min, float box_pad, float far_scale,
                              float* t_out, int* slot_out, void* stream) {
  if (n_rays > 0) {
    closest_stream_kernel<<<walk_blocks(n_rays), kWalkThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        ox, oy, oz, dx, dy, dz, n_rays, wbox, wchild, waxis, w, wanchor,
        n_chunks, leaf_size, t_min, Widen{box_pad, far_scale}, t_out, slot_out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int any_stream(const float* ox, const float* oy, const float* oz,
                          const float* dx, const float* dy, const float* dz,
                          const float* t_max, int n_rays, const float* wbox,
                          const int* wchild, const int* waxis, const float* w,
                          const float* wanchor, int n_chunks, int leaf_size,
                          float t_min, float box_pad, float far_scale,
                          unsigned char* blocked_out, void* stream) {
  if (n_rays > 0) {
    any_stream_kernel<<<walk_blocks(n_rays), kWalkThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        ox, oy, oz, dx, dy, dz, t_max, n_rays, wbox, wchild, waxis, w,
        wanchor, n_chunks, leaf_size, t_min, Widen{box_pad, far_scale},
        blocked_out);
  }
  return static_cast<int>(cudaGetLastError());
}
