// Binary skip-pointer BVH traversal: closest hit and any hit, one thread
// per ray.
//
// Replaces the Pallas TPU kernels `_closest_kernel` and `_any_kernel` of
// heatray_tpu/ops/traverse_pallas.py.  Those walk the tree once per 512-ray
// tile with one scalar loop and a stack in SMEM: a node is entered when any
// ray of the tile overlaps its box, the near child is chosen from the
// tile's summed direction sign along the node's split axis, and a leaf is
// tested against the whole tile as one MXU contraction.  Here every thread
// walks the tree for its own ray with its own stack of 96 (the reference's
// STACK_DEPTH, which covers the build's depth cap of MAX_SAH_DEPTH +
// log2 T) and its own near-first order, and tests a leaf's triangles in
// exact f32.  The closest hit does not depend on the order and the slab
// test is widened (wide_bvh_common.cuh), so the result is the brute
// force's over the same leaf rows: the plain version.  Ties in t go to the
// lowest slot.
//
// What bounds it on an H100: divergent memory latency, as in the wide
// kernels: each node visit reads a 24-byte box and an 8-byte meta record,
// each leaf visit 48 bytes per triangle, at addresses that differ from lane
// to lane, and a binary tree has about twice the visits of an arity-8 one.
// This simple design does nothing about that yet: no wide nodes, no staged
// leaves, no sorted or persistent wavefronts.
//
// Layouts (heatray_tpu_torch/ops/bvh.py, `BVH`):
//   nbox (N * 6,) f32 [min xyz, max xyz] per node, preorder
//   meta (N * 2,) i32 per node: leaf chunk (>= 0) or -1 - split axis; skip
//   w    (C, 4, 3 Tc) f32 leaf chunks, raw Woop rows (no anchor)

#include <cuda_runtime.h>

#include "wide_bvh_common.cuh"

namespace {

using namespace wide_bvh;

constexpr int kStackDepth = 96;
constexpr int kThreads = 128;

// One step of the walk from a node whose box the ray enters: an internal
// node pushes its far child and returns its near one; a leaf returns -1.
__device__ __forceinline__ int descend(const int* __restrict__ meta, int node,
                                       const Ray& r, int* stack, int& sp) {
  const int code = meta[2 * node];
  if (code >= 0) return -1;
  const int axis = -1 - code;
  const int left = node + 1;
  const int right = meta[2 * left + 1];
  const float d = axis == 0 ? r.dx : (axis == 1 ? r.dy : r.dz);
  const bool left_near = d >= 0.0f;  // left holds the lower coordinates
  stack[sp++] = left_near ? right : left;
  return left_near ? left : right;
}

__global__ void __launch_bounds__(kThreads) closest_bvh_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz, int n_rays,
    const float* __restrict__ nbox, const int* __restrict__ meta,
    const float* __restrict__ w, int tc, float t_min, Widen widen,
    float* __restrict__ t_out, int* __restrict__ slot_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const Ray r = load_ray(ox, oy, oz, dx, dy, dz, i);

  float best = kMissT;
  int best_slot = -1;
  int stack[kStackDepth];
  int sp = 0;
  int node = 0;
  while (node >= 0) {
    int next = -1;
    if (slab(nbox + 6 * node, r, t_min, best, widen)) {
      next = descend(meta, node, r, stack, sp);
      if (next < 0) {
        const int chunk = meta[2 * node];
        const float* W = w + (size_t)chunk * 12 * tc;
        for (int j = 0; j < tc; ++j) {
          const float t = tri_t(W, tc, j, r.ox, r.oy, r.oz, r, t_min, kMissT);
          const int slot = chunk * tc + j;
          if (t < best || (t == best && t < kMissT && slot < best_slot)) {
            best = t;
            best_slot = slot;
          }
        }
      }
    }
    if (next < 0) next = sp > 0 ? stack[--sp] : -1;
    node = next;
  }
  t_out[i] = best;
  slot_out[i] = best_slot;
}

__global__ void __launch_bounds__(kThreads) any_bvh_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ t_max, int n_rays, const float* __restrict__ nbox,
    const int* __restrict__ meta, const float* __restrict__ w, int tc,
    float t_min, Widen widen, unsigned char* __restrict__ blocked_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const Ray r = load_ray(ox, oy, oz, dx, dy, dz, i);
  const float t_far = t_max[i];

  int stack[kStackDepth];
  int sp = 0;
  int node = 0;
  while (node >= 0) {
    int next = -1;
    if (slab(nbox + 6 * node, r, t_min, t_far, widen)) {
      next = descend(meta, node, r, stack, sp);
      if (next < 0) {
        const float* W = w + (size_t)meta[2 * node] * 12 * tc;
        for (int j = 0; j < tc; ++j) {
          if (tri_t(W, tc, j, r.ox, r.oy, r.oz, r, t_min, t_far) < kMissT) {
            blocked_out[i] = 1;  // the first occluder ends the walk
            return;
          }
        }
      }
    }
    if (next < 0) next = sp > 0 ? stack[--sp] : -1;
    node = next;
  }
  blocked_out[i] = 0;
}

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// Plain C entry points for ctypes.  Each launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 = the launch was accepted).

extern "C" int bvh2_stack_depth() { return kStackDepth; }

extern "C" int closest_bvh(const float* ox, const float* oy, const float* oz,
                           const float* dx, const float* dy, const float* dz,
                           int n_rays, const float* nbox, const int* meta,
                           const float* w, int leaf_size, float t_min,
                           float box_pad, float far_scale,
                           float* t_out, int* slot_out, void* stream) {
  if (n_rays > 0) {
    closest_bvh_kernel<<<blocks_for(n_rays), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        ox, oy, oz, dx, dy, dz, n_rays, nbox, meta, w, leaf_size,
        t_min, Widen{box_pad, far_scale}, t_out, slot_out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int any_bvh(const float* ox, const float* oy, const float* oz,
                       const float* dx, const float* dy, const float* dz,
                       const float* t_max, int n_rays, const float* nbox,
                       const int* meta, const float* w, int leaf_size,
                       float t_min, float box_pad, float far_scale,
                       unsigned char* blocked_out, void* stream) {
  if (n_rays > 0) {
    any_bvh_kernel<<<blocks_for(n_rays), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        ox, oy, oz, dx, dy, dz, t_max, n_rays, nbox, meta, w, leaf_size,
        t_min, Widen{box_pad, far_scale}, blocked_out);
  }
  return static_cast<int>(cudaGetLastError());
}
