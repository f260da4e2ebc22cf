// Binary skip-pointer BVH traversal: closest hit (K6a) and any hit (K6b),
// one walk per ray.
//
// Replaces the Pallas TPU kernels `_closest_kernel` and `_any_kernel` of
// heatray_tpu/ops/traverse_pallas.py.  Those walk the tree once per 512-ray
// tile with one scalar loop and a stack in SMEM: a node is entered when any
// ray of the tile overlaps its box, the near child is chosen from the
// tile's summed direction sign along the node's split axis, and a leaf is
// tested against the whole tile as one MXU contraction.  Here every thread
// walks the tree for its own ray with its own stack of 96 (the reference's
// STACK_DEPTH, which covers the build's depth cap of MAX_SAH_DEPTH +
// log2 T) and its own near-first order, and a node is re-culled against the
// ray's current best when it is popped.  The closest hit does not depend on
// the order and the slab test is widened (wide_bvh_common.cuh), so the
// result is the brute force's over the same leaf rows: the plain version.
// Ties in t go to the lowest slot, across leaves too.
//
// What bounds them on an H100: the latency of dependent loads, not bytes
// or operations.  Each node visit is a 24-byte box and an 8-byte meta
// record at an address that differs from lane to lane, the next address
// known only after the test; a binary tree has about twice the visits of
// an arity-8 one.
//
// K6a walks in the while-while loop of wide_bvh_walk.cuh's `closest_walk`,
// adapted to the binary tree: each round, a lane with no leaf to offer
// visits at most kVisits nodes (a node its ray enters before its best
// pushes its far child and goes on to its near one; a leaf it enters
// becomes its offered leaf), and then the warp serves the offered (ray,
// leaf) pairs with K5a's service (`lane_serve_blocks_closest`): lane j
// holds triangle j of each block of 32 of an offered leaf in 12 registers,
// loaded by 12 coalesced loads once for all the lanes that offer that leaf,
// and a block is served only to the lanes whose ray enters its box (the
// tree's `blocks`, inverted over padding and never entered) before their
// best.  So a leaf's triangles are read together by the warp instead of 12
// scalar loads a triangle on each lane, a leaf costs only the rays that
// enter each of its blocks, and no lane waits on another lane's serial
// loop over a 64-triangle leaf, which is what the thread-serial loop it
// replaces did on incoherent bounce rays.  The leaf rows are raw Woop rows;
// the service re-centres each ray on its leaf's anchor, which the tree
// gives as zeros (x - 0.0f == x exactly, so t is that of the raw rows).
//
// K6b walks in the same loop with `any_walk`'s any-hit rules
// (wide_bvh_walk.cuh): each node is slab-tested against the ray's own
// t_max, which never shrinks, so a popped node needs no re-cull; the
// offered leaves are served with K5b's `lane_serve_blocks_any` over the same
// block boxes and zero anchors, each block only to the lanes whose ray
// enters its box before its t_max and has no hit yet; and a lane whose ray
// is blocked ends its walk.  The warp loops while some lane has a node
// left.
//
// Layouts (heatray_tpu_torch/ops/bvh.py, `BVH`):
//   nbox    (N * 6,) f32 [min xyz, max xyz] per node, preorder
//   meta    (N * 2,) i32 per node: leaf chunk (>= 0) or -1 - split axis; skip
//   w       (C, 4, 3 Tc) f32 leaf chunks, raw Woop rows (no anchor)
//   blocks  (C, ceil(Tc / 32), 6) f32 the boxes of each leaf's runs of 32
//           slots
//   wanchor (3, C) f32 zeros

#include <cuda_runtime.h>

#include "wide_bvh_common.cuh"

namespace {

using namespace wide_bvh;

constexpr int kStackDepth = 96;
constexpr int kThreads = 128;
// K6a's and K6b's register cap: K1's (at most 64 registers a thread, 8
// blocks of 128 per SM); the stack lives in local memory.
constexpr int kMinBlocks = 8;
// Nodes a lane may visit in one round of its warp's loop while it has no
// leaf to offer.
constexpr int kVisits = 1;

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

__global__ void __launch_bounds__(kThreads, kMinBlocks) closest_bvh_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz, int n_rays,
    const float* __restrict__ blocks, const float* __restrict__ nbox,
    const int* __restrict__ meta, const float* __restrict__ w,
    const float* __restrict__ wanchor, int n_chunks, int tc, float t_min, Widen widen,
    float* __restrict__ t_out, int* __restrict__ slot_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool valid = i < n_rays;
  if (!__any_sync(kFullMask, valid)) return;  // the whole warp is past the end
  Ray r = {};
  if (valid) r = load_ray(ox, oy, oz, dx, dy, dz, i);

  float best = kMissT;
  int best_slot = -1;
  int stack[kStackDepth];
  int sp = 0;
  int node = valid ? 0 : -1;
  for (;;) {
    // This lane's next leaf that its ray enters before its best hit.
    int chunk = -1;
    for (int v = 0; v < kVisits && node >= 0 && chunk < 0; ++v) {
      int next = -1;
      if (slab(nbox + 6 * node, r, t_min, best, widen)) {
        next = descend(meta, node, r, stack, sp);
        if (next < 0) chunk = meta[2 * node];
      }
      if (next < 0) next = sp > 0 ? stack[--sp] : -1;
      node = next;
    }
    lane_serve_blocks_closest(chunk, w, tc, wanchor, n_chunks, blocks, r, t_min, widen, best,
                              best_slot);
    if (!__any_sync(kFullMask, node >= 0)) break;
  }
  if (valid) {
    t_out[i] = best;
    slot_out[i] = best_slot;
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks) any_bvh_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ t_max, int n_rays, const float* __restrict__ blocks,
    const float* __restrict__ nbox, const int* __restrict__ meta, const float* __restrict__ w,
    const float* __restrict__ wanchor, int n_chunks, int tc, float t_min, Widen widen,
    unsigned char* __restrict__ blocked_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool valid = i < n_rays;
  if (!__any_sync(kFullMask, valid)) return;  // the whole warp is past the end
  Ray r = {};
  float t_hi = 0.0f;
  if (valid) {
    r = load_ray(ox, oy, oz, dx, dy, dz, i);
    t_hi = t_max[i];
  }

  bool blocked = false;
  int stack[kStackDepth];
  int sp = 0;
  int node = valid ? 0 : -1;
  for (;;) {
    // This lane's next leaf that its ray enters before its t_max.
    int chunk = -1;
    for (int v = 0; v < kVisits && node >= 0 && chunk < 0; ++v) {
      int next = -1;
      if (slab(nbox + 6 * node, r, t_min, t_hi, widen)) {
        next = descend(meta, node, r, stack, sp);
        if (next < 0) chunk = meta[2 * node];
      }
      if (next < 0) next = sp > 0 ? stack[--sp] : -1;
      node = next;
    }
    if (lane_serve_blocks_any(chunk, w, tc, wanchor, n_chunks, blocks, r, t_min, t_hi, widen)) {
      blocked = true;  // the first occluder ends this ray's walk
      node = -1;
    }
    if (!__any_sync(kFullMask, node >= 0)) break;
  }
  if (valid) blocked_out[i] = blocked ? 1 : 0;
}

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// Plain C entry points for ctypes.  Each launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 = the launch was accepted).
// The stack depth bounds both walks; both take the tree's block boxes and
// its (zero) anchors.

extern "C" int bvh2_stack_depth() { return kStackDepth; }

extern "C" int closest_bvh(const float* ox, const float* oy, const float* oz,
                           const float* dx, const float* dy, const float* dz,
                           int n_rays, const float* blocks, const float* nbox,
                           const int* meta, const float* w, const float* wanchor,
                           int n_chunks, int leaf_size, float t_min, float box_pad,
                           float far_scale, float* t_out, int* slot_out, void* stream) {
  if (n_rays > 0) {
    closest_bvh_kernel<<<blocks_for(n_rays), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        ox, oy, oz, dx, dy, dz, n_rays, blocks, nbox, meta, w, wanchor, n_chunks, leaf_size,
        t_min, Widen{box_pad, far_scale}, t_out, slot_out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int any_bvh(const float* ox, const float* oy, const float* oz,
                       const float* dx, const float* dy, const float* dz,
                       const float* t_max, int n_rays, const float* blocks, const float* nbox,
                       const int* meta, const float* w, const float* wanchor, int n_chunks,
                       int leaf_size, float t_min, float box_pad, float far_scale,
                       unsigned char* blocked_out, void* stream) {
  if (n_rays > 0) {
    any_bvh_kernel<<<blocks_for(n_rays), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        ox, oy, oz, dx, dy, dz, t_max, n_rays, blocks, nbox, meta, w, wanchor, n_chunks,
        leaf_size, t_min, Widen{box_pad, far_scale}, blocked_out);
  }
  return static_cast<int>(cudaGetLastError());
}
