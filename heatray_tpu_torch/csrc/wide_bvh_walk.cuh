// One walk per ray over an arity-8 BVH, with the leaf tests served by the
// warp: the loops of K1/K2 (wide_bvh.cu) and K3a/K3b (wide_bvh_stream.cu),
// and K5a/K5b and K4a/K4b (wide_bvh_t.cu), which differ only in the leaf
// service they call (`LaneServe`, `WarpServe`, `BlockServe`) and in their
// register cap; and P1 `nodes` (probes.cu), K1's walk with `NoServe`.
//
// Each thread walks its own ray with its own stack, in its own near-to-far
// order along the node's sort axis, culling children against its own best
// hit, with no barrier and no shared walk state.  Only the leaf test is
// shared, as in the while-while layout of Aila and Laine ("Understanding the
// Efficiency of Ray Traversal on GPUs", HPG 2009):
//
// - A node's live leaf children stay pending on the ray's lane, and the lane
//   offers them one at a time, near to far; for closest hit each is re-culled
//   against its ray's current best just before it is offered.
// - Each round of the warp's loop, every lane that has no leaf to offer
//   visits at most kVisits nodes until it has one; then the warp serves the
//   offered (ray, leaf) pairs (wide_bvh_common.cuh: `warp_serve_*`, the
//   leaf's triangles across the lanes, one ray at a time, or `lane_serve_*`,
//   one triangle per lane in registers, for K5 and K4 culled block by
//   block).
//   Only the ray's own lane keeps the result, so a leaf costs only the rays
//   that enter it, and a ray's result does not depend on which rays share
//   its warp.
// - The loop ends when no lane of the warp has a node or a pending leaf.
//   Every warp collective is reached by all 32 lanes: lanes past the last
//   ray, and lanes whose walk is over (or, for any hit, whose ray is
//   blocked), take part with nothing to offer, and write nothing.
//
// Ties in t go to the lowest slot, across leaves too (the services accept t
// equal to the ray's best and keep the lower slot), so the result equals the
// brute force over the same slot rows bit for bit: the plain version.

#pragma once

#include <cuda_runtime.h>

#include "wide_bvh_common.cuh"

namespace wide_bvh {

constexpr int kStackDepth = 64;
// Nodes a lane may visit in one round of its warp's loop while it has no
// leaf to offer: one, so that no lane's long walk holds up the warp's leaf
// tests (more per round was not faster for closest hit on the H100).
constexpr int kVisits = 1;

// One ray's walk: its stack, its next node (-1: none), and the pending leaf
// children of the last node it visited.
struct RayWalk {
  int stack[kStackDepth];
  int sp;
  int node;
  int leaf_node;    // the node whose leaf children are pending
  unsigned leaves;  // the pending children's bits in leaf_node's row
  bool low_first;   // leaf_node's near-to-far order for this ray
};

// Visits the walk's next node: the live leaf children become pending, the
// live internal children are pushed far to near (the stack pops near
// first), and the next node is popped.
__device__ __forceinline__ void visit(RayWalk& walk, const float* __restrict__ wbox,
                                      const int* __restrict__ wchild,
                                      const int* __restrict__ waxis, const Ray& r,
                                      float t_min, float t_far, Widen widen) {
  const int node = walk.node;
  const float* boxes = wbox + (size_t)node * kArity * 8;
  const int* codes = wchild + (size_t)node * kArity;
  const int axis = waxis[node];
  const float d_axis = axis == 0 ? r.dx : (axis == 1 ? r.dy : r.dz);
  const bool low_first = d_axis >= 0.0f;
  const unsigned live = live_children(boxes, codes, r, t_min, t_far, widen);
  unsigned leaves = 0;
  for (int k = 0; k < kArity; ++k) {
    const int c = low_first ? kArity - 1 - k : k;
    if (!((live >> c) & 1u)) continue;
    const int code = codes[c];
    if (code >= 0) {
      walk.stack[walk.sp++] = code;
    } else {
      leaves |= 1u << c;  // live excludes empty slots: code <= -2
    }
  }
  walk.leaf_node = node;
  walk.leaves = leaves;
  walk.low_first = low_first;
  walk.node = walk.sp > 0 ? walk.stack[--walk.sp] : -1;
}

// Takes the nearest pending leaf child off the walk: its index in the row
// of wchild (leaf_node * 8 + slot).
__device__ __forceinline__ size_t take_leaf(RayWalk& walk) {
  const int bits = static_cast<int>(walk.leaves);
  const int c = walk.low_first ? __ffs(bits) - 1 : 31 - __clz(bits);
  walk.leaves &= ~(1u << c);
  return (size_t)walk.leaf_node * kArity + c;
}

// A walk from the root, or none for a lane without a ray.
__device__ __forceinline__ void start_walk(RayWalk& walk, bool valid) {
  walk.sp = 0;
  walk.node = valid ? 0 : -1;
  walk.leaf_node = 0;
  walk.leaves = 0;
  walk.low_first = true;
}


// Threads per block of the walk kernels.
constexpr int kWalkThreads = 128;

// The leaf services a walk loop takes.  K3's: each offered pair tested by
// the whole warp, the leaf's triangles across the lanes.
struct WarpServe {
  __device__ __forceinline__ static void closest(int chunk, const float* __restrict__ w, int tc,
                                                 const float* __restrict__ wanchor, int n_chunks,
                                                 const Ray& r, float t_min, float& best,
                                                 int& best_slot) {
    warp_serve_closest(chunk, w, 12 * (size_t)tc, tc, wanchor, n_chunks, r, t_min, best,
                       best_slot);
  }
  __device__ __forceinline__ static bool any(int chunk, const float* __restrict__ w, int tc,
                                             const float* __restrict__ wanchor, int n_chunks,
                                             const Ray& r, float t_min, float t_max) {
    return warp_serve_any(chunk, w, 12 * (size_t)tc, tc, wanchor, n_chunks, r, t_min, t_max);
  }
};

// K1/K2's: one triangle per lane in registers, for every lane that offers
// the leaf.
struct LaneServe {
  __device__ __forceinline__ static void closest(int chunk, const float* __restrict__ w, int tc,
                                                 const float* __restrict__ wanchor, int n_chunks,
                                                 const Ray& r, float t_min, float& best,
                                                 int& best_slot) {
    lane_serve_closest(chunk, w, tc, wanchor, n_chunks, r, t_min, best, best_slot);
  }
  __device__ __forceinline__ static bool any(int chunk, const float* __restrict__ w, int tc,
                                             const float* __restrict__ wanchor, int n_chunks,
                                             const Ray& r, float t_min, float t_max) {
    return lane_serve_any(chunk, w, tc, wanchor, n_chunks, r, t_min, t_max);
  }
};

// K5's and K4's: K1's service over leaves with a box per block of 32
// slots, each block served only to the offering lanes whose ray enters its
// box before their best, or for any hit before their t_max
// (`lane_serve_blocks_closest`, `lane_serve_blocks_any`), given the tree's
// block boxes and the slab widening after the common arguments.
struct BlockServe {
  __device__ __forceinline__ static void closest(int chunk, const float* __restrict__ w, int tc,
                                                 const float* __restrict__ wanchor, int n_chunks,
                                                 const Ray& r, float t_min, float& best,
                                                 int& best_slot, const float* __restrict__ blocks,
                                                 Widen widen) {
    lane_serve_blocks_closest(chunk, w, tc, wanchor, n_chunks, blocks, r, t_min, widen, best,
                              best_slot);
  }
  __device__ __forceinline__ static bool any(int chunk, const float* __restrict__ w, int tc,
                                             const float* __restrict__ wanchor, int n_chunks,
                                             const Ray& r, float t_min, float t_max,
                                             const float* __restrict__ blocks, Widen widen) {
    return lane_serve_blocks_any(chunk, w, tc, wanchor, n_chunks, blocks, r, t_min, t_max,
                                 widen);
  }
};

// P1 `nodes`'s (probes.cu): a service that serves nothing, so that the walk
// is K1's with its leaf tests taken out.  Nothing lowers a ray's best, so
// its node set is that of a walk with no far end; `closest_walk` counts a
// ray's node visits and writes the count in place of the slot.
struct NoServe {
  __device__ __forceinline__ static void closest(int, const float* __restrict__, int,
                                                 const float* __restrict__, int, const Ray&,
                                                 float, float&, int&) {}
};

// Whether `closest_walk` counts each ray's node visits and writes the count
// in place of its slot: for NoServe only, so that the walks of the other
// services compile as they did without the count.
template <class Serve>
constexpr bool kCountsVisits = false;
template <>
constexpr bool kCountsVisits<NoServe> = true;

// The body of a closest-hit walk kernel (one thread per ray, kWalkThreads a
// block): t and slot of each ray's closest hit, kMissT and -1 for none.
// `Serve::closest` serves the offered leaves, given `extra` after its
// common arguments (BlockServe's data; none for K1 and K3).
template <class Serve, class... Extra>
__device__ __forceinline__ void closest_walk(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz, int n_rays,
    const float* __restrict__ wbox, const int* __restrict__ wchild,
    const int* __restrict__ waxis, const float* __restrict__ w,
    const float* __restrict__ wanchor, int n_chunks, int tc, float t_min,
    Widen widen, float* __restrict__ t_out, int* __restrict__ slot_out, Extra... extra) {
  const int i = blockIdx.x * kWalkThreads + threadIdx.x;
  const bool valid = i < n_rays;
  if (!__any_sync(kFullMask, valid)) return;  // the whole warp is past the end
  Ray r = {};
  if (valid) r = load_ray(ox, oy, oz, dx, dy, dz, i);

  float best = kMissT;
  int best_slot = -1;
  int visits = 0;  // kCountsVisits<Serve> only
  RayWalk walk;
  start_walk(walk, valid);
  for (;;) {
    // This lane's next leaf that its ray still enters before its best hit.
    int chunk = -1;
    for (int v = 0;; ++v) {
      while (walk.leaves && chunk < 0) {
        const size_t at = take_leaf(walk);
        if (slab(wbox + at * 8, r, t_min, best, widen)) chunk = -2 - wchild[at];
      }
      if (chunk >= 0 || walk.node < 0 || v == kVisits) break;
      visit(walk, wbox, wchild, waxis, r, t_min, best, widen);
      if constexpr (kCountsVisits<Serve>) ++visits;
    }
    Serve::closest(chunk, w, tc, wanchor, n_chunks, r, t_min, best, best_slot, extra...);
    if (!__any_sync(kFullMask, walk.node >= 0 || walk.leaves)) break;
  }
  if (valid) {
    t_out[i] = best;
    if constexpr (kCountsVisits<Serve>) {
      slot_out[i] = visits;
    } else {
      slot_out[i] = best_slot;
    }
  }
}

// The body of an any-hit walk kernel: 1 for each ray with a hit in
// (t_min, its t_max), else 0.  `Serve::any` serves the offered leaves,
// given `extra` after its common arguments, as in `closest_walk`.
template <class Serve, class... Extra>
__device__ __forceinline__ void any_walk(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ t_max, int n_rays,
    const float* __restrict__ wbox, const int* __restrict__ wchild,
    const int* __restrict__ waxis, const float* __restrict__ w,
    const float* __restrict__ wanchor, int n_chunks, int tc, float t_min,
    Widen widen, unsigned char* __restrict__ blocked_out, Extra... extra) {
  const int i = blockIdx.x * kWalkThreads + threadIdx.x;
  const bool valid = i < n_rays;
  if (!__any_sync(kFullMask, valid)) return;
  Ray r = {};
  float t_hi = 0.0f;
  if (valid) {
    r = load_ray(ox, oy, oz, dx, dy, dz, i);
    t_hi = t_max[i];
  }

  bool blocked = false;
  RayWalk walk;
  start_walk(walk, valid);
  for (;;) {
    // This lane's next leaf (its far end does not change: no re-cull).
    int chunk = -1;
    for (int v = 0;; ++v) {
      if (walk.leaves) {
        chunk = -2 - wchild[take_leaf(walk)];
        break;
      }
      if (walk.node < 0 || v == kVisits) break;
      visit(walk, wbox, wchild, waxis, r, t_min, t_hi, widen);
    }
    if (Serve::any(chunk, w, tc, wanchor, n_chunks, r, t_min, t_hi, extra...)) {
      blocked = true;  // the first occluder ends this ray's walk
      walk.node = -1;
      walk.leaves = 0;
    }
    if (!__any_sync(kFullMask, walk.node >= 0 || walk.leaves)) break;
  }
  if (valid) blocked_out[i] = blocked ? 1 : 0;
}

inline int walk_blocks(int n_rays) { return (n_rays + kWalkThreads - 1) / kWalkThreads; }

}  // namespace wide_bvh
