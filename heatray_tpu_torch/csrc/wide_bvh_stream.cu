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
// its rays, and pays two to three block barriers per node.  So here the walk
// is K1's (wide_bvh.cu): each thread walks its own ray with its own stack,
// in its own near-to-far order along the node's sort axis, culling children
// against its own best hit, with no barrier and no shared walk state.  Only
// the leaf test is shared, as in the while-while layout of Aila and Laine
// ("Understanding the Efficiency of Ray Traversal on GPUs", HPG 2009):
//
// - A node's live leaf children stay pending on the ray's lane, and the lane
//   offers them one at a time, near to far, each re-culled against its ray's
//   current best just before it is offered.
// - Each round of the warp's loop, every lane that has no leaf to offer
//   visits at most kVisits nodes until it has one; then the warp takes the
//   offered (ray, leaf) pairs one by one (a ballot, then __ffs) and tests
//   each with the leaf's triangles spread over its 32 lanes
//   (wide_bvh_common.cuh, `warp_serve_closest` / `warp_serve_any`, which
//   K4 and K5 share: lane j reads column j of each Woop row, coalesced, and
//   the (t, slot) reduction keeps the lower slot on a tie).  Only the ray's
//   own lane keeps the result.  So a leaf costs only the rays that enter
//   it, and a ray's result does not depend on which rays share its warp.
// - The loop ends when no lane of the warp has a node or a pending leaf.
//   Every warp collective is reached by all 32 lanes: lanes past the last
//   ray, and lanes whose walk is over (or, for any hit, whose ray is
//   blocked), take part with nothing to offer, and write nothing.
//
// The leaf rows are read from device memory: the whole `w` of a
// 300k-triangle scene (about 21 MB) stays in the 50 MB L2.
//
// Numerics: K1's (wide_bvh_common.cuh: `tri_t`, exact f32, IEEE divide,
// built with --fmad=false, the widened slab).  Ties in t go to the lowest
// slot, across leaves too, so the result equals the brute force over the
// same slot rows bit for bit: the plain version.
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
// What is left for later: no staging of leaves in shared memory, no test of
// several rays against one leaf from registers, no `wgmma` pair tests, no
// persistent threads.

#include <cuda_runtime.h>

#include "wide_bvh_common.cuh"

namespace {

using namespace wide_bvh;

constexpr int kStackDepth = 64;  // K1's; the streaming tree of high_poly needs 35
constexpr int kThreads = 128;
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

__global__ void __launch_bounds__(kThreads) closest_stream_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz, int n_rays,
    const float* __restrict__ wbox, const int* __restrict__ wchild,
    const int* __restrict__ waxis, const float* __restrict__ w,
    const float* __restrict__ wanchor, int n_chunks, int tc, float t_min,
    Widen widen, float* __restrict__ t_out, int* __restrict__ slot_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool valid = i < n_rays;
  if (!__any_sync(kFullMask, valid)) return;  // the whole warp is past the end
  Ray r = {};
  if (valid) r = load_ray(ox, oy, oz, dx, dy, dz, i);
  const size_t chunk_floats = 12 * (size_t)tc;

  float best = kMissT;
  int best_slot = -1;
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
    }
    // The warp tests each offered (ray, leaf) pair in turn.
    warp_serve_closest(chunk, w, chunk_floats, tc, wanchor, n_chunks, r, t_min, best,
                       best_slot);
    if (!__any_sync(kFullMask, walk.node >= 0 || walk.leaves)) break;
  }
  if (valid) {
    t_out[i] = best;
    slot_out[i] = best_slot;
  }
}

__global__ void __launch_bounds__(kThreads) any_stream_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ t_max, int n_rays,
    const float* __restrict__ wbox, const int* __restrict__ wchild,
    const int* __restrict__ waxis, const float* __restrict__ w,
    const float* __restrict__ wanchor, int n_chunks, int tc, float t_min,
    Widen widen, unsigned char* __restrict__ blocked_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool valid = i < n_rays;
  if (!__any_sync(kFullMask, valid)) return;
  Ray r = {};
  float t_hi = 0.0f;
  if (valid) {
    r = load_ray(ox, oy, oz, dx, dy, dz, i);
    t_hi = t_max[i];
  }
  const size_t chunk_floats = 12 * (size_t)tc;

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
    if (warp_serve_any(chunk, w, chunk_floats, tc, wanchor, n_chunks, r, t_min, t_hi)) {
      blocked = true;  // the first occluder ends this ray's walk
      walk.node = -1;
      walk.leaves = 0;
    }
    if (!__any_sync(kFullMask, walk.node >= 0 || walk.leaves)) break;
  }
  if (valid) blocked_out[i] = blocked ? 1 : 0;
}

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

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
    closest_stream_kernel<<<blocks_for(n_rays), kThreads, 0,
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
    any_stream_kernel<<<blocks_for(n_rays), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        ox, oy, oz, dx, dy, dz, t_max, n_rays, wbox, wchild, waxis, w,
        wanchor, n_chunks, leaf_size, t_min, Widen{box_pad, far_scale},
        blocked_out);
  }
  return static_cast<int>(cudaGetLastError());
}
