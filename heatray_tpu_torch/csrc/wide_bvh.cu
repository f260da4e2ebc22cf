// Arity-8 BVH traversal: closest hit and any hit, one thread per ray.
//
// Replaces the Pallas TPU kernels `_closest_kernel` and `_any_kernel` of
// heatray_tpu/ops/wide_bvh.py.  Those walk the tree once per 512-ray tile
// with the tile's aggregate direction sign and test a whole leaf against the
// tile as one MXU contraction.  Here every thread walks the tree for its own
// ray, with its own stack, its own near-first child order along the node's
// sort axis, and exact float32 leaf math.  The closest hit does not depend
// on the order, and the slab test is widened so that it never culls a hit
// the pair test accepts (see `slab`), so the result is that of a brute force
// over the same leaf rows: the plain version.
//
// What bounds it on an H100: divergent memory latency.  Each node visit
// reads 8 child boxes (256 B) and each leaf visit 12 floats per triangle,
// at addresses that differ from lane to lane of a warp, and lanes of one
// warp take different paths through the tree.  The arithmetic (a few
// hundred FLOPs per visit) is far below the card's rate.  This simple
// design does nothing about that yet: no warp-level or sorted wavefronts,
// no persistent threads, no staging of nodes or leaves in shared memory
// through TMA, no `wgmma` leaf tests.  Those are later work.
//
// Numerics, layouts and the slab and pair tests: wide_bvh_common.cuh.
// Ties in t go to the lowest slot, as in the plain version.

#include <cuda_runtime.h>

#include "wide_bvh_common.cuh"

namespace {

using namespace wide_bvh;

constexpr int kStackDepth = 64;
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads) closest_wide_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz, int n_rays,
    const float* __restrict__ wbox, const int* __restrict__ wchild,
    const int* __restrict__ waxis, const float* __restrict__ w,
    const float* __restrict__ wanchor, int n_chunks, int tc, float t_min,
    Widen widen, float* __restrict__ t_out, int* __restrict__ slot_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const Ray r = load_ray(ox, oy, oz, dx, dy, dz, i);

  float best = kMissT;
  int best_slot = -1;
  int stack[kStackDepth];
  int sp = 0;
  int node = 0;
  while (node >= 0) {
    const float* boxes = wbox + (size_t)node * kArity * 8;
    const int* codes = wchild + (size_t)node * kArity;
    const int axis = waxis[node];
    const float d_axis = axis == 0 ? r.dx : (axis == 1 ? r.dy : r.dz);
    const bool low_first = d_axis >= 0.0f;
    const unsigned live = live_children(boxes, codes, r, t_min, best, widen);

    // Leaf children near to far: the running best shrinks early.
    for (int k = 0; k < kArity; ++k) {
      const int c = low_first ? k : kArity - 1 - k;
      const int code = codes[c];
      if (!((live >> c) & 1u) || code > -2) continue;
      const int chunk = -2 - code;
      const float ax = r.ox - wanchor[chunk];
      const float ay = r.oy - wanchor[n_chunks + chunk];
      const float az = r.oz - wanchor[2 * n_chunks + chunk];
      const float* W = w + (size_t)chunk * 4 * 3 * tc;
      for (int j = 0; j < tc; ++j) {
        const float t = tri_t(W, tc, j, ax, ay, az, r, t_min, kMissT);
        const int slot = chunk * tc + j;
        if (t < best || (t == best && t < kMissT && slot < best_slot)) {
          best = t;
          best_slot = slot;
        }
      }
    }
    // Internal children far to near, so the stack pops near first.
    for (int k = 0; k < kArity; ++k) {
      const int c = low_first ? kArity - 1 - k : k;
      const int code = codes[c];
      if (((live >> c) & 1u) && code >= 0) stack[sp++] = code;
    }
    node = sp > 0 ? stack[--sp] : -1;
  }
  t_out[i] = best;
  slot_out[i] = best_slot;
}

__global__ void __launch_bounds__(kThreads) any_wide_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ t_max, int n_rays,
    const float* __restrict__ wbox, const int* __restrict__ wchild,
    const int* __restrict__ waxis, const float* __restrict__ w,
    const float* __restrict__ wanchor, int n_chunks, int tc, float t_min,
    Widen widen, unsigned char* __restrict__ blocked_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const Ray r = load_ray(ox, oy, oz, dx, dy, dz, i);
  const float t_far = t_max[i];

  int stack[kStackDepth];
  int sp = 0;
  int node = 0;
  while (node >= 0) {
    const float* boxes = wbox + (size_t)node * kArity * 8;
    const int* codes = wchild + (size_t)node * kArity;
    const int axis = waxis[node];
    const float d_axis = axis == 0 ? r.dx : (axis == 1 ? r.dy : r.dz);
    const bool low_first = d_axis >= 0.0f;
    const unsigned live = live_children(boxes, codes, r, t_min, t_far, widen);

    for (int k = 0; k < kArity; ++k) {
      const int c = low_first ? k : kArity - 1 - k;
      const int code = codes[c];
      if (!((live >> c) & 1u) || code > -2) continue;
      const int chunk = -2 - code;
      const float ax = r.ox - wanchor[chunk];
      const float ay = r.oy - wanchor[n_chunks + chunk];
      const float az = r.oz - wanchor[2 * n_chunks + chunk];
      const float* W = w + (size_t)chunk * 4 * 3 * tc;
      for (int j = 0; j < tc; ++j) {
        if (tri_t(W, tc, j, ax, ay, az, r, t_min, t_far) < kMissT) {
          blocked_out[i] = 1;  // first occluder ends the walk
          return;
        }
      }
    }
    for (int k = 0; k < kArity; ++k) {
      const int c = low_first ? kArity - 1 - k : k;
      const int code = codes[c];
      if (((live >> c) & 1u) && code >= 0) stack[sp++] = code;
    }
    node = sp > 0 ? stack[--sp] : -1;
  }
  blocked_out[i] = 0;
}

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

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
    closest_wide_kernel<<<blocks_for(n_rays), kThreads, 0,
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
    any_wide_kernel<<<blocks_for(n_rays), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        ox, oy, oz, dx, dy, dz, t_max, n_rays, wbox, wchild, waxis, w,
        wanchor, n_chunks, leaf_size, t_min, Widen{box_pad, far_scale},
        blocked_out);
  }
  return static_cast<int>(cudaGetLastError());
}
