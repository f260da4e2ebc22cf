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
// Numerics: built with --fmad=false, so every product and sum rounds
// separately, in the order the plain PyTorch version
// (heatray_tpu_torch/ops/intersect.py, `pair_t`) uses.  The divide is IEEE.
// Ties in t go to the lowest slot, as in the plain version.
//
// Layouts (all contiguous, see heatray_tpu_torch/ops/wide_bvh.py):
//   wbox    (Nw, 8, 8) f32: per child [minx miny minz maxx maxy maxz pad pad]
//   wchild  (Nw * 8,)  i32: >= 0 wide node, -1 empty, <= -2 leaf chunk -2-code
//   waxis   (Nw,)      i32: axis the children are sorted along (ascending)
//   w       (C, 4, 3 Tc) f32: feature rows x, y, z, 1; columns b1[Tc] b2[Tc] s[Tc],
//                       translation re-centred on the chunk anchor
//   wanchor (3, C)     f32

#include <cuda_runtime.h>

namespace {

constexpr int kArity = 8;
constexpr int kStackDepth = 64;
constexpr float kMissT = 3.0e38f;
constexpr float kBaryEps = 1e-6f;
constexpr int kThreads = 128;

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

__device__ __forceinline__ float safe_inv(float d) {
  return (d < 0.0f ? -1.0f : 1.0f) / fmaxf(fabsf(d), 1e-18f);
}

__device__ __forceinline__ Ray load_ray(const float* ox, const float* oy,
                                        const float* oz, const float* dx,
                                        const float* dy, const float* dz,
                                        int i) {
  Ray r;
  r.ox = ox[i];
  r.oy = oy[i];
  r.oz = oz[i];
  r.dx = dx[i];
  r.dy = dy[i];
  r.dz = dz[i];
  r.ix = safe_inv(r.dx);
  r.iy = safe_inv(r.dy);
  r.iz = safe_inv(r.dz);
  return r;
}

// How far the slab test widens a box (see `slab`).
struct Widen {
  float pad;  // per axis, times the box's extent along it
  float far;  // factor on the far end of the interval
};

// Conservative slab test of one child box against [t_min, t_far].
//
// The pair test accepts points up to kBaryEps outside a triangle in
// barycentric terms, which lies outside the triangle's box by up to
// 3 kBaryEps times its extent along each axis; an exact slab test (the TPU
// kernel's `_children_slab`) culls such a hit where the brute force over
// the same rows finds it.  So each box grows by `w.pad` times its extent on
// every side (a parent box contains its children, so their grown boxes
// too), and the far end by `w.far` against the slab's own rounding.
__device__ __forceinline__ bool slab(const float* __restrict__ b, const Ray& r,
                                     float t_min, float t_far, Widen w) {
  const float px = (b[3] - b[0]) * w.pad;
  const float py = (b[4] - b[1]) * w.pad;
  const float pz = (b[5] - b[2]) * w.pad;
  const float tx0 = ((b[0] - px) - r.ox) * r.ix;
  const float ty0 = ((b[1] - py) - r.oy) * r.iy;
  const float tz0 = ((b[2] - pz) - r.oz) * r.iz;
  const float tx1 = ((b[3] + px) - r.ox) * r.ix;
  const float ty1 = ((b[4] + py) - r.oy) * r.iy;
  const float tz1 = ((b[5] + pz) - r.oz) * r.iz;
  const float tn = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                         fmaxf(fminf(tz0, tz1), t_min));
  const float tf = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                         fminf(fmaxf(tz0, tz1), t_far));
  return tn <= tf * w.far;
}

// Bitmask of the children whose box the ray enters before t_far.  Empty
// slots (code -1) are skipped: their inverted boxes never count.
__device__ __forceinline__ unsigned live_children(
    const float* __restrict__ boxes, const int* __restrict__ codes,
    const Ray& r, float t_min, float t_far, Widen w) {
  unsigned bits = 0;
#pragma unroll
  for (int k = 0; k < kArity; ++k) {
    if (codes[k] != -1 && slab(boxes + 8 * k, r, t_min, t_far, w)) bits |= 1u << k;
  }
  return bits;
}

// Woop pair test of one triangle: its t, or kMissT outside the triangle.
// `W` points at the chunk, `j` is the triangle's column in each block.
__device__ __forceinline__ float tri_t(const float* __restrict__ W, int tc,
                                       int j, float ax, float ay, float az,
                                       const Ray& r, float t_min, float t_max) {
  const int stride = 3 * tc;
  const float* c0 = W;               // feature row x
  const float* c1 = W + stride;      // feature row y
  const float* c2 = W + 2 * stride;  // feature row z
  const float* c3 = W + 3 * stride;  // feature row 1
  const int s = 2 * tc + j;
  const float pos = ax * c0[s] + ay * c1[s] + az * c2[s] + c3[s];
  const float pds = r.dx * c0[s] + r.dy * c1[s] + r.dz * c2[s];
  const float t = -pos / pds;
  if (!(t > t_min && t < t_max)) return kMissT;  // NaN fails here too
  const int u = j, v = tc + j;
  const float b1 = (ax * c0[u] + ay * c1[u] + az * c2[u] + c3[u]) +
                   t * (r.dx * c0[u] + r.dy * c1[u] + r.dz * c2[u]);
  const float b2 = (ax * c0[v] + ay * c1[v] + az * c2[v] + c3[v]) +
                   t * (r.dx * c0[v] + r.dy * c1[v] + r.dz * c2[v]);
  const bool inside =
      b1 >= -kBaryEps && b2 >= -kBaryEps && b1 + b2 <= 1.0f + kBaryEps;
  return inside ? t : kMissT;
}

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
