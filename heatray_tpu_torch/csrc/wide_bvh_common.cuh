// Arity-8 BVH pieces shared by the traversal kernels (wide_bvh.cu,
// wide_bvh_stream.cu): the ray, the widened slab test of a node's children
// and the exact-f32 Woop pair test of one triangle of a leaf chunk.
//
// Numerics: built with --fmad=false, so every product and sum rounds
// separately, in the order the plain PyTorch version
// (heatray_tpu_torch/ops/intersect.py, `pair_t`) uses.  The divide is IEEE.
//
// Layouts (all contiguous, see heatray_tpu_torch/ops/wide_bvh.py):
//   wbox    (Nw, 8, 8) f32: per child [minx miny minz maxx maxy maxz pad pad]
//   wchild  (Nw * 8,)  i32: >= 0 wide node, -1 empty, <= -2 leaf chunk -2-code
//   waxis   (Nw,)      i32: axis the children are sorted along (ascending)
//   w       (C, 4, 3 Tc) f32: feature rows x, y, z, 1; columns b1[Tc] b2[Tc] s[Tc],
//                       translation re-centred on the chunk anchor
//   wanchor (3, C)     f32

#pragma once

#include <cuda_runtime.h>

namespace wide_bvh {

constexpr int kArity = 8;
constexpr float kMissT = 3.0e38f;
constexpr float kBaryEps = 1e-6f;

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
// kernels' `_children_slab`) culls such a hit where the brute force over
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
// `W` points at the chunk (global or shared memory), `j` is the triangle's
// column in each block.
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

}  // namespace wide_bvh
