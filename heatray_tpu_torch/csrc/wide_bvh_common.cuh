// Arity-8 BVH pieces shared by the traversal kernels (wide_bvh.cu,
// wide_bvh_stream.cu, wide_bvh_t.cu): the ray, the widened slab test of a
// node's children, the exact-f32 Woop pair test of one triangle of a leaf
// chunk, and that test spread across the lanes of a warp.
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

// A refused launch setting (a shared-memory opt-in) is also the thread's
// last error: clear it, or the next launch (this library's or PyTorch's)
// would report it as its own.  Returns the error.
inline int refused(cudaError_t err) {
  cudaGetLastError();
  return static_cast<int>(err);
}

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

// --- warp-transposed leaf tests (wide_bvh_t.cu, wide_bvh_stream.cu) ----------
//
// The counterpart of the TPU's transposed "VPU leaf math"
// (heatray_tpu/ops/intersect_pallas.py `_pair_hits_t`, rays x 3 Tc with the
// leaf's triangles across the lanes): one ray at a time, the same on every
// lane of a warp, against a whole leaf chunk, lane l testing columns l,
// l + 32, ..., so that each load of a Woop row reads 32 consecutive floats.
// Every call must be made by all 32 lanes of the warp.

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// Lane `src`'s ray on every lane.  The pair test reads only the origin and
// the direction, so the reciprocals are left unset.
__device__ __forceinline__ Ray shfl_ray(const Ray& r, int src) {
  Ray q = {};
  q.ox = __shfl_sync(kFullMask, r.ox, src);
  q.oy = __shfl_sync(kFullMask, r.oy, src);
  q.oz = __shfl_sync(kFullMask, r.oz, src);
  q.dx = __shfl_sync(kFullMask, r.dx, src);
  q.dy = __shfl_sync(kFullMask, r.dy, src);
  q.dz = __shfl_sync(kFullMask, r.dz, src);
  return q;
}

// Closest hit of the ray `q` against chunk `W`: on every lane, the smallest
// t of the chunk that is at most `t_best` (t_best itself included, so that a
// lower slot can still win a tie) and its column, the lowest on ties; kMissT
// when there is none.
__device__ __forceinline__ void warp_leaf_closest(const float* __restrict__ W,
                                                  int tc, float ax, float ay,
                                                  float az, const Ray& q,
                                                  float t_min, float t_best,
                                                  float* t_out, int* col_out) {
  // t < t_lim <=> t <= t_best (+inf as the direction)
  const float t_lim = nextafterf(t_best, __int_as_float(0x7f800000));
  float t = kMissT;
  int col = -1;
  for (int j = threadIdx.x & 31; j < tc; j += 32) {
    const float tj = tri_t(W, tc, j, ax, ay, az, q, t_min, t_lim);
    if (tj < t) {  // columns rise per lane: the lower one keeps a tie
      t = tj;
      col = j;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {  // the same minimum on every lane
    const float ot = __shfl_xor_sync(kFullMask, t, o);
    const int oc = __shfl_xor_sync(kFullMask, col, o);
    if (ot < t || (ot == t && static_cast<unsigned>(oc) < static_cast<unsigned>(col))) {
      t = ot;
      col = oc;
    }
  }
  *t_out = t;
  *col_out = col;
}

// Any hit of the ray `q` in (t_min, t_max) against chunk `W`, on every lane.
__device__ __forceinline__ bool warp_leaf_any(const float* __restrict__ W, int tc,
                                              float ax, float ay, float az,
                                              const Ray& q, float t_min, float t_max) {
  bool hit = false;
  for (int j = threadIdx.x & 31; j < tc && !hit; j += 32) {
    hit = tri_t(W, tc, j, ax, ay, az, q, t_min, t_max) < kMissT;
  }
  return __any_sync(kFullMask, hit);
}

// The warp's service of the (ray, leaf) pairs its lanes offer, closest hit:
// each lane that offers a chunk (`chunk >= 0`) has its ray tested in turn,
// lowest lane first, by the whole warp against that chunk's rows, at
// `w + chunk * stride` (global memory; a stride of 0 when every lane offers
// the one chunk at `w`, which may be staged in shared memory).  Only the
// offering lane keeps the result, a smaller t or an equal one at a lower
// slot, so ties go to the lowest slot across leaves too.  Lanes that offer
// nothing (chunk < 0) take part and keep what they had.
__device__ __forceinline__ void warp_serve_closest(
    int chunk, const float* __restrict__ w, size_t stride, int tc,
    const float* __restrict__ wanchor, int n_chunks, const Ray& r, float t_min,
    float& best, int& best_slot) {
  const int lane = threadIdx.x & 31;
  for (unsigned want = __ballot_sync(kFullMask, chunk >= 0); want; want &= want - 1) {
    const int src = __ffs(static_cast<int>(want)) - 1;
    const int q_chunk = __shfl_sync(kFullMask, chunk, src);
    const Ray q = shfl_ray(r, src);
    const float q_best = __shfl_sync(kFullMask, best, src);
    float t;
    int col;
    warp_leaf_closest(w + q_chunk * stride, tc, q.ox - wanchor[q_chunk],
                      q.oy - wanchor[n_chunks + q_chunk], q.oz - wanchor[2 * n_chunks + q_chunk],
                      q, t_min, q_best, &t, &col);
    const int slot = q_chunk * tc + col;
    if (lane == src && (t < best || (t == best && t < kMissT && slot < best_slot))) {
      best = t;
      best_slot = slot;
    }
  }
}

// The same, any hit: true on each offering lane whose ray has a hit in
// (t_min, its own t_max) in the chunk it offered.
__device__ __forceinline__ bool warp_serve_any(
    int chunk, const float* __restrict__ w, size_t stride, int tc,
    const float* __restrict__ wanchor, int n_chunks, const Ray& r, float t_min,
    float t_max) {
  const int lane = threadIdx.x & 31;
  bool hit = false;
  for (unsigned want = __ballot_sync(kFullMask, chunk >= 0); want; want &= want - 1) {
    const int src = __ffs(static_cast<int>(want)) - 1;
    const int q_chunk = __shfl_sync(kFullMask, chunk, src);
    const Ray q = shfl_ray(r, src);
    const float q_max = __shfl_sync(kFullMask, t_max, src);
    if (warp_leaf_any(w + q_chunk * stride, tc, q.ox - wanchor[q_chunk],
                      q.oy - wanchor[n_chunks + q_chunk], q.oz - wanchor[2 * n_chunks + q_chunk],
                      q, t_min, q_max) &&
        lane == src) {
      hit = true;
    }
  }
  return hit;
}

// One leaf visit of a warp, closest hit: each ray of the warp whose own
// widened slab enters the leaf's box before its best hit (`box`, the child
// box in its parent's wbox row) offers the chunk `W` (global or shared
// memory) to `warp_serve_closest`.  Rays that miss the box cost nothing.
__device__ __forceinline__ void warp_visit_closest(
    const float* __restrict__ box, const float* __restrict__ W, int tc, int chunk,
    const float* __restrict__ wanchor, int n_chunks, const Ray& r, bool valid,
    float t_min, Widen widen, float& best, int& best_slot) {
  const bool enters = valid && slab(box, r, t_min, best, widen);
  warp_serve_closest(enters ? chunk : -1, W, 0, tc, wanchor, n_chunks, r, t_min, best,
                     best_slot);
}

// One leaf visit of a warp, any hit: each unblocked ray of the warp
// (`active`) whose own widened slab enters the box before its `t_max`
// offers the chunk; its lane becomes blocked on a hit.
__device__ __forceinline__ void warp_visit_any(
    const float* __restrict__ box, const float* __restrict__ W, int tc, int chunk,
    const float* __restrict__ wanchor, int n_chunks, const Ray& r, bool active,
    float t_min, float t_max, Widen widen, bool& blocked) {
  const bool enters = active && slab(box, r, t_min, t_max, widen);
  if (warp_serve_any(enters ? chunk : -1, W, 0, tc, wanchor, n_chunks, r, t_min, t_max)) {
    blocked = true;
  }
}

}  // namespace wide_bvh
