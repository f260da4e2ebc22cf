// BVH pieces shared by the traversal kernels (wide_bvh.cu,
// wide_bvh_stream.cu, wide_bvh_t.cu, bvh2.cu): the ray, the widened slab
// test of a node's children, the exact-f32 Woop pair test of one triangle
// of a leaf chunk, and the warp's leaf services: that test spread across the lanes of
// a warp, one ray at a time, or one triangle per lane held in registers for
// every ray of the warp that offers the leaf.
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

#include <cfloat>

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

// `slab` for a box that may be inverted (min above max: a run of padding
// slots or of masked triangles), which no ray enters.
__device__ __forceinline__ bool enters(const float* __restrict__ box, const Ray& r,
                                       float t_min, float t_far, Widen widen) {
  return box[0] <= box[3] && slab(box, r, t_min, t_far, widen);
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
// `col(f, g)` is the triangle's value in feature row f (x, y, z, 1) of
// column block g (b1, b2, s); it is read where the expression needs it, so
// a triangle in device memory loads its b1 and b2 columns only when t lies
// in range.
template <class Col>
__device__ __forceinline__ float woop_t(Col col, float ax, float ay, float az,
                                        const Ray& r, float t_min, float t_max) {
  const float pos = ax * col(0, 2) + ay * col(1, 2) + az * col(2, 2) + col(3, 2);
  const float pds = r.dx * col(0, 2) + r.dy * col(1, 2) + r.dz * col(2, 2);
  const float t = -pos / pds;
  if (!(t > t_min && t < t_max)) return kMissT;  // NaN fails here too
  const float b1 = (ax * col(0, 0) + ay * col(1, 0) + az * col(2, 0) + col(3, 0)) +
                   t * (r.dx * col(0, 0) + r.dy * col(1, 0) + r.dz * col(2, 0));
  const float b2 = (ax * col(0, 1) + ay * col(1, 1) + az * col(2, 1) + col(3, 1)) +
                   t * (r.dx * col(0, 1) + r.dy * col(1, 1) + r.dz * col(2, 1));
  const bool inside =
      b1 >= -kBaryEps && b2 >= -kBaryEps && b1 + b2 <= 1.0f + kBaryEps;
  return inside ? t : kMissT;
}

// The pair test of column `j` of chunk `W` (global or shared memory).
__device__ __forceinline__ float tri_t(const float* __restrict__ W, int tc,
                                       int j, float ax, float ay, float az,
                                       const Ray& r, float t_min, float t_max) {
  const int stride = 3 * tc;
  return woop_t([&](int f, int g) { return (W + f * stride)[g * tc + j]; }, ax, ay, az,
                r, t_min, t_max);
}

// One triangle's 12 Woop values in registers: c[g][f], column block g (b1,
// b2, s), feature row f (x, y, z, 1).
struct TriCols {
  float c[3][4];
};

// Column `j` of chunk `W`: 12 loads, each of which reads `tc` consecutive
// floats across the lanes j = 0 .. tc - 1 of a warp.
__device__ __forceinline__ TriCols load_cols(const float* __restrict__ W, int tc, int j) {
  TriCols cols;
#pragma unroll
  for (int g = 0; g < 3; ++g) {
#pragma unroll
    for (int f = 0; f < 4; ++f) cols.c[g][f] = W[f * 3 * tc + g * tc + j];
  }
  return cols;
}

// The pair test of a triangle held in registers: `tri_t`'s expression.
__device__ __forceinline__ float tri_t(const TriCols& cols, float ax, float ay, float az,
                                       const Ray& r, float t_min, float t_max) {
  return woop_t([&](int f, int g) { return cols.c[g][f]; }, ax, ay, az, r, t_min, t_max);
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

// A closest-hit candidate (t, slot) against the ray's (best, best_slot): a
// smaller t wins, an equal one at a lower slot, so ties go to the lowest
// slot across leaves too.
__device__ __forceinline__ void keep_closest(float t, int slot, float& best, int& best_slot) {
  if (t < best || (t == best && t < kMissT && slot < best_slot)) {
    best = t;
    best_slot = slot;
  }
}

// The warp's service of the (ray, leaf) pairs its lanes offer, closest hit:
// each lane that offers a chunk (`chunk >= 0`) has its ray tested in turn,
// lowest lane first, by the whole warp against that chunk's rows, at
// `w + chunk * stride` (global memory; a stride of 0 when every lane offers
// the one chunk at `w`, which may be staged in shared memory).  Only the
// offering lane keeps the result (`keep_closest`).  Lanes that offer
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
    if (lane == src) keep_closest(t, q_chunk * tc + col, best, best_slot);
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

// --- one triangle per lane (wide_bvh.cu) --------------------------------------
//
// The service of `warp_serve_closest` / `warp_serve_any` with the chunk's
// columns in registers: for each chunk offered in this round, lane j holds
// column j0 + j of each block of 32 columns (`load_cols`: 12 coalesced
// loads), loaded once for all the lanes that offer that chunk
// (`__match_any_sync`), and their rays are tested from those registers.
// Lanes past the chunk's last column hold nothing and find no hit.  The
// same calls must be made by all 32 lanes of the warp.

// An unsigned key in the order of the floats, for every float but NaN (-0
// is made +0 first, so that equal floats have equal keys), and its inverse.
__device__ __forceinline__ unsigned order_key(float t) {
  const unsigned b = __float_as_uint(t + 0.0f);
  return b ^ ((b & 0x80000000u) ? 0xffffffffu : 0x80000000u);
}

__device__ __forceinline__ float key_float(unsigned k) {
  return __uint_as_float(k ^ ((k & 0x80000000u) ? 0x80000000u : 0xffffffffu));
}

// Lane `src`'s triangle held in registers, on every lane.
__device__ __forceinline__ TriCols shfl_cols(const TriCols& cols, int src) {
  TriCols out;
#pragma unroll
  for (int g = 0; g < 3; ++g) {
#pragma unroll
    for (int f = 0; f < 4; ++f) out.c[g][f] = __shfl_sync(kFullMask, cols.c[g][f], src);
  }
  return out;
}

// Calls `test(c, j0, cols, a, rays)` once for each distinct chunk `c`
// offered by a lane (`chunk >= 0`), lowest offering lane first, and for
// each of its blocks of 32 columns, lowest first: `j0` the block's first
// column, `cols` this lane's column j0 + lane, `a` this lane's ray with its
// origin re-centred on the chunk's anchor (as the pair test takes it),
// `rays` the mask of the lanes that offer the chunk.
template <class Test>
__device__ __forceinline__ void lane_serve(int chunk, const float* __restrict__ w, int tc,
                                           const float* __restrict__ wanchor, int n_chunks,
                                           const Ray& r, Test test) {
  const int lane = threadIdx.x & 31;
  const unsigned same = __match_any_sync(kFullMask, chunk);
  for (unsigned want = __ballot_sync(kFullMask, chunk >= 0); want;) {
    const int lead = __ffs(static_cast<int>(want)) - 1;
    const unsigned rays = __shfl_sync(kFullMask, same, lead);
    want &= ~rays;
    const int c = __shfl_sync(kFullMask, chunk, lead);
    Ray a = r;
    a.ox = r.ox - wanchor[c];
    a.oy = r.oy - wanchor[n_chunks + c];
    a.oz = r.oz - wanchor[2 * n_chunks + c];
    for (int j0 = 0; j0 < tc; j0 += 32) {
      TriCols cols = {};
      if (j0 + lane < tc) cols = load_cols(w + (size_t)c * 12 * tc, tc, j0 + lane);
      test(c, j0, cols, a, rays);
    }
  }
}

// Groups of more rays than this test ray per lane; smaller ones one ray at
// a time across the columns.  On the Cornell box's launches 16-28 are
// within 1% of one another, 8 and no ray-per-lane branch slower
// (profile_torch_wide.py, variants `rays-*`).
constexpr int kLaneRays = 24;

// One block of at most 32 columns, closest hit: `n` columns, `cols` this
// lane's column (`has_col`: lane < n, written by each caller in its own
// terms; one form for both changed K1's or K7a's scheduled code and cost
// it 1-3%), `base` the slot of column 0, `rays` the lanes whose ray `a` (as
// the pair test takes it) is tested.  A group of many rays (coherent rays
// that enter a leaf together) has each of its lanes test its own ray
// against every column in turn, the column broadcast from lane j's
// registers by shuffles, in column order.  A small group tests its rays
// one after the other with one column per lane, and
// the (t, column) minimum over the lanes is two warp instructions: the
// least order key (redux.sync), then the lowest lane that holds it, which
// is the lowest column of that t.  The least t of the block is taken over
// every t in range, and the ray's own lane keeps it only if it is at most
// its best: the same result as testing against the best, without its
// shuffle.  `keep_closest` keeps ties to the lowest slot whatever the order
// of the blocks.  Every lane of the warp calls it.
__device__ __forceinline__ void serve_cols_closest(const TriCols& cols, int n, bool has_col,
                                                   int base, unsigned rays, const Ray& a,
                                                   float t_min, float& best, int& best_slot) {
  const int lane = threadIdx.x & 31;
  if (__popc(rays) > kLaneRays) {
    const bool mine = (rays >> lane) & 1u;
    // t < t_lim <=> t <= best (+inf as the direction)
    const float t_lim = nextafterf(best, __int_as_float(0x7f800000));
    for (int j = 0; j < n; ++j) {
      const TriCols col_j = shfl_cols(cols, j);
      if (mine) keep_closest(tri_t(col_j, a.ox, a.oy, a.oz, a, t_min, t_lim), base + j, best,
                             best_slot);
    }
    return;
  }
  for (; rays; rays &= rays - 1) {
    const int src = __ffs(static_cast<int>(rays)) - 1;
    const Ray q = shfl_ray(a, src);
    const float t = has_col ? tri_t(cols, q.ox, q.oy, q.oz, q, t_min, FLT_MAX) : kMissT;
    const unsigned key = order_key(t);
    const unsigned low = __reduce_min_sync(kFullMask, key);
    const int col = __ffs(static_cast<int>(__ballot_sync(kFullMask, key == low))) - 1;
    if (lane == src) keep_closest(key_float(low), base + col, best, best_slot);
  }
}

// Closest hit: `warp_serve_closest`'s contract, each block of 32 columns
// served by `serve_cols_closest`, lowest first.
__device__ __forceinline__ void lane_serve_closest(
    int chunk, const float* __restrict__ w, int tc, const float* __restrict__ wanchor,
    int n_chunks, const Ray& r, float t_min, float& best, int& best_slot) {
  const int lane = threadIdx.x & 31;
  lane_serve(chunk, w, tc, wanchor, n_chunks, r,
             [&](int c, int j0, const TriCols& cols, const Ray& a, unsigned rays) {
    serve_cols_closest(cols, min(tc - j0, 32), j0 + lane < tc, c * tc + j0, rays, a, t_min, best,
                       best_slot);
  });
}

// Closest hit over leaves with a box per block of 32 slots (K5a, K4a,
// K6a): the groups of `lane_serve` (the lanes that offer one chunk, lowest offering
// lane first), and in a group's chunk `c` each block whose box (`blocks`,
// (C, ceil(Tc / 32), 6), world coordinates, inverted over padding) some
// lane of the group enters before its own best, served by
// `serve_cols_closest` to those lanes alone, lowest block first; a block no
// lane enters costs each lane of the group one slab test and no load.  Its
// own copy of `lane_serve`'s group loop: sharing one loop changed K1's and
// K2's scheduled code.  Every lane of the warp calls it.
__device__ __forceinline__ void lane_serve_blocks_closest(
    int chunk, const float* __restrict__ w, int tc, const float* __restrict__ wanchor,
    int n_chunks, const float* __restrict__ blocks, const Ray& r, float t_min, Widen widen,
    float& best, int& best_slot) {
  const int lane = threadIdx.x & 31;
  const int n_blocks = (tc + 31) / 32;
  const unsigned same = __match_any_sync(kFullMask, chunk);
  for (unsigned want = __ballot_sync(kFullMask, chunk >= 0); want;) {
    const int lead = __ffs(static_cast<int>(want)) - 1;
    const unsigned group = __shfl_sync(kFullMask, same, lead);
    want &= ~group;
    const int c = __shfl_sync(kFullMask, chunk, lead);
    const bool mine = (group >> lane) & 1u;
    Ray a = r;
    a.ox = r.ox - wanchor[c];
    a.oy = r.oy - wanchor[n_chunks + c];
    a.oz = r.oz - wanchor[2 * n_chunks + c];
    const float* W = w + (size_t)c * 12 * tc;
    const float* box = blocks + (size_t)c * n_blocks * 6;
    for (int b = 0; b < n_blocks; ++b) {
      const unsigned rays =
          __ballot_sync(kFullMask, mine && enters(box + 6 * b, r, t_min, best, widen));
      if (!rays) continue;
      const int j0 = 32 * b;
      TriCols cols = {};
      if (j0 + lane < tc) cols = load_cols(W, tc, j0 + lane);
      serve_cols_closest(cols, min(tc - j0, 32), j0 + lane < tc, c * tc + j0, rays, a, t_min,
                         best, best_slot);
    }
  }
}

// One block of at most 32 columns, any hit: `cols` this lane's column
// (`has_col`), `rays` the lanes whose ray `a` is tested, one after the
// other across the columns, each against its own `t_max` (shuffled from its
// lane); `hit` becomes true on each such lane whose ray hits a column.
// Every lane of the warp calls it.
__device__ __forceinline__ void serve_cols_any(const TriCols& cols, bool has_col,
                                               unsigned rays, const Ray& a, float t_min,
                                               float t_max, bool& hit) {
  const int lane = threadIdx.x & 31;
  for (; rays; rays &= rays - 1) {
    const int src = __ffs(static_cast<int>(rays)) - 1;
    const Ray q = shfl_ray(a, src);
    const float q_max = __shfl_sync(kFullMask, t_max, src);
    const bool mine = has_col && tri_t(cols, q.ox, q.oy, q.oz, q, t_min, q_max) < kMissT;
    if (__any_sync(kFullMask, mine) && lane == src) hit = true;
  }
}

// Any hit: `warp_serve_any`'s contract, the rays of a group one after the
// other, each until its first block with a hit (`serve_cols_any`).
__device__ __forceinline__ bool lane_serve_any(
    int chunk, const float* __restrict__ w, int tc, const float* __restrict__ wanchor,
    int n_chunks, const Ray& r, float t_min, float t_max) {
  const int lane = threadIdx.x & 31;
  bool hit = false;
  lane_serve(chunk, w, tc, wanchor, n_chunks, r,
             [&](int, int j0, const TriCols& cols, const Ray& a, unsigned rays) {
    serve_cols_any(cols, j0 + lane < tc, rays & ~__ballot_sync(kFullMask, hit), a, t_min,
                   t_max, hit);
  });
  return hit;
}

// Any hit over leaves with a box per block of 32 slots (K5b, K4b): the
// groups of `lane_serve_blocks_closest`, and in a group's chunk `c` each
// block whose box some lane of the group enters before its own `t_max`,
// while that lane has no hit yet, served by `serve_cols_any` to those lanes
// alone, lowest block first; a block no such lane enters costs each lane of
// the group one slab test and no load.  True on each offering lane whose
// ray has a hit in (t_min, its t_max) in the chunk it offered.  Its own copy
// of the group loop, as `lane_serve_blocks_closest` has.  Every lane of the
// warp calls it.
__device__ __forceinline__ bool lane_serve_blocks_any(
    int chunk, const float* __restrict__ w, int tc, const float* __restrict__ wanchor,
    int n_chunks, const float* __restrict__ blocks, const Ray& r, float t_min, float t_max,
    Widen widen) {
  const int lane = threadIdx.x & 31;
  const int n_blocks = (tc + 31) / 32;
  bool hit = false;
  const unsigned same = __match_any_sync(kFullMask, chunk);
  for (unsigned want = __ballot_sync(kFullMask, chunk >= 0); want;) {
    const int lead = __ffs(static_cast<int>(want)) - 1;
    const unsigned group = __shfl_sync(kFullMask, same, lead);
    want &= ~group;
    const int c = __shfl_sync(kFullMask, chunk, lead);
    const bool mine = (group >> lane) & 1u;
    Ray a = r;
    a.ox = r.ox - wanchor[c];
    a.oy = r.oy - wanchor[n_chunks + c];
    a.oz = r.oz - wanchor[2 * n_chunks + c];
    const float* W = w + (size_t)c * 12 * tc;
    const float* box = blocks + (size_t)c * n_blocks * 6;
    for (int b = 0; b < n_blocks; ++b) {
      const unsigned rays =
          __ballot_sync(kFullMask, mine && !hit && enters(box + 6 * b, r, t_min, t_max, widen));
      if (!rays) continue;
      const int j0 = 32 * b;
      TriCols cols = {};
      if (j0 + lane < tc) cols = load_cols(W, tc, j0 + lane);
      serve_cols_any(cols, j0 + lane < tc, rays, a, t_min, t_max, hit);
    }
  }
  return hit;
}

}  // namespace wide_bvh
