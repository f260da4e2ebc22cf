// Flat triangle chunks culled by their AABBs and by the AABBs of their runs
// of 32 triangles: closest hit (K7a) and any hit (K7b).
//
// Replaces the Pallas TPU kernels `_closest_kernel` and `_any_kernel` of
// heatray_tpu/ops/intersect_pallas.py.  Those hold the whole chunk table in
// VMEM and, for each 1024-ray tile, loop over every chunk: when any ray of
// the tile enters the chunk's box, the whole tile is tested against all of
// its triangles as one MXU contraction.  Ids are triangle ids (the chunks
// are in triangle order); ties in t go to the lowest id, as in the plain
// version.  A chunk whose box is inverted (every triangle masked out of the
// occluders) is skipped.
//
// K7a, closest hit: a walk per ray over the chunk list and each chunk's
// blocks of 32 triangles, with no block barrier.  The
// pack carries a box per block (`blocks`, ops/intersect_pallas.py), the
// same widened slab test culls by it (the pair test's tolerance is relative
// to the triangle's extent, which a block's box bounds as a chunk's does),
// and the warp serves a block only to its lanes whose ray enters it:
// - Each warp takes the chunks in batches of 32: every lane tests its ray's
//   widened slab against each chunk of the batch before its best hit, the
//   warp's least entry distance into each chunk is one `__reduce_min_sync`,
//   and a bitonic sort across the lanes orders the batch nearest entry
//   first, so that the rays' best hits cull the chunks behind them.
// - In a chunk some lane enters, each such lane tests the blocks' boxes in
//   turn against its current best; a block no lane enters costs the warp
//   one slab test per lane, padding blocks (inverted boxes) are never
//   entered.
// - A block that some lanes enter is served as K1 serves a block of its
//   leaves (wide_bvh_common.cuh, `serve_cols_closest`): lane j holds
//   column j (staged by the warp), then a group of more than kLaneRays rays
//   tests ray per lane, the columns broadcast by shuffles, and a smaller
//   group one ray at a time across the lanes, the (t, column) minimum a
//   `__reduce_min_sync` and a ballot.  The rows carry no anchor, so the
//   rays are tested as they are.
// Ties in t go to the lowest id across blocks and chunks (`keep_closest`),
// so the result equals the plain brute force bit for bit in any order.
//
// What bounds it on an H100: latency and instruction rate, as for K1. Served
// whole, a chunk of 512 costs every ray that enters its box 512 exact pair
// tests, each some 60 float32 instructions (--fmad=false: a product and a
// sum are two; the IEEE divide): 1,348 a primary ray of the Cornell box, a
// quarter of them on the last chunk's padding, and 9.1-9.3x the time of the
// blocks (`profile_torch_wide.py --kernels k7`, variant `chunks`; NVIDIA
// H100 80GB HBM3, 700 W).  With the block boxes a primary ray tests 97 pairs
// (3.0 blocks), 1.10x what `chip_smoke.chunk_work` counts for the blocks it
// enters before its hit.  Index order costs 5-6% more, reads of the columns
// for each ray instead of shuffles 27-43% (16-byte reads 6-10%).  A block's
// rows are staged by `cp.async` (3 copies a lane in place of 12 reads): 1-2%
// faster than each lane reading its column from L1/L2 (variant `l2`; the
// Cornell box's pack is 221 KB, `high_poly`'s 14.4 MB, both within the 50 MB
// L2).  Tensor cores are not used: the pair test is exact float32 with
// separately rounded products, which TF32 (or 3xTF32) products cannot give,
// and a changed t moves hit masks at triangle edges (ROADMAP.md, F2).
//
// K7b, any hit: K7a's walk per ray (128 threads a block, no block barrier,
// no dynamic shared memory) in index order, with K2's any-hit service:
// - A lane enters a chunk when its ray's widened slab enters the chunk's
//   box before its own t_max; in an entered chunk, each unblocked lane that
//   entered it tests the blocks' boxes in turn against its t_max.
// - A block some lanes enter is served to them alone with K2's block
//   service (`serve_cols_any`): lane j holds column j (read from L1/L2),
//   and the rays are tested one after the other across the 32 columns,
//   each with its own t_max shuffled from its lane, the hit a vote.
// - A lane blocked by a hit enters nothing more, and the warp leaves when
//   every lane is blocked or past the last ray.  Any hit is a yes/no with no
//   tie, so the result equals the plain brute force in any order.
// What it replaced: one block of 256 rays walked the chunks in order,
// staged every chunk some ray entered (24 KB at Tc = 512) in shared memory
// behind two block barriers, and each entering thread tested all 512
// columns in turn: 7.4552 ms on the Cornell box's 2,073,600 first-bounce
// shadow lanes (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section 6).
//
// Layouts: w (C, 4, 3 Tc) f32 as in wide_bvh_common.cuh, with no anchor
// (the rows are the raw Woop rows); boxes (C, 6) f32 [min xyz, max xyz];
// blocks (C, ceil(Tc / 32), 6) f32, the boxes of each chunk's runs of 32
// columns.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "wide_bvh_common.cuh"

namespace {

using namespace wide_bvh;

// --- K7a: closest hit ---------------------------------------------------------

constexpr int kChunkThreads = 128;
constexpr int kBlock = 32;  // columns under one block box (BLOCK in the wrapper)
constexpr unsigned kNoEntry = 0xffffffffu;

// Where the ray enters a box, clamped to t_min: the order of the chunks.
// It is only an order, so the box is not widened.
__device__ __forceinline__ float entry_t(const float* __restrict__ b, const Ray& r,
                                         float t_min) {
  const float tx0 = (b[0] - r.ox) * r.ix, tx1 = (b[3] - r.ox) * r.ix;
  const float ty0 = (b[1] - r.oy) * r.iy, ty1 = (b[4] - r.oy) * r.iy;
  const float tz0 = (b[2] - r.oz) * r.iz, tz1 = (b[5] - r.oz) * r.iz;
  return fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fmaxf(fminf(tz0, tz1), t_min));
}

// The 32 lanes' keys in ascending order, the k-th smallest on lane k (a
// bitonic sort across the warp).
__device__ __forceinline__ unsigned warp_sort(unsigned key) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const unsigned other = __shfl_xor_sync(kFullMask, key, j);
      const bool keep_min = ((lane & j) == 0) == ((lane & k) == 0);
      key = keep_min ? min(key, other) : max(key, other);
    }
  }
  return key;
}

// The block of columns j0 .. j0 + 31 of chunk `W` (ids from `id0 + j0`)
// to the lanes of `rays` (`serve_cols_closest`).  Every lane of the warp
// calls it.  A whole block is first staged in the warp's shared memory, 12
// rows of 32 floats by 16-byte `cp.async` copies (3 a lane), and lane j
// takes column j from there.
__device__ __forceinline__ void serve_block(const float* __restrict__ W, int tc, int j0,
                                            int id0, unsigned rays, const Ray& r, float t_min,
                                            float& best, int& best_id) {
  __shared__ float4 staged[kChunkThreads / 32][12][kBlock / 4];
  const int lane = threadIdx.x & 31;
  const int n = min(tc - j0, kBlock);
  TriCols cols = {};
  if (n == kBlock && tc % 4 == 0) {  // staged: every row 16-byte aligned
    float4(*rows)[kBlock / 4] = staged[threadIdx.x / 32];
    for (int p = lane; p < 12 * kBlock / 4; p += 32) {
      const int row = p / (kBlock / 4), q = p % (kBlock / 4);  // row 4 g + f
      __pipeline_memcpy_async(&rows[row][q], W + (row % 4) * 3 * tc + (row / 4) * tc + j0 + 4 * q,
                              16);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncwarp();
    const float* col = reinterpret_cast<const float*>(rows);
#pragma unroll
    for (int g = 0; g < 3; ++g) {
#pragma unroll
      for (int f = 0; f < 4; ++f) cols.c[g][f] = col[(4 * g + f) * kBlock + lane];
    }
    __syncwarp();  // every lane holds its column before the next block's copies
  } else if (lane < n) {
    cols = load_cols(W, tc, j0 + lane);
  }
  serve_cols_closest(cols, n, lane < n, id0 + j0, rays, r, t_min, best, best_id);
}

__global__ void __launch_bounds__(kChunkThreads) closest_chunks_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz, int n_rays,
    const float* __restrict__ blocks, const float* __restrict__ w,
    const float* __restrict__ boxes, int n_chunks, int tc, float t_min, Widen widen,
    float* __restrict__ t_out, int* __restrict__ id_out) {
  const int i = blockIdx.x * kChunkThreads + threadIdx.x;
  const bool valid = i < n_rays;
  if (!__any_sync(kFullMask, valid)) return;  // the whole warp is past the end
  const int lane = threadIdx.x & 31;
  const int n_blocks = (tc + kBlock - 1) / kBlock;
  Ray r = {};
  if (valid) r = load_ray(ox, oy, oz, dx, dy, dz, i);

  float best = kMissT;
  int best_id = -1;
  for (int base = 0; base < n_chunks; base += 32) {
    const int n = min(32, n_chunks - base);
    // Lane k: chunk base + k's key, the warp's least entry into it over the
    // rays that enter its widened box before their best, its low 5 bits
    // replaced by k (an entry is never NaN, so its key stays below
    // kNoEntry), or kNoEntry.
    unsigned key = kNoEntry;
    for (int k = 0; k < n; ++k) {
      const float* box = boxes + 6 * (base + k);
      const bool in = valid && enters(box, r, t_min, best, widen);
      const unsigned near =
          __reduce_min_sync(kFullMask, in ? order_key(entry_t(box, r, t_min)) : kNoEntry);
      if (lane == k && near != kNoEntry) key = (near & ~31u) | k;
    }
    key = warp_sort(key);
    for (int k = 0; k < n; ++k) {
      const unsigned next = __shfl_sync(kFullMask, key, k);
      if (next == kNoEntry) break;  // sorted: no later chunk is entered either
      const int c = base + static_cast<int>(next & 31u);
      const bool mine = valid && enters(boxes + 6 * c, r, t_min, best, widen);
      if (!__any_sync(kFullMask, mine)) continue;
      const float* W = w + (size_t)c * 12 * tc;
      const float* block_box = blocks + (size_t)c * n_blocks * 6;
      for (int b = 0; b < n_blocks; ++b) {
        const bool in = mine && enters(block_box + 6 * b, r, t_min, best, widen);
        const unsigned rays = __ballot_sync(kFullMask, in);
        if (rays) serve_block(W, tc, b * kBlock, c * tc, rays, r, t_min, best, best_id);
      }
    }
  }
  if (valid) {
    t_out[i] = best;
    id_out[i] = best_id;
  }
}

// --- K7b: any hit ---------------------------------------------------------------

// The block of columns j0 .. j0 + 31 of chunk `W` to the lanes of `rays`,
// any hit, as K2 serves a block (`serve_cols_any`): `hit` becomes true on
// each whose ray hits a column before its own `t_max`.  Lane j reads column
// j from L1/L2: staging the block as K7a does, or a ray-per-lane branch for
// large groups, did not pay here (`profile_torch_wide.py --kernels k7`,
// variants `any-staged`, `any-lanes`).  Every lane of the warp calls it.
__device__ __forceinline__ void serve_block_any(const float* __restrict__ W, int tc, int j0,
                                                unsigned rays, const Ray& r, float t_min,
                                                float t_max, bool& hit) {
  const int lane = threadIdx.x & 31;
  const int n = min(tc - j0, kBlock);
  TriCols cols = {};
  if (lane < n) cols = load_cols(W, tc, j0 + lane);
  serve_cols_any(cols, lane < n, rays, r, t_min, t_max, hit);
}

__global__ void __launch_bounds__(kChunkThreads) any_chunks_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ t_max, int n_rays, const float* __restrict__ blocks,
    const float* __restrict__ w, const float* __restrict__ boxes, int n_chunks, int tc,
    float t_min, Widen widen, unsigned char* __restrict__ blocked_out) {
  const int i = blockIdx.x * kChunkThreads + threadIdx.x;
  const bool valid = i < n_rays;
  if (!__any_sync(kFullMask, valid)) return;  // the whole warp is past the end
  const int n_blocks = (tc + kBlock - 1) / kBlock;
  Ray r = {};
  float t_hi = 0.0f;
  if (valid) {
    r = load_ray(ox, oy, oz, dx, dy, dz, i);
    t_hi = t_max[i];
  }

  bool blocked = false;
  for (int c = 0; c < n_chunks; ++c) {
    const bool open = valid && !blocked;  // a blocked ray enters nothing more
    if (!__any_sync(kFullMask, open)) break;  // every ray of the warp is blocked
    const bool mine = open && enters(boxes + 6 * c, r, t_min, t_hi, widen);
    if (!__any_sync(kFullMask, mine)) continue;
    const float* W = w + (size_t)c * 12 * tc;
    const float* block_box = blocks + (size_t)c * n_blocks * 6;
    for (int b = 0; b < n_blocks; ++b) {
      const bool in = mine && !blocked && enters(block_box + 6 * b, r, t_min, t_hi, widen);
      const unsigned rays = __ballot_sync(kFullMask, in);
      if (rays) serve_block_any(W, tc, b * kBlock, rays, r, t_min, t_hi, blocked);
    }
  }
  if (valid) blocked_out[i] = blocked ? 1 : 0;
}

}  // namespace

// Plain C entry points for ctypes.  Each launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 = the launch was
// accepted).  `w` must be 16-byte aligned; `blocks` is (C, ceil(Tc / 32), 6).

extern "C" int closest_chunks(const float* ox, const float* oy, const float* oz,
                              const float* dx, const float* dy, const float* dz,
                              int n_rays, const float* blocks, const float* w,
                              const float* boxes, int n_chunks, int tri_chunk, float t_min,
                              float box_pad, float far_scale, float* t_out,
                              int* id_out, void* stream) {
  if (n_rays > 0) {
    closest_chunks_kernel<<<(n_rays + kChunkThreads - 1) / kChunkThreads, kChunkThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        ox, oy, oz, dx, dy, dz, n_rays, blocks, w, boxes, n_chunks, tri_chunk, t_min,
        Widen{box_pad, far_scale}, t_out, id_out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int any_chunks(const float* ox, const float* oy, const float* oz,
                          const float* dx, const float* dy, const float* dz,
                          const float* t_max, int n_rays, const float* blocks, const float* w,
                          const float* boxes, int n_chunks, int tri_chunk,
                          float t_min, float box_pad, float far_scale,
                          unsigned char* blocked_out, void* stream) {
  if (n_rays > 0) {
    any_chunks_kernel<<<(n_rays + kChunkThreads - 1) / kChunkThreads, kChunkThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        ox, oy, oz, dx, dy, dz, t_max, n_rays, blocks, w, boxes, n_chunks, tri_chunk,
        t_min, Widen{box_pad, far_scale}, blocked_out);
  }
  return static_cast<int>(cudaGetLastError());
}
