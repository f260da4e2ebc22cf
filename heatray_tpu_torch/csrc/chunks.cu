// Flat triangle chunks culled by their AABBs: closest hit (K7a) and any hit
// (K7b).
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
// K7b, any hit: one block of 256 rays (one a thread) walks the chunks in
// order.  Each thread runs the widened slab test against the chunk's box,
// and when any unblocked ray of the block enters it (`__syncthreads_or`)
// the block copies the chunk's (4, 3 Tc) columns (24 KB at Tc = 512) into
// shared memory; only the threads whose own ray enters then test its
// triangles, in exact f32.  A blocked ray tests nothing more, and the block
// leaves once every ray in it is blocked.
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

__device__ __forceinline__ bool enters(const float* __restrict__ box, const Ray& r,
                                       float t_min, float t_far, Widen widen) {
  return box[0] <= box[3] && slab(box, r, t_min, t_far, widen);
}

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

constexpr int kTile = 256;

// Every thread copies its share of chunk `c` into shared memory.
__device__ __forceinline__ void stage(const float* __restrict__ w, int c,
                                      int chunk_floats, float* chunk) {
  const float4* src = reinterpret_cast<const float4*>(w + (size_t)c * chunk_floats);
  float4* dst = reinterpret_cast<float4*>(chunk);
  for (int p = threadIdx.x; p < chunk_floats / 4; p += kTile) dst[p] = src[p];
}

__global__ void __launch_bounds__(kTile) any_chunks_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ t_max, int n_rays, const float* __restrict__ w,
    const float* __restrict__ boxes, int n_chunks, int tc, float t_min,
    Widen widen, unsigned char* __restrict__ blocked_out) {
  extern __shared__ float4 chunk_mem[];
  float* chunk = reinterpret_cast<float*>(chunk_mem);
  const int chunk_floats = 12 * tc;

  const int i = blockIdx.x * kTile + threadIdx.x;
  const bool valid = i < n_rays;
  Ray r = {};
  float t_hi = 0.0f;
  if (valid) {
    r = load_ray(ox, oy, oz, dx, dy, dz, i);
    t_hi = t_max[i];
  }

  bool blocked = false;
  // The same on every thread: some ray of the block is still unblocked.
  bool alive = __syncthreads_or(valid);
  for (int c = 0; c < n_chunks && alive; ++c) {
    const bool mine = valid && !blocked && enters(boxes + 6 * c, r, t_min, t_hi, widen);
    if (!__syncthreads_or(mine)) continue;
    stage(w, c, chunk_floats, chunk);
    __syncthreads();
    if (mine) {
      for (int j = 0; j < tc; ++j) {
        if (tri_t(chunk, tc, j, r.ox, r.oy, r.oz, r, t_min, t_hi) < kMissT) {
          blocked = true;  // the first occluder ends this ray's tests
          break;
        }
      }
    }
    alive = __syncthreads_or(valid && !blocked);
  }
  if (valid) blocked_out[i] = blocked ? 1 : 0;
}

// K7b's dynamic shared memory for chunks of `tc`.  Up to the default 48 KB
// (a chunk of 1,024) it needs no opt-in, so the render path's launches make
// no call; above, the kernel's opt-in is made per launch (past the block's
// 227 KB it fails).
cudaError_t chunk_memory(int tc, size_t* bytes) {
  *bytes = sizeof(float) * 12 * (size_t)tc;
  if (*bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(any_chunks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*bytes));
}

}  // namespace

// Plain C entry points for ctypes.  Each launches on `stream`, does not
// synchronise, and returns the first CUDA error (0 = the launch was
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
                          const float* t_max, int n_rays, const float* w,
                          const float* boxes, int n_chunks, int tri_chunk,
                          float t_min, float box_pad, float far_scale,
                          unsigned char* blocked_out, void* stream) {
  if (n_rays > 0) {
    size_t bytes = 0;
    const cudaError_t err = chunk_memory(tri_chunk, &bytes);
    if (err != cudaSuccess) return refused(err);
    any_chunks_kernel<<<(n_rays + kTile - 1) / kTile, kTile, bytes,
                        static_cast<cudaStream_t>(stream)>>>(
        ox, oy, oz, dx, dy, dz, t_max, n_rays, w, boxes, n_chunks, tri_chunk,
        t_min, Widen{box_pad, far_scale}, blocked_out);
  }
  return static_cast<int>(cudaGetLastError());
}
