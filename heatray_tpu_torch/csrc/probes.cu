// Probe kernels of the arity-8 BVH traversal: what a walk visits, and what
// each part of the closest-hit kernel costs on its own.
//
// Replaces the Pallas TPU kernels of the repository's root probe scripts:
//
//   visit_stats_kernel  tpu_visit_stats.py `_stats_kernel` (P3): per 256-ray
//                       tile, node visits, leaf visits, the summed share of
//                       the tile's rays that enter each opened leaf, and the
//                       leaf visits that lowered some ray's best t;
//   nodes_kernel        tpu_kernel_probe.py `_nodes_kernel` (P1 "nodes"): the
//                       walk without its leaf tests;
//   rows_brute_kernel   tpu_kernel_probe.py `_leaves_kernel` (P1 "leaves") and
//                       tpu_vpu_leaf.py `_mxu_kernel` (P4): closest t of every
//                       ray over every column of every leaf chunk, each ray
//                       re-centred on the chunk's anchor (the row layout: a
//                       thread holds its rays, the columns come to it).  Both
//                       TPU kernels compute this one function (a loop over
//                       chunks of `_pair_hits`, then a min); on this card
//                       exact float32 needs no precision schedule, so one
//                       kernel stands for both;
//   warp_brute_kernel   tpu_vpu_leaf.py `_vpu_kernel` (P4): the same closest t
//                       in the transposed layout: the columns across the lanes
//                       of a warp, held in registers, and the rays broadcast
//                       to them one at a time from shared memory, a warp
//                       reduction giving each ray's minimum over the warp's
//                       columns;
//   empty_kernel        tpu_kernel_probe.py `_empty_kernel` (P1 "grid"):
//                       x * 0 over the rays, the cost of a launch that moves
//                       the rays' x plane.
//
// visit_stats_kernel walks the tree as the TPU's streaming kernels do
// (wide_bvh_block.cuh): one block of 256 rays per tile, a child visited
// if any ray of the block enters its widened box before that ray's best t
// as it stood at node entry, leaves near to far by the block's summed
// direction along the node's axis, internal children pushed far to near,
// leaf chunks staged by cp.async.  At each opened leaf every ray of the
// block is tested, as the TPU kernel does.
// The optional seed chunk (the K largest triangles, anchored at their box
// centre) is tested first.  Thread 0 keeps the four counts and writes the
// tile's row.  Lanes past the last ray are absent: they vote for no child
// and count towards no share (the TPU kernel pads the last tile with rays
// of origin 0 and direction 0, which enter every box that holds the origin).
// Given `work_out`, it also counts the work the four counts need: the child
// boxes of the visited nodes, times the tile's rays; the filled triangles
// of each opened leaf, times the rays whose slab entered it at node entry;
// and of those pairs, the ones whose t lies in (t_min, the ray's best t at
// the leaf), which then need their barycentrics.
//
// nodes_kernel is K1's walk as it stood before its leaf tests were served
// by the warp (one thread per ray, its own stack, near child first by its
// own direction) with the leaf test removed.  With no best hit to cull by,
// the set of nodes a ray visits depends neither on the order nor on that
// change: it is the node set of wide_bvh_walk.cuh's walk too.  Its time is
// that of a thread-serial loop, not of the walk's rounds of a warp (one
// visit a round, a vote to end), so it does not split K1's time between
// walk and leaves.  It writes t = kMissT, as the TPU kernel does, and each
// ray's node count, without which nothing would depend on the walk.
//
// What bounds them on an H100: the brute-force kernels are bound by
// operations (15 float32 operations per pair for t, 30 more for the
// barycentrics where t lies in range, against 67 TFLOP/s); every thread of
// a block reads the same Woop column in the row layout, and every lane of a
// warp the same ray in the transposed one.  The node walk and
// visit_stats_kernel are bound by the latency of their divergent or
// block-serial walks, far above the bytes they move; empty_kernel by the
// bytes it moves (4 read and 4 written a ray: 16.6 MB at 1080p, 5.0 us at
// 3.35 TB/s) and, from L2, by its launch.
//
// empty_kernel's geometry is the card's, not the TPU's: the ray tile is the
// TPU probe's grid step, and `ray_tile` no longer sets the block (the entry
// point keeps it, and its callers their checks).  A block is kEmptyThreads
// threads, each taking kEmptyVecs float4s a trip, all loaded before any is
// stored, by loads that bypass L1 and streaming stores (__ldcs, __stcs),
// in a block-strided loop over a grid of as many blocks as the float4s
// need.  Where x and out sit at the same offset from a 16-byte boundary,
// the floats before it and past the last whole float4 go one at a time to
// 8 threads of the first block, once; otherwise (an unaligned view beside
// an aligned output) every float goes alone.  The earlier design took
// `ray_tile` / 4 threads a block, one float4 each behind a branch on the
// alignment in every thread: 8,100 blocks of 64 threads at tile 256.  On an
// NVIDIA H100 80GB HBM3 at 700 W (profile_torch_wide.py, family `grid`, in
// turns, device time a call over 2,073,600 floats, three runs): 0.0038-
// 0.0041 ms from L2 at every tile, into one output or a new one each call,
// torch.mul(x, 0.0)'s 0.0039-0.0042 (2,025 blocks of 128 threads), the
// earlier design's 0.0062 at tile 256; over inputs and outputs past the
// L2 0.0071-0.0074 ms, 67-70% of the bound, torch.mul's 0.0074-0.0075.
// Blocks of 128 or 512, 1 or 4 float4s a thread, a grid of one wave and
// loads through L1 all land within 0.0003 ms of it; 2 float4s read best.
//
// rows_brute_kernel is tiled so that the float32 pipe, not the load pipe,
// sets its pace.  A block takes `ray_tile` rays and each of its ray_tile / 4
// threads holds kRowRays = 4 of them in registers (origin, direction, the
// origin re-centred on the current chunk's anchor, the best t).  The
// chunks' columns, in the flat slot order (chunk c's column j is slot
// c Tc + j), are staged kStageCols at a time into shared memory by 4-byte
// cp.async, double-buffered (the next tile's copy is in flight while this
// one is tested), and transposed on the way: column k's 12 Woop values sit
// at 16-byte-aligned [12 k, 12 k + 12) as b1, b2, s, each (x, y, z, 1).  So
// every thread of a block reads the same column, as a broadcast, and one
// 16-byte read of its s block serves the t of all its rays.  Each column's
// `woop_t` is split in two: the t of all of a thread's rays, then, behind
// one branch, the b1 and b2 reads and the barycentrics of each ray whose t
// lies in range (on the Cornell box about three quarters of the filled
// columns a ray meets before its hit).  Where the thread-per-ray
// kernel it replaces issued 12 global loads per pair (the load pipe set its
// pace), this one issues a quarter of a shared load per pair.  A tile may
// span chunks: each run of one chunk's columns re-centres the rays on that
// chunk's anchor once.  The anchor is subtracted once per ray per chunk and
// each ray's best t is its t_max, as before, which culls nothing the
// minimum would keep; each pair's arithmetic is `woop_t`'s, and the
// minimum does not depend on the order, so t is the thread-per-ray
// kernel's on every ray.
//
// What bounds it now: instruction issue, on the float32 pipe.  With
// --fmad=false every multiply and add is an instruction of its own: a
// pair's t is 11, the IEEE division about 8 more (a reciprocal on the
// special-function unit, its Newton steps and a range check, where the
// bound counts one operation) and its range test 2; its barycentrics, where
// t lies in range, about 30.  The bound counts operations at the card's
// fused multiply-add rate, two a lane and cycle, which unfused code cannot
// reach.  Four independent rays a thread keep several divisions in flight
// and share each column's reads; a thread whose rays all miss a column's
// range skips its barycentrics.  No tensor cores: the Woop contraction has
// depth 4 (x, y, z, 1), below any mma or wgmma depth, and TF32 would break
// the exact float32 contract the pair test shares with the plain version.
//
// warp_brute_kernel keeps that layout, which is what sets it apart from
// rows_brute_kernel, and the same per-pair arithmetic.  A block takes
// `ray_tile` rays and copies them once, by 4-byte cp.async, into shared
// memory (origin and direction as two 16-byte records, at most 32 KB): the
// whole tile fits, and every column slice reads all of it, so it is staged
// once and not streamed.  The columns stay still: a slice is kSliceCols =
// 128 consecutive columns of one chunk, and lane j holds columns j, j + 32,
// j + 64, j + 96 of it in registers (kWarpCols = 4 of them, 12 floats
// each), loaded once per run of units (the first while the rays' copy is in
// flight).  The work is the block's (slice, 32 rays) units, slice-major;
// each of the block's 4 warps takes an equal run of them, so a warp reloads
// its registers only where its run crosses into the next slice, and the
// warps stay within one unit of each other whatever the chunk count.  With
// 95 registers a thread, blocks of 128 threads let 5 blocks share an SM
// (20 warps), where blocks of 256 left 16 warps and took 14% more time, and
// blocks of 64 (118 registers) 20% more (profile_torch_wide.py, family
// `brute`, on an H100); 2 columns a lane (60 registers, more warps, half the
// divisions in flight) took 9% more, 8 columns (158 registers) 3x, and two
// rays an iteration (a variant since dropped) 2% more.  Each ray is read
// from shared memory as a broadcast and re-centred on the slice's chunk
// anchor once for its four pairs on every lane; the four t are independent,
// so four divisions are in flight; the barycentrics sit behind one branch a lane
// (`woop_t` split as in rows_brute_kernel, its expressions as they are; a
// warp runs the branch where any lane's t lies in range, which on this
// scene is almost every ray).  Each ray's best t so far lives in shared
// memory as an order key (wide_bvh_common.cuh `order_key`): every lane culls
// by it, as the TPU kernel's `best` carried through its chunk loop, and one
// `redux.sync` minimum over the warp's 128 pairs, then one shared-memory
// `atomicMin` where it found a hit, lowers it.  (Where a warp takes the
// barycentric branch for nearly every ray, the branch saves nothing: with
// every lane's barycentrics computed for every ray, the kernel took 4% less
// time at P4's tc 128 and 1% less at tc 512.  It stays, so that the two
// layouts run one schedule of the pair's arithmetic.)  The bound only ever
// holds hits, so it is never below the final minimum and drops nothing the
// minimum keeps: t is the same on every ray whatever the order the warps run
// in.  The parent design (a warp's 32 rays one after the other, each lane
// reading its columns' 12 values from device memory for every ray and
// culling by its own running minimum) read each column once per ray; this
// one reads it once per block.
// They are probes: nothing else here is tuned.
//
// Numerics, layouts, the slab and pair tests: wide_bvh_common.cuh.

#include <cuda_runtime.h>

#include "wide_bvh_block.cuh"

namespace {

using namespace wide_bvh;

constexpr int kStackDepth = 64;  // K1's per-thread stack

// Does t of ray `r` against column j of chunk `W` lie in (t_min, t_max)?
// tri_t's t, in its order.
__device__ __forceinline__ bool t_in_range(const float* __restrict__ W, int tc, int j,
                                           float ax, float ay, float az, const Ray& r,
                                           float t_min, float t_max) {
  const int stride = 3 * tc;
  const int s = 2 * tc + j;
  const float* c0 = W;               // feature row x
  const float* c1 = W + stride;      // feature row y
  const float* c2 = W + 2 * stride;  // feature row z
  const float* c3 = W + 3 * stride;  // feature row 1
  const float pos = ax * c0[s] + ay * c1[s] + az * c2[s] + c3[s];
  const float pds = r.dx * c0[s] + r.dy * c1[s] + r.dz * c2[s];
  const float t = -pos / pds;
  return t > t_min && t < t_max;
}

__global__ void __launch_bounds__(kTile) visit_stats_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz, int n_rays,
    const float* __restrict__ wbox, const int* __restrict__ wchild,
    const int* __restrict__ waxis, const float* __restrict__ w,
    const float* __restrict__ wanchor, int n_chunks, int tc,
    const float* __restrict__ seed_w, const float* __restrict__ seed_anchor,
    int seed_k, float t_min, Widen widen, float* __restrict__ stats_out,
    const int* __restrict__ chunk_fill, long long* __restrict__ work_out) {
  __shared__ Walk s;
  __shared__ int warp_count[kTileWarps][kArity];
  __shared__ unsigned long long in_range_sum;
  extern __shared__ float4 slot_mem[];
  float* slots = reinterpret_cast<float*>(slot_mem);
  const int chunk_floats = 12 * tc;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const int i = blockIdx.x * kTile + threadIdx.x;
  const bool valid = i < n_rays;
  Ray r = {};
  if (valid) r = load_ray(ox, oy, oz, dx, dy, dz, i);
  bool sign[3];
  block_signs(s, valid, r, sign);

  float best = kMissT;
  if (valid && seed_k > 0) {
    const float ax = r.ox - seed_anchor[0];
    const float ay = r.oy - seed_anchor[1];
    const float az = r.oz - seed_anchor[2];
    for (int j = 0; j < seed_k; ++j) {
      best = fminf(best, tri_t(seed_w, seed_k, j, ax, ay, az, r, t_min, best));
    }
  }
  // Thread 0's counts: node visits, leaf visits, summed overlap share,
  // improving leaf visits.
  float nodes = 0.0f, leaves = 0.0f, overlap = 0.0f, improving = 0.0f;
  // With work_out: thread 0's filled children and entering pairs, and each
  // thread's pairs in range.
  long long children = 0, pairs = 0;
  unsigned long long in_range = 0;
  if (threadIdx.x == 0) {
    s.node = 0;
    s.sp = 0;
    in_range_sum = 0;
  }
  __syncthreads();
  for (int node = s.node; node >= 0; node = s.node) {
    const float* boxes = wbox + (size_t)node * kArity * 8;
    const int* codes = wchild + (size_t)node * kArity;
    const unsigned mine = valid ? live_children(boxes, codes, r, t_min, best, widen) : 0u;
#pragma unroll
    for (int k = 0; k < kArity; ++k) {
      const int n_in = __popc(__ballot_sync(kFullMask, (mine >> k) & 1u));
      if (lane == 0) warp_count[warp][k] = n_in;
    }
    const unsigned live = block_or(s, mine);  // its barrier also publishes warp_count
    const bool low_first = sign[waxis[node]];
    nodes += 1.0f;
    if (work_out != nullptr && threadIdx.x == 0) {
      for (int k = 0; k < kArity; ++k) children += codes[k] != -1;
    }

    const int n = stage_leaves(codes, live, low_first, w, chunk_floats, slots);
    for (int k = 0, q = 0; k < kArity; ++k) {
      const int c = low_first ? k : kArity - 1 - k;
      const int code = codes[c];
      if (!((live >> c) & 1u) || code > -2) continue;
      cp_async_wait(n - 1 - q);
      __syncthreads();  // slot q has arrived for every thread's share
      bool fell = false;
      if (valid) {
        const int chunk = -2 - code;
        const float ax = r.ox - wanchor[chunk];
        const float ay = r.oy - wanchor[n_chunks + chunk];
        const float az = r.oz - wanchor[2 * n_chunks + chunk];
        const float* W = slots + q * chunk_floats;
        float t_leaf = kMissT;
        for (int j = 0; j < tc; ++j) {
          t_leaf = fminf(t_leaf, tri_t(W, tc, j, ax, ay, az, r, t_min, best));
        }
        if (work_out != nullptr && ((mine >> c) & 1u)) {
          for (int j = 0; j < tc; ++j) {
            in_range += t_in_range(W, tc, j, ax, ay, az, r, t_min, best);
          }
        }
        fell = t_leaf < best;
        best = fminf(best, t_leaf);
      }
      const bool any_fell = __syncthreads_or(fell);
      if (threadIdx.x == 0) {
        int n_in = 0;
        for (int v = 0; v < kTileWarps; ++v) n_in += warp_count[v][c];
        leaves += 1.0f;
        overlap += static_cast<float>(n_in) / static_cast<float>(kTile);
        if (any_fell) improving += 1.0f;
        if (work_out != nullptr) {
          pairs += static_cast<long long>(n_in) * chunk_fill[-2 - code];
        }
      }
      ++q;
    }
    __syncthreads();  // every thread is done with the slots, warp_bits and warp_count
    push_and_pop(s, codes, live, low_first);
    __syncthreads();  // the next node is visible
  }
  if (work_out != nullptr) atomicAdd(&in_range_sum, in_range);
  __syncthreads();
  if (threadIdx.x == 0) {
    float* row = stats_out + 4 * (size_t)blockIdx.x;
    row[0] = nodes;
    row[1] = leaves;
    row[2] = overlap;
    row[3] = improving;
    if (work_out != nullptr) {
      long long* work = work_out + 3 * (size_t)blockIdx.x;
      work[0] = children * min(kTile, n_rays - static_cast<int>(blockIdx.x) * kTile);
      work[1] = pairs;
      work[2] = static_cast<long long>(in_range_sum);
    }
  }
}

__global__ void __launch_bounds__(1024) nodes_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz, int n_rays,
    const float* __restrict__ wbox, const int* __restrict__ wchild,
    const int* __restrict__ waxis, float t_min, Widen widen,
    float* __restrict__ t_out, int* __restrict__ visits_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const Ray r = load_ray(ox, oy, oz, dx, dy, dz, i);

  int stack[kStackDepth];
  int sp = 0;
  int node = 0;
  int visits = 0;
  while (node >= 0) {
    ++visits;
    const float* boxes = wbox + (size_t)node * kArity * 8;
    const int* codes = wchild + (size_t)node * kArity;
    const int axis = waxis[node];
    const float d_axis = axis == 0 ? r.dx : (axis == 1 ? r.dy : r.dz);
    const bool low_first = d_axis >= 0.0f;
    const unsigned live = live_children(boxes, codes, r, t_min, kMissT, widen);
    for (int k = 0; k < kArity; ++k) {  // far to near: the stack pops near first
      const int c = low_first ? kArity - 1 - k : k;
      const int code = codes[c];
      if (((live >> c) & 1u) && code >= 0) stack[sp++] = code;
    }
    node = sp > 0 ? stack[--sp] : -1;
  }
  t_out[i] = kMissT;
  visits_out[i] = visits;
}

constexpr int kRowRays = 4;       // rays a thread of rows_brute_kernel holds
constexpr int kStageCols = 128;   // columns staged in shared memory a tile

// `ray_tile` rays a block, kRowRays a thread (ray q of thread k is the
// block's ray q * blockDim.x + k), blockDim.x = ray_tile / kRowRays.
__global__ void __launch_bounds__(1024 / kRowRays) rows_brute_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz, int n_rays,
    const float* __restrict__ w, const float* __restrict__ wanchor, int n_chunks,
    int tc, int ray_tile, float t_min, float* __restrict__ t_out) {
  __shared__ float4 staged[2][kStageCols * 3];
  const int first = blockIdx.x * ray_tile + threadIdx.x;
  Ray r[kRowRays];
  float best[kRowRays];
#pragma unroll
  for (int q = 0; q < kRowRays; ++q) {
    const int i = first + q * blockDim.x;
    r[q] = Ray{};  // a ray past the end: direction 0, so t is never in range
    if (i < n_rays) {
      r[q].ox = ox[i];
      r[q].oy = oy[i];
      r[q].oz = oz[i];
      r[q].dx = dx[i];
      r[q].dy = dy[i];
      r[q].dz = dz[i];
    }
    best[q] = kMissT;
  }

  const int slots = n_chunks * tc;
  const int tiles = (slots + kStageCols - 1) / kStageCols;
  stage_cols(reinterpret_cast<float*>(staged[0]), w, tc, 0, min(kStageCols, slots));
  for (int k = 0; k < tiles; ++k) {
    const int s0 = k * kStageCols;
    const int n = min(kStageCols, slots - s0);
    if (k + 1 < tiles) {  // the next tile's copy, into the other buffer
      stage_cols(reinterpret_cast<float*>(staged[(k + 1) & 1]), w, tc, s0 + kStageCols,
                 min(kStageCols, slots - s0 - kStageCols));
      cp_async_wait(1);
    } else {
      cp_async_wait(0);
    }
    __syncthreads();  // tile k has arrived for every thread's share
    const float4* cols = staged[k & 1];
    for (int lo = 0; lo < n;) {  // one run of a chunk's columns
      const int c = (s0 + lo) / tc;
      const int hi = min(n, (c + 1) * tc - s0);
      const float cx = wanchor[c], cy = wanchor[n_chunks + c], cz = wanchor[2 * n_chunks + c];
      float ax[kRowRays], ay[kRowRays], az[kRowRays];
#pragma unroll
      for (int q = 0; q < kRowRays; ++q) {
        ax[q] = r[q].ox - cx;
        ay[q] = r[q].oy - cy;
        az[q] = r[q].oz - cz;
      }
      for (int j = lo; j < hi; ++j) {
        // `woop_t` against each ray's best, split in two: every ray's t,
        // then the barycentrics where some ray's t lies in range.
        const float4* col = cols + 3 * j;
        const float4 s = col[2];
        float t[kRowRays];
        bool in[kRowRays];
        bool any = false;
#pragma unroll
        for (int q = 0; q < kRowRays; ++q) {
          t[q] = plane_t(s, ax[q], ay[q], az[q], r[q]);
          in[q] = (t[q] > t_min) & (t[q] < best[q]);
          any |= in[q];
        }
        if (!any) continue;
        const float4 u = col[0], v = col[1];
#pragma unroll
        for (int q = 0; q < kRowRays; ++q) {
          const float hit = inside_t(u, v, t[q], ax[q], ay[q], az[q], r[q]);
          if (in[q]) best[q] = fminf(best[q], hit);
        }
      }
      lo = hi;
    }
    __syncthreads();  // every thread is done with tile k before its buffer is refilled
  }
#pragma unroll
  for (int q = 0; q < kRowRays; ++q) {
    const int i = first + q * blockDim.x;
    if (i < n_rays) t_out[i] = best[q];
  }
}

constexpr int kWarpCols = 4;                 // columns a lane of warp_brute_kernel holds
constexpr int kSliceCols = 32 * kWarpCols;   // columns a warp holds: a slice of one chunk
constexpr int kWarpThreads = 128;            // threads of a block of warp_brute_kernel
constexpr int kPartRays = 32;                // rays of one unit of a warp's work
constexpr int kMaxRayTile = 1024;

// Slice `slice` of the chunks `w` (chunk slice / per_chunk, its columns
// j0 .. j0 + kSliceCols - 1) in registers: this lane's column j0 + lane +
// 32 q as its b1, b2 and s blocks (x, y, z, 1), zero past the chunk's last
// column (t = -0 / 0 is NaN there, in no range), and the chunk's anchor.
__device__ __forceinline__ void load_slice(const float* __restrict__ w,
                                           const float* __restrict__ wanchor, int n_chunks,
                                           int tc, int per_chunk, int slice,
                                           float4 (&u)[kWarpCols], float4 (&v)[kWarpCols],
                                           float4 (&s)[kWarpCols], float& cx, float& cy,
                                           float& cz) {
  const int c = slice / per_chunk;
  const int j0 = (slice - c * per_chunk) * kSliceCols + (threadIdx.x & 31);
  const float* W = w + (size_t)c * kColFloats * tc;
#pragma unroll
  for (int q = 0; q < kWarpCols; ++q) {
    const int j = j0 + 32 * q;
    u[q] = v[q] = s[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (j < tc) {
      u[q] = make_float4(W[j], W[3 * tc + j], W[6 * tc + j], W[9 * tc + j]);
      v[q] = make_float4(W[tc + j], W[4 * tc + j], W[7 * tc + j], W[10 * tc + j]);
      s[q] = make_float4(W[2 * tc + j], W[5 * tc + j], W[8 * tc + j], W[11 * tc + j]);
    }
  }
  cx = wanchor[c];
  cy = wanchor[n_chunks + c];
  cz = wanchor[2 * n_chunks + c];
}

// `ray_tile` rays a block of kWarpThreads threads.  The block's rays sit in
// shared memory, each with the order key of its best t so far; the work is
// (slice, part of kPartRays rays) units, slice-major, and warp k takes the
// k-th of kWarpThreads / 32 equal runs of them.
__global__ void __launch_bounds__(kWarpThreads) warp_brute_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz, int n_rays,
    const float* __restrict__ w, const float* __restrict__ wanchor, int n_chunks,
    int tc, int ray_tile, float t_min, float* __restrict__ t_out) {
  // Ray k of the tile: its origin, with the order key of its best t in .w,
  // and its direction.
  __shared__ float4 org[kMaxRayTile], dir[kMaxRayTile];
  const int base = blockIdx.x * ray_tile;
  const int n = min(ray_tile, n_rays - base);
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    cp_async4(&org[k].x, ox + base + k);
    cp_async4(&org[k].y, oy + base + k);
    cp_async4(&org[k].z, oz + base + k);
    cp_async4(&dir[k].x, dx + base + k);
    cp_async4(&dir[k].y, dy + base + k);
    cp_async4(&dir[k].z, dz + base + k);
    org[k].w = __uint_as_float(order_key(kMissT));
  }
  cp_async_commit();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int parts = (n + kPartRays - 1) / kPartRays;
  const int per_chunk = (tc + kSliceCols - 1) / kSliceCols;
  const int units = n_chunks * per_chunk * parts;
  const int u1 = static_cast<int>(static_cast<long long>(warp + 1) * units / warps);
  int u = static_cast<int>(static_cast<long long>(warp) * units / warps);
  float4 cu[kWarpCols], cv[kWarpCols], cs[kWarpCols];
  float cx = 0.0f, cy = 0.0f, cz = 0.0f;
  int held = u / parts;  // the slice in registers, loaded while the rays arrive
  if (u < u1) load_slice(w, wanchor, n_chunks, tc, per_chunk, held, cu, cv, cs, cx, cy, cz);
  cp_async_wait(0);
  __syncthreads();  // the rays have arrived for every thread's share

  for (; u < u1; ++u) {
    const int slice = u / parts;
    if (slice != held) {
      held = slice;
      load_slice(w, wanchor, n_chunks, tc, per_chunk, held, cu, cv, cs, cx, cy, cz);
    }
    const int k0 = (u - slice * parts) * kPartRays;
    const int k1 = min(n, k0 + kPartRays);
    for (int k = k0; k < k1; ++k) {
      // The ray, broadcast to every lane, its origin re-centred on the
      // slice's chunk anchor once; its best t as it stands, which every
      // warp lowers, is the cull: a bound no smaller than the final
      // minimum drops no value that the minimum keeps.
      const float4 o = org[k], d = dir[k];
      Ray r = {};
      r.dx = d.x;
      r.dy = d.y;
      r.dz = d.z;
      const float bound = key_float(__float_as_uint(o.w));
      const float ax = o.x - cx, ay = o.y - cy, az = o.z - cz;
      // `woop_t` against the bound, split in two: the t of each of the
      // lane's columns, then the barycentrics where some t lies in range.
      float t[kWarpCols];
      bool in[kWarpCols];
      bool any = false;
#pragma unroll
      for (int q = 0; q < kWarpCols; ++q) {
        t[q] = plane_t(cs[q], ax, ay, az, r);
        in[q] = (t[q] > t_min) & (t[q] < bound);
        any |= in[q];
      }
      float hit = kMissT;
      if (any) {
#pragma unroll
        for (int q = 0; q < kWarpCols; ++q) {
          const float h = inside_t(cu[q], cv[q], t[q], ax, ay, az, r);
          if (in[q]) hit = fminf(hit, h);
        }
      }
      // One reduction for the warp's kSliceCols pairs of this ray.
      const unsigned low = __reduce_min_sync(kFullMask, order_key(hit));
      if (lane == 0 && low < order_key(kMissT)) {
        atomicMin(reinterpret_cast<unsigned*>(&org[k].w), low);
      }
    }
  }
  __syncthreads();  // every warp's minimum has been taken
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    t_out[base + k] = key_float(__float_as_uint(org[k].w));
  }
}

constexpr int kEmptyThreads = 256;         // threads of a block of empty_kernel
constexpr int kEmptyVecs = 2;              // float4s (or floats) a thread takes a trip

// x * 0 over `n` elements of type V (float4 or float) from x to out,
// kEmptyVecs a thread per trip of a block-strided loop: all its loads
// issued before any store, streamed past L1 (__ldcs, __stcs).
__device__ __forceinline__ float times_zero(float v) { return v * 0.0f; }
__device__ __forceinline__ float4 times_zero(float4 v) {
  return make_float4(v.x * 0.0f, v.y * 0.0f, v.z * 0.0f, v.w * 0.0f);
}

template <typename V>
__device__ __forceinline__ void zero_run(const V* __restrict__ x, int n, V* __restrict__ out) {
  constexpr int kStep = kEmptyThreads * kEmptyVecs;
  for (int i0 = blockIdx.x * kStep + threadIdx.x; i0 < n; i0 += gridDim.x * kStep) {
    V v[kEmptyVecs];
#pragma unroll
    for (int u = 0; u < kEmptyVecs; ++u) {
      if (i0 + u * kEmptyThreads < n) v[u] = __ldcs(x + i0 + u * kEmptyThreads);
    }
#pragma unroll
    for (int u = 0; u < kEmptyVecs; ++u) {
      if (i0 + u * kEmptyThreads < n) __stcs(out + i0 + u * kEmptyThreads, times_zero(v[u]));
    }
  }
}

// out = x * 0 over n floats.  With x and out at the same offset from a
// 16-byte boundary (`head` >= 0: the floats before it), the head and the
// tail past the last whole float4 go one float at a time to the first
// block's first 8 threads, and the float4s between to every thread; else
// (`head` < 0) every float goes alone.
__global__ void __launch_bounds__(kEmptyThreads) empty_kernel(const float* __restrict__ x, int n,
                                                               int head,
                                                               float* __restrict__ out) {
  if (head < 0) {
    zero_run(x, n, out);
    return;
  }
  const int vecs = (n - head) / 4;
  if (blockIdx.x == 0 && threadIdx.x < 8) {
    const int k = threadIdx.x < 4 ? threadIdx.x : head + 4 * vecs + threadIdx.x - 4;
    if (threadIdx.x < 4 ? k < head : k < n) out[k] = x[k] * 0.0f;
  }
  zero_run(reinterpret_cast<const float4*>(x + head), vecs, reinterpret_cast<float4*>(out + head));
}

inline int blocks_for(int n, int threads) { return (n + threads - 1) / threads; }

}  // namespace

// Plain C entry points for ctypes.  Each launches on `stream`, does not
// synchronise, and returns the first CUDA error (0 = the launch was
// accepted).  `ray_tile` is the rays of a block of the per-ray kernels (a
// multiple of 32, at most 1024; a thread each, but four a thread in
// rows_brute_kernel, and kWarpThreads threads for the whole tile in
// warp_brute_kernel); visit_stats_kernel's tile is 256, and empty_kernel's
// blocks do not depend on it.

extern "C" int probe_block_stack_depth() { return kBlockStack; }
extern "C" int probe_stack_depth() { return kStackDepth; }
extern "C" int probe_block_tile() { return kTile; }

extern "C" int probe_visit_stats(const float* ox, const float* oy, const float* oz,
                                 const float* dx, const float* dy, const float* dz,
                                 int n_rays, const float* wbox, const int* wchild,
                                 const int* waxis, const float* w, const float* wanchor,
                                 int n_chunks, int leaf_size, const float* seed_w,
                                 const float* seed_anchor, int seed_k, float t_min,
                                 float box_pad, float far_scale, float* stats_out,
                                 const int* chunk_fill, long long* work_out,
                                 void* stream) {
  if (n_rays > 0) {
    size_t bytes = 0;
    const cudaError_t err = slot_memory(visit_stats_kernel, leaf_size, &bytes);
    if (err != cudaSuccess) return refused(err);
    visit_stats_kernel<<<tiles_for(n_rays), kTile, bytes,
                         static_cast<cudaStream_t>(stream)>>>(
        ox, oy, oz, dx, dy, dz, n_rays, wbox, wchild, waxis, w, wanchor, n_chunks,
        leaf_size, seed_w, seed_anchor, seed_k, t_min, Widen{box_pad, far_scale},
        stats_out, chunk_fill, work_out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_nodes(const float* ox, const float* oy, const float* oz,
                           const float* dx, const float* dy, const float* dz,
                           int n_rays, const float* wbox, const int* wchild,
                           const int* waxis, int ray_tile, float t_min, float box_pad,
                           float far_scale, float* t_out, int* visits_out, void* stream) {
  if (n_rays > 0) {
    nodes_kernel<<<blocks_for(n_rays, ray_tile), ray_tile, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        ox, oy, oz, dx, dy, dz, n_rays, wbox, wchild, waxis, t_min,
        Widen{box_pad, far_scale}, t_out, visits_out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_rows(const float* ox, const float* oy, const float* oz,
                          const float* dx, const float* dy, const float* dz, int n_rays,
                          const float* w, const float* wanchor, int n_chunks,
                          int leaf_size, int ray_tile, float t_min, float* t_out,
                          void* stream) {
  if (n_rays > 0) {
    rows_brute_kernel<<<blocks_for(n_rays, ray_tile), ray_tile / kRowRays, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        ox, oy, oz, dx, dy, dz, n_rays, w, wanchor, n_chunks, leaf_size, ray_tile, t_min,
        t_out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_warp(const float* ox, const float* oy, const float* oz,
                          const float* dx, const float* dy, const float* dz, int n_rays,
                          const float* w, const float* wanchor, int n_chunks,
                          int leaf_size, int ray_tile, float t_min, float* t_out,
                          void* stream) {
  if (n_rays > 0) {
    warp_brute_kernel<<<blocks_for(n_rays, ray_tile), kWarpThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        ox, oy, oz, dx, dy, dz, n_rays, w, wanchor, n_chunks, leaf_size, ray_tile, t_min,
        t_out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_empty(const float* ox, int n_rays, int ray_tile, float* out,
                           void* stream) {
  if (n_rays > 0) {
    const size_t xa = reinterpret_cast<size_t>(ox), oa = reinterpret_cast<size_t>(out);
    const bool paired = ((xa ^ oa) & 15) == 0;
    const int head = paired ? min(static_cast<int>((16 - (xa & 15)) & 15) / 4, n_rays) : -1;
    const int items = paired ? (n_rays - head) / 4 : n_rays;
    const int blocks = max(blocks_for(items, kEmptyThreads * kEmptyVecs), 1);
    empty_kernel<<<blocks, kEmptyThreads, 0, static_cast<cudaStream_t>(stream)>>>(ox, n_rays,
                                                                                  head, out);
  }
  return static_cast<int>(cudaGetLastError());
}
