// Probe kernels of the arity-8 BVH traversal: what a walk visits, and what
// each part of the closest-hit kernel costs on its own.
//
// Replaces the Pallas TPU kernels of the repository's root probe scripts:
//
//   visit_stats_kernel  tpu_visit_stats.py `_stats_kernel` (P3): per 256-ray
//                       tile, node visits, leaf visits, the summed share of
//                       the tile's rays that enter each opened leaf, and the
//                       leaf visits that lowered some ray's best t;
//   nodes_kernel        tpu_kernel_probe.py `_nodes_kernel` (P1 "nodes"): K1's
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
// visit_stats_kernel walks the tree as the TPU's streaming kernels do: one
// block of 256 rays per tile, a child visited if any ray of the block
// enters its widened box before that ray's best t as it stood at node
// entry, leaves near to far by the block's summed direction along the
// node's axis, internal children pushed far to near.  The optional seed
// chunk (the K largest triangles, anchored at their box centre) is tested
// first.  Lanes past the last ray are absent: they vote for no child and
// count towards no share (the TPU kernel pads the last tile with rays of
// origin 0 and direction 0, which enter every box that holds the origin).
// Given `work_out`, it also counts the work the four counts need: the child
// boxes of the visited nodes, times the tile's rays; the filled triangles
// of each opened leaf, times the rays whose slab entered it at node entry;
// and of those pairs, the ones whose t lies in (t_min, the ray's best t at
// the leaf), which then need their barycentrics.
//
// What bounded its first design on this card: at each opened leaf every
// ray of the block tested every column, staged in shared memory, behind
// two barriers a leaf and two a node besides the block's OR, as the TPU
// kernel tests the whole tile in one contraction.  On the Cornell bounces
// only 2-5% of a tile's rays enter a leaf it opens (0.6% on high_poly's
// first bounce), so 95-99% of its pair tests were for rays that could not
// lower their best there, and its time followed its leaf visits.
// What this design does about it: each opened leaf is served only to the
// rays whose own slab entered its widened box at node entry.  A ray that
// did not cannot lower its best t there (the widened boxes hold every hit
// the pair test accepts, ROADMAP F5), so every ray's best, the four counts
// and the work counts are those of testing every ray, the plain version's
// rule, which chip_smoke.py and the card tests hold it to.  Each warp
// serves its own entering rays from device memory (the chunks stay in L2),
// `serve_leaf`: lane j holds column j of each block of 32; a group of up to
// 24 rays is tested one ray at a time, the least t a `redux.sync` minimum,
// a larger group ray per lane with the columns shuffled to it; t first, the
// barycentrics behind a branch (`woop_t`'s expressions as they are); a warp
// none of whose rays entered a leaf skips it.  The walk takes one barrier a
// node, the block's OR, on which the warps' bits of the previous node's
// improving leaves ride (double-buffered by node parity); every thread
// keeps the node and the stack's depth and pops the next node itself,
// thread 0 alone writing the stack.  Node and leaf visits are the same on
// every thread and each warp sums its own entering rays and pairs, so
// thread 0 reads no per-child counts at a node (with that loop the kernel
// took 13-15% more time on the Cornell wavefronts, 4-8% on high_poly's).
// What bounds it now: the latency of the block-serial walk, 22-29 node
// visits a tile on the Cornell bounces, each a chain of 8 box loads and
// slab tests, a reduction and a barrier, with each warp's leaf services
// between two barriers; 14x its operation bound there, 17x on the primary
// rays.  On an NVIDIA H100 80GB HBM3 at 700 W (profile_torch_wide.py,
// family `stats`, in turns with the first design, 1080p wavefronts): the
// Cornell box's depths 1-4 over its leaf-32 tree 0.415, 1.558, 1.861, 1.881
// ms (first design 0.634, 8.044, 13.641, 14.563), seeded 0.575-2.147
// (0.820-14.882); high_poly's depths 1-2 over its leaf-128 tree 0.857 and
// 1.168 (4.718, 11.807).  Every ray tested through this walk and service
// (`every-ray`) took 0.84-0.93x the first design, so the service makes the
// gain; fetching the next node's row and the entered leaves into L1 first
// (`prefetch.global.L1`) took 2-20% more, testing the seed's columns
// against no running best 1-4% more, and register caps of 2, 3 or 5 blocks
// an SM (80, 76 or 48 registers, against 64 with 52 bytes spilled) 1-15%
// more.
//
// nodes_kernel is K1's walk as it ships (wide_bvh_walk.cuh `closest_walk`:
// one ray a thread in blocks of 128 under K1's register cap, one node a
// round, pending leaf children taken near to far and re-culled by slab,
// the warp's vote to end) with `NoServe`, a service that serves nothing.
// Nothing lowers a ray's best, so its node set is that of a walk with no
// far end, as the plain version counts it.  It writes t = kMissT, as the
// TPU kernel does, and each ray's node visits, counted by the walk
// (`kCountsVisits`: the walks of the other services compile as they did).
// `ray_tile` no longer sets the block (the entry point keeps it, and its
// callers their checks).  Its first design was K1's walk before the warp
// served its leaves, a thread-serial loop in blocks of `ray_tile` (up to
// 1,024 threads, 64 registers, its stack in local memory), whose time said
// nothing of K1's walk.  What bounds it: the latency of the warp's rounds,
// each a node's 8 box loads and slab tests, far above the bytes it moves
// (a known hit's cull saves 9% on the primary rays, 33% on the head, where
// rays visit more nodes; the walk visits 1.39 and 1.80 nodes a ray there,
// and a warp runs as many rounds as its longest walk).  On an NVIDIA
// H100 80GB HBM3 at 700 W (profile_torch_wide.py, family `nodes`, in turns,
// leaf 32): 0.0867 ms on the Cornell primary rays and 0.2051 on the sorted
// depth-2 head (first design 0.0738, 0.1543), where K1 takes 0.3995 and
// 0.5984.  Culled by each ray's final t from K1 (`known-hit`) the walk
// takes 0.0786 and 0.1383, so K1's leaf service is 80% and 77% of K1; the
// node rows staged in shared memory (`smem-rows`) save nothing on the
// primary rays and 4% on the head, so the node loads' latency is not what
// bounds the walk.
//
// What bounds the other kernels on an H100: the brute-force kernels are
// bound by operations (15 float32 operations per pair for t, 30 more for
// the barycentrics where t lies in range, against 67 TFLOP/s); every thread
// of a block reads the same Woop column in the row layout, and every lane
// of a warp the same ray in the transposed one.  empty_kernel is bound by
// the bytes it moves (4 read and 4 written a ray: 16.6 MB at 1080p, 5.0 us
// at 3.35 TB/s) and, from L2, by its launch.
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
#include "wide_bvh_walk.cuh"

namespace {

using namespace wide_bvh;

// Groups of more entering rays than this in a warp are served ray per lane,
// smaller ones one ray at a time across the columns: K1's threshold
// (wide_bvh_common.cuh kLaneRays).
constexpr int kStatsLaneRays = 24;

// This lane's column j of chunk `W` (device memory) as its b1, b2 and s
// blocks (x, y, z, 1); zero past the chunk's last column (t = -0 / 0 is NaN
// there, in no range).
__device__ __forceinline__ void load_col(const float* __restrict__ W, int tc, int j, float4& u,
                                         float4& v, float4& s) {
  u = v = s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (j < tc) {
    u = make_float4(W[j], W[3 * tc + j], W[6 * tc + j], W[9 * tc + j]);
    v = make_float4(W[tc + j], W[4 * tc + j], W[7 * tc + j], W[10 * tc + j]);
    s = make_float4(W[2 * tc + j], W[5 * tc + j], W[8 * tc + j], W[11 * tc + j]);
  }
}

__device__ __forceinline__ float4 shfl4(const float4& x, int src) {
  return make_float4(__shfl_sync(kFullMask, x.x, src), __shfl_sync(kFullMask, x.y, src),
                     __shfl_sync(kFullMask, x.z, src), __shfl_sync(kFullMask, x.w, src));
}

// One opened leaf, chunk `W`, served to `ent`, the lanes of the warp whose
// ray's own slab entered it at node entry: each such lane's least t in
// (t_min, best) at which its ray meets a column of the chunk, kMissT for
// none (`woop_t` against the ray's best before the leaf, split into t and,
// behind a branch, the barycentrics, its expressions as they are).  `a` is
// this lane's ray with its origin re-centred on the chunk's anchor.  Each
// lane adds to `in_range` the pairs it tested whose t lay in range.  A
// group of more than kStatsLaneRays rays has each lane test its own ray
// against the columns in turn, broadcast from lane j's registers by
// shuffles, the barycentrics' shuffles behind a branch the same on the
// warp; a smaller group tests its rays one after the other, one column per
// lane, the least t a `redux.sync` minimum of order keys.  Every lane of the
// warp calls it, with the same `ent`.
__device__ __forceinline__ float serve_leaf(const float* __restrict__ W, int tc, unsigned ent,
                                            const Ray& a, float t_min, float best,
                                            unsigned& in_range) {
  const int lane = threadIdx.x & 31;
  const bool mine = (ent >> lane) & 1u;
  const bool per_lane = __popc(ent) > kStatsLaneRays;
  float t_leaf = kMissT;
  for (int j0 = 0; j0 < tc; j0 += 32) {
    float4 u, v, s;
    load_col(W, tc, j0 + lane, u, v, s);
    if (per_lane) {
      const int n = min(32, tc - j0);
      for (int k = 0; k < n; ++k) {
        const float t = plane_t(shfl4(s, k), a.ox, a.oy, a.oz, a);
        const bool in = mine & (t > t_min) & (t < best);
        in_range += in;
        if (__any_sync(kFullMask, in)) {
          const float hit = inside_t(shfl4(u, k), shfl4(v, k), t, a.ox, a.oy, a.oz, a);
          if (in) t_leaf = fminf(t_leaf, hit);
        }
      }
      continue;
    }
    for (unsigned rays = ent; rays; rays &= rays - 1) {
      const int src = __ffs(static_cast<int>(rays)) - 1;
      const Ray q = shfl_ray(a, src);
      const float q_best = __shfl_sync(kFullMask, best, src);
      const float t = plane_t(s, q.ox, q.oy, q.oz, q);
      const bool in = (t > t_min) & (t < q_best);
      in_range += in;
      float hit = kMissT;
      if (in) hit = inside_t(u, v, t, q.ox, q.oy, q.oz, q);
      const unsigned low = __reduce_min_sync(kFullMask, order_key(hit));
      if (lane == src) t_leaf = fminf(t_leaf, key_float(low));
    }
  }
  return t_leaf;
}

// One block of kTile rays.  Every thread keeps the node and the stack's
// depth, the same on all, and pops the next node itself; thread 0 alone
// writes the stack.  The node's one barrier is the block's OR of its child
// bits; the warps' bits of the previous node's improving leaves ride on it,
// double-buffered by node parity.  Node and leaf visits are the same on
// every thread; each warp sums its own entering rays and pairs, and the
// block's sums are taken once at the end.
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
  __shared__ Walk s;  // its stack and block_signs' sums
  __shared__ unsigned warp_bits[2][kTileWarps];
  __shared__ unsigned warp_fell[2][kTileWarps];
  __shared__ unsigned long long block_sums[3];  // entering rays, entering pairs, pairs in range
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const int i = blockIdx.x * kTile + threadIdx.x;
  const bool valid = i < n_rays;
  Ray r = {};
  if (valid) r = load_ray(ox, oy, oz, dx, dy, dz, i);
  if (threadIdx.x < 3) block_sums[threadIdx.x] = 0;  // visible after block_signs' barrier
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
  // The counts: node visits, leaf visits and improving leaf visits (thread
  // 0's), the filled children of the visited nodes; the warp's entering
  // rays and pairs, and each lane's pairs in range.
  float nodes = 0.0f, leaves = 0.0f, improving = 0.0f;
  long long children = 0, pairs = 0;
  unsigned entered = 0, in_range = 0;
  unsigned fell_bits = 0;  // the warp's: the last node's leaves that lowered a ray's best t
  int node = 0, sp = 0, parity = 0;
  while (node >= 0) {
    const float* boxes = wbox + (size_t)node * kArity * 8;
    const int* codes = wchild + (size_t)node * kArity;
    const unsigned mine = valid ? live_children(boxes, codes, r, t_min, best, widen) : 0u;
    const unsigned bits = __reduce_or_sync(kFullMask, mine);
    if (lane == 0) {
      warp_bits[parity][warp] = bits;
      warp_fell[parity][warp] = fell_bits;
    }
    __syncthreads();  // the node's one barrier
    unsigned live = 0;
#pragma unroll
    for (int k = 0; k < kTileWarps; ++k) live |= warp_bits[parity][k];
    if (threadIdx.x == 0) {
      unsigned fell = 0;
      for (int k = 0; k < kTileWarps; ++k) fell |= warp_fell[parity][k];
      improving += static_cast<float>(__popc(fell));  // the previous node's leaves
    }
    parity ^= 1;
    unsigned leaf_bits = 0, filled = 0;
#pragma unroll
    for (int c = 0; c < kArity; ++c) {
      const int code = codes[c];
      if (code != -1) filled |= 1u << c;
      if (code <= -2) leaf_bits |= 1u << c;
    }
    leaf_bits &= live;
    nodes += 1.0f;
    leaves += static_cast<float>(__popc(leaf_bits));
    children += __popc(filled);
    const bool low_first = sign[waxis[node]];

    // The live internal children, far to near: all but the nearest pushed
    // (by thread 0), the nearest next; else the stack's top.  An entry is
    // read a node later at the earliest, after the node's barrier.
    int next = -1;
    for (int k = 0; k < kArity; ++k) {
      const int c = low_first ? kArity - 1 - k : k;
      const int code = codes[c];
      if (!((live >> c) & 1u) || code < 0) continue;
      if (next >= 0) {
        if (threadIdx.x == 0) s.stack[sp] = next;
        ++sp;
      }
      next = code;
    }
    const int following = next >= 0 ? next : sp > 0 ? s.stack[--sp] : -1;

    // The node's live leaves, near to far, each served to the warp's rays
    // that entered it (a branch the same on the warp).
    fell_bits = 0;
    for (int k = 0; k < kArity; ++k) {
      const int c = low_first ? k : kArity - 1 - k;
      if (!((leaf_bits >> c) & 1u)) continue;
      const unsigned ent = __ballot_sync(kFullMask, (mine >> c) & 1u);
      const int chunk = -2 - codes[c];
      entered += __popc(ent);
      if (work_out != nullptr) pairs += static_cast<long long>(__popc(ent)) * chunk_fill[chunk];
      if (!ent) continue;
      Ray a = r;
      a.ox = r.ox - wanchor[chunk];
      a.oy = r.oy - wanchor[n_chunks + chunk];
      a.oz = r.oz - wanchor[2 * n_chunks + chunk];
      const float t_leaf =
          serve_leaf(w + (size_t)chunk * 12 * tc, tc, ent, a, t_min, best, in_range);
      const bool fell = ((ent >> lane) & 1u) && t_leaf < best;
      if (__any_sync(kFullMask, fell)) fell_bits |= 1u << c;
      best = fminf(best, t_leaf);
    }
    node = following;
  }
  if (lane == 0) {
    warp_fell[parity][warp] = fell_bits;
    atomicAdd(&block_sums[0], static_cast<unsigned long long>(entered));
    if (work_out != nullptr) atomicAdd(&block_sums[1], static_cast<unsigned long long>(pairs));
  }
  if (work_out != nullptr) {
    const unsigned warp_in = __reduce_add_sync(kFullMask, in_range);
    if (lane == 0) atomicAdd(&block_sums[2], static_cast<unsigned long long>(warp_in));
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned fell = 0;
    for (int k = 0; k < kTileWarps; ++k) fell |= warp_fell[parity][k];
    improving += static_cast<float>(__popc(fell));  // the last node's leaves
    float* row = stats_out + 4 * (size_t)blockIdx.x;
    row[0] = nodes;
    row[1] = leaves;
    // The sum over opened leaves of each one's entering share n / kTile:
    // every partial sum is a multiple of 1 / kTile far below 2^24 / kTile,
    // so the sum of the integers, divided once, is the same float.
    row[2] = static_cast<float>(block_sums[0]) / static_cast<float>(kTile);
    row[3] = improving;
    if (work_out != nullptr) {
      long long* work = work_out + 3 * (size_t)blockIdx.x;
      work[0] = children * min(kTile, n_rays - static_cast<int>(blockIdx.x) * kTile);
      work[1] = static_cast<long long>(block_sums[1]);
      work[2] = static_cast<long long>(block_sums[2]);
    }
  }
}

// K1's walk (wide_bvh_walk.cuh `closest_walk`, K1's blocks and register
// cap) with the service that serves nothing: t = kMissT and each ray's
// node visits.
__global__ void __launch_bounds__(kWalkThreads, 8) nodes_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz, int n_rays,
    const float* __restrict__ wbox, const int* __restrict__ wchild,
    const int* __restrict__ waxis, float t_min, Widen widen,
    float* __restrict__ t_out, int* __restrict__ visits_out) {
  closest_walk<NoServe>(ox, oy, oz, dx, dy, dz, n_rays, wbox, wchild, waxis, nullptr, nullptr, 0,
                        0, t_min, widen, t_out, visits_out);
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
    visit_stats_kernel<<<tiles_for(n_rays), kTile, 0, static_cast<cudaStream_t>(stream)>>>(
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
    nodes_kernel<<<walk_blocks(n_rays), kWalkThreads, 0, static_cast<cudaStream_t>(stream)>>>(
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
