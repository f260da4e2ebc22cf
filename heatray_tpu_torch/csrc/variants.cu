// Variants of the block-wide BVH walk on a sorted bounce wavefront: how a
// node's live leaves are tested, and how the leaf tests are batched.
//
// Replaces the Pallas TPU kernels of the repository's root probe script
// tpu_kernel_variants_probe.py (P2):
//
//   variant_walk_kernel  `make_kernel` (run_variant): a tile-wide walk whose
//                        variants differ in the leaf step of each node:
//     kBranch  (v0)      a block-uniform branch per live leaf, then every ray
//                        of the block tests it (the TPU's `pl.when` per leaf);
//     kMasked  (v1)      every child slot tested, its update masked: a child
//                        that is not a live leaf tests chunk max(-2 - code, 0)
//                        with a bound below t_min, so the test runs in full
//                        up to its t and keeps nothing;
//     kQueue   (v2)      thread 0 writes the node's live leaves into a
//                        shared-memory queue, then the block drains it;
//     kNoSlot  (v3)      v0 keeping t only: slots stay -1;
//     kGroup   (v4/v5)   per live leaf, a group of `group` rays (1, 2 or 4
//                        warps) tests it only if one of its rays entered the
//                        leaf's box at node entry (the warps' ORs of
//                        block_or);
//   queue_walk_kernel    `make_kernel_v6`, `_v7` and `_v8`: the node walk
//                        appends live leaves to a shared-memory queue of 64
//                        entries across nodes; whenever it holds `batch` or
//                        more, the last `batch` are drained, each ray testing
//                        them all and merging the results once; the rest
//                        drains at the end.  Three anchors:
//     kTile    (v6)      the ray origins re-centred on the tile's origin
//                        centroid, and the unanchored leaf rows staged in
//                        shared memory with their translation re-centred on
//                        it (the TPU kernel re-centres the origins but not
//                        the rows, so it tests rays moved by minus the
//                        centroid: ROADMAP F10);
//     kNone    (v7)      unanchored rows, absolute coordinates;
//     kChunk   (v8)      the tree's anchored rows and per-chunk anchors.
//
// The walk is P3's (wide_bvh_block.cuh): a block is the ray tile, the node
// and the stack in shared memory, a child visited if any ray of the block
// enters its widened box before that ray's best t as it stood at node
// entry, leaves near to far and internal children pushed far to near by the
// block's summed direction.  The blocks are 256, 512 or 1024 threads; the
// queue kernel also runs tiles of 2,048 rays as 1,024 threads with two rays
// each (ray j of thread t is ray j * 1024 + t of the tile); the variant
// walk holds one ray a thread.  Lanes past the last ray are absent: they
// enter no box, test nothing and add nothing to a sum (the TPU kernels pad
// the last tile with rays of origin 0).  Both kernels stage the chunks they
// test in shared memory (the Cornell box's leaf-32 `w`, 263 KB, stays in
// L2).  Each kernel also writes, per tile, the ray-chunk tests it ran (a
// chunk tested by the whole tile counts its rays), which says what each
// variant's work was.
//
// Every barrier sits on a condition that is the same for the whole block
// (the node, its OR-ed child bits, the queue count, the drain count); v4's group test is the
// same across a group's warps and has no barrier under it.  Ties in t go to
// the lowest slot in every variant, so each computes the function of its
// plain version exactly (heatray_tpu_torch/probes/kernel_variants.py):
// v0-v2, v4 and v8 that of K1, v3 its t, v6 and v7 a brute force over the
// unanchored rows with the tile's centroid or no anchor.
//
// What bounds them on an H100: like K3, the pair tests of rays that do not
// enter the leaf they test, and the block-serial walk; the tree stays in
// L2, so device memory is not the limit.
//
// variant_walk_kernel's leaf service.  After the block's OR of its child
// bits, the chunks the node's leaf step tests are the same for every thread
// (the live leaves, or v1's every child slot), so they are copied once into
// shared memory, by 4-byte cp.async into 48-byte column records
// (wide_bvh_block.cuh `stage_cols`, one commit group a chunk), at most 8
// chunks of 12 tc floats (12 KB at tc 32).  The copies are issued before
// thread 0 writes v2's queue and pushes and pops the walk's stack, which
// needs no barrier of its own: every thread has read the node before
// the first barrier, and the next is read after the last.  Each thread then
// tests its ray against the staged columns, which every thread of the block
// reads as a broadcast: first the ray's t, then, behind one branch, the
// barycentrics where t lies in range and below its t so far in the chunk
// (`woop_t` split as in rows_brute_kernel, its expressions as they are).
// v4 skips, as a branch the same on the whole group, every leaf that none
// of its group's rays entered, so its threads test only the leaves their
// group counts.  The earlier design read each pair's 12 Woop values from
// device memory, one ray a thread, in every warp of the block.  Two rays a
// thread (half the threads) took 8% more time on v0 at tile 512 and 11-12%
// more at 1024 (profile_torch_wide.py, family `walk`, on an H100), so a
// thread holds one.  Its loop over a chunk's staged columns is unrolled 4
// times: the loop as written took 12% more time on v0 at tile 512, unrolled
// 2 times 5% more, 8 times the same.  A ray's leaves, its bound at each and
// the order of its tests are the earlier design's, so t, slot and the tests
// per tile are too.  They are probes: nothing else here is tuned.
//
// queue_walk_kernel's drains.  A drain's `batch` chunks (at most kMaxBatch,
// 24 KB at tc 32) are copied once into shared memory as the same column
// records, one commit group for the whole drain, each thread taking whole
// columns; v6's thread then re-centres the translation of the columns it
// copied itself, after its own wait and before the barrier, in the
// expression's order (`cx * x + cy * y + cz * z + w`; built with
// --fmad=false, so the rows are bit for bit the earlier design's).  Each ray
// tests chunk b of the drain with t first and the barycentrics behind one
// branch (`staged_closest`), against nextafter(min(bound, t_batch)): its
// best t before the drain or the drain's best so far, whichever is lower.
// A column above t_batch could never be taken, and one equal to it is kept,
// so that a later chunk's lower slot still wins a tie; the result is the
// earlier design's, where every chunk was tested against the stale bound.
// At tile 2048 a thread's two rays share each column's reads (the columns
// outside, the rays inside, `staged_closest_rays`).  The walk takes one
// barrier a node, the block's OR, whose warp bits alternate between two
// arrays by node parity, and one a drain, after its copy: every thread
// keeps the node, the stack's depth and the queue's length, the same on
// all, and pops the next node itself; thread 0 alone writes the stack and
// the queue, whose entries are read a node later at the earliest (a drain
// takes the node's own live leaves from its child codes).  The earlier
// design took three barriers a node besides the OR's, two more a drain for
// v6's scalar copy, and read each pair's 12 Woop values from device memory
// (v7, v8), one ray a thread.  A ray's leaves, its bound at each and the
// order of its tests are the earlier design's, so t, slot and the tests per
// tile are too.  On an NVIDIA H100 80GB HBM3 at 700 W (profile_torch_wide.py,
// family `queue`, in turns with the earlier design): v8 at batch 8 takes
// 2.82 ms at tile 512 (4.62 before), v7 and v6 at batch 4 2.72 (4.49,
// 3.76), v8 at tile 2048 5.61 (9.43).  With the drains' tests removed the
// walk takes 0.50 ms at tile 512, so the pair tests are about four fifths
// of the time, at about 420 Gpairs/s (rows_brute_kernel's exact tests:
// 516): issue on the float32 pipe bounds them, as it does the brute force.
// The tightened bound saves no measurable time (the stale one took 0.2%
// more to 1.7% less), nor do two drain buffers that drop the barrier
// between two drains of one node (1.6% less to 2.8% more); the two rays'
// loop unrolled 8 times takes 2-3% off tile 2048 against 4 or 2.
//
// Numerics, layouts, the slab and pair tests: wide_bvh_common.cuh.

#include <cuda_runtime.h>

#include "wide_bvh_block.cuh"

namespace {

using namespace wide_bvh;

constexpr int kQueueSize = 64;  // the TPU kernels' SMEM leaf queue
constexpr int kMaxBatch = 16;   // so that batch - 1 + 8 entries always fit
constexpr int kSlotBuffers = 1;  // queue_walk_kernel's drain buffers

enum class Variant { kBranch, kMasked, kQueue, kNoSlot, kGroup };
enum class Anchor { kTile, kNone, kChunk };

struct WalkArgs {
  const float *ox, *oy, *oz, *dx, *dy, *dz;
  int n_rays;
  const float* wbox;
  const int* wchild;
  const int* waxis;
  const float* w;  // (C, 4, 3 tc): anchored (with wanchor) or not
  const float* wanchor;
  int n_chunks;
  int tc;
  int param;  // kGroup: warps per group; queue_walk_kernel: batch
  float t_min;
  Widen widen;
  float* t_out;
  int* slot_out;
  int* tests_out;  // (tiles,)
};

// Per axis, the sum over the tile's rays of v (0 on absent lanes), the same
// on every thread, in a fixed order: a butterfly within each warp of 32
// rays, then the warps in ray order (kernel_variants.tile_sums).
template <int Threads, int Rays>
__device__ __forceinline__ void tile_sums(float (&part)[Rays * Threads / 32][3],
                                          const float (&v)[Rays][3], float out[3]) {
  constexpr int kWarps = Threads / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < Rays; ++j) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float s = warp_sum(v[j][a]);
      if (lane == 0) part[j * kWarps + warp][a] = s;
    }
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float t = 0.0f;
    for (int k = 0; k < Rays * kWarps; ++k) t += part[k][a];
    out[a] = t;
  }
  __syncthreads();  // part may be written again
}

__device__ __forceinline__ void take(float t, int slot, float& best, int& best_slot) {
  if (t < best || (t == best && t < kMissT && slot < best_slot)) {
    best = t;
    best_slot = slot;
  }
}

// The block's total of every thread's count, written by thread 0.
__device__ __forceinline__ void write_tests(int* total, int mine, int* out) {
  mine = __reduce_add_sync(kFullMask, mine);
  if ((threadIdx.x & 31) == 0) atomicAdd(total, mine);
  __syncthreads();
  if (threadIdx.x == 0) out[blockIdx.x] = *total;
}

// One leaf test of a thread's ray against the chunk staged at `cols`
// (column-major, kColFloats floats a column): `woop_t` of each column split
// in two, the ray's t, then, behind one branch, the barycentrics where t
// lies in (t_min, lim) and below its t so far.  t and col are the ray's
// closest hit over the chunk and its lowest column on ties ((kMissT, -1)
// without one): `chunk_closest` with t_max `lim`, or v3's running minimum
// with `lim` its best.
__device__ __forceinline__ void staged_closest(const float4* cols, int tc, const Ray& r,
                                               float ax, float ay, float az, float lim,
                                               float t_min, float& t, int& col) {
  t = kMissT;
  col = -1;
#pragma unroll 4
  for (int j = 0; j < tc; ++j) {
    const float4* c = cols + 3 * j;
    const float tj = plane_t(c[2], ax, ay, az, r);
    if (!((tj > t_min) & (tj < lim) & (tj < t))) continue;
    if (inside_t(c[0], c[1], tj, ax, ay, az, r) < kMissT) {
      t = tj;
      col = j;
    }
  }
}

// A block of `Threads` threads, one ray each.  The node's tested chunks are
// staged in the dynamic shared memory, kArity slots of kColFloats tc floats.
template <Variant V, int Threads>
__global__ void __launch_bounds__(Threads) variant_walk_kernel(WalkArgs a) {
  __shared__ BlockWalk<Threads> s;
  __shared__ float part[Threads / 32][3];
  __shared__ int queue[kArity];
  __shared__ int tile_tests;
  extern __shared__ float4 slot_mem[];
  const int tc = a.tc;

  const int i = blockIdx.x * Threads + threadIdx.x;
  const bool valid = i < a.n_rays;
  Ray r = {};
  if (valid) r = load_ray(a.ox, a.oy, a.oz, a.dx, a.dy, a.dz, i);
  float sums[3];
  {
    const float dir[1][3] = {{r.dx, r.dy, r.dz}};  // 0 on an absent lane
    tile_sums<Threads, 1>(part, dir, sums);
  }
  const bool sign[3] = {sums[0] >= 0.0f, sums[1] >= 0.0f, sums[2] >= 0.0f};

  float best = kMissT;
  int best_slot = -1;
  int tests = 0;
  const int warps_per_group = a.param;

  if (threadIdx.x == 0) {
    s.node = 0;
    s.sp = 0;
    tile_tests = 0;
  }
  __syncthreads();
  for (int node = s.node; node >= 0; node = s.node) {
    const float* boxes = a.wbox + (size_t)node * kArity * 8;
    const int* codes = a.wchild + (size_t)node * kArity;
    const unsigned mine =
        valid ? live_children(boxes, codes, r, a.t_min, best, a.widen) : 0u;
    const unsigned live = block_or(s, mine);  // every thread has read s.node
    const bool low_first = sign[a.waxis[node]];
    unsigned group_live = live;
    if constexpr (V == Variant::kGroup) {
      const int first = (threadIdx.x >> 5) / warps_per_group * warps_per_group;
      group_live = 0;
      for (int k = 0; k < warps_per_group; ++k) group_live |= s.warp_bits[first + k];
    }

    // The chunks the leaf step tests, near to far, into slots 0, 1, ...:
    // the live leaves, or (v1) every child slot's.  Their copies are in
    // flight while thread 0 writes v2's queue and moves the walk on.
    int n = 0;
    for (int k = 0; k < kArity; ++k) {
      const int c = low_first ? k : kArity - 1 - k;
      const int code = codes[c];
      const bool leaf = ((live >> c) & 1u) && code <= -2;
      if (V != Variant::kMasked && !leaf) continue;
      const int chunk = max(-2 - code, 0);
      stage_cols(reinterpret_cast<float*>(slot_mem + n * 3 * tc), a.w, tc, chunk * tc, tc);
      if (V == Variant::kQueue && threadIdx.x == 0) queue[n] = chunk;
      ++n;
    }
    push_and_pop(s, codes, live, low_first);  // s.node is next read after the barriers below

    if (n > 0) {  // the same on the whole block
      cp_async_wait(0);
      __syncthreads();  // the slots (and v2's queue) are visible to every thread
      // The thread's ray tests a slot's chunk against its best t, with ties
      // kept (nextafterf) for a lower slot; v1's child slots that are not
      // live leaves against a bound no t passes; v3 against its best,
      // strictly.  v4 skips a leaf none of its group's rays entered.
      for (int k = 0, q = 0; k < kArity; ++k) {
        const int c = low_first ? k : kArity - 1 - k;
        const int code = codes[c];
        const bool leaf = ((live >> c) & 1u) && code <= -2;
        if (V != Variant::kMasked && !leaf) continue;
        const int slot = q++;
        if (V == Variant::kGroup && !((group_live >> c) & 1u)) continue;  // the same on the group
        if (!valid) continue;
        const int chunk = V == Variant::kQueue ? queue[slot] : max(-2 - code, 0);
        const float ax = r.ox - a.wanchor[chunk];
        const float ay = r.oy - a.wanchor[a.n_chunks + chunk];
        const float az = r.oz - a.wanchor[2 * a.n_chunks + chunk];
        const float lim = V == Variant::kNoSlot
                              ? best
                              : nextafterf(leaf ? best : -1.0f, __int_as_float(0x7f800000));
        float t;
        int col;
        staged_closest(slot_mem + slot * 3 * tc, tc, r, ax, ay, az, lim, a.t_min, t, col);
        ++tests;
        if constexpr (V == Variant::kNoSlot) {
          best = fminf(best, t);
        } else {
          take(t, chunk * tc + col, best, best_slot);
        }
      }
    }
    __syncthreads();  // every thread is done with the slots and the bits; s.node is visible
  }
  if (valid) {
    a.t_out[i] = best;
    a.slot_out[i] = V == Variant::kNoSlot ? -1 : best_slot;
  }
  write_tests(&tile_tests, tests, a.tests_out);
}

// staged_closest for the Rays rays of a thread at once: each staged column
// read once for all of them, each ray's tests (its t, then behind one
// branch its barycentrics) in staged_closest's order.  o[q] is ray q's
// re-centred origin; a ray whose `lim` is -inf tests nothing.
template <int Rays>
__device__ __forceinline__ void staged_closest_rays(const float4* cols, int tc,
                                                    const Ray (&r)[Rays],
                                                    const float (&o)[Rays][3],
                                                    const float (&lim)[Rays], float t_min,
                                                    float (&t)[Rays], int (&col)[Rays]) {
#pragma unroll
  for (int q = 0; q < Rays; ++q) {
    t[q] = kMissT;
    col[q] = -1;
  }
#pragma unroll 8
  for (int k = 0; k < tc; ++k) {
    const float4* c = cols + 3 * k;
    const float4 s = c[2];
#pragma unroll
    for (int q = 0; q < Rays; ++q) {
      const float tj = plane_t(s, o[q][0], o[q][1], o[q][2], r[q]);
      if (!((tj > t_min) & (tj < lim[q]) & (tj < t[q]))) continue;
      if (inside_t(c[0], c[1], tj, o[q][0], o[q][1], o[q][2], r[q]) < kMissT) {
        t[q] = tj;
        col[q] = k;
      }
    }
  }
}

// The chunk of the i-th live leaf of a node, near to far (`leaves`: the
// node's child bits that are live leaves).
__device__ __forceinline__ int nth_leaf(const int* __restrict__ codes, unsigned leaves,
                                        bool low_first, int i) {
  for (int k = 0; k < kArity; ++k) {
    const int c = low_first ? k : kArity - 1 - k;
    if (!((leaves >> c) & 1u)) continue;
    if (i-- == 0) return -2 - codes[c];
  }
  return 0;  // not reached: i < popc(leaves)
}

// A block of `Threads` threads, `Rays` rays each.  A drain's chunks are
// staged in the dynamic shared memory: kSlotBuffers buffers of `batch`
// chunks of tc column records.
template <Anchor A, int Threads, int Rays>
__global__ void __launch_bounds__(Threads) queue_walk_kernel(WalkArgs a) {
  constexpr int kTileRays = Threads * Rays;
  constexpr int kWarps = Threads / 32;
  __shared__ int stack[kBlockStack];
  __shared__ unsigned warp_bits[2][kWarps];  // by node parity
  __shared__ float part[Rays * kWarps][3];
  __shared__ int queue[kQueueSize];
  __shared__ int slot_chunk[kSlotBuffers][kMaxBatch];
  __shared__ int tile_tests;
  extern __shared__ float4 slot_mem[];
  const int tc = a.tc;
  const int batch = a.param;
  if (threadIdx.x == 0) tile_tests = 0;  // visible after tile_sums' barriers

  const int base = blockIdx.x * kTileRays;
  Ray r[Rays];
  bool valid[Rays];
  float best[Rays];
  int best_slot[Rays];
  float v[Rays][3];
#pragma unroll
  for (int j = 0; j < Rays; ++j) {
    const int i = base + j * Threads + threadIdx.x;
    valid[j] = i < a.n_rays;
    r[j] = Ray{};
    if (valid[j]) r[j] = load_ray(a.ox, a.oy, a.oz, a.dx, a.dy, a.dz, i);
    best[j] = kMissT;
    best_slot[j] = -1;
    v[j][0] = r[j].dx;
    v[j][1] = r[j].dy;
    v[j][2] = r[j].dz;
  }
  float sums[3];
  tile_sums<Threads, Rays>(part, v, sums);
  const bool sign[3] = {sums[0] >= 0.0f, sums[1] >= 0.0f, sums[2] >= 0.0f};

  // The origins the pair tests see (kTile: minus the tile's centroid over
  // its rays; kChunk re-centres per chunk at the test).
  float cx = 0.0f, cy = 0.0f, cz = 0.0f;
  if constexpr (A == Anchor::kTile) {
#pragma unroll
    for (int j = 0; j < Rays; ++j) {
      v[j][0] = r[j].ox;
      v[j][1] = r[j].oy;
      v[j][2] = r[j].oz;
    }
    tile_sums<Threads, Rays>(part, v, sums);
    const float n = static_cast<float>(min(kTileRays, a.n_rays - base));
    cx = sums[0] / n;
    cy = sums[1] / n;
    cz = sums[2] / n;
  }
  float ro[Rays][3];
  bool any_valid = false;
#pragma unroll
  for (int j = 0; j < Rays; ++j) {
    ro[j][0] = r[j].ox - cx;
    ro[j][1] = r[j].oy - cy;
    ro[j][2] = r[j].oz - cz;
    any_valid |= valid[j];
  }
  int tests = 0;
  int drains = 0;  // the same on every thread

  // Drain queue entries e0 .. e0 + n - 1: those below `fresh` stand in the
  // shared queue, those from `fresh` on are the current node's live leaves
  // (`leaves`), near to far.  Their columns are staged; then every valid
  // ray tests each chunk in turn against the lower of its best t before
  // the drain and the drain's best so far, with ties kept for a lower
  // slot, and merges the drain's best once.  Called by the whole block.
  auto drain = [&](int e0, int n, int fresh, const int* codes, unsigned leaves,
                   bool low_first) {
    const int buf = drains++ % kSlotBuffers;
    const float4* cols = slot_mem + (size_t)buf * 3 * batch * tc;
    float* dst = reinterpret_cast<float*>(slot_mem + (size_t)buf * 3 * batch * tc);
    for (int p = threadIdx.x; p < n * tc; p += Threads) {
      const int b = p / tc, j = p - b * tc;
      const int e = e0 + b;
      const int chunk = e < fresh ? queue[e] : nth_leaf(codes, leaves, low_first, e - fresh);
      if (j == 0) slot_chunk[buf][b] = chunk;
      const float* src = a.w + ((size_t)chunk * kColFloats * tc + j);
#pragma unroll
      for (int g = 0; g < 3; ++g) {
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          cp_async4(dst + kColFloats * p + 4 * g + f, src + f * 3 * tc + g * tc);
        }
      }
    }
    cp_async_commit();
    cp_async_wait(0);
    if constexpr (A == Anchor::kTile) {
      // The rows' translation re-centred on the centroid, by the thread
      // that copied the column, in the expression's order.
      for (int p = threadIdx.x; p < n * tc; p += Threads) {
        float* c = dst + kColFloats * p;
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          c[4 * g + 3] = cx * c[4 * g] + cy * c[4 * g + 1] + cz * c[4 * g + 2] + c[4 * g + 3];
        }
      }
    }
    __syncthreads();  // the drain's columns and chunks are visible
    if (!any_valid) return;
    float bound[Rays], t_batch[Rays];
    int slot_batch[Rays];
#pragma unroll
    for (int j = 0; j < Rays; ++j) {
      bound[j] = best[j];
      t_batch[j] = kMissT;
      slot_batch[j] = -1;
    }
    for (int b = 0; b < n; ++b) {
      const int chunk = slot_chunk[buf][b];
      float o[Rays][3], lim[Rays], t[Rays];
      int col[Rays];
#pragma unroll
      for (int j = 0; j < Rays; ++j) {
        o[j][0] = ro[j][0];
        o[j][1] = ro[j][1];
        o[j][2] = ro[j][2];
        if constexpr (A == Anchor::kChunk) {
          o[j][0] -= a.wanchor[chunk];
          o[j][1] -= a.wanchor[a.n_chunks + chunk];
          o[j][2] -= a.wanchor[2 * a.n_chunks + chunk];
        }
        // A column above the drain's best could never be taken; one equal
        // to it is kept, so that a lower slot still wins the tie.
        lim[j] = valid[j] ? nextafterf(fminf(bound[j], t_batch[j]), __int_as_float(0x7f800000))
                          : -__int_as_float(0x7f800000);
      }
      if constexpr (Rays == 1) {
        staged_closest(cols + b * 3 * tc, tc, r[0], o[0][0], o[0][1], o[0][2], lim[0], a.t_min,
                       t[0], col[0]);
      } else {
        staged_closest_rays<Rays>(cols + b * 3 * tc, tc, r, o, lim, a.t_min, t, col);
      }
#pragma unroll
      for (int j = 0; j < Rays; ++j) take(t[j], chunk * tc + col[j], t_batch[j], slot_batch[j]);
    }
#pragma unroll
    for (int j = 0; j < Rays; ++j) {
      if (!valid[j]) continue;
      take(t_batch[j], slot_batch[j], best[j], best_slot[j]);
      tests += n;
    }
  };

  // The walk.  Every thread keeps the node, the stack's depth and the
  // queue's length, the same on all; thread 0 alone writes the stack and
  // the queue, whose entries are read a node later at the earliest, after
  // the barrier of the block's OR.
  int node = 0, sp = 0, nq = 0, parity = 0;
  while (node >= 0) {
    const float* boxes = a.wbox + (size_t)node * kArity * 8;
    const int* codes = a.wchild + (size_t)node * kArity;
    unsigned mine = 0;
#pragma unroll
    for (int j = 0; j < Rays; ++j) {
      if (valid[j]) mine |= live_children(boxes, codes, r[j], a.t_min, best[j], a.widen);
    }
    // The block's OR, the node's one barrier.  Its warp bits alternate
    // between two arrays, so that the next node's cannot overwrite them
    // while a warp still reads them.
    mine = __reduce_or_sync(kFullMask, mine);
    if ((threadIdx.x & 31) == 0) warp_bits[parity][threadIdx.x >> 5] = mine;
    __syncthreads();
    unsigned live = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) live |= warp_bits[parity][k];
    parity ^= 1;
    const bool low_first = sign[a.waxis[node]];
    unsigned leaves = 0;
#pragma unroll
    for (int c = 0; c < kArity; ++c) {
      if (((live >> c) & 1u) && codes[c] <= -2) leaves |= 1u << c;
    }
    const int fresh = nq;
    nq += __popc(leaves);
    for (bool first = true; nq >= batch; nq -= batch, first = false) {
      if (kSlotBuffers == 1 && !first) __syncthreads();  // the last drain's readers are done
      drain(nq - batch, batch, fresh, codes, leaves, low_first);
    }
    // The node's entries that stay in the queue, and its live internal
    // children pushed far to near, all but the nearest, which is next.
    if (threadIdx.x == 0) {
      for (int e = fresh; e < nq; ++e) queue[e] = nth_leaf(codes, leaves, low_first, e - fresh);
    }
    int next = -1;
    for (int k = 0; k < kArity; ++k) {
      const int c = low_first ? kArity - 1 - k : k;
      const int code = codes[c];
      if (!((live >> c) & 1u) || code < 0) continue;
      if (next >= 0) {
        if (threadIdx.x == 0) stack[sp] = next;
        ++sp;
      }
      next = code;
    }
    node = next >= 0 ? next : sp > 0 ? stack[--sp] : -1;
  }
  if (nq > 0) {
    __syncthreads();  // the queue's entries are visible; the last drain's readers are done
    drain(0, nq, nq, nullptr, 0u, false);
  }
#pragma unroll
  for (int j = 0; j < Rays; ++j) {
    if (valid[j]) {
      const int i = base + j * Threads + threadIdx.x;
      a.t_out[i] = best[j];
      a.slot_out[i] = best_slot[j];
    }
  }
  write_tests(&tile_tests, tests, a.tests_out);
}

template <Variant V, int Threads>
int launch_variant(const WalkArgs& a, cudaStream_t stream) {
  auto kernel = variant_walk_kernel<V, Threads>;
  size_t bytes = 0;
  const cudaError_t err = slot_memory(kernel, a.tc, &bytes);
  if (err != cudaSuccess) return refused(err);
  const int tiles = (a.n_rays + Threads - 1) / Threads;
  kernel<<<tiles, Threads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <Variant V>
int launch_variant(const WalkArgs& a, int ray_tile, cudaStream_t stream) {
  switch (ray_tile) {
    case 256: return launch_variant<V, 256>(a, stream);
    case 512: return launch_variant<V, 512>(a, stream);
    case 1024: return launch_variant<V, 1024>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <Anchor A, int Threads, int Rays>
int launch_queue(const WalkArgs& a, cudaStream_t stream) {
  auto kernel = queue_walk_kernel<A, Threads, Rays>;
  // Above 48 KB the drain's slots need the kernel's opt-in.
  const size_t bytes = sizeof(float4) * 3 * (size_t)a.tc * a.param * kSlotBuffers;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return refused(err);
  const int tiles = (a.n_rays + Threads * Rays - 1) / (Threads * Rays);
  kernel<<<tiles, Threads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <Anchor A>
int launch_queue(const WalkArgs& a, int ray_tile, cudaStream_t stream) {
  switch (ray_tile) {
    case 256: return launch_queue<A, 256, 1>(a, stream);
    case 512: return launch_queue<A, 512, 1>(a, stream);
    case 1024: return launch_queue<A, 1024, 1>(a, stream);
    case 2048: return launch_queue<A, 1024, 2>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

WalkArgs walk_args(const float* ox, const float* oy, const float* oz, const float* dx,
                   const float* dy, const float* dz, int n_rays, const float* wbox,
                   const int* wchild, const int* waxis, const float* w,
                   const float* wanchor, int n_chunks, int leaf_size, int param,
                   float t_min, float box_pad, float far_scale, float* t_out,
                   int* slot_out, int* tests_out) {
  return WalkArgs{ox, oy, oz, dx, dy, dz, n_rays, wbox, wchild, waxis, w, wanchor,
                  n_chunks, leaf_size, param, t_min, Widen{box_pad, far_scale},
                  t_out, slot_out, tests_out};
}

}  // namespace

// Plain C entry points for ctypes.  Each launches on `stream`, does not
// synchronise, and returns the first CUDA error (0 = the launch was
// accepted; cudaErrorInvalidValue for a setting the kernels do not take).
//
// variant_walk: `variant` 0-4 (v0, v1, v2, v3, v4), `ray_tile` 256, 512 or
// 1024 threads, `group` 32, 64 or 128 rays dividing the tile (v4 only).
// queue_walk: `anchor` 0 (tile, v6: `w` unanchored), 1 (none, v7: `w`
// unanchored) or 2 (chunk, v8: the tree's anchored `w` and `wanchor`),
// `ray_tile` 256, 512, 1024 or 2048 rays, `batch` 1-16.  Both write t and
// slot per ray and the ray-chunk tests per tile (`tests_out`, one int per
// tile of `ray_tile` rays).

extern "C" int variants_stack_depth() { return kBlockStack; }

extern "C" int variant_walk(const float* ox, const float* oy, const float* oz,
                            const float* dx, const float* dy, const float* dz, int n_rays,
                            const float* wbox, const int* wchild, const int* waxis,
                            const float* w, const float* wanchor, int n_chunks,
                            int leaf_size, int variant, int ray_tile, int group,
                            float t_min, float box_pad, float far_scale, float* t_out,
                            int* slot_out, int* tests_out, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  if (group < 32 || group > 128 || group % 32 || ray_tile % group) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const WalkArgs a = walk_args(ox, oy, oz, dx, dy, dz, n_rays, wbox, wchild, waxis, w,
                               wanchor, n_chunks, leaf_size, group / 32, t_min, box_pad,
                               far_scale, t_out, slot_out, tests_out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return launch_variant<Variant::kBranch>(a, ray_tile, st);
    case 1: return launch_variant<Variant::kMasked>(a, ray_tile, st);
    case 2: return launch_variant<Variant::kQueue>(a, ray_tile, st);
    case 3: return launch_variant<Variant::kNoSlot>(a, ray_tile, st);
    case 4: return launch_variant<Variant::kGroup>(a, ray_tile, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int queue_walk(const float* ox, const float* oy, const float* oz,
                          const float* dx, const float* dy, const float* dz, int n_rays,
                          const float* wbox, const int* wchild, const int* waxis,
                          const float* w, const float* wanchor, int n_chunks, int leaf_size,
                          int anchor, int ray_tile, int batch, float t_min, float box_pad,
                          float far_scale, float* t_out, int* slot_out, int* tests_out,
                          void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  if (batch < 1 || batch > kMaxBatch) return static_cast<int>(cudaErrorInvalidValue);
  const WalkArgs a = walk_args(ox, oy, oz, dx, dy, dz, n_rays, wbox, wchild, waxis, w,
                               wanchor, n_chunks, leaf_size, batch, t_min, box_pad,
                               far_scale, t_out, slot_out, tests_out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (anchor) {
    case 0: return launch_queue<Anchor::kTile>(a, ray_tile, st);
    case 1: return launch_queue<Anchor::kNone>(a, ray_tile, st);
    case 2: return launch_queue<Anchor::kChunk>(a, ray_tile, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
