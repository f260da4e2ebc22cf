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
//                       ray over every column of every leaf chunk, one thread
//                       per ray (the row layout).  Both TPU kernels compute
//                       this one function (a loop over chunks of `_pair_hits`,
//                       then a min); on this card exact float32 needs no
//                       precision schedule, so one kernel stands for both;
//   warp_brute_kernel   tpu_vpu_leaf.py `_vpu_kernel` (P4): the same closest t
//                       in the transposed layout: a warp takes its 32 rays one
//                       at a time, lane j tests columns j, j + 32, ... of each
//                       chunk, and a shuffle reduction gives the ray's t (K5's
//                       leaf test, wide_bvh_common.cuh, without the tree);
//   empty_kernel        tpu_kernel_probe.py `_empty_kernel` (P1 "grid"):
//                       x * 0 over the same grid (`ray_tile` rays a block,
//                       four a thread), the cost of the launch.
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
// barycentrics where t lies in range, against 67 TFLOP/s); every lane of a
// warp reads the same Woop column in the row layout, and 32 consecutive
// columns in the transposed one.  The node walk and visit_stats_kernel are
// bound by the latency of their divergent or block-serial walks, far above
// the bytes they move; empty_kernel by the launch itself.  They are probes:
// nothing here is tuned.
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

__global__ void __launch_bounds__(1024) rows_brute_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz, int n_rays,
    const float* __restrict__ w, const float* __restrict__ wanchor, int n_chunks,
    int tc, float t_min, float* __restrict__ t_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const Ray r = load_ray(ox, oy, oz, dx, dy, dz, i);
  float best = kMissT;
  for (int c = 0; c < n_chunks; ++c) {
    const float ax = r.ox - wanchor[c];
    const float ay = r.oy - wanchor[n_chunks + c];
    const float az = r.oz - wanchor[2 * n_chunks + c];
    const float* W = w + (size_t)c * 12 * tc;
    for (int j = 0; j < tc; ++j) {
      best = fminf(best, tri_t(W, tc, j, ax, ay, az, r, t_min, best));
    }
  }
  t_out[i] = best;
}

__global__ void __launch_bounds__(1024) warp_brute_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz, int n_rays,
    const float* __restrict__ w, const float* __restrict__ wanchor, int n_chunks,
    int tc, float t_min, float* __restrict__ t_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int first = i & ~31;  // the warp's first ray
  if (first >= n_rays) return;  // the whole warp leaves together
  const bool valid = i < n_rays;
  const int lane = threadIdx.x & 31;
  Ray r = {};
  if (valid) r = load_ray(ox, oy, oz, dx, dy, dz, i);
  const int n_warp = min(32, n_rays - first);
  float mine = kMissT;
  for (int src = 0; src < n_warp; ++src) {
    const Ray q = shfl_ray(r, src);
    float t = kMissT;  // this lane's columns
    for (int c = 0; c < n_chunks; ++c) {
      const float ax = q.ox - wanchor[c];
      const float ay = q.oy - wanchor[n_chunks + c];
      const float az = q.oz - wanchor[2 * n_chunks + c];
      const float* W = w + (size_t)c * 12 * tc;
      for (int j = lane; j < tc; j += 32) {
        t = fminf(t, tri_t(W, tc, j, ax, ay, az, q, t_min, t));
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t = fminf(t, __shfl_xor_sync(kFullMask, t, o));
    if (lane == src) mine = t;
  }
  if (valid) t_out[i] = mine;
}

// `ray_tile` rays a block, four a thread: 16-byte reads and writes where
// both pointers allow them, else one float at a time.
__global__ void __launch_bounds__(256) empty_kernel(const float* __restrict__ ox, int n_rays,
                                                     int ray_tile, float* __restrict__ out) {
  const int i = blockIdx.x * ray_tile + 4 * threadIdx.x;
  const bool aligned = ((reinterpret_cast<size_t>(ox) | reinterpret_cast<size_t>(out)) & 15) == 0;
  if (aligned && i + 3 < n_rays) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(ox + i));
    *reinterpret_cast<float4*>(out + i) =
        make_float4(x.x * 0.0f, x.y * 0.0f, x.z * 0.0f, x.w * 0.0f);
  } else {
    for (int k = i; k < min(i + 4, n_rays); ++k) out[k] = ox[k] * 0.0f;
  }
}

inline int blocks_for(int n, int threads) { return (n + threads - 1) / threads; }

}  // namespace

// Plain C entry points for ctypes.  Each launches on `stream`, does not
// synchronise, and returns the first CUDA error (0 = the launch was
// accepted).  `ray_tile` is the rays of a block of the per-ray kernels (a
// multiple of 32, at most 1024; a thread each, but four a thread in
// empty_kernel); visit_stats_kernel's tile is 256.

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
    rows_brute_kernel<<<blocks_for(n_rays, ray_tile), ray_tile, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        ox, oy, oz, dx, dy, dz, n_rays, w, wanchor, n_chunks, leaf_size, t_min, t_out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_warp(const float* ox, const float* oy, const float* oz,
                          const float* dx, const float* dy, const float* dz, int n_rays,
                          const float* w, const float* wanchor, int n_chunks,
                          int leaf_size, int ray_tile, float t_min, float* t_out,
                          void* stream) {
  if (n_rays > 0) {
    warp_brute_kernel<<<blocks_for(n_rays, ray_tile), ray_tile, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        ox, oy, oz, dx, dy, dz, n_rays, w, wanchor, n_chunks, leaf_size, t_min, t_out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_empty(const float* ox, int n_rays, int ray_tile, float* out,
                           void* stream) {
  if (n_rays > 0) {
    empty_kernel<<<blocks_for(n_rays, ray_tile), ray_tile / 4, 0,
                   static_cast<cudaStream_t>(stream)>>>(ox, n_rays, ray_tile, out);
  }
  return static_cast<int>(cudaGetLastError());
}
