// The block-wide walk of the TPU's streaming kernels, kept by the visit
// probe (probes.cu: blocks of 256 rays) and by the walk variants
// (variants.cu: blocks of 128-1024 threads): one block walks the tree
// together, with the current node and the stack in shared memory so that
// the loop is the same for every thread; a child is visited if any ray of
// the block enters it, near to far by the block's summed direction along
// the node's sort axis.  Also the staged-column pair test of the
// brute-force probes and the walk variants: columns copied by 4-byte
// cp.async into 48-byte column records, and `woop_t` split into its t and,
// behind a branch, its barycentrics, with its expressions as they are.

#pragma once

#include <cuda_runtime.h>

#include "wide_bvh_common.cuh"

namespace wide_bvh {

constexpr int kTile = 256;         // rays per block, stream_ray_tile
constexpr int kBlockStack = 256;   // STACK_DEPTH of the TPU kernels
constexpr int kTileWarps = kTile / 32;

// Block-wide walk state of a block of `Threads` threads, in static shared
// memory.
template <int Threads>
struct BlockWalk {
  static constexpr int kWarps = Threads / 32;
  int stack[kBlockStack];
  int node;
  int sp;
  unsigned warp_bits[kWarps];
  float warp_dir[kWarps][3];
};
using Walk = BlockWalk<kTile>;

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` of this thread's commit groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

// --- columns staged in shared memory (probes.cu, variants.cu) -----------------

constexpr int kColFloats = 12;  // Woop values of one column

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

// Start the copy of `n` columns from slot `s0` of the flat slot order of
// chunks `w` into `dst`, column-major (column k's value of feature row f,
// column block g at dst[12 k + 4 g + f]), as one commit group of this
// thread.  Consecutive threads copy consecutive slots.
__device__ __forceinline__ void stage_cols(float* dst, const float* __restrict__ w, int tc,
                                           int s0, int n) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const int c = (s0 + k) / tc;
    const float* src = w + (size_t)c * kColFloats * tc + (s0 + k - c * tc);
#pragma unroll
    for (int g = 0; g < 3; ++g) {
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        cp_async4(dst + kColFloats * k + 4 * g + f, src + f * 3 * tc + g * tc);
      }
    }
  }
  cp_async_commit();
}

// `woop_t`'s t of one ray against a column's s block (x, y, z, 1), in its
// order.
__device__ __forceinline__ float plane_t(const float4& s, float ax, float ay, float az,
                                         const Ray& r) {
  const float pos = ax * s.x + ay * s.y + az * s.z + s.w;
  const float pds = r.dx * s.x + r.dy * s.y + r.dz * s.z;
  return -pos / pds;
}

// `woop_t`'s barycentric test of that t against the column's b1 and b2
// blocks, in its order: t where the ray meets the triangle, else kMissT.
__device__ __forceinline__ float inside_t(const float4& u, const float4& v, float t, float ax,
                                          float ay, float az, const Ray& r) {
  const float b1 =
      (ax * u.x + ay * u.y + az * u.z + u.w) + t * (r.dx * u.x + r.dy * u.y + r.dz * u.z);
  const float b2 =
      (ax * v.x + ay * v.y + az * v.z + v.w) + t * (r.dx * v.x + r.dy * v.y + r.dz * v.z);
  const bool inside = (b1 >= -kBaryEps) & (b2 >= -kBaryEps) & (b1 + b2 <= 1.0f + kBaryEps);
  return inside ? t : kMissT;
}

// Per axis: does the block travel predominantly +axis (low child near)?
// Every thread gets the same three answers (fixed summation order).
__device__ __forceinline__ void block_signs(Walk& s, bool valid, const Ray& r,
                                            bool sign[3]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float dx = warp_sum(valid ? r.dx : 0.0f);
  const float dy = warp_sum(valid ? r.dy : 0.0f);
  const float dz = warp_sum(valid ? r.dz : 0.0f);
  if (lane == 0) {
    s.warp_dir[warp][0] = dx;
    s.warp_dir[warp][1] = dy;
    s.warp_dir[warp][2] = dz;
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float t = 0.0f;
    for (int k = 0; k < kTileWarps; ++k) t += s.warp_dir[k][a];
    sign[a] = t >= 0.0f;
  }
}

// OR of every thread's child bits, the same on every thread; each warp's
// own OR stays in `s.warp_bits` until the next barrier.
template <int Threads>
__device__ __forceinline__ unsigned block_or(BlockWalk<Threads>& s, unsigned bits) {
  bits = __reduce_or_sync(kFullMask, bits);
  if ((threadIdx.x & 31) == 0) s.warp_bits[threadIdx.x >> 5] = bits;
  __syncthreads();
  unsigned live = 0;
#pragma unroll
  for (int k = 0; k < BlockWalk<Threads>::kWarps; ++k) live |= s.warp_bits[k];
  return live;
}

// Thread 0 pushes the live internal children far to near (the stack then
// pops near first) and pops the next node; -1 ends the walk.
template <int Threads>
__device__ __forceinline__ void push_and_pop(BlockWalk<Threads>& s,
                                             const int* __restrict__ codes,
                                             unsigned live, bool low_first) {
  if (threadIdx.x != 0) return;
  int sp = s.sp;
  for (int k = 0; k < kArity; ++k) {
    const int c = low_first ? kArity - 1 - k : k;
    const int code = codes[c];
    if (((live >> c) & 1u) && code >= 0) s.stack[sp++] = code;
  }
  s.node = sp > 0 ? s.stack[--sp] : -1;
  s.sp = sp;
}

inline int tiles_for(int n) { return (n + kTile - 1) / kTile; }

// Dynamic shared memory of the 8 leaf slots; above 48 KB it needs the
// kernel's opt-in.
template <typename Kernel>
cudaError_t slot_memory(Kernel kernel, int leaf_size, size_t* bytes) {
  *bytes = sizeof(float) * kArity * 12 * (size_t)leaf_size;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*bytes));
}

}  // namespace wide_bvh
