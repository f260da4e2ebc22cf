// Flat triangle chunks culled by their AABBs: closest hit and any hit, one
// block of 256 rays walking the chunks in order.
//
// Replaces the Pallas TPU kernels `_closest_kernel` and `_any_kernel` of
// heatray_tpu/ops/intersect_pallas.py.  Those hold the whole chunk table in
// VMEM and, for each 1024-ray tile, loop over every chunk: when any ray of
// the tile enters the chunk's box, the whole tile is tested against all of
// its triangles as one MXU contraction.  Here a block of 256 threads (one
// ray each) loops over the chunks the same way: each thread runs the
// widened slab test of wide_bvh_common.cuh against the chunk's box, and
// when any ray of the block enters it (`__syncthreads_or`) the block copies
// the chunk's (4, 3 Tc) columns (24 KB at Tc = 512) into shared memory.
// Only the threads whose own ray enters the box then test its triangles, in
// exact f32.  Ids are triangle ids (the chunks are in triangle order); ties
// in t go to the lowest id, as in the plain version.  A chunk whose box is
// inverted (every triangle masked out of the occluders) is skipped.  Any
// hit: a blocked ray tests nothing more, and the block leaves once every ray
// in it is blocked.
//
// What bounds it on an H100: the pair tests.  With no tree, a ray tests
// every triangle of every chunk whose box it enters, and Morton-ordered
// chunks of a whole scene overlap; the copies are small next to that and
// the table stays in L2.  This simple design does nothing more about it: no
// double-buffered copies, no wgmma pair tests, no sorting of rays into
// chunk-coherent blocks.
//
// Layouts: w (C, 4, 3 Tc) f32 as in wide_bvh_common.cuh, with no anchor
// (the rows are the raw Woop rows); boxes (C, 6) f32 [min xyz, max xyz].

#include <cuda_runtime.h>

#include "wide_bvh_common.cuh"

namespace {

using namespace wide_bvh;

constexpr int kTile = 256;

__device__ __forceinline__ bool enters(const float* __restrict__ box, const Ray& r,
                                       float t_min, float t_far, Widen widen) {
  return box[0] <= box[3] && slab(box, r, t_min, t_far, widen);
}

// Every thread copies its share of chunk `c` into shared memory.
__device__ __forceinline__ void stage(const float* __restrict__ w, int c,
                                      int chunk_floats, float* chunk) {
  const float4* src = reinterpret_cast<const float4*>(w + (size_t)c * chunk_floats);
  float4* dst = reinterpret_cast<float4*>(chunk);
  for (int p = threadIdx.x; p < chunk_floats / 4; p += kTile) dst[p] = src[p];
}

__global__ void __launch_bounds__(kTile) closest_chunks_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz, int n_rays,
    const float* __restrict__ w, const float* __restrict__ boxes, int n_chunks,
    int tc, float t_min, Widen widen, float* __restrict__ t_out,
    int* __restrict__ id_out) {
  extern __shared__ float4 chunk_mem[];
  float* chunk = reinterpret_cast<float*>(chunk_mem);
  const int chunk_floats = 12 * tc;

  const int i = blockIdx.x * kTile + threadIdx.x;
  const bool valid = i < n_rays;
  Ray r = {};
  if (valid) r = load_ray(ox, oy, oz, dx, dy, dz, i);

  float best = kMissT;
  int best_id = -1;
  for (int c = 0; c < n_chunks; ++c) {
    const bool mine = valid && enters(boxes + 6 * c, r, t_min, best, widen);
    // Also the barrier that ends every thread's reads of the last chunk.
    if (!__syncthreads_or(mine)) continue;
    stage(w, c, chunk_floats, chunk);
    __syncthreads();
    if (mine) {
      for (int j = 0; j < tc; ++j) {
        const float t = tri_t(chunk, tc, j, r.ox, r.oy, r.oz, r, t_min, kMissT);
        if (t < best) {
          best = t;
          best_id = c * tc + j;
        }
      }
    }
  }
  if (valid) {
    t_out[i] = best;
    id_out[i] = best_id;
  }
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

inline int blocks_for(int n) { return (n + kTile - 1) / kTile; }

// Dynamic shared memory of one chunk; above 48 KB it needs the kernel's
// opt-in, and past the block's 227 KB the opt-in itself fails.
template <typename Kernel>
cudaError_t chunk_memory(Kernel kernel, int tc, size_t* bytes) {
  *bytes = sizeof(float) * 12 * (size_t)tc;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*bytes));
}

}  // namespace

// Plain C entry points for ctypes.  Each launches on `stream`, does not
// synchronise, and returns the first CUDA error (0 = the launch was
// accepted).  `w` must be 16-byte aligned.

extern "C" int closest_chunks(const float* ox, const float* oy, const float* oz,
                              const float* dx, const float* dy, const float* dz,
                              int n_rays, const float* w, const float* boxes,
                              int n_chunks, int tri_chunk, float t_min,
                              float box_pad, float far_scale, float* t_out,
                              int* id_out, void* stream) {
  if (n_rays > 0) {
    size_t bytes = 0;
    const cudaError_t err = chunk_memory(closest_chunks_kernel, tri_chunk, &bytes);
    if (err != cudaSuccess) return refused(err);
    closest_chunks_kernel<<<blocks_for(n_rays), kTile, bytes,
                            static_cast<cudaStream_t>(stream)>>>(
        ox, oy, oz, dx, dy, dz, n_rays, w, boxes, n_chunks, tri_chunk, t_min,
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
    const cudaError_t err = chunk_memory(any_chunks_kernel, tri_chunk, &bytes);
    if (err != cudaSuccess) return refused(err);
    any_chunks_kernel<<<blocks_for(n_rays), kTile, bytes,
                        static_cast<cudaStream_t>(stream)>>>(
        ox, oy, oz, dx, dy, dz, t_max, n_rays, w, boxes, n_chunks, tri_chunk,
        t_min, Widen{box_pad, far_scale}, blocked_out);
  }
  return static_cast<int>(cudaGetLastError());
}
