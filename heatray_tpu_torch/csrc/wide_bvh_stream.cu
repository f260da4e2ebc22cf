// Arity-8 BVH traversal with leaf chunks staged in shared memory: closest
// hit and any hit, one block of 256 rays walking the tree together.
//
// Replaces the Pallas TPU kernels `_closest_stream_kernel` and
// `_any_stream_kernel` of heatray_tpu/ops/wide_bvh.py.  Those leave the leaf
// table `w` in HBM, walk the tree once per 256-ray tile and copy each
// visited leaf chunk by DMA into one of 8 VMEM slots, starting every live
// leaf's copy of a node before waiting on the first.  Here a block is that
// tile: one thread per ray, the stack and the current node in shared memory
// so that the loop is the same for every thread, and a child is visited if
// any ray of the block enters it (warp ballots OR-ed in shared memory).
// Children are ordered near to far by the block's summed direction along
// the node's sort axis; internal children are pushed far to near.  All live
// leaf chunks of a node (4 x 3 Tc f32 each, 6,144 B at Tc = 128) are copied
// with cp.async into up to 8 shared-memory slots, one commit group each, all
// started before the first wait; each thread then tests its ray against
// every triangle of each chunk in exact f32 (wide_bvh_common.cuh).  The slab
// test is the widened one of the per-ray kernels, so the result is the brute
// force's over the same leaf rows: the plain version.  Ties in t go to the
// lowest slot.  Any hit: a blocked ray stops testing (its far end becomes
// t_min - 1, so it enters no box), and the block leaves when every ray in it
// is blocked or the stack is empty.  Threads past the last ray stay in the
// loop as dead lanes, since every iteration has block-wide barriers.
//
// The block walk itself is in wide_bvh_block.cuh, shared with K4
// (wide_bvh_t.cu).
//
// What bounds it on an H100: the leaf pair tests.  A leaf that any ray of
// the block enters is tested by all 256 rays (about 40 FLOPs per pair), and
// the whole `w` of a 300k-triangle scene (about 21 MB) stays in the 50 MB
// L2, so device memory is not the limit.  This simple design does nothing
// more about it: no wgmma leaf tests, no TMA, no persistent blocks or warp
// specialisation.  Those are later work.

#include <cuda_runtime.h>

#include "wide_bvh_block.cuh"

namespace {

using namespace wide_bvh;

__global__ void __launch_bounds__(kTile) closest_stream_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz, int n_rays,
    const float* __restrict__ wbox, const int* __restrict__ wchild,
    const int* __restrict__ waxis, const float* __restrict__ w,
    const float* __restrict__ wanchor, int n_chunks, int tc, float t_min,
    Widen widen, float* __restrict__ t_out, int* __restrict__ slot_out) {
  __shared__ Walk s;
  extern __shared__ float4 slot_mem[];
  float* slots = reinterpret_cast<float*>(slot_mem);
  const int chunk_floats = 12 * tc;

  const int i = blockIdx.x * kTile + threadIdx.x;
  const bool valid = i < n_rays;
  Ray r = {};
  if (valid) r = load_ray(ox, oy, oz, dx, dy, dz, i);
  bool sign[3];
  block_signs(s, valid, r, sign);

  float best = kMissT;
  int best_slot = -1;
  if (threadIdx.x == 0) {
    s.node = 0;
    s.sp = 0;
  }
  __syncthreads();
  for (int node = s.node; node >= 0; node = s.node) {
    const float* boxes = wbox + (size_t)node * kArity * 8;
    const int* codes = wchild + (size_t)node * kArity;
    const unsigned mine = valid ? live_children(boxes, codes, r, t_min, best, widen) : 0u;
    const unsigned live = block_or(s, mine);
    const bool low_first = sign[waxis[node]];

    const int n = stage_leaves(codes, live, low_first, w, chunk_floats, slots);
    for (int k = 0, q = 0; k < kArity; ++k) {
      const int c = low_first ? k : kArity - 1 - k;
      const int code = codes[c];
      if (!((live >> c) & 1u) || code > -2) continue;
      cp_async_wait(n - 1 - q);
      __syncthreads();  // slot q has arrived for every thread's share
      if (valid) {
        const int chunk = -2 - code;
        const float ax = r.ox - wanchor[chunk];
        const float ay = r.oy - wanchor[n_chunks + chunk];
        const float az = r.oz - wanchor[2 * n_chunks + chunk];
        const float* W = slots + q * chunk_floats;
        for (int j = 0; j < tc; ++j) {
          const float t = tri_t(W, tc, j, ax, ay, az, r, t_min, kMissT);
          const int slot = chunk * tc + j;
          if (t < best || (t == best && t < kMissT && slot < best_slot)) {
            best = t;
            best_slot = slot;
          }
        }
      }
      ++q;
    }
    __syncthreads();  // every thread is done with the slots and warp_bits
    push_and_pop(s, codes, live, low_first);
    __syncthreads();  // the next node is visible
  }
  if (valid) {
    t_out[i] = best;
    slot_out[i] = best_slot;
  }
}

__global__ void __launch_bounds__(kTile) any_stream_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ t_max, int n_rays,
    const float* __restrict__ wbox, const int* __restrict__ wchild,
    const int* __restrict__ waxis, const float* __restrict__ w,
    const float* __restrict__ wanchor, int n_chunks, int tc, float t_min,
    Widen widen, unsigned char* __restrict__ blocked_out) {
  __shared__ Walk s;
  extern __shared__ float4 slot_mem[];
  float* slots = reinterpret_cast<float*>(slot_mem);
  const int chunk_floats = 12 * tc;

  const int i = blockIdx.x * kTile + threadIdx.x;
  const bool valid = i < n_rays;
  Ray r = {};
  float t_hi = t_min - 1.0f;
  if (valid) {
    r = load_ray(ox, oy, oz, dx, dy, dz, i);
    t_hi = t_max[i];
  }
  bool sign[3];
  block_signs(s, valid, r, sign);

  bool blocked = false;
  if (threadIdx.x == 0) {
    s.node = 0;
    s.sp = 0;
  }
  // The walk goes on while the stack has a node and some ray is unblocked.
  bool alive = __syncthreads_or(valid);
  for (int node = s.node; node >= 0 && alive; node = s.node) {
    const float* boxes = wbox + (size_t)node * kArity * 8;
    const int* codes = wchild + (size_t)node * kArity;
    // A blocked ray's far end falls below t_min: it enters no box.
    const float t_far = blocked ? t_min - 1.0f : t_hi;
    const unsigned mine = valid ? live_children(boxes, codes, r, t_min, t_far, widen) : 0u;
    const unsigned live = block_or(s, mine);
    const bool low_first = sign[waxis[node]];

    const int n = stage_leaves(codes, live, low_first, w, chunk_floats, slots);
    for (int k = 0, q = 0; k < kArity; ++k) {
      const int c = low_first ? k : kArity - 1 - k;
      const int code = codes[c];
      if (!((live >> c) & 1u) || code > -2) continue;
      cp_async_wait(n - 1 - q);
      __syncthreads();  // slot q has arrived for every thread's share
      if (valid && !blocked) {
        const int chunk = -2 - code;
        const float ax = r.ox - wanchor[chunk];
        const float ay = r.oy - wanchor[n_chunks + chunk];
        const float az = r.oz - wanchor[2 * n_chunks + chunk];
        const float* W = slots + q * chunk_floats;
        for (int j = 0; j < tc; ++j) {
          if (tri_t(W, tc, j, ax, ay, az, r, t_min, t_hi) < kMissT) {
            blocked = true;  // the first occluder ends this ray's tests
            break;
          }
        }
      }
      ++q;
    }
    __syncthreads();  // every thread is done with the slots and warp_bits
    push_and_pop(s, codes, live, low_first);
    alive = __syncthreads_or(valid && !blocked);  // and the next node is visible
  }
  if (valid) blocked_out[i] = blocked ? 1 : 0;
}

}  // namespace

// Plain C entry points for ctypes.  Each launches on `stream`, does not
// synchronise, and returns the first CUDA error (0 = the launch was
// accepted).  `w` must be 16-byte aligned.

extern "C" int wide_bvh_stream_stack_depth() { return kBlockStack; }

extern "C" int closest_stream(const float* ox, const float* oy, const float* oz,
                              const float* dx, const float* dy, const float* dz,
                              int n_rays, const float* wbox, const int* wchild,
                              const int* waxis, const float* w,
                              const float* wanchor, int n_chunks, int leaf_size,
                              float t_min, float box_pad, float far_scale,
                              float* t_out, int* slot_out, void* stream) {
  if (n_rays > 0) {
    size_t bytes = 0;
    const cudaError_t err = slot_memory(closest_stream_kernel, leaf_size, &bytes);
    if (err != cudaSuccess) return refused(err);
    closest_stream_kernel<<<tiles_for(n_rays), kTile, bytes,
                            static_cast<cudaStream_t>(stream)>>>(
        ox, oy, oz, dx, dy, dz, n_rays, wbox, wchild, waxis, w, wanchor,
        n_chunks, leaf_size, t_min, Widen{box_pad, far_scale}, t_out, slot_out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int any_stream(const float* ox, const float* oy, const float* oz,
                          const float* dx, const float* dy, const float* dz,
                          const float* t_max, int n_rays, const float* wbox,
                          const int* wchild, const int* waxis, const float* w,
                          const float* wanchor, int n_chunks, int leaf_size,
                          float t_min, float box_pad, float far_scale,
                          unsigned char* blocked_out, void* stream) {
  if (n_rays > 0) {
    size_t bytes = 0;
    const cudaError_t err = slot_memory(any_stream_kernel, leaf_size, &bytes);
    if (err != cudaSuccess) return refused(err);
    any_stream_kernel<<<tiles_for(n_rays), kTile, bytes,
                        static_cast<cudaStream_t>(stream)>>>(
        ox, oy, oz, dx, dy, dz, t_max, n_rays, wbox, wchild, waxis, w,
        wanchor, n_chunks, leaf_size, t_min, Widen{box_pad, far_scale},
        blocked_out);
  }
  return static_cast<int>(cudaGetLastError());
}
