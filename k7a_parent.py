"""K7a's design before the walk per ray, built as the yardstick that
``chip_smoke.py`` (phase 11) and ``profile_torch_wide.py`` time the shipped
``closest_chunks_kernel`` against.  A module, not a script: ``build()``
compiles ``SOURCE`` against the shared headers of ``heatray_tpu_torch/csrc``
and returns the loaded library.

The design, as it stood: one block of 256 rays walks the chunks in index
order; when any ray of the block enters a chunk's box, the block stages the
chunk in shared memory, and each entering thread tests every triangle of
it in turn.  Its ``closest_chunks`` takes no block boxes.  It imports no
jax.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

_P = ctypes.c_void_p
# rays (6), count, w, boxes, chunks, tri_chunk, t_min, box_pad, far_scale,
# t_out, id_out, stream
CLOSEST_ARGS = ([_P] * 6 + [ctypes.c_int, _P, _P, ctypes.c_int, ctypes.c_int]
                + [ctypes.c_float] * 3 + [_P, _P, _P])

SOURCE = """#include <cuda_runtime.h>

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
"""


def build(out_dir: Path) -> ctypes.CDLL:
    """Compile ``SOURCE`` into ``out_dir`` (with the package's nvcc flags)
    and load it; raises with the compiler's errors if it does not build.
    The compiler's report goes to ``chunks_parent.log`` there."""
    from heatray_tpu_torch.ops import cuda_build

    out_dir.mkdir(parents=True, exist_ok=True)
    source, so = out_dir / "chunks_parent.cu", out_dir / "chunks_parent.so"
    source.write_text(SOURCE)
    proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I",
                           str(cuda_build.CSRC_DIR), "-o", str(so), str(source)],
                          capture_output=True, text=True)
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on K7a's parent design:\n"
                           f"{proc.stderr[-3000:]}")
    lib = ctypes.CDLL(str(so))
    lib.closest_chunks.argtypes, lib.closest_chunks.restype = CLOSEST_ARGS, ctypes.c_int
    return lib
