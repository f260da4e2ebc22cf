"""The port's traversal probes: what the wide-BVH walk visits, and what each
part of the closest-hit kernel costs on its own.

Counterparts of the repository's root probe scripts, each with its own
CUDA kernels (``csrc/probes.cu``, built at first use) beside their plain
PyTorch versions:

- ``visit_stats`` (``tpu_visit_stats.py``, P3): node and leaf visits per
  256-ray block of K3's walk, the share of a block's rays that enter each
  leaf it opens, and the leaf visits that lower some ray's best hit, on
  real bounce wavefronts;
- ``kernel_probe`` (``tpu_kernel_probe.py``, P1): the walk without its leaf
  tests, the leaf tests without the walk, and an empty launch, beside K1;
- ``vpu_leaf`` (``tpu_vpu_leaf.py``, P4): the brute-force leaf pair test in
  the row layout against the warp-transposed one;
- ``kernel_variants`` (``tpu_kernel_variants_probe.py``, P2; its kernels in
  ``csrc/variants.cu``): variants of the block-wide walk's leaf step, leaf
  queues and batched drains on the sorted depth-2 wavefront, beside K1.

Each runs as ``python -m heatray_tpu_torch.probes.<name>``, on the card
unless ``--device cpu`` is given (the plain versions, at a size given by
``--size``).  As elsewhere in the port, a CUDA tensor goes to the kernel and
a CPU tensor to the plain version; a kernel that fails to build or launch
raises.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import time

import torch

from ..ops import cuda_build
from ..ops.wide_bvh import launch  # noqa: F401  (the probes launch through it)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_RAYS = [_P] * 6 + [_I]
_SIGNATURES = {
    "probe_block_stack_depth": [],
    "probe_stack_depth": [],
    "probe_block_tile": [],
    "probe_visit_stats": _RAYS + [_P] * 5 + [_I, _I, _P, _P, _I] + [_F] * 3 + [_P] * 4,
    "probe_nodes": _RAYS + [_P] * 3 + [_I] + [_F] * 3 + [_P, _P, _P],
    "probe_rows": _RAYS + [_P, _P, _I, _I, _I, _F, _P, _P],
    "probe_warp": _RAYS + [_P, _P, _I, _I, _I, _F, _P, _P],
    "probe_empty": [_P, _I, _I, _P, _P],
}
_WALK = _RAYS + [_P] * 5 + [_I] * 5 + [_F] * 3 + [_P] * 4
_VARIANT_SIGNATURES = {
    "variants_stack_depth": [],
    "variant_walk": _WALK,
    "queue_walk": _WALK,
}


def _declare(name: str, signatures: dict) -> ctypes.CDLL:
    lib = cuda_build.load(name)
    for fn, args in signatures.items():
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def kernels() -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/probes.cu``, with its entry points
    declared."""
    return _declare("probes", _SIGNATURES)


@functools.lru_cache(maxsize=None)
def variant_kernels() -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/variants.cu`` (P2), with its entry
    points declared."""
    return _declare("variants", _VARIANT_SIGNATURES)


def check_ray_tile(ray_tile: int) -> None:
    """The per-ray probe kernels run one ray per thread in blocks of
    ``ray_tile`` threads."""
    if ray_tile % 32 or not 32 <= ray_tile <= 1024:
        raise ValueError(f"ray_tile must be a multiple of 32 in [32, 1024], not {ray_tile}")


def elapsed_ms(fn, reps: int, device):
    """(mean ms of ``fn`` over ``reps`` runs after one warm-up, its last
    result): CUDA events on the card, the host clock on the CPU."""
    out = fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        return (time.perf_counter() - t0) * 1e3 / reps, out
    torch.cuda.synchronize(device)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(stop) / reps, out


def parser(description: str) -> argparse.ArgumentParser:
    """The options every probe takes: ``--device`` and ``--size``."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels, the default) or cpu (the plain versions)")
    p.add_argument("--size", type=int, nargs=2, default=(1920, 1080), metavar=("W", "H"),
                   help="image size of the wavefronts (default 1920 1080)")
    return p


def device_of(name: str) -> torch.device:
    """The probe's device; the card must be there if it is named."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the plain versions")
    return device


def device_label(device) -> str:
    """What a printed time was taken on."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu (plain versions)"


def options(width: int, height: int, depth: int, **kw):
    """The probes' render options (those of the reference probes)."""
    from ..options import RenderOptions

    return RenderOptions(width=width, height=height, max_render_passes=8, max_ray_depth=depth,
                         **kw)


def cornell(width: int, height: int, depth: int, device):
    """The Cornell box of the probes and ``bench.py``: (scene, camera,
    options, context) on ``device``."""
    from .. import cornell_box, make_context, orbit_camera

    opts = options(width, height, depth)
    scene = cornell_box(light="both", with_spheres=True).to(device)
    camera = orbit_camera(width, height, distance=6.2, focal_length_mm=35.0).to(device)
    return scene, camera, opts, make_context(opts, scene, device)
