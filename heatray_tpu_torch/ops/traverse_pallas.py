"""Binary-BVH traversal: the closest-hit and occlusion queries over the
skip-pointer tree of ``ops.bvh``, whose wrappers launch the CUDA kernels of
``csrc/bvh2.cu``.

Port of ``heatray_tpu.ops.traverse_pallas`` (``intersect_closest_bvh``,
``intersect_any_bvh``; the module keeps the reference's name).  Closest hit
returns ``(t, triangle id, hit)``: the kernel finds a slot and the wrapper
maps it through ``slot_tri``, so the ids index a triangle-ordered table.

On a CUDA tensor a wrapper launches its kernel (built at first use) and
counts the launch in its ``launches`` attribute; on a CPU tensor it runs the
plain PyTorch version, a brute force over the tree's leaf rows with no walk.
Both kernels cull by the tree's block boxes (``BVH.blocks``) and raise on a
tree without them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..vec import Vec3
from . import cuda_build
from .bvh import BLOCK, BVH
from .intersect import any_rows, chunk_rows, closest_rows
from .wide_bvh import launch_any, launch_closest, on_cpu


def _to_triangles(bvh: BVH, t, slot, hit):
    """(t, slot, hit) -> (t, triangle id, hit)."""
    tri = torch.where(hit, bvh.slot_tri[slot.clamp(min=0).long()], -1)
    return t, tri, hit


# --- plain versions ----------------------------------------------------------


def closest_bvh_plain(bvh: BVH, origins: Vec3, directions: Vec3, t_min=1e-4):
    """Brute-force closest hit over the tree's leaf rows: (t, triangle id,
    hit); ties go to the lowest slot."""
    return _to_triangles(bvh, *closest_rows(origins, directions, chunk_rows(bvh.w), t_min))


def any_bvh_plain(bvh: BVH, origins: Vec3, directions: Vec3, t_min=1e-4, t_max=3.0e37):
    """Brute-force any hit in (t_min, t_max) over the tree's leaf rows."""
    return any_rows(origins, directions, chunk_rows(bvh.w), t_min, t_max)


# --- kernel wrappers ---------------------------------------------------------

_P = ctypes.c_void_p
# blocks, nbox, meta, w, wanchor, chunks, leaf size.
_BLOCK_TREE = [_P] * 5 + [ctypes.c_int] * 2
_TAIL = [ctypes.c_float] * 3


@functools.lru_cache(maxsize=None)
def _kernels() -> ctypes.CDLL:
    lib = cuda_build.load("bvh2")
    lib.bvh2_stack_depth.argtypes = []
    lib.bvh2_stack_depth.restype = ctypes.c_int
    lib.closest_bvh.argtypes = [_P] * 6 + [ctypes.c_int] + _BLOCK_TREE + _TAIL + [_P, _P, _P]
    lib.any_bvh.argtypes = [_P] * 7 + [ctypes.c_int] + _BLOCK_TREE + _TAIL + [_P, _P]
    lib.closest_bvh.restype = lib.any_bvh.restype = ctypes.c_int
    return lib


def _block_tree_args(bvh: BVH, lib) -> list:
    """K6a's and K6b's arguments: the tree's block boxes, which it must
    carry, its nodes and leaves, its zero anchors, the chunk count and the
    leaf size; a ValueError for a tree deeper than the kernels' stack or
    with arrays they cannot take."""
    depth = lib.bvh2_stack_depth()
    if bvh.max_stack > depth:
        raise ValueError(f"tree needs a traversal stack of {bvh.max_stack}, the kernel has {depth}")
    for name, dtype in (("nbox", torch.float32), ("meta", torch.int32), ("w", torch.float32)):
        a = getattr(bvh, name)
        if a.dtype != dtype or not a.is_contiguous():
            raise ValueError(f"BVH.{name} must be a contiguous {dtype} tensor")
    blocks, anchor, leaf_size = bvh.blocks, bvh.wanchor, bvh.leaf_size
    if blocks is None:
        raise ValueError("the kernel culls by the leaves' block boxes: the tree has no "
                         "BVH.blocks")
    c = bvh.num_chunks
    for name, a, shape in (("blocks", blocks, (c, -(-leaf_size // BLOCK), 6)),
                           ("wanchor", anchor, (3, c))):
        if (a.dtype != torch.float32 or not a.is_contiguous() or a.shape != shape
                or a.device != bvh.w.device):
            raise ValueError(f"BVH.{name} must be a contiguous float32 {shape} tensor on the "
                             "tree's device")
    return [blocks.data_ptr(), bvh.nbox.data_ptr(), bvh.meta.data_ptr(), bvh.w.data_ptr(),
            anchor.data_ptr(), c, leaf_size]


def intersect_closest_bvh(bvh: BVH, origins: Vec3, directions: Vec3, t_min: float = 1e-4):
    """Closest hit of each ray (Vec3 of (R,)): ``(t, triangle id, hit)``,
    ``(MISS_T, -1)`` on a miss.

    CPU tensors take the plain version; CUDA tensors launch
    ``closest_bvh_kernel`` on the tree's device and its current stream: a
    walk per ray, each leaf it reaches served by the warp block of 32 by
    block, each block only to the rays that enter its box (``BVH.blocks``:
    a tree without them raises) before their best, one triangle per lane."""
    if on_cpu(bvh):
        return closest_bvh_plain(bvh, origins, directions, t_min)
    lib = _kernels()
    out = launch_closest(lib.closest_bvh, _block_tree_args(bvh, lib), bvh, origins, directions,
                         t_min)
    if origins.x.numel():
        intersect_closest_bvh.launches += 1
    return _to_triangles(bvh, *out)


def intersect_any_bvh(bvh: BVH, origins: Vec3, directions: Vec3, t_min: float = 1e-4,
                      t_max=3.0e37):
    """Occlusion: any hit in (t_min, t_max) of each ray; ``t_max`` is a float
    or an (R,) tensor.  Returns an (R,) bool mask.

    CPU tensors take the plain version; CUDA tensors launch
    ``any_bvh_kernel``: the walk of ``intersect_closest_bvh`` against each
    ray's own ``t_max``, each block of a leaf it reaches served only to the
    rays that enter its box before their ``t_max`` and have no hit yet, a
    blocked ray's walk ended (``BVH.blocks``: a tree without them raises)."""
    if on_cpu(bvh):
        return any_bvh_plain(bvh, origins, directions, t_min, t_max)
    lib = _kernels()
    out = launch_any(lib.any_bvh, _block_tree_args(bvh, lib), bvh, origins, directions, t_min,
                     t_max)
    if origins.x.numel():
        intersect_any_bvh.launches += 1
    return out


intersect_closest_bvh.launches = 0
intersect_any_bvh.launches = 0
