"""Flat triangle chunks: the kernel layout and the two chunk-culled queries,
whose wrappers launch the CUDA kernels of ``csrc/chunks.cu``.

Port of ``heatray_tpu.ops.intersect_pallas`` (``WoopPallas``,
``pack_for_pallas``, ``intersect_closest_pallas``, ``intersect_any_pallas``;
the module keeps the reference's name).  No tree: the Woop rows, in triangle
order, are cut into chunks of ``tri_chunk`` triangles packed as
``(C, 4, 3 Tc)`` (the wide BVH's leaf layout, without anchors), each with
its AABB, and the AABBs of its runs of 32 triangles (``blocks``, which
both kernels cull by; the reference has no such boxes).  A query
tests a ray against the triangles of each chunk whose box it enters, so the
closest hit returns triangle ids directly.

On a CUDA tensor a wrapper launches its kernel (built at first use) and
counts the launch in its ``launches`` attribute; on a CPU tensor it runs the
plain PyTorch version, a brute force over the same rows with no culling.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ..vec import Vec3
from . import cuda_build
from .intersect import WoopAccel, any_rows, chunk_boxes, chunk_rows, closest_rows
from .wide_bvh import BLOCK, launch_any, launch_closest, leaf_blocks, on_cpu

TRI_CHUNK = 512


@dataclasses.dataclass
class WoopPallas:
    """Kernel-layout triangle data: ``w`` (C, 4, 3 Tc) f32 (feature rows x, y,
    z, 1 against columns b1[Tc], b2[Tc], s[Tc]; padding triangles all zero,
    so never hit), ``boxes`` (C, 6) f32 per-chunk AABBs [min xyz, max xyz]
    and ``blocks`` (C, ceil(Tc / BLOCK), 6) f32 the AABBs of each chunk's
    runs of BLOCK columns (inverted where a run holds no triangle)."""

    w: torch.Tensor
    boxes: torch.Tensor
    blocks: torch.Tensor
    num_triangles: int

    @property
    def num_chunks(self) -> int:
        return self.w.shape[0]

    @property
    def tri_chunk(self) -> int:
        return self.w.shape[2] // 3

    def to(self, device) -> "WoopPallas":
        return dataclasses.replace(self, w=self.w.to(device), boxes=self.boxes.to(device),
                                   blocks=self.blocks.to(device))


def block_boxes(accel: WoopAccel, tri_chunk: int, n_chunks: int) -> torch.Tensor:
    """(n_chunks, ceil(tri_chunk / BLOCK), 6) AABBs of each chunk's runs of
    BLOCK triangles (``leaf_blocks``); padding triangles (and runs past the
    chunk's end) form empty (inverted) boxes."""
    big, pad = 3.0e38, n_chunks * tri_chunk - accel.num_triangles
    return leaf_blocks(torch.nn.functional.pad(accel.tri_min, (0, pad), value=big),
                       torch.nn.functional.pad(accel.tri_max, (0, pad), value=-big), tri_chunk)


def pack_for_pallas(accel: WoopAccel, tri_chunk: int = TRI_CHUNK) -> WoopPallas:
    """Repack the planar (12, T) Woop rows into (C, 4, 3 Tc) chunks plus the
    chunk and block AABBs, on ``accel``'s device (triangles arrive
    Morton-ordered from scene assembly, so chunks are spatially compact)."""
    t = accel.num_triangles
    c = -(-t // tri_chunk)
    w = torch.nn.functional.pad(accel.w, (0, c * tri_chunk - t))
    w = w.reshape(12, c, tri_chunk).permute(1, 0, 2)
    w = w.reshape(c, 3, 4, tri_chunk).permute(0, 2, 1, 3).reshape(c, 4, 3 * tri_chunk)
    return WoopPallas(w=w.contiguous(), boxes=chunk_boxes(accel, tri_chunk, c),
                      blocks=block_boxes(accel, tri_chunk, c), num_triangles=t)


# --- plain versions ----------------------------------------------------------


def closest_chunks_plain(packed: WoopPallas, origins: Vec3, directions: Vec3, t_min=1e-4):
    """Brute-force closest hit over the pack's rows: (t, triangle id, hit);
    ties go to the lowest id."""
    return closest_rows(origins, directions, chunk_rows(packed.w), t_min)


def any_chunks_plain(packed: WoopPallas, origins: Vec3, directions: Vec3, t_min=1e-4,
                     t_max=3.0e37):
    """Brute-force any hit in (t_min, t_max) over the pack's rows."""
    return any_rows(origins, directions, chunk_rows(packed.w), t_min, t_max)


# --- kernel wrappers ---------------------------------------------------------

_P = ctypes.c_void_p
_TREE = [_P, _P, _P, ctypes.c_int, ctypes.c_int]  # blocks, w, boxes, chunks, tri_chunk
_TAIL = [ctypes.c_float] * 3
_CLOSEST_ARGS = [_P] * 6 + [ctypes.c_int] + _TREE + _TAIL + [_P, _P, _P]
_ANY_ARGS = [_P] * 7 + [ctypes.c_int] + _TREE + _TAIL + [_P, _P]


@functools.lru_cache(maxsize=None)
def _kernels() -> ctypes.CDLL:
    lib = cuda_build.load("chunks")
    lib.closest_chunks.argtypes, lib.any_chunks.argtypes = _CLOSEST_ARGS, _ANY_ARGS
    lib.closest_chunks.restype = lib.any_chunks.restype = ctypes.c_int
    return lib


def _pack_args(packed: WoopPallas) -> list:
    """The pack's entry-point arguments (``_TREE``)."""
    for name in ("w", "boxes", "blocks"):
        a = getattr(packed, name)
        if a.dtype != torch.float32 or not a.is_contiguous():
            raise ValueError(f"WoopPallas.{name} must be a contiguous float32 tensor")
    if packed.w.data_ptr() % 16:
        raise ValueError("WoopPallas.w must be 16-byte aligned for the chunk kernels")
    return [packed.blocks.data_ptr(), packed.w.data_ptr(), packed.boxes.data_ptr(),
            packed.num_chunks, packed.tri_chunk]


def intersect_closest_pallas(packed: WoopPallas, origins: Vec3, directions: Vec3,
                             t_min: float = 1e-4):
    """Closest hit of each ray (Vec3 of (R,)): ``(t, triangle id, hit)``,
    ``(MISS_T, -1)`` on a miss.

    CPU tensors take the plain version; CUDA tensors launch
    ``closest_chunks_kernel`` on the pack's device and its current stream: a
    walk per ray over the chunk list and each chunk's blocks of 32
    triangles, each block tested by the warp for only the rays that enter
    its box."""
    if on_cpu(packed):
        return closest_chunks_plain(packed, origins, directions, t_min)
    out = launch_closest(_kernels().closest_chunks, _pack_args(packed), packed,
                         origins, directions, t_min)
    if origins.x.numel():
        intersect_closest_pallas.launches += 1
    return out


def intersect_any_pallas(packed: WoopPallas, origins: Vec3, directions: Vec3,
                         t_min: float = 1e-4, t_max=3.0e37):
    """Occlusion: any hit in (t_min, t_max) of each ray; ``t_max`` is a float
    or an (R,) tensor.  Returns an (R,) bool mask.

    CPU tensors take the plain version; CUDA tensors launch
    ``any_chunks_kernel``: ``intersect_closest_pallas``'s chunk and block
    culls, in index order, against each ray's own ``t_max``; a ray's walk
    ends at its first hit."""
    if on_cpu(packed):
        return any_chunks_plain(packed, origins, directions, t_min, t_max)
    out = launch_any(_kernels().any_chunks, _pack_args(packed), packed,
                     origins, directions, t_min, t_max)
    if origins.x.numel():
        intersect_any_pallas.launches += 1
    return out


intersect_closest_pallas.launches = 0
intersect_any_pallas.launches = 0
