"""ctypes binding of the port's host library (``csrc/native.cpp``; port of
``heatray_tpu.native``).

The library does the host side of scene ingestion: Morton order of triangle
centroids (``scene.geometry.merge_meshes``), area-weighted vertex normals
(``MeshData`` without normals), the OBJ tokenizer with fan triangulation
(``scene.loaders.obj`` for files without ``usemtl``) and the binned-SAH
tree build (``ops.bvh.build_topology``).  ``ops.cuda_build.load_host``
builds it with g++ into ``build/`` on the first call of any function here
and raises ``RuntimeError`` if it cannot; nothing compiles at import.  The
numpy twins (``scene.geometry.compute_vertex_normals_plain``,
``morton_order_plain``, ``ops.bvh.build_topology_plain``) exist for the
tests.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from .ops import cuda_build

_i64 = ctypes.c_int64
_f32p = ctypes.POINTER(ctypes.c_float)
_i32p = ctypes.POINTER(ctypes.c_int32)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load_host("native")
    p = ctypes.POINTER
    lib.morton_order.argtypes = [_f32p, _i64, _i32p, _i64, p(_i64)]
    lib.vertex_normals.argtypes = [_f32p, _i64, _i32p, _i64, _f32p]
    lib.obj_parse.restype = ctypes.c_void_p
    lib.obj_parse.argtypes = [ctypes.c_char_p, _i64, p(_i64)]
    lib.obj_read.argtypes = [ctypes.c_void_p, _f32p, _f32p, _f32p, _i32p, _i32p, _i32p]
    lib.obj_free.argtypes = [ctypes.c_void_p]
    lib.bvh_build.restype = ctypes.c_void_p
    lib.bvh_build.argtypes = [_f32p, _f32p, _i64, p(ctypes.c_uint8), _i64, _i64, p(_i64)]
    lib.bvh_read.argtypes = [ctypes.c_void_p, _f32p, _i32p, _i32p, _i32p]
    lib.bvh_free.argtypes = [ctypes.c_void_p]
    return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(_f32p)


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(_i32p)


def _mesh(positions, indices):
    """``positions`` (V, 3) f32 and ``indices`` (T, 3) i32, contiguous; the
    C++ reads them unchecked, so every index must name a vertex."""
    pos = np.ascontiguousarray(positions, np.float32)
    idx = np.ascontiguousarray(indices, np.int32)
    if pos.ndim != 2 or pos.shape[1] != 3 or idx.ndim != 2 or idx.shape[1] != 3:
        raise ValueError(f"positions (V, 3) and indices (T, 3), not {pos.shape} and {idx.shape}")
    if idx.size and (idx.min() < 0 or idx.max() >= pos.shape[0]):
        raise IndexError(f"indices outside [0, {pos.shape[0]})")
    return pos, idx


def morton_order(positions: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """(T,) i64 permutation sorting the centroids of the triangles
    ``indices`` (T, 3) over ``positions`` (V, 3) along a 30-bit Morton
    curve (stable among equal codes)."""
    lib = _lib()
    pos, idx = _mesh(positions, indices)
    out = np.empty(idx.shape[0], np.int64)
    lib.morton_order(_fptr(pos), pos.shape[0], _iptr(idx), idx.shape[0],
                     out.ctypes.data_as(ctypes.POINTER(_i64)))
    return out


def vertex_normals(positions: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """(V, 3) f32 area-weighted smooth normals of ``positions`` (V, 3) over
    the triangles ``indices`` (T, 3); a vertex of no (or only degenerate)
    triangles gets zeros."""
    lib = _lib()
    pos, idx = _mesh(positions, indices)
    out = np.empty_like(pos)
    lib.vertex_normals(_fptr(pos), pos.shape[0], _iptr(idx), idx.shape[0], _fptr(out))
    return out


def bvh_build(tri_min, tri_max, include, leaf_size: int, n_bins: int):
    """Binned-SAH build over the triangle boxes ``tri_min``/``tri_max``
    (planar (3, T) f32); ``include``: (T,) bool, or None for every
    triangle.  Returns (nbox (N, 6) f32, leaf_chunk (N,) i32, skip (N,)
    i32, slot_tri (C * leaf_size,) i32), the fields of ``BVHTopology``."""
    lib = _lib()
    tmin = np.ascontiguousarray(tri_min, np.float32)
    tmax = np.ascontiguousarray(tri_max, np.float32)
    inc = None if include is None else np.ascontiguousarray(include, np.uint8)
    if tmin.ndim != 2 or tmin.shape[0] != 3 or tmax.shape != tmin.shape or (
            inc is not None and inc.shape != (tmin.shape[1],)):
        raise ValueError(f"tri_min, tri_max (3, T) and include (T,), not {tmin.shape}, "
                         f"{tmax.shape} and {None if inc is None else inc.shape}")
    if leaf_size < 1 or n_bins < 2:
        raise ValueError(f"leaf_size {leaf_size} < 1 or n_bins {n_bins} < 2")
    inc_ptr = None if inc is None else inc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    counts = (_i64 * 2)()
    handle = lib.bvh_build(_fptr(tmin), _fptr(tmax), tmin.shape[1], inc_ptr, leaf_size,
                           n_bins, counts)
    try:
        n_nodes, n_chunks = int(counts[0]), int(counts[1])
        nbox = np.empty((n_nodes, 6), np.float32)
        leaf_chunk = np.empty(n_nodes, np.int32)
        skip = np.empty(n_nodes, np.int32)
        slot_tri = np.empty(n_chunks * leaf_size, np.int32)
        lib.bvh_read(handle, _fptr(nbox), _iptr(leaf_chunk), _iptr(skip), _iptr(slot_tri))
    finally:
        lib.bvh_free(handle)
    return nbox, leaf_chunk, skip, slot_tri


def parse_obj(text: bytes):
    """Tokenize an OBJ file's bytes and fan-triangulate its faces.

    Returns (v (V, 3), vt (Vt, 2), vn (Vn, 3), fv (T, 3), ft (T, 3), fn (T,
    3)): f32 streams and each triangle corner's 0-based i32 references, -1
    where a corner has no vt or vn."""
    lib = _lib()
    counts = (_i64 * 4)()
    handle = lib.obj_parse(text, len(text), counts)
    try:
        nv, nt, nn, ntri = (int(counts[i]) for i in range(4))
        v = np.empty((nv, 3), np.float32)
        vt = np.empty((nt, 2), np.float32)
        vn = np.empty((nn, 3), np.float32)
        fv = np.empty((ntri, 3), np.int32)
        ft = np.empty((ntri, 3), np.int32)
        fn = np.empty((ntri, 3), np.int32)
        lib.obj_read(handle, _fptr(v), _fptr(vt), _fptr(vn), _iptr(fv), _iptr(ft), _iptr(fn))
    finally:
        lib.obj_free(handle)
    return v, vt, vn, fv, ft, fn
