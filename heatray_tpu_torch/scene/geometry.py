"""Flat triangle geometry (port of ``heatray_tpu.scene.geometry``).

Meshes are assembled on the host in numpy and merged into one
structure-of-arrays soup, Morton-ordered so that contiguous triangles are
spatially compact.  Morton order and vertex normals run in the port's host
library (``native.py``); their numpy twins, ``morton_order_plain`` and
``compute_vertex_normals_plain``, are for the tests.  A mesh with UVs but
no authored tangents gets a tangent frame from its UVs
(``compute_tangents``), so normal maps work on it.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from .. import native


@dataclasses.dataclass
class Geometry:
    """Merged scene geometry, planar (component-major) tensors."""

    positions: torch.Tensor  # (3, V) f32
    normals: torch.Tensor  # (3, V) f32
    uvs: torch.Tensor  # (2, V) f32
    tangents: torch.Tensor  # (3, V) f32
    bitangents: torch.Tensor  # (3, V) f32
    colors: torch.Tensor  # (3, V) f32 vertex colors
    indices: torch.Tensor  # (3, T) i32
    material_ids: torch.Tensor  # (T,) i32
    # (T,) i32: the index of each triangle's source mesh, the handle of
    # ``scene.edit.remove_mesh``.
    mesh_ids: torch.Tensor

    @property
    def num_triangles(self) -> int:
        return self.indices.shape[1]

    @property
    def num_vertices(self) -> int:
        return self.positions.shape[1]


@dataclasses.dataclass
class MeshData:
    """Host-side mesh buffers (numpy), the analog of ``MeshProvider``."""

    positions: np.ndarray  # (V, 3)
    indices: np.ndarray  # (T, 3)
    normals: Optional[np.ndarray] = None
    uvs: Optional[np.ndarray] = None
    tangents: Optional[np.ndarray] = None
    bitangents: Optional[np.ndarray] = None
    colors: Optional[np.ndarray] = None
    name: str = "mesh"

    def __post_init__(self):
        self.positions = np.asarray(self.positions, dtype=np.float32).reshape(-1, 3)
        self.indices = np.asarray(self.indices, dtype=np.int32).reshape(-1, 3)
        if self.normals is None:
            self.normals = compute_vertex_normals(self.positions, self.indices)

    def transformed(self, matrix: np.ndarray) -> "MeshData":
        """Apply a 4x4 transform; a negative determinant flips the winding
        so geometric normals stay outward."""
        m = np.asarray(matrix, dtype=np.float32)
        rot = m[:3, :3]
        pos = self.positions @ rot.T + m[:3, 3]
        nrm_mat = np.linalg.inv(rot).T  # inverse transpose
        normals = self.normals @ nrm_mat.T
        normals = normals / np.maximum(np.linalg.norm(normals, axis=-1, keepdims=True), 1e-20)
        indices = self.indices[:, ::-1] if np.linalg.det(rot) < 0.0 else self.indices
        return MeshData(
            positions=pos.astype(np.float32),
            indices=indices,
            normals=normals.astype(np.float32),
            uvs=self.uvs,
            tangents=self.tangents @ rot.T if self.tangents is not None else None,
            bitangents=self.bitangents @ rot.T if self.bitangents is not None else None,
            colors=self.colors,
            name=self.name,
        )


def compute_vertex_normals(positions: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Area-weighted smooth vertex normals (the host library's)."""
    return native.vertex_normals(positions, indices)


def compute_vertex_normals_plain(positions: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """``compute_vertex_normals`` in numpy, which sums each vertex's face
    normals in another order (within 1e-6)."""
    v0 = positions[indices[:, 0]]
    v1 = positions[indices[:, 1]]
    v2 = positions[indices[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)
    normals = np.zeros_like(positions)
    for k in range(3):
        np.add.at(normals, indices[:, k], fn)
    norm = np.linalg.norm(normals, axis=-1, keepdims=True)
    return (normals / np.maximum(norm, 1e-20)).astype(np.float32)


def compute_tangents(
    positions: np.ndarray,
    normals: np.ndarray,
    uvs: np.ndarray,
    indices: np.ndarray,
):
    """Per-vertex tangent/bitangent frames from UV derivatives (Lengyel's
    method): the ``aiProcess_CalcTangentSpace`` analog the reference gets
    for free from Assimp (``AssimpMeshProvider.cpp:683``), for formats
    that ship UVs + a normal map but no authored tangents.

    Accumulates each triangle's UV-gradient tangent direction onto its
    vertices, Gram-Schmidt-orthonormalizes against the vertex normal, and
    takes the bitangent as ``cross(n, t)`` with the handedness of the
    accumulated frame.  Returns (tangents (V, 3), bitangents (V, 3))."""
    v0, v1, v2 = (positions[indices[:, k]] for k in range(3))
    w0, w1, w2 = (uvs[indices[:, k]] for k in range(3))
    e1, e2 = v1 - v0, v2 - v0
    du1, dv1 = w1[:, 0] - w0[:, 0], w1[:, 1] - w0[:, 1]
    du2, dv2 = w2[:, 0] - w0[:, 0], w2[:, 1] - w0[:, 1]
    det = du1 * dv2 - du2 * dv1
    inv = np.where(np.abs(det) > 1e-12, 1.0 / np.where(det == 0, 1, det), 0.0)
    tdir = (e1 * dv2[:, None] - e2 * dv1[:, None]) * inv[:, None]
    bdir = (e2 * du1[:, None] - e1 * du2[:, None]) * inv[:, None]

    tacc = np.zeros_like(positions, dtype=np.float64)
    bacc = np.zeros_like(positions, dtype=np.float64)
    for k in range(3):
        np.add.at(tacc, indices[:, k], tdir)
        np.add.at(bacc, indices[:, k], bdir)

    n = normals.astype(np.float64)
    t = tacc - n * np.sum(n * tacc, axis=1, keepdims=True)
    tlen = np.linalg.norm(t, axis=1, keepdims=True)
    # Degenerate UVs: fall back to any frame orthogonal to n.
    fallback = np.cross(n, np.where(np.abs(n[:, :1]) < 0.9,
                                    [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]))
    fallback /= np.maximum(
        np.linalg.norm(fallback, axis=1, keepdims=True), 1e-20
    )
    t = np.where(tlen > 1e-8, t / np.maximum(tlen, 1e-20), fallback)
    hand = np.where(
        np.sum(np.cross(n, t) * bacc, axis=1, keepdims=True) < 0.0,
        -1.0,
        1.0,
    )
    b = np.cross(n, t) * hand
    return t.astype(np.float32), b.astype(np.float32)


def morton_order_plain(positions: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """``native.morton_order`` in numpy: the triangle permutation sorting
    centroids along a 30-bit Morton curve."""
    c = positions[indices].mean(axis=1)
    lo = c.min(axis=0)
    extent = np.maximum(c.max(axis=0) - lo, 1e-12)
    q = np.clip(((c - lo) / extent) * 1023.0, 0.0, 1023.0).astype(np.uint64)

    def spread(x):
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    code = (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])
    return np.argsort(code, kind="stable").astype(np.int64)


def merge_meshes(meshes: List[MeshData], material_ids: List[int]) -> Geometry:
    """Concatenate per-mesh buffers into one Morton-ordered ``Geometry``."""
    if len(meshes) != len(material_ids):
        raise ValueError("one material id per mesh")
    pos, nrm, uv, tan, bit, col, idx, mat = [], [], [], [], [], [], [], []
    offset = 0
    for mesh, mid in zip(meshes, material_ids):
        v = mesh.positions.shape[0]
        pos.append(mesh.positions)
        nrm.append(mesh.normals)
        uv.append(mesh.uvs.astype(np.float32) if mesh.uvs is not None
                  else np.zeros((v, 2), np.float32))
        if mesh.tangents is not None:
            tangents = mesh.tangents.astype(np.float32)
            bitangents = (mesh.bitangents.astype(np.float32) if mesh.bitangents is not None
                          else np.cross(mesh.normals, tangents).astype(np.float32))
        elif mesh.uvs is not None:
            # UVs without authored tangents: the frame from the UVs
            # (``aiProcess_CalcTangentSpace``'s analog), so normal maps work.
            tangents, bitangents = compute_tangents(
                mesh.positions, mesh.normals, mesh.uvs.astype(np.float32), mesh.indices)
        else:
            tangents = bitangents = np.zeros((v, 3), np.float32)
        tan.append(tangents)
        bit.append(bitangents)
        col.append(
            mesh.colors.astype(np.float32)
            if mesh.colors is not None
            else np.ones((v, 3), np.float32)
        )
        idx.append(mesh.indices + offset)
        mat.append(np.full((mesh.indices.shape[0],), mid, dtype=np.int32))
        offset += v
    all_pos = np.concatenate(pos)
    all_idx = np.concatenate(idx)
    order = native.morton_order(all_pos, all_idx)
    mesh_of = np.repeat(np.arange(len(meshes), dtype=np.int32),
                        [m.indices.shape[0] for m in meshes])

    def planar(a):
        return torch.from_numpy(np.ascontiguousarray(a.T))

    return Geometry(
        positions=planar(all_pos),
        normals=planar(np.concatenate(nrm)),
        uvs=planar(np.concatenate(uv)),
        tangents=planar(np.concatenate(tan)),
        bitangents=planar(np.concatenate(bit)),
        colors=planar(np.concatenate(col)),
        indices=planar(all_idx[order]),
        material_ids=torch.from_numpy(np.concatenate(mat)[order]),
        mesh_ids=torch.from_numpy(mesh_of[order]),
    )


def scene_aabb(geometry: Geometry) -> np.ndarray:
    """(2, 3) min/max corners of the scene's vertices (host numpy)."""
    p = geometry.positions.cpu().numpy()  # (3, V)
    return np.stack([p.min(axis=1), p.max(axis=1)])


def translate(v) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = v
    return m


def scale(v) -> np.ndarray:
    """Scaling by ``v`` (a scalar or one factor per axis), as a 4x4 matrix."""
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[1, 1], m[2, 2] = np.broadcast_to(np.asarray(v, dtype=np.float32), (3,))
    return m


def rotate(angle: float, axis) -> np.ndarray:
    """Rotation about an axis (radians), as a 4x4 matrix."""
    axis = np.asarray(axis, dtype=np.float64)
    x, y, z = axis / np.linalg.norm(axis)
    c, s = np.cos(angle), np.sin(angle)
    C = 1 - c
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = np.array(
        [
            [x * x * C + c, x * y * C - z * s, x * z * C + y * s],
            [y * x * C + z * s, y * y * C + c, y * z * C - x * s],
            [z * x * C - y * s, z * y * C + x * s, z * z * C + c],
        ]
    )
    return m
