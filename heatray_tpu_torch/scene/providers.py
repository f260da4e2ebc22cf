"""Procedural mesh providers (sphere, plane, box); a numpy copy of
``heatray_tpu.scene.providers``, itself ported from the semantics of
``Source/HeatrayRenderer/Scene/SphereMeshProvider.h`` and
``PlaneMeshProvider.h`` (vectorized numpy instead of scalar fill loops).
"""

from __future__ import annotations

import numpy as np

from .geometry import MeshData


def sphere_mesh(
    u_slices: int = 50, v_slices: int = 50, radius: float = 1.0, name: str = "sphere"
) -> MeshData:
    """Lat/long sphere with positions/normals/uvs.

    Mirrors ``SphereMeshProvider.h``: (u_slices+1) x (v_slices+2) vertex grid,
    u wraps the equator (phi), v runs pole to pole (theta), uv.y = 1 - v.
    """
    vsteps = v_slices + 2
    u = np.arange(u_slices + 1, dtype=np.float32) / np.float32(u_slices)
    v = np.arange(vsteps, dtype=np.float32) / np.float32(v_slices + 1)
    uu, vv = np.meshgrid(u, v, indexing="ij")  # (U+1, vsteps)
    phi = uu * np.float32(2.0 * np.pi)
    theta = vv * np.float32(np.pi)
    # ``CartesianFromSpherical`` (SphereMeshProvider.h:7-12): note the
    # sin(-theta) on z.
    x = radius * np.cos(phi) * np.sin(theta)
    y = radius * np.cos(theta)
    z = radius * np.sin(phi) * np.sin(-theta)
    pos = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float32)
    norm = pos / np.maximum(np.linalg.norm(pos, axis=-1, keepdims=True), 1e-20)
    uvs = np.stack([uu, 1.0 - vv], axis=-1).reshape(-1, 2).astype(np.float32)

    tris = []
    for ii in range(u_slices):
        for jj in range(vsteps - 1):
            if jj == 0:  # top cap fan
                tris.append(
                    (ii * vsteps, ii * vsteps + 1, (ii + 1) * vsteps + 1)
                )
            elif jj == vsteps - 2:  # bottom cap fan
                tris.append(
                    ((ii + 1) * vsteps + jj, ii * vsteps + jj, ii * vsteps + jj + 1)
                )
            else:  # quad band
                tris.append(
                    (ii * vsteps + jj, ii * vsteps + jj + 1, (ii + 1) * vsteps + jj + 1)
                )
                tris.append(
                    ((ii + 1) * vsteps + jj + 1, (ii + 1) * vsteps + jj, ii * vsteps + jj)
                )
    indices = np.asarray(tris, dtype=np.int32)
    return MeshData(positions=pos, indices=indices, normals=norm, uvs=uvs, name=name)


def plane_mesh(width: float = 1.0, length: float = 1.0, name: str = "plane") -> MeshData:
    """XZ plane (+Y normal) of size width x length centered at the origin,
    mirroring ``PlaneMeshProvider.h`` (its triangle strip 0,1,3,2 unrolled)."""
    hw, hl = 0.5 * width, 0.5 * length
    pos = np.array(
        [[-hw, 0.0, hl], [hw, 0.0, hl], [hw, 0.0, -hl], [-hw, 0.0, -hl]],
        dtype=np.float32,
    )
    nrm = np.tile(np.array([[0.0, 1.0, 0.0]], np.float32), (4, 1))
    uvs = np.array(
        [[-1.0, -1.0], [1.0, -1.0], [1.0, 1.0], [-1.0, 1.0]], dtype=np.float32
    )
    indices = np.array([[0, 1, 3], [3, 1, 2]], dtype=np.int32)
    return MeshData(positions=pos, indices=indices, normals=nrm, uvs=uvs, name=name)


def box_mesh(size=(1.0, 1.0, 1.0), inward: bool = False, name: str = "box") -> MeshData:
    """Axis-aligned box with per-face normals (no reference counterpart;
    used for Cornell-box style test scenes)."""
    sx, sy, sz = np.asarray(size, np.float32) * 0.5
    faces = []
    # (normal axis, sign)
    for axis, sign in [(0, 1), (0, -1), (1, 1), (1, -1), (2, 1), (2, -1)]:
        n = np.zeros(3, np.float32)
        n[axis] = sign
        a = (axis + 1) % 3
        b = (axis + 2) % 3
        c = np.zeros((4, 3), np.float32)
        ext = np.array([sx, sy, sz], np.float32)
        for k, (ua, ub) in enumerate([(-1, -1), (1, -1), (1, 1), (-1, 1)]):
            c[k, axis] = sign * ext[axis]
            c[k, a] = ua * ext[a]
            c[k, b] = ub * ext[b]
        # Ensure CCW winding w.r.t. the outward normal.
        e1, e2 = c[1] - c[0], c[3] - c[0]
        if np.dot(np.cross(e1, e2), n) < 0:
            c = c[[0, 3, 2, 1]]
        faces.append((c, n))
    pos = np.concatenate([c for c, _ in faces])
    nrm = np.concatenate([np.tile(n, (4, 1)) for _, n in faces])
    if inward:
        nrm = -nrm
    idx = []
    for f in range(6):
        o = 4 * f
        if inward:
            idx += [[o, o + 2, o + 1], [o, o + 3, o + 2]]
        else:
            idx += [[o, o + 1, o + 2], [o, o + 2, o + 3]]
    uvs = np.tile(
        np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32), (6, 1)
    )
    return MeshData(
        positions=pos.astype(np.float32),
        indices=np.asarray(idx, np.int32),
        normals=nrm.astype(np.float32),
        uvs=uvs,
        name=name,
    )
