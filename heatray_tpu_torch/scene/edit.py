"""Functional scene edits (port of ``heatray_tpu.scene.edit``).

The original renderer edits retained-mode state in place:
``Scene::applyTransform`` re-uploads per-submesh ``worldFromEntity``
matrices (``Scene/Scene.cpp:38-49``), ``Scene::addMesh``/``removeMesh``
mutate the primitive list, and the ``Lighting`` registry adds, updates and
removes lights with swap-compaction (``Scene/Lighting.cpp:239-271``).  Here
every edit returns a NEW ``Scene`` and leaves its argument as it was.  A
tree built for the old scene never traces the new one: render the edit
through a new ``make_context(options, new_scene)``, which builds the wide
BVH and its leaf block boxes again (the analog of the original renderer's
reset after an edit, ``HeatrayRenderer.cpp:1601-1608``: accumulation
restarts from pass 0).

``apply_transform`` is torch on the scene's device and differentiable in
the matrix; mesh add/remove change shapes and run on the host.  An edit
keeps ``Scene.has_alpha_mask`` and ``Scene.has_textures`` true to the
triangles it leaves.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .geometry import Geometry, MeshData, merge_meshes
from .lights import (
    MAX_DIRECTIONAL_LIGHTS,
    MAX_POINT_LIGHTS,
    MAX_SPOT_LIGHTS,
    DirectionalLight,
    PointLight,
    SpotLight,
)
from .materials import TEXTURE_SLOTS, GlassParams, PBRParams, build_material_table
from .scene import Scene

# --------------------------------------------------------------------------
# Transforms (``Scene::applyTransform``, ``Scene/Scene.cpp:38-49``)
# --------------------------------------------------------------------------


def apply_transform(scene: Scene, matrix) -> Scene:
    """Apply a 4x4 world transform (array or tensor) to ALL scene geometry.

    Positions map by ``M``, normals by ``inv(M_3x3)^T`` (renormalized),
    tangent frames by the linear part.  A negative-determinant transform
    flips triangle winding so geometric normals stay outward (the analog of
    ``Mesh.cpp:86-91``).  Gradients flow to a ``matrix`` that requires them.
    """
    g = scene.geometry
    m = torch.as_tensor(matrix, dtype=torch.float32).to(g.positions.device)
    rot = m[:3, :3]
    nrm = torch.linalg.inv(rot).T @ g.normals
    nrm = nrm / torch.clamp(torch.linalg.vector_norm(nrm, dim=0, keepdim=True), min=1e-20)
    flip = bool(torch.linalg.det(rot.detach()) < 0.0)
    return dataclasses.replace(scene, geometry=dataclasses.replace(
        g,
        positions=rot @ g.positions + m[:3, 3:4],
        normals=nrm,
        tangents=rot @ g.tangents,
        bitangents=rot @ g.bitangents,
        # Winding flip on reflection: swap index rows 1 and 2.
        indices=g.indices[[0, 2, 1]] if flip else g.indices,
    ))


def trs_matrix(
    yaw: float = 0.0,
    pitch: float = 0.0,
    roll: float = 0.0,
    scale: float = 1.0,
) -> np.ndarray:
    """Session-style transform: uniform scale, then roll (Z), pitch (X),
    yaw (Y) — the ``Scene.RotationYaw/Pitch/Roll/Scale`` session variables
    (``Session.h:20-75``), applied about the world origin."""

    def rot(angle, i, j):
        r = np.eye(4, dtype=np.float32)
        c, s = np.cos(angle), np.sin(angle)
        r[i, i], r[i, j], r[j, i], r[j, j] = c, -s, s, c
        return r

    s = np.eye(4, dtype=np.float32)
    s[0, 0] = s[1, 1] = s[2, 2] = scale
    yaw_m = rot(yaw, 0, 2)  # about Y
    pitch_m = rot(pitch, 1, 2)  # about X
    roll_m = rot(roll, 0, 1)  # about Z
    return (yaw_m @ pitch_m @ roll_m @ s).astype(np.float32)


# --------------------------------------------------------------------------
# Mesh add / remove (``Scene::addMesh``/``removeMesh``)
# --------------------------------------------------------------------------


def _textured(materials, ids: torch.Tensor) -> bool:
    """Whether any of the materials ``ids`` reads a texture."""
    return any(bool((getattr(materials, slot)[ids] >= 0).any()) for slot in TEXTURE_SLOTS)


def add_mesh(
    scene: Scene,
    mesh: MeshData,
    material: PBRParams | GlassParams,
    transform: np.ndarray | None = None,
) -> Scene:
    """Append a mesh and its material to the scene (on the host: shapes
    change).  Its texture ids index the scene's atlas, which stays as it
    is."""
    if transform is not None:
        mesh = mesh.transformed(transform)
    g = scene.geometry
    dev = g.positions.device
    table = build_material_table([material])
    if _textured(table, torch.zeros(1, dtype=torch.long)):
        used = max(int(getattr(table, slot)[0]) for slot in TEXTURE_SLOTS)
        if not scene.has_textures or used >= scene.atlas.num_textures:
            raise ValueError(f"texture {used} is not in the scene's atlas")
    new_mid = scene.materials.base_color.shape[-1]  # planar (3, M)
    new_mesh_id = int(g.mesh_ids.max()) + 1 if g.num_triangles else 0
    sub = merge_meshes([mesh], [0])  # one mesh, Morton-ordered within

    def cat(a, b):
        return torch.cat([a, b.to(dev)], dim=-1)

    geometry = Geometry(
        positions=cat(g.positions, sub.positions),
        normals=cat(g.normals, sub.normals),
        uvs=cat(g.uvs, sub.uvs),
        tangents=cat(g.tangents, sub.tangents),
        bitangents=cat(g.bitangents, sub.bitangents),
        colors=cat(g.colors, sub.colors),
        indices=cat(g.indices, sub.indices + g.num_vertices),
        material_ids=cat(g.material_ids, torch.full_like(sub.material_ids, new_mid)),
        mesh_ids=cat(g.mesh_ids, torch.full_like(sub.mesh_ids, new_mesh_id)),
    )
    # The material dimension of every table field is the last one.
    materials = type(scene.materials)(**{
        f.name: cat(getattr(scene.materials, f.name), getattr(table, f.name))
        for f in dataclasses.fields(scene.materials)
    })
    return dataclasses.replace(
        scene, geometry=geometry, materials=materials,
        has_alpha_mask=scene.has_alpha_mask or bool(getattr(material, "alpha_masked", False)),
    )


def remove_mesh(scene: Scene, mesh_id: int) -> Scene:
    """Drop every triangle of ``mesh_id`` (on the host).  Vertices are left
    in place (unreferenced vertices are harmless to the intersector).  The
    scene keeps its alpha-mask flag only if a triangle left has an
    alpha-masked material, and its texture flag only if one left reads a
    texture."""
    g = scene.geometry
    keep = g.mesh_ids != mesh_id
    if not bool(keep.any()):
        raise ValueError("removing the last mesh leaves an empty scene")
    mids = g.material_ids[keep]
    used = torch.unique(mids).long()
    return dataclasses.replace(
        scene,
        geometry=dataclasses.replace(g, indices=g.indices[:, keep], material_ids=mids,
                                     mesh_ids=g.mesh_ids[keep]),
        has_alpha_mask=scene.has_alpha_mask and bool((scene.materials.alpha_mask[used] != 0).any()),
        has_textures=scene.has_textures and _textured(scene.materials, used),
    )


# --------------------------------------------------------------------------
# Light add / update / remove (``Lighting.cpp:239-271`` swap-compaction)
# --------------------------------------------------------------------------


def _set_rows(bank, index: int, **rows):
    """A copy of light bank ``bank`` with row ``index`` of each named field
    set (a tensor row or host values)."""
    out = {}
    for name, row in rows.items():
        arr = getattr(bank, name).clone()
        arr[index] = torch.as_tensor(np.asarray(row, np.float32) if not torch.is_tensor(row)
                                     else row, dtype=arr.dtype, device=arr.device)
        out[name] = arr
    return dataclasses.replace(bank, **out)


def _unit(v) -> np.ndarray:
    d = np.asarray(v, np.float32)
    return d / max(np.linalg.norm(d), 1e-20)


def _check(index: int, n: int):
    if not 0 <= index < n:
        raise IndexError(f"light {index} of {n}")


def _spot_angles(light: SpotLight):
    return (math.cos(light.inner_angle), math.cos(light.outer_angle))


def add_directional_light(scene: Scene, light: DirectionalLight) -> Scene:
    b = scene.lights
    n = b.num_directional
    if n >= MAX_DIRECTIONAL_LIGHTS:
        raise ValueError("directional light capacity reached")
    b = _set_rows(b, n, dir_direction=_unit(light.direction), dir_color=light.radiometric_color())
    return dataclasses.replace(scene, lights=dataclasses.replace(b, num_directional=n + 1))


def update_directional_light(scene: Scene, index: int, light: DirectionalLight) -> Scene:
    b = scene.lights
    _check(index, b.num_directional)
    return dataclasses.replace(scene, lights=_set_rows(
        b, index, dir_direction=_unit(light.direction), dir_color=light.radiometric_color()))


def remove_directional_light(scene: Scene, index: int) -> Scene:
    """Swap-compact removal (``Lighting.cpp:239-271``): the last light moves
    into the removed slot."""
    b = scene.lights
    _check(index, b.num_directional)
    last = b.num_directional - 1
    b = _set_rows(b, index, dir_direction=b.dir_direction[last], dir_color=b.dir_color[last])
    return dataclasses.replace(scene, lights=dataclasses.replace(b, num_directional=last))


def add_point_light(scene: Scene, light: PointLight) -> Scene:
    b = scene.lights
    n = b.num_point
    if n >= MAX_POINT_LIGHTS:
        raise ValueError("point light capacity reached")
    b = _set_rows(b, n, point_position=light.position, point_color=light.radiometric_color())
    return dataclasses.replace(scene, lights=dataclasses.replace(b, num_point=n + 1))


def update_point_light(scene: Scene, index: int, light: PointLight) -> Scene:
    b = scene.lights
    _check(index, b.num_point)
    return dataclasses.replace(scene, lights=_set_rows(
        b, index, point_position=light.position, point_color=light.radiometric_color()))


def remove_point_light(scene: Scene, index: int) -> Scene:
    b = scene.lights
    _check(index, b.num_point)
    last = b.num_point - 1
    b = _set_rows(b, index, point_position=b.point_position[last], point_color=b.point_color[last])
    return dataclasses.replace(scene, lights=dataclasses.replace(b, num_point=last))


def add_spot_light(scene: Scene, light: SpotLight) -> Scene:
    b = scene.lights
    n = b.num_spot
    if n >= MAX_SPOT_LIGHTS:
        raise ValueError("spot light capacity reached")
    b = _set_rows(b, n, spot_position=light.position, spot_direction=_unit(light.direction),
                  spot_color=light.radiometric_color(), spot_cos_angles=_spot_angles(light))
    return dataclasses.replace(scene, lights=dataclasses.replace(b, num_spot=n + 1))


def update_spot_light(scene: Scene, index: int, light: SpotLight) -> Scene:
    b = scene.lights
    _check(index, b.num_spot)
    return dataclasses.replace(scene, lights=_set_rows(
        b, index, spot_position=light.position, spot_direction=_unit(light.direction),
        spot_color=light.radiometric_color(), spot_cos_angles=_spot_angles(light)))


def remove_spot_light(scene: Scene, index: int) -> Scene:
    b = scene.lights
    _check(index, b.num_spot)
    last = b.num_spot - 1
    b = _set_rows(b, index, spot_position=b.spot_position[last],
                  spot_direction=b.spot_direction[last], spot_color=b.spot_color[last],
                  spot_cos_angles=b.spot_cos_angles[last])
    return dataclasses.replace(scene, lights=dataclasses.replace(b, num_spot=last))
