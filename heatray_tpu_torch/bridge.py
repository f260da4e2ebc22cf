"""Carry state built by the JAX package into the port.

Every function takes plain dicts of numpy arrays, keyed by the field names
of the JAX package's dataclasses (for example
``{f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}``),
never JAX objects, and returns the port's object on ``device`` (the card
unless the caller names another).  Both
packages can then compute on the same scene (with its UVs, tangents,
texture ids, texture atlas and lat/long environment map), tree, tables and
camera.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .camera import CameraParams
from .ops.wide_bvh import WideBVH, leaf_blocks, max_stack_depth, slot_boxes
from .sampling.tables import SampleTables
from .scene.geometry import Geometry
from .scene.lights import LightBank
from .scene.materials import MaterialTable
from .scene.scene import Scene, tensors_to
from .scene.textures import AtlasBuilder, TextureAtlas


def _tensors(cls, arrays: dict, device, scalars=()):
    """Build dataclass ``cls`` from the keys of ``arrays`` that it has:
    tensors, except the host scalars named in ``scalars``."""
    out = {}
    for f in dataclasses.fields(cls):
        if f.name not in arrays:
            continue
        a = np.asarray(arrays[f.name])
        if f.name in scalars:
            out[f.name] = a.item()
        else:
            out[f.name] = torch.from_numpy(np.array(a)).to(device)
    return cls(**out)


def scene_from_arrays(
    geometry: dict,
    materials: dict,
    lights: dict,
    has_alpha_mask: bool = False,
    has_textures: bool = False,
    atlas: dict | None = None,
    device="cuda",
) -> Scene:
    """A Scene from the arrays of ``Scene.geometry``, ``Scene.materials``,
    ``Scene.lights`` and, for a scene with textures, ``Scene.atlas``."""
    return Scene(
        geometry=_tensors(Geometry, geometry, device),
        materials=_tensors(MaterialTable, materials, device),
        lights=_tensors(
            LightBank, lights, device,
            scalars=("num_directional", "num_point", "num_spot", "env_enabled",
                     "env_exposure_compensation", "env_rotation"),
        ),
        has_alpha_mask=bool(has_alpha_mask),
        has_textures=bool(has_textures),
        atlas=(atlas_from_arrays(atlas, device) if atlas is not None
               else tensors_to(AtlasBuilder().build(), device)),
    )


def atlas_from_arrays(arrays: dict, device="cuda") -> TextureAtlas:
    """A TextureAtlas from the arrays of ``Scene.atlas``."""
    return _tensors(TextureAtlas, arrays, device)


def wide_bvh_from_arrays(
    arrays: dict, leaf_size: int, num_triangles: int, accel: dict, device="cuda"
) -> WideBVH:
    """A WideBVH from the arrays of a ``schedule="f32"`` build, with the
    leaves' block boxes (``WideBVH.blocks``, which the reference has not)
    made from the ``tri_min``/``tri_max`` arrays of the ``WoopAccel`` it was
    built from (``accel``)."""
    if np.asarray(arrays["w"]).dtype != np.float32:
        raise ValueError("only the f32 leaf layout (schedule='f32') is supported")
    t = {k: torch.from_numpy(np.array(np.asarray(arrays[k]))).to(device)
         for k in ("wbox", "wchild", "waxis", "w", "slot_tri", "wanchor")}
    tri_min, tri_max = (torch.from_numpy(np.array(np.asarray(accel[k]), np.float32)).to(device)
                        for k in ("tri_min", "tri_max"))
    return WideBVH(
        **t,
        leaf_size=int(leaf_size),
        num_triangles=int(num_triangles),
        max_stack=max_stack_depth(np.asarray(arrays["wchild"])),
        blocks=leaf_blocks(*slot_boxes(t["slot_tri"], tri_min, tri_max), int(leaf_size)),
    )


def sharded_wide_from_arrays(
    arrays: dict, leaf_size: int, num_triangles: int, num_shards: int, accel: dict,
    rank: int | None = None, device="cuda",
):
    """A ``parallel.geometry.ShardedWideBVH`` from the arrays of a
    ``schedule="f32"`` ``build_sharded_wide`` (each field stacked on the
    shard axis, padded to common shapes; padding nodes and chunks are
    unreachable): every shard's tree, or with ``rank`` that shard's alone
    (the forest a rank holds), each with block boxes made from the full
    accel's ``tri_min``/``tri_max`` indexed by its global triangle ids, as
    ``wide_bvh_from_arrays`` makes them."""
    from .parallel.geometry import ShardedWideBVH

    keep = range(num_shards) if rank is None else (rank,)
    shards = [
        wide_bvh_from_arrays({k: np.asarray(arrays[k])[i] for k in
                              ("wbox", "wchild", "waxis", "w", "slot_tri", "wanchor")},
                             leaf_size, num_triangles, accel, device) if i in keep else None
        for i in range(num_shards)
    ]
    return ShardedWideBVH(
        shards=tuple(shards),
        slot_tri=torch.from_numpy(np.array(np.asarray(arrays["slot_tri"]), np.int32)).to(device),
        slot_offset=torch.from_numpy(np.array(np.asarray(arrays["slot_offset"]), np.int32)
                                     ).to(device),
        leaf_size=int(leaf_size), num_triangles=int(num_triangles), num_shards=int(num_shards),
        shard=rank,
    )


def tables_from_arrays(
    arrays: dict, num_sequences: int, sequence_length: int, device="cuda"
) -> SampleTables:
    tables = _tensors(SampleTables, arrays, device)
    return dataclasses.replace(
        tables, num_sequences=int(num_sequences), sequence_length=int(sequence_length)
    )


def camera_from_arrays(arrays: dict, device="cuda") -> CameraParams:
    return _tensors(CameraParams, arrays, device)


def params_from_arrays(arrays: dict, device="cuda") -> dict:
    """Parameters for ``diff.inverse.make_loss_fn`` from a dict of arrays
    keyed as the JAX package's ``make_loss_fn`` keys them (``"base_color"``,
    ``"light.point_color"``, ``"camera.orbit"``, ...): float32 leaf
    tensors on ``device`` that require gradients."""
    return {k: torch.tensor(np.asarray(v, np.float32), device=device, requires_grad=True)
            for k, v in arrays.items()}
