"""Host-sharded geometry (port of ``heatray_tpu.parallel.geometry``): scenes
whose triangle data outgrows one device split across a mesh axis.

Triangles are Morton-ordered by the scene builder, so splitting the
triangle range into D contiguous pieces gives spatially compact shards, a
forest of trees, one per rank of the axis.  Every rank intersects the WHOLE
wavefront against its own shard only, and the results are reduced over the
axis with ``torch.distributed`` (closest hit: the least t, ties to the least
global slot; occlusion: any).  This trades D-fold ray work for D-fold
geometry memory, the standard scheme when geometry, not rays, binds memory.
Closest-hit ids stay GLOBAL through per-shard offsets.

Two forests:

- ``ShardedAccel`` (``shard_accel``, ``make_sharded_intersectors``): the
  brute force of ``ops.intersect`` over D equal pieces of the Woop rows,
  stacked on a leading shard axis in one process and reduced by the min
  over that axis, as the JAX package's ``vmap`` does;
- ``ShardedWideBVH`` (``build_sharded_wide``, ``place_sharded_wide``,
  ``make_sharded_wide_intersectors``): one wide tree of 32-triangle leaves
  per piece, each rank holding its own on its device and running K1/K2
  (``csrc/wide_bvh.cu``) over it; the ``"sharded"`` backend of
  ``render.integrator``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import wide_bvh
from ..ops.intersect import MISS_T, WoopAccel, intersect_any, intersect_closest
from ..ops.wide_bvh import WideBVH, build_wide_bvh
from ..vec import Vec3

# The candidate slot of a rank whose t is not the least: above every slot.
_NO_SLOT = 1 << 30


@dataclasses.dataclass
class ShardedAccel:
    """Woop rows split into ``num_shards`` pieces of equal length, stacked on
    a leading shard axis; ``offsets`` maps each piece's triangle 0 to its
    global id.  Padding triangles have zeroed Woop rows (never hit) and
    inverted boxes."""

    w: torch.Tensor  # (D, 12, Tp)
    geo_normal: torch.Tensor  # (D, 3, Tp)
    tri_min: torch.Tensor  # (D, 3, Tp)
    tri_max: torch.Tensor  # (D, 3, Tp)
    offsets: torch.Tensor  # (D,) int32
    num_triangles: int
    num_shards: int

    def shard(self, i: int) -> WoopAccel:
        return WoopAccel(w=self.w[i], geo_normal=self.geo_normal[i], tri_min=self.tri_min[i],
                         tri_max=self.tri_max[i])


def shard_accel(accel: WoopAccel, mesh, axis: str = "dp") -> ShardedAccel:
    """Split ``accel`` into ``mesh.shape[axis]`` Morton-contiguous pieces of
    ``ceil(T / D)`` triangles (``mesh`` may also be the count itself), on
    the accel's device."""
    d = mesh if isinstance(mesh, int) else mesh.shape[axis]
    t = accel.num_triangles
    tp = -(-t // d)

    def pad(x, value=0.0):
        x = torch.nn.functional.pad(x, (0, d * tp - t), value=value)
        return x.reshape(x.shape[0], d, tp).permute(1, 0, 2).contiguous()

    return ShardedAccel(
        w=pad(accel.w),
        geo_normal=pad(accel.geo_normal),
        tri_min=pad(accel.tri_min, 3.0e38),
        tri_max=pad(accel.tri_max, -3.0e38),
        offsets=torch.arange(d, dtype=torch.int32, device=accel.w.device) * tp,
        num_triangles=t,
        num_shards=d,
    )


def make_sharded_intersectors(sharded: ShardedAccel, sharded_occl: ShardedAccel | None = None):
    """(closest, any) over a ``ShardedAccel``: ``closest(org, dir, t_min)``
    gives (t, global triangle id, hit), the contract of
    ``ops.intersect.intersect_closest``; ``any(org, dir, t_min, t_max)`` the
    blocked mask.  Each shard is queried in turn; the closest hit is the
    first shard with the least t (ties go to the least global id)."""
    occl = sharded_occl if sharded_occl is not None else sharded

    def closest(org: Vec3, direction: Vec3, t_min):
        ts, ids = [], []
        for i in range(sharded.num_shards):
            t, tid, hit = intersect_closest(sharded.shard(i), org, direction, t_min)
            ts.append(t)
            ids.append(torch.where(hit, tid + sharded.offsets[i], -1))
        t, tid = torch.stack(ts), torch.stack(ids)  # (D, R)
        sel = torch.argmin(t, dim=0, keepdim=True)  # the first least t
        t, tid = t.gather(0, sel)[0], tid.gather(0, sel)[0]
        return t, tid, tid >= 0

    def any_hit(org: Vec3, direction: Vec3, t_min, t_max):
        blocked = torch.zeros(org.x.shape, dtype=torch.bool, device=org.x.device)
        for i in range(occl.num_shards):
            blocked |= intersect_any(occl.shard(i), org, direction, t_min, t_max)
        return blocked

    return closest, any_hit


@dataclasses.dataclass
class ShardedWideBVH:
    """A Morton-shard forest of wide trees.  ``shards[i]`` is shard i's
    ``WideBVH`` (None where this rank does not hold it), whose ``slot_tri``
    holds GLOBAL triangle ids (-1 padding); ``slot_tri`` (D, C * Tc) is every
    shard's, each padded to the most chunks C of any shard, so that global
    slot ``i * C * Tc + local slot`` indexes the concatenated table
    (``slot_offset[i] = i * C * Tc``); ``shard`` is the one shard a placed
    forest holds (``place_sharded_wide``), None where it holds all.  Each
    shard's tree keeps its own node and chunk counts, its block boxes and
    its own ``max_stack``."""

    shards: tuple
    slot_tri: torch.Tensor
    slot_offset: torch.Tensor
    leaf_size: int
    num_triangles: int
    num_shards: int
    shard: int | None = None

    @property
    def slots_per_shard(self) -> int:
        return self.slot_tri.shape[1]

    def shard_bvh(self, i: int | None = None) -> WideBVH:
        """The tree of shard ``i`` (default: the one a placed forest holds)."""
        i = self.shard if i is None else i
        if i is None or self.shards[i] is None:
            raise ValueError(f"this forest does not hold shard {i}")
        return self.shards[i]


def _forest(trees: list, leaf_size: int, num_triangles: int, shard=None) -> ShardedWideBVH:
    """A ``ShardedWideBVH`` holding every shard's tree, with their global
    slot tables ``slot_tri`` each padded to the most slots."""
    tables = [t.slot_tri.cpu() for t in trees]
    slots = max(x.shape[0] for x in tables)
    slot_tri = torch.stack([torch.nn.functional.pad(x, (0, slots - x.shape[0]), value=-1)
                            for x in tables])
    d = len(trees)
    return ShardedWideBVH(
        shards=tuple(trees), slot_tri=slot_tri,
        slot_offset=torch.arange(d, dtype=torch.int32) * slots,
        leaf_size=leaf_size, num_triangles=num_triangles, num_shards=d, shard=shard,
    )


def build_sharded_wide(accel: WoopAccel, num_shards: int, leaf_size: int = 32,
                       include: np.ndarray | None = None) -> ShardedWideBVH:
    """Split the (Morton-ordered) triangle range into ``num_shards``
    contiguous pieces, ``bounds[i] = round(i * T / D)``, and build one wide
    tree per piece, all on the host (the f32 leaf layout of
    ``build_wide_bvh``).  ``include`` (T,) bool filters triangles (the
    occluder-only forest).  ``place_sharded_wide`` moves a rank's own tree to
    its device."""
    t = accel.num_triangles
    host = WoopAccel(w=accel.w.detach().cpu(), geo_normal=accel.geo_normal.detach().cpu(),
                     tri_min=accel.tri_min.detach().cpu(), tri_max=accel.tri_max.detach().cpu())
    bounds = [round(i * t / num_shards) for i in range(num_shards + 1)]
    trees = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        sub = WoopAccel(w=host.w[:, lo:hi], geo_normal=host.geo_normal[:, lo:hi],
                        tri_min=host.tri_min[:, lo:hi], tri_max=host.tri_max[:, lo:hi])
        tree = build_wide_bvh(sub, leaf_size=leaf_size,
                              include=None if include is None else include[lo:hi])
        trees.append(dataclasses.replace(
            tree, num_triangles=t,
            slot_tri=torch.where(tree.slot_tri >= 0, tree.slot_tri + lo, -1).int()))
    return _forest(trees, trees[0].leaf_size, t)


def place_sharded_wide(swide: ShardedWideBVH, mesh, axis: str = "dp",
                       device=None) -> ShardedWideBVH:
    """The forest as this rank holds it: its own shard, ``mesh``'s
    coordinate on ``axis``, on ``device`` (default the mesh's), the others
    dropped; the global slot tables stay whole."""
    if swide.num_shards != mesh.shape[axis]:
        raise ValueError(f"a forest of {swide.num_shards} shards on a mesh axis of "
                         f"{mesh.shape[axis]} ranks")
    device = mesh.device if device is None else torch.device(device)
    keep = mesh.coordinate(axis)
    return dataclasses.replace(
        swide,
        shards=tuple(tree.to(device) if i == keep else None
                     for i, tree in enumerate(swide.shards)),
        slot_tri=swide.slot_tri.to(device),
        slot_offset=swide.slot_offset.to(device),
        shard=keep,
    )


def make_sharded_wide_intersectors(swide: ShardedWideBVH, swide_occl: ShardedWideBVH | None,
                                   mesh, axis: str = "dp"):
    """(closest, any) over a placed forest: each rank runs K1/K2
    (``ops.wide_bvh.intersect_closest_wide``/``intersect_any_wide``: the
    kernels on a CUDA tree, their plain versions on the CPU) over its own
    tree on the whole wavefront, which every rank of ``mesh[axis]`` must
    pass alike, and the results are reduced over the axis.

    ``closest(org, dir, t_min) -> (t, GLOBAL slot, hit)``, the contract of
    the wide backend, to pair with a shading table in the order of the
    concatenated ``swide.slot_tri``: the least t over the ranks (MIN), then
    the least global slot among the ranks whose hit has that t (MIN, so
    ties go to the least global slot); a ray hits where a slot came back
    (the JAX package's MAX of the hit masks, which the slot's MIN already
    carries).  ``any(org, dir, t_min, t_max)``: the MAX of the ranks'
    blocked masks."""
    occl = swide_occl if swide_occl is not None else swide
    tree, tree_occl = swide.shard_bvh(), occl.shard_bvh()
    base = swide.shard * swide.slots_per_shard  # slot_offset[shard], without a device read

    def closest(org: Vec3, direction: Vec3, t_min):
        t, slot, hit = wide_bvh.intersect_closest_wide(tree, org, direction, t_min)
        t_all = mesh.all_reduce(t.clone(), "min", axis)
        cand = torch.where(hit & (t <= t_all), slot + base, _NO_SLOT)
        slot_all = mesh.all_reduce(cand, "min", axis)
        hit_all = slot_all < _NO_SLOT
        return (torch.where(hit_all, t_all, MISS_T), torch.where(hit_all, slot_all, -1),
                hit_all)

    def any_hit(org: Vec3, direction: Vec3, t_min, t_max):
        blocked = wide_bvh.intersect_any_wide(tree_occl, org, direction, t_min, t_max)
        return mesh.all_reduce(blocked.to(torch.uint8), "max", axis) > 0

    return closest, any_hit
