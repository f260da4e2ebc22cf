"""Binned-SAH binary BVH over triangle AABBs (port of ``heatray_tpu.ops.bvh``).

``build_topology`` (host, the port's C++ library ``native.py``) flattens the
tree in DFS preorder with skip pointers; leaves are fixed-size triangle
chunks (``leaf_size`` slots, padded with -1).  ``build_topology_plain`` is
its numpy twin, for the tests.  ``wide_bvh.py`` collapses the tree into
arity-8 nodes; ``pack_bvh`` packs it as it is for the binary-BVH kernels
(``traverse_pallas.py``), and ``traverse_closest_numpy`` walks it one ray
at a time as a test oracle.
``leaf_blocks`` gives any of these trees (and the chunk packs) the boxes of
each leaf's runs of BLOCK slots, which the block-culled kernels cull by;
the reference has none.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from .. import native
from .intersect import WoopAccel

# Past this depth the builder forces median splits, which bounds the tree
# depth (and the traversal stack) by MAX_SAH_DEPTH + log2(T).
MAX_SAH_DEPTH = 48
BLOCK = 32  # slots under one block box (K4, K5, K6a, K7): a warp's width
_BIG_BOX = 3.0e38  # the corners of an inverted (empty) box


@dataclasses.dataclass(frozen=True)
class BVHTopology:
    """Flattened tree: pure structure, no triangle data."""

    nbox: np.ndarray  # (N, 6) f32 node AABBs [min xyz, max xyz]
    leaf_chunk: np.ndarray  # (N,) i32: chunk id for leaves, -1 - axis inside
    skip: np.ndarray  # (N,) i32 DFS escape pointer (N = done)
    slot_tri: np.ndarray  # (C * Tc,) i32 chunk slot -> triangle id, -1 pad
    leaf_size: int

    @property
    def num_nodes(self) -> int:
        return self.nbox.shape[0]

    @property
    def num_chunks(self) -> int:
        return self.slot_tri.shape[0] // self.leaf_size


def build_topology(
    tri_min: np.ndarray,
    tri_max: np.ndarray,
    leaf_size: int = 64,
    n_bins: int = 16,
    include: np.ndarray | None = None,
) -> BVHTopology:
    """Binned-SAH build over triangle AABBs ``tri_min``/``tri_max`` (3, T),
    in the host library (``native.bvh_build``).

    ``include``: optional (T,) bool; only these triangles enter the tree.
    With none, the tree is one empty leaf whose box never passes a slab test.
    """
    nbox, leaf_chunk, skip, slot_tri = native.bvh_build(
        np.asarray(tri_min, np.float32), np.asarray(tri_max, np.float32),
        None if include is None else np.asarray(include, bool), leaf_size, n_bins)
    return BVHTopology(nbox=nbox, leaf_chunk=leaf_chunk, skip=skip, slot_tri=slot_tri,
                       leaf_size=leaf_size)


def build_topology_plain(
    tri_min: np.ndarray,
    tri_max: np.ndarray,
    leaf_size: int = 64,
    n_bins: int = 16,
    include: np.ndarray | None = None,
) -> BVHTopology:
    """``build_topology`` in numpy: the same tree, field for field."""
    tri_min = np.asarray(tri_min, np.float32)
    tri_max = np.asarray(tri_max, np.float32)
    ids = np.arange(tri_min.shape[1], dtype=np.int32)
    if include is not None:
        ids = ids[np.asarray(include, bool)]
    if ids.size == 0:
        # One empty leaf whose box never passes a slab test.
        big = np.float32(3.0e38)
        return BVHTopology(
            nbox=np.array([[big, big, big, -big, -big, -big]], np.float32),
            leaf_chunk=np.array([0], np.int32),
            skip=np.array([1], np.int32),
            slot_tri=np.full((leaf_size,), -1, np.int32),
            leaf_size=leaf_size,
        )
    bmin = tri_min[:, ids].T  # (T', 3)
    bmax = tri_max[:, ids].T
    cent = 0.5 * (bmin + bmax)

    nbox: list[np.ndarray] = []
    leaf_chunk: list[int] = []
    skip: list[int] = []
    leaves: list[np.ndarray] = []
    order = np.arange(ids.shape[0])

    def areas(mn, mx):
        d = np.maximum(mx - mn, 0.0)
        return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

    def emit(lo: int, hi: int, depth: int = 0) -> None:
        """Emit the subtree over order[lo:hi] in preorder."""
        my = len(nbox)
        sel = order[lo:hi]
        nbox.append(np.concatenate([bmin[sel].min(axis=0), bmax[sel].max(axis=0)]))
        leaf_chunk.append(-1)
        skip.append(-1)

        if hi - lo <= leaf_size:
            leaf_chunk[my] = len(leaves)
            leaves.append(ids[sel])
            skip[my] = len(nbox)
            return

        c = cent[sel]
        lo_c = c.min(axis=0)
        extent = c.max(axis=0) - lo_c
        axis = int(np.argmax(extent))
        mid = None
        if extent[axis] > 1e-12 and depth < MAX_SAH_DEPTH:
            b = np.minimum(
                ((c[:, axis] - lo_c[axis]) / extent[axis] * n_bins).astype(np.int32),
                n_bins - 1,
            )
            counts = np.bincount(b, minlength=n_bins)
            bin_min = np.full((n_bins, 3), np.inf, np.float32)
            bin_max = np.full((n_bins, 3), -np.inf, np.float32)
            for k in range(3):
                np.minimum.at(bin_min[:, k], b, bmin[sel][:, k])
                np.maximum.at(bin_max[:, k], b, bmax[sel][:, k])
            pre_min = np.minimum.accumulate(bin_min, axis=0)
            pre_max = np.maximum.accumulate(bin_max, axis=0)
            suf_min = np.minimum.accumulate(bin_min[::-1], axis=0)[::-1]
            suf_max = np.maximum.accumulate(bin_max[::-1], axis=0)[::-1]
            n_l = np.cumsum(counts)[:-1]
            n_r = (hi - lo) - n_l
            cost = (
                areas(pre_min, pre_max)[:-1] * n_l
                + areas(suf_min, suf_max)[1:] * n_r
            )
            valid = (n_l > 0) & (n_r > 0)
            if valid.any():
                split_bin = int(np.argmin(np.where(valid, cost, np.inf)))
                left = b <= split_bin
                mid = lo + int(left.sum())
                # Near-side-first partition (stable keeps spatial order).
                order[lo:hi] = np.concatenate([sel[left], sel[~left]])
        if mid is None:
            # Median split: all centroids in one bin, or past MAX_SAH_DEPTH.
            order[lo:hi] = sel[np.argsort(c[:, axis], kind="stable")]
            mid = lo + (hi - lo) // 2
        leaf_chunk[my] = -1 - axis
        emit(lo, mid, depth + 1)
        emit(mid, hi, depth + 1)
        skip[my] = len(nbox)

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 100_000))
    try:
        emit(0, ids.shape[0])
    finally:
        sys.setrecursionlimit(old_limit)

    slot_tri = np.full((len(leaves) * leaf_size,), -1, np.int32)
    for c, tri in enumerate(leaves):
        slot_tri[c * leaf_size : c * leaf_size + tri.shape[0]] = tri
    return BVHTopology(
        nbox=np.asarray(nbox, np.float32),
        leaf_chunk=np.asarray(leaf_chunk, np.int32),
        skip=np.asarray(skip, np.int32),
        slot_tri=slot_tri,
        leaf_size=leaf_size,
    )


def slot_boxes(slot_tri: torch.Tensor, tri_min: torch.Tensor, tri_max: torch.Tensor):
    """The triangle boxes ``tri_min``/``tri_max`` (3, T) in slot order, (3, S)
    each, inverted on padding slots (``slot_tri`` -1)."""
    filled = slot_tri >= 0
    tri = slot_tri.clamp(min=0).long()
    return (torch.where(filled, tri_min[:, tri], _BIG_BOX),
            torch.where(filled, tri_max[:, tri], -_BIG_BOX))


def leaf_blocks(lo: torch.Tensor, hi: torch.Tensor, leaf_size: int) -> torch.Tensor:
    """(C, ceil(leaf_size / BLOCK), 6) AABBs [min xyz, max xyz] of each
    leaf's runs of BLOCK slots, from the slots' boxes ``lo``/``hi`` (3,
    C * leaf_size; inverted where a slot is empty): a run of empty slots,
    or past the leaf's end, gets an inverted box, which no ray enters."""
    c = lo.shape[1] // leaf_size
    nb = -(-leaf_size // BLOCK)

    def runs(x, fill, reduce):
        x = torch.nn.functional.pad(x.reshape(3, c, leaf_size), (0, nb * BLOCK - leaf_size),
                                    value=fill)
        return reduce(x.reshape(3, c, nb, BLOCK), dim=3)

    lo, hi = runs(lo, _BIG_BOX, torch.amin), runs(hi, -_BIG_BOX, torch.amax)
    return torch.cat([lo, hi]).permute(1, 2, 0).contiguous()


@dataclasses.dataclass
class BVH:
    """The binary BVH as the traversal kernels read it.

    ``nbox`` (N * 6,) f32 node AABBs; ``meta`` (N * 2,) i32 interleaving per
    node (leaf chunk, or ``-1 - axis`` inside; skip pointer).  Preorder makes
    a node's left child ``i + 1`` and its right child ``skip[i + 1]``.  ``w``
    (C, 4, 3 Tc) f32 leaf chunks in the flat-chunk layout (raw Woop rows, no
    anchor; padding slots all zero, so never hit); ``slot_tri`` (C * Tc,)
    i32 maps slots to triangle ids (-1 padding).  ``max_stack`` is the
    deepest stack a near-first walk can need: the tree's depth.
    ``blocks`` (C, ceil(Tc / BLOCK), 6) f32: the world-space AABBs of each
    leaf's runs of BLOCK slots (``leaf_blocks``), which K6a culls by (it
    raises on a tree without them); ``wanchor`` (3, C) f32 zeros: the leaf
    anchors of K6a's leaf service, which re-centres each ray on its leaf's
    anchor (the rows are raw, so the anchor is 0 and t that of the raw rows).
    """

    nbox: torch.Tensor
    meta: torch.Tensor
    w: torch.Tensor
    slot_tri: torch.Tensor
    leaf_size: int
    num_triangles: int
    max_stack: int
    blocks: torch.Tensor | None
    wanchor: torch.Tensor

    @property
    def num_nodes(self) -> int:
        return self.nbox.shape[0] // 6

    @property
    def num_chunks(self) -> int:
        return self.w.shape[0]

    def to(self, device) -> "BVH":
        return dataclasses.replace(
            self,
            **{
                f.name: getattr(self, f.name).to(device)
                for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)
            },
        )


def tree_depth(topo: BVHTopology) -> int:
    """Edges on the longest root-to-leaf path of a preorder topology."""
    depth = np.zeros(topo.num_nodes, np.int64)
    for i in range(topo.num_nodes):  # a parent precedes its children
        if topo.leaf_chunk[i] < 0:
            depth[i + 1] = depth[topo.skip[i + 1]] = depth[i] + 1
    return int(depth.max())


def pack_bvh(accel: WoopAccel, topo: BVHTopology) -> BVH:
    """Gather the accel's Woop rows into the topology's chunk slots, on the
    host, and place the result on ``accel``'s device, with the block boxes
    of the accel's triangle boxes (emptied ones, +-3e38, count as padding)."""
    tc, c = topo.leaf_size, topo.num_chunks
    valid = (topo.slot_tri >= 0).astype(np.float32)
    safe = np.maximum(topo.slot_tri, 0)
    w = np.take(accel.w.cpu().numpy(), safe, axis=1) * valid[None, :]
    w = w.reshape(12, c, tc).transpose(1, 0, 2)
    w = w.reshape(c, 3, 4, tc).transpose(0, 2, 1, 3).reshape(c, 4, 3 * tc)
    meta = np.stack([topo.leaf_chunk, topo.skip], axis=1).reshape(-1)
    dev = accel.w.device
    slot_tri = torch.from_numpy(topo.slot_tri).to(dev)
    return BVH(
        nbox=torch.from_numpy(topo.nbox.reshape(-1).copy()).to(dev),
        meta=torch.from_numpy(meta.astype(np.int32)).to(dev),
        w=torch.from_numpy(np.ascontiguousarray(w)).to(dev),
        slot_tri=slot_tri,
        leaf_size=tc,
        num_triangles=accel.num_triangles,
        max_stack=tree_depth(topo),
        blocks=leaf_blocks(*slot_boxes(slot_tri, accel.tri_min, accel.tri_max), tc),
        wanchor=torch.zeros((3, c), dtype=torch.float32, device=dev),
    )


def build_bvh(accel: WoopAccel, leaf_size: int = 64, include: np.ndarray | None = None) -> BVH:
    """Topology and packing in one call (host build).  ``include`` (T,) bool
    keeps only those triangles (the occluder-only tree)."""
    topo = build_topology(
        accel.tri_min.cpu().numpy(), accel.tri_max.cpu().numpy(),
        leaf_size=leaf_size, include=include,
    )
    return pack_bvh(accel, topo)


def traverse_closest_numpy(topo: BVHTopology, woop_w: np.ndarray, o, d, t_min=1e-4):
    """Scalar skip-pointer walk of ONE ray (numpy, test oracle) over exact
    boxes: (t, triangle id).  ``woop_w`` (12, T) Woop rows; ``o``/``d`` (3,)."""
    inv = np.where(d < 0, -1.0, 1.0) / np.maximum(np.abs(d), 1e-18)
    best_t, best_id = 3.0e38, -1
    i, tc = 0, topo.leaf_size
    while i < topo.num_nodes:
        box = topo.nbox[i]
        t0 = (box[:3] - o) * inv
        t1 = (box[3:] - o) * inv
        tn = max(np.minimum(t0, t1).max(), t_min)
        tf = min(np.maximum(t0, t1).min(), best_t)
        if tn > tf:
            i = int(topo.skip[i])
            continue
        chunk = topo.leaf_chunk[i]
        for tri in topo.slot_tri[chunk * tc:(chunk + 1) * tc] if chunk >= 0 else ():
            if tri < 0:
                continue
            w = woop_w[:, tri]
            dz = w[8] * d[0] + w[9] * d[1] + w[10] * d[2]
            if abs(dz) <= 1e-15:
                continue
            t = -(w[8] * o[0] + w[9] * o[1] + w[10] * o[2] + w[11]) / dz
            if not t_min < t < best_t:
                continue
            p = o + t * d
            b1 = w[0] * p[0] + w[1] * p[1] + w[2] * p[2] + w[3]
            b2 = w[4] * p[0] + w[5] * p[1] + w[6] * p[2] + w[7]
            if b1 >= -1e-6 and b2 >= -1e-6 and b1 + b2 <= 1.0 + 1e-6:
                best_t, best_id = t, int(tri)
        i += 1
    return best_t, best_id
