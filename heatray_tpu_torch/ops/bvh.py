"""Binned-SAH binary BVH topology over triangle AABBs (host, numpy).

Port of the numpy path of ``heatray_tpu.ops.bvh.build_topology``: the tree
is flattened in DFS preorder with skip pointers, and leaves are fixed-size
triangle chunks (``leaf_size`` slots, padded with -1).  The wide builder
(``wide_bvh.py``) collapses it into arity-8 nodes.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np

# Past this depth the builder forces median splits, which bounds the tree
# depth (and the traversal stack) by MAX_SAH_DEPTH + log2(T).
MAX_SAH_DEPTH = 48


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
    """Binned-SAH build over triangle AABBs ``tri_min``/``tri_max`` (3, T).

    ``include``: optional (T,) bool; only these triangles enter the tree.
    """
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
