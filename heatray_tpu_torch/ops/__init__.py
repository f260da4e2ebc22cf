"""Intersection: Woop rows, brute-force queries, the wide BVH and its kernels."""

from .intersect import (
    MISS_T,
    WoopAccel,
    build_woop,
    hit_attributes,
    intersect_any,
    intersect_closest,
)

__all__ = [
    "MISS_T",
    "WoopAccel",
    "build_woop",
    "hit_attributes",
    "intersect_any",
    "intersect_closest",
]
