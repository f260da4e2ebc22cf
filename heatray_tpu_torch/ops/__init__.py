"""Intersection: Woop rows, brute-force queries, the wide BVH and its kernels."""
