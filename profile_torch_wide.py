#!/usr/bin/env python3
"""K1/K2 (``heatray_tpu_torch/csrc/wide_bvh.cu``), K5a/K5b and K4a/K4b
(``csrc/wide_bvh_t.cu``), K6a/K6b (``csrc/bvh2.cu``), K7a/K7b
(``csrc/chunks.cu``), the brute-force probe kernels, P1's grid and nodes
and P3 (``csrc/probes.cu``) and P2's walks (``csrc/variants.cu``
``variant_walk_kernel`` and ``queue_walk_kernel``) beside variants of their
design, on the 1080p launches of the Cornell box (K1, K5, K6, K7, the
probes) and of ``high_poly`` (K4) on an NVIDIA card.

Run from the root of a checkout, on a machine with one card:

    python3 profile_torch_wide.py
        [--kernels k1,k4,k5,k6,k7,brute,walk,queue,grid,stats,nodes] [--parent DIR]

Each variant is a copy of ``heatray_tpu_torch/csrc/`` with the text edits
of ``VARIANTS`` (K1/K2), ``K4_VARIANTS`` (K4a/K4b), ``T_VARIANTS`` (K5a and
K5b), ``K6_VARIANTS`` (K6a/K6b), ``CHUNK_VARIANTS`` (K7a/K7b),
``BRUTE_VARIANTS`` (``rows_brute_kernel``) and ``WARP_VARIANTS``
(``warp_brute_kernel``; both family ``brute``), ``WALK_VARIANTS``
(``variant_walk_kernel``, family ``walk``), ``QUEUE_VARIANTS``
(``queue_walk_kernel``, family ``queue``), ``GRID_VARIANTS``
(``empty_kernel``, family ``grid``), ``STATS_VARIANTS``
(``visit_stats_kernel``, family ``stats``) or ``NODES_VARIANTS``
(``nodes_kernel``, family ``nodes``) applied, built with the
package's nvcc flags into ``build/wide_variants/`` (one nvcc each, all
started together).  ``--parent DIR`` adds the ``wide_bvh.cu``,
``wide_bvh_t.cu``, ``bvh2.cu``, ``chunks.cu``, ``probes.cu`` and
``variants.cu`` of another tree as they stand (for example an unpacked
parent commit), as the variant ``parent``, and compares the SASS of each
kernel of ``wide_bvh.cu``, ``wide_bvh_stream.cu``, ``wide_bvh_t.cu``,
``bvh2.cu``, ``chunks.cu``, ``probes.cu`` and ``variants.cu`` with this
tree's (``cuobjdump``; P2's kernels one per template instance).  The launches
are those of a pass at depth 2, sorted and gated as on the card: the
closest-hit kernels on the primary rays and on the sorted depth-2 head, the
occlusion kernels on their shadow lanes; K1/K2 over the Cornell box's trees
at leaf 32, 64 and 128, K5 over its leaf-128 trees (Route A's), K6 over
its ``"bvh"`` context's binary trees (leaf 64), K7 over the rebuild mode's
chunk packs, K4a/K4b over ``high_poly``'s leaf-128 tree (the ``"stream"``
context's, which Route B builds alike); the brute force (P1 ``leaves``, P4
row, P4 warp) on the Cornell box's primary rays of ``chip_smoke.py``
phase 17, over the leaf-32 and leaf-128 trees' anchored chunks (P1) and
the packs of 128 and 512 (P4); P2a's cases (v0-v3, v4 at groups 32 and
128, tiles 512 and 1024) and P2b-d's (v6 and v7 at batch 4 and 8, v8 at 8
and 16, tiles 512, 1024 and 2048) on phase 19's sorted depth-2 wavefront
over the leaf-32 tree; P1's grid on the x plane of phase 17's rays; P3 on
phase 16's wavefronts at 1080p (the Cornell box's depths 1-4 over its
leaf-32 tree, ``high_poly``'s depths 1-2 over its leaf-128 tree, plain and
seeded); P1's nodes beside K1 on the Cornell box's primary rays and sorted
depth-2 head at leaf 32.  It prints, one reading per line:

- the card's name and power limit, as ``nvidia-smi`` gives them;
- ``[build]``: each variant's registers, spill bytes and static shared
  bytes per kernel;
- ``[check]``: each variant's results against the shipped kernel's on every
  launch it runs (t, slot or id, and blocked, bit for bit); a variant of
  this tree must equal it, the parent's count of differing lanes is
  printed (the brute force's parent ``rows_brute_kernel`` must equal it
  too; both layouts of every build are held to the shipped
  ``rows_brute_kernel``); for K4, K5b, K6 and the brute force, each
  variant against the plain version too, on ``chip_smoke.N_CHECK`` seeded
  lanes of each launch (the brute force within ``chip_smoke.TOL``); P2a's
  t, slot and tests per tile of every build against the parent's (or,
  without one, the shipped kernel's), all of which must be equal, and so
  P2b-d's (``walk-only`` excepted, which is timed only); P1 grid's output
  of every build and of ``torch.mul`` equal to x * 0 bit for bit on the
  rays, an unaligned view, 1, 3 and 8,191 floats and the special values;
  P3's four counts and work counts of every tile, every build, equal to
  the parent's (``every-ray``'s counts only); P1 nodes' t (MISS_T) and
  visits of every ray equal to the parent's (``known-hit``: t equal to
  K1's, visits at most the shipped walk's);
- ``[time]``: ms per launch over 10 launches, each library timed in turn,
  in order and then in reverse, min/max of the two: K1/K2 for every variant
  over the leaf-32 tree, and ``shipped``, ``warp`` and the parent over the
  trees at leaf 64 and 128 too; K5a for each of its variants, K5b for the
  shipped kernel, ``leaves``, ``uncapped`` and the parent; K6a and K6b for
  each of their variants on their two launches each; K4a and K4b for each
  of theirs on the four launches; K7a for each of ``CHUNK_VARIANTS`` and
  K7b for those of ``K7B_VARIANTS``; ``rows_brute_kernel`` for each of
  ``BRUTE_VARIANTS`` and the parent at each brute-force setting and
  ``warp_brute_kernel`` for each of ``WARP_VARIANTS``, the shipped build
  and the parent at P4's, each beside its share of the operation bound;
  ``variant_walk_kernel`` for each of ``WALK_VARIANTS`` and the parent at
  each case, with K1 on the same rays; ``queue_walk_kernel`` for each of
  ``QUEUE_VARIANTS`` and the parent at each case, beside each case's own
  work bound, with v0 and K1 on the same rays; ``empty_kernel`` for each
  of ``GRID_VARIANTS``, the parent and ``torch.mul``, device ms a call at
  tiles 256, 512 and 1024 from a graph of 10 calls on one input (L2; into
  one output, or each into a new one) and of 16 over 8 inputs and outputs
  (past the L2), beside the bytes bound; ``visit_stats_kernel`` for each of
  ``STATS_VARIANTS`` and the parent on every wavefront, beside its bound
  from its work counts (``[work]``); ``nodes_kernel`` for each of
  ``NODES_VARIANTS`` and the parent, with K1, on K1's two launches;
- ``[work]``: each P3 wavefront's visits per tile, overlap share and work
  counts, and the bound they make; ``[bound]``: the node walk's bound on
  each of K1's two launches, with no far end and culled by K1's hits;
- ``[split]``: K1's time on each of those launches split by the ``nodes``
  family: K1 less ``known-hit`` (the leaf service), the shipped walk less
  ``known-hit`` (what a known hit's cull saves), the shipped walk less
  ``smem-rows`` (the node loads' latency);
- ``[geometry]``: the grid and block of ``torch.mul(x, 0.0)``'s kernel and
  of ``empty_kernel``'s (shipped, parent), from the profiler's trace;
- ``[groups]``: at each leaf size and launch, the groups of rays that K1/K2's
  leaf service meets (one per warp, offered leaf and round; the ``count``
  variant): their number, mean rays per group, and the share of groups, and
  of (ray, leaf) pairs, in groups of more than 16 and than ``kLaneRays``
  rays;
- ``[pairs]``: on each K7a launch, the pair tests K7a makes (its (ray,
  block) services times the block's 32 columns; the ``count`` variant)
  against those of ``chip_smoke.chunk_work`` (every block a ray enters, in
  every chunk it enters, before its hit) and those of whole chunks, and the
  groups served ray per lane and one ray at a time;
- ``[sass]``: with ``--parent``, for each kernel, whether its SASS equals
  the parent's instruction for instruction, or how many of its
  instructions differ; and the SASS length of each brute-force variant's
  ``rows_brute_kernel`` and ``warp_brute_kernel``, and of each walk and
  queue variant's ``variant_walk_kernel`` or ``queue_walk_kernel``
  instances.

It imports no jax.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import difflib
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent
FAMILIES = ("k1", "k4", "k5", "k6", "k7", "brute", "walk", "queue", "grid", "stats", "nodes")
CSRC = REPO / "heatray_tpu_torch" / "csrc"
OUT = REPO / "build" / "wide_variants"
WIDTH, HEIGHT = 1920, 1080
LEAVES = (32, 64, 128)
WIDE_LEAF_VARIANTS = ("shipped", "warp", "parent")

_COMMON = "wide_bvh_common.cuh"
_K1 = "wide_bvh.cu"
_K3 = "wide_bvh_stream.cu"
_K5 = "wide_bvh_t.cu"
_K6 = "bvh2.cu"
_K7 = "chunks.cu"
_PROBES = "probes.cu"
_WALK = "variants.cu"
_WALK_LOOP = "wide_bvh_walk.cuh"
# A ray-per-lane branch for large groups in the any-hit block service of K2
# and K7b (`serve_cols_any`), as K1's closest-hit service has.
_ANY_LANES = """  if (__popc(rays) > kLaneRays) {
    const bool mine = (rays >> lane) & 1u;
    for (int j = 0; j < 32; ++j) {
      const TriCols col_j = shfl_cols(cols, j);
      const bool has_j = __shfl_sync(kFullMask, has_col, j);
      if (mine && !hit && has_j && tri_t(col_j, a.ox, a.oy, a.oz, a, t_min, t_max) < kMissT) {
        hit = true;
      }
    }
    return;
  }
"""
_ANY_LOOP = """  for (; rays; rays &= rays - 1) {
    const int src = __ffs(static_cast<int>(rays)) - 1;
    const Ray q = shfl_ray(a, src);
    const float q_max"""
_COUNT_READ = """
extern "C" int lane_groups_read(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, lane_groups, sizeof(lane_groups)));
}

extern "C" int lane_groups_clear() {
  static const unsigned long long zero[33] = {};
  return static_cast<int>(cudaMemcpyToSymbol(lane_groups, zero, sizeof(zero)));
}
"""


def lane_rays() -> int:
    """kLaneRays as shipped: groups of more rays test ray per lane (K1/K2
    and K7a alike)."""
    return int(re.search(r"constexpr int kLaneRays = (\d+);",
                         (CSRC / _COMMON).read_text()).group(1))


def _lane_rays(n: int, what: str):
    return what, [(_COMMON, re.compile(r"constexpr int kLaneRays = \d+;"),
                   f"constexpr int kLaneRays = {n};")]


# The block service given the chunk's rows (`W`), for the variants that
# read the columns instead of shuffling them.
_ROWS = [
    (_COMMON, "__device__ __forceinline__ void serve_cols_closest(const TriCols& cols,",
     "__device__ __forceinline__ void serve_cols_closest(const float* __restrict__ W, int tc,\n"
     "                                                   int j0, const TriCols& cols,"),
    (_COMMON, "\n    serve_cols_closest(cols, min(tc - j0, 32),",
     "\n    serve_cols_closest(w + (size_t)c * 12 * tc, tc, j0, cols, min(tc - j0, 32),"),
    (_COMMON, "\n      serve_cols_closest(cols, min(tc - j0, 32),",
     "\n      serve_cols_closest(W, tc, j0, cols, min(tc - j0, 32),"),
    (_K7, "  serve_cols_closest(cols, n,", "  serve_cols_closest(W, tc, j0, cols, n,"),
]
_LOAD = _ROWS + [(_COMMON, "      const TriCols col_j = shfl_cols(cols, j);",
                  "      const TriCols col_j = load_cols(W, tc, j0 + j);")]


# name -> (what it changes, [(file, text or pattern, replacement)]).  Each
# text or pattern must occur once in its file.
VARIANTS = {
    "shipped": ("the kernels as shipped", []),
    "warp": ("K3's leaf service (the leaf's triangles across the lanes, one ray at a time)", [
        (_K1, "closest_walk<LaneServe>", "closest_walk<WarpServe>"),
        (_K1, "any_walk<LaneServe>", "any_walk<WarpServe>"),
    ]),
    **{f"rays-{n}": _lane_rays(n, f"ray per lane above {n} rays a group")
       for n in (8, 16, 20, 28)},
    "rays-none": _lane_rays(32, "no ray-per-lane branch: every group one ray at a time"),
    "uncapped": ("no register cap (__launch_bounds__ with 1 block per SM)", [
        (_K1, "constexpr int kMinBlocks = 8;", "constexpr int kMinBlocks = 1;"),
    ]),
    "load": ("ray per lane reads each column from memory instead of shuffles", _LOAD),
    "any-lanes": ("K2 with K1's ray-per-lane branch for large groups", [
        (_COMMON, _ANY_LOOP, _ANY_LANES + _ANY_LOOP),
    ]),
    "count": ("the shipped kernels, counting groups by their size", [
        (_COMMON, "template <class Test>\n__device__ __forceinline__ void lane_serve(",
         "__device__ unsigned long long lane_groups[33];\n\n"
         "template <class Test>\n__device__ __forceinline__ void lane_serve("),
        (_COMMON, "    want &= ~rays;\n",
         "    want &= ~rays;\n    if (lane == lead) atomicAdd(&lane_groups[__popc(rays)], 1ull);\n"),
        (_K1, "extern \"C\" int wide_bvh_stack_depth()",
         _COUNT_READ.lstrip() + "\nextern \"C\" int wide_bvh_stack_depth()"),
    ]),
}

def _in_kernel(kernel: str, text: str, new: str):
    """An edit of the first ``text`` after the definition of ``kernel`` (K5a
    and K4a share their body's text): (pattern, replacement)."""
    pattern = re.compile(re.escape(f"{kernel}(") + ".*?" + re.escape(text), re.S)
    return pattern, lambda m: m.group(0)[:-len(text)] + new


def _k5_serve(serve: str, kernel: str = "closest_wide_t_kernel"):
    """K5a's walk (or K4a's) with another leaf service, which takes no block
    boxes."""
    return [(_K5, *_in_kernel(kernel, "closest_walk<BlockServe>(", f"closest_walk<{serve}>(")),
            (_K5, *_in_kernel(kernel, "t_out, slot_out, blocks, widen);", "t_out, slot_out);"))]


# K5a and K5b: name -> (what it changes, [(file, text, replacement)]), as
# VARIANTS; K5b runs in "shipped", "leaves", "uncapped" and the parent.
T_VARIANTS = {
    "shipped": ("K5a and K5b as shipped", []),
    "leaves": ("no block boxes: K1/K2's lane service over whole leaves of 128",
               _k5_serve("LaneServe") + [
                   (_K5, *_in_kernel("any_wide_t_kernel", "any_walk<BlockServe>(",
                                     "any_walk<LaneServe>(")),
                   (_K5, *_in_kernel("any_wide_t_kernel", "blocked_out, blocks, widen);",
                                     "blocked_out);"))]),
    "warp": ("K5a: K3's warp service over whole leaves of 128", _k5_serve("WarpServe")),
    "uncapped": ("no register cap (__launch_bounds__ with 1 block per SM)", [
        (_K5, "constexpr int kMinBlocks = 8;", "constexpr int kMinBlocks = 1;"),
    ]),
}

# K4a/K4b: name -> (what it changes, [(file, text, replacement)]), as
# VARIANTS.
K4_VARIANTS = {
    "shipped": ("K4a and K4b as shipped", []),
    "leaves": ("no block boxes: K1/K2's lane service over whole leaves of 128",
               _k5_serve("LaneServe", "closest_stream_t_kernel") + [
                   (_K5, *_in_kernel("any_stream_t_kernel", "any_walk<BlockServe>(",
                                     "any_walk<LaneServe>(")),
                   (_K5, *_in_kernel("any_stream_t_kernel", "blocked_out, blocks, widen);",
                                     "blocked_out);"))]),
    "uncapped": ("no register cap (__launch_bounds__ with 1 block per SM)", [
        (_K5, "constexpr int kMinBlocks = 8;", "constexpr int kMinBlocks = 1;"),
    ]),
}

# K6a and K6b: name -> (what it changes, [(file, text, replacement)]), as
# VARIANTS.
K6_VARIANTS = {
    "shipped": ("K6a and K6b as shipped", []),
    "leaves": ("no block boxes: K1's and K2's lane services over whole leaves", [
        (_K6, "    lane_serve_blocks_closest(chunk, w, tc, wanchor, n_chunks, blocks, r, t_min, "
              "widen, best,\n                              best_slot);",
         "    lane_serve_closest(chunk, w, tc, wanchor, n_chunks, r, t_min, best, best_slot);"),
        (_K6, "if (lane_serve_blocks_any(chunk, w, tc, wanchor, n_chunks, blocks, r, t_min, t_hi, "
              "widen)) {",
         "if (lane_serve_any(chunk, w, tc, wanchor, n_chunks, r, t_min, t_hi)) {"),
    ]),
    **{f"visits-{n}": (f"{n} node visits a round for a lane with no leaf to offer", [
        (_K6, "constexpr int kVisits = 1;", f"constexpr int kVisits = {n};"),
    ]) for n in (2, 4)},
}

# K7a's ray-per-lane branch reading 4 columns' rows at once (16-byte reads
# of the same address on every lane) instead of shuffling them.
_LOAD16 = """    for (int j = 0; mine && j < n; j += 4) {  // Tc a multiple of 4
      float4 v[3][4];
      for (int g = 0; g < 3; ++g) {
        for (int f = 0; f < 4; ++f) {
          v[g][f] = __ldg(reinterpret_cast<const float4*>(W + f * 3 * tc + g * tc + j0 + j));
        }
      }
      for (int q = 0; q < 4; ++q) {
        TriCols col_j;
        for (int g = 0; g < 3; ++g) {
          for (int f = 0; f < 4; ++f) col_j.c[g][f] = reinterpret_cast<const float*>(&v[g][f])[q];
        }
        keep_closest(tri_t(col_j, a.ox, a.oy, a.oz, a, t_min, t_lim), base + j + q, best,
                     best_slot);
      }
    }
"""
_SHUFFLED = """    for (int j = 0; j < n; ++j) {
      const TriCols col_j = shfl_cols(cols, j);
      if (mine) keep_closest(tri_t(col_j, a.ox, a.oy, a.oz, a, t_min, t_lim), base + j, best,
                             best_slot);
    }
"""
# K7b in K7a's order: each batch of 32 chunks sorted by the warp's least
# entry into each over its unblocked lanes that enter it before their t_max.
_K7B_NEAREST = [
    (_K7, """  bool blocked = false;
  for (int c = 0; c < n_chunks; ++c) {
    const bool open = valid && !blocked;  // a blocked ray enters nothing more
    if (!__any_sync(kFullMask, open)) break;  // every ray of the warp is blocked
""", """  bool blocked = false;
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < n_chunks; base += 32) {
  if (!__any_sync(kFullMask, valid && !blocked)) break;
  const int n = min(32, n_chunks - base);
  unsigned key = kNoEntry;
  for (int k = 0; k < n; ++k) {
    const float* box = boxes + 6 * (base + k);
    const bool in = valid && !blocked && enters(box, r, t_min, t_hi, widen);
    const unsigned near =
        __reduce_min_sync(kFullMask, in ? order_key(entry_t(box, r, t_min)) : kNoEntry);
    if (lane == k && near != kNoEntry) key = (near & ~31u) | k;
  }
  key = warp_sort(key);
  for (int k = 0; k < n; ++k) {
    const unsigned next = __shfl_sync(kFullMask, key, k);
    if (next == kNoEntry) break;
    const int c = base + static_cast<int>(next & 31u);
    const bool open = valid && !blocked;
    if (!__any_sync(kFullMask, open)) break;
"""),
    (_K7, "    }\n  }\n  if (valid) blocked_out[i] = blocked ? 1 : 0;",
     "    }\n  }\n  }\n  if (valid) blocked_out[i] = blocked ? 1 : 0;"),
]
# K7b's block read, and the same block staged as K7a stages it.
_K7B_LOAD = "  TriCols cols = {};\n  if (lane < n) cols = load_cols(W, tc, j0 + lane);\n"
_K7B_STAGED = """  __shared__ float4 staged_any[kChunkThreads / 32][12][kBlock / 4];
  TriCols cols = {};
  if (n == kBlock && tc % 4 == 0) {
    float4(*rows)[kBlock / 4] = staged_any[threadIdx.x / 32];
    for (int p = lane; p < 12 * kBlock / 4; p += 32) {
      const int row = p / (kBlock / 4), q = p % (kBlock / 4);
      __pipeline_memcpy_async(&rows[row][q], W + (row % 4) * 3 * tc + (row / 4) * tc + j0 + 4 * q,
                              16);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncwarp();
    const float* col = reinterpret_cast<const float*>(rows);
    for (int g = 0; g < 3; ++g) {
      for (int f = 0; f < 4; ++f) cols.c[g][f] = col[(4 * g + f) * kBlock + lane];
    }
    __syncwarp();
  } else if (lane < n) {
    cols = load_cols(W, tc, j0 + lane);
  }
"""
# K7b's block service with a ray-per-lane branch for large groups, as K1's
# and K7a's closest-hit service has.
_K7B_LANES = """  if (__popc(rays) > kLaneRays) {
    const bool mine = (rays >> lane) & 1u;
    for (int j = 0; j < n; ++j) {
      const TriCols col_j = shfl_cols(cols, j);
      if (mine && !hit && tri_t(col_j, r.ox, r.oy, r.oz, r, t_min, t_max) < kMissT) hit = true;
    }
    return;
  }
  serve_cols_any(cols, lane < n, rays, r, t_min, t_max, hit);
"""
# The variants that time K7b: its own and the parent.
K7B_VARIANTS = ("shipped", "nearest", "any-staged", "any-lanes", "any-chunks", "parent")
_CHUNK_COUNT_READ = """
extern "C" int chunk_counts_read(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, chunk_counts, sizeof(chunk_counts)));
}

extern "C" int chunk_counts_clear() {
  static const unsigned long long zero[4] = {};
  return static_cast<int>(cudaMemcpyToSymbol(chunk_counts, zero, sizeof(zero)));
}
"""
# K7a: name -> (what it changes, [(file, text, replacement)]), as VARIANTS.
CHUNK_VARIANTS = {
    "shipped": ("K7a as shipped", []),
    "index": ("chunks in index order, not nearest entry first", [
        (_K7, "    key = warp_sort(key);\n", ""),
        (_K7, "if (next == kNoEntry) break;  // sorted: no later chunk is entered either",
         "if (next == kNoEntry) continue;"),
    ]),
    "chunks": ("no block boxes: every block of a chunk served to each lane that enters it", [
        (_K7, "const bool in = mine && enters(block_box + 6 * b, r, t_min, best, widen);",
         "const bool in = mine;"),
    ]),
    "load": ("ray per lane reads each column (4 bytes, one address) instead of shuffles",
             _LOAD),
    "load16": ("ray per lane reads 4 columns' rows at once (16 bytes) instead of shuffles",
               _ROWS + [(_COMMON, _SHUFFLED, _LOAD16)]),
    **{f"rays-{n}": _lane_rays(n, f"ray per lane above {n} rays a group") for n in (8, 16)},
    "rays-none": _lane_rays(32, "no ray-per-lane branch: every group one ray at a time"),
    "l2": ("each lane reads its column of a block from L1/L2, not staged in shared memory", [
        (_K7, "  if (n == kBlock && tc % 4 == 0) {  // staged", "  if (false) {  // staged"),
    ]),
    "nearest": ("K7b: the chunks of each batch of 32 nearest entry first (K7a's order)",
                _K7B_NEAREST),
    "any-chunks": ("K7b without block boxes: every block of an entered chunk served", [
        (_K7, "&& !blocked && enters(block_box + 6 * b, r, t_min, t_hi, widen);", "&& !blocked;"),
    ]),
    "any-staged": ("K7b: each block staged in shared memory by cp.async, as K7a's",
                   [(_K7, _K7B_LOAD, _K7B_STAGED)]),
    "any-lanes": ("K7b: groups of more than kLaneRays rays tested ray per lane", [
        (_K7, "  serve_cols_any(cols, lane < n, rays, r, t_min, t_max, hit);\n", _K7B_LANES),
    ]),
    "count": ("the shipped kernel, counting its (ray, block) services", [
        (_K7, "// The block of columns j0 .. j0 + 31 of chunk `W` (ids",
         "__device__ unsigned long long chunk_counts[4];\n\n"
         "// The block of columns j0 .. j0 + 31 of chunk `W` (ids"),
        (_K7, "  const int lane = threadIdx.x & 31;\n  const int n = min(tc - j0, kBlock);\n"
              "  TriCols cols = {};\n  if (n == kBlock",
         "  const int lane = threadIdx.x & 31;\n  const int n = min(tc - j0, kBlock);\n"
         "  if (lane == __ffs(static_cast<int>(rays)) - 1) {\n"
         "    const bool big = __popc(rays) > kLaneRays;\n"
         "    atomicAdd(&chunk_counts[0], static_cast<unsigned long long>(__popc(rays)));\n"
         "    atomicAdd(&chunk_counts[big ? 1 : 2], 1ull);\n"
         "    if (big) {\n"
         "      atomicAdd(&chunk_counts[3], static_cast<unsigned long long>(__popc(rays)));\n"
         "    }\n"
         "  }\n  TriCols cols = {};\n  if (n == kBlock"),
        (_K7, "extern \"C\" int closest_chunks(",
         _CHUNK_COUNT_READ.lstrip() + "\nextern \"C\" int closest_chunks("),
    ]),
}

# rows_brute_kernel's barycentrics behind one branch a column, and
# without it.
_SKIP = "        if (!any) continue;\n"
# rows_brute_kernel's column loop, and the same with the whole of woop_t
# for each ray, its range test as its early return (the kernel's first
# form).
_COLUMN_LOOP = """        const float4 s = col[2];
        float t[kRowRays];
        bool in[kRowRays];
        bool any = false;
#pragma unroll
        for (int q = 0; q < kRowRays; ++q) {
          t[q] = plane_t(s, ax[q], ay[q], az[q], r[q]);
          in[q] = (t[q] > t_min) & (t[q] < best[q]);
          any |= in[q];
        }
        if (!any) continue;
        const float4 u = col[0], v = col[1];
#pragma unroll
        for (int q = 0; q < kRowRays; ++q) {
          const float hit = inside_t(u, v, t[q], ax[q], ay[q], az[q], r[q]);
          if (in[q]) best[q] = fminf(best[q], hit);
        }"""
_COLUMN_WOOP = """#pragma unroll
        for (int q = 0; q < kRowRays; ++q) {
          best[q] = fminf(best[q], woop_t([&](int f, int g) {
            const float4 c = col[g];
            return f == 0 ? c.x : (f == 1 ? c.y : (f == 2 ? c.z : c.w));
          }, ax[q], ay[q], az[q], r[q], t_min, best[q]));
        }"""
_MIN_2 = (_PROBES, "__launch_bounds__(1024 / kRowRays)", "__launch_bounds__(1024 / kRowRays, 2)")
# rows_brute_kernel's re-centring of its rays on a chunk's anchor, and the
# same from origins read again from device memory (a ray past the end takes
# the last ray's origin: its direction is 0, so its t is never in range).
_CENTRE = """        ax[q] = r[q].ox - cx;
        ay[q] = r[q].oy - cy;
        az[q] = r[q].oz - cz;"""
_RELOAD = """        const int i = min(first + q * static_cast<int>(blockDim.x), n_rays - 1);
        ax[q] = ox[i] - cx;
        ay[q] = oy[i] - cy;
        az[q] = oz[i] - cz;"""

# rows_brute_kernel (P1 "leaves", P4 row): name -> (what it changes, [(file,
# text, replacement)]), as VARIANTS.
BRUTE_VARIANTS = {
    "shipped": ("rows_brute_kernel as shipped: 4 rays a thread, 128 columns a tile, every ray's "
                "t of a column, then its barycentrics behind one branch", []),
    "woop": ("woop_t whole for each ray, its range test an early return", [
        (_PROBES, _COLUMN_LOOP, _COLUMN_WOOP)]),
    "flat": ("every ray's barycentrics for every column: no branch but the division's", [
        (_PROBES, _SKIP, "")]),
    **{f"rays-{n}": (f"{n} rays a thread", [
        (_PROBES, "constexpr int kRowRays = 4;", f"constexpr int kRowRays = {n};"),
    ]) for n in (2, 8)},
    **{f"cols-{n}": (f"{n} columns staged a tile", [
        (_PROBES, "constexpr int kStageCols = 128;", f"constexpr int kStageCols = {n};"),
    ]) for n in (64, 256)},
    "min-2": ("__launch_bounds__ with 2 blocks an SM: up to 128 registers", [_MIN_2]),
    "reload": ("each run of a chunk's columns re-reads the origins from device memory, so "
               "that only the re-centred ones stay in registers", [(_PROBES, _CENTRE, _RELOAD)]),
}
# warp_brute_kernel (P4 warp): the same table, names with a "warp-" prefix.
# Its barycentrics behind one branch a lane, and without it.
_WARP_SKIP = "      if (any) {\n"
WARP_VARIANTS = {
    **{f"warp-cols-{n}": (f"warp_brute_kernel with {n} columns a lane ({32 * n}-column slices)", [
        (_PROBES, "constexpr int kWarpCols = 4;", f"constexpr int kWarpCols = {n};"),
    ]) for n in (2, 8)},
    **{f"warp-threads-{n}": (f"warp_brute_kernel in blocks of {n} threads", [
        (_PROBES, "constexpr int kWarpThreads = 128;", f"constexpr int kWarpThreads = {n};"),
    ]) for n in (64, 256)},
    "warp-min-6": ("warp_brute_kernel with __launch_bounds__ of 6 blocks an SM: up to 80 "
                   "registers", [
        (_PROBES, "__launch_bounds__(kWarpThreads)", "__launch_bounds__(kWarpThreads, 6)"),
    ]),
    "warp-part-64": ("warp_brute_kernel's units of 64 rays", [
        (_PROBES, "constexpr int kPartRays = 32;", "constexpr int kPartRays = 64;"),
    ]),
    "warp-flat": ("warp_brute_kernel with every lane's barycentrics for every ray: no branch", [
        (_PROBES, _WARP_SKIP, "      {\n"),
    ]),
}
# The brute-force settings timed: (probe, chunk size, ray tile); P1 over a
# Cornell tree's anchored leaves, P4 over a pack of the triangles.
# rows_brute_kernel runs them all, warp_brute_kernel P4's (it is checked at
# all four).
BRUTE_CASES = (("P1", 32, 256), ("P1", 128, 1024), ("P4", 128, 256), ("P4", 512, 512))

# variant_walk_kernel (P2a), family "walk": name -> (what it changes, [(file,
# text, replacement)]).
WALK_VARIANTS = {
    "shipped": ("variant_walk_kernel as shipped: the node's tested chunks staged in shared memory, "
                "one ray a thread, t first, barycentrics behind one branch, the columns' loop "
                "unrolled 4 times", []),
    **{f"unroll-{n}": (f"the staged columns' loop unrolled {n} times", [
        (_WALK, "#pragma unroll 4\n  for (int j = 0; j < tc; ++j) {",
         f"#pragma unroll {n}\n  for (int j = 0; j < tc; ++j) {{"),
    ]) for n in (1, 2, 8)},
}
# P2a's cases timed: (variant, group) at each of WALK_TILES, on phase 19's
# sorted depth-2 wavefront.
WALK_CASES = (("v0", 128), ("v1", 128), ("v2", 128), ("v3", 128), ("v4", 32), ("v4", 128))
WALK_TILES = (512, 1024)

# queue_walk_kernel (P2b-d), family "queue": name -> (what it changes, [(file,
# text, replacement)]).  ``walk-only`` keeps the drains' copies and barriers
# and removes their tests: no hit culls its walk, so its t, slot and tests
# are not the kernel's, and it is timed only.
QUEUE_VARIANTS = {
    "shipped": ("queue_walk_kernel as shipped: each drain's chunks staged in shared memory, t "
                "first, each chunk against the drain's best so far, one barrier a node and one a "
                "drain; at tile 2048 the two rays' column loop unrolled 8 times", []),
    "buffers-2": ("two drain buffers by turns: no barrier between two drains of one node", [
        (_WALK, "constexpr int kSlotBuffers = 1;", "constexpr int kSlotBuffers = 2;"),
    ]),
    "stale": ("each chunk of a drain against the ray's best t before the drain, as the parent", [
        (_WALK, "nextafterf(fminf(bound[j], t_batch[j]), __int_as_float(0x7f800000))",
         "nextafterf(bound[j], __int_as_float(0x7f800000))"),
    ]),
    **{f"rays-unroll-{n}": (f"tile 2048: the two rays' loop over the columns unrolled {n} "
                            f"times", [
        (_WALK, "#pragma unroll 8\n  for (int k = 0; k < tc; ++k) {",
         f"#pragma unroll {n}\n  for (int k = 0; k < tc; ++k) {{"),
    ]) for n in (2, 4)},
    "walk-only": ("the drains' copies and barriers kept, their tests removed (timed only)", [
        (_WALK, "    if (!any_valid) return;\n", "    return;\n"),
    ]),
}
TIMED_ONLY = ("walk-only",)
# P2b-d's cases timed: (variant, batch) at each of QUEUE_TILES, on phase 19's
# sorted depth-2 wavefront.
QUEUE_CASES = (("v6", 4), ("v6", 8), ("v7", 4), ("v7", 8), ("v8", 8), ("v8", 16))
QUEUE_TILES = (512, 1024, 2048)

# empty_kernel (P1 grid), family "grid": name -> (what it changes, [(file,
# text, replacement)]).
GRID_VARIANTS = {
    "shipped": ("empty_kernel as shipped: blocks of 256, 2 float4s a thread loaded before any "
                "store, __ldcs/__stcs, the head and tail by 8 threads of the first block", []),
    **{f"threads-{n}": (f"blocks of {n} threads", [
        (_PROBES, "constexpr int kEmptyThreads = 256;", f"constexpr int kEmptyThreads = {n};"),
    ]) for n in (128, 512)},
    **{f"vecs-{n}": (f"{n} float4s a thread", [
        (_PROBES, "constexpr int kEmptyVecs = 2;", f"constexpr int kEmptyVecs = {n};"),
    ]) for n in (1, 4)},
    "stride": ("a grid of one wave (132 SMs x 2,048 threads), block-strided", [
        (_PROBES, "const int blocks = max(blocks_for(items, kEmptyThreads * kEmptyVecs), 1);",
         "const int blocks = max(min(blocks_for(items, kEmptyThreads * kEmptyVecs), "
         "132 * 2048 / kEmptyThreads), 1);"),
    ]),
    "cached": ("plain loads and stores (through L1) in place of __ldcs/__stcs", [
        (_PROBES, "v[u] = __ldcs(x + i0 + u * kEmptyThreads);", "v[u] = x[i0 + u * kEmptyThreads];"),
        (_PROBES, "__stcs(out + i0 + u * kEmptyThreads, times_zero(v[u]));",
         "out[i0 + u * kEmptyThreads] = times_zero(v[u]);"),
    ]),
}
GRID_TILES = (256, 512, 1024)
GRID_COPIES = 8  # rotating inputs and outputs: 8 x 2 x 8.3 MB, past the 50 MB L2


# visit_stats_kernel (P3), family "stats": name -> (what it changes, [(file,
# text, replacement)]).  ``every-ray`` serves each opened leaf to every ray
# of the block, as the parent did, through the shipped barriers and service:
# its four counts are the kernel's, its pairs in range are not (it counts
# those of every ray), so only the counts are checked.  ``prefetch`` and
# ``seed-independent`` set their helpers before the kernel.
_STATS_KERNEL = "// One block of kTile rays.  Every thread keeps the node and the stack's"
_PREFETCH_HELPERS = """// A hint that the 128-byte line at `p` will be read soon: it is fetched
// into L1 while the warp works on, so that the read finds it there.
__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
}

// The warp's prefetch of a chunk of `tc` columns (its 12 tc floats, one
// line a lane) and of its anchor.
__device__ __forceinline__ void prefetch_chunk(const float* __restrict__ w,
                                               const float* __restrict__ wanchor, int n_chunks,
                                               int tc, int chunk) {
  const int lane = threadIdx.x & 31;
  const char* rows = reinterpret_cast<const char*>(w + (size_t)chunk * 12 * tc);
  for (int k = lane; k < 12 * tc / 32; k += 32) prefetch_l1(rows + 128 * k);
  if (lane >= 29) prefetch_l1(wanchor + (lane - 29) * n_chunks + chunk);
}

"""
_SEED_HELPER = """// The closest hit of a ray over the seed chunk (K columns, anchored at
// `anchor`), or kMissT: each column's `woop_t` against kMissT, t first and
// the barycentrics behind a branch, then the least.  With no running best
// in the range test the columns' tests are independent, and the least is
// the same.
__device__ __forceinline__ float seed_t(const float* __restrict__ sw, int k,
                                        const float* __restrict__ anchor, const Ray& r,
                                        float t_min) {
  const float ax = r.ox - anchor[0], ay = r.oy - anchor[1], az = r.oz - anchor[2];
  float best = kMissT;
#pragma unroll 4
  for (int j = 0; j < k; ++j) {
    const float4 s = make_float4(sw[2 * k + j], sw[5 * k + j], sw[8 * k + j], sw[11 * k + j]);
    const float t = plane_t(s, ax, ay, az, r);
    if (!((t > t_min) & (t < kMissT))) continue;
    const float4 u = make_float4(sw[j], sw[3 * k + j], sw[6 * k + j], sw[9 * k + j]);
    const float4 v = make_float4(sw[k + j], sw[4 * k + j], sw[7 * k + j], sw[10 * k + j]);
    best = fminf(best, inside_t(u, v, t, ax, ay, az, r));
  }
  return best;
}

"""
_POP = "    const int following = next >= 0 ? next : sp > 0 ? s.stack[--sp] : -1;\n"
_SEED_LOOP = """  if (valid && seed_k > 0) {
    const float ax = r.ox - seed_anchor[0];
    const float ay = r.oy - seed_anchor[1];
    const float az = r.oz - seed_anchor[2];
    for (int j = 0; j < seed_k; ++j) {
      best = fminf(best, tri_t(seed_w, seed_k, j, ax, ay, az, r, t_min, best));
    }
  }
"""
_PREFETCH_POP = """    const int following = next >= 0 ? next : sp > 0 ? s.stack[--sp] : -1;
    if (following >= 0 && lane < 3) {
      const size_t row = (size_t)following * kArity;
      prefetch_l1(lane < 2 ? static_cast<const void*>(wbox + (row + 4 * lane) * 8)
                           : static_cast<const void*>(wchild + row));
    }
    const unsigned served = leaf_bits & bits;
    for (unsigned b = served; b; b &= b - 1) {
      prefetch_chunk(w, wanchor, n_chunks, tc, -2 - codes[__ffs(static_cast<int>(b)) - 1]);
    }

"""
STATS_VARIANTS = {
    "shipped": ("visit_stats_kernel as shipped: each opened leaf served only to the rays that "
                "entered it, by their warps, from device memory; one barrier a node; each warp "
                "sums its own entering rays and pairs", []),
    "every-ray": ("every ray of the block tested at each opened leaf (the parent's rule) through "
                  "the shipped barriers and service", [
        (_PROBES, "      if (!ent) continue;\n",
         "      if (!__any_sync(kFullMask, valid)) continue;\n"),
        (_PROBES, "serve_leaf(w + (size_t)chunk * 12 * tc, tc, ent,",
         "serve_leaf(w + (size_t)chunk * 12 * tc, tc, __ballot_sync(kFullMask, valid),"),
    ]),
    "prefetch": ("the next node's row and the chunks of the leaves a warp's rays entered fetched "
                 "into L1 (prefetch.global.L1) before its leaves are served", [
        (_PROBES, _STATS_KERNEL, _PREFETCH_HELPERS + _STATS_KERNEL),
        (_PROBES, _POP, _PREFETCH_POP),
    ]),
    **{f"min-{n}": (f"__launch_bounds__ with {n} blocks an SM: up to {65536 // (256 * n) // 8 * 8} "
                    "registers", [
        (_PROBES, "__launch_bounds__(kTile) visit_stats_kernel(",
         f"__launch_bounds__(kTile, {n}) visit_stats_kernel("),
    ]) for n in (2, 3, 5)},
    "seed-independent": ("each seed column tested against no running best (t first, the "
                         "barycentrics behind a branch, unrolled 4 times), then the least", [
        (_PROBES, _STATS_KERNEL, _SEED_HELPER + _STATS_KERNEL),
        (_PROBES, _SEED_LOOP,
         "  if (valid && seed_k > 0) best = seed_t(seed_w, seed_k, seed_anchor, r, t_min);\n"),
    ]),
}
COUNTS_ONLY = ("every-ray",)
# P3's wavefronts timed: (scene, depth) at 1080p, each plain and seeded.
STATS_WAVES = (("cornell", 1), ("cornell", 2), ("cornell", 3), ("cornell", 4),
               ("high-poly", 1), ("high-poly", 2))

# nodes_kernel (P1 nodes), family "nodes": name -> (what it changes, [(file,
# text, replacement)]).  ``known-hit`` reads each ray's t from its t output
# (K1's t, written there first) as its best from the start: the walk K1
# would take if it knew its hit.  ``smem-rows`` takes the tree's node count
# in ``ray_tile`` (the shipped kernel's blocks do not depend on it) and
# stages the node rows in that much dynamic shared memory.
_NODE_ROW_BYTES = 8 * 8 * 4 + 8 * 4 + 4  # a node's boxes, child codes and axis
_SMEM_ROWS = """  extern __shared__ float4 rows_mem[];
  unsigned bytes;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(bytes));
  const int n_nodes = static_cast<int>(bytes) / {row};
  float* sbox = reinterpret_cast<float*>(rows_mem);
  int* schild = reinterpret_cast<int*>(sbox + n_nodes * kArity * 8);
  int* saxis = schild + n_nodes * kArity;
  for (int k = threadIdx.x; k < n_nodes * kArity * 2; k += blockDim.x) {{
    cp_async16(sbox + 4 * k, wbox + 4 * k);
  }}
  for (int k = threadIdx.x; k < n_nodes * kArity / 4; k += blockDim.x) {{
    cp_async16(schild + 4 * k, wchild + 4 * k);
  }}
  for (int k = threadIdx.x; k < n_nodes; k += blockDim.x) {{
    cp_async4(reinterpret_cast<float*>(saxis + k), reinterpret_cast<const float*>(waxis + k));
  }}
  cp_async_commit();
  cp_async_wait(0);
  __syncthreads();
  closest_walk<NoServe>(ox, oy, oz, dx, dy, dz, n_rays, sbox, schild, saxis, nullptr, nullptr, 0,
""".format(row=_NODE_ROW_BYTES)
_NODES_KERNEL = "// K1's walk (wide_bvh_walk.cuh `closest_walk`, K1's blocks and register"
_CP_ASYNC16 = """__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" ::"r"(s), "l"(gmem)
               : "memory");
}

"""
NODES_VARIANTS = {
    "shipped": ("nodes_kernel as shipped: K1's walk (closest_walk, blocks of 128, one node a "
                "round, pending leaves re-culled) with a service that serves nothing", []),
    "known-hit": ("the same walk culled by each ray's final t from K1 (read from its t output)", [
        (_WALK_LOOP, "  float best = kMissT;\n  int best_slot = -1;\n  int visits = 0;",
         "  float best = valid ? t_out[i] : kMissT;\n  int best_slot = -1;\n  int visits = 0;"),
    ]),
    "smem-rows": ("the node rows (boxes, child codes, axis) staged once per block in shared "
                  "memory by cp.async", [
        (_PROBES, _NODES_KERNEL, _CP_ASYNC16 + _NODES_KERNEL),
        (_PROBES, "  closest_walk<NoServe>(ox, oy, oz, dx, dy, dz, n_rays, wbox, wchild, waxis, "
                  "nullptr, nullptr, 0,\n", _SMEM_ROWS),
        (_PROBES, "nodes_kernel<<<walk_blocks(n_rays), kWalkThreads, 0,",
         f"nodes_kernel<<<walk_blocks(n_rays), kWalkThreads, ray_tile * {_NODE_ROW_BYTES},"),
    ]),
}


def log(*args):
    print(*args, flush=True)


def variant_source(name: str, edits, target: str = _K1) -> Path:
    """A copy of csrc/ with ``edits`` applied: the path of its ``target``
    source."""
    src = OUT / name / "csrc"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(CSRC, src)
    for file, text, new in edits:
        path = src / file
        pattern = text if isinstance(text, re.Pattern) else re.compile(re.escape(text))
        repl = new if callable(new) else new.replace("\\", "\\\\")
        body, count = pattern.subn(repl, path.read_text())
        if count != 1:
            raise ValueError(f"variant {name}: {pattern.pattern!r} occurs {count} times in {file}")
        path.write_text(body)
    return src / target


def compile_lib(name: str, source: Path):
    """(library or None, ptxas report) of one variant."""
    from heatray_tpu_torch.ops import cuda_build

    OUT.mkdir(parents=True, exist_ok=True)
    so = OUT / f"{name}.so"
    proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(so), str(source)],
                          capture_output=True, text=True)
    report = proc.stdout + proc.stderr
    if proc.returncode:
        log(f"[build] {name}: nvcc failed ({proc.returncode})\n{proc.stderr[-3000:]}")
        return None, report
    return so, report


def takes_blocks(source: Path, entry: str) -> bool:
    """Whether the C entry point ``entry`` of ``source`` takes block boxes
    (a parent tree's may not: K7b's, K5's and K6a's before their block
    boxes)."""
    m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", source.read_text())
    return m is not None and "blocks" in m.group(1)


# A binary tree's arguments to a K6 entry without block boxes (the earlier
# designs of K6a and K6b): nbox, meta, w, leaf size.
_BVH_TREE = [ctypes.c_void_p] * 3 + [ctypes.c_int]


def bvh_tree_args(lib_fn, binary, lib) -> list:
    """The arguments of a K6 entry: ``traverse_pallas._block_tree_args``,
    less the block boxes, anchors and chunk count where the entry takes
    none."""
    from heatray_tpu_torch.ops import traverse_pallas as tp

    args = tp._block_tree_args(binary, lib)
    return args if lib_fn.blocks else args[1:4] + args[6:]


def library(so: Path, source: Path) -> ctypes.CDLL:
    """A build of ``wide_bvh.cu``, ``wide_bvh_t.cu``, ``bvh2.cu``,
    ``chunks.cu`` or ``probes.cu`` (or a variant of one), its entry points
    declared as the package declares them, less the block boxes where
    ``source``'s entry takes none (K4's and K5's before their block boxes,
    K7b's; K6's before their block boxes took no anchors either); each
    entry declared gets a ``blocks`` attribute that says which."""
    from heatray_tpu_torch.ops import intersect_pallas as ip
    from heatray_tpu_torch.ops import traverse_pallas as tp
    from heatray_tpu_torch.ops import wide_bvh as wb
    from heatray_tpu_torch.probes import _SIGNATURES, _VARIANT_SIGNATURES

    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    k6a = [p] * 6 + [i] + tp._BLOCK_TREE + tp._TAIL + [p] * 3
    k6b = [p] * 7 + [i] + tp._BLOCK_TREE + tp._TAIL + [p] * 2
    # entry -> (its arguments with block boxes, the index of that pointer)
    entries = {"closest_wide": (wb._CLOSEST_ARGS, None), "any_wide": (wb._ANY_ARGS, None),
               "closest_wide_t": (wb._CLOSEST_BLOCK_ARGS, 7),
               "any_wide_t": (wb._ANY_BLOCK_ARGS, 8),
               "closest_stream_t": (wb._CLOSEST_BLOCK_ARGS, 7),
               "any_stream_t": (wb._ANY_BLOCK_ARGS, 8),
               "closest_bvh": (k6a, 7), "any_bvh": (k6b, 8),
               "closest_chunks": (ip._CLOSEST_ARGS, 7), "any_chunks": (ip._ANY_ARGS, 8),
               **{name: (_SIGNATURES[name], None) for name in ("probe_rows", "probe_warp",
                                                                "probe_empty", "probe_visit_stats",
                                                                "probe_nodes")},
               **{name: (_VARIANT_SIGNATURES[name], None) for name in ("variant_walk",
                                                                       "queue_walk")}}
    for entry, (args, at) in entries.items():
        if not hasattr(lib, entry):
            continue
        fn = getattr(lib, entry)
        fn.blocks = at is not None and takes_blocks(source, entry)
        fn.argtypes = args if at is None or fn.blocks else args[:at] + args[at + 1:]
        if entry.endswith("_bvh") and not fn.blocks:  # nor the anchors and chunk count
            fn.argtypes = args[:at] + _BVH_TREE + args[at + len(tp._BLOCK_TREE):]
        fn.restype = ctypes.c_int
    for depth in ("wide_bvh_stack_depth", "wide_t_stack_depth", "stream_t_stack_depth",
                  "bvh2_stack_depth", "variants_stack_depth", "probe_block_stack_depth",
                  "probe_stack_depth", "probe_block_tile"):
        if hasattr(lib, depth):
            getattr(lib, depth).restype = ctypes.c_int
    return lib


_KERNEL_LABELS = {"closest_wide_t": "K5a", "any_wide_t": "K5b", "closest_stream_t": "K4a",
                  "any_stream_t": "K4b", "closest_stream": "K3a", "any_stream": "K3b",
                  "closest_wide": "K1", "any_wide": "K2", "closest_bvh": "K6a",
                  "any_bvh": "K6b", "closest_chunks": "K7a", "any_chunks": "K7b",
                  "visit_stats": "P3 visit_stats", "nodes": "P1 nodes",
                  "rows_brute": "P1/P4 rows_brute", "warp_brute": "P4 warp_brute",
                  "empty": "P1 empty"}


def kernel_label(name: str):
    """The label of a kernel's (mangled) name, or None; P2's templates with
    their arguments (variant or anchor, threads[, rays])."""
    m = re.search(r"(variant_walk|queue_walk)_kernelI(.*?)EEv", name)
    if m:
        args = ",".join(re.findall(r"(?:E|Li)(\d+)", m.group(2)))
        return f"P2 {m.group(1)}<{args}>"
    return next((k for n, k in _KERNEL_LABELS.items() if f"{n}_kernel" in name), None)


def resources(report: str) -> str:
    """Each kernel's registers and spill bytes from a ptxas report."""
    out, kernel = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel = kernel_label(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and kernel:
            out.setdefault(kernel, {})["spill"] = f"{m.group(1)}/{m.group(2)} B spilled"
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            out.setdefault(kernel, {})["regs"] = f"{m.group(1)} registers"
            smem = re.search(r"(\d+) bytes smem", line)
            out[kernel]["smem"] = f", {smem.group(1)} B static shared" if smem else ""
    return ", ".join(f"{k} {v.get('regs', '?')} ({v.get('spill', '?')}{v.get('smem', '')})"
                     for k, v in sorted(out.items()))


def launches(device):
    """The Cornell box's trees at each of LEAVES, the rebuild mode's chunk
    packs (closest hit, occlusion), its ``"bvh"`` context's binary trees
    (closest hit, occlusion) and its four launches."""
    import torch

    from heatray_tpu_torch import cornell_box, orbit_camera
    from heatray_tpu_torch.options import FrameGlobals, RenderOptions
    from heatray_tpu_torch.render import integrator

    opts = RenderOptions(width=WIDTH, height=HEIGHT, max_render_passes=64, max_ray_depth=4)
    scene = cornell_box(light="both", with_spheres=True).to(device)
    camera = orbit_camera(WIDTH, HEIGHT, distance=6.2, focal_length_mm=35.0).to(device)
    trees = {}
    for leaf in LEAVES:
        pack = integrator.make_context(dataclasses.replace(opts, wide_leaf_size=leaf), scene,
                                       device).accel_pack
        trees[leaf] = (pack.wide, pack.wide_occl)
    chunk_pack = integrator.rebuild_pack(scene, opts)
    chunks = (chunk_pack.packed, chunk_pack.packed_occl)
    bvh_pack = integrator.make_context(dataclasses.replace(opts, intersect_backend="bvh"), scene,
                                       device).accel_pack
    binary = bvh_pack.bvh
    ctx = integrator.make_context(opts, scene, device)
    pack = ctx.accel_pack
    frame = FrameGlobals.create(0, device=device)
    primary = integrator.start_paths(camera, ctx, opts, 0)
    first, shadow = integrator.bounce(scene, ctx, opts, frame, 1, primary, pack)
    paths = integrator._sort_paths(first, *integrator._sort_bounds(pack))
    n = integrator._gated_lanes(paths, opts.gate_segments)
    head = paths.map(lambda p: p[:n])
    _, shadow2 = integrator.bounce(scene, ctx, opts, frame, 2, head, pack)
    torch.cuda.synchronize()
    rays = {"primary": (primary, None), "shadow": (shadow, shadow.t_max),
            "head": (head, None), "head shadow": (shadow2, shadow2.t_max)}
    log(f"[rays] primary {primary.org.x.numel()}, shadow {shadow.org.x.numel()}, head {n}, "
        f"head shadow {shadow2.org.x.numel()}; epsilon {opts.ray_epsilon}; "
        f"{chunks[0].num_chunks} chunks of {chunks[0].tri_chunk}; binary tree of "
        f"{binary.num_nodes} nodes, {binary.num_chunks} leaves of {binary.leaf_size}, "
        f"stack {binary.max_stack}")
    return trees, chunks, (binary, bvh_pack.bvh_occl), rays, opts.ray_epsilon


def hp_launches(device):
    """``high_poly``'s leaf-128 trees (closest hit, occlusion) of the
    ``"stream"`` context ``"auto"`` picks, and the four launches of
    ``chip_smoke.py`` phase 7: the primary rays, the first-bounce shadow
    lanes, the sorted, gated depth-2 head and its shadow lanes."""
    import torch

    from heatray_tpu_torch import frame_scene, high_poly, scene_aabb
    from heatray_tpu_torch.options import FrameGlobals, RenderOptions
    from heatray_tpu_torch.render import integrator

    opts = RenderOptions(width=WIDTH, height=HEIGHT, max_render_passes=64, max_ray_depth=4)
    scene = high_poly().to(device)
    camera = frame_scene(scene_aabb(scene.geometry), WIDTH, HEIGHT, theta=0.35).to(device)
    ctx = integrator.make_context(opts, scene, device)
    pack = ctx.accel_pack
    if (pack.backend, pack.wide.leaf_size) != ("stream", 128):
        raise AssertionError(f"high_poly got {pack.backend!r} at leaf {pack.wide.leaf_size}")
    frame = FrameGlobals.create(0, device=device)
    primary = integrator.start_paths(camera, ctx, opts, 0)
    first, shadow = integrator.bounce(scene, ctx, opts, frame, 1, primary, pack)
    paths = integrator._sort_paths(first, *integrator._sort_bounds(pack))
    n = integrator._gated_lanes(paths, opts.gate_segments)
    head = paths.map(lambda p: p[:n])
    _, shadow2 = integrator.bounce(scene, ctx, opts, frame, 2, head, pack)
    torch.cuda.synchronize()
    log(f"[rays] high_poly: {pack.wide.num_triangles} triangles, {pack.wide.num_chunks} leaves "
        f"of 128, stack {pack.wide.max_stack}; primary {primary.org.x.numel()}, shadow "
        f"{shadow.org.x.numel()}, head {n}, head shadow {shadow2.org.x.numel()}")
    rays = {"primary": (primary, None), "shadow": (shadow, shadow.t_max),
            "head": (head, None), "head shadow": (shadow2, shadow2.t_max)}
    return (pack.wide, pack.wide_occl), rays, opts.ray_epsilon


def in_turns(names, whats, run) -> dict:
    """ms of ``run(name, what)`` over 10 launches, each name in turn, in
    order and then in reverse: name -> what -> [two readings]."""
    from chip_smoke import time_ms

    ms = {name: {what: [] for what in whats} for name in names}
    for name in names + names[::-1]:
        for what in whats:
            ms[name][what].append(time_ms(lambda: run(name, what), 10))
    return ms


def profile_k1(libs, trees, rays, eps) -> None:
    """K1/K2's variants: checked against the shipped kernels, timed, and
    their groups counted."""
    import torch

    from heatray_tpu_torch.ops import wide_bvh as wb

    def run(name, leaf, what):
        lib = libs[name]
        ray, t_max = rays[what]
        bvh = trees[leaf][t_max is not None]
        tree = wb._tree_args(bvh, lib.wide_bvh_stack_depth())
        if t_max is None:
            return wb.launch_closest(lib.closest_wide, tree, bvh, ray.org, ray.direction, eps)[:2]
        return (wb.launch_any(lib.any_wide, tree, bvh, ray.org, ray.direction, eps, t_max),)

    for leaf in LEAVES:
        names = [n for n in libs if leaf == 32 or n in WIDE_LEAF_VARIANTS]
        ref = {what: run("shipped", leaf, what) for what in rays}
        for name in names:
            differ = {}
            for what in rays:
                out = run(name, leaf, what)
                same = torch.ones_like(out[0], dtype=torch.bool)
                for a, b in zip(out, ref[what]):
                    same &= a == b
                differ[what] = int((~same).sum())
            log(f"[check] leaf {leaf}, {name}: lanes that differ from shipped: {differ}")
            if name != "parent" and any(differ.values()):
                raise AssertionError(f"variant {name} differs from the shipped kernels")
        ms = in_turns(names, list(rays), lambda name, what: run(name, leaf, what))
        for name in names:
            log(f"[time] leaf {leaf}, {name}: " + ", ".join(
                f"{what} {min(v):.4f}/{max(v):.4f}" for what, v in ms[name].items()))

    if "count" in libs:
        lib = libs["count"]
        hist = (ctypes.c_ulonglong * 33)()
        for leaf in LEAVES:
            for what in rays:
                if lib.lane_groups_clear():
                    raise RuntimeError("lane_groups_clear failed")
                run("count", leaf, what)
                torch.cuda.synchronize()
                if lib.lane_groups_read(hist):
                    raise RuntimeError("lane_groups_read failed")
                h = list(hist)
                groups = sum(h)
                pairs = sum(k * c for k, c in enumerate(h))
                shares = []
                for above in sorted({16, lane_rays()}):
                    big = sum(h[above + 1:])
                    big_pairs = sum(k * c for k, c in enumerate(h) if k > above)
                    shares.append(f"above {above} rays: {big / max(groups, 1):.4f} of the "
                                  f"groups, {big_pairs / max(pairs, 1):.4f} of the pairs")
                log(f"[groups] leaf {leaf}, {what}: {groups} groups, "
                    f"{pairs / max(groups, 1):.3f} rays a group; " + "; ".join(shares))


def plain_picks(rays, plain):
    """The plain version on ``chip_smoke.N_CHECK`` seeded lanes of each
    launch: what -> (lanes, ``plain(what, origins, directions, t_max or
    None)``'s outputs)."""
    import torch

    from chip_smoke import N_CHECK, SEED, subset

    gen = torch.Generator().manual_seed(SEED)
    out = {}
    for what, (ray, t_max) in rays.items():
        pick = torch.randperm(ray.org.x.numel(), generator=gen)[:N_CHECK].to(ray.org.x.device)
        o, d = subset(ray.org, pick), subset(ray.direction, pick)
        out[what] = (pick, plain(what, o, d, None if t_max is None else t_max[pick]))
    return out


def check_variants(label, libs, whats, run, plain=None) -> None:
    """Each variant of ``libs`` on each launch of ``whats`` against the
    shipped kernel (every lane, every output) and, with ``plain`` (from
    ``plain_picks``), against the plain version on its lanes; a variant of
    this tree must equal both, the parent's differing lanes are printed."""
    import torch

    from chip_smoke import N_CHECK

    def differ(out, want, pick=None):
        same = torch.ones_like(want[0], dtype=torch.bool)
        for a, b in zip(out, want):
            same &= (a if pick is None else a[pick]) == b
        return int((~same).sum())

    ref = {what: run("shipped", what) for what in whats}
    for name in libs:
        outs = {what: run(name, what) for what in whats}
        off = {what: differ(outs[what], ref[what]) for what in whats}
        off_plain = {what: differ(outs[what], plain[what][1], plain[what][0])
                     for what in whats} if plain else {}
        log(f"[check] {label} {name}: lanes that differ from shipped {off}"
            + (f", from the plain version on {N_CHECK} seeded lanes of each launch {off_plain}"
               if plain else ""))
        if name != "parent" and (any(off.values()) or any(off_plain.values())):
            raise AssertionError(f"{label} variant {name} differs from the shipped kernel or "
                                 "the plain version")
    torch.cuda.synchronize()


def profile_k5(libs, trees, rays, eps) -> None:
    """K5a's and K5b's variants over the Cornell box's leaf-128 trees (Route
    A's): K5a on the primary rays and the head, K5b on their shadow lanes,
    each checked bit for bit against the shipped kernel and K5b against the
    plain version on N_CHECK seeded lanes of each launch, then timed in
    turns."""
    from heatray_tpu_torch.ops import wide_bvh as wb

    def run(name, what):
        lib = libs[name]
        ray, t_max = rays[what]
        bvh = trees[128][t_max is not None]
        fn = lib.closest_wide_t if t_max is None else lib.any_wide_t
        depth = lib.wide_t_stack_depth()
        tree = wb._block_tree_args(bvh, depth) if fn.blocks else wb._tree_args(bvh, depth)
        if t_max is None:
            return wb.launch_closest(fn, tree, bvh, ray.org, ray.direction, eps)[:2]
        return (wb.launch_any(fn, tree, bvh, ray.org, ray.direction, eps, t_max),)

    closest = ["primary", "head"]
    check_variants("K5a", libs, closest, run)
    k5b = [n for n in ("shipped", "leaves", "uncapped", "parent") if n in libs]
    shadows = {what: rays[what] for what in ("shadow", "head shadow")}
    plain = plain_picks(shadows, lambda what, o, d, t_max: (
        wb.any_wide_plain(trees[128][1], o, d, eps, t_max),))
    check_variants("K5b", {n: libs[n] for n in k5b}, list(shadows), run, plain)
    for label, names, whats in (("K5a", list(libs), closest), ("K5b", k5b, list(shadows))):
        ms = in_turns(names, whats, run)
        for name in names:
            log(f"[time] {label} {name}: " + ", ".join(
                f"{what} {min(v):.4f}/{max(v):.4f}" for what, v in ms[name].items()))


def profile_k6(libs, binaries, rays, eps) -> None:
    """K6a's and K6b's variants over the Cornell box's binary trees (the
    ``"bvh"`` context's, leaf 64): K6a on the primary rays and the head,
    K6b on their shadow lanes over the occluder tree, each checked bit for
    bit (t and slot, masks) against the shipped kernel and against the
    plain version on N_CHECK seeded lanes of each launch, then timed in
    turns."""
    from heatray_tpu_torch.ops import intersect
    from heatray_tpu_torch.ops import traverse_pallas as tp
    from heatray_tpu_torch.ops import wide_bvh as wb

    def run(name, what):
        lib = libs[name]
        ray, t_max = rays[what]
        binary = binaries[t_max is not None]
        if t_max is None:
            fn = lib.closest_bvh
            tree = bvh_tree_args(fn, binary, lib)
            return wb.launch_closest(fn, tree, binary, ray.org, ray.direction, eps)[:2]
        fn = lib.any_bvh
        tree = bvh_tree_args(fn, binary, lib)
        return (wb.launch_any(fn, tree, binary, ray.org, ray.direction, eps, t_max),)

    closest = {what: rays[what] for what in ("primary", "head")}
    rows = intersect.chunk_rows(binaries[0].w)
    plain = plain_picks(closest, lambda what, o, d, _: intersect.closest_rows(o, d, rows, eps)[:2])
    check_variants("K6a", libs, list(closest), run, plain)
    shadows = {what: rays[what] for what in ("shadow", "head shadow")}
    plain = plain_picks(shadows, lambda what, o, d, t_max: (
        tp.any_bvh_plain(binaries[1], o, d, eps, t_max),))
    check_variants("K6b", libs, list(shadows), run, plain)
    for label, whats in (("K6a", list(closest)), ("K6b", list(shadows))):
        ms = in_turns(list(libs), whats, run)
        for name in libs:
            log(f"[time] {label} {name}: " + ", ".join(
                f"{what} {min(v):.4f}/{max(v):.4f}" for what, v in ms[name].items()))


def profile_brute(libs, t_min: float = 1e-4) -> None:
    """``rows_brute_kernel``'s and ``warp_brute_kernel``'s variants and the
    parent on the Cornell box's 1080p primary rays (``chip_smoke.py`` phase
    17's) at each of BRUTE_CASES: each kernel of each build checked bit for
    bit against the shipped ``rows_brute_kernel`` on every ray (the minimum
    does not depend on the order of the columns; a parent's differing rays
    are printed) and within ``chip_smoke.TOL`` against the plain version on
    N_CHECK seeded rays, then timed in turns (``rows_brute_kernel`` of the
    shipped build, the parent and each variant that edits it at every case,
    ``warp_brute_kernel`` of the shipped build, the parent and each ``warp-``
    variant at P4's), and set beside the operation bound of the brute force
    over the scene's triangles (``chip_smoke.brute_in_range``, the bound of
    phase 17's kernels line)."""
    import torch

    from chip_smoke import (BARY_FLOPS, N_CHECK, PAIR_T_FLOPS, PEAK_FLOPS, SEED, TOL,
                            brute_in_range, subset)
    from heatray_tpu_torch.ops import wide_bvh as wb
    from heatray_tpu_torch.ops.intersect import MISS_T
    from heatray_tpu_torch.probes import cornell, vpu_leaf
    from heatray_tpu_torch.render import integrator

    device = torch.device("cuda:0")
    _, camera, opts, ctx = cornell(WIDTH, HEIGHT, 4, device)
    prim = integrator.start_paths(camera, ctx, opts, 0)
    accel = ctx.accel_pack.accel
    o, d = prim.org, prim.direction
    r = o.x.numel()
    chunks = {}
    for probe, tc, _ in BRUTE_CASES:
        if probe == "P1":
            bvh = wb.build_wide_bvh(accel, leaf_size=tc)
            chunks[probe, tc] = (bvh.w, bvh.wanchor)
        else:
            chunks[probe, tc] = (vpu_leaf.pack_chunks(accel, tc), None)
    torch.cuda.synchronize()

    def run(key, case):  # key: (build, "rows" or "warp")
        name, layout = key
        probe, tc, rt = case
        w, anchor = chunks[probe, tc]
        fn = libs[name].probe_warp if layout == "warp" else libs[name].probe_rows
        return (vpu_leaf._brute(fn, w, o, d, anchor, rt, t_min),)

    keys = [(name, layout) for name in libs for layout in ("rows", "warp")]
    rows_keys = [(n, "rows") for n in libs if not n.startswith("warp-")]
    warp_keys = [(n, "warp") for n in libs if n in ("shipped", "parent") or n.startswith("warp-")]
    pick = torch.randperm(r, generator=torch.Generator().manual_seed(SEED))[:N_CHECK].to(device)
    s_o, s_d = subset(o, pick), subset(d, pick)
    for case in BRUTE_CASES:
        probe, tc, rt = case
        w, anchor = chunks[probe, tc]
        want = run(("shipped", "rows"), case)[0]
        t_p = vpu_leaf.closest_brute_plain(w, s_o, s_d, anchor, t_min)
        hit = t_p < MISS_T
        for key in keys:
            t = run(key, case)[0]
            off = int((t != want).sum())
            near = ((t[pick] - t_p).abs() <= TOL + TOL * t_p.abs()) & ((t[pick] < MISS_T) == hit)
            log(f"[check] brute {probe} tc {tc} rt {rt} {key[0]} {key[1]}_brute_kernel: rays "
                f"whose t differs from the shipped rows_brute_kernel {off}, seeded rays off the "
                f"plain version {int((~near).sum())}")
            if (off and key != ("parent", "warp")) or not bool(near.all()):
                raise AssertionError(f"brute {key} at {case} differs from the shipped kernel or "
                                     "the plain version")
    t_hit = run(("shipped", "rows"), BRUTE_CASES[0])[0]
    flops = r * accel.num_triangles * PAIR_T_FLOPS + brute_in_range(accel, o, d, t_hit) * BARY_FLOPS
    bound = flops / PEAK_FLOPS * 1e3
    log(f"[bound] brute force on {r} rays, {accel.num_triangles} triangles: "
        f"{flops / 1e9:.1f} GFLOP -> {bound:.4f} ms (operations)")
    p4 = [case for case in BRUTE_CASES if case[0] == "P4"]
    for layout, names, cases in (("rows", rows_keys, list(BRUTE_CASES)), ("warp", warp_keys, p4)):
        ms = in_turns(names, cases, run)
        for key in names:
            log(f"[time] brute {layout}_brute {key[0]}: " + ", ".join(
                f"{p} tc {tc} rt {rt} {min(v):.4f}/{max(v):.4f} ({bound / min(v):.1%} of the bound)"
                for (p, tc, rt), v in ms[key].items()))


def profile_walk(libs) -> None:
    """``variant_walk_kernel``'s variants and the parent on ``chip_smoke.py``
    phase 19's rays (the Cornell box's sorted depth-2 wavefront at 1080p,
    over its leaf-32 ``"wide"`` tree): each of WALK_CASES at each of
    WALK_TILES, t, slot and the tests per tile checked bit for bit against
    the parent's (when given) and the shipped kernel's, then timed in turns,
    with K1 on the same rays."""
    import torch

    from chip_smoke import time_ms
    from heatray_tpu_torch.ops import wide_bvh as wb
    from heatray_tpu_torch.probes import cornell
    from heatray_tpu_torch.probes import kernel_variants as kv

    device = torch.device("cuda:0")
    scene, camera, opts, ctx = cornell(WIDTH, HEIGHT, 4, device)
    paths = kv.wavefront(scene, camera, ctx, opts)
    bvh = ctx.accel_pack.wide
    o, d = paths.org, paths.direction
    torch.cuda.synchronize()
    cases = [(v, g, rt) for rt in WALK_TILES for v, g in WALK_CASES]

    def run(name, case):
        variant, group, rt = case
        return kv._launch("variant_walk", kv._WALK_CODES[variant], bvh.w, bvh, o, d, rt, group,
                          kv.T_MIN, lib=libs[name])

    ref = "parent" if "parent" in libs else "shipped"
    log(f"[rays] walk: {o.x.numel()} lanes of the sorted depth-2 wavefront, "
        f"{int(paths.active.sum())} live; {bvh.num_chunks} leaves of {bvh.leaf_size}")
    for case in cases:
        want = run(ref, case)
        for name in libs:
            got = run(name, case)
            off = [int((a != b).sum()) for a, b in zip(got, want)]
            log(f"[check] walk {case[0]} g {case[1]} rt {case[2]} {name}: lanes whose t, slot "
                f"differ and tiles whose tests differ from the {ref}'s {off}; "
                f"{float(got[2].double().mean()) / case[2]:.3f} leaf tests per ray of a tile")
            if any(off):
                raise AssertionError(f"walk {name} at {case} differs from the {ref}'s")
    ms = in_turns(list(libs), cases, run)
    for name in libs:
        log(f"[time] walk {name}: " + ", ".join(
            f"{v}{f'g{g}' if v == 'v4' else ''}@{rt} {min(x):.4f}/{max(x):.4f}"
            for (v, g, rt), x in ms[name].items()))
    k1 = time_ms(lambda: wb.intersect_closest_wide(bvh, o, d), 10)
    log(f"[time] walk: K1 (closest_wide) on the same rays {k1:.4f}")


def profile_queue(libs) -> None:
    """``queue_walk_kernel``'s variants and the parent on ``chip_smoke.py``
    phase 19's rays (the Cornell box's sorted depth-2 wavefront at 1080p,
    over its leaf-32 ``"wide"`` tree): each of QUEUE_CASES at each of
    QUEUE_TILES, t, slot and the tests per tile checked bit for bit against
    the parent's (when given) and the shipped kernel's (TIMED_ONLY variants
    excepted), then timed in turns, with v0 (``variant_walk_kernel``, tile
    512) and K1 on the same rays."""
    import torch

    from chip_smoke import PAIR_T_FLOPS, PEAK_FLOPS, time_ms
    from heatray_tpu_torch.ops import wide_bvh as wb
    from heatray_tpu_torch.probes import cornell
    from heatray_tpu_torch.probes import kernel_variants as kv

    device = torch.device("cuda:0")
    scene, camera, opts, ctx = cornell(WIDTH, HEIGHT, 4, device)
    paths = kv.wavefront(scene, camera, ctx, opts)
    bvh = ctx.accel_pack.wide
    rows = kv.unanchored_rows(ctx.accel_pack.accel, bvh)
    o, d = paths.org, paths.direction
    torch.cuda.synchronize()
    cases = [(v, b, rt) for rt in QUEUE_TILES for v, b in QUEUE_CASES]

    def run(name, case):
        variant, batch, rt = case
        return kv._launch("queue_walk", kv._ANCHORS[variant], bvh.w if variant == "v8" else rows,
                          bvh, o, d, rt, batch, kv.T_MIN, lib=libs[name])

    ref = "parent" if "parent" in libs else "shipped"
    log(f"[rays] queue: {o.x.numel()} lanes of the sorted depth-2 wavefront, "
        f"{int(paths.active.sum())} live; {bvh.num_chunks} leaves of {bvh.leaf_size}")
    work = {}
    for case in cases:
        want = run(ref, case)
        work[case] = float(want[2].double().sum()) * bvh.leaf_size * PAIR_T_FLOPS / PEAK_FLOPS * 1e3
        for name in libs:
            got = run(name, case)
            off = [int((a != b).sum()) for a, b in zip(got, want)]
            log(f"[check] queue {case[0]}b{case[1]} rt {case[2]} {name}: lanes whose t, slot "
                f"differ and tiles whose tests differ from the {ref}'s {off}; "
                f"{float(got[2].double().mean()) / case[2]:.3f} leaf tests per ray of a tile")
            if any(off) and name not in TIMED_ONLY:
                raise AssertionError(f"queue {name} at {case} differs from the {ref}'s")
    ms = in_turns(list(libs), cases, run)
    for name in libs:
        log(f"[time] queue {name}: " + ", ".join(
            f"{v}b{b}@{rt} {min(x):.4f}/{max(x):.4f}" for (v, b, rt), x in ms[name].items()))
    log("[time] queue own-work bound (tests x columns x 15 FLOP at 67 TFLOP/s): " + ", ".join(
        f"{v}b{b}@{rt} {w:.4f}" for (v, b, rt), w in work.items()))
    v0 = time_ms(lambda: kv._launch("variant_walk", 0, bvh.w, bvh, o, d, 512, 128, kv.T_MIN,
                                    lib=libs["shipped"]), 10)
    k1 = time_ms(lambda: wb.intersect_closest_wide(bvh, o, d), 10)
    log(f"[time] queue: v0 (variant_walk_kernel, tile 512) {v0:.4f}, K1 (closest_wide) {k1:.4f} "
        f"on the same rays")


def profile_stats(libs) -> None:
    """``visit_stats_kernel``'s variants and the parent on the wavefronts of
    ``chip_smoke.py`` phase 16 at 1080p (STATS_WAVES: the Cornell box's
    depths 1-4 over its leaf-32 tree, ``high_poly``'s depths 1-2 over its
    leaf-128 tree), plain and seeded: the four counts of every tile of
    every build equal to the parent's (or, without one, the shipped
    kernel's), the work counts too but for COUNTS_ONLY; then timed in
    turns, each wavefront beside its bound from the shipped kernel's work
    counts."""
    import torch

    from chip_smoke import BARY_FLOPS, PAIR_T_FLOPS, PEAK_BYTES, PEAK_FLOPS, SLAB_FLOPS
    from heatray_tpu_torch.options import FrameGlobals
    from heatray_tpu_torch.probes import visit_stats as vs
    from heatray_tpu_torch.render import integrator

    device = torch.device("cuda:0")
    waves = {}  # (scene, depth) -> (tree, origins, directions, seed chunk and anchor)
    for name in dict(STATS_WAVES):
        depth = max(d for n, d in STATS_WAVES if n == name)
        scene, camera, opts, ctx, tree = vs.setup(name, WIDTH, HEIGHT, depth, device)
        seed = vs.seed_chunk(scene, ctx.accel_pack.accel)[:2]
        frame = FrameGlobals.create(0, device=device)
        paths = integrator.start_paths(camera, ctx, opts, 0)
        for dep in range(1, depth + 1):
            waves[name, dep] = (tree, paths.org, paths.direction, seed)
            if dep < depth:
                paths, _ = integrator.bounce(scene, ctx, opts, frame, dep, paths, ctx.accel_pack)
    torch.cuda.synchronize()
    cases = [(name, dep, k) for name, dep in STATS_WAVES for k in (0, vs.SEED_K)]

    def run(name, case, work=False):
        tree, o, d, (sw, sa) = waves[case[:2]]
        return vs._launch(libs[name], tree, o, d, sw, sa, vs.TILE, case[2], 1e-4, work)

    ref = "parent" if "parent" in libs else "shipped"
    bounds = {}
    for case in cases:
        tree, o, d, _ = waves[case[:2]]
        want = run(ref, case, work=True)
        for name in libs:
            got = run(name, case, work=True)
            off = [int((a != b).sum()) for a, b in zip(got[:4], want[:4])]
            off_work = int((got[4] != want[4]).any(dim=1).sum())
            log(f"[check] stats {case[0]} depth {case[1]} seed {case[2]} {name}: tiles whose "
                f"nodes, leaves, overlap, improving differ from the {ref}'s {off}, whose work "
                f"counts differ {off_work}")
            if any(off) or (off_work and name not in COUNTS_ONLY):
                raise AssertionError(f"stats {name} at {case} differs from the {ref}'s")
        box_tests, pair_tests, in_range = (int(x) for x in want[4].sum(dim=0).tolist())
        r = o.x.numel()
        flops = box_tests * SLAB_FLOPS + pair_tests * PAIR_T_FLOPS + in_range * BARY_FLOPS
        nbytes = 24 * r + 16 * (-(-r // vs.TILE))
        bounds[case] = max(nbytes / PEAK_BYTES, flops / PEAK_FLOPS) * 1e3
        s = vs.summary(want)
        log(f"[work] stats {case[0]} depth {case[1]} seed {case[2]}: {r} rays; nodes/tile "
            f"{s['nodes_mean']:.2f}, leaves/tile {s['leaves_mean']:.2f} (max "
            f"{s['leaves_max']:.0f}), overlap {s['overlap_frac']:.4f}; {box_tests} box tests, "
            f"{pair_tests} pair tests, {in_range} in range; bound {bounds[case]:.4f} ms")
    ms = in_turns(list(libs), cases, run)
    for name in libs:
        log(f"[time] stats {name}: " + ", ".join(
            f"{n} d{dep}{' seeded' if k else ''} {min(x):.4f}/{max(x):.4f}"
            for (n, dep, k), x in ms[name].items()))
    log("[time] stats bound (its work counts: 26 a box test, 15 a pair test, 30 in range, at "
        "67 TFLOP/s): " + ", ".join(f"{n} d{dep}{' seeded' if k else ''} {b:.4f}"
                                    for (n, dep, k), b in bounds.items()))


def k1_launches(device):
    """The Cornell box's leaf-32 ``"wide"`` tree and K1's launches of
    ``chip_smoke.py`` phase 4 at 1080p: the primary rays and the sorted,
    gated depth-2 head."""
    import torch

    from heatray_tpu_torch import cornell_box, orbit_camera
    from heatray_tpu_torch.options import FrameGlobals, RenderOptions
    from heatray_tpu_torch.render import integrator

    opts = RenderOptions(width=WIDTH, height=HEIGHT, max_render_passes=64, max_ray_depth=4,
                         wide_leaf_size=32)
    scene = cornell_box(light="both", with_spheres=True).to(device)
    camera = orbit_camera(WIDTH, HEIGHT, distance=6.2, focal_length_mm=35.0).to(device)
    ctx = integrator.make_context(opts, scene, device)
    pack = ctx.accel_pack
    primary = integrator.start_paths(camera, ctx, opts, 0)
    first, _ = integrator.bounce(scene, ctx, opts, FrameGlobals.create(0, device=device), 1,
                                 primary, pack)
    paths = integrator._sort_paths(first, *integrator._sort_bounds(pack))
    head = paths.map(lambda p: p[:integrator._gated_lanes(paths, opts.gate_segments)])
    torch.cuda.synchronize()
    return pack.wide, {"primary": primary, "head": head}


def profile_nodes(libs) -> None:
    """``nodes_kernel``'s variants and the parent beside K1 on K1's two
    Cornell launches at leaf 32 (``k1_launches``): t and each ray's visits
    of ``shipped`` and ``smem-rows`` equal to the parent's (or, without one,
    the shipped kernel's), ``known-hit``'s t equal to K1's and its visits at
    most the shipped kernel's on every ray; then timed in turns with K1, and
    K1's time split: K1 less ``known-hit`` the leaf service, the shipped walk
    less ``known-hit`` the cull a known hit saves, the shipped walk less
    ``smem-rows`` the node loads' latency."""
    import torch

    from heatray_tpu_torch.ops import wide_bvh as wb
    from heatray_tpu_torch.ops.intersect import MISS_T
    from heatray_tpu_torch.probes import kernel_probe as kp

    bvh, rays = k1_launches(torch.device("cuda:0"))
    k1_t = {what: wb.intersect_closest_wide(bvh, p.org, p.direction)[0] for what, p in rays.items()}
    tiles = {"known-hit": 256, "smem-rows": bvh.num_nodes, "shipped": 256, "parent": 256}
    t_in = {what: t.clone() for what, t in k1_t.items()}

    def run(name, what):
        p = rays[what]
        if name == "K1":
            return wb.intersect_closest_wide(bvh, p.org, p.direction)
        return kp._launch_nodes(libs[name], bvh, p.org, p.direction, tiles[name], 1e-4,
                                t=t_in[what] if name == "known-hit" else None)

    ref = "parent" if "parent" in libs else "shipped"
    log(f"[rays] nodes: primary {rays['primary'].org.x.numel()}, head "
        f"{rays['head'].org.x.numel()}; {bvh.num_nodes} nodes "
        f"({bvh.num_nodes * _NODE_ROW_BYTES} bytes of rows), {bvh.num_chunks} leaves of "
        f"{bvh.leaf_size}")
    visits = {}
    for what in rays:
        want = run(ref, what)
        for name in libs:
            t, v = run(name, what)
            visits[name, what] = v
            if name == "known-hit":
                ok = torch.equal(t, k1_t[what]) and bool((v <= run("shipped", what)[1]).all())
            else:
                ok = bool((t == MISS_T).all()) and torch.equal(v, want[1])
            log(f"[check] nodes {what} {name}: {'as required' if ok else 'DIFFERS'}; visits a "
                f"ray mean {float(v.double().mean()):.3f}, max {int(v.max())}")
            if not ok and name != "parent":
                raise AssertionError(f"nodes {name} on {what} differs")
    from chip_smoke import PEAK_BYTES, PEAK_FLOPS, SLAB_FLOPS, walk_work

    for what, p in rays.items():
        r = p.org.x.numel()
        for label, t_far in (("no far end", torch.full_like(k1_t[what], MISS_T)),
                             ("known hit", k1_t[what])):
            work = walk_work(bvh, p.org, p.direction, t_far, with_leaves=False)
            bound = max((work["tree_bytes"] + 32 * r) / PEAK_BYTES,
                        work["boxes"] * SLAB_FLOPS / PEAK_FLOPS) * 1e3
            log(f"[bound] nodes {what}, {label}: {work['reached']}, {work['boxes'] / r:.3f} box "
                f"tests a ray -> {bound:.4f} ms (the rays, the outputs and the nodes reached at "
                f"3.35 TB/s; 26 FLOP a box test at 67 TFLOP/s)")
    names = [*libs, "K1"]
    ms = in_turns(names, list(rays), run)
    for name in names:
        log(f"[time] nodes {name}: " + ", ".join(f"{what} {min(x):.4f}/{max(x):.4f}"
                                                 for what, x in ms[name].items()))
    for what in rays:
        k1, known, walk = (min(ms[n][what]) for n in ("K1", "known-hit", "shipped"))
        smem = min(ms["smem-rows"][what])
        log(f"[split] K1 on {what}: {k1:.4f} ms; the walk knowing its hit (known-hit) {known:.4f}, "
            f"so the leaf service {k1 - known:.4f} ({(k1 - known) / k1:.0%}); the walk with no "
            f"far end (shipped) {walk:.4f}, so a known hit's cull saves {walk - known:.4f}; node "
            f"rows in shared memory (smem-rows) {smem:.4f}, so the node loads' latency "
            f"{walk - smem:.4f}")


def _kernel_geometry(fn, trace: Path) -> list:
    """(kernel name, grid, block) of each kernel ``fn`` launches, from the
    profiler's trace."""
    import json

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    return [(e["name"][:60], e["args"].get("grid"), e["args"].get("block"))
            for e in events if e.get("cat") == "kernel"]


def profile_grid(libs) -> None:
    """``empty_kernel``'s variants, the parent and ``torch.mul(x, 0.0)`` on
    the x plane of the Cornell box's 1080p primary rays (``chip_smoke.py``
    phase 17's): each build's output bit for bit equal to ``x * 0`` there,
    on an unaligned view, on 1, 3 and 8,191 floats and on the special
    values; then, in turns at each of GRID_TILES, the device time a call
    from CUDA-graph replays of 10 calls on one input (which stays in the
    50 MB L2), into one output or each into a new one (as the wrapper and
    ``torch.mul`` allocate it), and of 2 x GRID_COPIES calls over
    GRID_COPIES inputs and outputs (133 MB), each beside the 16.6 MB bound; and ``torch.mul``'s and
    ``empty_kernel``'s grid and block from the profiler's trace."""
    import torch

    from chip_smoke import PEAK_BYTES, time_ms
    from heatray_tpu_torch.probes import cornell
    from heatray_tpu_torch.render import integrator

    device = torch.device("cuda:0")
    _, camera, opts, ctx = cornell(WIDTH, HEIGHT, 4, device)
    x = integrator.start_paths(camera, ctx, opts, 0).org.x.contiguous()
    n = x.numel()

    def call(name, src, out, rt=256):
        """x * 0 of ``src`` into ``out``, or into a new tensor (as the
        wrapper and ``torch.mul`` allocate it) where ``out`` is None."""
        if name == "torch.mul":
            return torch.mul(src, 0.0) if out is None else torch.mul(src, 0.0, out=out)
        out = torch.empty_like(src) if out is None else out
        stream = torch.cuda.current_stream(device).cuda_stream  # a graph captures on its own
        err = libs[name].probe_empty(src.data_ptr(), src.numel(), rt, out.data_ptr(), stream)
        if err:
            raise RuntimeError(f"grid {name}: launch refused ({err})")
        return out

    special = torch.tensor([-1.0, -0.0, 0.0, float("inf"), -float("inf"), float("nan"), 3e37,
                            -3e37], device=device)
    inputs = {"rays": x, "rays[1:]": x[1:], "n=1": x[:1], "n=3": x[5:8], "n=8191": x[3:8194],
              "special": special.repeat(1025)[1:]}
    for name in [*libs, "torch.mul"]:
        for label, src in inputs.items():
            for rt in GRID_TILES:
                got = call(name, src, torch.empty_like(src), rt)
                want = src * 0.0
                same = torch.equal(got.view(torch.int32), want.view(torch.int32))
                if not same:
                    raise AssertionError(f"grid {name} {label} rt {rt}: differs from x * 0 bit "
                                         f"for bit on {int((got.view(torch.int32) != want.view(torch.int32)).sum())} floats")
        log(f"[check] grid {name}: x * 0 bit for bit on {', '.join(inputs)}, at tiles "
            f"{GRID_TILES}")
    bound = 8 * n / PEAK_BYTES * 1e3
    copies = [(x.clone(), torch.empty_like(x)) for _ in range(GRID_COPIES)]
    one = (x, torch.empty_like(x))

    def graph_ms(fns):
        for fn in fns:
            fn()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for fn in fns:
                fn()
        return time_ms(graph.replay, 5) / len(fns)

    names = [*libs, "torch.mul"]
    whats = [(rt, mode) for rt in GRID_TILES for mode in ("L2", "L2 new out", "rotating")]

    def run(name, what):
        rt, mode = what
        pairs = {"L2": [one] * 10, "L2 new out": [(x, None)] * 10, "rotating": copies * 2}[mode]
        return graph_ms([lambda s=s, o=o: call(name, s, o, rt) for s, o in pairs])

    ms = {name: {what: [] for what in whats} for name in names}
    for name in names + names[::-1]:
        for what in whats:
            ms[name][what].append(run(name, what))
    log(f"[bound] grid on {n} floats: {8 * n / 1e6:.1f} MB -> {bound:.4f} ms (bytes)")
    for name in names:
        log(f"[time] grid {name}, device ms a call: " + ", ".join(
            f"rt {rt} {mode} {min(v):.4f}/{max(v):.4f} ({bound / min(v):.0%} of the bound)"
            for (rt, mode), v in ms[name].items()))
    # Through the wrappers, as chip_smoke.py phase 17 reads them: this
    # tree's kernel_probe.empty and torch.mul, each allocating its output.
    from heatray_tpu_torch.probes import kernel_probe as kp
    from heatray_tpu_torch.vec import Vec3

    v = Vec3(x, x, x)
    wrappers = {"kernel_probe.empty": lambda: kp.empty(v), "torch.mul": lambda: torch.mul(x, 0.0)}
    got = {name: [] for name in wrappers}
    for name in [*wrappers, *reversed(wrappers)]:
        got[name].append(graph_ms([wrappers[name]] * 10))
    log(f"[time] grid through the wrappers, device ms a call from L2 (x {x.data_ptr() % 16} bytes "
        f"past a 16-byte boundary): " + ", ".join(f"{name} {min(t):.4f}/{max(t):.4f}"
                                                for name, t in got.items()))
    OUT.mkdir(parents=True, exist_ok=True)
    for name, fn in (("torch.mul", lambda: torch.mul(x, 0.0)),
                     ("shipped", lambda: call("shipped", x, one[1])),
                     *((("parent", lambda: call("parent", x, one[1])),) if "parent" in libs else ())):
        log(f"[geometry] grid {name}: " + "; ".join(
            f"{k} grid {g} block {b}" for k, g, b in _kernel_geometry(fn, OUT / "grid_trace.json")))


def profile_k4(libs, trees, rays, eps) -> None:
    """K4a's and K4b's variants (and the parent's, which takes no block
    boxes) over ``high_poly``'s leaf-128 trees on phase 7's four launches:
    each checked against the plain version on N_CHECK seeded lanes of each
    launch and against the shipped kernel on every lane, then timed in
    turns."""
    from heatray_tpu_torch.ops import wide_bvh as wb

    def run(name, what):
        lib = libs[name]
        ray, t_max = rays[what]
        bvh = trees[t_max is not None]
        fn = lib.any_stream_t if t_max is not None else lib.closest_stream_t
        depth = lib.stream_t_stack_depth()
        tree = wb._block_tree_args(bvh, depth) if fn.blocks else wb._tree_args(bvh, depth)
        if t_max is None:
            return wb.launch_closest(fn, tree, bvh, ray.org, ray.direction, eps)[:2]
        return (wb.launch_any(fn, tree, bvh, ray.org, ray.direction, eps, t_max),)

    plain = plain_picks(rays, lambda what, o, d, t_max: (
        wb.closest_stream_plain(trees[0], o, d, eps)[:2] if t_max is None else
        (wb.any_stream_plain(trees[1], o, d, eps, t_max),)))
    check_variants("K4", libs, list(rays), run, plain)
    ms = in_turns(list(libs), list(rays), run)
    for name in libs:
        log(f"[time] K4 {name}: " + ", ".join(
            f"{what} {min(v):.4f}/{max(v):.4f}" for what, v in ms[name].items()))


def profile_k7(libs, chunks, rays, eps) -> None:
    """K7a's and K7b's variants on the rebuild mode's chunk packs: checked
    bit for bit against the shipped kernel, timed in turns (K7a for every
    variant, K7b for those of K7B_VARIANTS), and K7a's pair tests of the
    ``count`` variant set beside ``chunk_work``'s."""
    import torch

    from chip_smoke import chunk_work
    from heatray_tpu_torch.ops import intersect_pallas as ip
    from heatray_tpu_torch.ops.intersect_pallas import BLOCK
    from heatray_tpu_torch.ops import wide_bvh as wb

    def run(name, what):
        lib = libs[name]
        ray, t_max = rays[what]
        packed = chunks[t_max is not None]
        fn = lib.any_chunks if t_max is not None else lib.closest_chunks
        args = ip._pack_args(packed)
        args = args if fn.blocks else args[1:]
        if t_max is None:
            return wb.launch_closest(fn, args, packed, ray.org, ray.direction, eps)[:2]
        return (wb.launch_any(fn, args, packed, ray.org, ray.direction, eps, t_max),)

    families = {"K7a": (list(libs), ["primary", "head"]),
                "K7b": ([n for n in K7B_VARIANTS if n in libs], ["shadow", "head shadow"])}
    for kernel, (names, whats) in families.items():
        ref = {what: run("shipped", what) for what in whats}
        for name in names:
            differ = {}
            for what in whats:
                same = torch.ones_like(ref[what][0], dtype=torch.bool)
                for a, b in zip(run(name, what), ref[what]):
                    same &= a == b
                differ[what] = int((~same).sum())
            log(f"[check] {kernel} {name}: lanes whose results differ from shipped: {differ}")
            if name != "parent" and any(differ.values()):
                raise AssertionError(f"{kernel} variant {name} differs from the shipped kernel")
        torch.cuda.synchronize()
        ms = in_turns(names, whats, run)
        for name in names:
            log(f"[time] {kernel} {name}: " + ", ".join(
                f"{what} {min(v):.4f}/{max(v):.4f}" for what, v in ms[name].items()))

    if "count" in libs:
        lib = libs["count"]
        counts = (ctypes.c_ulonglong * 4)()
        tc = chunks[0].tri_chunk
        for what in ("primary", "head"):
            ray, _ = rays[what]
            if lib.chunk_counts_clear():
                raise RuntimeError("chunk_counts_clear failed")
            t_far = run("count", what)[0]
            torch.cuda.synchronize()
            if lib.chunk_counts_read(counts):
                raise RuntimeError("chunk_counts_read failed")
            served, lane_groups, ray_groups, lane_rays = list(counts)
            work = chunk_work(chunks[0], ray.org, ray.direction, t_far, eps, blocks=True)
            r = ray.org.x.numel()
            log(f"[pairs] K7a {what} ({r} rays): {served} (ray, block) services, "
                f"{served * BLOCK / r:.1f} pair tests a ray ({served / r:.3f} blocks); "
                f"chunk_work with blocks {work['block_entries'] * BLOCK / r:.1f} a ray "
                f"({work['pairs'] / r:.1f} on filled columns): "
                f"{served / max(work['block_entries'], 1):.4f}x; whole chunks "
                f"{work['entries'] * tc / r:.1f} a ray ({work['entries'] / r:.3f} chunks); "
                f"groups ray per lane {lane_groups} ({lane_rays / max(lane_groups, 1):.2f} rays "
                f"a group), one ray at a time {ray_groups} "
                f"({(served - lane_rays) / max(ray_groups, 1):.2f})")


def sass(so: Path) -> dict:
    """K label -> the kernel's SASS instructions (``cuobjdump -sass``), each
    without its address and encoding."""
    from heatray_tpu_torch.ops import cuda_build

    tool = Path(cuda_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    out, kernel = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            kernel = kernel_label(m.group(1))
            if kernel:
                out[kernel] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*(/\*.*)?$", line)
        if kernel and m:
            out[kernel].append(m.group(1))
    return out


def compare_sass(pairs) -> None:
    """One [sass] line per kernel of each (shipped .so, parent .so) pair."""
    for mine, parent in pairs:
        a, b = sass(mine), sass(parent)
        for kernel in sorted(set(a) | set(b)):
            if kernel not in a or kernel not in b:
                log(f"[sass] {kernel}: only in {'this tree' if kernel in a else 'the parent'}")
                continue
            x, y = a[kernel], b[kernel]
            ops = difflib.SequenceMatcher(None, y, x, autojunk=False).get_opcodes()
            changed = sum(max(i2 - i1, j2 - j1) for tag, i1, i2, j1, j2 in ops if tag != "equal")
            log(f"[sass] {kernel}: {len(x)} instructions, parent {len(y)}; "
                + ("equal, instruction for instruction" if x == y else
                   f"{changed} changed, inserted or removed (difflib)"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", default=",".join(FAMILIES),
                    help="which families to profile: any of k1 (K1/K2), k4 (K4a/K4b), k5 "
                         "(K5a/K5b), k6 (K6a/K6b), k7 (K7a/K7b), brute (rows_brute_kernel and "
                         "warp_brute_kernel), walk (variant_walk_kernel), queue "
                         "(queue_walk_kernel), grid (empty_kernel), stats "
                         "(visit_stats_kernel) and nodes (nodes_kernel), comma-separated "
                         "(default: all eleven)")
    ap.add_argument("--parent", type=Path,
                    help="another tree whose wide_bvh.cu, wide_bvh_t.cu, bvh2.cu, chunks.cu, "
                         "probes.cu and variants.cu to time too, and whose kernels' SASS to "
                         "compare")
    args = ap.parse_args()
    families = set(args.kernels.split(","))
    if not families or families - set(FAMILIES):
        raise SystemExit(f"--kernels takes {', '.join(FAMILIES)}, not {args.kernels!r}")

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_wide: needs an NVIDIA card")
    sys.path.insert(0, str(REPO))
    from chip_smoke import card_line

    card = card_line()
    log(card)
    tables = {"k1": (VARIANTS, _K1), "k4": (K4_VARIANTS, _K5), "k5": (T_VARIANTS, _K5),
              "k6": (K6_VARIANTS, _K6), "k7": (CHUNK_VARIANTS, _K7),
              "brute": ({**BRUTE_VARIANTS, **WARP_VARIANTS}, _PROBES),
              "walk": (WALK_VARIANTS, _WALK), "queue": (QUEUE_VARIANTS, _WALK),
              "grid": (GRID_VARIANTS, _PROBES), "stats": (STATS_VARIANTS, _PROBES),
              "nodes": (NODES_VARIANTS, _PROBES)}
    sources = {}  # (family, name) -> source
    for family in sorted(families):
        variants, target = tables[family]
        for name, (_, edits) in variants.items():
            sources[family, name] = variant_source(f"{family}-{name}", edits, target)
        if args.parent:
            sources[family, "parent"] = (args.parent.resolve() / "heatray_tpu_torch" / "csrc"
                                         / target)
    # The sources whose every kernel's SASS is set beside the parent's.  A
    # file no family builds is built alone.
    sass_files = {"k1": _K1, "k3": _K3, "k5": _K5, "k6": _K6, "k7": _K7, "brute": _PROBES,
                  "walk": _WALK}
    shipped_of = {}  # file -> the family whose "shipped" and "parent" build it
    for family, target in sorted(sass_files.items()) if args.parent else ():
        have = next((f for f in sorted(families) if tables[f][1] == target), None)
        if have is None:
            have = f"sass-{family}"
            sources[have, "shipped"] = variant_source(f"{have}-shipped", [], target)
            sources[have, "parent"] = args.parent.resolve() / "heatray_tpu_torch" / "csrc" / target
        shipped_of[target] = have
    with ThreadPoolExecutor(len(sources)) as pool:
        built = dict(zip(sources, pool.map(
            lambda key: compile_lib("-".join(key), sources[key]), sources)))
    libs = {family: {} for family in tables}
    for (family, name), (so, report) in built.items():
        variants = tables.get(family, ({}, None))[0]
        what = variants[name][0] if name in variants else f"{sources[family, name]} as it stands"
        log(f"[build] {family} {name} ({what}): {resources(report)}")
        if so is None:
            raise RuntimeError(f"{family} {name} did not build")
        if family in libs:
            libs[family][name] = library(so, sources[family, name])
    if args.parent:
        compare_sass([(built[f, "shipped"][0], built[f, "parent"][0])
                      for f in shipped_of.values()])
    for (family, name), (so, _) in built.items():
        if family == "brute":
            code = sass(so)
            log(f"[sass] brute {name}: rows_brute_kernel {len(code['P1/P4 rows_brute'])}, "
                f"warp_brute_kernel {len(code['P4 warp_brute'])} instructions")
        elif family in ("walk", "queue"):
            kernel = {"walk": "variant_walk", "queue": "queue_walk"}[family]
            code = {k: v for k, v in sass(so).items() if k.startswith(f"P2 {kernel}")}
            log(f"[sass] {family} {name}: {kernel}_kernel " + ", ".join(
                f"{k[len(f'P2 {kernel}'):]} {len(v)}" for k, v in sorted(code.items()))
                + " instructions")

    device = torch.device("cuda:0")
    if libs["k1"] or libs["k5"] or libs["k6"] or libs["k7"]:
        trees, chunks, binaries, rays, eps = launches(device)
        if libs["k1"]:
            profile_k1(libs["k1"], trees, rays, eps)
        if libs["k5"]:
            profile_k5(libs["k5"], trees, rays, eps)
        if libs["k6"]:
            profile_k6(libs["k6"], binaries, rays, eps)
        if libs["k7"]:
            profile_k7(libs["k7"], chunks, rays, eps)
        del trees, chunks, binaries, rays
    if libs["brute"]:
        profile_brute(libs["brute"])
    if libs["walk"]:
        profile_walk(libs["walk"])
    if libs["queue"]:
        profile_queue(libs["queue"])
    if libs["grid"]:
        profile_grid(libs["grid"])
    if libs["stats"]:
        profile_stats(libs["stats"])
    if libs["nodes"]:
        profile_nodes(libs["nodes"])
    if libs["k4"]:
        hp_trees, hp_rays, eps = hp_launches(device)
        profile_k4(libs["k4"], hp_trees, hp_rays, eps)
    log(f"[card] {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
