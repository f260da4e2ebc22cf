#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (heatray_tpu_torch) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the kernels of ``heatray_tpu_torch/csrc``, one ``nvcc`` per
source, and the host library ``csrc/native.cpp`` (g++), all started
together, and then:

1. checks K1 and K2 (``wide_bvh.cu``) against their plain PyTorch versions
   on the card: on the Cornell box, each kernel launched at the shapes a
   1080p pass gives it (see 5), and on a 50,000-triangle random soup at leaf
   32.  K1/K2 walk the tree once per ray and share only the leaf tests
   across the warp (K3's walk), so no slot may differ at all;
2. renders the golden configuration config2 (48x48, 4 passes, depth 4) and
   compares it with ``tests/goldens/config2_cornell.npy``;
2b. renders one 1080p Cornell pass with the bounce sort and segment gating
   on and one with both off, twice each, and requires equal accumulations;
3. renders the Cornell path, 1920x1080, depth 4, 4 passes (sorted and
   gated, as "auto" gives on the card), counting kernel launches, and
   reports ms per pass and Mrays/s;
3c. takes ``bench.py``'s fwd+bwd step on the same scene: a context made with
   ``static_shading=False`` (each pass builds its slot-ordered shading table
   from the scene it is given) must render a pass without autograd equal,
   bit for bit, to one through phase 1's baked table; the step is
   ``mean(img^2)`` of one pass, with ``base_color`` and ``roughness`` as
   leaf tensors through ``diff.inverse.apply_material_params``.  Its
   gradients must be finite, ``base_color``'s nonzero on every material
   the primary rays hit and ``roughness``' on the metal sphere (material
   5); K1 and K2 must run once per bounce with live lanes in the forward and
   never in the backward.  It times the step (one warm-up, then the slope
   over 1 and 5 steps, as ``bench.py`` does) with ``remat_bounces`` on and
   off in turns, with the step's peak device memory, and holds the card's
   gradients at 24x24, depth 2 against the CPU's (within 1e-3 of each
   key's largest |g|) and, on the card, sorted and gated against unsorted
   (32x32, depth 3, 16 segments, so that the gate cuts lanes; rtol 1e-5,
   atol 1e-8);
4. checks K1 and K2 against their plain versions again on all 2,073,600
   rays of a 1080p bounce (no slot may differ), and times both there and on
   phase 1's depth-2 sorted head and its shadow lanes, beside K3's kernels
   over the same leaf-32 tree on the same four launches;
5. builds the ~300k-triangle ``high_poly`` scene on the card (the context
   picks the streaming backend on its own) and checks K3a and K3b
   (``wide_bvh_stream.cu``) against their plain versions.  Each kernel is
   launched at the shapes the path gives it: all 2,073,600 primary rays,
   the first bounce's shadow lanes, and the second bounce's sorted, gated
   head and its shadow lanes.  The plain version runs on 65,536 seeded live
   lanes of each launch, and on the 50,000-triangle soup at leaf 128.  K3
   walks the tree once per ray and shares only the leaf tests across the
   warp, so a ray's result does not depend on which rays share its warp:
   no slot may differ at all;
6. renders the ``high_poly`` path, 1920x1080, depth 4, 4 passes, framed as
   ``bench.py`` frames it, counting kernel launches: each kernel runs once
   per bounce that has live lanes, and the script counts those bounces;
7. times K3a and K3b on all 2,073,600 primary rays and first-bounce shadow
   lanes (their plain versions on the 65,536-ray sample) and on phase 5's
   depth-2 sorted head and its shadow lanes; beside them, on the same four
   launches, K4a/K4b over the same leaf-128 tree (the same walk per ray as
   K3, served by block boxes of 32), and K1 and K2 over a
   32-triangle-leaf tree of the scene;
8. checks K7a and K7b (``chunks.cu``) in the rebuild mode (a context made
   without a scene: every pass rebuilds the Woop rows, the 512-triangle
   chunk packs and the shading table) and K6a and K6b (``bvh2.cu``) under
   ``intersect_backend="bvh"`` against their plain versions, each launched
   at the shapes the 1080p Cornell path gives it (as in 5), and on the
   50,000-triangle soup; K7a and K6a to every t and every id equal, bit
   for bit, K7b and K6b to equal masks;
9. renders config2 through the rebuild mode, ``"pallas"`` and ``"bvh"`` and
   compares each with the golden;
10. renders the Cornell path (as in 3) in the rebuild mode and under
   ``"bvh"``, counting launches (each new kernel once per bounce with live
   lanes, no K1-K3) and timing the rebuild within each pass, and compares
   each image with phase 3's ``"wide"`` image of the same passes;
11. times K7a, K7b, K6a and K6b on phase 4's rays, and their plain
   versions on all of them; one ``[compare]`` line sets K6a and K6b beside
   K1 and K2 over phase 4's leaf-32 trees on phase 4's four launches (the
   primary rays, the first-bounce shadow lanes, the sorted depth-2 head and
   its shadow lanes), and gives K6's entries their head readings;
12. checks K5a and K5b (``wide_bvh_t.cu``) under Route A (the Cornell box
   with ``wide_leaf_math="vpu"``: "auto" keeps "wide" and rounds the leaf of
   32 up to 128) against their plain versions, at the shapes the 1080p path
   gives them (as in 5), and on the 50,000-triangle soup at leaf 128: hit
   masks equal, K5a's t and every slot bit for bit, K5b's masks equal (K5a
   and K5b walk per ray, culled by the tree's block boxes, as K4 does);
13. renders Route A (as in 3), counting launches (K5a and K5b once per
   bounce with live lanes, no other traversal kernel), and compares its
   image with phase 3's ``"wide"`` image of the same passes;
14. the same for K4a and K4b (``wide_bvh_t.cu``) under Route B (``high_poly``
   with ``stream_leaf_math="vpu"``, leaf 128; the tree's stack depth is
   logged beside the kernels' 64): their checks at the path's shapes and on
   the soup (K4a's t and every slot bit for bit, K4b's masks equal), the
   path, and its image against phase 6's ``"stream"`` image;
15. times K5a and K5b on phase 4's rays; one ``[compare]`` line sets them
   beside K1 and K2 over the leaf-32 trees and K4b over Route A's own
   occluder tree on phase 4's four launches, and gives K5's entries their
   head readings; and times K4a and K4b on phase 7's four launches for the
   kernels line (phase 7 sets them beside K3a and K3b over the same tree);
16. runs the P3 probe (``heatray_tpu_torch.probes.visit_stats``, kernel
   ``visit_stats_kernel`` of ``probes.cu``) through its entry point: the
   Cornell box over its leaf-32 ``"wide"`` tree on the 1080p primary rays
   and the unsorted bounces 2-4, plain and seeded, and ``high_poly`` over
   phase 5's leaf-128 tree on its primary rays and first bounce; on 64
   seeded whole tiles of each wavefront the plain walk must give the same
   node, leaf and improving counts, overlap sums within 1e-6 relative, and
   the same work counts (``visit_stats(work=True)``: box tests, pair tests,
   pairs in range), from which each wavefront's bound is made; one
   ``[compare]`` line per Cornell depth sets P3's ms beside that bound;
17. runs the P1 probe (``probes.kernel_probe``: ``grid``, ``nodes`` and
   ``leaves``, with K1 as ``full``) on the 1080p Cornell primary rays at
   leaf {32, 64, 128} x tile {256, 512, 1024}; each probe is checked
   against its plain version on N_CHECK seeded lanes (``nodes``: t and
   visit counts equal; ``leaves``: hit masks equal, t within TOL, and
   equal to the tree's brute force ``closest_wide_plain``); ``grid`` is
   also timed a call beside ``torch.mul(x, 0.0)``, with the device time of
   each alone (a CUDA-graph replay, on one input and over GRID_COPIES
   inputs in turn, past the L2) and its host path taken apart;
18. runs the P4 probe (``probes.vpu_leaf``: the row and warp-transposed
   brute force) at tc {128, 256, 512} x tile {256, 512}, each layout
   against the plain brute force on N_CHECK seeded lanes and against the
   other on all rays (agreement, and t equal bit for bit); one
   ``[compare]`` line sets ``warp_brute_kernel``'s ms at tc 128, tile 256
   beside its share of the bound and beside ``rows_brute_kernel``'s;
19. runs the P2 probe (``probes.kernel_variants``, kernels of
   ``variants.cu``) on the 1080p Cornell box's sorted depth-2 wavefront
   over the leaf-32 tree: ``v0``-``v4`` at tiles 512 and 1024 (v4 at group
   32 and 128), v6 and v7 at batch 4 and 8, v8 at batch 8 and 16 x tiles
   512, 1024 and 2048, and K1 on the same rays; each case is held against
   its plain version on P2_TILES seeded whole tiles (the last, partial one
   among them): hit masks equal, t within TOL, slots equal (all -1 for
   v3); and the tests per tile must show v2 and v3 walking as v0, v1 more,
   v4 no more, and v0 equal to K1 bit for bit; a ``[compare]`` line sets
   ``variant_walk_kernel``'s v0 at tile 512 beside its share of K1's bound
   and of its own work bound (its ray-chunk tests x the chunk's columns x
   a pair's t) and beside K1 on the same rays, and a ``[compare] P2b-d``
   line sets each ``queue_walk_kernel`` anchor's ms at its entry's case
   beside the same two shares;
20. the appearance slice, through K1/K2: Scene A (``multi_material`` lit
   by the 2k procedural studio map) and Scene B (the same layout with
   2048x2048 base-colour, normal and metallic-roughness textures on the
   ground, clearcoat 1.0 with a 1024x1024 clearcoat-normal map on the metal
   sphere and a double-sided alpha-masked 1024x1024 cut-out quad before the
   glass sphere; mips on, so the ray cones pick levels), each at 1920x1080,
   depth 5: K1/K2 against their plain versions at the path's shapes (as in
   5), 4 passes through ``render_pass`` (only K1/K2 may run, once per bounce
   with live lanes) with the steady ms/pass, Mrays/s, the kernels of one
   pass under the profiler and the peak device memory; sorted and gated
   equal to unsorted bit for bit; the ACES display image on the card equal
   to the same call on the CPU within POST_TOL.  Scene B must differ from A,
   and from B with every texel's alpha at 1 (the pass-through ran).  Then
   one 1080p pass of each of AOV_MODES on Scene B (finite; the NaN and Inf
   detectors under the clean ceiling of ``tests/test_goldens.py``), goldens
   config3 and config5 on the card against their goldens and the CPU's
   render (within CPU_TOL), and one fwd+bwd step over ``env.map`` and
   ``env.rotation`` on Scene A (remat on: gradients finite, the map's
   nonzero; K1/K2 in the forward only), with its ms and peak memory.  K6a
   and K6b under ``intersect_backend="bvh"`` on Scene B, against their
   plain versions at the path's shapes (as in 5): K6b walks the occluder
   tree built without the cut-out quad (``build_bvh(include=...)``), whose
   block boxes bound the included triangles alone;
21. the ingest slice, from model files to images through ``cli``:
   ``high_poly``'s 298,766 triangles written (``scene.export``) as a binary
   PLY, as an OBJ with one ``usemtl`` group per material and its MTL, and as
   a GLB with an embedded PNG texture and its sun as a
   ``KHR_lights_punctual`` light, and the Cornell box as OBJ+MTL; each file
   loaded through ``load_model_scene`` (host seconds per format) to the
   built-in's triangle count and triangle set.  The PLY (K3a/K3b) and the
   Cornell OBJ (K1/K2) are rendered at 1920x1080, depth 4, 4 passes under
   the built-in INGEST_ENV map through ``cli.main(["render", ..., "--out",
   "<dir>/x.exr"])`` with the launch counts set to 0 just before and read
   just after (each kernel once per bounce with live lanes, no other);
   their kernels are held against their plain versions at the path's
   shapes (as in 5); the EXR read back must equal a direct ``render`` of
   the same scene rounded to half, bit for bit; the path's steady ms/pass,
   Mrays/s, kernels per pass and peak memory are taken as in 3; and its
   image is compared with the built-in's geometry under the file's
   materials and light (at most IMAGE_SHARE of the pixels off by more than
   IMAGE_TOL).  Then a session file naming the PLY, with its Scene group's
   yaw and scale set, is loaded and rendered (finite, non-black), and its
   context's tree, block boxes included, must equal a fresh build over the
   edited triangles; a render checkpointed after 2 passes
   (``save_render_state``) and resumed for 2 more must equal the 4 straight
   passes bit for bit; and ``render.png`` is written by ``save_ldr`` and
   read back with PIL blocked.  The host library (``native.py``, built by
   g++ from ``csrc/native.cpp``): on ``high_poly`` the leaf-32 tree, the
   leaf-128 tree and a leaf-128 occluder tree over a seeded include mask
   are built by ``build_topology`` and by its numpy twin
   ``build_topology_plain`` and must be equal field for field; Morton order
   must equal ``morton_order_plain``, and the normals must lie within
   NATIVE_NORMAL_TOL of ``compute_vertex_normals_plain``; the host seconds
   of each are logged with the host CPU's model.  ``load_model_scene`` and
   ``make_context`` of ``hp.ply``, ``hp.obj`` and ``hp.glb``, and the PLY's
   ``cli render``, are split into their host steps (``HostSplit``: parse,
   normals, merge, Morton order, tree build, wide collapse and packing,
   block boxes, shading table, sample and multiscatter tables, passes,
   output);
22. the live preview and edit loop: ``interactive.InteractiveRenderer`` with
   ``interactive_block`` on the Cornell box at 1920x1080, depth 4, served
   by ``viewer.ProgressiveViewer`` on 127.0.0.1, port 0.  K1/K2 against
   their plain versions on a block pass's lanes (block INTERACTIVE_BLOCK,
   as in 5); nine block passes through the loop with the launch counts set
   to 0 just before and read just after (K1 and K2 alone, once per bounce
   with live lanes), equal to one full pass within 1e-5 and covering every
   pixel once; ``/frame.png`` decoded to the published image; the mean of
   TIMED block passes, full passes and publishes after a warm-up; then
   every edit type sent as ``POST /edit`` and applied by ``poll_and_apply``
   (material; a directional light added, edited in part and removed; the
   point light moved; a spot light added, edited and removed; the
   environment; the camera; the display; a transform; the options, to depth
   3 and ``ms_impl="lut"``; an environment and a scene loaded from files),
   each checked to take effect and to reset (``post`` not), with the time
   from the request to the published frame (the transform's split into
   its host steps by ``HostSplit``, as in 21); after the material and the
   transform edits the pass must equal a fresh context's bit for bit, and
   a removal the pass before the light's add;
23. multi-device rendering (``heatray_tpu_torch.parallel``) on the one card,
   every rank on it: one-device references first (the Cornell box at
   1920x1080, depth 4, 2 and 4 passes; ``high_poly`` through
   ``intersect_backend="wide"``, 2 passes; the box at 960x540, 4 passes;
   the train steps' losses and gradients at STEP_W x STEP_H, depth 2);
   then ``render_sharded`` over a one-rank NCCL group in this process, 2
   passes, equal to ``render`` bit for bit; then ranks started with
   ``torch.multiprocessing`` (spawn), which only load the kernels built
   above, over gloo: two ranks render the Cornell rows (540 a rank, 4
   passes, sorted and gated), gathered equal to ``render`` bit for bit on
   each; ``high_poly`` through the ``"sharded"`` backend (one wide tree of
   about 149k triangles a rank; K1/K2 on each rank's tree against their
   plain versions at the path's shapes, as in 5, then 2 passes), the two
   ranks' images equal bit for bit and within IMAGE_SHARE/IMAGE_TOL of the
   one-device ``"wide"`` image, with each rank's ms/pass, peak memory and
   tree bytes beside the monolithic tree's, and its passes timed again at
   torch's default host thread count and at the rank's own (one, as
   ``torchrun`` starts ranks), in turns, each with one more pass whose gloo
   reductions are timed; and one
   ``make_sharded_train_step``; four ranks on a 2x2 ``(sp, dp)`` mesh render
   ``render_sharded_2d`` (within SP_TOL of the serial passes, alpha 4) and
   take one ``make_sharded_train_step_2d``.  Each step's loss and gradients
   (SGD at lr 1.0) lie within STEP_TOL of each key's largest |g| of the
   one-device step's.  Every rank counts its launches around each run: K1
   and K2 alone, once per bounce with live lanes, in the forward only.  A
   rank that fails, or ranks still running after MULTI_TIMEOUT, fail the
   run.  Every time of this phase is taken with its ranks sharing one card.

Each probe phase sets the probe kernels' launch counts to 0 just before
its run and reads them just after; every kernel of the probe must have
run.

Each kernel's bound is the larger of the bytes it must move over the
H100's 3.35 TB/s and the float32 operations its rays need over 67 TFLOP/s.
A plain walk over all the timed rays, knowing each ray's hit distance,
counts both: the bytes of the rays, of the outputs and of the nodes (or
chunk boxes) and leaf triangles the rays reach, each once; the per-ray
arithmetic of the box slab tests, of every pair test's t, and of the
barycentrics of the pairs whose t lies in range.  The chunk kernels test
every chunk's box per ray and, in each chunk a ray enters, every block's
box and the triangles of the blocks it enters (K7b's entry also gives the
bound over whole chunks); K5a, K5b, K4a, K4b and K6a, in each leaf a ray
reaches, every block's box and the triangles of the blocks it enters (their
entries also give the bound over whole leaves).

Any failure raises and exits non-zero.  The last three lines of standard
output are the card's name and power limit, the per-kernel JSON record and
the result JSON.  Without a CUDA device, or outside a checkout, it fails
before printing a result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent
DEVICE = "cuda:0"
SEED = 0
N_CHECK = 65_536
SOUP_TRIANGLES = 50_000
WIDTH, HEIGHT, DEPTH, PASSES = 1920, 1080, 4, 4
TOL = 1e-5  # rtol = atol on t: both sides are exact float32 arithmetic
# K7a, K5a, K4a and K6a: their t must equal the plain version's bit for bit
# (the same float32 operations in the same order), with every id equal.
EXACT_T = ("closest_chunks", "closest_wide_t", "closest_stream_t", "closest_bvh")
# The kernels that cull by block boxes of 32 (the pack's or the tree's), so
# that their bounds count the blocks' work (``chunk_work(blocks=True)``,
# ``walk_work(blocks=True)``, ``bvh2_work(blocks=True)``).
BLOCK_CULLED = ("closest_chunks", "any_chunks", "closest_wide_t", "any_wide_t",
                "closest_stream_t", "any_stream_t", "closest_bvh", "any_bvh")
# Of those, the ones whose entries also give the bound over whole leaves
# (or chunks): the design without block boxes.
WHOLE_BOUND = {"any_chunks": "chunks", "closest_wide_t": "leaves", "any_wide_t": "leaves",
               "closest_stream_t": "leaves", "any_stream_t": "leaves", "closest_bvh": "leaves",
               "any_bvh": "leaves"}
SOURCES = ("wide_bvh", "wide_bvh_stream", "chunks", "bvh2", "wide_bvh_t", "probes", "variants")
# name -> (CUDA source, TPU kernel it replaces)
KERNELS = {
    "closest_wide": ("heatray_tpu_torch/csrc/wide_bvh.cu", "heatray_tpu/ops/wide_bvh.py:297"),
    "any_wide": ("heatray_tpu_torch/csrc/wide_bvh.cu", "heatray_tpu/ops/wide_bvh.py:421"),
    "closest_stream": ("heatray_tpu_torch/csrc/wide_bvh_stream.cu",
                       "heatray_tpu/ops/wide_bvh.py:788"),
    "any_stream": ("heatray_tpu_torch/csrc/wide_bvh_stream.cu", "heatray_tpu/ops/wide_bvh.py:883"),
    "closest_chunks": ("heatray_tpu_torch/csrc/chunks.cu",
                       "heatray_tpu/ops/intersect_pallas.py:282"),
    "any_chunks": ("heatray_tpu_torch/csrc/chunks.cu", "heatray_tpu/ops/intersect_pallas.py:318"),
    "closest_bvh": ("heatray_tpu_torch/csrc/bvh2.cu", "heatray_tpu/ops/traverse_pallas.py:113"),
    "any_bvh": ("heatray_tpu_torch/csrc/bvh2.cu", "heatray_tpu/ops/traverse_pallas.py:164"),
    "closest_wide_t": ("heatray_tpu_torch/csrc/wide_bvh_t.cu", "heatray_tpu/ops/wide_bvh.py:526"),
    "any_wide_t": ("heatray_tpu_torch/csrc/wide_bvh_t.cu", "heatray_tpu/ops/wide_bvh.py:607"),
    "closest_stream_t": ("heatray_tpu_torch/csrc/wide_bvh_t.cu", "heatray_tpu/ops/wide_bvh.py:960"),
    "any_stream_t": ("heatray_tpu_torch/csrc/wide_bvh_t.cu", "heatray_tpu/ops/wide_bvh.py:1059"),
}
# The probe kernels (csrc/probes.cu): name -> (TPU kernel it replaces, the
# other TPU kernel that computes the same function, if any).
PROBE_SOURCE = "heatray_tpu_torch/csrc/probes.cu"
PROBE_KERNELS = {
    "visit_stats": ("tpu_visit_stats.py:68", None),
    "nodes": ("tpu_kernel_probe.py:89", None),
    "rows_brute": ("tpu_kernel_probe.py:126", "tpu_vpu_leaf.py:85"),
    "warp_brute": ("tpu_vpu_leaf.py:134", None),
    "empty": ("tpu_kernel_probe.py:141", None),
}
# P2's kernels (csrc/variants.cu): name -> (TPU kernel it replaces, the case
# whose time stands in the entry).
P2_SOURCE = "heatray_tpu_torch/csrc/variants.cu"
P2_KERNELS = {
    "variant_walk": ("tpu_kernel_variants_probe.py:455", "v0", 512),
    "queue_walk_tile": ("tpu_kernel_variants_probe.py:309", "v6b4", 512),
    "queue_walk_none": ("tpu_kernel_variants_probe.py:85", "v7b4", 512),
    "queue_walk_chunk": ("tpu_kernel_variants_probe.py:201", "v8b8", 512),
}
P2_VARIANTS = ("v0", "v1", "v2", "v3", "v4g32", "v4g128", "v6b4", "v6b8", "v7b4", "v7b8")
P2_QUEUES = {"v6": "queue_walk_tile", "v7": "queue_walk_none", "v8": "queue_walk_chunk"}
P3_TILES = 64  # seeded whole tiles of each wavefront held against the plain walk
P2_TILES = 64
GRID_COPIES = 8  # P1 grid's rotating inputs: 8 x 8.3 MB, past the H100's 50 MB L2
# NVIDIA's H100 SXM data sheet: HBM bytes/s and float32 FLOP/s outside the
# tensor cores.
PEAK_BYTES, PEAK_FLOPS = 3.35e12, 67e12
# float32 operations (wide_bvh_common.cuh) of one child-box slab test, per
# ray: 6 subtracts and 6 multiplies, 12 min/max, the far-end scale and the
# compare (the widening of the box itself depends on the box alone); of a
# pair test's t (two dot products with their offset, the divide, the range
# check); and of its barycentrics, where t lies in range.
SLAB_FLOPS, PAIR_T_FLOPS, BARY_FLOPS = 26, 15, 30
# Bytes of one wide node's record (wbox row, wchild row, waxis), of one
# binary node's (box, meta), of one chunk's box, of one leaf triangle's Woop
# columns (4 rows of b1, b2, s) and of one wide leaf's anchor.
NODE_BYTES, NODE2_BYTES, BOX_BYTES = 8 * 8 * 4 + 8 * 4 + 4, 6 * 4 + 2 * 4, 6 * 4
TRI_BYTES, ANCHOR_BYTES = 4 * 3 * 4, 3 * 4
# Of the full-width images of two routes, at most this share of pixels may
# differ by more than IMAGE_TOL (near-edge ties and the rounding of anchored
# against raw Woop rows change a few paths).
IMAGE_TOL, IMAGE_SHARE = 5e-3, 1e-3


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def queries():
    """name -> (kernel wrapper, plain version)."""
    from heatray_tpu_torch.ops import intersect_pallas as ip
    from heatray_tpu_torch.ops import traverse_pallas as tp
    from heatray_tpu_torch.ops import wide_bvh as wb

    return {
        "closest_wide": (wb.intersect_closest_wide, wb.closest_wide_plain),
        "any_wide": (wb.intersect_any_wide, wb.any_wide_plain),
        "closest_stream": (wb.intersect_closest_stream, wb.closest_stream_plain),
        "any_stream": (wb.intersect_any_stream, wb.any_stream_plain),
        "closest_chunks": (ip.intersect_closest_pallas, ip.closest_chunks_plain),
        "any_chunks": (ip.intersect_any_pallas, ip.any_chunks_plain),
        "closest_bvh": (tp.intersect_closest_bvh, tp.closest_bvh_plain),
        "any_bvh": (tp.intersect_any_bvh, tp.any_bvh_plain),
        "closest_wide_t": (wb.intersect_closest_vpu, wb.closest_wide_plain),
        "any_wide_t": (wb.intersect_any_vpu, wb.any_wide_plain),
        "closest_stream_t": (wb.intersect_closest_stream_vpu, wb.closest_stream_plain),
        "any_stream_t": (wb.intersect_any_stream_vpu, wb.any_stream_plain),
    }


def reset_launches():
    for kernel, _ in queries().values():
        kernel.launches = 0


def read_launches() -> dict:
    return {name: kernel.launches for name, (kernel, _) in queries().items()}


def probe_wrappers() -> dict:
    """Probe kernel name -> the wrapper that counts its launches."""
    from heatray_tpu_torch.probes import kernel_probe, kernel_variants, visit_stats, vpu_leaf

    return {"visit_stats": visit_stats.visit_stats, "nodes": kernel_probe.node_walk,
            "rows_brute": vpu_leaf.rows_closest, "warp_brute": vpu_leaf.warp_closest,
            "empty": kernel_probe.empty, "variant_walk": kernel_variants.variant_walk,
            "queue_walk_tile": kernel_variants.closest_v6,
            "queue_walk_none": kernel_variants.closest_v7,
            "queue_walk_chunk": kernel_variants.closest_v8}


def run_probe(label, names, fn):
    """Drive one probe's path: every probe count set to 0 just before
    ``fn()`` and read just after; each kernel of ``names`` must have run,
    and no other probe kernel.  Returns (fn's result, launches)."""
    import torch

    torch.cuda.synchronize()
    for wrapper in probe_wrappers().values():
        wrapper.launches = 0
    out = fn()
    torch.cuda.synchronize()
    launches = {name: w.launches for name, w in probe_wrappers().items()}
    if any(launches[n] == 0 for n in names) or any(
            n for name, n in launches.items() if name not in names):
        raise AssertionError(f"{label}: probe kernel launches {launches}, expected {names}")
    log(f"[{label}] launches {launches}")
    return out, launches


def subset(v, idx):
    from heatray_tpu_torch.vec import Vec3

    return Vec3(v.x[idx].contiguous(), v.y[idx].contiguous(), v.z[idx].contiguous())


def slot_t(tree, org, d, slot):
    """t of each ray against one given id each (plain arithmetic): a slot of
    a wide tree, or a triangle id of a chunk pack or a binary tree."""
    import torch

    from heatray_tpu_torch.ops.bvh import BVH
    from heatray_tpu_torch.ops.intersect import MISS_T, chunk_rows
    from heatray_tpu_torch.ops.wide_bvh import WideBVH, slot_rows

    if isinstance(tree, WideBVH):
        rows, anchor = slot_rows(tree)
    else:
        rows = chunk_rows(tree.w)
        anchor = torch.zeros((3, rows.shape[1]), device=rows.device)
    s = slot.clamp(min=0).long()
    if isinstance(tree, BVH):  # triangle id -> its slot
        valid = (tree.slot_tri >= 0).nonzero()[:, 0]
        slot_of = torch.zeros(tree.num_triangles, dtype=torch.long, device=s.device)
        slot_of[tree.slot_tri[valid].long()] = valid
        s = slot_of[s]
    r, a = rows[:, s], anchor[:, s]
    ox, oy, oz = org.x - a[0], org.y - a[1], org.z - a[2]

    def aff(g, x, y, z, with_b):
        v = x * r[4 * g] + y * r[4 * g + 1] + z * r[4 * g + 2]
        return v + r[4 * g + 3] if with_b else v

    t = -aff(2, ox, oy, oz, True) / aff(2, d.x, d.y, d.z, False)
    return torch.where(slot >= 0, t, MISS_T)


def live_pick(active, gen):
    """N_CHECK seeded lanes among the live ones."""
    import torch

    live = active.nonzero()[:, 0]
    return live[torch.randperm(live.numel(), generator=gen)[:N_CHECK].to(live.device)]


def check_closest(name, bvh, org, d, label, err, pick=None, t_min=1e-4, exact=False):
    """The kernel on all the rays against the plain version on the lanes
    ``pick`` (all when None).  ``exact``: no slot may differ, not even on a
    tie; for K7a and K5a, no t either."""
    import torch

    kernel, plain = queries()[name]
    t_k, s_k, h_k = kernel(bvh, org, d, t_min)
    n_all = h_k.numel()
    if pick is not None:
        org, d = subset(org, pick), subset(d, pick)
        t_k, s_k, h_k = t_k[pick], s_k[pick], h_k[pick]
    t_p, s_p, h_p = plain(bvh, org, d, t_min)
    torch.cuda.synchronize()
    if not torch.equal(h_k, h_p):
        raise AssertionError(f"{label}: {name} masks differ on {int((h_k != h_p).sum())} rays")
    diff = (t_k - t_p).abs()
    bad = diff > TOL + TOL * t_p.abs()
    if exact and name in EXACT_T:
        bad = t_k != t_p
    if bad.any():
        raise AssertionError(f"{label}: {name} t differs on {int(bad.sum())} rays, "
                             f"max {float(diff.max())}")
    # A different slot is allowed only where it ties with the plain one.
    other = s_k != s_p
    tie = (slot_t(bvh, org, d, s_k) - t_p).abs() <= TOL + TOL * t_p.abs()
    if (other & ~tie).any() or (exact and other.any()):
        raise AssertionError(f"{label}: {int(other.sum())} slots differ, "
                             f"{int((other & ~tie).sum())} without a tie")
    dt = float(diff[h_p].max()) if h_p.any() else 0.0
    err[name] = max(err[name], dt)
    log(f"[check] {label}: {name} ok on {h_k.numel()} of {n_all} rays launched, "
        f"{int(h_k.sum())} hit, max |dt| {dt:.3g}, {int(other.sum())} tied slots differ")


def check_any(name, bvh, org, d, t_max, label, err, pick=None, t_min=1e-4):
    """As ``check_closest``, for occlusion."""
    import torch

    kernel, plain = queries()[name]
    b_k = kernel(bvh, org, d, t_min, t_max)
    n_all = b_k.numel()
    if pick is not None:
        org, d, t_max, b_k = subset(org, pick), subset(d, pick), t_max[pick], b_k[pick]
    b_p = plain(bvh, org, d, t_min, t_max)
    torch.cuda.synchronize()
    n_bad = int((b_k != b_p).sum())
    if n_bad:
        raise AssertionError(f"{label}: {name} masks differ on {n_bad} rays")
    # The masks as 0/1: the largest |kernel - plain| over the rays.
    err[name] = max(err[name], float((b_k.float() - b_p.float()).abs().max()))
    log(f"[check] {label}: {name} ok on {b_k.numel()} of {n_all} rays launched, "
        f"{int(b_k.sum())} blocked")


def check_path_rays(names, scene, camera, ctx, opts, gen, label, err, exact=False, block=None,
                    trees=None):
    """Each kernel launched at the shapes a pass gives it, against its plain
    version on N_CHECK seeded live lanes of each launch: all primary rays,
    the first bounce's shadow lanes, and the second bounce's sorted, gated
    head and its shadow lanes (``exact``: see ``check_closest``).  ``block``:
    the primary rays are the lanes of that 3x3 block pass (sample index 0)
    alone, as ``interactive_block`` traces them.  ``trees``: the (closest
    hit, occluder) trees the kernels are checked on, where they are not the
    pack's (a rank's shard of the ``"sharded"`` forest).  Returns the primary rays,
    the first-bounce shadow rays, the depth-2 head and its shadow rays."""
    from heatray_tpu_torch.options import FrameGlobals
    from heatray_tpu_torch.render import integrator

    closest, any_ = names
    eps = opts.ray_epsilon
    # A context without a pack is the rebuild mode: the pass's own pack.
    pack = ctx.accel_pack or integrator.rebuild_pack(scene, opts)
    tree, tree_occl = trees or pack.structures()
    frame = FrameGlobals.create(0, device=ctx.device)
    cone = integrator.pixel_cone(scene, camera, opts)  # a textured scene's ray cones
    primary = integrator.start_paths(camera, ctx, opts, 0, cone=cone is not None)
    if block is not None:
        pixels = integrator.block_pixels(block, opts.height, opts.width, ctx.device)
        primary = primary.map(lambda p: p.index_select(0, pixels))
    check_closest(closest, tree, primary.org, primary.direction, f"{label} primary", err,
                  live_pick(primary.active, gen), eps, exact)
    first, shadow = integrator.bounce(scene, ctx, opts, frame, 1, primary, pack, cone)
    check_any(any_, tree_occl, shadow.org, shadow.direction, shadow.t_max,
              f"{label} first-bounce shadow", err, live_pick(shadow.active, gen), eps)
    paths = integrator._sort_paths(first, *integrator._sort_bounds(pack))
    n = integrator._gated_lanes(paths, opts.gate_segments)
    if n == 0:
        raise AssertionError(f"{label}: no live lane at depth 2")
    head = paths.map(lambda p: p[:n])
    tag = f"{label} depth-2 sorted head ({n} of {paths.active.numel()} lanes)"
    check_closest(closest, tree, head.org, head.direction, tag, err,
                  live_pick(head.active, gen), eps, exact)
    _, shadow2 = integrator.bounce(scene, ctx, opts, frame, 2, head, pack, cone)
    check_any(any_, tree_occl, shadow2.org, shadow2.direction, shadow2.t_max,
              f"{tag} shadow", err, live_pick(shadow2.active, gen), eps)
    return primary, shadow, head, shadow2


def random_soup(n_tri, n_rays, device):
    """A seeded random triangle soup and rays aimed through it."""
    import numpy as np
    import torch

    from heatray_tpu_torch.vec import Vec3

    rng = np.random.default_rng(SEED)
    v0 = rng.uniform(-4, 4, (n_tri, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(-0.5, 0.5, (n_tri, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-0.5, 0.5, (n_tri, 3)).astype(np.float32)
    pos = torch.from_numpy(np.concatenate([v0, v1, v2]).T.copy()).to(device)
    idx = torch.arange(3 * n_tri, dtype=torch.int32, device=device).reshape(n_tri, 3).T.contiguous()
    o = rng.uniform(-8, 8, (n_rays, 3)).astype(np.float32)
    d = rng.uniform(-2, 2, (n_rays, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)

    def vec(a):
        return Vec3(*(torch.from_numpy(np.ascontiguousarray(a[:, k])).to(device) for k in range(3)))

    return pos, idx, vec(o), vec(d)


def time_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def walk_work(bvh, org, d, t_far, t_min=1e-4, chunk=16384, with_leaves=True, blocks=False):
    """What these rays need of the tree: a dict of child-box tests, pair
    tests, pairs whose t lies in (t_min, t_far], and the nodes, leaves and
    leaf triangles reached.  Each ray tests the non-empty children of every
    node whose widened box it enters before ``t_far`` (its hit distance),
    and every triangle of each such leaf (none without ``with_leaves``: the
    node walk alone); with ``blocks`` (K5a), in each such leaf every block
    box (``WideBVH.blocks``), and only the triangles of the blocks it
    enters.  A plain level-by-level walk."""
    import torch

    from heatray_tpu_torch.ops import wide_bvh as wb
    from heatray_tpu_torch.ops.wide_bvh import widened_slab

    device = bvh.w.device
    codes = bvh.wchild.view(-1, wb.ARITY).long()
    tc = bvh.leaf_size
    # Slots of each leaf (C, Tc), or of each block (C * NB, BLOCK; -1 past the leaf).
    slots = torch.arange(bvh.num_chunks * tc, device=device).view(-1, tc)
    if blocks:
        n_blocks = bvh.blocks.shape[1]
        slots = torch.nn.functional.pad(slots, (0, n_blocks * wb.BLOCK - tc), value=-1)
        slots = slots.view(-1, wb.BLOCK)
        block_box = bvh.blocks.view(-1, 6).T  # (6, C * NB)
    filled_slot = (slots >= 0) & (bvh.slot_tri[slots.clamp(min=0)] >= 0)
    s_col = bvh.w[:, :, 2 * tc:].permute(1, 0, 2).reshape(4, -1)  # (4, S): each slot's s column
    node_seen = torch.zeros(codes.shape[0], dtype=torch.bool, device=device)
    leaf_seen = torch.zeros(slots.shape[0], dtype=torch.bool, device=device)
    boxes = pairs = in_range = 0
    for lo in range(0, org.x.numel(), chunk):
        oc = [c[lo:lo + chunk] for c in (org.x, org.y, org.z)]
        dc = [c[lo:lo + chunk] for c in (d.x, d.y, d.z)]
        o = [c[:, None, None] for c in oc]
        inv = [(torch.where(c < 0, -1.0, 1.0) / c.abs().clamp(min=1e-18))[:, None, None]
               for c in dc]
        tfc = t_far[lo:lo + chunk]
        level = torch.zeros(1, dtype=torch.long, device=device)
        reach = torch.ones((oc[0].shape[0], 1), dtype=torch.bool, device=device)
        while level.numel():
            node_seen[level] = True
            c, b = codes[level], bvh.wbox[level]
            filled = c != -1
            boxes += int((reach.sum(0) * filled.sum(1)).sum())
            corners = b.permute(2, 0, 1)  # (8, L, 8): coordinate, node, child
            ok = widened_slab(corners[0:3], corners[3:6], o, inv, tfc[:, None, None], t_min)
            ok = ok & reach[:, :, None] & filled[None]
            # Every (ray, leaf) pair reached, or (ray, block) pair entered:
            # the t of each triangle.
            ray, node, k = (ok & (c <= -2)[None] & with_leaves).nonzero(as_tuple=True)
            unit = -2 - c[node, k]
            if blocks:  # the blocks of each leaf reached
                boxes += ray.numel() * n_blocks
                ray, unit = _blocks_entered(ray, unit, n_blocks, block_box, oc,
                                            [x[:, 0, 0] for x in inv], tfc, t_min)
            leaf_seen[unit] = True
            fill = filled_slot[unit]
            pairs += int(fill.sum())
            col = slots[unit].clamp(min=0)
            leaf = col // tc
            s = s_col[:, col]  # (4, pairs, columns)
            ax, ay, az = ((oc[i][ray][:, None] - bvh.wanchor[i][leaf]) for i in range(3))
            dx, dy, dz = (dc[i][ray][:, None] for i in range(3))
            t = -(ax * s[0] + ay * s[1] + az * s[2] + s[3]) / (dx * s[0] + dy * s[1] + dz * s[2])
            in_range += int((fill & (t > t_min) & (t <= tfc[ray][:, None])).sum())
            # Inner children some ray of the chunk enters.
            inner = (c >= 0) & ok.any(0)
            level, reach = c[inner], ok[:, inner]
    nodes, units, tris = (int(node_seen.sum()), int(leaf_seen.sum()),
                          int(filled_slot[leaf_seen].sum()))
    leaves = units if not blocks else int(leaf_seen.view(bvh.num_chunks, -1).any(1).sum())
    box_bytes = leaves * n_blocks * BOX_BYTES if blocks else 0
    return {"boxes": boxes, "pairs": pairs, "in_range": in_range,
            "tree_bytes": (nodes * NODE_BYTES + leaves * ANCHOR_BYTES + box_bytes
                           + tris * TRI_BYTES),
            "reached": f"{nodes} nodes, {leaves} leaves"
                       + (f", {units} blocks" if blocks else "") + f" ({tris} triangles)"}


def _blocks_entered(ray, unit, n_blocks, block_box, oc, inv, tf, t_min):
    """The (ray, block) pairs of the (ray, leaf or chunk) pairs ``ray``,
    ``unit`` whose block box (``block_box`` (6, units * n_blocks); an
    inverted one never) the ray enters, widened, before its far end
    ``tf``: (rays, block indices).  ``oc``, ``inv``: the rays' origins and
    reciprocal directions, three (r,) tensors each."""
    import torch

    from heatray_tpu_torch.ops.wide_bvh import widened_slab

    ray = ray[:, None].expand(-1, n_blocks).reshape(-1)
    unit = (unit[:, None] * n_blocks + torch.arange(n_blocks, device=unit.device)).reshape(-1)
    box = block_box[:, unit]
    ok = widened_slab(box[:3], box[3:], [x[ray] for x in oc], [x[ray] for x in inv], tf[ray],
                      t_min) & (box[0] <= box[3])
    return ray[ok], unit[ok]


def _ray_chunks(org, d, t_far, chunk):
    """Per slice of ``chunk`` rays: origins, reciprocal directions,
    directions and far ends, each a list of three (or one) (r,) tensors."""
    import torch

    for lo in range(0, org.x.numel(), chunk):
        oc = [c[lo:lo + chunk] for c in (org.x, org.y, org.z)]
        dc = [c[lo:lo + chunk] for c in (d.x, d.y, d.z)]
        inv = [torch.where(c < 0, -1.0, 1.0) / c.abs().clamp(min=1e-18) for c in dc]
        yield oc, inv, dc, t_far[lo:lo + chunk]


def _pair_t(rows, oc, dc, ray, cols):
    """t of ray ``ray[k]`` against each row ``cols[k, :]`` of ``rows`` (12, S)."""
    r = rows[:, cols]
    ox, oy, oz = (oc[i][ray][:, None] for i in range(3))
    dx, dy, dz = (dc[i][ray][:, None] for i in range(3))
    return -(ox * r[8] + oy * r[9] + oz * r[10] + r[11]) / (dx * r[8] + dy * r[9] + dz * r[10])


def chunk_work(packed, org, d, t_far, t_min=1e-4, chunk=8192, blocks=False):
    """``walk_work`` for the chunk kernels: every ray tests every chunk's box,
    and every triangle of each chunk whose widened box it enters before
    ``t_far``; with ``blocks`` (K7a), in such a chunk every block's box, and
    only the triangles of the blocks it enters.  ``entries``: the (ray,
    chunk) pairs entered, ``block_entries`` the (ray, block) pairs."""
    import torch

    from heatray_tpu_torch.ops.intersect import chunk_rows
    from heatray_tpu_torch.ops.intersect_pallas import BLOCK
    from heatray_tpu_torch.ops.wide_bvh import widened_slab

    rows, tc = chunk_rows(packed.w), packed.tri_chunk
    n_blocks = packed.blocks.shape[1]
    # Columns of each chunk (C, Tc), or of each block (C * NB, BLOCK; -1 past the chunk).
    cols = torch.arange(packed.num_chunks * tc, device=rows.device).view(-1, tc)
    if blocks:
        cols = torch.nn.functional.pad(cols, (0, n_blocks * BLOCK - tc), value=-1)
        cols = cols.view(-1, BLOCK)
    filled = (cols >= 0) & (cols < packed.num_triangles)
    seen = torch.zeros(cols.shape[0], dtype=torch.bool, device=rows.device)
    b = packed.boxes.T[:, None, :]  # (6, 1, C)
    bb = packed.blocks.view(-1, 6).T  # (6, C * NB)
    pairs = in_range = entries = block_entries = 0
    for oc, inv, dc, tf in _ray_chunks(org, d, t_far, chunk):
        ok = widened_slab(b[:3], b[3:], [c[:, None] for c in oc], [c[:, None] for c in inv],
                     tf[:, None], t_min) & (b[0] <= b[3])
        ray, c = ok.nonzero(as_tuple=True)
        entries += ray.numel()
        if blocks:  # the blocks of each entered chunk
            ray, c = _blocks_entered(ray, c, n_blocks, bb, oc, inv, tf, t_min)
            block_entries += ray.numel()
        seen[c] = True
        fill = filled[c]
        pairs += int(fill.sum())
        t = _pair_t(rows, oc, dc, ray, cols[c].clamp(min=0))
        in_range += int((fill & (t > t_min) & (t <= tf[ray][:, None])).sum())
    n_tris = int(filled[seen].sum())
    n_boxes = org.x.numel() * packed.num_chunks + (entries * n_blocks if blocks else 0)
    box_bytes = packed.num_chunks * BOX_BYTES * (1 + (n_blocks if blocks else 0))
    return {"boxes": n_boxes, "pairs": pairs, "in_range": in_range, "entries": entries,
            "block_entries": block_entries, "tree_bytes": box_bytes + n_tris * TRI_BYTES,
            "reached": f"{packed.num_chunks} chunk boxes, {int(seen.sum())} "
                       f"{'blocks' if blocks else 'chunks'} ({n_tris} triangles)"}


def bvh2_work(bvh, org, d, t_far, t_min=1e-4, chunk=16384, blocks=False):
    """``walk_work`` for the binary-BVH kernels: each ray tests the box of
    the root and of both children of every internal node whose widened box
    it enters before ``t_far``, and every triangle of each leaf it enters;
    with ``blocks`` (K6a, K6b), in each such leaf every block box
    (``BVH.blocks``), and only the triangles of the blocks it enters."""
    import torch

    from heatray_tpu_torch.ops.bvh import BLOCK
    from heatray_tpu_torch.ops.intersect import chunk_rows
    from heatray_tpu_torch.ops.wide_bvh import widened_slab

    rows, tc = chunk_rows(bvh.w), bvh.leaf_size
    nbox, meta = bvh.nbox.view(-1, 6), bvh.meta.view(-1, 2).long()
    right = meta[:, 1].roll(-1)  # right child of node i: skip of node i + 1
    # Slots of each leaf (C, Tc), or of each block (C * NB, BLOCK; -1 past the leaf).
    slots = torch.arange(bvh.num_chunks * tc, device=rows.device).view(-1, tc)
    if blocks:
        n_blocks = bvh.blocks.shape[1]
        slots = torch.nn.functional.pad(slots, (0, n_blocks * BLOCK - tc), value=-1)
        slots = slots.view(-1, BLOCK)
        block_box = bvh.blocks.view(-1, 6).T  # (6, C * NB)
    filled_slot = (slots >= 0) & (bvh.slot_tri[slots.clamp(min=0)] >= 0)
    node_seen = torch.zeros(nbox.shape[0], dtype=torch.bool, device=rows.device)
    unit_seen = torch.zeros(slots.shape[0], dtype=torch.bool, device=rows.device)
    boxes = pairs = in_range = 0
    for oc, inv, dc, tf in _ray_chunks(org, d, t_far, chunk):
        level = torch.zeros(1, dtype=torch.long, device=rows.device)
        reach = torch.ones((oc[0].shape[0], 1), dtype=torch.bool, device=rows.device)
        while level.numel():
            node_seen[level] = True
            boxes += int(reach.sum())
            b = nbox[level].T[:, None, :]
            ok = reach & widened_slab(b[:3], b[3:], [c[:, None] for c in oc],
                                 [c[:, None] for c in inv], tf[:, None], t_min)
            code = meta[level, 0]
            # Every (ray, leaf) pair entered, or (ray, block) pair: the t of each triangle.
            ray, k = (ok & (code >= 0)[None]).nonzero(as_tuple=True)
            unit = code[k]
            if blocks:  # the blocks of each leaf entered
                boxes += ray.numel() * n_blocks
                ray, unit = _blocks_entered(ray, unit, n_blocks, block_box, oc, inv, tf, t_min)
            unit_seen[unit] = True
            fill = filled_slot[unit]
            pairs += int(fill.sum())
            t = _pair_t(rows, oc, dc, ray, slots[unit].clamp(min=0))
            in_range += int((fill & (t > t_min) & (t <= tf[ray][:, None])).sum())
            inner = (code < 0) & ok.any(0)
            parents = level[inner]
            level = torch.cat([parents + 1, right[parents]])
            reach = ok[:, inner].repeat(1, 2)
    nodes, units, tris = (int(node_seen.sum()), int(unit_seen.sum()),
                          int(filled_slot[unit_seen].sum()))
    leaves = units if not blocks else int(unit_seen.view(bvh.num_chunks, -1).any(1).sum())
    box_bytes = leaves * n_blocks * BOX_BYTES if blocks else 0
    return {"boxes": boxes, "pairs": pairs, "in_range": in_range,
            "tree_bytes": nodes * NODE2_BYTES + box_bytes + tris * TRI_BYTES,
            "reached": f"{nodes} nodes, {leaves} leaves"
                       + (f", {units} blocks" if blocks else "") + f" ({tris} triangles)"}


def bound(r, work, occlusion):
    """(bound ms, what bounds it) of one query over ``r`` rays that need
    ``work`` (``walk_work``, ``chunk_work``, ``bvh2_work``) of the tree."""
    ray_bytes = 24 + (4 + 1 if occlusion else 8)  # origin, direction, t_max, outputs
    nbytes = work["tree_bytes"] + ray_bytes * r
    flops = (work["boxes"] * SLAB_FLOPS + work["pairs"] * PAIR_T_FLOPS
             + work["in_range"] * BARY_FLOPS)
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS * 1e3
    log(f"[bound] {r} rays: {work['reached']} reached; "
        f"{nbytes / 1e6:.3f} MB -> {t_bytes:.4f} ms; "
        f"{work['boxes'] / r:.3f} box tests, {work['pairs'] / r:.3f} pair tests, "
        f"{work['in_range'] / r:.3f} in range per ray, {flops / 1e9:.3f} GFLOP "
        f"-> {t_ops:.4f} ms")
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_kernels(spec, err, launches):
    """One kernels-line entry per ``spec`` item (name, tree or chunk pack,
    org, dir, t_max or None, plain on all rays or on the sample).  Kernels are timed over
    10 launches, plain versions once; the walk's work is counted on all the
    rays."""
    import torch

    out = []
    for name, bvh, org, d, t_max, plain_all in spec:
        kernel, plain = queries()[name]
        r = org.x.numel()
        sample = torch.randperm(r, generator=torch.Generator().manual_seed(SEED))[:N_CHECK]
        sample = sample.to(org.x.device)
        s_org, s_dir = subset(org, sample), subset(d, sample)
        args, s_args = (bvh, org, d), (bvh, s_org, s_dir)
        if t_max is not None:
            args, s_args = args + (1e-4, t_max), s_args + (1e-4, t_max[sample].contiguous())
        ms = time_ms(lambda: kernel(*args), 10)
        plain_ms = time_ms(lambda: plain(*(args if plain_all else s_args)), 1)
        n_plain = r if plain_all else sample.numel()
        # A walk that knows each ray's hit distance (and, for occlusion, its
        # t_max) needs no more than this.
        family = name.split("_", 1)[1]
        t_far = queries()["closest_" + family][0](bvh, org, d)[0]
        if t_max is not None:
            t_far = torch.minimum(t_far, t_max)
        whole_work = {"chunks": chunk_work, "bvh": bvh2_work}.get(family, walk_work)
        work = whole_work
        if name in BLOCK_CULLED:
            work = functools.partial(whole_work, blocks=True)
        bound_ms, bound_by = bound(r, work(bvh, org, d, t_far), t_max is not None)
        log(f"[time] {name} on {r} rays: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms on "
            f"{n_plain} rays, bound {bound_ms:.4f} ms ({bound_by})")
        out.append({
            "name": name, "route": "cuda", "source": KERNELS[name][0],
            "replaces": KERNELS[name][1], "launches": launches[name],
            "max_abs_err": err[name], "ms": ms, "rays": r, "plain_ms": plain_ms,
            "plain_rays": n_plain, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
        })
        if name in WHOLE_BOUND:  # the bound without block boxes: whole leaves or chunks
            whole = bound(r, whole_work(bvh, org, d, t_far), t_max is not None)
            unit = WHOLE_BOUND[name]
            out[-1].update({f"whole_{unit}_bound_ms": whole[0], f"whole_{unit}_bound_by": whole[1]})
    return out


def head_entry(entry, bvh, o, dd, t_max, ms):
    """Set a kernels-line entry's depth-2 head reading: its rays, ``ms``,
    and the bound of what those rays need of ``bvh`` (a wide or a binary
    tree; over the blocks they enter, for a kernel of BLOCK_CULLED);
    ``t_max`` None for closest hit."""
    import torch

    name = entry["name"]
    family = name.split("_", 1)[1]
    occl = t_max is not None
    t_far = queries()["closest_" + family][0](bvh, o, dd)[0]
    if occl:
        t_far = torch.minimum(t_far, t_max)
    work = bvh2_work if family == "bvh" else walk_work
    b_ms, b_by = bound(o.x.numel(), work(bvh, o, dd, t_far, blocks=name in BLOCK_CULLED), occl)
    entry.update(head_rays=o.x.numel(), head_ms=ms, head_bound_ms=b_ms, head_bound_by=b_by)
    log(f"[time] {name} on the {o.x.numel()} depth-2 head rays: kernel {ms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by})")


def compare_launches(label, kernels, mine, rivals, launches, card):
    """One [compare] line: the kernels ``mine`` beside ``rivals`` (each a dict
    label -> (query name, the tree it walks)), on the primary rays and
    first-bounce shadow lanes and on the depth-2 sorted head and its shadow
    lanes (``launches``: two (rays, shadow rays) pairs).  Each is timed over
    10 launches, except ``mine`` on the primary and shadow rays, which
    ``time_kernels`` has just timed: their kernels-line entries give those
    times, and get the head's rays, time and bound."""
    entries = {k["name"]: k for k in kernels}
    mine_names = {name for name, _ in mine.values()}
    parts = []
    for tag, (rays, shadow) in zip(("primary", "depth-2 head"), launches):
        ms = {}
        for who, (name, tree) in {**mine, **rivals}.items():
            if tag == "primary" and name in mine_names:
                ms[who] = entries[name]["ms"]
                continue
            fn = queries()[name][0]
            if name.startswith("any_"):
                ms[who] = time_ms(lambda: fn(tree, shadow.org, shadow.direction,
                                             t_max=shadow.t_max), 10)
            else:
                ms[who] = time_ms(lambda: fn(tree, rays.org, rays.direction), 10)
        parts.append(f"{tag} ({rays.org.x.numel()} rays, {shadow.org.x.numel()} shadow lanes): "
                     + ", ".join(f"{who} {t:.4f}" for who, t in ms.items()))
        if tag == "primary":
            continue
        for who, (name, tree) in mine.items():
            occl = name.startswith("any_")
            o = shadow if occl else rays
            head_entry(entries[name], tree, o.org, o.direction,
                       shadow.t_max if occl else None, ms[who])
    log(f"[compare] {label}, ms: {'; '.join(parts)}; card {card}")


def run_path(label, scene, camera, ctx, opts, expect, readings=None):
    """The render path of one scene: PASSES passes through ``render_pass``
    with the launch counts set to 0 just before and read just after.  Each
    kernel of ``expect`` must run once per bounce with live lanes: the
    first bounce of every pass, and each later one whose gated lane count
    (``_gated_lanes``, counted here) is above 0; no other kernel may run.
    In the rebuild mode the time of each pass's rebuild is taken apart.
    Returns the launches and the resolved image; ``readings`` (a dict), if
    given, gets the accumulation, each pass's ms and rays, and the peak
    device memory of the passes."""
    import torch

    from heatray_tpu_torch import resolve
    from heatray_tpu_torch.options import FrameGlobals
    from heatray_tpu_torch.render import integrator

    if integrator._bounce_modes(ctx, opts, WIDTH * HEIGHT) != (True, True):
        raise AssertionError(f"{label}: 'auto' does not sort and gate on the card")
    device = ctx.device
    accum = torch.zeros((4, HEIGHT, WIDTH), dtype=torch.float32, device=device)
    rays, pass_ms, lanes, rebuild_ms = 0, [], [], []
    gated, rebuild = integrator._gated_lanes, integrator.rebuild_pack

    def count_lanes(*args):
        lanes.append(gated(*args))
        return lanes[-1]

    def timed_rebuild(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pack = rebuild(*args)
        torch.cuda.synchronize()
        rebuild_ms.append((time.perf_counter() - t0) * 1e3)
        return pack

    integrator._gated_lanes, integrator.rebuild_pack = count_lanes, timed_rebuild
    pass_rays = []
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        for i in range(PASSES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            accum, stats = integrator.render_pass(
                scene, camera, ctx, opts, FrameGlobals.create(i, device=device), accum,
                with_stats=True,
            )
            torch.cuda.synchronize()
            pass_ms.append((time.perf_counter() - t0) * 1e3)
            rays += stats["rays"]
            pass_rays.append(stats["rays"])
        launches = read_launches()
    finally:
        integrator._gated_lanes, integrator.rebuild_pack = gated, rebuild
    depth = opts.max_ray_depth
    if len(lanes) != PASSES * (depth - 1):
        raise AssertionError(f"{label}: {len(lanes)} gated bounces, not {PASSES * (depth - 1)}")
    runs = PASSES + sum(n > 0 for n in lanes)
    if any(launches[name] != runs for name in expect):
        raise AssertionError(f"{label} path kernel launches {launches}, not {runs} each "
                             f"(gated lanes {lanes})")
    if any(n for name, n in launches.items() if name not in expect):
        raise AssertionError(f"{label} path launched kernels other than {expect}: {launches}")
    if len(rebuild_ms) != (PASSES if ctx.accel_pack is None else 0):
        raise AssertionError(f"{label}: {len(rebuild_ms)} rebuilds in {PASSES} passes")
    if not torch.equal(accum[3], torch.full_like(accum[3], float(PASSES))):
        raise AssertionError(f"{label}: alpha is not the pass count everywhere")
    img = resolve(accum)
    if not bool(torch.isfinite(img).all()) or float(img.max()) <= 0.0:
        raise AssertionError(f"{label} image is not finite, or black")
    if readings is not None:
        readings.update(accum=accum, pass_ms=pass_ms, pass_rays=pass_rays,
                        peak_mib=torch.cuda.max_memory_allocated() / 2**20)
    total_s = sum(pass_ms) / 1e3
    log(f"[{label}] {WIDTH}x{HEIGHT} depth {depth}, {PASSES} passes: ms/pass "
        f"{[round(m, 3) for m in pass_ms]}, mean {sum(pass_ms) / PASSES:.3f}; "
        f"{rays} rays, {rays / total_s / 1e6:.3f} Mrays/s; launches {launches}; "
        f"gated lanes {lanes}; image mean {float(img.mean()):.4g}")
    if rebuild_ms:
        log(f"[{label}] rebuild ms per pass {[round(m, 3) for m in rebuild_ms]}, mean "
            f"{sum(rebuild_ms) / PASSES:.3f}")
    return launches, img


def phase_grad(scene, camera, baked_ctx, opts, card):
    """Phase 3c: ``bench.py``'s fwd+bwd step through K1/K2 (see the module
    docstring)."""
    import numpy as np
    import torch

    from heatray_tpu_torch import make_loss_fn, orbit_camera
    from heatray_tpu_torch.bridge import params_from_arrays
    from heatray_tpu_torch.diff.inverse import apply_material_params
    from heatray_tpu_torch.options import FrameGlobals, RenderOptions
    from heatray_tpu_torch.render import integrator

    t_phase = time.perf_counter()
    device = baked_ctx.device
    t0 = time.perf_counter()
    ctx = integrator.make_context(opts, scene, device, static_shading=False)
    torch.cuda.synchronize()
    pack = ctx.accel_pack
    if pack.route != "wide" or pack.shade_table is not None:
        raise AssertionError(f"static_shading=False gave route {pack.route!r} and a baked table")
    log(f"[grad] context with static_shading=False in {time.perf_counter() - t0:.2f} s")
    zero = torch.zeros((4, HEIGHT, WIDTH), dtype=torch.float32, device=device)

    # The same forward: a per-pass table against the baked one, without autograd.
    with torch.no_grad():
        frame = FrameGlobals.create(7, device=device)
        in_graph = integrator.render_pass(scene, camera, ctx, opts, frame, zero)
        baked = integrator.render_pass(scene, camera, baked_ctx, opts, frame, zero)
    if not torch.equal(in_graph, baked):
        d = (in_graph - baked).abs()
        raise AssertionError(f"in-graph table pass differs from the baked one: "
                             f"{int((d > 0).sum())} values, max {float(d.max())}")
    log("[grad] a pass through the in-graph table equals one through the baked table, "
        "bit for bit")
    del in_graph, baked

    mats = scene.materials
    params = params_from_arrays({"base_color": mats.base_color.cpu().numpy(),
                                 "roughness": mats.roughness.cpu().numpy()}, device)

    def forward(o, idx, with_stats=False):
        out = integrator.render_pass(apply_material_params(scene, params), camera, ctx, o,
                                     FrameGlobals.create(idx, device=device), zero,
                                     with_stats=with_stats)
        a, stats = out if with_stats else (out, None)
        img = a[:3] / torch.clamp(a[3:], min=1.0)
        return torch.mean(img * img), stats

    # One step with the launches counted in its forward and in its backward.
    lanes, gated = [], integrator._gated_lanes

    def count_lanes(*args):
        lanes.append(gated(*args))
        return lanes[-1]

    integrator._gated_lanes = count_lanes
    try:
        torch.cuda.synchronize()
        reset_launches()
        loss, stats = forward(opts, 0, with_stats=True)
        torch.cuda.synchronize()
        fwd = read_launches()
        reset_launches()
        loss.backward()
        torch.cuda.synchronize()
        bwd = read_launches()
    finally:
        integrator._gated_lanes = gated
    runs = 1 + sum(n > 0 for n in lanes)
    expect = {name: runs if name in ("closest_wide", "any_wide") else 0 for name in fwd}
    if fwd != expect or any(bwd.values()):
        raise AssertionError(f"step launches: forward {fwd}, backward {bwd}; expected forward "
                             f"{expect} (gated lanes {lanes}) and none in the backward")
    rays = stats["rays"]
    log(f"[grad] step launches: forward {fwd['closest_wide']} K1, {fwd['any_wide']} K2 "
        f"(gated lanes {lanes}); backward none; loss {float(loss.detach())!r}, {rays} rays")
    grads = {k: v.grad for k, v in params.items()}
    if not all(bool(torch.isfinite(g).all()) for g in grads.values()):
        raise AssertionError("step gradients are not finite")
    with torch.no_grad():
        prim = integrator.start_paths(camera, ctx, opts, 0)
        _, slot, hit = integrator._make_intersectors(pack)[0](prim.org, prim.direction,
                                                              opts.ray_epsilon)
        tri = pack.wide.slot_tri[slot[hit].long()].long()
        seen = torch.unique(scene.geometry.material_ids[tri].long())
    if not bool((grads["base_color"][:, seen] != 0).all()) or float(grads["roughness"][5]) == 0:
        raise AssertionError(f"zero gradients: base_color {grads['base_color'].tolist()} on "
                             f"materials {seen.tolist()}, roughness {grads['roughness'].tolist()}")
    log(f"[grad] base_color gradient {grads['base_color'].tolist()} (materials the primary "
        f"rays hit: {seen.tolist()}); roughness {grads['roughness'].tolist()}")

    # The step's time and memory, remat on and off in turns.
    def step(o, idx):
        for v in params.values():
            v.grad = None
        forward(o, idx)[0].backward()

    def chain(o, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            step(o, 1 + i)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    modes = {True: opts, False: dataclasses.replace(opts, remat_bounces=False)}
    for remat in (True, False, False, True):
        o = modes[remat]
        chain(o, 1)  # warm-up
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t1 = chain(o, 1)
        peak = torch.cuda.max_memory_allocated()
        t5 = chain(o, 5)
        dt = max((t5 - t1) / 4, 1e-9)
        log(f"[grad] fwd+bwd step, {WIDTH}x{HEIGHT} depth {DEPTH}, remat_bounces={remat}: "
            f"{dt * 1e3:.3f} ms/step (t1 {t1 * 1e3:.3f} ms, t5 {t5 * 1e3:.3f} ms) -> "
            f"{rays / dt / 1e6:.3f} Mrays/s (fwd+bwd); peak memory {peak / 2**20:.1f} MiB, "
            f"{(peak - held) / 2**20:.1f} MiB above the {held / 2**20:.1f} held before the "
            f"step; card {card}")
    del ctx, params, grads, loss
    torch.cuda.empty_cache()

    # The card against the CPU (plain versions), 24x24, depth 2.
    small = RenderOptions(width=24, height=24, max_render_passes=4, max_ray_depth=2)

    def small_grads(dev):
        s = scene.to(dev)
        p = params_from_arrays({"base_color": mats.base_color.cpu().numpy(),
                                "roughness": mats.roughness.cpu().numpy(),
                                "light.point_color": s.lights.point_color.cpu().numpy()}, dev)
        loss_fn = make_loss_fn(s, orbit_camera(24, 24, distance=6.2, focal_length_mm=35.0),
                               integrator.make_context(small, s, dev, static_shading=False),
                               small, torch.zeros((24, 24, 3)))
        loss_fn(p).backward()
        return {k: v.grad.cpu() for k, v in p.items()}

    on_card, on_cpu = small_grads(device), small_grads(torch.device("cpu"))
    for k, want in on_cpu.items():
        scale = float(want.abs().max())
        err = float((on_card[k] - want).abs().max()) / max(scale, 1e-30)
        if scale == 0.0 or not err <= 1e-3:
            raise AssertionError(f"24x24 step gradient {k}: card against CPU {err} of the "
                                 f"largest |g| {scale}")
        log(f"[grad] 24x24 depth 2, {k}: card against CPU max |diff| {err:.3g} of the largest "
            f"|g| {scale:.4g}")

    # Sorted and gated against unsorted on the card (tests/test_gating.py's case,
    # with segments fine enough that the gate cuts lanes).
    base = RenderOptions(width=32, height=32, max_render_passes=4, max_ray_depth=3,
                         gate_segments=16)
    sorted_grads = {}
    for sort in (False, True):
        o = dataclasses.replace(base, sort_bounces=sort, gate_bounces=sort)
        c = integrator.make_context(o, scene, device, static_shading=False)
        if integrator._bounce_modes(c, o, 32 * 32) != (sort, sort):
            raise AssertionError(f"sort_bounces={sort} did not give sort and gate {sort}")
        p = params_from_arrays({"base_color": mats.base_color.cpu().numpy(),
                                "roughness": mats.roughness.cpu().numpy()}, device)
        loss_fn = make_loss_fn(scene, orbit_camera(32, 32, distance=6.2, focal_length_mm=35.0),
                               c, o, torch.zeros((32, 32, 3)))
        lanes.clear()
        integrator._gated_lanes = count_lanes
        try:
            loss_fn(p).backward()
        finally:
            integrator._gated_lanes = gated
        if sort and min(lanes) == 32 * 32:
            raise AssertionError(f"the gate cut no lane: {lanes}")
        sorted_grads[sort] = {k: v.grad.cpu().numpy() for k, v in p.items()}
    for k, want in sorted_grads[False].items():
        np.testing.assert_allclose(sorted_grads[True][k], want, rtol=1e-5, atol=1e-8,
                                   err_msg=f"sorted gradient {k}")
    log(f"[grad] 32x32 depth 3: sorted and gated gradients (gated lanes {lanes} of "
        f"{32 * 32}) equal unsorted ones (rtol 1e-5, atol 1e-8); phase 3c took "
        f"{time.perf_counter() - t_phase:.1f} s")


def compare_images(label, img, ref, ref_label):
    """At most IMAGE_SHARE of the pixels of ``img`` may differ from ``ref``
    by more than IMAGE_TOL."""
    diff = (img - ref).abs().amax(dim=2)
    n_bad = int((diff > IMAGE_TOL).sum())
    log(f"[image] {label} against {ref_label}: {n_bad} of {diff.numel()} pixels differ by "
        f"more than {IMAGE_TOL}, max |diff| {float(diff.max()):.4g}")
    if n_bad > IMAGE_SHARE * diff.numel():
        raise AssertionError(f"{label}: {n_bad} pixels differ from the {ref_label} path")


def vpu_context(label, scene, opts, route, device):
    """A context of a transposed-leaf-math route, built through
    ``make_context`` as a user builds one; its tree must have leaves of 128."""
    import torch

    from heatray_tpu_torch.render import integrator

    t0 = time.perf_counter()
    ctx = integrator.make_context(opts, scene, device)
    torch.cuda.synchronize()
    pack = ctx.accel_pack
    log(f"[setup] {label} context in {time.perf_counter() - t0:.2f} s: route {pack.route!r}, "
        f"{pack.wide.num_nodes} nodes, {pack.wide.num_chunks} leaves of {pack.wide.leaf_size}, "
        f"stack {pack.wide.max_stack}")
    if (pack.route, pack.wide.leaf_size) != (route, 128):
        raise AssertionError(f"{label} got route {pack.route!r}, leaf {pack.wide.leaf_size}")
    return ctx


def brute_in_range(accel, org, d, t_hit, t_min=1e-4, chunk=2048):
    """(ray, triangle) pairs over every triangle of ``accel`` whose t lies
    in (t_min, t_hit]: the pairs whose barycentrics a brute force needs."""
    rows = accel.w
    n = 0
    for lo in range(0, org.x.numel(), chunk):
        ox, oy, oz = (c[lo:lo + chunk, None] for c in (org.x, org.y, org.z))
        dx, dy, dz = (c[lo:lo + chunk, None] for c in (d.x, d.y, d.z))
        t = -(ox * rows[8] + oy * rows[9] + oz * rows[10] + rows[11]) / (
            dx * rows[8] + dy * rows[9] + dz * rows[10])
        n += int(((t > t_min) & (t <= t_hit[lo:lo + chunk, None])).sum())
    return n


def probe_bound(label, nbytes, flops):
    """(bound ms, what bounds it) of a probe kernel that must move ``nbytes``
    and do ``flops`` float32 operations."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS * 1e3
    log(f"[bound] {label}: {nbytes / 1e6:.3f} MB -> {t_bytes:.4f} ms; {flops / 1e9:.3f} GFLOP "
        f"-> {t_ops:.4f} ms")
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def probe_entry(name, ms, rays, plain, bound, library_ms=None, **extra):
    """One kernels-line entry of a probe kernel; ``plain`` is (ms, rays) of
    its plain version, ``bound`` (ms, by).  Launches and errors are filled
    in at the end."""
    replaces, also = PROBE_KERNELS[name]
    entry = {"name": name, "route": "cuda", "source": PROBE_SOURCE, "replaces": replaces,
             "launches": 0, "max_abs_err": 0.0, "ms": ms, "rays": rays, "plain_ms": plain[0],
             "plain_rays": plain[1], "bound_ms": bound[0], "bound_by": bound[1],
             "library_ms": library_ms}
    if also:
        entry["also_replaces"] = also
    entry.update(extra)
    return entry


def timed_once(fn):
    """(host ms around ``fn`` with synchronisations, its result)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def phase_p3(cornell, high_poly, gen, err, card):
    """Phase 16: P3 through ``visit_stats.run`` on the Cornell and
    ``high_poly`` wavefronts; on each, the kernel's work counts
    (``visit_stats(work=True)``) and, on P3_TILES seeded whole tiles, its
    four counts and work counts against the plain walk; each wavefront's
    bound from its work counts, and a ``[compare]`` line per Cornell depth.
    Returns (kernels-line entry, launches)."""
    import torch

    from heatray_tpu_torch.probes import visit_stats as vs

    scene, camera, opts, ctx, tree = cornell
    hp_scene, hp_camera, hp_opts, hp_ctx = high_poly
    hp_tree = hp_ctx.accel_pack.wide

    def path():
        return (vs.run(scene, camera, ctx, opts, tree, DEPTH, log=log),
                vs.run(hp_scene, hp_camera, hp_ctx, hp_opts, hp_tree, 2, log=log))

    (c_recs, hp_recs), launches = run_probe("P3 visit_stats", ("visit_stats",), path)
    plain = None
    for label, t, recs in (("cornell leaf 32", tree, c_recs), ("high_poly leaf 128", hp_tree,
                                                                hp_recs)):
        for rec in recs:
            org, d = rec["org"], rec["direction"]
            what = f"P3 {label} depth {rec['depth']} {rec['tag']}"
            r = org.x.numel()
            n_tiles = r // vs.TILE
            tiles = torch.randperm(n_tiles, generator=gen)[:P3_TILES].to(org.x.device)
            lanes = (tiles[:, None] * vs.TILE + torch.arange(vs.TILE, device=org.x.device)
                     ).reshape(-1)
            sw, sa = rec["seed"]
            *counts, spent = vs.visit_stats(t, org, d, sw, sa, seed_k=rec["seed_k"], work=True)
            if not all(torch.equal(a, b) for a, b in zip(counts, rec["stats"])):
                raise AssertionError(f"{what}: the counts of the work run differ from the timed "
                                     "run's")
            ms, want = timed_once(lambda: vs.visit_stats_plain(
                t, subset(org, lanes), subset(d, lanes), sw, sa, seed_k=rec["seed_k"], work=True))
            got = [a[tiles] for a in (*counts, spent)]
            for i, (a, b) in enumerate(zip(got, want)):
                same = ((a - b).abs() <= 1e-6 * b.abs()).all() if i == 2 else torch.equal(a, b)
                if not bool(same):
                    off = int((a != b).reshape(a.shape[0], -1).any(dim=1).sum())
                    raise AssertionError(f"{what}: count {i} differs on {off} tiles")
                if i < 4:
                    err["visit_stats"] = max(err["visit_stats"], float((a - b).abs().max()))
            # The bound: the work its counts need (``vs.WORK``): each ray's
            # tests of the filled children of the visited nodes, and its pair
            # tests (with their barycentrics where t lies in range) of the
            # leaves its own slab entered.
            box_tests, pair_tests, in_range = (int(x) for x in spent.sum(dim=0).tolist())
            flops = box_tests * SLAB_FLOPS + pair_tests * PAIR_T_FLOPS + in_range * BARY_FLOPS
            rec["bound"] = probe_bound(f"{what} on {r} rays: {box_tests} box tests, {pair_tests} "
                                       f"pair tests ({in_range} in range)",
                                       24 * r + 16 * -(-r // vs.TILE), flops)
            log(f"[check] {what}: {tiles.numel()} tiles of {n_tiles} equal to the plain walk, "
                f"counts and work counts ({ms:.1f} ms); kernel {rec['ms']:.4f} ms")
            plain = plain or (ms, lanes.numel())
    for dep in range(1, DEPTH + 1):
        line = "; ".join(
            f"{rec['tag']} {rec['ms']:.4f} ms beside its bound {rec['bound'][0]:.4f} "
            f"({rec['bound'][1]}, {rec['ms'] / rec['bound'][0]:.1f}x)"
            for rec in c_recs if rec["depth"] == dep)
        log(f"[compare] P3 cornell leaf 32 depth {dep} ({c_recs[2 * dep - 2]['org'].x.numel()} "
            f"rays): {line}; card {card}")
    # The entry: the Cornell primary rays, unseeded, with depth 2 beside.
    rec, rec2 = c_recs[0], c_recs[2]
    return probe_entry("visit_stats", rec["ms"], rec["org"].x.numel(), plain, rec["bound"],
                       depth2_ms=rec2["ms"], depth2_bound_ms=rec2["bound"][0]), launches


def grid_costs(org):
    """P1 ``grid``'s readings on the rays' x plane: ms a call of
    ``kernel_probe.empty`` and of ``torch.mul(x, 0.0)``, each over 10 calls
    back to back (CUDA events, ``time_ms``: the kernels line's ``ms_10``
    and ``library_ms``; its ``ms`` stays ``kernel_probe.run``'s reading over
    5 calls, so that it lines up with earlier runs); the
    device time of each alone, from 10 replays of a CUDA graph of the same
    10 calls, the lesser of two readings in turns; and the host path of ``empty`` taken apart, each part over 1,000
    calls (``time.perf_counter_ns``, microseconds a call) on the first 4,096
    rays, whose launches the card finishes faster than the host makes them
    (no part of the host path depends on the rays' count); and the device
    time a call of each over GRID_COPIES copies of the x plane in turn, two
    rounds in one graph (66 MB of inputs and 133 MB of outputs, past the
    50 MB L2), beside the 16.6 MB bound."""
    import torch

    from heatray_tpu_torch.ops import wide_bvh as wb
    from heatray_tpu_torch.probes import check_ray_tile, kernels
    from heatray_tpu_torch.probes import kernel_probe as kp
    from heatray_tpu_torch.vec import Vec3

    calls = {"empty": lambda: kp.empty(org), "torch.mul": lambda: torch.mul(org.x, 0.0)}
    few = Vec3(*(c[:4096].contiguous() for c in (org.x, org.y, org.z)))
    x = few.x
    dev, n = x.device, x.numel()
    lib = kernels()
    out = torch.empty_like(x)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)

    def graph_ms(fn, count=None):
        """Device ms a call: ``fn`` 10 times in one graph, or once when it
        makes ``count`` calls itself."""
        fn()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(1 if count else 10):
                fn()
        return time_ms(graph.replay, 10) / (count or 10)

    def checks():
        check_ray_tile(256)
        return wb.on_cpu(x) or x.dtype != torch.float32 or x.dim() != 1 or x.contiguous()

    def guard():
        with torch.cuda.device(dev):
            pass

    parts = {
        "checks and contiguous": checks,
        "empty_like": lambda: torch.empty_like(x),
        "device guard (torch.cuda.device)": guard,
        "current-device test": lambda: dev.index == torch._C._cuda_getDevice(),
        "torch.cuda.current_stream(device).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "raw stream handle": lambda: torch._C._cuda_getCurrentRawStream(dev.index),
        "ctypes call, no launch (cudaGetLastError)":
            lambda: lib.probe_empty(x.data_ptr(), 0, 256, out.data_ptr(), stream),
        "ctypes call with its launch":
            lambda: lib.probe_empty(x.data_ptr(), n, 256, out.data_ptr(), stream),
        "launch(), the shared helper, with that call":
            lambda: wb.launch(lib.probe_empty, dev, x.data_ptr(), n, 256, out.data_ptr()),
        "empty, the whole wrapper": lambda: kp.empty(few),
        "torch.mul(x, 0.0)": lambda: torch.mul(x, 0.0),
    }
    host_us = {}
    for part, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(1000):
            fn()
        host_us[part] = (time.perf_counter_ns() - t0) / 1000 / 1e3
        torch.cuda.synchronize()
    ms = {name: time_ms(fn, 10) for name, fn in calls.items()}
    # Device time, the least of two readings in turns (empty, torch.mul,
    # torch.mul, empty): on one input, and over GRID_COPIES inputs in turn
    # (66 MB, past the 50 MB L2), two rounds.
    copies = [Vec3(c, c, c) for c in (org.x.clone() for _ in range(GRID_COPIES))]
    rotating = {"empty": lambda v: kp.empty(v), "torch.mul": lambda v: torch.mul(v.x, 0.0)}
    device_ms, rotating_ms = {}, {}
    for name in [*calls, *reversed(calls)]:
        one = graph_ms(calls[name])
        over = graph_ms(lambda fn=rotating[name]: [fn(v) for v in copies * 2], len(copies) * 2)
        device_ms[name] = min(device_ms.get(name, one), one)
        rotating_ms[name] = min(rotating_ms.get(name, over), over)
    del copies
    bound_ms = 8 * org.x.numel() / PEAK_BYTES * 1e3
    log(f"[compare] P1 grid on {org.x.numel()} rays, ms a call over 10 back to back: empty "
        f"{ms['empty']:.4f}, torch.mul {ms['torch.mul']:.4f}; device ms a call (10 replays "
        f"of a graph of 10, the lesser of 2 in turns): empty {device_ms['empty']:.4f}, torch.mul "
        f"{device_ms['torch.mul']:.4f}; over {GRID_COPIES} inputs in turn: empty "
        f"{rotating_ms['empty']:.4f} ({bound_ms / rotating_ms['empty']:.1%} of the "
        f"{bound_ms:.4f} ms bound), torch.mul {rotating_ms['torch.mul']:.4f} "
        f"({bound_ms / rotating_ms['torch.mul']:.1%})")
    log(f"[host] P1 grid on {n} rays, us a call over 1,000 calls: "
        + "; ".join(f"{part} {us:.2f}" for part, us in host_us.items()))
    return {"ms_10": ms["empty"], "library_ms": ms["torch.mul"], "device_ms": device_ms["empty"],
            "library_device_ms": device_ms["torch.mul"],
            "rotating_device_ms": rotating_ms["empty"],
            "library_rotating_device_ms": rotating_ms["torch.mul"], "host_us": host_us}


def phase_p1(accel, prim, gen, err):
    """Phase 17: P1 through ``kernel_probe.run``, each probe checked against
    its plain version on N_CHECK seeded lanes.  Returns (kernels-line
    entries, launches, the primary rays' closest t)."""
    import torch

    from heatray_tpu_torch.ops import wide_bvh as wb
    from heatray_tpu_torch.ops.intersect import MISS_T
    from heatray_tpu_torch.probes import kernel_probe as kp
    from heatray_tpu_torch.probes.vpu_leaf import closest_brute_plain

    org, d = prim.org, prim.direction
    r = org.x.numel()
    recs, launches = run_probe("P1 kernel_probe", ("empty", "nodes", "rows_brute"),
                               lambda: kp.run(accel, org, d, reps=5, log=log))
    lanes = torch.randperm(r, generator=gen)[:N_CHECK].to(org.x.device)
    s_org, s_d = subset(org, lanes), subset(d, lanes)
    plain_ms = {}
    for rec in recs:
        bvh, ls = rec["bvh"], rec["leaf"]
        plain_ms["nodes", ls], (_, visits_p) = timed_once(lambda: kp.node_walk_plain(
            bvh, s_org, s_d))
        plain_ms["leaves", ls], t_p = timed_once(lambda: closest_brute_plain(
            bvh.w, s_org, s_d, bvh.wanchor))
        t_tree = wb.closest_wide_plain(bvh, s_org, s_d)[0]
        for (probe, rt), out in rec["out"].items():
            if probe == "grid":
                if not torch.equal(out[lanes], kp.empty_plain(s_org)):
                    raise AssertionError(f"P1 grid leaf {ls} rt {rt} differs")
            elif probe == "nodes":
                t, visits = out
                if not (bool((t == MISS_T).all()) and torch.equal(visits[lanes], visits_p)):
                    raise AssertionError(f"P1 nodes leaf {ls} rt {rt}: t or visits differ")
            elif probe == "leaves":
                t = out[lanes]
                for ref, what in ((t_p, "plain"), (t_tree, "closest_wide_plain")):
                    hit = ref < MISS_T
                    diff = (t - ref).abs()
                    if not torch.equal(t < MISS_T, hit) or bool(
                            (diff[hit] > TOL + TOL * ref[hit].abs()).any()):
                        raise AssertionError(f"P1 leaves leaf {ls} rt {rt} differs from {what}")
                    err["rows_brute"] = max(err["rows_brute"],
                                            float(diff[hit].max()) if hit.any() else 0.0)
        log(f"[check] P1 leaf {ls}: grid, nodes and leaves at every tile equal their plain "
            f"versions on {lanes.numel()} lanes, leaves equal closest_wide_plain; max visits "
            f"{int(visits_p.max())}, mean {float(visits_p.float().mean()):.3f}")
    rec = recs[0]  # leaf 32, tile 256: the entries
    bvh, ls = rec["bvh"], rec["leaf"]
    t_hit = rec["out"]["leaves", 256]
    work = walk_work(bvh, org, d, torch.full_like(t_hit, MISS_T), with_leaves=False)
    nodes_bound = probe_bound(f"P1 nodes on {r} rays: {work['reached']} reached, "
                              f"{work['boxes'] / r:.3f} box tests per ray",
                              work["tree_bytes"] + 32 * r, work["boxes"] * SLAB_FLOPS)
    in_range = brute_in_range(accel, org, d, t_hit)
    n_tri = accel.num_triangles
    brute = (r * 28 + n_tri * TRI_BYTES + bvh.num_chunks * ANCHOR_BYTES,
             r * n_tri * PAIR_T_FLOPS + in_range * BARY_FLOPS)
    leaves_bound = probe_bound(f"P1 leaves on {r} rays: {n_tri} triangles, "
                               f"{in_range / r:.3f} pairs in range per ray", *brute)
    ms = rec["ms"]
    grid = grid_costs(prim.org)
    entries = [
        probe_entry("nodes", ms["nodes", 256], r, (plain_ms["nodes", ls], N_CHECK), nodes_bound,
                    leaf=ls, ray_tile=256),
        probe_entry("rows_brute", ms["leaves", 256], r, (plain_ms["leaves", ls], N_CHECK),
                    leaves_bound, leaf=ls, ray_tile=256),
        probe_entry("empty", ms["grid", 256], r, (time_ms(lambda: kp.empty_plain(org), 10), r),
                    probe_bound(f"P1 grid on {r} rays", 8 * r, 0), grid["library_ms"],
                    ray_tile=256, ms_10=grid["ms_10"], device_ms=grid["device_ms"],
                    library_device_ms=grid["library_device_ms"],
                    rotating_device_ms=grid["rotating_device_ms"],
                    library_rotating_device_ms=grid["library_rotating_device_ms"],
                    host_us=grid["host_us"]),
    ]
    log(f"[compare] P1 on {r} rays, leaf {ls}, tile 256, ms a call over 5 back to back: grid "
        f"{ms['grid', 256]:.4f}, nodes {ms['nodes', 256]:.4f}, leaves "
        f"{ms['leaves', 256]:.4f}, full (K1) {ms['full', None]:.4f}")
    return entries, launches, brute


def phase_p4(accel, prim, gen, err, brute):
    """Phase 18: P4 through ``vpu_leaf.run``, each layout checked against the
    plain brute force on N_CHECK seeded lanes and against the other on all
    rays.  ``brute``: (bytes, FLOPs) of the brute force on these rays.
    Returns (kernels-line entry of the warp layout, launches, row ms)."""
    import torch

    from heatray_tpu_torch.ops.intersect import MISS_T
    from heatray_tpu_torch.probes import vpu_leaf

    org, d = prim.org, prim.direction
    r = org.x.numel()
    recs, launches = run_probe("P4 vpu_leaf", ("rows_brute", "warp_brute"),
                               lambda: vpu_leaf.run(accel, org, d, reps=5, log=log))
    lanes = torch.randperm(r, generator=gen)[:N_CHECK].to(org.x.device)
    s_org, s_d = subset(org, lanes), subset(d, lanes)
    plain = {}
    for rec in recs:
        tc = rec["tc"]
        if tc not in plain:
            plain[tc] = timed_once(lambda: vpu_leaf.closest_brute_plain(rec["w"], s_org, s_d))
        t_p = plain[tc][1]
        hit = t_p < MISS_T
        for name, key in (("rows_brute", "row_t"), ("warp_brute", "warp_t")):
            t = rec[key][lanes]
            diff = (t - t_p).abs()
            if not torch.equal(t < MISS_T, hit) or bool(
                    (diff[hit] > TOL + TOL * t_p[hit].abs()).any()):
                raise AssertionError(f"P4 {name} tc {tc} rt {rec['rt']} differs from plain")
            err[name] = max(err[name], float(diff[hit].max()) if hit.any() else 0.0)
        if rec["agree"] != 1.0 or rec["max_dt"] > TOL:
            raise AssertionError(f"P4 tc {tc} rt {rec['rt']}: layouts agree on {rec['agree']}, "
                                 f"max |dt| {rec['max_dt']}")
        # The minimum does not depend on the order of the columns: the two
        # layouts' t are equal bit for bit.
        if not torch.equal(rec["row_t"], rec["warp_t"]):
            raise AssertionError(f"P4 tc {tc} rt {rec['rt']}: warp differs from row on "
                                 f"{int((rec['row_t'] != rec['warp_t']).sum())} rays")
        log(f"[check] P4 tc {tc} rt {rec['rt']}: row and warp equal the plain brute force on "
            f"{lanes.numel()} lanes, and each other bit for bit on all {r} rays")
    rec = recs[0]  # tc 128, tile 256
    bound = probe_bound(f"P4 on {r} rays", *brute)
    entry = probe_entry("warp_brute", rec["warp_ms"], r, (plain[rec["tc"]][0], N_CHECK), bound,
                        leaf=rec["tc"], ray_tile=rec["rt"])
    return entry, launches, rec["row_ms"]


def phase_p2(cornell, gen, err, card):
    """Phase 19: P2 through ``kernel_variants.run`` on the sorted depth-2
    wavefront, each case checked on P2_TILES seeded whole tiles against its
    plain version.  Returns (kernels-line entries, launches)."""
    import torch

    from heatray_tpu_torch.ops.intersect import MISS_T
    from heatray_tpu_torch.probes import kernel_variants as kv

    scene, camera, opts, ctx, tree = cornell
    t0 = time.perf_counter()
    paths = kv.wavefront(scene, camera, ctx, opts)
    rows = kv.unanchored_rows(ctx.accel_pack.accel, tree)
    org, d = paths.org, paths.direction
    r = org.x.numel()
    torch.cuda.synchronize()
    log(f"[setup] P2 wavefront in {time.perf_counter() - t0:.2f} s: {r} lanes, "
        f"{int(paths.active.sum())} live")
    cases = kv.default_cases()
    cases += [c for c in kv.variant_cases(P2_VARIANTS)[1:] if c not in cases]
    res, launches = run_probe("P2 kernel_variants", tuple(P2_KERNELS),
                              lambda: kv.run(tree, rows, org, d, cases, reps=5, log=log))
    device = org.x.device
    plain, by_case = {}, {}
    for rec in res["cases"]:
        case = rec["case"]
        rt = case.ray_tile
        n_tiles = -(-r // rt)
        family = {"v6": ("v6", rt), "v7": ("v7", rt)}.get(case.variant, ("k1", rt))
        if family not in plain:
            # Seeded whole tiles, the last (partial at 2,048) among them, each
            # tile's lanes together so that v6's centroids are the kernel's.
            tiles = torch.cat([torch.randperm(n_tiles - 1, generator=gen)[:P2_TILES - 1],
                               torch.tensor([n_tiles - 1])])
            lanes = (tiles[:, None] * rt + torch.arange(rt)).reshape(-1)
            lanes = lanes[lanes < r].to(device)
            probe = kv.Case(family[0] if family[0] != "k1" else "v0", rt)
            ms, want = timed_once(lambda: kv.case_plain(probe, tree, rows, subset(org, lanes),
                                                        subset(d, lanes)))
            plain[family] = (lanes, want, ms, tiles.numel())
        lanes, (t_p, slot_p), _, n_checked = plain[family]
        if case.variant == "v3":
            slot_p = torch.full_like(slot_p, -1)
        t, slot = rec["t"][lanes], rec["slot"][lanes]
        hit = t_p < MISS_T
        diff = (t - t_p).abs()
        bad = (t < MISS_T) != hit
        bad |= hit & (diff > TOL + TOL * t_p.abs())
        bad |= slot != slot_p
        name = P2_QUEUES.get(case.variant, "variant_walk")
        if bool(bad.any()):
            raise AssertionError(f"P2 {case.name} rt {rt}: {int(bad.sum())} of {lanes.numel()} "
                                 f"lanes differ from the plain version (first: "
                                 f"{lanes[bad.nonzero()[:8, 0]].tolist()})")
        err[name] = max(err[name], float(diff[hit].max()) if hit.any() else 0.0)
        by_case[case.name, rt] = rec
        log(f"[check] P2 {case.name} rt {rt}: equal to the plain version on {lanes.numel()} "
            f"lanes of {n_checked} tiles; {rec['ms']:.4f} ms, {rec['tests_per_tile']:.2f} leaf "
            f"tests per tile")
    for rt in (512, 1024):
        tests = {n: by_case[n, rt]["tests"] for n in ("v0", "v1", "v2", "v3", "v4g32", "v4g128")}
        if not (torch.equal(tests["v2"], tests["v0"]) and torch.equal(tests["v3"], tests["v0"])
                and bool((tests["v1"] > tests["v0"]).all())
                and all(bool((tests[g] <= tests["v0"]).all()) for g in ("v4g32", "v4g128"))):
            raise AssertionError(f"P2 rt {rt}: the tests per tile do not follow the variants")
    k1 = res["k1"]
    if not (torch.equal(k1["t"], by_case["v0", 512]["t"])
            and torch.equal(k1["slot"], by_case["v0", 512]["slot"])):
        raise AssertionError("P2: v0 differs from K1 on the wavefront")
    log(f"[check] P2: v2 and v3 ran v0's tests, v1 more, v4 no more; v0 equals K1 on all {r} "
        f"lanes")
    bound_ms, bound_by = bound(r, walk_work(tree, org, d, k1["t"]), False)
    # Each case's own work bound: its ray-chunk tests times the chunk's
    # columns, each pair's t at least (PAIR_T_FLOPS).
    work_ms = {key: float(rec["tests"].double().sum()) * tree.leaf_size * PAIR_T_FLOPS
               / PEAK_FLOPS * 1e3 for key, rec in by_case.items()}
    entries = []
    for name, (replaces, case_name, rt) in P2_KERNELS.items():
        rec = by_case[case_name, rt]
        mine = [key for key, other in by_case.items()
                if P2_QUEUES.get(other["case"].variant, "variant_walk") == name]
        family = {"v6": ("v6", rt), "v7": ("v7", rt)}.get(rec["case"].variant, ("k1", rt))
        lanes, _, plain_ms, _ = plain[family]
        entries.append({
            "name": name, "route": "cuda", "source": P2_SOURCE, "replaces": replaces,
            "launches": 0, "max_abs_err": 0.0, "ms": rec["ms"], "rays": r,
            "plain_ms": plain_ms, "plain_rays": lanes.numel(), "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "case": case_name, "ray_tile": rt,
            "settings": {f"{n}@{t}": by_case[n, t]["ms"] for n, t in mine},
            "tests_per_tile": {f"{n}@{t}": by_case[n, t]["tests_per_tile"] for n, t in mine},
            "work_bound_ms": work_ms[case_name, rt],
            "work_bound_ms_settings": {f"{n}@{t}": work_ms[n, t] for n, t in mine},
            "k1_ms": k1["ms"],
        })
    log(f"[compare] P2 on {r} lanes of the sorted depth-2 wavefront: "
        + ", ".join(f"{n}@{t} {rec['ms']:.4f} ms ({rec['tests_per_tile']:.1f} tests/tile)"
                    for (n, t), rec in by_case.items())
        + f"; K1 {k1['ms']:.4f} ms; card {card}")
    v0 = by_case["v0", 512]
    log(f"[compare] P2a variant_walk v0, tile 512: {v0['ms']:.4f} ms, "
        f"{bound_ms / v0['ms']:.2%} of K1's {bound_ms:.4f} ms bound ({bound_by}) and "
        f"{work_ms['v0', 512] / v0['ms']:.2%} of its own {work_ms['v0', 512]:.4f} ms "
        f"({v0['tests_per_tile']:.3f} leaf tests a ray x {tree.leaf_size} columns x "
        f"{PAIR_T_FLOPS} FLOP); K1 on the same rays {k1['ms']:.4f} ms; card {card}")
    log("[compare] P2b-d queue_walk at their entries' cases: " + "; ".join(
        f"{e['name']} {e['case']}@{e['ray_tile']} {e['ms']:.4f} ms, "
        f"{bound_ms / e['ms']:.2%} of K1's {bound_ms:.4f} ms bound and "
        f"{e['work_bound_ms'] / e['ms']:.2%} of its own {e['work_bound_ms']:.4f} ms "
        f"({by_case[e['case'], e['ray_tile']]['tests_per_tile']:.3f} leaf tests a ray)"
        for e in entries if e["name"] in P2_QUEUES.values())
        + f"; K1 on the same rays {k1['ms']:.4f} ms; card {card}")
    return entries, launches


# The appearance slice (phase 20): config5's depth, a 2k lat/long map, the
# texture sizes of Scene B, the NaN/Inf detectors' clean ceiling at that depth
# (``tests/test_goldens.py:195``) and the card-against-CPU bound of F6.
APPEARANCE_DEPTH = 5
ENV_SIZE = (1024, 2048)
TEX, TEX_SMALL = 2048, 1024
CLEAN_CEILING = 0.1 * (2 * APPEARANCE_DEPTH + 1) + 1e-5
CPU_TOL = 5.6e-5
POST_TOL = 1e-5
AOV_MODES = ("GEOMETRIC_NORMALS", "UVS", "BASE_COLOR", "NORMALMAP", "SHADER", "NANS", "INFS")


def appearance_scenes(device):
    """Scene A, ``multi_material`` lit by the 2k procedural studio map, and
    Scene B: the same layout with seeded textures, an sRGB checker base
    colour, a normal map and a metallic-roughness map on the ground plane
    (TEX x TEX each), clearcoat 1.0 with a clearcoat-normal map on the metal
    sphere, and a double-sided alpha-masked cut-out quad (TEX_SMALL) between
    the camera and the glass sphere."""
    import math

    import numpy as np

    from heatray_tpu_torch.scene.builtin import multi_material
    from heatray_tpu_torch.scene.environments import get_environment
    from heatray_tpu_torch.scene.geometry import rotate, translate
    from heatray_tpu_torch.scene.lights import EnvironmentLightDesc
    from heatray_tpu_torch.scene.materials import GlassParams, PBRParams
    from heatray_tpu_torch.scene.providers import plane_mesh, sphere_mesh
    from heatray_tpu_torch.scene.scene import SceneBuilder

    env = EnvironmentLightDesc(image=get_environment("studio", *ENV_SIZE))
    scene_a = multi_material(env=env)

    rng = np.random.default_rng(SEED)
    yy, xx = np.meshgrid(np.arange(TEX, dtype=np.float32) / TEX,
                         np.arange(TEX, dtype=np.float32) / TEX, indexing="ij")
    checker = ((np.floor(xx * 16) + np.floor(yy * 16)) % 2).astype(np.float32)
    base = np.stack([0.25 + 0.6 * checker, 0.55 - 0.3 * checker, 0.35 + 0.2 * checker], -1)
    base += 0.06 * rng.standard_normal(base.shape, dtype=np.float32)
    nrm = np.stack([0.35 * np.sin(2 * math.pi * 24 * xx), 0.35 * np.sin(2 * math.pi * 24 * yy),
                    np.ones_like(xx)], -1)
    nrm += 0.05 * rng.standard_normal(nrm.shape, dtype=np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    mr = np.stack([np.zeros_like(xx), 0.25 + 0.75 * checker, 0.5 * (1.0 - checker)], -1)
    cc = nrm[::2, ::2].copy()
    cc[..., :2] *= -1.0
    ys, xs = np.meshgrid(np.arange(TEX_SMALL) / TEX_SMALL, np.arange(TEX_SMALL) / TEX_SMALL,
                         indexing="ij")
    cut = np.ones((TEX_SMALL, TEX_SMALL, 4), np.float32)
    cut[..., :3] = rng.uniform(0.3, 0.9, 3).astype(np.float32)
    cut[..., 3] = ((np.hypot((xs * 8) % 1 - 0.5, (ys * 8) % 1 - 0.5)) > 0.3).astype(np.float32)

    b = SceneBuilder()
    b.add_mesh(plane_mesh(15, 15, "Plane"), PBRParams(
        base_color=(0.9, 0.9, 0.9), metallic=0.0, roughness=1.0, specular_f0=0.0, name="Ground",
        base_color_tex=b.add_texture(np.clip(base, 0, 1), srgb=True),
        normal_tex=b.add_texture(nrm * 0.5 + 0.5),
        metallic_roughness_tex=b.add_texture(mr)), transform=translate([0.0, -1.5, 0.0]))
    b.add_mesh(sphere_mesh(50, 50, 1.0, "Sphere"), PBRParams(
        base_color=(0.4, 0.4, 0.4), metallic=1.0, roughness=0.1, specular_f0=0.3, name="PBR",
        clearcoat=1.0, clearcoat_normal_tex=b.add_texture(cc * 0.5 + 0.5)),
        transform=translate([-0.9, -0.5, -0.8]))
    b.add_mesh(sphere_mesh(50, 50, 1.0, "Sphere"), GlassParams(
        base_color=(0.9, 0.6, 0.6), roughness=0.1, ior=1.57, density=0.5, name="Glass"),
        transform=translate([1.2, -0.5, 0.8]))
    # Facing the camera (orbit distance 6, theta 0.3), 45% of the way from
    # the glass sphere toward it.
    b.add_mesh(plane_mesh(1.2, 1.2, "Cut-out"), PBRParams(
        base_color_tex=b.add_texture(cut), double_sided=True, alpha_masked=True,
        roughness=0.5, name="Cut-out"),
        transform=translate([0.66, 0.52, 3.02]) @ rotate(math.pi / 2 - 0.3, [1, 0, 0]))
    b.set_environment(env)
    scene_b = b.build()
    if not (scene_b.has_textures and scene_b.has_alpha_mask):
        raise AssertionError("Scene B has no textures or no alpha mask")
    return scene_a.to(device), scene_b.to(device)


def golden_scene(name):
    """(scene, camera, options) of ``tests/test_goldens.py``'s config3
    (clearcoat under a 16x32 lat/long sky) or config5 (``multi_material``,
    whose golden is the ACES display image), built with the port."""
    import numpy as np

    from heatray_tpu_torch import orbit_camera
    from heatray_tpu_torch.options import RenderOptions
    from heatray_tpu_torch.scene.builtin import multi_material
    from heatray_tpu_torch.scene.lights import EnvironmentLightDesc
    from heatray_tpu_torch.scene.materials import PBRParams
    from heatray_tpu_torch.scene.providers import sphere_mesh
    from heatray_tpu_torch.scene.scene import SceneBuilder

    g = 48
    if name == "config5_full_aces":
        return (multi_material(), orbit_camera(g, g, distance=6.0, theta=0.3),
                RenderOptions(width=g, height=g, max_render_passes=4, max_ray_depth=5))
    b = SceneBuilder()
    b.add_mesh(sphere_mesh(24, 24, 1.0), PBRParams(
        base_color=(0.6, 0.1, 0.1), metallic=0.8, roughness=0.25, clearcoat=1.0,
        clearcoat_roughness=0.1, specular_f0=0.5))
    sky = np.linspace(3.0, 0.05, 16, dtype=np.float32)[:, None, None]
    b.set_environment(EnvironmentLightDesc(image=np.broadcast_to(sky, (16, 32, 3)).copy()))
    return (b.build(), orbit_camera(g, g, distance=4.0, theta=0.3),
            RenderOptions(width=g, height=g, max_render_passes=4, max_ray_depth=3))


def kernels_per_pass(fn):
    """(CUDA kernels, their summed device ms) the profiler records in one
    call of ``fn``, or None where it records none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.key_averages() if e.device_type == cuda]
    n = sum(e.count for e in kernels)
    return (n, sum(e.self_device_time_total for e in kernels) / 1e3) if n else None


def phase_appearance(gen, err, card):
    """Phase 20: the appearance slice (see the module docstring).  Returns
    K1's and K2's launches on the paths of Scenes A and B."""
    import numpy as np
    import torch

    from heatray_tpu_torch import make_loss_fn, orbit_camera, render, resolve
    from heatray_tpu_torch.options import AOV, FrameGlobals, RenderOptions
    from heatray_tpu_torch.post import PostProcessingParams, apply_post_pipeline
    from heatray_tpu_torch.render import integrator

    t_phase = time.perf_counter()
    device = torch.device(DEVICE)
    names = ("closest_wide", "any_wide")
    t0 = time.perf_counter()
    scene_a, scene_b = appearance_scenes(device)
    atlas = scene_b.atlas
    log(f"[appearance] scenes in {time.perf_counter() - t0:.1f} s: a {ENV_SIZE[0]}x{ENV_SIZE[1]} "
        f"map; Scene B's atlas {atlas.num_textures} textures, {atlas.num_levels} levels, "
        f"{atlas.data.numel() * 4 / 2**20:.1f} MiB")
    opts = RenderOptions(width=WIDTH, height=HEIGHT, max_render_passes=64,
                         max_ray_depth=APPEARANCE_DEPTH)
    camera = orbit_camera(WIDTH, HEIGHT, distance=6.0, theta=0.3).to(device)
    zero = torch.zeros((4, HEIGHT, WIDTH), dtype=torch.float32, device=device)
    plain_opts = dataclasses.replace(opts, sort_bounces=False, gate_bounces=False)
    post = PostProcessingParams(tonemapping_enabled=True)
    out, launches = {}, {}
    for label, scene in (("scene_a", scene_a), ("scene_b", scene_b)):
        ctx = integrator.make_context(opts, scene, device)
        pack = ctx.accel_pack
        if pack.route != "wide" or pack.shade_table.shape[1] != (83 if scene.has_textures else 51):
            raise AssertionError(f"{label}: route {pack.route!r}, table {pack.shade_table.shape}")
        check_path_rays(names, scene, camera, ctx, opts, gen, label, err, exact=True)
        readings = {}
        launches[label], img = run_path(label, scene, camera, ctx, opts, names, readings)
        accum = readings["accum"]
        steady_s = sum(readings["pass_ms"][1:]) / 1e3
        ms = 1e3 * steady_s / (PASSES - 1)
        mrays = sum(readings["pass_rays"][1:]) / steady_s / 1e6
        n_kernels = kernels_per_pass(lambda: integrator.render_pass(
            scene, camera, ctx, opts, FrameGlobals.create(PASSES, device=device), zero))

        # Sorted and gated against unsorted, bit for bit.
        frame = FrameGlobals.create(5, device=device)
        one = {on: integrator.render_pass(scene, camera, ctx, opts if on else plain_opts, frame,
                                          zero) for on in (True, False)}
        if not torch.equal(one[True], one[False]):
            d = (one[True] - one[False]).abs()
            raise AssertionError(f"{label}: sorted+gated pass differs from unsorted: "
                                 f"{int((d > 0).sum())} values, max {float(d.max())}")

        # The ACES display image on the card against the same call on the CPU.
        shown = apply_post_pipeline(accum, post)
        shown_cpu = apply_post_pipeline(accum.cpu(), post)
        d_post = float((shown.cpu() - shown_cpu).abs().max())
        if not (bool(torch.isfinite(shown).all()) and d_post <= POST_TOL):
            raise AssertionError(f"{label}: ACES image on the card differs from the CPU's "
                                 f"by {d_post}")
        prof = ("not measured" if n_kernels is None else
                f"{n_kernels[0]} ({n_kernels[1]:.1f} kernel ms, {n_kernels[1] / ms:.0%} of the "
                f"steady ms/pass)")
        log(f"[appearance] {label} {WIDTH}x{HEIGHT} depth {APPEARANCE_DEPTH}: steady ms/pass "
            f"{ms:.3f} (passes 2-{PASSES}), {mrays:.3f} Mrays/s, kernels per pass {prof}, "
            f"peak memory "
            f"{readings['peak_mib']:.1f} MiB; K1 {launches[label]['closest_wide']}, K2 "
            f"{launches[label]['any_wide']} launches in {PASSES} passes; sorted+gated = "
            f"unsorted bit for bit; ACES card against CPU max |diff| {d_post:.3g}; card {card}")
        out[label] = (ctx, img, one[True])

    # Scene B differs from A, and the pass-through ran: B with every alpha
    # at 1 differs from B.
    n_diff = int(((out["scene_a"][1] - out["scene_b"][1]).abs().amax(dim=2) > 0).sum())
    opaque = dataclasses.replace(scene_b, atlas=dataclasses.replace(atlas, data=torch.cat(
        [atlas.data[:3], torch.ones_like(atlas.data[3:])])))
    solid = integrator.render_pass(opaque, camera, out["scene_b"][0], opts,
                                   FrameGlobals.create(5, device=device), zero)
    n_cut = int(((solid - out["scene_b"][2]).abs()[:3].amax(dim=0) > 0).sum())
    if n_diff == 0 or n_cut == 0:
        raise AssertionError(f"Scene B differs from A on {n_diff} pixels, from B with opaque "
                             f"texels on {n_cut}")
    log(f"[appearance] Scene B differs from A on {n_diff} pixels; B with every alpha at 1 "
        f"differs from B on {n_cut} pixels of one pass (the pass-through)")
    del solid, opaque

    # K6a and K6b on Scene B under "bvh": K6b over the occluder tree built
    # without the cut-out quad, whose block boxes bound only what it holds.
    bvh_b_opts = dataclasses.replace(opts, intersect_backend="bvh")
    bvh_b = integrator.make_context(bvh_b_opts, scene_b, device)
    tree, occl = bvh_b.accel_pack.bvh, bvh_b.accel_pack.bvh_occl
    held, kept = int((tree.slot_tri >= 0).sum()), int((occl.slot_tri >= 0).sum())
    if occl is tree or not 0 < kept < held:
        raise AssertionError(f"Scene B's occluder tree holds {kept} of {held} triangles")
    check_path_rays(("closest_bvh", "any_bvh"), scene_b, camera, bvh_b, bvh_b_opts, gen,
                    "scene_b bvh", err, exact=True)
    log(f"[appearance] Scene B under 'bvh': K6b over the occluder tree of {kept} of {held} "
        f"triangles ({occl.num_chunks} leaves) equals its plain version at the path's shapes")
    del bvh_b, tree, occl

    # AOVs at 1080p on Scene B, one pass each.
    ctx_b = out["scene_b"][0]
    for mode in AOV_MODES:
        aov = AOV[mode]
        reset_launches()
        accum = integrator.render_pass(scene_b, camera, ctx_b, dataclasses.replace(opts, aov=aov),
                                       FrameGlobals.create(0, device=device), zero)
        img = resolve(accum)
        hi = float(img.max())
        k1 = read_launches()["closest_wide"]
        if not bool(torch.isfinite(img).all()) or hi <= 0.0:
            raise AssertionError(f"AOV {mode}: not finite, or black")
        if aov in (AOV.NANS, AOV.INFS) and hi > CLEAN_CEILING:
            raise AssertionError(f"AOV {mode}: detector fired, max {hi}")
        if aov not in (AOV.NANS, AOV.INFS) and k1 != 1:
            raise AssertionError(f"AOV {mode}: {k1} K1 launches, not 1")
        log(f"[appearance] AOV {mode} on Scene B: finite, max {hi:.4g}, K1 launches {k1}")
    del ctx_b

    # Goldens config3 and config5 on the card, against the golden and the CPU.
    for name in ("config3_pbr_env", "config5_full_aces"):
        scene, cam, g_opts = golden_scene(name)
        imgs = {}
        for where, dev in (("card", device), ("cpu", torch.device("cpu"))):
            accum, _ = render(scene, cam, g_opts, num_passes=4, device=dev)
            accum = accum.cpu()
            imgs[where] = (resolve(accum), apply_post_pipeline(accum, post)
                           if name == "config5_full_aces" else resolve(accum))
        golden = np.load(REPO / "tests" / "goldens" / f"{name}.npy").astype(np.float32)
        np.testing.assert_allclose(imgs["card"][1].numpy(), golden, rtol=5e-3, atol=5e-3)
        d_cpu = float((imgs["card"][0] - imgs["cpu"][0]).abs().max())
        if not d_cpu <= CPU_TOL:
            raise AssertionError(f"{name}: card against CPU max |diff| {d_cpu}")
        log(f"[golden] {name} 48x48x4 on the card matches, max |diff| "
            f"{float(np.abs(imgs['card'][1].numpy() - golden).max()):.3g}; against the CPU's "
            f"render {d_cpu:.3g}")

    # One fwd+bwd step over env.map and env.rotation on Scene A, remat on.
    ctx_a = out["scene_a"][0]
    params = {"env.map": scene_a.lights.env_map.clone().requires_grad_(True),
              "env.rotation": torch.zeros((), device=device, requires_grad=True)}
    loss_fn = make_loss_fn(scene_a, camera, ctx_a, opts, torch.zeros((HEIGHT, WIDTH, 3)))
    lanes, gated = [], integrator._gated_lanes

    def count_lanes(*args):
        lanes.append(gated(*args))
        return lanes[-1]

    integrator._gated_lanes = count_lanes
    try:
        torch.cuda.synchronize()
        reset_launches()
        loss = loss_fn(params)
        torch.cuda.synchronize()
        fwd = read_launches()
        reset_launches()
        loss.backward()
        torch.cuda.synchronize()
        bwd = read_launches()
    finally:
        integrator._gated_lanes = gated
    runs = 1 + sum(n > 0 for n in lanes)
    expect = {name: runs if name in names else 0 for name in fwd}
    if fwd != expect or any(bwd.values()):
        raise AssertionError(f"env step launches: forward {fwd}, backward {bwd}; expected "
                             f"forward {expect} and none in the backward")
    g_map, g_rot = params["env.map"].grad, params["env.rotation"].grad
    if not (bool(torch.isfinite(g_map).all()) and bool(torch.isfinite(g_rot))
            and float(g_map.abs().sum()) > 0.0):
        raise AssertionError(f"env step gradients: map finite {bool(torch.isfinite(g_map).all())},"
                             f" |sum| {float(g_map.abs().sum())}; rotation {float(g_rot)}")
    for v in params.values():
        v.grad = None
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss_fn(params, 1).backward()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    log(f"[appearance] fwd+bwd step over env.map and env.rotation, Scene A {WIDTH}x{HEIGHT} "
        f"depth {APPEARANCE_DEPTH}, remat_bounces=True: {step_ms:.3f} ms (the second step), "
        f"peak memory {peak / 2**20:.1f} MiB, {(peak - held) / 2**20:.1f} MiB above the "
        f"{held / 2**20:.1f} held before the step; K1 {fwd['closest_wide']}"
        f", K2 {fwd['any_wide']} in the forward (gated lanes {lanes}), none in the backward; "
        f"env.map gradient: {int((g_map != 0).sum())} of {g_map.numel()} nonzero, max "
        f"{float(g_map.abs().max()):.4g}; env.rotation gradient {float(g_rot):.4g}; card {card}")
    log(f"[appearance] phase 20 took {time.perf_counter() - t_phase:.1f} s")
    return {label: {name: launches[label][name] for name in names} for label in launches}


# The ingest slice (phase 21): the built-in environment the loaded files are
# lit by, the Scene group's edit of the session, and the GLB's texture size.
INGEST_ENV = "studio"
SESSION_YAW, SESSION_SCALE = 0.6, 1.25
INGEST_TEX = 256


def sorted_triangles(scene):
    """(T, 9) corner positions of every triangle, rows sorted: a scene's
    triangle set, whatever the order of its vertices and triangles."""
    import numpy as np

    p = scene.geometry.positions.cpu().numpy().T
    t = p[scene.geometry.indices.cpu().numpy().T].reshape(-1, 9)
    return t[np.lexsort(t.T[::-1])]


def counted_cli(argv, names):
    """``cli.main(argv)`` with the launch counts set to 0 just before and
    read just after; each kernel of ``names`` must have run once per bounce
    with live lanes, no other kernel at all.  Returns the launches."""
    from heatray_tpu_torch import cli
    from heatray_tpu_torch.render import integrator

    lanes, gated = [], integrator._gated_lanes

    def count_lanes(*args):
        lanes.append(gated(*args))
        return lanes[-1]

    integrator._gated_lanes = count_lanes
    try:
        reset_launches()
        if cli.main(argv) != 0:
            raise AssertionError(f"cli.main({argv}) failed")
        launches = read_launches()
    finally:
        integrator._gated_lanes = gated
    runs = PASSES + sum(n > 0 for n in lanes)
    if any(launches[n] != runs for n in names) or any(
            v for n, v in launches.items() if n not in names):
        raise AssertionError(f"cli render launches {launches}, not {runs} of each of {names}")
    return launches


NATIVE_NORMAL_TOL = 1e-6  # the C++ normals against numpy's summation order
NATIVE_MASK_SHARE = 0.7  # the triangles a seeded occluder mask keeps


def host_cpu() -> str:
    """The host CPU's model (its name, vendor, family, model and stepping
    as the first processor of ``/proc/cpuinfo`` gives them), architecture
    and the cores this process may use."""
    import platform

    keys = ("model name", "vendor_id", "cpu family", "model", "stepping", "CPU implementer",
            "CPU part")
    found = {}
    with contextlib.suppress(OSError):
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break  # the first processor's block only
                key, _, value = line.partition(":")
                if key.strip() in keys:
                    found[key.strip()] = value.strip()
    model = "; ".join(f"{k} {found[k]}" for k in keys if k in found) or "no /proc/cpuinfo"
    return f"{model}; {platform.machine()}, {len(os.sched_getaffinity(0))} cores"


class HostSplit:
    """Seconds of each host step under ``with HostSplit() as split:``, each
    step's own (less the steps it calls).  Every point is a module's
    function or a class's method that the port looks up at call time; the
    card is synchronised around each step, so a step's device work counts
    in it."""

    POINTS = (
        ("heatray_tpu_torch.scene.loaders", "load_gltf", "parse"),
        ("heatray_tpu_torch.scene.geometry", "compute_vertex_normals", "normals"),
        ("heatray_tpu_torch.scene.scene", "merge_meshes", "merge"),
        ("heatray_tpu_torch.native", "morton_order", "Morton order"),
        ("heatray_tpu_torch.render.integrator", "build_woop", "Woop rows"),
        ("heatray_tpu_torch.native", "bvh_build", "tree build"),
        ("heatray_tpu_torch.render.integrator", "build_wide_bvh", "wide collapse and packing"),
        ("heatray_tpu_torch.ops.wide_bvh", "slot_boxes", "block boxes"),
        ("heatray_tpu_torch.ops.wide_bvh", "leaf_blocks", "block boxes"),
        ("heatray_tpu_torch.render.integrator", "pass_pack", "shading table"),
        ("heatray_tpu_torch.render.integrator", "build_tables", "sample tables"),
        ("heatray_tpu_torch.render.integrator", "multiscatter_lut_packed", "multiscatter table"),
        ("heatray_tpu_torch.render.integrator", "render_pass", "passes"),
        ("heatray_tpu_torch.cli", "_save", "output"),
        ("heatray_tpu_torch.scene.edit", "apply_transform", "scene edit"),
        ("heatray_tpu_torch.interactive", "InteractiveRenderer.poll_and_apply", "poll and apply"),
        ("heatray_tpu_torch.interactive", "InteractiveRenderer.step", "passes"),
        ("heatray_tpu_torch.interactive", "InteractiveRenderer.publish", "publish"),
    )

    def __init__(self):
        self.seconds, self.calls, self._stack, self._saved = {}, {}, [], []

    def _sync(self):
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def _wrap(self, label, fn):
        def timed(*args, **kwargs):
            self._sync()
            self._stack.append(0.0)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self._sync()
                dt = time.perf_counter() - t0
                inner = self._stack.pop()
                if self._stack:
                    self._stack[-1] += dt
                self.seconds[label] = self.seconds.get(label, 0.0) + dt - inner
                self.calls[label] = self.calls.get(label, 0) + 1
        return timed

    def __enter__(self):
        import importlib

        for module, attr, label in self.POINTS:
            owner = importlib.import_module(module)
            *path, name = attr.split(".")  # a module's function, or a class's method
            for part in path:
                owner = getattr(owner, part)
            self._saved.append((owner, name, getattr(owner, name)))
            setattr(owner, name, self._wrap(label, getattr(owner, name)))
        loaders = importlib.import_module("heatray_tpu_torch.scene.loaders")
        self._loaders = dict(loaders._LOADERS)
        for suffix, fn in self._loaders.items():
            loaders._LOADERS[suffix] = self._wrap("parse", fn)
        self._sync()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import importlib

        self._sync()
        self.total = time.perf_counter() - self.t0
        for mod, name, fn in reversed(self._saved):
            setattr(mod, name, fn)
        importlib.import_module("heatray_tpu_torch.scene.loaders")._LOADERS.update(self._loaders)
        return False

    def line(self) -> str:
        """``total: step seconds (calls), ..., rest``."""
        parts = [f"{k} {v:.3f} s ({self.calls[k]})" for k, v in self.seconds.items()]
        rest = self.total - sum(self.seconds.values())
        return f"{self.total:.3f} s: {', '.join(parts)}, rest {rest:.3f} s"


def native_checks(geo, card):
    """The host library on ``geo`` (``high_poly``'s merged geometry, on the
    CPU) against its numpy twins; logs the host seconds of each."""
    import numpy as np

    from heatray_tpu_torch import native
    from heatray_tpu_torch.ops.bvh import build_topology, build_topology_plain
    from heatray_tpu_torch.ops.intersect import build_woop
    from heatray_tpu_torch.scene import geometry

    def timed(fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        return out, time.perf_counter() - t0

    accel = build_woop(geo.positions, geo.indices)
    tri_min, tri_max = accel.tri_min.numpy(), accel.tri_max.numpy()
    t_count = tri_min.shape[1]
    mask = np.random.default_rng(SEED).random(t_count) < NATIVE_MASK_SHARE
    readings = []
    for label, kw in (("leaf 32", {"leaf_size": 32}), ("leaf 128", {"leaf_size": 128}),
                      (f"occluder leaf 128 ({int(mask.sum())} triangles)",
                       {"leaf_size": 128, "include": mask})):
        fast, t_fast = timed(build_topology, tri_min, tri_max, **kw)
        plain, t_plain = timed(build_topology_plain, tri_min, tri_max, **kw)
        differ = [f for f in ("nbox", "leaf_chunk", "skip", "slot_tri")
                  if not np.array_equal(getattr(fast, f), getattr(plain, f))]
        if differ:
            raise AssertionError(f"high_poly {label}: build_topology and build_topology_plain "
                                 f"differ in {differ}")
        readings.append(f"{label} {t_fast:.4f} s against plain {t_plain:.4f} s "
                        f"({fast.num_nodes} nodes, equal)")
    pos, idx = geo.positions.numpy().T.copy(), geo.indices.numpy().T.copy()
    order, t_fast = timed(native.morton_order, pos, idx)
    order_plain, t_plain = timed(geometry.morton_order_plain, pos, idx)
    if not np.array_equal(order, order_plain):
        raise AssertionError("high_poly: native.morton_order differs from morton_order_plain")
    readings.append(f"Morton order {t_fast:.4f} s against plain {t_plain:.4f} s (equal)")
    normals, t_fast = timed(geometry.compute_vertex_normals, pos, idx)
    normals_plain, t_plain = timed(geometry.compute_vertex_normals_plain, pos, idx)
    diff = float(np.abs(normals - normals_plain).max())
    if not diff <= NATIVE_NORMAL_TOL:
        raise AssertionError(f"high_poly normals {diff} off the plain twin's")
    readings.append(f"normals {t_fast:.4f} s against plain {t_plain:.4f} s (max |diff| "
                    f"{diff:.3g}, {int((normals != normals_plain).sum())} of {normals.size} "
                    f"components differ)")
    log(f"[native] high_poly ({t_count} triangles), host seconds: {'; '.join(readings)}; "
        f"host {host_cpu()}; card {card}")


def phase_ingest(gen, err, card):
    """Phase 21: the ingest slice (see the module docstring).  Returns K1's,
    K2's, K3a's and K3b's launches in the two ``cli`` renders."""
    import importlib.util
    import tempfile

    import numpy as np
    import torch

    from heatray_tpu_torch import (
        cli, cornell_box, high_poly, load_model_scene, render, resolve, scene_aabb,
    )
    from heatray_tpu_torch.io_utils import session as session_io
    from heatray_tpu_torch.io_utils.image import load_image, save_ldr
    from heatray_tpu_torch.io_utils.png import read_png
    from heatray_tpu_torch.ops import wide_bvh
    from heatray_tpu_torch.ops.intersect import build_woop
    from heatray_tpu_torch.options import FrameGlobals, RenderOptions
    from heatray_tpu_torch.post import PostProcessingParams, apply_post_pipeline
    from heatray_tpu_torch.render import integrator
    from heatray_tpu_torch.scene import export

    t_phase = time.perf_counter()
    device = torch.device(DEVICE)
    builtin = {"hp": high_poly(), "cornell": cornell_box(light="both", with_spheres=True)}
    native_checks(builtin["hp"].geometry, card)
    aabb = scene_aabb(builtin["hp"].geometry)
    hp_orbit = [str(3.0 * 0.5 * float(np.linalg.norm(aabb[1] - aabb[0]))), "0", "0.35"]
    (REPO / "build").mkdir(exist_ok=True)
    out = {}
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        tmp = Path(tmp)
        tex = np.random.default_rng(SEED).integers(0, 256, (INGEST_TEX, INGEST_TEX, 3),
                                                   dtype=np.int64).astype(np.uint8)
        files = {"hp.ply": export.write_ply, "hp.obj": export.write_obj,
                 "hp.glb": lambda p, s: export.write_glb(p, s, texture=tex),
                 "cornell.obj": export.write_obj}
        loaded, load_s = {}, {}
        split_opts = RenderOptions(width=WIDTH, height=HEIGHT, max_render_passes=PASSES,
                                   max_ray_depth=DEPTH)
        for name, write in files.items():
            write(str(tmp / name), builtin[name.split(".")[0]])
            with HostSplit() as split:
                loaded[name] = load_model_scene(str(tmp / name))
            load_s[name] = split.total
            if name.startswith("hp."):
                with HostSplit() as ctx_split:
                    split_ctx = integrator.make_context(split_opts, loaded[name].to(device),
                                                        device)
                log(f"[ingest] {name} host split: load_model_scene {split.line()}; "
                    f"make_context ({split_ctx.accel_pack.backend!r}) {ctx_split.line()}; "
                    f"host {host_cpu()}; card {card}")
                del split_ctx
            ref = builtin[name.split(".")[0]]
            n, n_ref = loaded[name].geometry.num_triangles, ref.geometry.num_triangles
            if n != n_ref or not np.array_equal(sorted_triangles(loaded[name]),
                                                sorted_triangles(ref)):
                raise AssertionError(f"{name}: {n} triangles, not the built-in's {n_ref}, or "
                                     f"other positions")
        glb = loaded["hp.glb"]
        if not (glb.has_textures and glb.lights.num_directional == 1):
            raise AssertionError("hp.glb lost its texture or its light")
        log(f"[ingest] host seconds to load {', '.join(f'{k} {v:.2f}' for k, v in load_s.items())}"
            f" ({builtin['hp'].geometry.num_triangles} and "
            f"{builtin['cornell'].geometry.num_triangles} triangles, each set equal to the "
            f"built-in's); card {card}")

        cases = {"hp.ply": (("closest_stream", "any_stream"), "stream", hp_orbit, ()),
                 "cornell.obj": (("closest_wide", "any_wide"), "wide", ["6.2", "0", "0"],
                                 ("--focal-length", "35"))}
        for name, (names, backend, orbit, extra) in cases.items():
            label = f"ingest {name}"
            exr = tmp / f"{name}.exr"
            argv = ["render", "--scene", str(tmp / name), "--size", str(WIDTH), str(HEIGHT),
                    "--depth", str(DEPTH), "--passes", str(PASSES), "--env", INGEST_ENV,
                    "--orbit", *orbit, *extra]
            with HostSplit() as split:
                launches = counted_cli([*argv, "--out", str(exr)], names)
            log(f"[ingest] {name} cli render ({WIDTH}x{HEIGHT}, {PASSES} passes, counted) host "
                f"split {split.line()}; host {host_cpu()}; card {card}")
            scene, camera, opts = cli.build(cli.make_parser().parse_args(argv))
            scene, camera = scene.to(device), camera.to(device)
            ctx = integrator.make_context(opts, scene, device)
            if ctx.accel_pack.backend != backend:
                raise AssertionError(f"{label}: backend {ctx.accel_pack.backend!r}")
            check_path_rays(names, scene, camera, ctx, opts, gen, label, err, exact=True)

            # The EXR is the direct render rounded to half, bit for bit.
            accum, _ = render(scene, camera, opts, num_passes=PASSES, ctx=ctx, device=device)
            direct = resolve(accum).cpu().numpy()
            read = load_image(str(exr))
            if not np.array_equal(read, direct.astype(np.float16).astype(np.float32)):
                raise AssertionError(f"{label}: the EXR differs from the direct render in half")

            readings = {}
            _, img = run_path(label, scene, camera, ctx, opts, names, readings)
            if not torch.equal(readings["accum"], accum):
                raise AssertionError(f"{label}: render_pass differs from render")
            zero = torch.zeros_like(accum)
            n_kernels = kernels_per_pass(lambda: integrator.render_pass(
                scene, camera, ctx, opts, FrameGlobals.create(PASSES, device=device), zero))
            steady_s = sum(readings["pass_ms"][1:]) / 1e3
            prof = ("not measured" if n_kernels is None else
                    f"{n_kernels[0]} ({n_kernels[1]:.1f} kernel ms)")
            log(f"[ingest] {name} {WIDTH}x{HEIGHT} depth {DEPTH} through cli: steady ms/pass "
                f"{1e3 * steady_s / (PASSES - 1):.3f} (passes 2-{PASSES}), "
                f"{sum(readings['pass_rays'][1:]) / steady_s / 1e6:.3f} Mrays/s, kernels per "
                f"pass {prof}, peak memory {readings['peak_mib']:.1f} MiB; cli launches "
                f"{ {n: launches[n] for n in names} }; EXR = direct render in half; card {card}")

            # Against the built-in's geometry under the loaded file's materials
            # and light: the PLY has one material, the OBJ one per built-in id.
            geo = builtin[name.split(".")[0]].geometry
            if name == "hp.ply":
                geo = dataclasses.replace(geo, material_ids=torch.zeros_like(geo.material_ids))
            ref_scene = dataclasses.replace(scene, geometry=geo).to(device)
            ref, _ = render(ref_scene, camera, opts, num_passes=PASSES, device=device)
            compare_images(label, img, resolve(ref), "built-in geometry")
            out[name] = (scene, camera, opts, ctx, accum, launches)
            del ref_scene, ref, readings, zero

        # A session naming the PLY, rotated and scaled by its Scene group.
        values = {"RenderOptions": {"Scene": str(tmp / "hp.ply"), "MaxRayDepth": DEPTH,
                                    "MaxRenderPasses": PASSES},
                  "Camera": {"OrbitDistance": float(hp_orbit[0]), "OrbitTheta": 0.35},
                  "Scene": {"RotationYaw": SESSION_YAW, "Scale": SESSION_SCALE}}
        session_io.Session(values).write(str(tmp / "s.json"))
        t0 = time.perf_counter()
        s_scene, s_camera, s_opts = session_io.load_session(str(tmp / "s.json"),
                                                            override_size=(WIDTH, HEIGHT))
        s_scene, s_camera = s_scene.to(device), s_camera.to(device)
        t_load = time.perf_counter() - t0
        s_accum, s_ctx = render(s_scene, s_camera, s_opts, num_passes=1, device=device)
        s_img = resolve(s_accum)
        if not bool(torch.isfinite(s_img).all()) or float(s_img.max()) <= 0.0:
            raise AssertionError("the session's scene renders not finite, or black")
        tree = s_ctx.accel_pack.wide
        fresh = wide_bvh.build_wide_bvh(
            build_woop(s_scene.geometry.positions, s_scene.geometry.indices), tree.leaf_size)
        same = [f.name for f in dataclasses.fields(fresh)
                if (torch.equal(getattr(tree, f.name), getattr(fresh, f.name))
                    if torch.is_tensor(getattr(fresh, f.name))
                    else getattr(tree, f.name) == getattr(fresh, f.name))]
        if len(same) != len(dataclasses.fields(fresh)):
            raise AssertionError(f"the edited scene's tree differs from a fresh build: "
                                 f"only {same} equal")
        if torch.equal(tree.blocks, out["hp.ply"][3].accel_pack.wide.blocks):
            raise AssertionError("the edited scene kept the unedited tree's block boxes")
        log(f"[ingest] session (yaw {SESSION_YAW}, scale {SESSION_SCALE}) loaded in "
            f"{t_load:.2f} s; one {WIDTH}x{HEIGHT} pass finite, max {float(s_img.max()):.4g}; "
            f"its tree and block boxes equal a fresh build over the edited triangles")
        del s_scene, s_ctx, s_accum, s_img, tree, fresh

        # Resume: 2 passes, saved and loaded, then 2 more = 4 straight passes.
        scene, camera, opts, ctx, accum, _ = out["hp.ply"]
        half, _ = render(scene, camera, opts, num_passes=PASSES // 2, ctx=ctx, device=device)
        state = tmp / "state.npz"
        session_io.save_render_state(str(state), half, PASSES // 2, session_io.Session(values))
        saved, next_pass, _ = session_io.load_render_state(str(state))
        resumed, _ = render(scene, camera, opts, num_passes=PASSES - next_pass, ctx=ctx,
                            device=device, accum=torch.from_numpy(saved).to(device),
                            start_pass=next_pass)
        if not torch.equal(resumed, accum):
            raise AssertionError("resumed render differs from the straight one")

        # The PNG without PIL: the port's own writer and reader.
        has_pil = importlib.util.find_spec("PIL") is not None
        shown = apply_post_pipeline(accum, PostProcessingParams(tonemapping_enabled=True))
        shown = shown.cpu().numpy()
        png = tmp / "render.png"
        blocked = {name: sys.modules.pop(name, None) for name in ("PIL", "PIL.Image")}
        sys.modules.update(dict.fromkeys(blocked))  # None: any import of PIL fails
        try:
            save_ldr(str(png), shown)
            back = read_png(str(png))
        finally:
            for name, module in blocked.items():
                if module is None:
                    del sys.modules[name]
                else:
                    sys.modules[name] = module
        expect = (np.clip(shown, 0, 1) * 255 + 0.5).astype(np.uint8)[::-1]
        if not np.array_equal(back, expect):
            raise AssertionError("render.png does not read back")
        log(f"[ingest] resume after {next_pass} passes = {PASSES} straight, bit for bit; "
            f"render.png ({png.stat().st_size} bytes) written and read without PIL (PIL "
            f"{'installed, blocked' if has_pil else 'not installed'})")
    log(f"[ingest] phase 21 took {time.perf_counter() - t_phase:.1f} s")
    return {name: v[5] for name, v in out.items()}


INTERACTIVE_BLOCK = 4  # the block pass whose lanes phase 22 checks K1/K2 on
TIMED = 5  # passes (after one warm-up) behind each mean of phase 22


def post_edit(viewer, edit):
    """Send one edit to the viewer over HTTP, as a browser would."""
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{viewer.port}/edit", method="POST",
                                 data=json.dumps(edit).encode(),
                                 headers={"Content-Type": "application/json"})
    if json.loads(urllib.request.urlopen(req, timeout=30).read()) != {"queued": True}:
        raise AssertionError(f"the viewer did not queue {edit!r}")


def get_url(viewer, path):
    import urllib.request

    return urllib.request.urlopen(f"http://127.0.0.1:{viewer.port}{path}", timeout=30).read()


def synced_ms(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def phase_interactive(gen, err, card):
    """Phase 22: the live preview and edit loop (see the module docstring).
    Returns K1's and K2's launches in the nine block passes."""
    import tempfile

    import numpy as np
    import torch

    from heatray_tpu_torch import cornell_box, orbit_camera
    from heatray_tpu_torch.interactive import InteractiveRenderer
    from heatray_tpu_torch.io_utils.hdr import write_hdr
    from heatray_tpu_torch.io_utils.png import decode_png
    from heatray_tpu_torch.options import FrameGlobals, RenderOptions
    from heatray_tpu_torch.render import integrator
    from heatray_tpu_torch.scene import export
    from heatray_tpu_torch.viewer import ProgressiveViewer

    t_phase = time.perf_counter()
    device = torch.device(DEVICE)
    opts = RenderOptions(width=WIDTH, height=HEIGHT, max_render_passes=64, max_ray_depth=DEPTH,
                         interactive_block=True)
    full_opts = dataclasses.replace(opts, interactive_block=False)
    viewer = ProgressiveViewer(port=0, host="127.0.0.1").start()
    try:
        t0 = time.perf_counter()
        r = InteractiveRenderer(cornell_box(light="both", with_spheres=True),
                                orbit_camera(WIDTH, HEIGHT, distance=6.2, focal_length_mm=35.0),
                                opts, viewer=viewer, orbit=dict(distance=6.2, focal_length=35.0),
                                device=device)
        torch.cuda.synchronize()
        if r.ctx.accel_pack.backend != "wide":
            raise AssertionError(f"the edit loop got the {r.ctx.accel_pack.backend!r} backend")
        viewer.set_scene_info(r.scene_info())
        log(f"[interactive] viewer on 127.0.0.1:{viewer.port}; 1080p context in "
            f"{time.perf_counter() - t0:.2f} s")

        # K1/K2 on a block pass's lanes against their plain versions.
        check_path_rays(("closest_wide", "any_wide"), r.scene, r.camera, r.ctx, opts, gen,
                        f"interactive block {INTERACTIVE_BLOCK}", err, exact=True,
                        block=INTERACTIVE_BLOCK)

        # Nine block passes through the edit loop, counted, against one full pass.
        lanes, gated = [], integrator._gated_lanes

        def count_lanes(*args):
            lanes.append(gated(*args))
            return lanes[-1]

        integrator._gated_lanes = count_lanes
        try:
            torch.cuda.synchronize()
            reset_launches()
            for _ in range(9):
                r.step()
            torch.cuda.synchronize()
            launches = read_launches()
        finally:
            integrator._gated_lanes = gated
        runs = 9 + sum(n > 0 for n in lanes)
        if len(lanes) != 9 * (DEPTH - 1) or any(
                launches[k] != runs for k in ("closest_wide", "any_wide")) or any(
                n for k, n in launches.items() if k not in ("closest_wide", "any_wide")):
            raise AssertionError(f"nine block passes: launches {launches}, not {runs} of K1 and "
                                 f"K2 alone (gated lanes {lanes})")
        full = integrator.render_pass(r.scene, r.camera, r.ctx, full_opts,
                                      FrameGlobals.create(0, device=device),
                                      torch.zeros_like(r.accum))
        if not torch.equal(r.accum[3], torch.ones_like(r.accum[3])):
            raise AssertionError("nine block passes did not cover every pixel once")
        diff = float((r.accum - full).abs().max())
        if diff > 1e-5:
            raise AssertionError(f"nine block passes differ from one full pass by {diff}")
        log(f"[interactive] nine block passes equal one full pass: max |diff| {diff:.3g}; "
            f"launches {launches} ({runs} bounces with live lanes; gated lanes {lanes})")

        # The viewer's frame is the published image.
        publish_ms, _ = synced_ms(r.publish)
        status = json.loads(get_url(viewer, "/status.json"))
        frame = decode_png(get_url(viewer, "/frame.png"))
        if status["passes_done"] != 9 or not np.array_equal(frame, r.frame_rgb8()):
            raise AssertionError(f"/frame.png or /status.json is not the published image: {status}")

        # Steady times: a block pass, a full pass, a publish.
        block_ms, full_ms, pub_ms = [], [], []
        zero = torch.zeros_like(r.accum)
        for i in range(TIMED + 1):
            block_ms.append(synced_ms(r.step)[0])
            full_ms.append(synced_ms(lambda: integrator.render_pass(
                r.scene, r.camera, r.ctx, full_opts,
                FrameGlobals.create(i, device=device), zero))[0])
            pub_ms.append(synced_ms(r.publish)[0])
        readings = {"block_pass_ms": sum(block_ms[1:]) / TIMED,
                    "full_pass_ms": sum(full_ms[1:]) / TIMED,
                    "publish_ms": sum(pub_ms[1:]) / TIMED, "first_publish_ms": publish_ms}
        log(f"[interactive] {WIDTH}x{HEIGHT} depth {DEPTH}, mean of {TIMED} after a warm-up: "
            f"block pass {readings['block_pass_ms']:.3f} ms, full pass "
            f"{readings['full_pass_ms']:.3f} ms, publish {readings['publish_ms']:.3f} ms "
            f"(post chain, one copy, PNG); card {card}")

        def fresh_equal(label):
            """The loop's last pass against the same pass through a fresh
            context of the loop's scene, bit for bit."""
            ctx = integrator.make_context(r.options, r.scene, device)
            ref = integrator.render_pass(r.scene, r.camera, ctx, r.options,
                                         FrameGlobals.create(0, device=device),
                                         torch.zeros_like(r.accum))
            if not torch.equal(r.accum, ref):
                raise AssertionError(f"{label}: the edited loop's pass differs from a fresh "
                                     f"context's by {float((r.accum - ref).abs().max())}")
            log(f"[interactive] {label}: the pass equals a fresh context's bit for bit")

        def lights():
            return r.scene.lights

        (REPO / "build").mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
            tmp = Path(tmp)
            sky = np.ones((64, 128, 3), np.float32) * np.linspace(0.2, 1.5, 64)[:, None, None]
            write_hdr(str(tmp / "sky.hdr"), sky)
            export.write_obj(str(tmp / "cornell.obj"), cornell_box(light="both",
                                                                    with_spheres=True))
            n_dir, n_spot = lights().num_directional, lights().num_spot
            edits = [
                ("material", {"type": "material", "index": 2, "base_color": [0.1, 0.9, 0.2],
                              "metallic": 1.0, "roughness": 0.3},
                 lambda: float(r.scene.materials.metallic[2]) == 1.0),
                ("directional add", {"type": "directional_light", "index": n_dir,
                                     "direction": [0.3, 1.0, 0.2], "illuminance": 400.0},
                 lambda: lights().num_directional == n_dir + 1),
                ("directional update", {"type": "directional_light", "index": n_dir,
                                        "color": [1.0, 0.5, 0.5]},
                 lambda: float(lights().dir_direction[n_dir][1]) > 0.9),
                ("directional remove", {"type": "directional_light", "index": n_dir,
                                        "remove": True},
                 lambda: lights().num_directional == n_dir),
                ("point update", {"type": "point_light", "index": 0,
                                  "position": [0.3, 1.6, 0.2]},
                 lambda: torch.allclose(lights().point_position[0].cpu(),
                                        torch.tensor([0.3, 1.6, 0.2]))),
                ("spot add", {"type": "spot_light", "index": n_spot, "position": [0.5, 1.9, 0.0],
                              "direction": [0.0, -1.0, 0.0], "luminous_intensity": 800.0},
                 lambda: lights().num_spot == n_spot + 1),
                ("spot update", {"type": "spot_light", "index": n_spot,
                                 "luminous_intensity": 1600.0},
                 lambda: float(lights().spot_direction[n_spot][1]) < -0.99),
                ("spot remove", {"type": "spot_light", "index": n_spot, "remove": True},
                 lambda: lights().num_spot == n_spot),
                ("env", {"type": "env", "enabled": True, "solid_color": [0.3, 0.4, 0.6],
                         "exposure": 0.5, "rotation": 0.3},
                 lambda: lights().env_enabled == 1 and lights().env_rotation == 0.3),
                ("camera", {"type": "camera", "distance": 5.8, "phi": 0.15, "theta": 0.05},
                 lambda: r.orbit["distance"] == 5.8),
                ("post", {"type": "post", "exposure": 0.5, "tonemapping_enabled": True},
                 lambda: r.post.exposure == 0.5 and r.post.tonemapping_enabled),
                ("transform", {"type": "transform", "yaw": 10.0, "scale": 0.95},
                 lambda: r.ctx.accel_pack.wide.blocks is not None),
                ("options", {"type": "options", "max_ray_depth": 3, "ms_impl": "lut"},
                 lambda: (r.options.max_ray_depth, r.options.ms_impl) == (3, "lut")
                 and r.ctx.ms_lut.device == r.ctx.device),
                ("load env", {"type": "load", "path": str(tmp / "sky.hdr")},
                 lambda: tuple(lights().env_map.shape) == (3, 64, 128)),
                ("load scene", {"type": "load", "path": str(tmp / "cornell.obj")},
                 lambda: r.scene.geometry.num_triangles == 4106 and lights().env_enabled == 1
                 and r.ctx.accel_pack.backend == "wide"),
            ]
            images, frame_ms = {}, {}
            for label, edit, took in edits:
                if r.pass_index == 0:
                    r.step()
                before, index = r.accum.clone(), r.pass_index
                split = HostSplit() if label == "transform" else contextlib.nullcontext()
                with split:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    post_edit(viewer, edit)
                    if r.poll_and_apply() != 1:
                        raise AssertionError(f"{label}: the edit did not arrive")
                    r.step()
                    r.publish()
                    torch.cuda.synchronize()
                    frame_ms[label] = (time.perf_counter() - t0) * 1e3
                if label == "transform":
                    log(f"[interactive] transform edit to first frame, host split "
                        f"{split.line()}; host {host_cpu()}; card {card}")
                if not took():
                    raise AssertionError(f"{label}: the edit did not take effect")
                resets = label != "post"
                if r.pass_index != (1 if resets else index + 1):
                    raise AssertionError(f"{label}: pass {r.pass_index} after the edit's step")
                if not bool(torch.isfinite(r.accum).all()):
                    raise AssertionError(f"{label}: the image is not finite")
                if resets and torch.equal(r.accum, before):
                    raise AssertionError(f"{label}: the image did not change")
                images[label] = r.accum.clone()
                if label in ("material", "transform"):
                    fresh_equal(label)
            for label in ("directional", "spot"):
                # A removal gives back the pass before the light's add.
                prior = "material" if label == "directional" else "point update"
                if not torch.equal(images[f"{label} remove"], images[prior]):
                    raise AssertionError(f"{label} remove: the pass differs from the one "
                                         f"before the add")
        frame = decode_png(get_url(viewer, "/frame.png"))
        if not np.array_equal(frame, r.frame_rgb8()):
            raise AssertionError("/frame.png is not the last published image")
    finally:
        viewer.stop()
    readings["material_to_frame_ms"] = frame_ms["material"]
    readings["transform_to_frame_ms"] = frame_ms["transform"]
    readings["seconds"] = time.perf_counter() - t_phase
    log(f"[interactive] edit to first frame (POST, poll_and_apply, one block pass, publish), "
        f"ms: {', '.join(f'{k} {v:.1f}' for k, v in frame_ms.items())}; card {card}")
    log(f"[interactive] phase 22 readings {json.dumps(readings)}")
    return {k: launches[k] for k in ("closest_wide", "any_wide")}, readings


# --- phase 23: multi-device on the one card -------------------------------------

MULTI_TIMEOUT = 300  # s: a collective, or a group of ranks, that waits longer fails the run
STEP_W, STEP_H, STEP_DEPTH = 240, 136, 2  # the sharded train steps
STEP_TOL = 1e-3  # of each key's largest |g|, as phase 3c holds the card against the CPU
SP_TOL = 1e-4  # the (sp, dp) merge sums the passes in another order than one device
K12 = ("closest_wide", "any_wide")


@contextlib.contextmanager
def counted_lanes():
    """The gated lane counts (``integrator._gated_lanes``) of the passes run
    inside, with every launch count set to 0 on entry; yields (lanes,
    launches), ``launches`` filled on exit after a synchronise."""
    import torch

    from heatray_tpu_torch.render import integrator

    lanes, launches, gated = [], {}, integrator._gated_lanes

    def count(*args):
        lanes.append(gated(*args))
        return lanes[-1]

    torch.cuda.synchronize()
    reset_launches()
    integrator._gated_lanes = count
    try:
        yield lanes, launches
        torch.cuda.synchronize()
        launches.update(read_launches())
    finally:
        integrator._gated_lanes = gated


def expect_k12(label, launches, lanes, passes):
    """K1 and K2 once per bounce with live lanes (the first bounce of each
    of ``passes`` passes and each gated bounce above 0 lanes), no other
    traversal kernel."""
    runs = passes + sum(n > 0 for n in lanes)
    want = {name: runs if name in K12 else 0 for name in launches}
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, expected {want} (gated lanes {lanes})")


def tree_bytes(*trees) -> int:
    """Device bytes of distinct wide trees (every tensor field)."""
    import torch

    seen = {id(t): t for t in trees}.values()
    return sum(getattr(t, f.name).numel() * getattr(t, f.name).element_size()
               for t in seen for f in dataclasses.fields(t)
               if isinstance(getattr(t, f.name), torch.Tensor))


def step_params(scene, device) -> dict:
    from heatray_tpu_torch.bridge import params_from_arrays

    mats = scene.materials
    return params_from_arrays({"base_color": mats.base_color.cpu().numpy(),
                               "roughness": mats.roughness.cpu().numpy()}, device)


def step_setup(device):
    """Scene, camera, options and ``static_shading=False`` context of the
    sharded train steps: the Cornell box at STEP_W x STEP_H, depth 2."""
    from heatray_tpu_torch import cornell_box, orbit_camera
    from heatray_tpu_torch.options import RenderOptions
    from heatray_tpu_torch.render import integrator

    opts = RenderOptions(width=STEP_W, height=STEP_H, max_render_passes=8,
                         max_ray_depth=STEP_DEPTH)
    scene = cornell_box(light="both", with_spheres=True).to(device)
    camera = orbit_camera(STEP_W, STEP_H, distance=6.2, focal_length_mm=35.0).to(device)
    return scene, camera, opts, integrator.make_context(opts, scene, device,
                                                        static_shading=False)


def sharded_step(label, make_step, scene, device, sample_index, passes):
    """One step of ``make_step`` (SGD at lr 1.0: each gradient is the
    parameters' change), its launches counted: K1/K2 in the forward only."""
    import torch

    step = make_step(lambda tensors: torch.optim.SGD(tensors, lr=1.0))
    params = step_params(scene, device)
    before = {k: v.detach().clone() for k, v in params.items()}
    with counted_lanes() as (lanes, launches):
        params, loss = step(params, sample_index)
    expect_k12(label, launches, lanes, passes)
    return {"loss": float(loss), "launches": launches, "lanes": list(lanes),
            "grads": {k: (before[k] - v.detach()).cpu() for k, v in params.items()}}


def run_ranks(label, scenario, world, *args) -> list:
    """``scenario(*args)`` on ``world`` gloo ranks, all on DEVICE
    (``parallel.launch.spawn``: each starts with ``OMP_NUM_THREADS=1``, as
    ``torchrun`` starts ranks; the kernels are built already, so the ranks
    only load them); a rank that fails, or a group still running after
    MULTI_TIMEOUT, fails the run, and no rank outlives this call."""
    from heatray_tpu_torch.parallel.launch import spawn

    store = tempfile.mkdtemp(dir=REPO / "build")
    t0 = time.perf_counter()
    try:
        out = spawn(scenario, world, store, *args, device=DEVICE, timeout_s=MULTI_TIMEOUT,
                    deadline_s=MULTI_TIMEOUT).results()
    except TimeoutError as e:
        raise AssertionError(f"{label}: {e}") from e
    shutil.rmtree(store)
    log(f"[multi] {label}: {world} gloo ranks on one card took {time.perf_counter() - t0:.1f} s "
        f"(start, context, work)")
    return out


@contextlib.contextmanager
def timed_reduces():
    """Every ``Mesh.all_reduce`` inside, synchronised before and after and
    timed; yields a list of (ms, bytes), one a call."""
    import torch

    from heatray_tpu_torch.parallel import sharding

    calls, reduce = [], sharding.Mesh.all_reduce

    def timed(self, tensor, op="sum", axis=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = reduce(self, tensor, op, axis)
        torch.cuda.synchronize()
        calls.append(((time.perf_counter() - t0) * 1e3, tensor.numel() * tensor.element_size()))
        return out

    sharding.Mesh.all_reduce = timed
    try:
        yield calls
    finally:
        sharding.Mesh.all_reduce = reduce


def ranks_pair(target, default_threads):
    """Phase 23's two gloo ranks: the Cornell rows, ``high_poly`` through the
    ``"sharded"`` backend (its passes timed again at torch's default thread
    count, ``default_threads``, and at the rank's own, in turns, each with
    one more pass whose gloo reductions are timed), and one
    ``make_sharded_train_step``."""
    import torch
    import torch.distributed as dist

    from heatray_tpu_torch import cornell_box, frame_scene, high_poly, orbit_camera, render
    from heatray_tpu_torch import scene_aabb
    from heatray_tpu_torch.options import RenderOptions
    from heatray_tpu_torch.parallel import sharding
    from heatray_tpu_torch.render import integrator

    device = torch.device(DEVICE)
    rank = dist.get_rank()
    mesh = sharding.make_mesh(2, device=device)
    err = dict.fromkeys(KERNELS, 0.0)
    out = {"err": err}

    opts = RenderOptions(width=WIDTH, height=HEIGHT, max_render_passes=64, max_ray_depth=DEPTH)
    scene = cornell_box(light="both", with_spheres=True).to(device)
    camera = orbit_camera(WIDTH, HEIGHT, distance=6.2, focal_length_mm=35.0).to(device)
    ctx = integrator.make_context(opts, scene, device)
    with counted_lanes() as (lanes, launches):
        accum = sharding.render_sharded(scene, camera, ctx, opts, mesh, PASSES)
    expect_k12(f"rank {rank} rows", launches, lanes, PASSES)
    dt, _ = synced_ms(lambda: sharding.render_sharded(scene, camera, ctx, opts, mesh, PASSES))
    out["rows"] = {"accum": accum.cpu(), "launches": launches, "lanes": list(lanes),
                   "ms_per_pass": dt / PASSES}
    del ctx, accum

    t0 = time.perf_counter()
    hp_scene = high_poly().to(device)
    hp_camera = frame_scene(scene_aabb(hp_scene.geometry), WIDTH, HEIGHT, theta=0.35).to(device)
    scene_s, t0 = time.perf_counter() - t0, time.perf_counter()
    hp_opts = dataclasses.replace(opts, intersect_backend="sharded")
    hp_ctx = integrator.make_context(hp_opts, hp_scene, device, mesh=mesh)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    pack = hp_ctx.accel_pack
    tree, tree_occl = pack.swide.shard_bvh(), pack.swide_occl.shard_bvh()
    check_path_rays(K12, hp_scene, hp_camera, hp_ctx, hp_opts,
                    torch.Generator(device="cpu").manual_seed(SEED), f"rank {rank} high_poly shard",
                    err, exact=True, trees=(tree, tree_occl))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with counted_lanes() as (lanes, launches):
        t0 = time.perf_counter()
        accum, _ = render(hp_scene, hp_camera, hp_opts, num_passes=2, ctx=hp_ctx, device=device)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    expect_k12(f"rank {rank} sharded", launches, lanes, 2)
    out["sharded"] = {
        "accum": accum.cpu(), "launches": launches, "lanes": list(lanes),
        "ms_per_pass": dt * 1e3 / 2, "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
        "tree_bytes": tree_bytes(tree, tree_occl), "setup_s": setup_s, "scene_s": scene_s,
        "triangles": int((tree.slot_tri >= 0).sum()), "nodes": tree.num_nodes,
        "leaves": tree.num_chunks, "stack": tree.max_stack,
    }
    start_threads, threads = torch.get_num_threads(), {}
    for n in (default_threads, start_threads):
        torch.set_num_threads(n)
        dt, _ = synced_ms(lambda: render(hp_scene, hp_camera, hp_opts, num_passes=2, ctx=hp_ctx,
                                         device=device))
        with timed_reduces() as calls:
            render(hp_scene, hp_camera, hp_opts, num_passes=1, ctx=hp_ctx, device=device)
        threads[n] = {"ms_per_pass": dt / 2, "reduce_ms": sum(c[0] for c in calls),
                      "reduces": len(calls), "reduce_mb": sum(c[1] for c in calls) / 1e6}
    torch.set_num_threads(start_threads)
    out["sharded"].update(start_threads=start_threads, threads=threads)
    del hp_ctx, pack, tree, tree_occl, accum, hp_scene

    s_scene, s_cam, s_opts, s_ctx = step_setup(device)
    out["dp_step"] = sharded_step(
        f"rank {rank} dp step",
        lambda opt: sharding.make_sharded_train_step(s_scene, s_cam, s_ctx, s_opts, target, mesh,
                                                     opt),
        s_scene, device, 1, 1)
    return out


def ranks_quad(target):
    """Phase 23's four gloo ranks on a 2x2 ``(sp, dp)`` mesh: the Cornell
    box at half width and one ``make_sharded_train_step_2d``."""
    import torch
    import torch.distributed as dist

    from heatray_tpu_torch import cornell_box, orbit_camera
    from heatray_tpu_torch.options import RenderOptions
    from heatray_tpu_torch.parallel import sharding
    from heatray_tpu_torch.render import integrator

    device = torch.device(DEVICE)
    rank = dist.get_rank()
    mesh = sharding.make_mesh_2d(2, 2, device=device)
    w, h = WIDTH // 2, HEIGHT // 2
    opts = RenderOptions(width=w, height=h, max_render_passes=64, max_ray_depth=DEPTH)
    scene = cornell_box(light="both", with_spheres=True).to(device)
    camera = orbit_camera(w, h, distance=6.2, focal_length_mm=35.0).to(device)
    ctx = integrator.make_context(opts, scene, device)
    with counted_lanes() as (lanes, launches):
        t0 = time.perf_counter()
        merged = sharding.render_sharded_2d(scene, camera, ctx, opts, mesh, PASSES)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    expect_k12(f"rank {rank} sp dp", launches, lanes, PASSES // 2)
    out = {"sp_dp": {"accum": merged.cpu(), "launches": launches, "lanes": list(lanes),
                     "ms": dt * 1e3}}
    s_scene, s_cam, s_opts, s_ctx = step_setup(device)
    out["2d_step"] = sharded_step(
        f"rank {rank} 2d step",
        lambda opt: sharding.make_sharded_train_step_2d(s_scene, s_cam, s_ctx, s_opts, target,
                                                        mesh, opt),
        s_scene, device, 1, 1)
    return out


def thread_ms(threads) -> str:
    """The sharded pass by host thread count, for the log."""
    return "; ".join(
        f"at {n} thread(s) {t['ms_per_pass']:.3f} ms/pass, gloo reductions {t['reduce_ms']:.3f} "
        f"ms in one pass ({t['reduces']} calls, {t['reduce_mb']:.2f} MB)"
        for n, t in threads.items())


def check_step(label, got, ref):
    """A rank's step against the one-device step: loss and every gradient
    within STEP_TOL of the key's largest |g|."""
    loss_err = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
    if not loss_err <= STEP_TOL:
        raise AssertionError(f"{label}: loss {got['loss']!r} against {ref['loss']!r}")
    parts = []
    for k, want in ref["grads"].items():
        scale = float(want.abs().max())
        e = float((got["grads"][k] - want).abs().max()) / max(scale, 1e-30)
        if scale == 0.0 or not e <= STEP_TOL:
            raise AssertionError(f"{label}: gradient {k} off by {e} of the largest |g| {scale}")
        parts.append(f"{k} {e:.3g} of {scale:.4g}")
    log(f"[multi] {label}: loss {got['loss']!r} against one device {ref['loss']!r} "
        f"({loss_err:.3g}); gradients off by {', '.join(parts)}")


def phase_multi(gen, err, card):
    """Phase 23: multi-device rendering on the one card (see the module
    docstring).  Returns K1's and K2's launches by scenario and rank."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from heatray_tpu_torch import (
        cornell_box, frame_scene, high_poly, make_loss_fn, orbit_camera, render, resolve,
        scene_aabb,
    )
    from heatray_tpu_torch.options import RenderOptions
    from heatray_tpu_torch.parallel import sharding
    from heatray_tpu_torch.render import integrator

    t_phase = time.perf_counter()
    device = torch.device(DEVICE)
    k12 = {name: {} for name in K12}

    def note(scenario, launches):
        for name in K12:
            k12[name][scenario] = launches if isinstance(launches, int) else [
                x[name] for x in launches]

    # One-device references, before any rank starts.
    opts = RenderOptions(width=WIDTH, height=HEIGHT, max_render_passes=64, max_ray_depth=DEPTH)
    scene = cornell_box(light="both", with_spheres=True).to(device)
    camera = orbit_camera(WIDTH, HEIGHT, distance=6.2, focal_length_mm=35.0).to(device)
    ctx = integrator.make_context(opts, scene, device)
    two = {}
    ref_ms, (ref4, _) = synced_ms(lambda: render(
        scene, camera, opts, num_passes=PASSES, ctx=ctx, device=device,
        pass_callback=lambda i, a: two.setdefault(i, a.clone()) if i == 1 else None))
    ref2 = two[1]

    # 1. render_sharded over a one-rank NCCL group, in this process.
    store = Path(tempfile.mkdtemp(dir=REPO / "build"))
    sharding.initialize_distributed(f"file://{store}/nccl", 1, 0, backend="nccl",
                                    device=device, timeout_s=MULTI_TIMEOUT)
    try:
        mesh = sharding.make_mesh(1, device=device)
        with counted_lanes() as (lanes, launches):
            acc = sharding.render_sharded(scene, camera, ctx, opts, mesh, 2)
        dt, _ = synced_ms(lambda: sharding.render_sharded(scene, camera, ctx, opts, mesh, 2))
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store)
    expect_k12("nccl render_sharded", launches, lanes, 2)
    if backend != "nccl" or not torch.equal(acc, ref2):
        d = (acc - ref2).abs()
        raise AssertionError(f"one-rank {backend} render_sharded differs from render: "
                             f"{int((d > 0).sum())} values, max {float(d.max())}")
    note("nccl_rank_rows", launches["closest_wide"])
    log(f"[multi] render_sharded over a one-rank NCCL group, {WIDTH}x{HEIGHT} depth {DEPTH}, "
        f"2 passes: equal to render bit for bit; a second call {dt / 2:.3f} ms/pass with the "
        f"gather, against render's {ref_ms / PASSES:.3f} ms/pass over {PASSES} passes; "
        f"launches {launches}; card {card}")
    del ctx, acc, two

    hp_scene = high_poly().to(device)
    hp_camera = frame_scene(scene_aabb(hp_scene.geometry), WIDTH, HEIGHT, theta=0.35).to(device)
    hp_opts = dataclasses.replace(opts, intersect_backend="wide")
    t0 = time.perf_counter()
    hp_ctx = integrator.make_context(hp_opts, hp_scene, device)
    torch.cuda.synchronize()
    mono = hp_ctx.accel_pack
    mono_bytes, mono_s = tree_bytes(mono.wide, mono.wide_occl), time.perf_counter() - t0
    hp_ms, (hp_ref, _) = synced_ms(lambda: render(hp_scene, hp_camera, hp_opts, num_passes=2,
                                                   ctx=hp_ctx, device=device))
    hp_ref = resolve(hp_ref)
    del hp_ctx, mono, hp_scene

    half = RenderOptions(width=WIDTH // 2, height=HEIGHT // 2, max_render_passes=64,
                         max_ray_depth=DEPTH)
    ref_half, _ = render(scene, orbit_camera(WIDTH // 2, HEIGHT // 2, distance=6.2,
                                             focal_length_mm=35.0).to(device),
                         half, num_passes=PASSES, device=device)

    target = np.random.default_rng(SEED + 23).uniform(0.0, 1.0, (STEP_H, STEP_W, 3)).astype(
        np.float32)
    s_scene, s_cam, s_opts, s_ctx = step_setup(device)
    step_refs = {}
    for key, passes in (("dp", 1), ("2d", 2)):
        p = step_params(s_scene, device)
        loss = make_loss_fn(s_scene, s_cam, s_ctx, s_opts, target, num_passes=passes)(
            p, 1 * passes)
        loss.backward()
        step_refs[key] = {"loss": float(loss.detach()),
                          "grads": {k: v.grad.cpu() for k, v in p.items()}}
    del s_ctx, scene
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"[multi] one-device references in {time.perf_counter() - t_phase:.1f} s: high_poly's "
        f"monolithic leaf-32 context {mono_s:.1f} s, {hp_ms / 2:.3f} ms/pass over 2 passes "
        f"through \"wide\"; card {card}")

    # 2-4. gloo ranks sharing the card.
    pair = run_ranks("rows, sharded, dp step", ranks_pair, 2, target, torch.get_num_threads())
    for r, out in enumerate(pair):
        for name, e in out["err"].items():
            err[name] = max(err[name], e)
        rows = out["rows"]
        if not torch.equal(rows["accum"], ref4.cpu()):
            d = (rows["accum"] - ref4.cpu()).abs()
            raise AssertionError(f"rank {r}: gathered rows differ from render: "
                                 f"{int((d > 0).sum())} values, max {float(d.max())}")
    note("gloo_2_ranks_rows", [out["rows"]["launches"] for out in pair])
    log(f"[multi] render_sharded, 2 gloo ranks of {HEIGHT // 2} rows on one card, {WIDTH}x"
        f"{HEIGHT} depth {DEPTH}, {PASSES} passes (sorted, gated): gathered image equal to "
        f"render bit for bit on each rank; ms/pass per rank over a second call (with the "
        f"gather) {[round(o['rows']['ms_per_pass'], 3) for o in pair]}, against one device's "
        f"{ref_ms / PASSES:.3f}; gated lanes per rank "
        f"{[o['rows']['lanes'] for o in pair]}; card {card}")

    sh = [out["sharded"] for out in pair]
    if not torch.equal(sh[0]["accum"], sh[1]["accum"]):
        raise AssertionError("the two ranks' sharded images differ")
    compare_images("high_poly sharded (2 gloo ranks)", resolve(sh[0]["accum"]).to(device),
                   hp_ref, "one-device wide")
    note("gloo_2_ranks_sharded", [s["launches"] for s in sh])
    for r, s in enumerate(sh):
        log(f"[multi] high_poly \"sharded\", rank {r} of 2 on one card: {s['triangles']} "
            f"triangles, {s['nodes']} nodes, {s['leaves']} leaves, stack {s['stack']}; scene "
            f"{s['scene_s']:.1f} s, context (the forest's host build) {s['setup_s']:.1f} s; "
            f"{s['ms_per_pass']:.3f} ms/pass over 2 passes at {s['start_threads']} host "
            f"thread(s); {thread_ms(s['threads'])}; peak memory "
            f"{s['peak_mib']:.1f} MiB; tree bytes {s['tree_bytes']} against the monolithic "
            f"leaf-32 trees' {mono_bytes} ({s['tree_bytes'] / mono_bytes:.3f}); launches "
            f"{s['launches']}; gated lanes {s['lanes']}; card {card}")
    for r, out in enumerate(pair):
        check_step(f"make_sharded_train_step, rank {r} of 2", out["dp_step"], step_refs["dp"])
    note("gloo_2_ranks_dp_step", [out["dp_step"]["launches"] for out in pair])
    del pair, sh, hp_ref

    quad = run_ranks("(sp 2, dp 2) render and 2d step", ranks_quad, 4, target)
    for r, out in enumerate(quad):
        m = out["sp_dp"]["accum"]
        diff = float((m - ref_half.cpu()).abs().max())
        if not diff <= SP_TOL or not torch.equal(m[3], torch.full_like(m[3], float(PASSES))):
            raise AssertionError(f"rank {r}: (sp, dp) merge off the serial passes by {diff}")
        check_step(f"make_sharded_train_step_2d, rank {r} of 4", out["2d_step"],
                   step_refs["2d"])
    note("gloo_4_ranks_sp_dp", [out["sp_dp"]["launches"] for out in quad])
    note("gloo_4_ranks_2d_step", [out["2d_step"]["launches"] for out in quad])
    log(f"[multi] render_sharded_2d, (sp 2, dp 2) gloo ranks on one card, {WIDTH // 2}x"
        f"{HEIGHT // 2} depth {DEPTH}, {PASSES} passes: merged image within {SP_TOL} of the "
        f"serial passes on each rank, alpha {PASSES}; the call's ms per rank, with its first "
        f"collectives, {[round(o['sp_dp']['ms'], 3) for o in quad]}; card {card}")
    log(f"[multi] phase 23 took {time.perf_counter() - t_phase:.1f} s")
    return k12


def main() -> int:
    import torch

    t_start = time.perf_counter()

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this script needs a card")
    if not (REPO / "heatray_tpu_torch").is_dir():
        raise SystemExit("chip_smoke: run it from a checkout of the repository")
    sys.path.insert(0, str(REPO))

    import numpy as np

    from heatray_tpu_torch import (
        cornell_box, frame_scene, high_poly, orbit_camera, render, resolve, scene_aabb,
    )
    from heatray_tpu_torch.ops import cuda_build, wide_bvh
    from heatray_tpu_torch.ops.bvh import build_bvh
    from heatray_tpu_torch.ops.intersect import build_woop
    from heatray_tpu_torch.ops.intersect_pallas import pack_for_pallas
    from heatray_tpu_torch.options import FrameGlobals, RenderOptions
    from heatray_tpu_torch.render import integrator

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(DEVICE)
    card = card_line()
    log(card)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES) + 1) as pool:
        host_lib = pool.submit(cuda_build.build_host, "native")  # g++: the host library
        libs = list(pool.map(cuda_build.build, SOURCES))
        host_lib = host_lib.result()
    log(f"[build] {[lib.name for lib in libs]} and {host_lib.name} in "
        f"{time.perf_counter() - t0:.1f} s")
    for lib in libs:
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "stack frame" in line:
                log(f"[build] {lib.name}:", line.strip())

    err = dict.fromkeys([*KERNELS, *PROBE_KERNELS, *P2_KERNELS], 0.0)
    gen = torch.Generator(device="cpu").manual_seed(SEED)

    # --- 1. K1/K2 against their plain versions -----------------------------
    opts = RenderOptions(width=WIDTH, height=HEIGHT, max_render_passes=64, max_ray_depth=DEPTH)
    scene = cornell_box(light="both", with_spheres=True).to(device)
    camera = orbit_camera(WIDTH, HEIGHT, distance=6.2, focal_length_mm=35.0).to(device)
    t0 = time.perf_counter()
    ctx = integrator.make_context(opts, scene, device)
    torch.cuda.synchronize()
    pack = ctx.accel_pack
    if pack.backend != "wide":
        raise AssertionError(f"the Cornell box got the {pack.backend!r} backend")
    log(f"[setup] Cornell 1080p context in {time.perf_counter() - t0:.1f} s: "
        f"{pack.wide.num_triangles} triangles, {pack.wide.num_nodes} nodes, "
        f"{pack.wide.num_chunks} leaves, stack {pack.wide.max_stack}")

    _, _, c_head, c_shadow2 = check_path_rays(("closest_wide", "any_wide"), scene, camera, ctx,
                                              opts, gen, "cornell", err, exact=True)

    pos, idx, s_org, s_dir = random_soup(SOUP_TRIANGLES, N_CHECK, device)
    t0 = time.perf_counter()
    soup = wide_bvh.build_wide_bvh(build_woop(pos, idx), leaf_size=32)
    log(f"[setup] {SOUP_TRIANGLES}-triangle soup tree in {time.perf_counter() - t0:.1f} s: "
        f"{soup.num_nodes} nodes, stack {soup.max_stack}")
    check_closest("closest_wide", soup, s_org, s_dir, "soup", err, exact=True)
    t_max = torch.from_numpy(
        np.random.default_rng(SEED + 1).uniform(1.0, 12.0, N_CHECK).astype(np.float32)
    ).to(device)
    check_any("any_wide", soup, s_org, s_dir, t_max, "soup", err)

    # --- 2. the golden configuration ---------------------------------------
    g = 48
    g_opts = RenderOptions(width=g, height=g, max_render_passes=4, max_ray_depth=4)
    g_cam = orbit_camera(g, g, distance=6.2, focal_length_mm=35.0)
    accum, _ = render(cornell_box(light="both", with_spheres=True), g_cam, g_opts,
                      num_passes=4, device=device)
    img = resolve(accum).cpu().numpy()
    golden = np.load(REPO / "tests" / "goldens" / "config2_cornell.npy").astype(np.float32)
    np.testing.assert_allclose(img, golden, rtol=5e-3, atol=5e-3)
    log(f"[golden] config2 48x48x4 matches, max |diff| {float(np.abs(img - golden).max()):.3g}")

    # --- 2b. sorted and gated against unsorted, bit for bit -----------------
    if integrator._bounce_modes(ctx, opts, WIDTH * HEIGHT) != (True, True):
        raise AssertionError("'auto' does not sort and gate on the card")
    plain_opts = dataclasses.replace(opts, sort_bounces=False, gate_bounces=False)
    zero = torch.zeros((4, HEIGHT, WIDTH), dtype=torch.float32, device=device)
    out, ms = {}, {True: [], False: []}
    for on in (True, False, False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[on] = integrator.render_pass(scene, camera, ctx, opts if on else plain_opts,
                                         FrameGlobals.create(5, device=device), zero,
                                         with_stats=True)
        torch.cuda.synchronize()
        ms[on].append((time.perf_counter() - t0) * 1e3)
    (a_on, s_on), (a_off, s_off) = out[True], out[False]
    if not torch.equal(a_on, a_off) or s_on != s_off:
        d = (a_on - a_off).abs()
        raise AssertionError(
            f"sorted+gated pass differs from unsorted: {int((d > 0).sum())} values, "
            f"max {float(d.max())}; rays {s_on} vs {s_off}"
        )
    log(f"[sort] Cornell 1080p pass sorted+gated ms {[round(m, 3) for m in ms[True]]}, "
        f"unsorted ms {[round(m, 3) for m in ms[False]]}: accumulations equal, "
        f"{s_on['rays']} rays each")

    # --- 3. the Cornell path -------------------------------------------------
    cornell_launches, wide_img = run_path("cornell", scene, camera, ctx, opts,
                                          ("closest_wide", "any_wide"))

    # --- 3c. the gradient step -------------------------------------------------
    phase_grad(scene, camera, ctx, opts, card)

    # --- 4. K1/K2 against plain versions at the path's shapes ----------------
    frame = FrameGlobals.create(1, device=device)
    prim = integrator.start_paths(camera, ctx, opts, 1)
    _, shadow = integrator.bounce(scene, ctx, opts, frame, 1, prim, pack)
    check_closest("closest_wide", pack.wide, prim.org, prim.direction, "cornell 1080p primary", err,
                  exact=True)
    check_any("any_wide", pack.wide_occl, shadow.org, shadow.direction, shadow.t_max,
              "cornell 1080p NEE shadow", err)
    kernels = time_kernels([
        ("closest_wide", pack.wide, prim.org, prim.direction, None, True),
        ("any_wide", pack.wide_occl, shadow.org, shadow.direction, shadow.t_max, True),
    ], err, cornell_launches)
    cornell_rays = ((prim, shadow), (c_head, c_shadow2))
    compare_launches("cornell, one leaf-32 tree", kernels,
                     {"K1": ("closest_wide", pack.wide), "K2": ("any_wide", pack.wide_occl)},
                     {"K3a": ("closest_stream", pack.wide), "K3b": ("any_stream", pack.wide_occl)},
                     cornell_rays, card)
    # Phases 11 and 15 time K6 and K5 on the same launches, beside K1/K2 over these trees.
    k1_trees = {"K1": ("closest_wide", pack.wide), "K2": ("any_wide", pack.wide_occl)}
    del ctx, pack, c_head, c_shadow2

    # --- 5. high_poly on the card: streaming kernels against plain ------------
    t0 = time.perf_counter()
    hp_scene = high_poly().to(device)
    t_scene = time.perf_counter() - t0
    hp_camera = frame_scene(scene_aabb(hp_scene.geometry), WIDTH, HEIGHT, theta=0.35).to(device)
    t0 = time.perf_counter()
    hp_ctx = integrator.make_context(opts, hp_scene, device)
    torch.cuda.synchronize()
    hp = hp_ctx.accel_pack
    log(f"[setup] high_poly: scene {t_scene:.2f} s, context {time.perf_counter() - t0:.2f} s "
        f"(host build): {hp.wide.num_triangles} triangles, backend {hp.backend!r}, "
        f"{hp.wide.num_nodes} nodes, {hp.wide.num_chunks} leaves of {hp.wide.leaf_size}, "
        f"stack {hp.wide.max_stack}, w {hp.wide.w.numel() * 4 / 1e6:.1f} MB")
    if hp.backend != "stream" or hp.wide.leaf_size != opts.stream_leaf_size:
        raise AssertionError(f"high_poly got the {hp.backend!r} backend")
    primary, shadow, head, shadow2 = check_path_rays(
        ("closest_stream", "any_stream"), hp_scene, hp_camera, hp_ctx, opts, gen, "high_poly",
        err, exact=True)
    soup128 = wide_bvh.build_wide_bvh(build_woop(pos, idx), leaf_size=128)
    log(f"[setup] {SOUP_TRIANGLES}-triangle soup at leaf 128: {soup128.num_nodes} nodes, "
        f"{soup128.num_chunks} leaves, stack {soup128.max_stack}")
    check_closest("closest_stream", soup128, s_org, s_dir, "soup leaf 128", err, exact=True)
    check_any("any_stream", soup128, s_org, s_dir, t_max, "soup leaf 128", err)

    # --- 6. the high_poly path -------------------------------------------------
    hp_launches, hp_img = run_path("high_poly", hp_scene, hp_camera, hp_ctx, opts,
                                   ("closest_stream", "any_stream"))

    # --- 7. K3 times, beside K4 over the same tree and K1/K2 over leaf 32 -------
    kernels += time_kernels([
        ("closest_stream", hp.wide, primary.org, primary.direction, None, False),
        ("any_stream", hp.wide_occl, shadow.org, shadow.direction, shadow.t_max, False),
    ], err, hp_launches)
    compare_launches("high_poly, one leaf-128 tree", kernels,
                     {"K3a": ("closest_stream", hp.wide), "K3b": ("any_stream", hp.wide_occl)},
                     {"K4a": ("closest_stream_t", hp.wide), "K4b": ("any_stream_t", hp.wide_occl)},
                     ((primary, shadow), (head, shadow2)), card)
    t0 = time.perf_counter()
    wide32 = wide_bvh.build_wide_bvh(hp.accel, leaf_size=32)
    torch.cuda.synchronize()
    log(f"[setup] high_poly at leaf 32 in {time.perf_counter() - t0:.2f} s: "
        f"{wide32.num_nodes} nodes, {wide32.num_chunks} leaves, stack {wide32.max_stack}")
    if wide32.max_stack > wide_bvh._kernels().wide_bvh_stack_depth():
        log(f"[compare] K1 cannot walk the leaf-32 tree: stack {wide32.max_stack}")
    else:
        k3 = {k["name"]: k for k in kernels}
        for tag, rays, sh, key in (("", primary, shadow, "ms"),
                                   (" depth-2 head", head, shadow2, "head_ms")):
            k1 = time_ms(lambda: wide_bvh.intersect_closest_wide(
                wide32, rays.org, rays.direction), 10)
            k2 = time_ms(lambda: wide_bvh.intersect_any_wide(
                wide32, sh.org, sh.direction, t_max=sh.t_max), 10)
            log(f"[compare] high_poly{tag} on {rays.org.x.numel()} rays: K1 on leaf 32 "
                f"{k1:.4f} ms vs K3a on leaf 128 {k3['closest_stream'][key]:.4f} ms; K2 on "
                f"leaf 32 {k2:.4f} ms vs K3b {k3['any_stream'][key]:.4f} ms; card {card}")
    hp_rays = (primary, shadow, head, shadow2)  # phase 15 times K4 on them
    del hp, wide32, head, shadow2  # phase 16 walks hp_ctx's tree

    # --- 8. K7 in the rebuild mode and K6 under "bvh", against plain -----------
    routes = {
        "rebuild": (opts, ("closest_chunks", "any_chunks")),
        "bvh": (dataclasses.replace(opts, intersect_backend="bvh"), ("closest_bvh", "any_bvh")),
    }
    ctxs = {}
    for route, (r_opts, names) in routes.items():
        t0 = time.perf_counter()
        ctxs[route] = integrator.make_context(r_opts, None if route == "rebuild" else scene,
                                              device)
        torch.cuda.synchronize()
        log(f"[setup] Cornell 1080p {route} context in {time.perf_counter() - t0:.2f} s")
        check_path_rays(names, scene, camera, ctxs[route], r_opts, gen, f"cornell {route}", err,
                        exact=True)
    soup_accel = build_woop(pos, idx)
    t0 = time.perf_counter()
    soup_trees = {"chunks": pack_for_pallas(soup_accel, opts.pallas_tri_chunk),
                  "bvh": build_bvh(soup_accel, leaf_size=opts.bvh_leaf_size)}
    log(f"[setup] {SOUP_TRIANGLES}-triangle soup: {soup_trees['chunks'].num_chunks} chunks, "
        f"binary tree of {soup_trees['bvh'].num_nodes} nodes, stack "
        f"{soup_trees['bvh'].max_stack}, in {time.perf_counter() - t0:.1f} s")
    for family, tree in soup_trees.items():
        check_closest(f"closest_{family}", tree, s_org, s_dir, "soup", err, exact=True)
        check_any(f"any_{family}", tree, s_org, s_dir, t_max, "soup", err)
    del soup_trees, soup_accel

    # --- 9. the golden through the three new routes ---------------------------
    for route in ("rebuild", "pallas", "bvh"):
        r_opts = dataclasses.replace(g_opts, intersect_backend="pallas" if route == "rebuild"
                                     else route)
        r_ctx = integrator.make_context(r_opts, device=device) if route == "rebuild" else None
        accum, _ = render(cornell_box(light="both", with_spheres=True), g_cam, r_opts,
                          num_passes=4, ctx=r_ctx, device=device)
        img = resolve(accum).cpu().numpy()
        np.testing.assert_allclose(img, golden, rtol=5e-3, atol=5e-3)
        log(f"[golden] config2 48x48x4 through {route} matches, max |diff| "
            f"{float(np.abs(img - golden).max()):.3g}")

    # --- 10. the Cornell path in the rebuild mode and under "bvh" ---------------
    kernels_launches = {}
    for route, (r_opts, names) in routes.items():
        launches, img = run_path(f"cornell {route}", scene, camera, ctxs[route], r_opts, names)
        for name in names:
            kernels_launches[name] = launches[name]
        compare_images(f"cornell {route}", img, wide_img, "wide")

    # --- 11. K7 and K6 times on phase 4's rays, K6 beside K1/K2 -----------------
    (prim, shadow), _ = cornell_rays
    chunk_pack = integrator.rebuild_pack(scene, opts)
    bvh_pack = ctxs["bvh"].accel_pack
    kernels += time_kernels([
        ("closest_chunks", chunk_pack.packed, prim.org, prim.direction, None, True),
        ("any_chunks", chunk_pack.packed_occl, shadow.org, shadow.direction, shadow.t_max, True),
        ("closest_bvh", bvh_pack.bvh, prim.org, prim.direction, None, True),
        ("any_bvh", bvh_pack.bvh_occl, shadow.org, shadow.direction, shadow.t_max, True),
    ], err, kernels_launches)
    compare_launches(f"cornell, binary tree of leaf {bvh_pack.bvh.leaf_size} beside leaf 32",
                     kernels, {"K6a": ("closest_bvh", bvh_pack.bvh),
                               "K6b": ("any_bvh", bvh_pack.bvh_occl)},
                     k1_trees, cornell_rays, card)
    del ctxs, chunk_pack, bvh_pack

    # --- 12. K5 under Route A against its plain versions ------------------------
    a_names = ("closest_wide_t", "any_wide_t")
    a_opts = dataclasses.replace(opts, wide_leaf_math="vpu")
    a_ctx = vpu_context("Cornell 1080p route A", scene, a_opts, "wide/vpu", device)
    check_path_rays(a_names, scene, camera, a_ctx, a_opts, gen, "cornell vpu", err, exact=True)
    check_closest("closest_wide_t", soup128, s_org, s_dir, "soup leaf 128", err, exact=True)
    check_any("any_wide_t", soup128, s_org, s_dir, t_max, "soup leaf 128", err)

    # --- 13. the Cornell path through Route A ----------------------------------
    a_launches, img = run_path("cornell vpu", scene, camera, a_ctx, a_opts, a_names)
    compare_images("cornell vpu", img, wide_img, "wide")

    # --- 14. K4 and the high_poly path through Route B ----------------------------
    b_names = ("closest_stream_t", "any_stream_t")
    b_opts = dataclasses.replace(opts, stream_leaf_math="vpu")
    b_ctx = vpu_context("high_poly 1080p route B", hp_scene, b_opts, "stream/vpu", device)
    log(f"[setup] route B: the occluder tree's stack {b_ctx.accel_pack.wide_occl.max_stack}; "
        f"K4's stack {wide_bvh._t_kernels().stream_t_stack_depth()}")
    check_path_rays(b_names, hp_scene, hp_camera, b_ctx, b_opts, gen, "high_poly vpu", err,
                    exact=True)
    check_closest("closest_stream_t", soup128, s_org, s_dir, "soup leaf 128", err, exact=True)
    check_any("any_stream_t", soup128, s_org, s_dir, t_max, "soup leaf 128", err)
    b_launches, img = run_path("high_poly vpu", hp_scene, hp_camera, b_ctx, b_opts, b_names)
    compare_images("high_poly vpu", img, hp_img, "stream")
    del img, hp_img, wide_img, soup128

    # --- 15. K5 times beside K1/K2 and K4b on the same rays, and K4 times ---------
    a_pack, b_pack = a_ctx.accel_pack, b_ctx.accel_pack
    kernels += time_kernels([
        ("closest_wide_t", a_pack.wide, prim.org, prim.direction, None, True),
        ("any_wide_t", a_pack.wide_occl, shadow.org, shadow.direction, shadow.t_max, True),
    ], err, a_launches)
    compare_launches("cornell, route A's leaf-128 trees beside leaf 32", kernels,
                     {"K5a": ("closest_wide_t", a_pack.wide),
                      "K5b": ("any_wide_t", a_pack.wide_occl)},
                     {**k1_trees, "K4b": ("any_stream_t", a_pack.wide_occl)},
                     cornell_rays, card)
    del cornell_rays, k1_trees
    hp_primary, hp_shadow, hp_head, hp_shadow2 = hp_rays
    kernels += time_kernels([
        ("closest_stream_t", b_pack.wide, hp_primary.org, hp_primary.direction, None, False),
        ("any_stream_t", b_pack.wide_occl, hp_shadow.org, hp_shadow.direction, hp_shadow.t_max,
         False),
    ], err, b_launches)
    entries = {k["name"]: k for k in kernels}
    for name, bvh, rays in (("closest_stream_t", b_pack.wide, hp_head),
                            ("any_stream_t", b_pack.wide_occl, hp_shadow2)):
        fn = queries()[name][0]
        kw = {"t_max": rays.t_max} if name.startswith("any_") else {}
        ms = time_ms(lambda: fn(bvh, rays.org, rays.direction, **kw), 10)
        head_entry(entries[name], bvh, rays.org, rays.direction, kw.get("t_max"), ms)
    del hp_rays, hp_head, hp_shadow2

    del a_ctx, b_ctx, a_pack, b_pack

    # --- 16. P3: visit counts per block, through the probe's entry point ------
    from heatray_tpu_torch.probes import visit_stats

    p_setup = visit_stats.setup("cornell", WIDTH, HEIGHT, DEPTH, device)
    p3_entry, p3_launches = phase_p3(p_setup, (hp_scene, hp_camera, opts, hp_ctx), gen, err,
                                     card)
    del hp_ctx

    # --- 17-18. P1 (node walk, leaf tests, launch) and P4 (row and warp) --------
    _, p_camera, p_opts, p_ctx, _ = p_setup
    p_prim = integrator.start_paths(p_camera, p_ctx, p_opts, 0)
    p_accel = p_ctx.accel_pack.accel
    p1_entries, p1_launches, brute = phase_p1(p_accel, p_prim, gen, err)
    p4_entry, p4_launches, p4_row_ms = phase_p4(p_accel, p_prim, gen, err, brute)
    p4_bound = p4_entry["bound_ms"]
    log(f"[compare] P4 on {p_prim.org.x.numel()} rays, tc 128, tile 256: warp "
        f"{p4_entry['ms']:.4f} ms ({p4_bound / p4_entry['ms']:.1%} of the {p4_bound:.4f} ms "
        f"bound), row (rows_brute_kernel) {p4_row_ms:.4f} ms ({p4_bound / p4_row_ms:.1%}); "
        f"card {card}")
    del p_prim

    # --- 19. P2: the walk variants on the sorted depth-2 wavefront --------------
    p2_entries, p2_launches = phase_p2(p_setup, gen, err, card)
    probe_launches = {name: p3_launches[name] + p1_launches[name] + p4_launches[name]
                      + p2_launches[name] for name in [*PROBE_KERNELS, *P2_KERNELS]}
    p1_entries[1]["p4_ms"] = p4_row_ms  # rows_brute at P4's tc 128, tile 256
    for entry in [p3_entry, *p1_entries, p4_entry, *p2_entries]:
        entry["launches"] = probe_launches[entry["name"]]
        entry["max_abs_err"] = err[entry["name"]]
        kernels.append(entry)

    # --- 20. the appearance slice: Scenes A and B through K1/K2 ----------------
    appearance = phase_appearance(gen, err, card)
    for entry in kernels:
        if entry["name"] in ("closest_wide", "any_wide"):
            entry["appearance_launches"] = {k: v[entry["name"]] for k, v in appearance.items()}
            entry["max_abs_err"] = err[entry["name"]]

    # --- 21. the ingest slice: model files to images through cli ---------------
    ingest = phase_ingest(gen, err, card)
    for entry in kernels:
        if entry["name"] in ("closest_wide", "any_wide", "closest_stream", "any_stream"):
            entry["ingest_launches"] = {k: v[entry["name"]] for k, v in ingest.items()
                                        if v[entry["name"]]}
            entry["max_abs_err"] = err[entry["name"]]

    # --- 22. the live preview and edit loop ---------------------------------
    interactive_launches, interactive = phase_interactive(gen, err, card)
    for entry in kernels:
        if entry["name"] in interactive_launches:
            n = interactive_launches[entry["name"]]
            entry["interactive_launches"] = n // 9 if n % 9 == 0 else n / 9  # a block pass
            entry["interactive_launches_nine_passes"] = n
            entry["interactive"] = interactive
            entry["max_abs_err"] = err[entry["name"]]

    # --- 23. multi-device on the one card ------------------------------------
    multi = phase_multi(gen, err, card)
    for entry in kernels:
        if entry["name"] in multi:
            entry["multi_launches"] = multi[entry["name"]]
            entry["max_abs_err"] = err[entry["name"]]

    log(f"[total] chip_smoke.py took {time.perf_counter() - t_start:.1f} s")
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
