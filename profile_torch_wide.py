#!/usr/bin/env python3
"""K1/K2 (``heatray_tpu_torch/csrc/wide_bvh.cu``) and K7a
(``heatray_tpu_torch/csrc/chunks.cu``) beside variants of their design, on
the Cornell box's 1080p launches on an NVIDIA card.

Run from the root of a checkout, on a machine with one card:

    python3 profile_torch_wide.py [--kernels k1,k7] [--parent DIR]

Each variant is a copy of ``heatray_tpu_torch/csrc/`` with the text edits
of ``VARIANTS`` (K1/K2) or ``CHUNK_VARIANTS`` (K7a) applied, built with the
package's nvcc flags into ``build/wide_variants/`` (one nvcc each, all
started together).  ``--parent DIR`` adds the ``wide_bvh.cu`` and
``chunks.cu`` of another tree as they stand (for example an unpacked parent
commit); without it, K7a's ``parent`` is the design it replaced
(``k7a_parent.py``, a 256-ray block walk in index order over chunks staged
in shared memory, each entering thread testing every triangle in turn).  The
launches are those of a pass at depth 2, sorted and gated as on the card:
K1 and K7a on the primary rays and on the sorted depth-2 head, K2 and K7b on
their shadow lanes, K7 over the rebuild mode's chunk pack.  For K1/K2 it
prints, one reading per line:

- the card's name and power limit, as ``nvidia-smi`` gives them;
- ``[build]``: each variant's registers and spill bytes for K1 and K2;
- ``[check]``: each variant's results against the shipped kernel's on every
  launch (t, slot and blocked, bit for bit); a variant of this tree must
  equal it, the parent's count of differing lanes is printed;
- ``[time]``: ms per launch over 10 launches, each library timed in turn,
  in order and then in reverse, min/max of the two: every variant over the
  Cornell box's tree at leaf 32, and ``shipped``, ``warp`` and the parent
  over the trees at leaf 64 and 128 (``wide_leaf_size``) too;
- ``[groups]``: at each leaf size and launch, the groups of rays that K1/K2's
  leaf service meets (one per warp, offered leaf and round; the ``count``
  variant): their number, mean rays per group, and the share of groups, and
  of (ray, leaf) pairs, in groups of more than 16 and than ``kLaneRays``
  rays.

and for K7a:

- ``[build]``: each variant's registers and spill bytes for K7a (K7b);
- ``[check]``: each variant's t and ids against the shipped kernel's on the
  primary rays and the head, bit for bit (a variant of this tree must equal
  it; the parent's count of differing lanes is printed);
- ``[time]``: ms per launch over 10 launches, in turns as for K1, and K7b
  for ``shipped`` and the parent;
- ``[pairs]``: on each launch, the pair tests K7a makes (its (ray, block)
  services times the block's 32 columns; the ``count`` variant) against
  those of ``chip_smoke.chunk_work`` (every block a ray enters, in every
  chunk it enters, before its hit) and those of whole chunks (the parent's),
  and the groups served ray per lane and one ray at a time.

It imports no jax.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent
CSRC = REPO / "heatray_tpu_torch" / "csrc"
OUT = REPO / "build" / "wide_variants"
WIDTH, HEIGHT = 1920, 1080
LEAVES = (32, 64, 128)
WIDE_LEAF_VARIANTS = ("shipped", "warp", "parent")

_COMMON = "wide_bvh_common.cuh"
_K1 = "wide_bvh.cu"
_K7 = "chunks.cu"
_ANY_LANES = """    if (__popc(rays) > kLaneRays) {
      const bool mine = (rays >> lane) & 1u;
      const int n = min(tc - j0, 32);
      for (int j = 0; j < n; ++j) {
        const TriCols col_j = shfl_cols(cols, j);
        if (mine && !hit && tri_t(col_j, a.ox, a.oy, a.oz, a, t_min, t_max) < kMissT) {
          hit = true;
        }
      }
      return;
    }
"""
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
    (_COMMON, "    serve_cols_closest(cols, min(tc - j0, 32),",
     "    serve_cols_closest(w + (size_t)c * 12 * tc, tc, j0, cols, min(tc - j0, 32),"),
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
        (_COMMON, "    for (rays &= ~__ballot_sync(kFullMask, hit); rays; rays &= rays - 1) {\n",
         _ANY_LANES + "    for (rays &= ~__ballot_sync(kFullMask, hit); rays; rays &= rays - 1) {\n"),
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
    "count": ("the shipped kernel, counting its (ray, block) services", [
        (_K7, "// The block of columns j0 .. j0 + 31 of chunk `W`",
         "__device__ unsigned long long chunk_counts[4];\n\n"
         "// The block of columns j0 .. j0 + 31 of chunk `W`"),
        (_K7, "  const int lane = threadIdx.x & 31;\n  const int n = min(tc - j0, kBlock);\n",
         "  const int lane = threadIdx.x & 31;\n  const int n = min(tc - j0, kBlock);\n"
         "  if (lane == __ffs(static_cast<int>(rays)) - 1) {\n"
         "    const bool big = __popc(rays) > kLaneRays;\n"
         "    atomicAdd(&chunk_counts[0], static_cast<unsigned long long>(__popc(rays)));\n"
         "    atomicAdd(&chunk_counts[big ? 1 : 2], 1ull);\n"
         "    if (big) {\n"
         "      atomicAdd(&chunk_counts[3], static_cast<unsigned long long>(__popc(rays)));\n"
         "    }\n"
         "  }\n"),
        (_K7, "extern \"C\" int closest_chunks(",
         _CHUNK_COUNT_READ.lstrip() + "\nextern \"C\" int closest_chunks("),
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
        body, count = pattern.subn(new.replace("\\", "\\\\"), path.read_text())
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


def chunk_library(so: Path, blocks: bool = True) -> ctypes.CDLL:
    """A build of chunks.cu (or of a variant of it), its entry points
    declared as the package declares them; without ``blocks`` (the parent
    design), ``closest_chunks`` takes no block boxes."""
    from heatray_tpu_torch.ops import intersect_pallas as ip

    lib = ctypes.CDLL(str(so))
    closest = ip._CLOSEST_ARGS if blocks else [a for i, a in enumerate(ip._CLOSEST_ARGS) if i != 7]
    lib.closest_chunks.argtypes, lib.closest_chunks.restype = closest, ctypes.c_int
    if hasattr(lib, "any_chunks"):
        lib.any_chunks.argtypes, lib.any_chunks.restype = ip._ANY_ARGS, ctypes.c_int
    return lib


_KERNEL_LABELS = {"closest_wide": "K1", "any_wide": "K2", "closest_chunks": "K7a",
                  "any_chunks": "K7b"}


def resources(report: str) -> str:
    """Each kernel's registers and spill bytes from a ptxas report."""
    out, kernel = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel = next((k for name, k in _KERNEL_LABELS.items() if name in m.group(1)), None)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and kernel:
            out.setdefault(kernel, {})["spill"] = f"{m.group(1)}/{m.group(2)} B spilled"
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            out.setdefault(kernel, {})["regs"] = f"{m.group(1)} registers"
    return ", ".join(f"{k} {v.get('regs', '?')} ({v.get('spill', '?')})"
                     for k, v in sorted(out.items()))


def launches(device):
    """The Cornell box's trees at each of LEAVES, the rebuild mode's chunk
    packs (closest hit, occlusion) and its four launches."""
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
        f"{chunks[0].num_chunks} chunks of {chunks[0].tri_chunk}")
    return trees, chunks, rays, opts.ray_epsilon


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


def profile_k7(libs, chunks, rays, eps, parents) -> None:
    """K7a's variants on the rebuild mode's chunk pack: checked bit for bit
    against the shipped kernel, timed in turns (K7b for the shipped kernel
    and the parent), and the pair tests of the ``count`` variant set beside
    ``chunk_work``'s.  ``parents``: the libraries whose K7a takes no block
    boxes."""
    import torch

    from chip_smoke import chunk_work
    from heatray_tpu_torch.ops import intersect_pallas as ip
    from heatray_tpu_torch.ops.intersect_pallas import BLOCK
    from heatray_tpu_torch.ops import wide_bvh as wb

    def run(name, what):
        lib = libs[name]
        ray, t_max = rays[what]
        packed = chunks[t_max is not None]
        if t_max is None:
            args = ip._pack_args(packed, blocks=name not in parents)
            return wb.launch_closest(lib.closest_chunks, args, packed, ray.org, ray.direction,
                                     eps)[:2]
        return (wb.launch_any(lib.any_chunks, ip._pack_args(packed), packed, ray.org,
                              ray.direction, eps, t_max),)

    closest = ["primary", "head"]
    ref = {what: run("shipped", what) for what in closest}
    for name in libs:
        differ = {}
        for what in closest:
            (t, ids), (t_ref, id_ref) = run(name, what), ref[what]
            differ[what] = int(((t != t_ref) | (ids != id_ref)).sum())
        log(f"[check] K7a {name}: lanes whose t or id differ from shipped: {differ}")
        if name != "parent" and any(differ.values()):
            raise AssertionError(f"K7a variant {name} differs from the shipped kernel")
    names = list(libs)
    ms = in_turns(names, closest, run)
    for name in names:
        log(f"[time] K7a {name}: " + ", ".join(
            f"{what} {min(v):.4f}/{max(v):.4f}" for what, v in ms[name].items()))
    occl = [n for n in ("shipped", "parent") if n in libs and hasattr(libs[n], "any_chunks")]
    ms = in_turns(occl, ["shadow", "head shadow"], run)
    for name in occl:
        log(f"[time] K7b {name}: " + ", ".join(
            f"{what} {min(v):.4f}/{max(v):.4f}" for what, v in ms[name].items()))

    if "count" in libs:
        lib = libs["count"]
        counts = (ctypes.c_ulonglong * 4)()
        tc = chunks[0].tri_chunk
        for what in closest:
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", default="k1,k7",
                    help="which families to profile: k1 (K1/K2), k7 (K7a), or both (default)")
    ap.add_argument("--parent", type=Path,
                    help="another tree whose wide_bvh.cu and chunks.cu to time too")
    args = ap.parse_args()
    families = set(args.kernels.split(","))
    if not families or families - {"k1", "k7"}:
        raise SystemExit(f"--kernels takes k1, k7 or both, not {args.kernels!r}")

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_wide: needs an NVIDIA card")
    sys.path.insert(0, str(REPO))
    import k7a_parent
    from chip_smoke import card_line
    from heatray_tpu_torch.ops import wide_bvh as wb

    card = card_line()
    log(card)
    sources = {}  # (family, name) -> source
    if "k1" in families:
        for name, (_, edits) in VARIANTS.items():
            sources["k1", name] = variant_source(f"k1-{name}", edits)
        if args.parent:
            sources["k1", "parent"] = args.parent.resolve() / "heatray_tpu_torch" / "csrc" / _K1
    if "k7" in families:
        for name, (_, edits) in CHUNK_VARIANTS.items():
            sources["k7", name] = variant_source(f"k7-{name}", edits, _K7)
        if args.parent:
            sources["k7", "parent"] = args.parent.resolve() / "heatray_tpu_torch" / "csrc" / _K7
    parent_dir = OUT / "k7a_parent"
    with ThreadPoolExecutor(len(sources) + 1) as pool:
        parent = (pool.submit(k7a_parent.build, parent_dir)
                  if "k7" in families and not args.parent else None)
        built = dict(zip(sources, pool.map(
            lambda key: compile_lib("-".join(key), sources[key]), sources)))
    libs, no_blocks = {"k1": {}, "k7": {}}, []
    if parent is not None:
        libs["k7"]["parent"] = parent.result()
        no_blocks.append("parent")
        log(f"[build] k7 parent (k7a_parent.py): "
            f"{resources((parent_dir / 'chunks_parent.log').read_text())}")
    for (family, name), (so, report) in built.items():
        variants = VARIANTS if family == "k1" else CHUNK_VARIANTS
        what = variants[name][0] if name in variants else f"{sources[family, name]} as it stands"
        log(f"[build] {family} {name} ({what}): {resources(report)}")
        if so is None:
            continue
        if family == "k7":
            # --parent's chunks.cu from before the block boxes.
            if "const float* blocks" not in sources[family, name].read_text():
                no_blocks.append(name)
            libs[family][name] = chunk_library(so, blocks=name not in no_blocks)
            continue
        lib = ctypes.CDLL(str(so))
        lib.wide_bvh_stack_depth.restype = ctypes.c_int
        lib.closest_wide.argtypes, lib.any_wide.argtypes = wb._CLOSEST_ARGS, wb._ANY_ARGS
        libs[family][name] = lib

    trees, chunks, rays, eps = launches(torch.device("cuda:0"))
    if libs["k1"]:
        profile_k1(libs["k1"], trees, rays, eps)
    if libs["k7"]:
        profile_k7(libs["k7"], chunks, rays, eps, no_blocks)
    log(f"[card] {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
