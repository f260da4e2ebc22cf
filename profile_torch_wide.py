#!/usr/bin/env python3
"""K1/K2 (``heatray_tpu_torch/csrc/wide_bvh.cu``) beside variants of their
design, on the Cornell box's 1080p launches on an NVIDIA card.

Run from the root of a checkout, on a machine with one card:

    python3 profile_torch_wide.py [--parent DIR]

Each variant is a copy of ``heatray_tpu_torch/csrc/`` with the text edits
of ``VARIANTS`` applied, built with the package's nvcc flags into
``build/wide_variants/`` (one nvcc each, all started together).
``--parent DIR`` adds the ``wide_bvh.cu`` of another tree as it stands (for
example an unpacked parent commit).  The launches are those of a pass at
depth 2, sorted and gated as on the card: K1 on the primary rays and on the
sorted depth-2 head, K2 on their shadow lanes.  It prints, one reading per
line:

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
# kLaneRays as shipped: groups of more rays test ray per lane.
LANE_RAYS = int(re.search(r"constexpr int kLaneRays = (\d+);",
                          (CSRC / _COMMON).read_text()).group(1))
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


def _lane_rays(n: int, what: str):
    return what, [(_COMMON, f"constexpr int kLaneRays = {LANE_RAYS};",
                   f"constexpr int kLaneRays = {n};")]


# name -> (what it changes, [(file, text, replacement)]).  Each text must
# occur once in its file.
VARIANTS = {
    "shipped": ("the kernels as shipped", []),
    "warp": ("K3's leaf service (the leaf's triangles across the lanes, one ray at a time)", [
        (_K1, "closest_walk<LaneServe>", "closest_walk<WarpServe>"),
        (_K1, "any_walk<LaneServe>", "any_walk<WarpServe>"),
    ]),
    **{f"rays-{n}": _lane_rays(n, f"ray per lane above {n} rays a group")
       for n in (8, 16, 20, 28) if n != LANE_RAYS},
    "rays-none": _lane_rays(32, "no ray-per-lane branch: every group one ray at a time"),
    "uncapped": ("no register cap (__launch_bounds__ with 1 block per SM)", [
        (_K1, "constexpr int kMinBlocks = 8;", "constexpr int kMinBlocks = 1;"),
    ]),
    "load": ("ray per lane reads each column from memory instead of shuffles", [
        (_COMMON, "const TriCols col_j = shfl_cols(cols, j);",
         "const TriCols col_j = load_cols(w + (size_t)c * 12 * tc, tc, j0 + j);"),
    ]),
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


def log(*args):
    print(*args, flush=True)


def variant_source(name: str, edits) -> Path:
    """A copy of csrc/ with ``edits`` applied: the path of its wide_bvh.cu."""
    src = OUT / name / "csrc"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(CSRC, src)
    for file, text, new in edits:
        path = src / file
        body = path.read_text()
        if body.count(text) != 1:
            raise ValueError(f"variant {name}: {text!r} occurs {body.count(text)} times in {file}")
        path.write_text(body.replace(text, new))
    return src / _K1


def compile_lib(name: str, source: Path):
    """(library or None, ptxas report) of one variant."""
    from heatray_tpu_torch.ops import cuda_build

    so = OUT / f"{name}.so"
    proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(so), str(source)],
                          capture_output=True, text=True)
    report = proc.stdout + proc.stderr
    if proc.returncode:
        log(f"[build] {name}: nvcc failed ({proc.returncode})\n{proc.stderr[-3000:]}")
        return None, report
    return so, report


def resources(report: str) -> str:
    """K1's and K2's registers and spill bytes from a ptxas report."""
    out, kernel = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel = ("K1" if "closest_wide" in m.group(1) else
                      "K2" if "any_wide" in m.group(1) else None)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and kernel:
            out.setdefault(kernel, {})["spill"] = f"{m.group(1)}/{m.group(2)} B spilled"
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            out.setdefault(kernel, {})["regs"] = f"{m.group(1)} registers"
    return ", ".join(f"{k} {v.get('regs', '?')} ({v.get('spill', '?')})"
                     for k, v in sorted(out.items()))


def launches(device):
    """The Cornell box's trees at each of LEAVES and its four launches."""
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
        f"head shadow {shadow2.org.x.numel()}; epsilon {opts.ray_epsilon}")
    return trees, rays, opts.ray_epsilon


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="another tree whose wide_bvh.cu to time too")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_wide: needs an NVIDIA card")
    sys.path.insert(0, str(REPO))
    from chip_smoke import card_line, time_ms
    from heatray_tpu_torch.ops import wide_bvh as wb

    card = card_line()
    log(card)
    OUT.mkdir(parents=True, exist_ok=True)
    sources = {name: variant_source(name, edits) for name, (_, edits) in VARIANTS.items()}
    if args.parent:
        sources["parent"] = args.parent.resolve() / "heatray_tpu_torch" / "csrc" / _K1
    with ThreadPoolExecutor(len(sources)) as pool:
        built = dict(zip(sources, pool.map(lambda k: compile_lib(k, sources[k]), sources)))
    libs = {}
    for name, (so, report) in built.items():
        what = VARIANTS[name][0] if name in VARIANTS else f"{args.parent}'s wide_bvh.cu"
        log(f"[build] {name} ({what}): {resources(report)}")
        if so is None:
            continue
        lib = ctypes.CDLL(str(so))
        lib.wide_bvh_stack_depth.restype = ctypes.c_int
        lib.closest_wide.argtypes, lib.any_wide.argtypes = wb._CLOSEST_ARGS, wb._ANY_ARGS
        libs[name] = lib

    device = torch.device("cuda:0")
    trees, rays, eps = launches(device)

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
        ms = {name: {what: [] for what in rays} for name in names}
        for name in names + names[::-1]:
            for what in rays:
                ms[name][what].append(time_ms(lambda: run(name, leaf, what), 10))
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
                for above in sorted({16, LANE_RAYS}):
                    big = sum(h[above + 1:])
                    big_pairs = sum(k * c for k, c in enumerate(h) if k > above)
                    shares.append(f"above {above} rays: {big / max(groups, 1):.4f} of the "
                                  f"groups, {big_pairs / max(pairs, 1):.4f} of the pairs")
                log(f"[groups] leaf {leaf}, {what}: {groups} groups, "
                    f"{pairs / max(groups, 1):.3f} rays a group; " + "; ".join(shares))
    log(f"[card] {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
