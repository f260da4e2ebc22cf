#!/usr/bin/env python3
"""Where one 1080p pass of the PyTorch/CUDA port (heatray_tpu_torch) spends
its time on an NVIDIA card, how the card's config2 render compares with the
stored golden and with the CPU, and what the bounce sort and segment gating
cost or save on the Cornell box.

Run from the root of a checkout, on a machine with one card:

    python3 profile_torch_pass.py [--scene cornell|high-poly|scene-a|scene-b] [--passes 5]
                                  [--backend auto|wide|stream|bvh|pallas|rebuild]
                                  [--leaf-math mxu|vpu] [--root DIR] [--trace FILE]
                                  [--step]

``--root`` imports the package from another tree (for example an unpacked
parent commit), so two versions can be compared within one machine session.
It prints, one reading per line:

- the card's name and power limit, as ``nvidia-smi`` gives them;
- ``[golden]``: config2 (48x48, 4 passes, depth 4) rendered on the card and on
  the CPU, each against ``tests/goldens/config2_cornell.npy``: max |diff| and
  the count of values outside rtol = atol = 5e-3; then card against CPU: max
  |diff| and the count of values that differ at all and by more than 1e-3;
- ``[sort]``: the Cornell box at 1920x1080, depth 4, steady passes with the
  bounce sort and segment gating on and with both off, in turns, and their
  means;
- ``[pass]``: the chosen scene (``--scene``; ``high-poly`` is ``high_poly()``
  framed as ``bench.py`` frames it; ``scene-a`` and ``scene-b`` are
  ``chip_smoke.py``'s phase-20 scenes, ``multi_material`` under the 2k
  studio map and its textured variant, rendered at depth 5) at 1920x1080,
  depth 4, through the chosen backend (``--backend``: an
  ``intersect_backend``, ``auto`` by default, or ``rebuild``, a context
  without a scene, whose passes rebuild their Woop
  rows, chunk packs and shading table) and, for the wide trees, the chosen
  leaf math (``--leaf-math vpu``: ``wide_leaf_math`` and ``stream_leaf_math``
  ``"vpu"``, the transposed kernels K5 and K4): the ms of each steady pass
  after two warm-up passes (host clock around ``render_pass``, ended by
  ``torch.cuda.synchronize()``) and their mean;
- ``[prof]``: one more pass under ``torch.profiler``, its stages labelled from
  outside the package with ``record_function``: the pass's wall ms, the sum
  of its CUDA kernels' self time (the "kernel ms" every share below divides
  by), their count, that sum over the wall, peak device memory, the lanes
  each gated bounce ran, each label's device ms, and the closest-hit and
  occlusion kernels' ms per launch.  In the rebuild mode the rebuild is a
  label of its own.

With ``--step`` it prints instead, after the card line, ``bench.py``'s
fwd+bwd step on the chosen scene at 1920x1080, depth 4 (``mean(img^2)`` of
one pass, ``base_color`` and ``roughness`` as leaf tensors through
``diff.inverse.apply_material_params``, a context made with
``static_shading=False``), with ``remat_bounces`` on and off in turns:

- ``[step]``: the ms of each steady step after two warm-up steps (host
  clock, ended by ``torch.cuda.synchronize()``) and their mean;
- ``[step prof]``: one more step under ``torch.profiler``, its forward
  (through the loss) and its backward profiled apart: each one's wall ms,
  kernel ms, kernel count, busy share (kernel ms over the wall) and
  traversal-kernel launches, the step's peak device memory, and the
  backward's largest kernels by device ms.

It imports no jax.  ``--trace`` also writes the profiler's Chrome trace.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
WIDTH, HEIGHT, DEPTH = 1920, 1080, 4
GOLDEN_SIZE, GOLDEN_PASSES, GOLDEN_TOL = 48, 4, 5e-3

# (module, function, label); a label is summed over every call of a pass.
# The traversal kernels are counted by name instead: they are launched
# through ctypes, which the profiler does not tie to an enclosing label.
KERNELS = {
    "closest_wide_kernel": "K1 closest hit",
    "any_wide_kernel": "K2 occlusion",
    "closest_stream_kernel": "K3a closest hit (streaming)",
    "any_stream_kernel": "K3b occlusion (streaming)",
    "closest_chunks_kernel": "K7a closest hit (chunks)",
    "any_chunks_kernel": "K7b occlusion (chunks)",
    "closest_bvh_kernel": "K6a closest hit (binary BVH)",
    "any_bvh_kernel": "K6b occlusion (binary BVH)",
    "closest_wide_t_kernel": "K5a closest hit (transposed leaf test)",
    "any_wide_t_kernel": "K5b occlusion (transposed leaf test)",
    "closest_stream_t_kernel": "K4a closest hit (streaming, transposed leaf test)",
    "any_stream_t_kernel": "K4b occlusion (streaming, transposed leaf test)",
}
LABELS = [
    ("integrator", "rebuild_pack", "rebuild"),
    ("integrator", "generate_primary_rays", "raygen"),
    ("integrator", "_sort_paths", "bounce sort"),
    ("integrator", "gather_rows", "row gather"),
    ("integrator", "hit_attributes_rows", "hit attributes"),
    ("integrator", "shade_hits", "shading"),
    ("integrator", "_accum_update", "accumulate"),
    ("shade", "sobol_value", "shading: Sobol chain"),
    ("shade", "compute_light_sample", "shading: light selection"),
    ("shade", "compute_multiscattering_fit", "shading: multiscatter fit"),
    ("shade", "sample_atlas", "shading: texture fetches"),
    ("shade", "env_radiance", "shading: environment lookups"),
    ("integrator", "env_radiance", "environment on misses"),
]
APPEARANCE_SCENES, APPEARANCE_DEPTH = ("scene-a", "scene-b"), 5


def log(*args):
    print(*args, flush=True)


def golden(np, device):
    from heatray_tpu_torch import cornell_box, orbit_camera, render, resolve
    from heatray_tpu_torch.options import RenderOptions

    g = GOLDEN_SIZE
    opts = RenderOptions(width=g, height=g, max_render_passes=GOLDEN_PASSES, max_ray_depth=DEPTH)
    camera = orbit_camera(g, g, distance=6.2, focal_length_mm=35.0)
    ref = np.load(REPO / "tests" / "goldens" / "config2_cornell.npy").astype(np.float32)
    img = {}
    for dev in (device, "cpu"):
        accum, _ = render(cornell_box(light="both", with_spheres=True), camera, opts,
                          num_passes=GOLDEN_PASSES, device=dev)
        img[dev] = resolve(accum).cpu().numpy()
        d = np.abs(img[dev] - ref)
        bad = int((d > GOLDEN_TOL + GOLDEN_TOL * np.abs(ref)).sum())
        log(f"[golden] {dev}: max |diff| {float(d.max())!r}, {bad} values outside 5e-3")
    d = np.abs(img[device] - img["cpu"])
    log(f"[golden] card - cpu: max |diff| {float(d.max())!r}, {int((d > 0).sum())} values "
        f"differ, {int((d > 1e-3).sum())} by more than 1e-3")


def scene_and_camera(name, device):
    from heatray_tpu_torch import cornell_box, frame_scene, high_poly, orbit_camera, scene_aabb

    if name == "cornell":
        scene = cornell_box(light="both", with_spheres=True)
        camera = orbit_camera(WIDTH, HEIGHT, distance=6.2, focal_length_mm=35.0)
    elif name in APPEARANCE_SCENES:
        from chip_smoke import appearance_scenes

        scene = appearance_scenes(device)[APPEARANCE_SCENES.index(name)]
        camera = orbit_camera(WIDTH, HEIGHT, distance=6.0, theta=0.3)
    else:
        scene = high_poly()
        camera = frame_scene(scene_aabb(scene.geometry), WIDTH, HEIGHT, theta=0.35)
    return scene.to(device), camera.to(device)


def kernel_stats(prof):
    """(kernel ms, kernel count, traversal launches, [(name, ms)] by device
    ms) of the CUDA kernels a profile recorded."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.key_averages() if e.device_type == cuda]
    ms = sum(e.self_device_time_total for e in kernels) / 1e3
    traversal = sum(e.count for e in kernels if any(k in e.key for k in KERNELS))
    top = sorted(((e.key, e.self_device_time_total / 1e3) for e in kernels), key=lambda r: -r[1])
    return ms, sum(e.count for e in kernels), traversal, top


def profile_step(args, opts, device) -> int:
    """The ``--step`` readings (see the module docstring)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from heatray_tpu_torch.bridge import params_from_arrays
    from heatray_tpu_torch.diff.inverse import apply_material_params
    from heatray_tpu_torch.options import FrameGlobals
    from heatray_tpu_torch.render import integrator

    scene, camera = scene_and_camera(args.scene, device)
    ctx = integrator.make_context(opts, scene, device, static_shading=False)
    params = params_from_arrays({"base_color": scene.materials.base_color.cpu().numpy(),
                                 "roughness": scene.materials.roughness.cpu().numpy()}, device)
    zero = torch.zeros((4, HEIGHT, WIDTH), device=device)

    def forward(options, i):
        for v in params.values():
            v.grad = None
        a = integrator.render_pass(apply_material_params(scene, params), camera, ctx, options,
                                   FrameGlobals.create(i, device=device), zero)
        img = a[:3] / torch.clamp(a[3:], min=1.0)
        return torch.mean(img * img)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    for remat in (True, False, False, True):
        options = dataclasses.replace(opts, remat_bounces=remat)
        for i in range(2):
            forward(options, i).backward()
        ms = [timed(lambda: forward(options, 2 + i).backward())[1] for i in range(args.passes)]
        log(f"[step] {args.scene} {WIDTH}x{HEIGHT} depth {DEPTH}, remat_bounces={remat}: "
            f"steady ms {ms!r}, mean {sum(ms) / len(ms)!r}")
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts) as prof_f:
            loss, wall_f = timed(lambda: forward(options, 2 + args.passes))
        with profile(activities=acts) as prof_b:
            _, wall_b = timed(loss.backward)
        peak = torch.cuda.max_memory_allocated()
        for part, prof, wall in (("forward", prof_f, wall_f), ("backward", prof_b, wall_b)):
            ms_k, n, traversal, top = kernel_stats(prof)
            log(f"[step prof] remat_bounces={remat} {part}: wall {wall!r} ms; kernel ms {ms_k!r} "
                f"in {n} kernels, {ms_k / wall!r} of the wall; traversal launches {traversal}")
        log(f"[step prof] remat_bounces={remat}: peak memory {peak / 2**20!r} MiB "
            f"({(peak - held) / 2**20!r} above the {held / 2**20!r} held before the step); "
            f"backward's largest kernels (ms) {[(k[:60], round(v, 3)) for k, v in top[:6]]}")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", choices=("cornell", "high-poly", *APPEARANCE_SCENES),
                    default="cornell",
                    help="scene of the [pass] and [prof] readings")
    ap.add_argument("--backend", default="auto",
                    choices=("auto", "wide", "stream", "bvh", "pallas", "rebuild"),
                    help="intersect_backend of the [pass] and [prof] readings, or rebuild")
    ap.add_argument("--leaf-math", choices=("mxu", "vpu"), default="mxu",
                    help="wide_leaf_math and stream_leaf_math of the [pass] and [prof] readings")
    ap.add_argument("--passes", type=int, default=5, help="steady passes to time")
    ap.add_argument("--root", type=Path, default=REPO, help="tree to import the package from")
    ap.add_argument("--trace", type=Path, help="write the profiled pass's Chrome trace here")
    ap.add_argument("--step", action="store_true",
                    help="profile bench.py's fwd+bwd step instead of a pass")
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_pass: needs an NVIDIA card")
    sys.path.insert(0, str(args.root.resolve()))
    from heatray_tpu_torch.options import FrameGlobals, RenderOptions
    from heatray_tpu_torch.render import integrator, shade

    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    log(f"[root] {args.root.resolve()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda:0")
    opts = RenderOptions(width=WIDTH, height=HEIGHT, max_render_passes=64, max_ray_depth=DEPTH)
    if args.step:
        return profile_step(args, opts, device)
    golden(np, device)

    accum = torch.zeros((4, HEIGHT, WIDTH), device=device)

    def one_pass(scene, camera, ctx, options, i):
        nonlocal accum
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        accum = integrator.render_pass(scene, camera, ctx, options,
                                       FrameGlobals.create(i, device=device), accum)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    # Sorted and gated against unsorted, in turns, on the Cornell box.
    scene, camera = scene_and_camera("cornell", device)
    ctx = integrator.make_context(opts, scene, device)
    modes = {True: opts, False: dataclasses.replace(opts, sort_bounces=False, gate_bounces=False)}
    ms = {True: [], False: []}
    for i in range(args.passes + 1):
        for on in ((True, False) if i % 2 else (False, True)):
            t = one_pass(scene, camera, ctx, modes[on], i)
            if i:  # the first round warms both up
                ms[on].append(t)
    log(f"[sort] cornell {WIDTH}x{HEIGHT} depth {DEPTH}: sorted+gated ms {ms[True]!r}, mean "
        f"{sum(ms[True]) / len(ms[True])!r}; unsorted ms {ms[False]!r}, mean "
        f"{sum(ms[False]) / len(ms[False])!r}")

    rebuild = args.backend == "rebuild"
    opts = dataclasses.replace(opts, intersect_backend="pallas" if rebuild else args.backend,
                               wide_leaf_math=args.leaf_math, stream_leaf_math=args.leaf_math,
                               max_ray_depth=(APPEARANCE_DEPTH if args.scene in APPEARANCE_SCENES
                                              else DEPTH))
    t0 = time.perf_counter()
    scene, camera = scene_and_camera(args.scene, device)
    ctx = integrator.make_context(opts, None if rebuild else scene, device)
    torch.cuda.synchronize()
    log(f"[setup] {args.scene}: {scene.geometry.num_triangles} triangles, backend "
        f"{'rebuild' if rebuild else ctx.accel_pack.backend!r}, leaf math {args.leaf_math}, "
        f"context in "
        f"{time.perf_counter() - t0!r} s")
    warm = [one_pass(scene, camera, ctx, opts, i) for i in range(2)]
    ms = [one_pass(scene, camera, ctx, opts, 2 + i) for i in range(args.passes)]
    log(f"[pass] {args.scene} {WIDTH}x{HEIGHT} depth {opts.max_ray_depth}: warm-up ms {warm!r}; "
        f"steady ms {ms!r}, mean {sum(ms) / len(ms)!r}")

    lanes = []
    gated = integrator._gated_lanes

    def count_lanes(*a, **k):
        n = gated(*a, **k)
        lanes.append(n)
        return n

    integrator._gated_lanes = count_lanes
    mods = {"integrator": integrator, "shade": shade}
    for mod, name, label in LABELS:
        fn = getattr(mods[mod], name)

        @functools.wraps(fn)
        def wrapped(*a, _fn=fn, _label=label, **k):
            with record_function(_label):
                return _fn(*a, **k)

        setattr(mods[mod], name, wrapped)

    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = one_pass(scene, camera, ctx, opts, 2 + args.passes)
    # Each label shows up twice: as the host range (device time = the kernels
    # it launched) and as its copy on the device timeline, which is no kernel.
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    labels = {label for _, _, label in LABELS}
    ka = prof.key_averages()
    kernels = [e for e in ka if e.device_type == cuda and e.key not in labels]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"[prof] wall {wall!r} ms; kernel ms {busy!r} in {sum(e.count for e in kernels)} "
        f"kernels, {busy / wall!r} of the wall; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**20!r} MiB; lanes run at depths 2.. "
        f"{lanes!r} of {WIDTH * HEIGHT}")
    rows = [(e.key, e.count, e.device_time_total / 1e3)
            for e in ka if e.key in labels and e.device_type == cpu]
    for name, label in KERNELS.items():
        per = [ev.device_time / 1e3 for ev in prof.events()
               if name in ev.name and ev.device_type == cuda]
        rows.append((label, len(per), sum(per)))
        log(f"[prof] {name} ms per launch {per!r}")
    outside = busy - sum(ms for key, _, ms in rows if not key.startswith("shading:"))
    rows.append(("outside the labels", 0, outside))
    for key, count, dev_ms in sorted(rows, key=lambda r: -r[2]):
        log(f"[prof] {key}: {count} calls, device {dev_ms!r} ms, {dev_ms / busy!r} of kernel ms")
    if args.trace:
        args.trace.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(args.trace))
    return 0


if __name__ == "__main__":
    sys.exit(main())
