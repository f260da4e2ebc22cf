#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (heatray_tpu_torch) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the wide-BVH kernels from ``heatray_tpu_torch/csrc`` and then:

1. checks each kernel against its plain PyTorch version on the card: the
   Cornell box tree with 65,536 primary, first-bounce and NEE shadow rays of
   a 1080p pass, and a 50,000-triangle random soup;
2. renders the golden configuration config2 (48x48, 4 passes, depth 4) and
   compares it with ``tests/goldens/config2_cornell.npy``;
3. renders the main path, the Cornell box at 1920x1080, depth 4, 4 passes,
   counting kernel launches, and reports ms per pass and Mrays/s;
4. checks each kernel against its plain version again on all 2,073,600
   rays of a 1080p bounce, and times both there.

Any failure raises and exits non-zero.  The last two lines of standard
output are the per-kernel JSON record and the result JSON.  Without a CUDA
device, or outside a checkout, it fails before printing a result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
DEVICE = "cuda:0"
SEED = 0
N_CHECK = 65_536
SOUP_TRIANGLES = 50_000
WIDTH, HEIGHT, DEPTH, PASSES = 1920, 1080, 4, 4
TOL = 1e-5  # rtol = atol on t: both sides are exact float32 arithmetic
KERNEL_SOURCE = "heatray_tpu_torch/csrc/wide_bvh.cu"
REPLACES = {
    "closest_wide": "heatray_tpu/ops/wide_bvh.py:297",
    "any_wide": "heatray_tpu/ops/wide_bvh.py:421",
}


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def subset(v, idx):
    from heatray_tpu_torch.vec import Vec3

    return Vec3(v.x[idx].contiguous(), v.y[idx].contiguous(), v.z[idx].contiguous())


def slot_t(bvh, org, d, slot):
    """t of each ray against one given slot each (plain arithmetic)."""
    import torch

    from heatray_tpu_torch.ops.intersect import MISS_T
    from heatray_tpu_torch.ops.wide_bvh import slot_rows

    rows, anchor = slot_rows(bvh)
    s = slot.clamp(min=0).long()
    r, a = rows[:, s], anchor[:, s]
    ox, oy, oz = org.x - a[0], org.y - a[1], org.z - a[2]

    def aff(g, x, y, z, with_b):
        v = x * r[4 * g] + y * r[4 * g + 1] + z * r[4 * g + 2]
        return v + r[4 * g + 3] if with_b else v

    t = -aff(2, ox, oy, oz, True) / aff(2, d.x, d.y, d.z, False)
    return torch.where(slot >= 0, t, MISS_T)


def check_closest(bvh, org, d, label, err):
    import torch

    from heatray_tpu_torch.ops import wide_bvh

    t_k, s_k, h_k = wide_bvh.intersect_closest_wide(bvh, org, d)
    t_p, s_p, h_p = wide_bvh.closest_wide_plain(bvh, org, d)
    torch.cuda.synchronize()
    if not torch.equal(h_k, h_p):
        raise AssertionError(f"{label}: closest-hit masks differ on {int((h_k != h_p).sum())} rays")
    diff = (t_k - t_p).abs()
    bad = diff > TOL + TOL * t_p.abs()
    if bad.any():
        raise AssertionError(f"{label}: closest t differs, max {float(diff.max())}")
    # A different slot is allowed only where it ties with the plain one.
    other = s_k != s_p
    tie = (slot_t(bvh, org, d, s_k) - t_p).abs() <= TOL + TOL * t_p.abs()
    if (other & ~tie).any():
        raise AssertionError(f"{label}: {int((other & ~tie).sum())} slots differ without a tie")
    err["closest_wide"] = max(err["closest_wide"], float(diff[h_p].max()) if h_p.any() else 0.0)
    log(f"[check] {label}: closest ok, {int(h_k.sum())}/{h_k.numel()} hit, "
        f"max |dt| {float(diff[h_p].max()) if h_p.any() else 0.0:.3g}, "
        f"{int(other.sum())} tied slots differ")


def check_any(bvh, org, d, t_max, label, err):
    import torch

    from heatray_tpu_torch.ops import wide_bvh

    b_k = wide_bvh.intersect_any_wide(bvh, org, d, t_max=t_max)
    b_p = wide_bvh.any_wide_plain(bvh, org, d, t_max=t_max)
    torch.cuda.synchronize()
    n_bad = int((b_k != b_p).sum())
    if n_bad:
        raise AssertionError(f"{label}: occlusion masks differ on {n_bad} rays")
    # The masks as 0/1: the largest |kernel - plain| over the rays.
    err["any_wide"] = max(err["any_wide"], float((b_k.float() - b_p.float()).abs().max()))
    log(f"[check] {label}: any ok, {int(b_k.sum())}/{b_k.numel()} blocked")


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this script needs a card")
    if not (REPO / "heatray_tpu_torch").is_dir():
        raise SystemExit("chip_smoke: run it from a checkout of the repository")
    sys.path.insert(0, str(REPO))

    import numpy as np

    from heatray_tpu_torch import cornell_box, orbit_camera, render, resolve
    from heatray_tpu_torch.ops import cuda_build, wide_bvh
    from heatray_tpu_torch.ops.intersect import build_woop
    from heatray_tpu_torch.options import FrameGlobals, RenderOptions
    from heatray_tpu_torch.render import integrator

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(DEVICE)
    card = card_line()
    log(card)

    t0 = time.perf_counter()
    lib = cuda_build.build("wide_bvh")
    log(f"[build] {lib.name} in {time.perf_counter() - t0:.1f} s")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "stack frame" in line:
            log("[build]", line.strip())

    # --- 1. kernels against their plain versions --------------------------
    err = {"closest_wide": 0.0, "any_wide": 0.0}
    opts = RenderOptions(width=WIDTH, height=HEIGHT, max_render_passes=64, max_ray_depth=DEPTH)
    scene = cornell_box(light="both", with_spheres=True).to(device)
    camera = orbit_camera(WIDTH, HEIGHT, distance=6.2, focal_length_mm=35.0).to(device)
    t0 = time.perf_counter()
    ctx = integrator.make_context(opts, scene, device)
    torch.cuda.synchronize()
    pack = ctx.accel_pack
    log(f"[setup] 1080p context in {time.perf_counter() - t0:.1f} s: "
        f"{pack.wide.num_triangles} triangles, {pack.wide.num_nodes} nodes, "
        f"{pack.wide.num_chunks} leaves, stack {pack.wide.max_stack}")

    frame = FrameGlobals.create(0, device=device)
    primary = integrator.start_paths(camera, ctx, opts, 0)
    first, shadow = integrator.bounce(scene, ctx, opts, frame, 1, primary)
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    pick = torch.randperm(WIDTH * HEIGHT, generator=gen)[:N_CHECK].to(device)
    check_closest(pack.wide, subset(primary.org, pick), subset(primary.direction, pick),
                  "cornell primary", err)
    live = first.active.nonzero()[:, 0]
    sel = live[torch.randperm(live.numel(), generator=gen)[:N_CHECK].to(device)]
    check_closest(pack.wide, subset(first.org, sel), subset(first.direction, sel),
                  "cornell first bounce", err)
    live = shadow.active.nonzero()[:, 0]
    sel = live[torch.randperm(live.numel(), generator=gen)[:N_CHECK].to(device)]
    check_any(pack.wide_occl, subset(shadow.org, sel), subset(shadow.direction, sel),
              shadow.t_max[sel].contiguous(), "cornell NEE shadow", err)

    pos, idx, s_org, s_dir = random_soup(SOUP_TRIANGLES, N_CHECK, device)
    t0 = time.perf_counter()
    soup = wide_bvh.build_wide_bvh(build_woop(pos, idx), leaf_size=32)
    log(f"[setup] {SOUP_TRIANGLES}-triangle soup tree in {time.perf_counter() - t0:.1f} s: "
        f"{soup.num_nodes} nodes, stack {soup.max_stack}")
    check_closest(soup, s_org, s_dir, "soup", err)
    t_max = torch.from_numpy(
        np.random.default_rng(SEED + 1).uniform(1.0, 12.0, N_CHECK).astype(np.float32)
    ).to(device)
    check_any(soup, s_org, s_dir, t_max, "soup", err)

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

    # --- 3. the main path ----------------------------------------------------
    closest_fn, any_fn = wide_bvh.intersect_closest_wide, wide_bvh.intersect_any_wide
    accum = torch.zeros((4, HEIGHT, WIDTH), dtype=torch.float32, device=device)
    rays, pass_ms = 0, []
    closest_fn.launches = any_fn.launches = 0
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
    launches = {"closest_wide": closest_fn.launches, "any_wide": any_fn.launches}
    if launches["closest_wide"] != PASSES * DEPTH or launches["any_wide"] < PASSES:
        raise AssertionError(f"main path kernel launches {launches}")
    if not torch.equal(accum[3], torch.full_like(accum[3], float(PASSES))):
        raise AssertionError("alpha is not the pass count everywhere")
    img = resolve(accum)
    if not bool(torch.isfinite(img).all()) or float(img.max()) <= 0.0:
        raise AssertionError("main path image is not finite, or black")
    total_s = sum(pass_ms) / 1e3
    log(f"[main] {WIDTH}x{HEIGHT} depth {DEPTH}, {PASSES} passes: ms/pass "
        f"{[round(m, 3) for m in pass_ms]}, mean {sum(pass_ms) / PASSES:.3f}; "
        f"{rays} rays, {rays / total_s / 1e6:.3f} Mrays/s; launches {launches}; card {card}")

    # --- 4. kernels against plain versions, and times, at the main path's shapes
    frame = FrameGlobals.create(1, device=device)
    prim = integrator.start_paths(camera, ctx, opts, 1)
    _, shadow = integrator.bounce(scene, ctx, opts, frame, 1, prim)
    check_closest(pack.wide, prim.org, prim.direction, "cornell 1080p primary", err)
    check_any(pack.wide_occl, shadow.org, shadow.direction, shadow.t_max,
              "cornell 1080p NEE shadow", err)
    timing = {
        "closest_wide": (
            lambda: closest_fn(pack.wide, prim.org, prim.direction),
            lambda: wide_bvh.closest_wide_plain(pack.wide, prim.org, prim.direction),
        ),
        "any_wide": (
            lambda: any_fn(pack.wide_occl, shadow.org, shadow.direction, t_max=shadow.t_max),
            lambda: wide_bvh.any_wide_plain(
                pack.wide_occl, shadow.org, shadow.direction, t_max=shadow.t_max
            ),
        ),
    }
    kernels = []
    for name, (kernel, plain) in timing.items():
        ms, plain_ms = time_ms(kernel, 10), time_ms(plain, 1)
        log(f"[time] {name} on {WIDTH * HEIGHT} rays: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
        })

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
