"""P1: where the wide-BVH closest-hit time goes.

Port of ``tpu_kernel_probe.py``.  On the Cornell box's primary rays it times,
for leaf sizes {32, 64, 128} and ray tiles (block sizes) {256, 512, 1024}:

- ``grid``: an empty kernel over the same grid, ``x * 0`` per ray (the
  launch and grid cost; ``empty``);
- ``nodes``: K1's walk with its leaf tests removed (``node_walk``: the box
  tests, the stack, the pending leaves' re-culls and the warp's loop);
- ``leaves``: the leaf pair tests without the walk, every ray against every
  chunk of the tree (``leaves``, through ``vpu_leaf.rows_closest`` over the
  tree's anchored chunks and their anchors);
- ``full``: the shipped kernel, K1 (``intersect_closest_wide``), whose blocks
  are 128 threads whatever the ray tile, so it is timed once per leaf size.

    python -m heatray_tpu_torch.probes.kernel_probe [quick] [--device cuda|cpu] [--size W H]

prints each probe's ms and Mrays/s; ``quick`` runs leaf 32 and tile 256
only.  The reference's own ``leaves`` probe raises: it hands the fused
bf16 pack (C, 12, 3 Tc) to a pair test that contracts 4 rows, and on an f32
pack it would ignore the anchors.  Here the probe tests the anchored rows
with their anchors, so its t is the tree's closest hit.
"""

from __future__ import annotations

import torch

from ..ops import wide_bvh
from ..ops.intersect import MISS_T
from ..ops.wide_bvh import reciprocals, widened_slab
from ..vec import Vec3
from . import (
    check_ray_tile, cornell, device_label, device_of, elapsed_ms, kernels, launch, parser,
)
from .vpu_leaf import rows_closest

LEAF_SIZES = (32, 64, 128)
RAY_TILES = (256, 512, 1024)


def empty_plain(origins: Vec3) -> torch.Tensor:
    """The plain version of ``empty``."""
    return origins.x * 0.0


def empty(origins: Vec3, ray_tile: int = 256) -> torch.Tensor:
    """``origins.x * 0`` (R,): CPU tensors take the plain version; CUDA
    tensors launch ``empty_kernel`` (``csrc/probes.cu``), whose blocks are
    the card's, whatever ``ray_tile`` (the TPU probe's grid step, still
    checked)."""
    check_ray_tile(ray_tile)
    x = origins.x
    if wide_bvh.on_cpu(x):
        return empty_plain(origins)
    if x.dtype != torch.float32 or x.dim() != 1:
        raise ValueError("rays must be float32 (R,) tensors")
    x = x.contiguous()
    out = torch.empty_like(x)
    launch(kernels().probe_empty, x.device, x.data_ptr(), x.numel(), ray_tile, out.data_ptr())
    if x.numel():
        empty.launches += 1
    return out


def node_walk_plain(bvh, origins: Vec3, directions: Vec3, t_min: float = 1e-4,
                    chunk: int = 16384):
    """The plain version of ``node_walk``: a level-by-level frontier of the
    nodes each ray's widened slab enters (with no far end), counted per
    ray.  Returns (t = MISS_T, visits int32), (R,) each."""
    device = bvh.w.device
    codes = bvh.wchild.view(-1, wide_bvh.ARITY).long()
    filled = codes != -1
    r = origins.x.numel()
    visits = torch.zeros(r, dtype=torch.int32, device=device)
    far = torch.full((), MISS_T, device=device)
    for lo in range(0, r, chunk):
        o = [c[lo:lo + chunk][:, None, None] for c in (origins.x, origins.y, origins.z)]
        inv = [c[:, None, None] for c in reciprocals(directions.map(lambda c: c[lo:lo + chunk]))]
        level = torch.zeros(1, dtype=torch.long, device=device)
        reach = torch.ones((o[0].shape[0], 1), dtype=torch.bool, device=device)
        while level.numel():
            visits[lo:lo + chunk] += reach.sum(dim=1, dtype=torch.int32)
            b = bvh.wbox[level].permute(2, 0, 1)  # (8, L, 8): coordinate, node, child
            ok = widened_slab(b[0:3], b[3:6], o, inv, far, t_min)
            ok = ok & reach[:, :, None] & filled[level][None]
            inner = (codes[level] >= 0) & ok.any(dim=0)
            level, reach = codes[level][inner], ok[:, inner]
    return torch.full((r,), MISS_T, device=device), visits


def node_walk(bvh, origins: Vec3, directions: Vec3, ray_tile: int = 256, t_min: float = 1e-4):
    """K1's walk without its leaf tests: (t = MISS_T, node visits int32) per
    ray.

    CPU tensors take the plain version; CUDA tensors launch ``nodes_kernel``
    (``csrc/probes.cu``: K1's loop, ``closest_walk``, with a service that
    serves nothing), in K1's blocks of 128 whatever ``ray_tile`` (the TPU
    probe's grid step, still checked)."""
    check_ray_tile(ray_tile)
    if wide_bvh.on_cpu(bvh):
        return node_walk_plain(bvh, origins, directions, t_min)
    out = _launch_nodes(kernels(), bvh, origins, directions, ray_tile, t_min)
    if origins.x.numel():
        node_walk.launches += 1
    return out


def _launch_nodes(lib, bvh, origins: Vec3, directions: Vec3, ray_tile: int, t_min: float,
                  t=None):
    """``node_walk``'s launch through ``lib`` (a build of ``csrc/probes.cu``),
    counting nothing; ``t``, if given, is the t output the kernel writes
    (and a variant may read)."""
    tree = wide_bvh._tree_args(bvh, lib.probe_stack_depth())
    device = bvh.w.device
    comps, ptrs = wide_bvh._ray_ptrs(origins, directions, device)
    r = comps[0].shape[0]
    t = torch.empty((r,), dtype=torch.float32, device=device) if t is None else t
    visits = torch.empty((r,), dtype=torch.int32, device=device)
    launch(lib.probe_nodes, device, *ptrs, r, *tree[:3], ray_tile, float(t_min),
           wide_bvh.BOX_PAD, wide_bvh.FAR_SCALE, t.data_ptr(), visits.data_ptr())
    return t, visits


node_walk.launches = 0
empty.launches = 0


def leaves(bvh, origins: Vec3, directions: Vec3, ray_tile: int = 256, t_min: float = 1e-4):
    """Every ray against every leaf chunk of the tree, its anchored rows
    re-centred on its anchors: the closest t (``rows_closest``)."""
    return rows_closest(bvh.w, origins, directions, bvh.wanchor, ray_tile, t_min)


def run(accel, origins: Vec3, directions: Vec3, leaf_sizes=LEAF_SIZES, ray_tiles=RAY_TILES,
        reps: int = 8, log=print) -> list:
    """Time the probes at every leaf size and ray tile, and K1 once per leaf
    size.  Returns per leaf size a dict of its tree, and per probe and tile
    the ms and the last result (``ms[(probe, rt)]``, ``out[(probe, rt)]``;
    K1 under ``("full", None)``)."""
    device = origins.x.device
    r = origins.x.numel()
    out = []
    for ls in leaf_sizes:
        bvh = wide_bvh.build_wide_bvh(accel, leaf_size=ls)
        log(f"--- leaf={ls}: {bvh.num_nodes} wide nodes, {bvh.num_chunks} chunks")
        rec = {"leaf": ls, "bvh": bvh, "ms": {}, "out": {}}
        probes = {
            "grid": lambda rt: empty(origins, rt),
            "nodes": lambda rt: node_walk(bvh, origins, directions, rt),
            "leaves": lambda rt: leaves(bvh, origins, directions, rt),
        }
        for rt in ray_tiles:
            for probe, fn in probes.items():
                ms, res = elapsed_ms(lambda: fn(rt), reps, device)
                rec["ms"][probe, rt], rec["out"][probe, rt] = ms, res
                log(f"{probe:7s} leaf={ls} rt={rt}".ljust(44)
                    + f" {ms:9.2f} ms  ({r / ms / 1e3:8.1f} Mrays/s)")
        ms, res = elapsed_ms(lambda: wide_bvh.intersect_closest_wide(bvh, origins, directions),
                             reps, device)
        rec["ms"]["full", None], rec["out"]["full", None] = ms, res
        log(f"full    leaf={ls} (K1, blocks of 128)".ljust(44)
            + f" {ms:9.2f} ms  ({r / ms / 1e3:8.1f} Mrays/s)")
        out.append(rec)
    return out


def main(argv=None) -> int:
    from ..render import integrator

    p = parser("P1: where the wide-BVH closest-hit time goes")
    p.add_argument("quick", nargs="?", choices=("quick",), help="leaf 32, tile 256 only")
    args = p.parse_args(argv)
    device = device_of(args.device)
    width, height = args.size
    scene, camera, opts, ctx = cornell(width, height, 4, device)
    primary = integrator.start_paths(camera, ctx, opts, 0)
    print(f"cornell {width}x{height}; {device_label(device)}")
    quick = args.quick == "quick"
    run(ctx.accel_pack.accel, primary.org, primary.direction,
        LEAF_SIZES[:1] if quick else LEAF_SIZES, RAY_TILES[:1] if quick else RAY_TILES)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
