"""P4: the brute-force leaf pair test in the row layout against the
warp-transposed one.

Port of ``tpu_vpu_leaf.py``.  Every ray is tested against every triangle of
the Cornell box, packed into leaf chunks of ``tc`` triangles without anchors
(``pack_chunks``), two ways:

- ``rows_closest``: each thread holds four rays and tests them against
  every column of every chunk, the columns staged through shared memory
  128 at a time (the TPU's ``_mxu_kernel``, a K=4 contraction per chunk on
  its matrix unit).  On this card the pair test is exact float32 and needs
  no precision schedule, so the reference's "MXU HIGHEST" and "MXU
  bf16x3" rows are this one kernel;
- ``warp_closest``: the columns across the lanes of a warp, lane j holding
  columns j, j + 32, j + 64, j + 96 of a 128-column slice of a chunk in
  registers, and the block's rays, staged in shared memory, broadcast to
  them one at a time, each ray's minimum over the warp's columns taken by
  one warp reduction (the TPU's ``_vpu_kernel``, rays on sublanes and
  triangles on lanes).

Both return the closest t of each ray (``MISS_T`` on a miss); the plain
version of both is the brute force ``closest_rows`` over the same rows.

    python -m heatray_tpu_torch.probes.vpu_leaf [--device cuda|cpu] [--size W H]

runs tc in {128, 256, 512} and ray tiles (block sizes) in {256, 512} on the
primary rays and prints each kernel's ms and Gpairs/s (pairs = rays x
chunks x tc, padding included, as the reference counts them) and the two
layouts' agreement.
"""

from __future__ import annotations

import torch

from ..ops.intersect import MISS_T, WoopAccel, chunk_rows, closest_rows
from ..ops.wide_bvh import _ray_ptrs, on_cpu
from ..vec import Vec3
from . import check_ray_tile, cornell, device_label, device_of, elapsed_ms, kernels, launch, parser

LEAF_SIZES = (128, 256, 512)
RAY_TILES = (256, 512)


def pack_chunks(accel: WoopAccel, tc: int) -> torch.Tensor:
    """(12, T) Woop rows -> (C, 4, 3 tc) chunks in triangle order, padded
    with zero columns, without anchors (``tpu_vpu_leaf.py:72``)."""
    t = accel.w.shape[1]
    c = -(-t // tc)
    w = torch.nn.functional.pad(accel.w, (0, c * tc - t))
    w = w.reshape(12, c, tc).permute(1, 0, 2)
    return w.reshape(c, 3, 4, tc).permute(0, 2, 1, 3).reshape(c, 4, 3 * tc).contiguous()


def closest_brute_plain(w: torch.Tensor, origins: Vec3, directions: Vec3, wanchor=None,
                        t_min: float = 1e-4) -> torch.Tensor:
    """The plain version of both brute-force kernels: closest t over every
    column of the chunks ``w`` (C, 4, 3 tc), each re-centred on its anchor
    ``wanchor`` (3, C) if given."""
    anchor = None if wanchor is None else wanchor.repeat_interleave(w.shape[2] // 3, dim=1)
    return closest_rows(origins, directions, chunk_rows(w), t_min, anchor)[0]


def _brute(fn, w, origins, directions, wanchor, ray_tile, t_min):
    check_ray_tile(ray_tile)
    device = w.device
    if w.dtype != torch.float32 or w.dim() != 3 or w.shape[1] != 4 or w.shape[2] % 3:
        raise ValueError("w must be float32 (C, 4, 3 tc) leaf chunks")
    w = w.contiguous()
    n_chunks, tc = w.shape[0], w.shape[2] // 3
    if wanchor is None:
        wanchor = torch.zeros((3, n_chunks), dtype=torch.float32, device=device)
    if wanchor.dtype != torch.float32 or tuple(wanchor.shape) != (3, n_chunks):
        raise ValueError(f"wanchor must be a float32 (3, {n_chunks}) tensor")
    wanchor = wanchor.to(device).contiguous()
    comps, ptrs = _ray_ptrs(origins, directions, device)
    r = comps[0].shape[0]
    t = torch.empty((r,), dtype=torch.float32, device=device)
    launch(fn, device, *ptrs, r, w.data_ptr(), wanchor.data_ptr(), n_chunks, tc, ray_tile,
           float(t_min), t.data_ptr())
    return t


def rows_closest(w: torch.Tensor, origins: Vec3, directions: Vec3, wanchor=None,
                 ray_tile: int = 256, t_min: float = 1e-4) -> torch.Tensor:
    """Closest t of each ray over every column of the chunks ``w`` (C, 4,
    3 tc), each re-centred on its anchor ``wanchor`` (3, C) if given: the
    row layout, four rays a thread.

    CPU tensors take the plain version; CUDA tensors launch
    ``rows_brute_kernel`` (``csrc/probes.cu``) in blocks of ``ray_tile``
    rays."""
    if on_cpu(w):
        check_ray_tile(ray_tile)
        return closest_brute_plain(w, origins, directions, wanchor, t_min)
    t = _brute(kernels().probe_rows, w, origins, directions, wanchor, ray_tile, t_min)
    if t.numel():
        rows_closest.launches += 1
    return t


def warp_closest(w: torch.Tensor, origins: Vec3, directions: Vec3, wanchor=None,
                 ray_tile: int = 256, t_min: float = 1e-4) -> torch.Tensor:
    """As ``rows_closest``, in the warp-transposed layout: CUDA tensors
    launch ``warp_brute_kernel``, ``ray_tile`` rays a block of 128
    threads."""
    if on_cpu(w):
        check_ray_tile(ray_tile)
        return closest_brute_plain(w, origins, directions, wanchor, t_min)
    t = _brute(kernels().probe_warp, w, origins, directions, wanchor, ray_tile, t_min)
    if t.numel():
        warp_closest.launches += 1
    return t


rows_closest.launches = 0
warp_closest.launches = 0


def agreement(a: torch.Tensor, b: torch.Tensor):
    """(share of rays whose hit/miss agrees, max |dt| where both hit)."""
    ha, hb = a < MISS_T, b < MISS_T
    both = ha & hb
    err = float((a[both] - b[both]).abs().max()) if bool(both.any()) else 0.0
    return float((ha == hb).float().mean()), err


def run(accel: WoopAccel, origins: Vec3, directions: Vec3, leaf_sizes=LEAF_SIZES,
        ray_tiles=RAY_TILES, reps: int = 8, log=print) -> list:
    """Time both layouts at every leaf size and ray tile.  Returns per
    (tc, rt) a dict of the chunk pack, both kernels' ms and t, and their
    agreement."""
    device = origins.x.device
    r = origins.x.numel()
    log(f"tris={accel.num_triangles}, rays={r}; the row layout is one exact float32 kernel: "
        f"it stands for the reference's 'MXU HIGHEST' and 'MXU bf16x3' rows alike")
    out = []
    for tc in leaf_sizes:
        w = pack_chunks(accel, tc)
        pairs = r * w.shape[0] * tc
        for rt in ray_tiles:
            base = f"tc={tc} rt={rt}"
            rec = {"tc": tc, "rt": rt, "w": w, "pairs": pairs}
            for name, fn, label in (("row", rows_closest, "row layout "),
                                    ("warp", warp_closest, "warp transp")):
                ms, t = elapsed_ms(lambda: fn(w, origins, directions, ray_tile=rt), reps, device)
                rec[f"{name}_ms"], rec[f"{name}_t"] = ms, t
                log(f"{label} {base}".ljust(36) + f" {ms:9.2f} ms  ({pairs / ms / 1e6:7.2f} "
                    f"Gpairs/s)")
            rec["agree"], rec["max_dt"] = agreement(rec["row_t"], rec["warp_t"])
            log(f"   warp vs row: hit agree {rec['agree']:.6f}, max |dt| {rec['max_dt']:.2e}")
            out.append(rec)
    return out


def main(argv=None) -> int:
    from ..render import integrator

    args = parser("P4: the leaf pair test, row layout against warp-transposed").parse_args(argv)
    device = device_of(args.device)
    width, height = args.size
    scene, camera, opts, ctx = cornell(width, height, 4, device)
    primary = integrator.start_paths(camera, ctx, opts, 0)
    print(f"cornell {width}x{height}; {device_label(device)}")
    run(ctx.accel_pack.accel, primary.org, primary.direction)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
