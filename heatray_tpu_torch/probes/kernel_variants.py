"""P2: variants of the block-wide walk on the sorted bounce wavefront.

Port of ``tpu_kernel_variants_probe.py``.  On the Cornell box's depth-2
wavefront, sorted by octant and Morton code (``wavefront``), it times
variants of a walk in which a block of ``ray_tile`` rays walks the leaf-32
``"wide"`` tree together (``csrc/variants.cu``), each giving per ray the
closest t and slot:

- ``variant_walk`` (the reference's ``make_kernel``): ``v0`` a branch per
  live leaf, the whole tile testing it; ``v1`` every child slot tested, the
  update masked; ``v2`` a shared-memory queue of the node's live leaves,
  then a drain; ``v3`` ``v0`` without slots (they stay -1); ``v4`` (also
  ``v5``) the test run only by the groups of ``group`` rays with a ray that
  entered the leaf;
- ``closest_v6``, ``closest_v7``, ``closest_v8`` (``make_kernel_v6``,
  ``_v7``, ``_v8``): a leaf queue across nodes, drained ``batch`` chunks at a
  time, over the unanchored rows re-centred on the tile's origin centroid
  (v6), the unanchored rows as they are (v7), or the tree's per-chunk
  anchored rows (v8).

Each case is compared with ``v0`` at the reference's rtol 1e-4 / atol 1e-5
(``match_t``, ``match_id``), and K1 (``intersect_closest_wide``) is timed on
the same rays.  Each kernel also counts, per tile, the ray-chunk tests it
ran: the work the variant chose.

All are exact float32 (the port's leaf math), with ties to the lowest slot,
so v0-v2, v4 and v8 compute K1's function (plain version
``closest_wide_plain``), v3 its t, and v6 and v7 a brute force over the
unanchored rows (``closest_rows_plain``): the reference's bf16 hi/lo pack of
v6 is not built.  Unlike the reference:

- batch comes from the case (``v8b16``, ``v6b4``; a bare ``v6``-``v8`` takes
  the reference's ``run_v*`` default of 4), where the reference's
  ``VARIANTS=`` hands the group of 128 to v6-v8 as their batch, over a queue
  of 64 entries;
- v6 re-centres the rows' translation on the tile's centroid as well as the
  origins (the reference re-centres the origins only, and so tests rays
  moved by minus the centroid);
- lanes past the last ray are absent (the reference pads with origin-0 rays).

    python -m heatray_tpu_torch.probes.kernel_variants [--variants v0,v1,v4g32,v6b8,...]
        [--device cuda|cpu] [--size W H]

runs ``v0`` at tile 512 and then either the reference's default cases (v8 at
batch 8 and 16 x tiles 512, 1024, 2048) or the named ones at tiles 512 and
1024, printing per case its ms, its agreement with ``v0`` and its leaf
tests per tile.
"""

from __future__ import annotations

import dataclasses
import re

import torch

from ..ops import wide_bvh
from ..ops.intersect import WoopAccel, chunk_rows, closest_rows
from ..ops.wide_bvh import WideBVH
from ..vec import Vec3
from . import cornell, device_label, device_of, elapsed_ms, launch, parser, variant_kernels

T_MIN = 1e-4
# The reference's agreement with v0 (tpu_kernel_variants_probe.py:810).
MATCH_RTOL, MATCH_ATOL = 1e-4, 1e-5
WALK_TILES = (256, 512, 1024)  # variant_walk: one ray per thread
QUEUE_TILES = (256, 512, 1024, 2048)  # queue kernels: 2,048 as 1,024 threads x 2 rays
GROUPS = (32, 64, 128)
MAX_BATCH = 16  # kMaxBatch: the queue of 64 entries always holds batch - 1 + 8
_WALK_CODES = {"v0": 0, "v1": 1, "v2": 2, "v3": 3, "v4": 4, "v5": 4}
_ANCHORS = {"v6": 0, "v7": 1, "v8": 2}  # tile, none, chunk
_WARP = 32


@dataclasses.dataclass(frozen=True)
class Case:
    """One probe case: a variant at a ray tile, with its group (v0-v5) or
    batch (v6-v8)."""

    variant: str
    ray_tile: int
    group: int = 128
    batch: int = 4

    @property
    def queued(self) -> bool:
        return self.variant in _ANCHORS

    @property
    def name(self) -> str:
        if self.queued:
            return f"{self.variant}b{self.batch}"
        return f"{self.variant}g{self.group}" if self.variant in ("v4", "v5") else self.variant


def parse_case(spec: str, ray_tile: int) -> Case:
    """``v0``-``v8``, with ``g<group>`` for v4/v5 or ``b<batch>`` for v6-v8
    (defaults: group 128, batch 4, the reference's)."""
    m = re.fullmatch(r"(v[0-8])(?:([gb])(\d+))?", spec)
    if not m or m.group(1) not in (*_WALK_CODES, *_ANCHORS):
        raise ValueError(f"unknown case {spec!r}")
    variant, kind, n = m.group(1), m.group(2), m.group(3)
    if kind and (kind == "b") != (variant in _ANCHORS):
        raise ValueError(f"{spec!r}: v6-v8 take a batch (b), v4/v5 a group (g)")
    if kind == "g" and variant not in ("v4", "v5"):
        raise ValueError(f"{spec!r}: only v4/v5 take a group")
    if kind == "b":
        return Case(variant, ray_tile, batch=int(n))
    return Case(variant, ray_tile, group=int(n) if kind else 128)


def default_cases() -> list:
    """``v0`` at tile 512, then the reference's defaults (:736-738)."""
    return [Case("v0", 512)] + [Case("v8", rt, batch=b) for b, rt in (
        (8, 512), (8, 1024), (16, 512), (16, 1024), (8, 2048), (16, 2048))]


def variant_cases(specs) -> list:
    """``v0`` at tile 512, then each named case at tiles 512 and 1024
    (:739-743)."""
    return [Case("v0", 512)] + [parse_case(s, rt) for s in specs for rt in (512, 1024)]


# --- inputs -------------------------------------------------------------------


def wavefront(scene, camera, ctx, opts):
    """The probe's rays: sample 2's primary rays, one bounce at depth 1
    (``integrator.bounce`` on the context's own structures) and the
    octant+Morton sort of every lane, dead lanes parked at the end
    (``integrator._sort_paths``).  Returns the sorted ``Paths``."""
    from ..options import FrameGlobals
    from ..render import integrator

    frame = FrameGlobals.create(2, device=ctx.device)
    paths = integrator.start_paths(camera, ctx, opts, 2)
    paths, _ = integrator.bounce(scene, ctx, opts, frame, 1, paths, ctx.accel_pack)
    return integrator._sort_paths(paths, *integrator._sort_bounds(ctx.accel_pack))


def unanchored_rows(accel: WoopAccel, bvh: WideBVH) -> torch.Tensor:
    """The (C, 4, 3 Tc) leaf operand of v6 and v7: the Woop rows of
    ``accel`` gathered in the tree's slot order, zero on empty slots, with
    no anchor folded in (``tpu_kernel_variants_probe.py:646-652``, in
    float32)."""
    slot = bvh.slot_tri.long()
    w = torch.where(slot >= 0, accel.w[:, slot.clamp(min=0)], 0.0)
    c, tc = bvh.num_chunks, bvh.leaf_size
    w = w.reshape(12, c, tc).permute(1, 0, 2)
    return w.reshape(c, 3, 4, tc).permute(0, 2, 1, 3).reshape(c, 4, 3 * tc).contiguous()


def tile_sums(c: torch.Tensor, ray_tile: int) -> torch.Tensor:
    """(tiles,) sums of ``c`` over each tile of ``ray_tile`` lanes in the
    kernels' float32 order (``tile_sums`` of ``csrc/variants.cu``): a
    butterfly within each warp of 32 lanes, then the warps in order; absent
    lanes add 0."""
    n = c.shape[0]
    tiles = -(-n // ray_tile)
    v = torch.nn.functional.pad(c, (0, tiles * ray_tile - n)).view(tiles, -1, _WARP)
    lane = torch.arange(_WARP, device=c.device)
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., lane ^ o]
    total = torch.zeros((tiles,), dtype=c.dtype, device=c.device)
    for k in range(v.shape[1]):
        total = total + v[:, k, 0]
    return total


def tile_centroids(origins: Vec3, ray_tile: int) -> torch.Tensor:
    """(tiles, 3): v6's anchor, each tile's origin centroid over its rays."""
    n = origins.x.shape[0]
    tiles = -(-n // ray_tile)
    count = torch.full((tiles,), ray_tile, dtype=torch.float32, device=origins.x.device)
    count[-1] = n - (tiles - 1) * ray_tile
    return torch.stack([tile_sums(c, ray_tile) / count
                        for c in (origins.x, origins.y, origins.z)], dim=1)


# --- plain versions -------------------------------------------------------------


def closest_rows_plain(rows: torch.Tensor, origins: Vec3, directions: Vec3, anchor=None,
                       ray_tile: int = 512, t_min: float = T_MIN):
    """The plain version of v6 (``anchor="tile"``) and v7 (``None``): the
    closest hit (t, slot) of each ray over every column of the unanchored
    chunks ``rows`` (C, 4, 3 Tc).  With ``"tile"``, each tile of
    ``ray_tile`` rays is re-centred on its origin centroid as the kernel
    does: the origins minus it, and each row's translation replaced by the
    row's affine at it, in float32."""
    rows12 = chunk_rows(rows)
    if anchor is None:
        return closest_rows(origins, directions, rows12, t_min)[:2]
    if anchor != "tile":
        raise ValueError(f"anchor must be 'tile' or None, not {anchor!r}")
    ts, slots = [], []
    for k, a in enumerate(tile_centroids(origins, ray_tile)):
        fixed = rows12.clone()
        for g in range(3):
            fixed[4 * g + 3] = (a[0] * rows12[4 * g] + a[1] * rows12[4 * g + 1]
                                + a[2] * rows12[4 * g + 2] + rows12[4 * g + 3])
        sl = slice(k * ray_tile, (k + 1) * ray_tile)
        t, slot, _ = closest_rows(origins.map(lambda c: c[sl]), directions.map(lambda c: c[sl]),
                                  fixed, t_min, a[:, None].expand(3, rows12.shape[1]))
        ts.append(t)
        slots.append(slot)
    return torch.cat(ts), torch.cat(slots)


def case_plain(case: Case, bvh: WideBVH, rows, origins: Vec3, directions: Vec3,
               t_min: float = T_MIN):
    """The plain version of a case: (t, slot) per ray."""
    if case.variant in ("v6", "v7"):
        return closest_rows_plain(rows, origins, directions,
                                  "tile" if case.variant == "v6" else None, case.ray_tile, t_min)
    t, slot, _ = wide_bvh.closest_wide_plain(bvh, origins, directions, t_min)
    return t, torch.full_like(slot, -1) if case.variant == "v3" else slot


# --- kernel wrappers --------------------------------------------------------------


def _launch(entry, code, w, bvh: WideBVH, origins: Vec3, directions: Vec3, ray_tile, param,
            t_min, lib=None):
    """Launch ``variant_walk`` or ``queue_walk`` of ``csrc/variants.cu``
    (or of ``lib``, another build of it) over the tree ``bvh`` with leaf
    rows ``w``: (t, slot, ray-chunk tests per tile) on the tree's device."""
    lib = lib or variant_kernels()
    tree = wide_bvh._tree_args(bvh, lib.variants_stack_depth())
    device = bvh.w.device
    if (w.dtype != torch.float32 or not w.is_contiguous() or w.shape != bvh.w.shape
            or w.device != device):
        raise ValueError(f"leaf rows must be a contiguous float32 {tuple(bvh.w.shape)} tensor "
                         f"on the tree's device")
    tree[3] = w.data_ptr()
    comps, ptrs = wide_bvh._ray_ptrs(origins, directions, device)
    r = comps[0].shape[0]
    t = torch.empty((r,), dtype=torch.float32, device=device)
    slot = torch.empty((r,), dtype=torch.int32, device=device)
    tests = torch.empty((-(-r // ray_tile),), dtype=torch.int32, device=device)
    launch(getattr(lib, entry), device, *ptrs, r, *tree, code, ray_tile, param, float(t_min),
           wide_bvh.BOX_PAD, wide_bvh.FAR_SCALE, t.data_ptr(), slot.data_ptr(), tests.data_ptr())
    return t, slot, tests


def variant_walk(bvh: WideBVH, origins: Vec3, directions: Vec3, variant: str = "v0",
                 ray_tile: int = 512, group: int = 128, t_min: float = T_MIN):
    """The tile-wide walk's variants v0-v5 (see the module docstring):
    (t, slot, ray-chunk tests per tile).

    CPU tensors take the plain version (no tests: None); CUDA tensors launch
    ``variant_walk_kernel`` (``csrc/variants.cu``, each node's tested chunks
    staged in shared memory) in blocks of ``ray_tile`` (256, 512 or 1024)
    rays, ``group`` (32, 64 or 128, dividing the tile) for v4/v5."""
    if variant not in _WALK_CODES:
        raise ValueError(f"variant must be one of {tuple(_WALK_CODES)}, not {variant!r}")
    if ray_tile not in WALK_TILES or group not in GROUPS or ray_tile % group:
        raise ValueError(f"ray_tile must be one of {WALK_TILES} and group one of {GROUPS} "
                         f"dividing it, not {ray_tile}, {group}")
    if wide_bvh.on_cpu(bvh):
        t, slot = case_plain(Case(variant, ray_tile, group), bvh, None, origins, directions,
                             t_min)
        return t, slot, None
    out = _launch("variant_walk", _WALK_CODES[variant], bvh.w, bvh, origins, directions,
                  ray_tile, group, t_min)
    if origins.x.numel():
        variant_walk.launches += 1
    return out


def _queue_walk(wrapper, variant, bvh, rows, origins, directions, ray_tile, batch, t_min):
    """The queue kernel with the anchor of ``variant``, counted on
    ``wrapper``, or on the CPU its plain version."""
    if ray_tile not in QUEUE_TILES or not 1 <= batch <= MAX_BATCH:
        raise ValueError(f"ray_tile must be one of {QUEUE_TILES} and batch in [1, {MAX_BATCH}], "
                         f"not {ray_tile}, {batch}")
    if wide_bvh.on_cpu(bvh):
        t, slot = case_plain(Case(variant, ray_tile, batch=batch), bvh, rows, origins,
                             directions, t_min)
        return t, slot, None
    out = _launch("queue_walk", _ANCHORS[variant], bvh.w if rows is None else rows, bvh,
                  origins, directions, ray_tile, batch, t_min)
    if origins.x.numel():
        wrapper.launches += 1
    return out


def closest_v6(bvh: WideBVH, rows: torch.Tensor, origins: Vec3, directions: Vec3,
               ray_tile: int = 512, batch: int = 4, t_min: float = T_MIN):
    """v6: the leaf queue drained ``batch`` chunks at a time over the
    unanchored rows ``rows`` (``unanchored_rows``), each tile re-centred on
    its origin centroid: (t, slot, ray-chunk tests per tile).

    CPU tensors take the plain version (``closest_rows_plain(..., "tile")``);
    CUDA tensors launch ``queue_walk_kernel<Anchor::kTile>``."""
    return _queue_walk(closest_v6, "v6", bvh, rows, origins, directions, ray_tile, batch, t_min)


def closest_v7(bvh: WideBVH, rows: torch.Tensor, origins: Vec3, directions: Vec3,
               ray_tile: int = 512, batch: int = 4, t_min: float = T_MIN):
    """v7: as v6 with no anchor (absolute coordinates); CUDA tensors launch
    ``queue_walk_kernel<Anchor::kNone>``."""
    return _queue_walk(closest_v7, "v7", bvh, rows, origins, directions, ray_tile, batch, t_min)


def closest_v8(bvh: WideBVH, origins: Vec3, directions: Vec3, ray_tile: int = 512,
               batch: int = 4, t_min: float = T_MIN):
    """v8: the leaf queue drained ``batch`` chunks at a time over the tree's
    anchored rows, each chunk re-centred on its own anchor; CUDA tensors
    launch ``queue_walk_kernel<Anchor::kChunk>``, CPU tensors take K1's
    plain version."""
    return _queue_walk(closest_v8, "v8", bvh, None, origins, directions, ray_tile, batch, t_min)


variant_walk.launches = 0
closest_v6.launches = 0
closest_v7.launches = 0
closest_v8.launches = 0


def call(case: Case, bvh: WideBVH, rows, origins: Vec3, directions: Vec3):
    """The case's kernel (or, on the CPU, its plain version)."""
    if case.variant == "v6":
        return closest_v6(bvh, rows, origins, directions, case.ray_tile, case.batch)
    if case.variant == "v7":
        return closest_v7(bvh, rows, origins, directions, case.ray_tile, case.batch)
    if case.variant == "v8":
        return closest_v8(bvh, origins, directions, case.ray_tile, case.batch)
    return variant_walk(bvh, origins, directions, case.variant, case.ray_tile, case.group)


# --- the probe ----------------------------------------------------------------------


def agreement(t, slot, t0, slot0):
    """The reference's ``match_t`` and ``match_id`` of (t, slot) against v0's."""
    near = torch.isclose(t, t0, rtol=MATCH_RTOL, atol=MATCH_ATOL)
    return float(near.float().mean()), float((slot == slot0).float().mean())


def run(bvh: WideBVH, rows, origins: Vec3, directions: Vec3, cases=None, reps: int = 5,
        log=print) -> dict:
    """Time every case (the first must be ``v0``, the agreement reference)
    and K1 on the same rays.  Returns ``{"cases": [...], "k1": {...}}``: per
    case a dict of the ``Case``, its name, ms, t, slot, tests per tile (None
    on the CPU), match_t and match_id; K1's ms, t and slot."""
    cases = default_cases() if cases is None else list(cases)
    if not cases or cases[0].variant != "v0":
        raise ValueError("the first case must be v0, the agreement reference")
    device = origins.x.device
    r = origins.x.numel()
    out = []
    for case in cases:
        ms, (t, slot, tests) = elapsed_ms(lambda: call(case, bvh, rows, origins, directions),
                                          reps, device)
        rec = {"case": case, "name": case.name, "ms": ms, "t": t, "slot": slot, "tests": tests}
        ref = out[0] if out else rec
        rec["match_t"], rec["match_id"] = agreement(t, slot, ref["t"], ref["slot"])
        param = f"b={case.batch}" if case.queued else f"g={case.group}"
        if tests is None:
            work = "leaf tests n/a (plain version)"
        else:
            rec["tests_per_tile"] = float(tests.double().mean()) / case.ray_tile
            work = (f"leaf tests/tile {rec['tests_per_tile']:.2f} "
                    f"({float(tests.double().sum()) / max(r, 1):.3f} per ray)")
        log(f"{case.name:6s} rt={case.ray_tile:4d} {param:5s}: {ms:9.4f} ms "
            f"match_t={rec['match_t']:.4f} match_id={rec['match_id']:.4f}  {work}")
        out.append(rec)
    ms, (t, slot, _) = elapsed_ms(lambda: wide_bvh.intersect_closest_wide(bvh, origins,
                                                                          directions),
                                  reps, device)
    k1 = {"ms": ms, "t": t, "slot": slot}
    k1["match_t"], k1["match_id"] = agreement(t, slot, out[0]["t"], out[0]["slot"])
    log(f"K1 closest_wide (a walk per ray, blocks of 128): {ms:9.4f} ms "
        f"match_t={k1['match_t']:.4f} match_id={k1['match_id']:.4f}")
    return {"cases": out, "k1": k1}


def main(argv=None) -> int:
    p = parser("P2: variants of the block-wide walk on the sorted depth-2 wavefront")
    p.add_argument("--variants", help="comma-separated cases at tiles 512 and 1024 (v0-v8, "
                   "v4g32, v6b8, ...) in place of the default v8 cases")
    args = p.parse_args(argv)
    device = device_of(args.device)
    width, height = args.size
    scene, camera, opts, ctx = cornell(width, height, 4, device)
    paths = wavefront(scene, camera, ctx, opts)
    bvh = ctx.accel_pack.wide
    rows = unanchored_rows(ctx.accel_pack.accel, bvh)
    cases = variant_cases(args.variants.split(",")) if args.variants else default_cases()
    print(f"cornell {width}x{height}, sorted depth-2 wavefront: {paths.active.numel()} lanes, "
          f"{int(paths.active.sum())} live; {bvh.num_chunks} leaves of {bvh.leaf_size}; "
          f"{device_label(device)}")
    run(bvh, rows, paths.org, paths.direction, cases)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
