"""P3: traversal visit statistics per 256-ray block, on real bounce wavefronts.

Port of ``tpu_visit_stats.py``.  For each tile of 256 rays, K3's block walk
(a child is visited if any ray of the block enters its widened box before
that ray's best hit as it stood at node entry) is run with every ray of the
block tested at each opened leaf, as the TPU kernel tests them (the plain
version; the kernel tests only the rays whose own slab entered the leaf,
which cannot change a count: ROADMAP F5), and counts:

- ``nodes``: node visits;
- ``leaves``: leaf visits;
- ``overlap``: the sum over opened leaves of the share of the tile's 256
  rays whose own slab, at node entry, entered that leaf;
- ``improving``: leaf visits that lowered some ray's best t.

``overlap / leaves`` is the mean share of a block's rays that need each leaf
it opens: how much leaf work is one stray ray dragging 255 others through a
chunk.  The optional horizon seed (``seed_chunk``: the 32 largest triangles)
is tested before the walk.

The wavefronts are the port's own: primary rays, then the extension rays of
``integrator.bounce``, unsorted and ungated (parked dead lanes included), as
the reference's are.

    python -m heatray_tpu_torch.probes.visit_stats [--scene cornell|high-poly]
        [--depth 4] [--device cuda|cpu] [--size W H]

prints, per depth, plain and seeded, the reference's line (means and 95th
percentiles of node and leaf visits per tile, the overlap share, the share
of improving leaf visits), with the most visits of any tile and the
kernel's ms: the Cornell box over its
leaf-32 ``"wide"`` tree, or ``high_poly`` over its leaf-128 ``"stream"``
tree, the one K3 and K4 walk.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import wide_bvh
from ..ops.intersect import MISS_T, chunk_rows, pair_t
from ..ops.wide_bvh import reciprocals, widened_slab
from ..vec import Vec3
from . import cornell, device_label, device_of, elapsed_ms, kernels, launch, options, parser

TILE = 256  # rays per block: K3's tile, the reference's ray_tile
SEED_K = 32
_WARP = 32
# The work the four counts need, per tile (``visit_stats(work=True)``):
# child-box tests (the filled children of each visited node, times the
# tile's rays), pair tests (the filled triangles of each opened leaf, times
# the rays whose slab entered it at node entry), and of those pairs the ones
# whose t lies in (t_min, the ray's best t at the leaf), which then need
# their barycentrics.
WORK = ("box_tests", "pair_tests", "pairs_in_range")


def seed_chunk(scene, accel, k: int = SEED_K):
    """The horizon seed of ``tpu_visit_stats.py`` (:202-228), built in numpy:
    the ``k`` largest-area triangles of ``scene`` as one chunk (4, 3k) of
    ``accel``'s Woop rows, anchored at the centre of their joint box (the
    translation folded in float64), and that anchor (3,).  Returns (seed_w,
    seed_anchor, their share of the scene's area), on ``accel``'s device."""
    pos = scene.geometry.positions.cpu().numpy()  # (3, V)
    idx = scene.geometry.indices.cpu().numpy()  # (3, T)
    p0, p1, p2 = pos[:, idx[0]], pos[:, idx[1]], pos[:, idx[2]]
    area = 0.5 * np.linalg.norm(np.cross((p1 - p0).T, (p2 - p0).T), axis=1)
    top = np.argsort(-area)[:k]
    w = accel.w.cpu().numpy().astype(np.float64)[:, top]  # (12, k)
    tmn = accel.tri_min.cpu().numpy()[:, top]
    tmx = accel.tri_max.cpu().numpy()[:, top]
    anchor = 0.5 * (tmn.min(axis=1) + tmx.max(axis=1))  # (3,)
    for g in range(3):
        w[4 * g + 3] += anchor[0] * w[4 * g] + anchor[1] * w[4 * g + 1] + anchor[2] * w[4 * g + 2]
    seed_w = w.astype(np.float32).reshape(3, 4, k).transpose(1, 0, 2).reshape(4, 3 * k)
    device = accel.w.device
    return (torch.from_numpy(np.ascontiguousarray(seed_w)).to(device),
            torch.from_numpy(anchor.astype(np.float32)).to(device),
            float(area[top].sum() / area.sum()))


def group_signs(directions: Vec3) -> list:
    """Per axis, does a group of rays travel predominantly +axis?  The block
    walk's own sum (``block_signs``, ``csrc/wide_bvh_block.cuh``): a
    butterfly sum within each warp of 32, then the warps' sums in order, in
    float32."""
    out = []
    for c in (directions.x, directions.y, directions.z):
        n = c.shape[0]
        v = torch.nn.functional.pad(c, (0, -n % _WARP)).view(-1, _WARP)
        lane = torch.arange(_WARP, device=c.device)
        for o in (16, 8, 4, 2, 1):
            v = v + v[:, lane ^ o]
        total = torch.zeros((), dtype=c.dtype, device=c.device)
        for s in v[:, 0]:
            total = total + s
        out.append(bool(total >= 0.0))
    return out


def _t_in_range(org: Vec3, d: Vec3, rows, anchor, t_min, t_max):
    """(R, S): does t of each ray against each Woop row lie in (t_min,
    t_max)?  ``pair_t``'s t before its barycentric test."""
    ox, oy, oz = (c[:, None] - a for c, a in zip((org.x, org.y, org.z), anchor))
    dx, dy, dz = d.x[:, None], d.y[:, None], d.z[:, None]
    t = -(ox * rows[8] + oy * rows[9] + oz * rows[10] + rows[11]) / (
        dx * rows[8] + dy * rows[9] + dz * rows[10])
    return (t > t_min) & (t < t_max[:, None])


def group_walk(bvh, org: Vec3, d: Vec3, group: int, t_max=None, t_min: float = 1e-4,
               every_ray: bool = False, seed=None):
    """Plain-torch emulation of the group walks of the TPU's kernels and P3.
    Per group of ``group`` rays (a warp of 32, or P3's block of 256): one
    shared stack; a child is visited if any ray of the group enters its
    widened box before that ray's far end (its best t, or its t_max
    until it is blocked) as it stood at node entry; leaves near to far by
    the group's summed direction along the node's axis (``group_signs``),
    internal children pushed far to near.  At each visited leaf, every ray
    of the group is tested (``every_ray``: P3) or only the rays whose own
    slab still enters it against their best t by then; ties in
    t go to the lowest slot.  ``seed`` (a chunk (4, 3k) and its anchor
    (3,)) is tested by every ray before the walk (closest hit only; a ray's
    slot then stays -1 where the seed gave its t).

    Returns ((t, slot), or the blocked mask, and a (groups, 8) float64
    tensor per group: node visits, leaf visits, the sum over visited leaves
    of the share of the group's ``group`` rays whose slab entered the leaf
    at node entry, leaf visits that lowered some ray's t (or blocked some
    ray), the (ray, leaf) pairs that a visited leaf skipped; and the work
    ``WORK`` names."""
    rows, anchor = wide_bvh.slot_rows(bvh)
    codes = bvh.wchild.view(-1, wide_bvh.ARITY)
    code_list, axes = codes.tolist(), bvh.waxis.tolist()
    filled = codes != -1
    tc, big = bvh.leaf_size, MISS_T
    fill = (bvh.slot_tri.view(-1, tc) >= 0).sum(dim=1).tolist()
    closest = t_max is None
    if seed is not None:
        if not closest:
            raise ValueError("a seed chunk needs a closest-hit walk")
        seed_rows, seed_anchor = chunk_rows(seed[0][None]), seed[1][:, None]
    outs, stats = [], []
    for lo in range(0, org.x.shape[0], group):
        ob, db = org.map(lambda c: c[lo:lo + group]), d.map(lambda c: c[lo:lo + group])
        n = ob.x.shape[0]
        o3, rcp = (ob.x, ob.y, ob.z), reciprocals(db)
        low_first = group_signs(db)
        best = torch.full((n,), big, device=ob.x.device)
        slot = torch.full((n,), -1, dtype=torch.int32, device=ob.x.device)
        if seed is not None:
            t = pair_t(ob, db, seed_rows, t_min, big, seed_anchor.expand(3, seed_rows.shape[1]))
            best = torch.minimum(best, t.min(dim=1).values)
        hi = None if closest else torch.as_tensor(t_max, dtype=torch.float32)[lo:lo + group]
        blocked = torch.zeros((n,), dtype=torch.bool, device=ob.x.device)

        def far_end():
            return best if closest else torch.where(blocked, t_min - 1.0, hi)

        def enters(boxes):  # (K, 8) boxes -> (K, n)
            b = boxes.T[:, :, None]
            return widened_slab(b[0:3], b[3:6], o3, rcp, far_end(), t_min)

        nodes = leaves = skipped = box_tests = pairs = 0
        in_range = []
        shares, gains = [], []
        stack, node = [], 0
        while node >= 0 and (closest or not bool(blocked.all())):
            nodes += 1
            box_tests += int(filled[node].sum()) * n
            enter = enters(bvh.wbox[node]) & filled[node][:, None]
            live = enter.any(dim=1).tolist()
            order = (range(wide_bvh.ARITY) if low_first[axes[node]]
                     else range(wide_bvh.ARITY - 1, -1, -1))
            for k in order:
                code = code_list[node][k]
                if not live[k] or code > -2:
                    continue
                leaves += 1
                shares.append(enter[k].sum())
                pairs += int(enter[k].sum()) * fill[-2 - code]
                rays = (torch.arange(n, device=ob.x.device) if every_ray
                        else enters(bvh.wbox[node, k:k + 1])[0].nonzero()[:, 0])
                skipped += n - rays.numel()
                cols = slice((-2 - code) * tc, (-1 - code) * tc)
                near = enter[k].nonzero()[:, 0]
                in_range.append(_t_in_range(
                    ob.map(lambda c: c[near]), db.map(lambda c: c[near]), rows[:, cols],
                    anchor[:, cols], t_min, far_end()[near]).sum())
                sub = (ob.map(lambda c: c[rays]), db.map(lambda c: c[rays]))
                if closest:
                    t = pair_t(*sub, rows[:, cols], t_min, big, anchor[:, cols])
                    cand, arg = torch.min(t, dim=1)
                    cand_slot = (arg + cols.start).int()
                    b, s = best[rays], slot[rays]
                    better = (cand < b) | ((cand == b) & (cand < big) & (cand_slot < s))
                    gains.append((cand < b).any())
                    best[rays] = torch.where(better, cand, b)
                    slot[rays] = torch.where(better, cand_slot, s)
                else:
                    t = pair_t(*sub, rows[:, cols], t_min, hi[rays], anchor[:, cols])
                    now = (t < big).any(dim=1)
                    gains.append((now & ~blocked[rays]).any())
                    blocked[rays] |= now
            stack += [code_list[node][k] for k in reversed(order)
                      if live[k] and code_list[node][k] >= 0]
            node = stack.pop() if stack else -1
        share = float(torch.stack(shares).sum()) / group if shares else 0.0
        gain = float(torch.stack(gains).sum()) if gains else 0.0
        in_range = int(torch.stack(in_range).sum()) if in_range else 0
        stats.append((nodes, leaves, share, gain, skipped, box_tests, pairs, in_range))
        outs.append((best, slot) if closest else blocked)
    stats = torch.tensor(stats, dtype=torch.float64)
    if closest:
        return (torch.cat([a for a, _ in outs]), torch.cat([b for _, b in outs])), stats
    return torch.cat(outs), stats


def visit_stats_plain(tree, origins: Vec3, directions: Vec3, seed_w=None, seed_anchor=None,
                      ray_tile: int = TILE, seed_k: int = 0, t_min: float = 1e-4,
                      work: bool = False):
    """The plain version of ``visit_stats``: ``group_walk`` tile by tile,
    every ray tested at each opened leaf."""
    seed = (seed_w, seed_anchor) if seed_k else None
    _, stats = group_walk(tree, origins, directions, ray_tile, t_min=t_min, every_ray=True,
                          seed=seed)
    stats = stats.to(origins.x.device)
    counts = tuple(stats[:, i].float() for i in range(4))
    return counts + (stats[:, 5:8].long(),) if work else counts


def visit_stats(tree, origins: Vec3, directions: Vec3, seed_w=None, seed_anchor=None,
                ray_tile: int = TILE, seed_k: int = 0, t_min: float = 1e-4,
                work: bool = False):
    """Per tile of ``ray_tile`` rays: (nodes, leaves, overlap, improving),
    (tiles,) float32 each (see the module docstring).  ``seed_k`` > 0 tests
    the seed chunk ``seed_w`` (4, 3 seed_k), anchored at ``seed_anchor``
    (3,), first.  ``work`` adds a fifth, (tiles, 3) int64: the ``WORK``
    those counts need.

    CPU tensors take the plain version; CUDA tensors launch
    ``visit_stats_kernel`` (``csrc/probes.cu``), whose tile is 256 rays and
    which serves each opened leaf only to the rays that entered it (the
    rule ``group_walk(every_ray=False)`` models; the counts do not change)."""
    if seed_k and (seed_w is None or tuple(seed_w.shape) != (4, 3 * seed_k)):
        raise ValueError(f"seed_w must be a (4, {3 * seed_k}) chunk")
    if wide_bvh.on_cpu(tree):
        return visit_stats_plain(tree, origins, directions, seed_w, seed_anchor, ray_tile,
                                 seed_k, t_min, work)
    out = _launch(kernels(), tree, origins, directions, seed_w, seed_anchor, ray_tile, seed_k,
                  t_min, work)
    if origins.x.numel():
        visit_stats.launches += 1
    return out


def _launch(lib, tree, origins: Vec3, directions: Vec3, seed_w, seed_anchor, ray_tile: int,
            seed_k: int, t_min: float, work: bool):
    """``visit_stats``'s launch through ``lib`` (a build of ``csrc/probes.cu``),
    counting nothing."""
    if ray_tile != lib.probe_block_tile():
        raise ValueError(f"visit_stats_kernel walks tiles of {lib.probe_block_tile()} rays, "
                         f"not {ray_tile}")
    device = tree.w.device
    tree_args = wide_bvh._tree_args(tree, lib.probe_block_stack_depth())
    comps, ptrs = wide_bvh._ray_ptrs(origins, directions, device)
    r = comps[0].shape[0]
    n_tiles = -(-r // ray_tile)
    seed = [0, 0]
    if seed_k:
        seed_w = seed_w.to(device=device, dtype=torch.float32).contiguous()
        seed_anchor = seed_anchor.to(device=device, dtype=torch.float32).contiguous()
        seed = [seed_w.data_ptr(), seed_anchor.data_ptr()]
    stats = torch.empty((n_tiles, 4), dtype=torch.float32, device=device)
    spent, work_args = None, [0, 0]
    if work:
        fill = (tree.slot_tri.view(-1, tree.leaf_size) >= 0).sum(dim=1, dtype=torch.int32)
        spent = torch.empty((n_tiles, len(WORK)), dtype=torch.int64, device=device)
        work_args = [fill.data_ptr(), spent.data_ptr()]
    launch(lib.probe_visit_stats, device, *ptrs, r, *tree_args, *seed, int(seed_k),
           float(t_min), wide_bvh.BOX_PAD, wide_bvh.FAR_SCALE, stats.data_ptr(), *work_args)
    counts = stats[:, 0], stats[:, 1], stats[:, 2], stats[:, 3]
    return counts + (spent,) if work else counts


visit_stats.launches = 0


def summary(stats) -> dict:
    """The reference's per-wavefront numbers from one ``visit_stats`` result."""
    nodes, leaves, frac, impr = (s.double().cpu().numpy() for s in stats[:4])
    n_leaves = max(leaves.sum(), 1.0)
    return {
        "nodes_mean": float(nodes.mean()), "nodes_p95": float(np.percentile(nodes, 95)),
        "nodes_max": float(nodes.max()), "leaves_mean": float(leaves.mean()),
        "leaves_p95": float(np.percentile(leaves, 95)), "leaves_max": float(leaves.max()),
        "overlap_frac": float(frac.sum() / n_leaves), "improving": float(impr.sum() / n_leaves),
    }


def run(scene, camera, ctx, opts, tree, depth: int, seed_k: int = SEED_K, log=print) -> list:
    """P3 over the wavefronts of depths 1..``depth``, plain and seeded: the
    primary rays, then ``integrator.bounce``'s extension rays (unsorted,
    ungated).  Logs the reference's line per wavefront and returns, per
    wavefront, a dict of its depth, tag, live share, rays, ``visit_stats``
    result, its ``summary`` and the call's ms."""
    from ..options import FrameGlobals
    from ..render import integrator

    device = ctx.device
    seed_w, seed_anchor, share = seed_chunk(scene, ctx.accel_pack.accel, seed_k)
    log(f"seed triangles: {seed_k}, area share {share:.2f}")
    frame = FrameGlobals.create(0, device=device)
    paths = integrator.start_paths(camera, ctx, opts, 0)
    out = []
    for dep in range(1, depth + 1):
        act = float(paths.active.float().mean())
        for k, tag in ((0, "plain"), (seed_k, "seeded")):
            ms, stats = elapsed_ms(lambda: visit_stats(
                tree, paths.org, paths.direction, seed_w, seed_anchor, seed_k=k), 1, device)
            s = summary(stats)
            log(f"depth {dep} {tag:6s}: act={act:.2f} nodes/tile mean={s['nodes_mean']:.1f} "
                f"p95={s['nodes_p95']:.0f} max={s['nodes_max']:.0f} "
                f"leaves/tile mean={s['leaves_mean']:.1f} p95={s['leaves_p95']:.0f} "
                f"max={s['leaves_max']:.0f} (of {tree.num_chunks}) "
                f"overlap-frac={s['overlap_frac']:.3f} improving={s['improving']:.2f} "
                f"ms={ms:.4f}")
            out.append({"depth": dep, "tag": tag, "seed_k": k, "active": act,
                        "org": paths.org, "direction": paths.direction, "stats": stats,
                        "summary": s, "ms": ms, "seed": (seed_w, seed_anchor)})
        if dep < depth:
            paths, _ = integrator.bounce(scene, ctx, opts, frame, dep, paths, ctx.accel_pack)
    return out


def setup(scene_name: str, width: int, height: int, depth: int, device):
    """(scene, camera, options, context, tree) of a probe scene: the Cornell
    box over its leaf-32 ``"wide"`` tree, or ``high_poly`` over its leaf-128
    ``"stream"`` tree."""
    from .. import frame_scene, high_poly, make_context, scene_aabb

    if scene_name == "cornell":
        scene, camera, opts, ctx = cornell(width, height, depth, device)
    else:
        scene = high_poly().to(device)
        camera = frame_scene(scene_aabb(scene.geometry), width, height, theta=0.35).to(device)
        opts = options(width, height, depth, intersect_backend="stream")
        ctx = make_context(opts, scene, device)
    return scene, camera, opts, ctx, ctx.accel_pack.wide


def main(argv=None) -> int:
    p = parser("P3: visit statistics per 256-ray block on bounce wavefronts")
    p.add_argument("--scene", choices=("cornell", "high-poly"), default="cornell")
    p.add_argument("--depth", type=int, default=4)
    args = p.parse_args(argv)
    device = device_of(args.device)
    width, height = args.size
    scene, camera, opts, ctx, tree = setup(args.scene, width, height, args.depth, device)
    print(f"{args.scene} {width}x{height}: {tree.num_triangles} triangles, {tree.num_nodes} "
          f"nodes, {tree.num_chunks} leaves of {tree.leaf_size}; {device_label(device)}")
    run(scene, camera, ctx, opts, tree, args.depth)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
