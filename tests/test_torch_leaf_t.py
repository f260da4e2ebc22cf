"""The port's transposed ("vpu") leaf math against the JAX package:
``intersect_closest_vpu``/``intersect_any_vpu`` (K5) and the streaming pair
with ``leaf_math="vpu"`` (K4), their plain versions against the TPU kernels
in interpret mode and the XLA brute force; the plain-torch emulation of the
group walks (``probes.visit_stats.group_walk``: a group of rays descends
together, each leaf is tested only on the rays whose own widened slab
enters it, ties go to the lowest slot); models of the block-culled walks of
K5 and K4 (a ray is served a block of 32 only if it enters every box above
it) and the block boxes of Route A's and Route B's trees;
the two routes sorted and gated against unsorted; and ``build_accel``'s
leaf sizes.  The routes' images against the JAX render are in
test_torch_render.py and test_torch_stream.py, beside the JAX renders those
files already make.

All inputs are made from numpy seeds and handed to both packages.  The CUDA
kernels themselves are checked in test_torch_cuda.py.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from heatray_tpu.ops import intersect_any as jax_intersect_any
from heatray_tpu.ops import intersect_closest as jax_intersect_closest
from heatray_tpu.ops.wide_bvh import build_wide_bvh as jax_build_wide_bvh
from heatray_tpu.ops.wide_bvh import intersect_any_stream as jax_any_stream
from heatray_tpu.ops.wide_bvh import intersect_any_vpu as jax_any_vpu
from heatray_tpu.ops.wide_bvh import intersect_closest_stream as jax_closest_stream
from heatray_tpu.ops.wide_bvh import intersect_closest_vpu as jax_closest_vpu
from heatray_tpu_torch import RenderOptions, cornell_box, frame_scene, high_poly, orbit_camera
from heatray_tpu_torch import scene_aabb
from heatray_tpu_torch.ops import intersect, wide_bvh
from heatray_tpu_torch.options import FrameGlobals
from heatray_tpu_torch.probes.visit_stats import group_walk
from heatray_tpu_torch.render import integrator
from heatray_tpu_torch.utils.threads import share_cores

from test_torch_wide_bvh import _rays, _soup, cornell_edge_rays

share_cores(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))


SIZE = 16


@pytest.fixture(scope="module")
def soup():
    """One triangle soup and ray set for every test here, so each JAX
    function compiles once: (JAX accel, port accel, JAX rays, port rays,
    t_max (R,) numpy, XLA closest (t, id, hit), XLA blocked)."""
    jax_accel, accel = _soup(700, 11)
    (jo, jd), (o, d) = _rays(512, 7)
    t_max = np.random.default_rng(0).uniform(1.0, 12.0, 512).astype(np.float32)
    t_ref, id_ref, _, hit_ref = (np.asarray(a) for a in jax_intersect_closest(jax_accel, jo, jd))
    blocked_ref = np.asarray(jax_intersect_any(jax_accel, jo, jd, t_max=t_max))
    return jax_accel, accel, (jo, jd), (o, d), t_max, (t_ref, id_ref, hit_ref), blocked_ref


def _queries(route):
    """(closest, any) of a route, each taking (bvh, o, d[, t_max])."""
    if route == "wide":
        return wide_bvh.intersect_closest_vpu, lambda bvh, o, d, t_max: (
            wide_bvh.intersect_any_vpu(bvh, o, d, t_max=t_max))

    def closest(bvh, o, d):
        return wide_bvh.intersect_closest_stream(bvh, o, d, leaf_math="vpu")

    def any_(bvh, o, d, t_max):
        return wide_bvh.intersect_any_stream(bvh, o, d, t_max=t_max, leaf_math="vpu")

    return closest, any_


@pytest.mark.parametrize("route", ["wide", "stream"])
@pytest.mark.parametrize("leaf_size", [128, 256])
def test_plain_matches_xla(soup, route, leaf_size):
    """Against the exact XLA brute force (the reference's own VPU kernels
    round t with ``_recip_fast``): hit masks equal, t at 1e-5, triangle ids
    through ``slot_tri`` equal but for ties, occlusion masks equal."""
    _, accel, _, (o, d), t_max, (t_ref, id_ref, hit_ref), blocked_ref = soup
    bvh = wide_bvh.build_wide_bvh(accel, leaf_size=leaf_size)
    closest, any_ = _queries(route)
    t, slot, hit = closest(bvh, o, d)
    np.testing.assert_array_equal(hit.numpy(), hit_ref)
    np.testing.assert_allclose(t.numpy()[hit_ref], t_ref[hit_ref], rtol=1e-5, atol=1e-5)
    assert (t.numpy()[~hit_ref] == intersect.MISS_T).all() and (slot.numpy()[~hit_ref] == -1).all()
    assert (bvh.slot_tri.numpy()[slot.numpy()[hit_ref]] == id_ref[hit_ref]).mean() > 0.999
    blocked = any_(bvh, o, d, torch.from_numpy(t_max))
    np.testing.assert_array_equal(blocked.numpy(), blocked_ref)
    assert 0 < int(blocked.sum()) < 512


# One leaf size per JAX function, so that each compiles once.
@pytest.mark.parametrize("route, leaf_size", [("wide", 128), ("stream", 256)])
def test_closest_matches_jax_kernel(soup, route, leaf_size):
    """Against the TPU kernel in interpret mode on the same JAX-built tree,
    carried over by ``wide_bvh_from_arrays``: hit masks equal, t at rtol
    1e-4 (``_recip_fast``), slots equal but for ties."""
    from heatray_tpu_torch.bridge import wide_bvh_from_arrays

    jax_accel, _, (jo, jd), (o, d), *_ = soup
    ref_bvh = jax_build_wide_bvh(jax_accel, leaf_size=leaf_size, schedule="f32")
    arrays = {f.name: np.asarray(getattr(ref_bvh, f.name)) for f in dataclasses.fields(ref_bvh)}
    boxes = {k: np.asarray(getattr(jax_accel, k)) for k in ("tri_min", "tri_max")}
    bvh = wide_bvh_from_arrays(arrays, ref_bvh.leaf_size, ref_bvh.num_triangles, boxes,
                               device="cpu")
    if route == "wide":
        ref = jax_closest_vpu(ref_bvh, jo, jd, ray_tile=256, interpret=True, return_slots=True)
    else:
        ref = jax_closest_stream(ref_bvh, jo, jd, ray_tile=256, interpret=True,
                                 return_slots=True, leaf_math="vpu")
    t_ref, slot_ref, hit_ref = (np.asarray(a) for a in ref)
    t, slot, hit = _queries(route)[0](bvh, o, d)
    np.testing.assert_array_equal(hit.numpy(), hit_ref)
    np.testing.assert_allclose(t.numpy()[hit_ref], t_ref[hit_ref], rtol=1e-4)
    assert (slot.numpy()[hit_ref] == slot_ref[hit_ref]).mean() > 0.999


@pytest.mark.parametrize("route, leaf_size", [("wide", 256), ("stream", 128)])
def test_any_matches_jax_kernel(soup, route, leaf_size):
    from heatray_tpu_torch.bridge import wide_bvh_from_arrays

    jax_accel, _, (jo, jd), (o, d), t_max, *_ = soup
    ref_bvh = jax_build_wide_bvh(jax_accel, leaf_size=leaf_size, schedule="f32")
    arrays = {f.name: np.asarray(getattr(ref_bvh, f.name)) for f in dataclasses.fields(ref_bvh)}
    boxes = {k: np.asarray(getattr(jax_accel, k)) for k in ("tri_min", "tri_max")}
    bvh = wide_bvh_from_arrays(arrays, ref_bvh.leaf_size, ref_bvh.num_triangles, boxes,
                               device="cpu")
    if route == "wide":
        ref = jax_any_vpu(ref_bvh, jo, jd, t_max=t_max, ray_tile=256, interpret=True)
    else:
        ref = jax_any_stream(ref_bvh, jo, jd, t_max=t_max, ray_tile=256, interpret=True,
                             leaf_math="vpu")
    blocked = _queries(route)[1](bvh, o, d, torch.from_numpy(t_max))
    np.testing.assert_array_equal(blocked.numpy(), np.asarray(ref))


@pytest.mark.parametrize("group", [32, 256])
def test_group_walk_equals_plain(group):
    """Rays aimed just past the Cornell box's triangle edges (and the one
    that grazes the floor's open front edge), over its leaf-128 tree: the
    group walk of the TPU's tiles (at a warp's 32) and of P3's blocks of
    256, with its per-ray leaf skip, gives the plain version's t and slots
    bit for bit, and its occlusion; and the skip does skip."""
    bvh, o, d = cornell_edge_rays(767, leaf_size=128)
    t_p, slot_p, hit_p = wide_bvh.closest_wide_plain(bvh, o, d)
    assert bool(hit_p[-1]) and int(hit_p.sum()) > 700
    (t_w, slot_w), stats = group_walk(bvh, o, d, group)
    assert torch.equal(t_w, t_p) and torch.equal(slot_w, slot_p)
    assert stats[:, 4].sum() > 0

    t_max = torch.where(hit_p, t_p * 1.001, 5.0)
    blocked, stats = group_walk(bvh, o, d, group, t_max=t_max)
    assert torch.equal(blocked, wide_bvh.any_wide_plain(bvh, o, d, t_max=t_max))
    assert bool(blocked[-1]) and stats[:, 4].sum() > 0


def _cornell_occluders():
    """The Cornell box's accel and the ``include`` mask of its occluder tree
    with the metal sphere (material 5) alpha-masked."""
    scene = cornell_box(light="both", with_spheres=True)
    accel = intersect.build_woop(scene.geometry.positions, scene.geometry.indices)
    mask = torch.zeros_like(scene.materials.alpha_mask)
    mask[5] = 1
    return accel, (mask[scene.geometry.material_ids.long()] == 0).numpy()


def _check_block_boxes(bvh, accel, include=None):
    """Each leaf's block boxes are the boxes of the triangles in its runs of
    32 slots, and a run of padding slots has an inverted box."""
    assert bvh.blocks.shape == (bvh.num_chunks, bvh.leaf_size // wide_bvh.BLOCK, 6)
    runs = bvh.slot_tri.view(-1, wide_bvh.BLOCK)
    boxes = bvh.blocks.view(-1, 6)
    filled = runs >= 0
    assert bool((~filled).all(dim=1).any())  # some run is all padding
    if include is not None:
        assert not include.all()
        assert not bool(np.isin(runs[filled].numpy(), np.flatnonzero(~include)).any())
    for run, box, f in zip(runs, boxes, filled):
        if not f.any():
            assert bool((box[:3] > box[3:]).all())
            continue
        tri = run[f].long()
        assert torch.equal(box[:3], accel.tri_min[:, tri].amin(dim=1))
        assert torch.equal(box[3:], accel.tri_max[:, tri].amax(dim=1))


@pytest.mark.parametrize("tree", ["all", "occluders", "route-b-128", "route-b-256"])
def test_leaf_block_boxes_bound_their_slots(tree):
    """The Cornell box's leaf-128 tree, and its occluder tree with the metal
    sphere alpha-masked (``include``); and Route B's trees (``high_poly`` at
    5,000 triangles through ``build_accel`` with ``stream_leaf_math="vpu"``,
    leaves of 128 and 256, its ``wide`` and ``wide_occl``): each leaf's
    block boxes bound its runs of 32 slots (``_check_block_boxes``)."""
    if tree.startswith("route-b"):
        leaf = int(tree.rsplit("-", 1)[1])
        scene = high_poly(triangles=5_000)
        pack = integrator.build_accel(scene, RenderOptions(
            width=8, height=8, intersect_backend="stream", stream_leaf_math="vpu",
            stream_leaf_size=leaf), static_shading=False)
        assert (pack.route, pack.wide.leaf_size) == ("stream/vpu", leaf)
        for bvh in (pack.wide, pack.wide_occl):
            _check_block_boxes(bvh, pack.accel)
        return
    accel, include = _cornell_occluders()
    include = include if tree == "occluders" else None
    _check_block_boxes(wide_bvh.build_wide_bvh(accel, leaf_size=128, include=include), accel,
                       include)


def _block_culled_pairs(bvh, o, d, far, t_min=1e-4):
    """The (ray, block) pairs a block-culled walk serves, if it culls by
    ``far`` (R,): a ray is served a block if it enters every box above it
    (the nodes', the leaf's in its parent's row, the block's; an inverted
    one never) before ``far``.  Returns the leaves each ray enters (R, C)
    and the blocks it is served (R, C, NB), both bool."""
    n = o.x.numel()
    org = [o.x[:, None], o.y[:, None], o.z[:, None]]
    rcp = [c[:, None] for c in wide_bvh.reciprocals(d)]
    far = far[:, None]

    def enter(box):  # (R, K) rays against K boxes (K, 6), inverted ones never
        return wide_bvh.widened_slab(box.T[:3], box.T[3:], org, rcp, far, t_min) & (
            box[:, 0] <= box[:, 3])

    codes = bvh.wchild.view(-1, wide_bvh.ARITY).long()
    leaf_in = torch.zeros((n, bvh.num_chunks), dtype=torch.bool)
    reach = {0: torch.ones(n, dtype=torch.bool)}
    while reach:
        node, rays = reach.popitem()
        ok = rays[:, None] & enter(bvh.wbox[node, :, :6]) & (codes[node] != -1)
        for k, code in enumerate(codes[node].tolist()):
            if code >= 0:
                reach[code] = ok[:, k]
            elif code <= -2:
                leaf_in[:, -2 - code] |= ok[:, k]
    blocks = torch.stack([enter(bvh.blocks[c]) for c in range(bvh.num_chunks)], dim=1)
    return leaf_in, blocks & leaf_in[:, :, None]


def _block_t(bvh, o, d, c, b, rays, t_min=1e-4):
    """t of each ray ``rays`` against each slot of block ``b`` of leaf ``c``:
    (t (len(rays), 32), the block's slots)."""
    rows, anchor = wide_bvh.slot_rows(bvh)
    cols = slice(c * bvh.leaf_size + b * wide_bvh.BLOCK,
                 c * bvh.leaf_size + (b + 1) * wide_bvh.BLOCK)
    t = intersect.pair_t(o.map(lambda x: x[rays]), d.map(lambda x: x[rays]), rows[:, cols],
                         t_min, intersect.MISS_T, anchor[:, cols])
    return t, cols


def test_block_culled_walk_reaches_every_plain_hit():
    """K5a reaches a hit if its ray enters every box above it (the nodes',
    the leaf's, the block's) before its running best t, which never falls
    below the hit's t.  A model that culls by the plain hit's t itself,
    leaves then blocks, so offers each ray fewer blocks than K5a can, must
    still give the plain version's t and slot bit for bit, ties to the
    lowest slot included, on rays aimed just past the Cornell box's triangle
    edges over its leaf-128 tree; and the block boxes cull blocks of
    entered leaves."""
    bvh, o, d = cornell_edge_rays(767, leaf_size=128)
    t_p, slot_p, hit_p = wide_bvh.closest_wide_plain(bvh, o, d)
    assert bool(hit_p[-1]) and int(hit_p.sum()) > 700
    n = o.x.numel()
    leaf_in, served_blocks = _block_culled_pairs(bvh, o, d, t_p)
    best = torch.full((n,), intersect.MISS_T)
    slot = torch.full((n,), -1, dtype=torch.int32)
    for c in range(bvh.num_chunks):
        for b in range(served_blocks.shape[2]):
            e = served_blocks[:, c, b].nonzero()[:, 0]
            t, cols = _block_t(bvh, o, d, c, b, e)
            cand, arg = torch.min(t, dim=1)
            cand_slot = (arg + cols.start).int()
            better = (cand < best[e]) | ((cand == best[e]) & (cand < intersect.MISS_T)
                                         & (cand_slot < slot[e]))
            best[e] = torch.where(better, cand, best[e])
            slot[e] = torch.where(better, cand_slot, slot[e])
    assert torch.equal(best, t_p) and torch.equal(slot, slot_p)
    assert 0 < int(served_blocks.sum()) < 4 * int(leaf_in.sum())


@pytest.mark.parametrize("tree", ["all", "occluders"])
@pytest.mark.parametrize("side", ["below", "above"])
def test_block_culled_any_walk_blocks_as_plain(tree, side):
    """A model of K5b's and K4b's walk (one loop): a ray is served a block
    only if it enters every box above it (the nodes', the leaf's, the
    block's) before its t_max, and is blocked by a hit in (t_min, t_max) in
    a block it is served.  On rays aimed just past the Cornell box's
    triangle edges, over its leaf-128 tree and its occluder tree with the
    metal sphere alpha-masked (Route A's trees, which K5b walks), each ray's t_max just at (``below``: that hit is out of
    range) or one ulp above (``above``) its plain closest hit over that
    tree, the model's blocked mask equals ``any_stream_plain``'s; and the
    block boxes cull blocks of entered leaves."""
    bvh, o, d = cornell_edge_rays(767, leaf_size=128)
    if tree == "occluders":
        accel, include = _cornell_occluders()
        bvh = wide_bvh.build_wide_bvh(accel, leaf_size=128, include=include)
    t_p, _, hit_p = wide_bvh.closest_wide_plain(bvh, o, d)
    assert int(hit_p.sum()) > 600
    t_hit = t_p if side == "below" else torch.nextafter(t_p, torch.tensor(float("inf")))
    t_max = torch.where(hit_p, t_hit, 5.0)
    want = wide_bvh.any_stream_plain(bvh, o, d, t_max=t_max)
    assert torch.equal(want, hit_p) if side == "above" else not bool(want.any())
    leaf_in, served_blocks = _block_culled_pairs(bvh, o, d, t_max)
    blocked = torch.zeros_like(want)
    for c in range(bvh.num_chunks):
        for b in range(served_blocks.shape[2]):
            e = served_blocks[:, c, b].nonzero()[:, 0]
            t, _ = _block_t(bvh, o, d, c, b, e)
            blocked[e] |= (t < t_max[e, None]).any(dim=1)
    assert torch.equal(blocked, want)
    assert 0 < int(served_blocks.sum()) < 4 * int(leaf_in.sum())


def _route(name):
    """(scene, camera, options) of Route A (Cornell, ``wide_leaf_math="vpu"``)
    or Route B (``high_poly`` at 5,000 triangles, ``stream_leaf_math="vpu"``)
    at SIZE x SIZE, depth 4."""
    opts = RenderOptions(width=SIZE, height=SIZE, max_render_passes=4, max_ray_depth=4)
    if name == "A":
        scene = cornell_box(light="both", with_spheres=True)
        camera = orbit_camera(SIZE, SIZE, distance=6.2, focal_length_mm=35.0)
        return scene, camera, dataclasses.replace(opts, wide_leaf_math="vpu")
    scene = high_poly(triangles=5_000)
    camera = frame_scene(scene_aabb(scene.geometry), SIZE, SIZE, theta=0.35)
    return scene, camera, dataclasses.replace(opts, intersect_backend="stream",
                                              stream_leaf_math="vpu")


@pytest.mark.parametrize("name, route", [("A", "wide/vpu"), ("B", "stream/vpu")])
def test_route_sorted_gated_equals_unsorted(name, route):
    """Each route's pass with the bounce sort and segment gating equals the
    unsorted pass to the bit, with the same ray count, through the route's
    own queries (leaves of 128)."""
    scene, camera, opts = _route(name)
    zero = torch.zeros((4, SIZE, SIZE))
    ctx = integrator.make_context(opts, scene, device="cpu")
    pack = ctx.accel_pack
    assert (pack.route, pack.wide.leaf_size) == (route, 128)
    out = {}
    for on in (False, True):
        o = dataclasses.replace(opts, sort_bounces=on, gate_bounces=on)
        assert integrator._bounce_modes(ctx, o, SIZE * SIZE) == (on, on)
        out[on] = integrator.render_pass(scene, camera, ctx, o, FrameGlobals.create(1), zero,
                                         with_stats=True)
    assert torch.equal(out[True][0], out[False][0]) and out[True][1] == out[False][1]
    assert float(out[True][0][:3].max()) > 0.0


def test_build_accel_leaf_sizes():
    """``"wide"`` with the vpu leaf math rounds its leaf up to a multiple of
    128; ``"stream"`` with it rejects a leaf that is not one; the mxu
    routes keep theirs."""
    scene = cornell_box()
    cases = [({}, "wide", 32), ({"wide_leaf_math": "vpu"}, "wide/vpu", 128),
             ({"wide_leaf_math": "vpu", "wide_leaf_size": 200}, "wide/vpu", 256),
             ({"intersect_backend": "stream", "stream_leaf_size": 192}, "stream", 192),
             ({"intersect_backend": "stream", "stream_leaf_math": "vpu",
               "stream_leaf_size": 256}, "stream/vpu", 256)]
    for kw, route, leaf in cases:
        pack = integrator.build_accel(scene, RenderOptions(width=8, height=8, **kw))
        assert (pack.route, pack.wide.leaf_size) == (route, leaf), kw
        assert pack.wide_occl is pack.wide
    with pytest.raises(ValueError, match="multiple of 128"):
        integrator.build_accel(scene, RenderOptions(
            width=8, height=8, intersect_backend="stream", stream_leaf_math="vpu",
            stream_leaf_size=192))


def test_cpu_wrappers_take_the_plain_versions():
    """On the CPU each wrapper returns its plain version and counts no
    launch; a leaf that is not a multiple of 128 raises everywhere."""
    _, accel = _soup(300, 5)
    _, (o, d) = _rays(128, 3)
    bvh = wide_bvh.build_wide_bvh(accel, leaf_size=128)
    counters = (wide_bvh.intersect_closest_vpu, wide_bvh.intersect_any_vpu,
                wide_bvh.intersect_closest_stream_vpu, wide_bvh.intersect_any_stream_vpu,
                wide_bvh.intersect_closest_stream, wide_bvh.intersect_any_stream)
    before = [f.launches for f in counters]
    want = wide_bvh.closest_wide_plain(bvh, o, d)
    for closest, any_ in (_queries("wide"), _queries("stream")):
        assert all(torch.equal(a, b) for a, b in zip(closest(bvh, o, d), want))
        assert torch.equal(any_(bvh, o, d, 3.0), wide_bvh.any_wide_plain(bvh, o, d, t_max=3.0))
    assert [f.launches for f in counters] == before
    small = wide_bvh.build_wide_bvh(accel, leaf_size=64)
    for fn in counters[:4]:
        with pytest.raises(ValueError, match="multiple of 128"):
            fn(small, o, d)
    with pytest.raises(ValueError, match="leaf_math"):
        wide_bvh.intersect_closest_stream(bvh, o, d, leaf_math="bf16")
