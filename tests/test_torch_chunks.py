"""The port's flat-chunk backend (``intersect_backend="pallas"``) and the
rebuild mode against the JAX package: the chunk pack and boxes bit for bit,
the plain closest/any-hit versions against the XLA brute force, an
emulation of the chunk kernels' widened per-ray cull, and renders.

All inputs are made from numpy seeds and handed to both packages.  The CUDA
kernels themselves are checked in test_torch_cuda.py.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from heatray_tpu.camera import orbit_camera as jax_orbit_camera
from heatray_tpu.ops import build_woop as jax_build_woop
from heatray_tpu.ops import intersect_any as jax_intersect_any
from heatray_tpu.ops import intersect_closest as jax_intersect_closest
from heatray_tpu.ops.intersect import chunk_boxes as jax_chunk_boxes
from heatray_tpu.ops.intersect_pallas import pack_for_pallas as jax_pack_for_pallas
from heatray_tpu.options import RenderOptions as JaxRenderOptions
from heatray_tpu.render import make_context as jax_make_context
from heatray_tpu.render import render as jax_render
from heatray_tpu.render import resolve as jax_resolve
from heatray_tpu.render.integrator import _occluder_accel as jax_occluder_accel
from heatray_tpu.scene.builtin import cornell_box as jax_cornell_box
from heatray_tpu_torch import RenderOptions, cornell_box, orbit_camera, resolve
from heatray_tpu_torch.ops import intersect, intersect_pallas, wide_bvh
from heatray_tpu_torch.options import FrameGlobals
from heatray_tpu_torch.render import integrator
from heatray_tpu_torch.utils.threads import share_cores

from test_torch_wide_bvh import _rays, _soup, cornell_edge_rays

share_cores(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))


SIZE = 16
TOL = 1e-5  # rtol = atol on t: both sides are exact float32 arithmetic


def tri_t(rows, o, d, ids):
    """t of each ray against one given row of ``rows`` (12, S) each."""
    r = rows[:, ids.clamp(min=0).long()]

    def aff(g, x, y, z):
        return x * r[4 * g] + y * r[4 * g + 1] + z * r[4 * g + 2]

    return -(aff(2, o.x, o.y, o.z) + r[11]) / aff(2, d.x, d.y, d.z)


def assert_closest_matches(rows, o, d, got, want):
    """Hit masks equal, t within TOL, ids equal except where the two ids'
    triangles tie within TOL."""
    t, ids, hit = got
    t_ref, id_ref, hit_ref = (torch.from_numpy(np.array(a)) for a in want)
    assert torch.equal(hit, hit_ref)
    torch.testing.assert_close(t[hit], t_ref[hit], rtol=TOL, atol=TOL)
    other = hit & (ids != id_ref)
    tie = (tri_t(rows, o, d, ids) - t_ref).abs() <= TOL + TOL * t_ref.abs()
    assert not (other & ~tie).any()
    return int(other.sum())


@pytest.mark.parametrize("t, tri_chunk", [(700, 128), (700, 512)])
def test_pack_matches_jax(t, tri_chunk):
    jax_accel, accel = _soup(t, 3)
    ref = jax_pack_for_pallas(jax_accel, tri_chunk=tri_chunk)
    ours = intersect_pallas.pack_for_pallas(accel, tri_chunk)
    np.testing.assert_array_equal(ours.w.numpy(), np.asarray(ref.w))
    np.testing.assert_array_equal(ours.boxes.numpy(), np.asarray(ref.boxes))
    assert (ours.num_triangles, ours.num_chunks, ours.tri_chunk) == (t, ref.num_chunks, tri_chunk)
    c = -(-t // 64)
    np.testing.assert_array_equal(intersect.chunk_boxes(accel, 64, c).numpy(),
                                  np.asarray(jax_chunk_boxes(jax_accel, 64, c)))


def test_closest_plain_matches_xla():
    jax_accel, accel = _soup(700, 11)
    packed = intersect_pallas.pack_for_pallas(accel, 128)
    (jo, jd), (o, d) = _rays(512, 7)
    t_ref, id_ref, _, hit_ref = jax_intersect_closest(jax_accel, jo, jd)
    got = intersect_pallas.intersect_closest_pallas(packed, o, d)
    assert assert_closest_matches(accel.w, o, d, got, (t_ref, id_ref, hit_ref)) <= 1
    assert int(got[2].sum()) > 100


def test_any_plain_matches_xla():
    jax_accel, accel = _soup(700, 13)
    packed = intersect_pallas.pack_for_pallas(accel, 128)
    (jo, jd), (o, d) = _rays(512, 17)
    t_max = np.random.default_rng(0).uniform(1.0, 12.0, 512).astype(np.float32)
    blocked = intersect_pallas.intersect_any_pallas(packed, o, d, t_max=torch.from_numpy(t_max))
    np.testing.assert_array_equal(blocked.numpy(),
                                  np.asarray(jax_intersect_any(jax_accel, jo, jd, t_max=t_max)))
    assert 0 < int(blocked.sum()) < 512


def _edge_rays_and_pack(tri_chunk):
    """Rays aimed just past the Cornell box's triangle edges (and one that
    grazes the floor's open front edge) and the box's chunk pack."""
    _, o, d = cornell_edge_rays(2047, leaf_size=32)
    scene = cornell_box(light="both", with_spheres=True)
    accel = intersect.build_woop(scene.geometry.positions, scene.geometry.indices)
    return intersect_pallas.pack_for_pallas(accel, tri_chunk), o, d


def _enters(box, o, d, t_far, pad, far, t_min=1e-4):
    """Per-ray slab test of the chunk kernels against per-ray boxes (R, 6)."""
    rcp = [torch.where(c < 0, -1.0, 1.0) / c.abs().clamp(min=1e-18) for c in (d.x, d.y, d.z)]
    tn, tf = torch.full_like(o.x, t_min), t_far
    for a, org in enumerate((o.x, o.y, o.z)):
        p = (box[:, 3 + a] - box[:, a]) * pad
        t0 = ((box[:, a] - p) - org) * rcp[a]
        t1 = ((box[:, 3 + a] + p) - org) * rcp[a]
        tn, tf = torch.maximum(tn, torch.minimum(t0, t1)), torch.minimum(tf, torch.maximum(t0, t1))
    return (tn <= tf * far) & (box[:, 0] <= box[:, 3])


@pytest.mark.parametrize("tri_chunk", [1, 512])
def test_chunk_cull_reaches_every_plain_hit(tri_chunk):
    """Edge rays hit in the plain version up to BARY_EPS outside their
    triangle, so outside its box.  A kernel reaches a hit iff the ray enters
    the hit's chunk box before its running best t, which is never below the
    hit's t: so it must enter it before the hit's t.  The widened slab does
    for every hit, and so does K7a's second cull, by the box of the hit's
    block of 32 columns; exact boxes of one triangle each cull some."""
    packed, o, d = _edge_rays_and_pack(tri_chunk)
    t, ids, hit = intersect_pallas.closest_chunks_plain(packed, o, d)
    assert bool(hit[-1]) and int(hit.sum()) > 1900
    chunk, col = ids[hit].long() // tri_chunk, ids[hit].long() % tri_chunk
    box = packed.boxes[chunk]
    block = packed.blocks[chunk, col // intersect_pallas.BLOCK]
    o, d = o.map(lambda c: c[hit]), d.map(lambda c: c[hit])
    for b in (box, block):
        assert _enters(b, o, d, t[hit], wide_bvh.BOX_PAD, wide_bvh.FAR_SCALE).all()
    if tri_chunk == 1:
        assert int((~_enters(box, o, d, t[hit], 0.0, 1.0)).sum()) > 1


@pytest.mark.parametrize("tri_chunk", [64, 100])
def test_block_boxes_bound_their_columns(tri_chunk):
    """Each chunk's block boxes are the boxes of its runs of BLOCK triangles
    (the last run of a chunk of 100 holds 4), inverted past its triangles."""
    _, accel = _soup(700, 3)
    packed = intersect_pallas.pack_for_pallas(accel, tri_chunk)
    nb = -(-tri_chunk // intersect_pallas.BLOCK)
    assert packed.blocks.shape == (packed.num_chunks, nb, 6)
    for c in range(packed.num_chunks):
        for b in range(nb):
            lo = c * tri_chunk + b * intersect_pallas.BLOCK
            hi = min(lo + intersect_pallas.BLOCK, (c + 1) * tri_chunk, accel.num_triangles)
            got = packed.blocks[c, b]
            if lo >= hi:
                assert bool((got[:3] > got[3:]).all())
                continue
            torch.testing.assert_close(got[:3], accel.tri_min[:, lo:hi].amin(dim=1), rtol=0,
                                       atol=0)
            torch.testing.assert_close(got[3:], accel.tri_max[:, lo:hi].amax(dim=1), rtol=0,
                                       atol=0)


def _warp_order(packed, o, d, t_min, lanes=32):
    """K7a's order of the chunks, per warp of ``lanes`` consecutive rays: by
    the warp's least entry into each chunk's (unwidened) box, clamped to
    t_min, over its rays that enter the widened box; chunks no ray of the
    warp enters come last.  Returns per ray its warp's order (R, C) and
    whether each of those chunks is entered (R, C)."""
    n, c = o.x.shape[0], packed.num_chunks
    rcp = [torch.where(x < 0, -1.0, 1.0) / x.abs().clamp(min=1e-18) for x in (d.x, d.y, d.z)]
    keys = []
    for k in range(c):
        box = packed.boxes[k]
        enter = _enters(box.expand(n, 6), o, d, torch.full_like(o.x, intersect.MISS_T),
                        wide_bvh.BOX_PAD, wide_bvh.FAR_SCALE)
        near = torch.full_like(o.x, t_min)
        for a, org in enumerate((o.x, o.y, o.z)):
            t0, t1 = (box[a] - org) * rcp[a], (box[3 + a] - org) * rcp[a]
            near = torch.maximum(near, torch.minimum(t0, t1))
        keys.append(torch.where(enter, near, float("inf")))
    keys = torch.stack(keys, dim=1)
    warp = (torch.arange(n) // lanes)[:, None].expand(n, c)
    least = torch.full((int(warp[-1, 0]) + 1, c), float("inf"))
    least = least.scatter_reduce(0, warp, keys, "amin")
    order = torch.argsort(least, dim=1, stable=True)
    return order[warp[:, 0]], torch.isfinite(least.gather(1, order))[warp[:, 0]]


@pytest.mark.parametrize("order", ["index", "nearest first"])
def test_chunk_walk_equals_plain(order):
    """A plain-torch emulation of the chunk kernels (each ray testing a chunk
    only if it enters its widened box before its running best t, or for
    occlusion its t_max while unblocked) gives the plain version's closest
    hits and occlusion on the edge rays, bit for bit: with the chunks in
    index order, and, for the closest hit, per warp of 32 rays nearest
    entry first, each entered chunk's blocks culled by their own boxes (K7a),
    where equal t go to the lower id whichever chunk comes first; and
    occlusion, in index order, the blocks culled by their boxes too (K7b)."""
    packed, o, d = _edge_rays_and_pack(512)
    rows, big, t_min = intersect.chunk_rows(packed.w), intersect.MISS_T, 1e-4
    t_p, id_p, hit_p = intersect_pallas.closest_chunks_plain(packed, o, d)
    t_max = torch.where(hit_p, t_p * 1.001, 5.0)
    best = torch.full_like(o.x, big)
    ids = torch.full(o.x.shape, -1, dtype=torch.int32)
    blocked = torch.zeros(o.x.shape, dtype=torch.bool)
    n = o.x.shape[0]
    chunk_of = torch.arange(packed.num_chunks).expand(n, -1)
    entered = torch.ones(chunk_of.shape, dtype=torch.bool)
    if order == "nearest first":
        chunk_of, entered = _warp_order(packed, o, d, t_min)
        assert bool((chunk_of != torch.arange(packed.num_chunks)).any(dim=1).float().mean() > 0.5)
    for k in range(packed.num_chunks):
        for c in range(packed.num_chunks):  # the rays whose k-th chunk is c
            lanes = (chunk_of[:, k] == c) & entered[:, k]
            if not lanes.any():
                continue
            box = packed.boxes[c].expand(n, 6)
            cols = slice(c * packed.tri_chunk, (c + 1) * packed.tri_chunk)
            enter = lanes & _enters(box, o, d, best, wide_bvh.BOX_PAD, wide_bvh.FAR_SCALE)
            spans = [(None, cols)]
            if order == "nearest first":
                step = intersect_pallas.BLOCK
                spans = [(b, slice(cols.start + b * step, min(cols.start + (b + 1) * step,
                                                               cols.stop)))
                         for b in range(packed.blocks.shape[1])]
            for b, span in spans:
                e = enter
                if b is not None:
                    e = e & _enters(packed.blocks[c, b].expand(n, 6), o, d, best,
                                    wide_bvh.BOX_PAD, wide_bvh.FAR_SCALE)
                if not e.any():
                    continue
                t = torch.where(e[:, None], intersect.pair_t(o, d, rows[:, span], t_min, big),
                                big)
                cand, arg = torch.min(t, dim=1)
                cand_id = (arg + span.start).int()
                better = (cand < best) | ((cand == best) & (cand < big) & (cand_id < ids))
                best = torch.where(better, cand, best)
                ids = torch.where(better, cand_id, ids)
    assert torch.equal(best, t_p) and torch.equal(ids, id_p)
    blocked, _ = _any_chunk_walk(packed, o, d, t_max, t_min)
    assert torch.equal(blocked, intersect_pallas.any_chunks_plain(packed, o, d, t_max=t_max))
    assert bool(blocked[-1])


def _any_chunk_walk(packed, o, d, t_max, t_min=1e-4):
    """A plain-torch model of K7b's walk: chunks in index order, each
    entered by the unblocked rays whose widened slab enters its box before
    their own t_max, and in it each block of BLOCK columns entered by those
    of them whose slab enters the block's box; a hit in an entered block
    blocks the ray.  Returns (blocked, (ray, block) entries).  (K7b also
    stops a ray at its first blocked block within a chunk: the same mask.)"""
    rows, n, tc = intersect.chunk_rows(packed.w), o.x.shape[0], packed.tri_chunk
    nb, step = packed.blocks.shape[1], intersect_pallas.BLOCK
    blocked = torch.zeros(n, dtype=torch.bool)
    entries = 0

    def rep(x):  # each ray once per block
        return x.repeat_interleave(nb)

    for c in range(packed.num_chunks):
        mine = (~blocked & _enters(packed.boxes[c].expand(n, 6), o, d, t_max, wide_bvh.BOX_PAD,
                                   wide_bvh.FAR_SCALE)).nonzero()[:, 0]
        if not mine.numel():
            continue
        om, dm = o.map(lambda x: x[mine]), d.map(lambda x: x[mine])
        boxes = packed.blocks[c].repeat(mine.numel(), 1)  # (m * NB, 6), block fastest
        enter = _enters(boxes, om.map(rep), dm.map(rep), rep(t_max[mine]), wide_bvh.BOX_PAD,
                        wide_bvh.FAR_SCALE).view(-1, nb)
        entries += int(enter.sum())
        hit = intersect.pair_t(om, dm, rows[:, c * tc:(c + 1) * tc], t_min, t_max[mine])
        hit = torch.nn.functional.pad(hit < intersect.MISS_T, (0, nb * step - tc))
        blocked[mine] |= (enter & hit.view(-1, nb, step).any(dim=2)).any(dim=1)
    return blocked, entries


@pytest.fixture(scope="module")
def renders():
    """(JAX rebuild-mode image, port rebuild-mode accumulation) of the
    Cornell box at 16x16, one pass, depth 4.  The JAX package runs its XLA
    brute force on the CPU, unsorted."""
    jax_opts = JaxRenderOptions(width=SIZE, height=SIZE, max_render_passes=4, max_ray_depth=4,
                                sort_bounces=False)
    jax_scene = jax_cornell_box(light="both", with_spheres=True)
    jax_camera = jax_orbit_camera(SIZE, SIZE, distance=6.2, focal_length_mm=35.0)
    jax_accum, _ = jax_render(jax_scene, jax_camera, jax_opts, num_passes=1,
                              ctx=jax_make_context(jax_opts))

    opts = _options()
    ctx = integrator.make_context(opts, device="cpu")
    assert ctx.accel_pack is None
    accum, _ = integrator.render(cornell_box(light="both", with_spheres=True), _camera(), opts,
                                 num_passes=1, ctx=ctx, device="cpu")
    return np.asarray(jax_resolve(jax_accum)), accum


def _options(**kw):
    return RenderOptions(width=SIZE, height=SIZE, max_render_passes=4, max_ray_depth=4, **kw)


def _camera():
    return orbit_camera(SIZE, SIZE, distance=6.2, focal_length_mm=35.0)


def test_rebuild_render_matches_jax(renders):
    """Per pixel, at ``test_small_render_matches_jax``'s tolerance."""
    ref, accum = renders
    img = resolve(accum).numpy()
    assert np.isfinite(img).all() and img.max() > 0.0
    np.testing.assert_allclose(img, ref, rtol=1e-3, atol=1e-4)


def test_prebuilt_pallas_pack_renders_like_the_rebuild(renders):
    """``intersect_backend="pallas"`` with a pack built once: the same rows,
    packs and table as the rebuild mode's, so the same image to the bit."""
    opts = _options(intersect_backend="pallas")
    accum, ctx = integrator.render(cornell_box(light="both", with_spheres=True), _camera(), opts,
                                   num_passes=1, device="cpu")
    pack = ctx.accel_pack
    assert pack.backend == "pallas" and pack.packed.tri_chunk == opts.pallas_tri_chunk
    assert pack.packed_occl is pack.packed and pack.wide is None and pack.bvh is None
    assert pack.shade_table.shape[0] == pack.accel.num_triangles  # triangle order
    assert torch.equal(accum, renders[1])


def _masked(scene, material):
    """The scene with ``material`` alpha-masked (it then blocks no shadow ray)."""
    mask = torch.zeros_like(scene.materials.alpha_mask)
    mask[material] = 1
    return dataclasses.replace(
        scene, materials=dataclasses.replace(scene.materials, alpha_mask=mask), has_alpha_mask=True
    )


def test_occluder_accel_matches_jax():
    jax_scene = jax_cornell_box(light="both", with_spheres=True)
    jax_scene = jax_scene.replace(
        materials=jax_scene.materials.replace(
            alpha_mask=jax_scene.materials.alpha_mask.at[5].set(1)),
        has_alpha_mask=True,
    )
    scene = _masked(cornell_box(light="both", with_spheres=True), 5)
    ref = jax_occluder_accel(
        jax_build_woop(jax_scene.geometry.positions, jax_scene.geometry.indices), jax_scene)
    accel = intersect.build_woop(scene.geometry.positions, scene.geometry.indices)
    ours = integrator._occluder_accel(accel, scene)
    for name in ("w", "tri_min", "tri_max"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(), np.asarray(getattr(ref, name)))


def test_any_chunk_walk_on_the_occluder_pack_equals_plain():
    """The metal sphere alpha-masked: in the rebuild mode's occluder pack
    its triangles' rows are zero and their boxes inverted, so a block of
    them alone has an inverted box, which K7b's walk never enters.  The
    model of K7b's walk (``_any_chunk_walk``) on that pack, for rays aimed
    just past the box's triangle edges with t_max just beyond their closest
    hit in the full pack, gives ``any_chunks_plain``'s mask, and the block
    boxes cull."""
    scene = _masked(cornell_box(light="both", with_spheres=True), 5)
    pack = integrator.rebuild_pack(scene, _options())
    occl = pack.packed_occl
    assert occl is not pack.packed
    masked = ~integrator._occluder_mask(scene)
    nb, step = occl.blocks.shape[1], intersect_pallas.BLOCK
    # (C, NB, BLOCK): the triangle id of each block's columns, and whether it is one.
    within = (torch.arange(nb)[:, None] * step + torch.arange(step)) < occl.tri_chunk
    col = (torch.arange(occl.num_chunks)[:, None, None] * occl.tri_chunk
           + torch.arange(nb)[:, None] * step + torch.arange(step))
    inside = within & (col < occl.num_triangles)
    all_masked = (masked[col.clamp(max=occl.num_triangles - 1)] | ~inside).all(dim=2)
    all_masked &= inside.any(dim=2)
    assert bool(all_masked.any())
    inverted = occl.blocks[..., 0] > occl.blocks[..., 3]
    assert torch.equal(inverted & inside.any(dim=2), all_masked)

    _, o, d = cornell_edge_rays(2047, leaf_size=32)
    t_p, _, hit_p = intersect_pallas.closest_chunks_plain(pack.packed, o, d)
    t_max = torch.where(hit_p, t_p * 1.001, 5.0)
    want = intersect_pallas.any_chunks_plain(occl, o, d, t_max=t_max)
    blocked, entries = _any_chunk_walk(occl, o, d, t_max)
    assert torch.equal(blocked, want)
    assert not torch.equal(want, intersect_pallas.any_chunks_plain(pack.packed, o, d,
                                                                   t_max=t_max))
    assert 0 < entries < o.x.numel() * occl.num_chunks * nb // 4


def test_alpha_masked_rebuild_matches_prebuilt(renders):
    """The metal sphere alpha-masked: the rebuild mode traces shadow rays
    against the occluder pack, as the prebuilt ``"wide"`` backend does
    against its occluder tree; the shadows change."""
    scene = _masked(cornell_box(light="both", with_spheres=True), 5)
    opts = _options()
    rebuilt, _ = integrator.render(scene, _camera(), opts, num_passes=1,
                                   ctx=integrator.make_context(opts, device="cpu"), device="cpu")
    prebuilt, ctx = integrator.render(scene, _camera(), opts, num_passes=1, device="cpu")
    assert ctx.accel_pack.wide_occl is not ctx.accel_pack.wide
    torch.testing.assert_close(rebuilt, prebuilt, rtol=1e-3, atol=1e-4)
    assert not torch.allclose(rebuilt, renders[1], rtol=1e-3, atol=1e-4)


def test_sorted_gated_rebuild_equals_unsorted():
    """The bounce sort and gating in the rebuild mode: the same accumulation
    to the bit and the same ray count."""
    scene = cornell_box(light="both", with_spheres=True)
    zero = torch.zeros((4, SIZE, SIZE))
    out = {}
    for on in (False, True):
        opts = _options(sort_bounces=on, gate_bounces=on)
        ctx = integrator.make_context(opts, device="cpu")
        assert integrator._bounce_modes(ctx, opts, SIZE * SIZE) == (on, on)
        out[on] = integrator.render_pass(scene, _camera(), ctx, opts, FrameGlobals.create(1), zero,
                                         with_stats=True)
    assert torch.equal(out[True][0], out[False][0]) and out[True][1] == out[False][1]


def test_rebuild_context_defaults_to_the_card():
    """A context with no scene names the card unless told otherwise."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        integrator.make_context(_options())
    assert integrator.make_context(_options(), device="cpu").accel_pack is None


def test_cpu_wrappers_take_the_plain_versions():
    _, accel = _soup(700, 5)
    packed = intersect_pallas.pack_for_pallas(accel, 64)
    _, (o, d) = _rays(128, 3)
    k = intersect_pallas
    before = (k.intersect_closest_pallas.launches, k.intersect_any_pallas.launches)
    got = k.intersect_closest_pallas(packed, o, d)
    assert all(torch.equal(a, b) for a, b in zip(got, k.closest_chunks_plain(packed, o, d)))
    assert torch.equal(k.intersect_any_pallas(packed, o, d, t_max=3.0),
                       k.any_chunks_plain(packed, o, d, t_max=3.0))
    assert (k.intersect_closest_pallas.launches, k.intersect_any_pallas.launches) == before
