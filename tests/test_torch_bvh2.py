"""The port's binary-BVH backend (``intersect_backend="bvh"``) against the
JAX package: the packed tree bit for bit, the plain closest/any-hit
versions against the XLA brute force and against the TPU kernels in
interpret mode, the numpy walk, an emulation of the kernels' widened
per-ray walk, the tree's block boxes and models of K6a's and K6b's
block-culled walks over them, and renders.

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
from heatray_tpu.ops.bvh import build_bvh as jax_build_bvh
from heatray_tpu.ops.traverse_pallas import intersect_any_bvh as jax_any_bvh
from heatray_tpu.ops.traverse_pallas import intersect_closest_bvh as jax_closest_bvh
from heatray_tpu_torch import RenderOptions, cornell_box, orbit_camera
from heatray_tpu_torch.ops import bvh as bvh_mod
from heatray_tpu_torch.ops import intersect, traverse_pallas, wide_bvh
from heatray_tpu_torch.options import FrameGlobals
from heatray_tpu_torch.render import integrator
from heatray_tpu_torch.utils.threads import share_cores

from test_bvh import make_soup
from test_torch_chunks import assert_closest_matches, tri_t
from test_torch_leaf_t import _cornell_occluders
from test_torch_wide_bvh import _rays, _soup, cornell_edge_rays

share_cores(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))


SIZE = 16


def _port_soup(t, seed):
    """The port's accel of ``_soup``'s triangles, without the JAX side."""
    positions, indices = make_soup(t, seed=seed)
    return intersect.build_woop(torch.from_numpy(np.ascontiguousarray(positions.T)),
                                torch.from_numpy(np.ascontiguousarray(indices.T)))


@pytest.mark.parametrize("t, seed, leaf_size", [(700, 11, 64), (700, 3, 16)])
def test_build_matches_jax(t, seed, leaf_size):
    jax_accel, accel = _soup(t, seed)
    ref = jax_build_bvh(jax_accel, leaf_size=leaf_size)
    ours = bvh_mod.build_bvh(accel, leaf_size=leaf_size)
    for name in ("nbox", "meta", "w", "slot_tri"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert (ours.leaf_size, ours.num_triangles, ours.num_nodes) == (
        ref.leaf_size, ref.num_triangles, ref.num_nodes)


def test_max_stack_bounds_every_walk():
    """``max_stack`` is the tree's depth, and a near-first walk that enters
    every node, with either near-child choice, never holds more entries."""
    bvh = bvh_mod.build_bvh(_port_soup(2000, 7), leaf_size=4)
    meta = bvh.meta.view(-1, 2).tolist()
    deepest, depth = 0, 0
    for left_near in (True, False):
        stack, node, level = [], 0, 0
        while node >= 0:
            depth = max(depth, level)
            if meta[node][0] < 0:
                left, right = node + 1, meta[node + 1][1]
                stack.append((right if left_near else left, level + 1))
                deepest = max(deepest, len(stack))
                node, level = (left if left_near else right), level + 1
            else:
                node, level = stack.pop() if stack else (-1, 0)
    assert deepest <= bvh.max_stack == depth > 10


def test_closest_plain_matches_xla():
    jax_accel, accel = _soup(700, 11)
    bvh = bvh_mod.build_bvh(accel, leaf_size=64)
    (jo, jd), (o, d) = _rays(512, 7)
    t_ref, id_ref, _, hit_ref = jax_intersect_closest(jax_accel, jo, jd)
    got = traverse_pallas.intersect_closest_bvh(bvh, o, d)
    assert assert_closest_matches(accel.w, o, d, got, (t_ref, id_ref, hit_ref)) <= 1


def test_any_plain_matches_xla():
    jax_accel, accel = _soup(700, 13)
    bvh = bvh_mod.build_bvh(accel, leaf_size=64)
    (jo, jd), (o, d) = _rays(512, 17)
    t_max = np.random.default_rng(0).uniform(1.0, 12.0, 512).astype(np.float32)
    blocked = traverse_pallas.intersect_any_bvh(bvh, o, d, t_max=torch.from_numpy(t_max))
    np.testing.assert_array_equal(blocked.numpy(),
                                  np.asarray(jax_intersect_any(jax_accel, jo, jd, t_max=t_max)))
    assert 0 < int(blocked.sum()) < 512


def test_plain_matches_interpret_kernels():
    """The TPU kernels in interpret mode, on the same tree.  Their pair test
    divides by an approximate reciprocal (``_recip_fast``), so their t is
    off by up to about 1e-5 relative: on the lanes where it agrees within
    5e-5, hits and ids agree (except ties); occlusion agrees everywhere."""
    jax_accel, accel = _soup(700, 7)
    ref_bvh = jax_build_bvh(jax_accel, leaf_size=16)
    bvh = bvh_mod.build_bvh(accel, leaf_size=16)
    (jo, jd), (o, d) = _rays(256, 8)
    t_ref, id_ref, hit_ref = (
        torch.from_numpy(np.array(a))
        for a in jax_closest_bvh(ref_bvh, jo, jd, ray_tile=128, interpret=True)
    )
    t, ids, hit = traverse_pallas.closest_bvh_plain(bvh, o, d)
    close = (t - t_ref).abs() <= 5e-5 * t_ref.abs().clamp(min=1.0)
    assert int(close.sum()) >= 250 and int(hit.sum()) > 100
    assert torch.equal(hit[close], hit_ref[close])
    other = close & hit & (ids != id_ref)
    assert not (other & ((tri_t(accel.w, o, d, id_ref) - t).abs() > 1e-5)).any()

    t_max = np.random.default_rng(10).uniform(1.0, 20.0, 256).astype(np.float32)
    ref = jax_any_bvh(ref_bvh, jo, jd, t_max=t_max, ray_tile=128, interpret=True)
    blocked = traverse_pallas.any_bvh_plain(bvh, o, d, t_max=torch.from_numpy(t_max))
    np.testing.assert_array_equal(blocked.numpy(), np.asarray(ref))


def test_numpy_walk_matches_plain():
    """The port's own walk oracle (exact boxes, float32 numpy) on the same
    tree: t within 1e-5 and the same triangle, except ties."""
    accel = _port_soup(300, 5)
    topo = bvh_mod.build_topology(accel.tri_min.numpy(), accel.tri_max.numpy(), leaf_size=16)
    bvh = bvh_mod.pack_bvh(accel, topo)
    _, (o, d) = _rays(64, 9)
    t_p, id_p, hit_p = traverse_pallas.closest_bvh_plain(bvh, o, d)
    w = accel.w.numpy()
    for k in range(64):
        ray = [np.array([c[k] for c in (v.x, v.y, v.z)], np.float32) for v in (o, d)]
        t, tri = bvh_mod.traverse_closest_numpy(topo, w, *ray)
        assert (tri >= 0) == bool(hit_p[k])
        if tri >= 0:
            assert abs(t - float(t_p[k])) <= 1e-5 * max(1.0, abs(t))
            assert tri == int(id_p[k]) or abs(float(tri_t(accel.w, o, d, torch.tensor(
                [tri] * 64))[k]) - t) <= 1e-5
    assert int(hit_p.sum()) > 20


def _reached_leaves(bvh, o, d, t_far, pad, far, t_min=1e-4):
    """(R, C): the leaf chunks each ray reaches in a walk whose slab test
    (widened by ``pad`` and ``far``) runs against ``t_far``, node by node
    in preorder (a parent precedes its children)."""
    nbox, meta = bvh.nbox.view(-1, 6), bvh.meta.view(-1, 2).tolist()
    rcp = [torch.where(c < 0, -1.0, 1.0) / c.abs().clamp(min=1e-18) for c in (d.x, d.y, d.z)]
    org = (o.x, o.y, o.z)
    ok = torch.zeros((o.x.shape[0], bvh.num_nodes), dtype=torch.bool)
    ok[:, 0] = True
    leaves = torch.zeros((o.x.shape[0], bvh.num_chunks), dtype=torch.bool)
    for n in range(bvh.num_nodes):
        b = nbox[n]
        tn, tf = torch.full_like(o.x, t_min), t_far
        for a in range(3):
            p = (b[3 + a] - b[a]) * pad
            t0 = ((b[a] - p) - org[a]) * rcp[a]
            t1 = ((b[3 + a] + p) - org[a]) * rcp[a]
            tn, tf = torch.maximum(tn, torch.minimum(t0, t1)), torch.minimum(tf, torch.maximum(t0, t1))
        enter = ok[:, n] & (tn <= tf * far)
        code = meta[n][0]
        if code >= 0:
            leaves[:, code] = enter
        else:
            ok[:, n + 1] = ok[:, meta[n + 1][1]] = enter
    return leaves


@pytest.mark.parametrize("leaf_size", [4, 64])
def test_widened_walk_reaches_every_plain_hit(leaf_size):
    """Edge rays hit in the plain version up to BARY_EPS outside their
    triangle, so outside its leaf's box.  The kernels reach a hit iff every
    box on the way to its leaf passes the slab test against the running
    best t, never below the hit's t: so against the hit's t.  The widened
    slab passes them for every hit; exact boxes of 4-triangle leaves cull
    some."""
    _, o, d = cornell_edge_rays(2047, leaf_size=32)
    scene = cornell_box(light="both", with_spheres=True)
    accel = intersect.build_woop(scene.geometry.positions, scene.geometry.indices)
    bvh = bvh_mod.build_bvh(accel, leaf_size=leaf_size)
    t, _, hit = traverse_pallas.closest_bvh_plain(bvh, o, d)
    _, slot, _ = intersect.closest_rows(o, d, intersect.chunk_rows(bvh.w), 1e-4)
    assert bool(hit[-1]) and int(hit.sum()) > 1900
    rays = hit.nonzero()[:, 0]
    leaf = slot[rays].long() // leaf_size
    t_far = torch.where(hit, t, 3.0e37)
    widened = _reached_leaves(bvh, o, d, t_far, wide_bvh.BOX_PAD, wide_bvh.FAR_SCALE)
    assert widened[rays, leaf].all()
    if leaf_size == 4:
        exact = _reached_leaves(bvh, o, d, t_far, 0.0, 1.0)
        assert int((~exact[rays, leaf]).sum()) > 1


@pytest.mark.parametrize("tree", ["all", "occluders"])
@pytest.mark.parametrize("leaf_size", [4, 16, 64])
def test_block_boxes_bound_their_slots(leaf_size, tree):
    """The Cornell box's binary tree, and its occluder tree with the metal
    sphere alpha-masked (``include``): each leaf's block boxes
    (``BVH.blocks``, one per run of 32 slots, the last run padded past the
    leaf's end where the leaf size is not a multiple of 32) are the boxes of
    the triangles in the run, a run without one (padding, past the leaf's
    end) has an inverted box, the anchors are zero, and ``BVH.to`` carries
    both."""
    accel, include = _cornell_occluders()
    include = include if tree == "occluders" else None
    bvh = bvh_mod.build_bvh(accel, leaf_size=leaf_size, include=include).to(torch.device("cpu"))
    nb = -(-leaf_size // bvh_mod.BLOCK)
    assert bvh.blocks.shape == (bvh.num_chunks, nb, 6) and bvh.blocks.dtype == torch.float32
    assert torch.equal(bvh.wanchor, torch.zeros((3, bvh.num_chunks)))
    runs = torch.nn.functional.pad(bvh.slot_tri.view(-1, leaf_size),
                                   (0, nb * bvh_mod.BLOCK - leaf_size), value=-1)
    runs = runs.view(-1, bvh_mod.BLOCK)
    filled = runs >= 0
    if include is not None:
        assert not bool(np.isin(runs[filled].numpy(), np.flatnonzero(~include)).any())
    tri = runs.clamp(min=0).long()
    inf = torch.tensor(float("inf"))
    lo = torch.where(filled, accel.tri_min[:, tri], inf).amin(dim=2).T
    hi = torch.where(filled, accel.tri_max[:, tri], -inf).amax(dim=2).T
    boxes = bvh.blocks.view(-1, 6)
    some = filled.any(dim=1)
    assert torch.equal(boxes[some, :3], lo[some]) and torch.equal(boxes[some, 3:], hi[some])
    assert bool((boxes[~some, :3] > boxes[~some, 3:]).all())
    if leaf_size == 64:  # leaves of 32 or fewer triangles: their second run is padding
        assert bool((~some).any())


class _Kernels:
    """The one entry of the built library that K6's argument check reads."""

    @staticmethod
    def bvh2_stack_depth():
        return 96


@pytest.mark.parametrize("fault", [None, "missing", "shape", "dtype", "anchor"])
def test_block_tree_args_check_the_block_boxes(fault):
    """The arguments of both K6 entries, ``closest_bvh`` (K6a) and
    ``any_bvh`` (K6b) (``traverse_pallas._block_tree_args``, made before
    any launch): the tree's block boxes, its nodes and leaves, its zero
    anchors, the chunk count and the leaf size, in the C entries' order; or
    a ValueError for a tree without block boxes, or with block boxes or
    anchors of the wrong shape or type."""
    bvh = bvh_mod.build_bvh(_port_soup(300, 5), leaf_size=16)
    if fault is None:
        assert traverse_pallas._block_tree_args(bvh, _Kernels) == [
            bvh.blocks.data_ptr(), bvh.nbox.data_ptr(), bvh.meta.data_ptr(), bvh.w.data_ptr(),
            bvh.wanchor.data_ptr(), bvh.num_chunks, 16]
        return
    bad, match = {
        "missing": ({"blocks": None}, "block boxes"),
        "shape": ({"blocks": bvh.blocks[:-1].contiguous()}, "BVH.blocks"),
        "dtype": ({"blocks": bvh.blocks.double()}, "BVH.blocks"),
        "anchor": ({"wanchor": bvh.wanchor[:, :-1].contiguous()}, "BVH.wanchor"),
    }[fault]
    with pytest.raises(ValueError, match=match):
        traverse_pallas._block_tree_args(dataclasses.replace(bvh, **bad), _Kernels)


def _reached_blocks(bvh, o, d, t_far, t_min=1e-4):
    """(R, C, NB): the (ray, leaf, block) triples a block-culled walk serves
    if it culls by ``t_far``: the ray reaches the leaf (``_reached_leaves``,
    widened) and enters the block's widened box (an inverted one never)
    before ``t_far``; and the (R, C) leaves it reaches."""
    leaves = _reached_leaves(bvh, o, d, t_far, wide_bvh.BOX_PAD, wide_bvh.FAR_SCALE, t_min)
    org = [o.x[:, None], o.y[:, None], o.z[:, None]]
    rcp = [c[:, None] for c in wide_bvh.reciprocals(d)]
    box = bvh.blocks.view(-1, 6)
    enter = wide_bvh.widened_slab(box.T[:3], box.T[3:], org, rcp, t_far[:, None], t_min) & (
        box[:, 0] <= box[:, 3])
    return leaves[:, :, None] & enter.view(-1, bvh.num_chunks, bvh.blocks.shape[1]), leaves


@pytest.mark.parametrize("leaf_size", [16, 64])
def test_block_culled_binary_walk_reaches_every_plain_hit(leaf_size):
    """A model of K6a: a ray is served a block of 32 slots if it reaches
    the block's leaf (every node box on the way, widened, before its
    running best) and enters the block's box before its best.  Its best
    never falls below the plain hit's t, so a model that culls by that t
    itself offers each ray fewer blocks than K6a can, and must still give
    the plain version's t and slot bit for bit, ties to the lowest slot
    included, on rays aimed just past the Cornell box's triangle edges; and
    at leaf 64 the block boxes cull blocks of reached leaves."""
    _, o, d = cornell_edge_rays(2047, leaf_size=32)
    scene = cornell_box(light="both", with_spheres=True)
    accel = intersect.build_woop(scene.geometry.positions, scene.geometry.indices)
    bvh = bvh_mod.build_bvh(accel, leaf_size=leaf_size)
    rows = intersect.chunk_rows(bvh.w)
    t_p, slot_p, hit_p = intersect.closest_rows(o, d, rows, 1e-4)
    assert bool(hit_p[-1]) and int(hit_p.sum()) > 1900
    served, leaves = _reached_blocks(bvh, o, d, t_p)
    best = torch.full_like(t_p, intersect.MISS_T)
    slot = torch.full_like(slot_p, -1)
    for c in range(bvh.num_chunks):
        for b in range(served.shape[2]):
            e = served[:, c, b].nonzero()[:, 0]
            lo = c * leaf_size + b * bvh_mod.BLOCK
            cols = slice(lo, min(lo + bvh_mod.BLOCK, (c + 1) * leaf_size))
            t = intersect.pair_t(o.map(lambda x: x[e]), d.map(lambda x: x[e]), rows[:, cols],
                                 1e-4, intersect.MISS_T)
            cand, arg = torch.min(t, dim=1)
            cand_slot = (arg + lo).int()
            better = (cand < best[e]) | ((cand == best[e]) & (cand < intersect.MISS_T)
                                         & (cand_slot < slot[e]))
            best[e] = torch.where(better, cand, best[e])
            slot[e] = torch.where(better, cand_slot, slot[e])
    assert torch.equal(best, t_p) and torch.equal(slot, slot_p)
    whole = served.shape[2] * int(leaves.sum())
    assert 0 < int(served.sum()) < whole if leaf_size == 64 else int(served.sum()) == whole


@pytest.mark.parametrize("tree", ["all", "occluders"])
@pytest.mark.parametrize("leaf_size", [16, 64])
def test_block_culled_binary_any_walk_reaches_every_plain_occluder(leaf_size, tree):
    """A model of K6b over the Cornell box's binary tree, and over its
    occluder tree with the metal sphere alpha-masked (``include``): a ray
    is served a block of 32 slots if it reaches the block's leaf (every
    node box on the way, widened, before its ``t_max``) and enters the
    block's box before its ``t_max``; it is blocked if a served block holds
    a pair hit in (t_min, t_max).  K6b culls by the same ``t_max``, which
    never shrinks, and may only stop earlier, at its first occluder.  On
    rays aimed just past the triangle edges, with ``t_max`` at the plain
    closest t (not blocked) or just past it (blocked), the model's mask
    equals ``any_bvh_plain``'s; and at leaf 64 the block boxes cull blocks
    of reached leaves."""
    _, o, d = cornell_edge_rays(2047, leaf_size=32)
    accel, include = _cornell_occluders()
    bvh = bvh_mod.build_bvh(accel, leaf_size=leaf_size,
                            include=include if tree == "occluders" else None)
    rows = intersect.chunk_rows(bvh.w)
    t_p, _, hit_p = intersect.closest_rows(o, d, rows, 1e-4)
    assert int(hit_p.sum()) > 1500
    past = torch.nextafter(t_p, torch.tensor(float("inf")))
    t_max = torch.where(hit_p, torch.where(torch.arange(t_p.numel()) % 2 == 1, past, t_p), 12.0)
    want = traverse_pallas.any_bvh_plain(bvh, o, d, t_max=t_max)
    assert 0 < int(want.sum()) < int(hit_p.sum())
    served, leaves = _reached_blocks(bvh, o, d, t_max)
    blocked = torch.zeros_like(want)
    for c in range(bvh.num_chunks):
        for b in range(served.shape[2]):
            e = served[:, c, b].nonzero()[:, 0]
            lo = c * leaf_size + b * bvh_mod.BLOCK
            cols = slice(lo, min(lo + bvh_mod.BLOCK, (c + 1) * leaf_size))
            t = intersect.pair_t(o.map(lambda x: x[e]), d.map(lambda x: x[e]), rows[:, cols],
                                 1e-4, t_max[e])
            blocked[e] |= (t < intersect.MISS_T).any(dim=1)
    assert torch.equal(blocked, want)
    whole = served.shape[2] * int(leaves.sum())
    assert 0 < int(served.sum()) < whole if leaf_size == 64 else int(served.sum()) == whole


def _camera():
    return orbit_camera(SIZE, SIZE, distance=6.2, focal_length_mm=35.0)


def _render(backend, **kw):
    opts = RenderOptions(width=SIZE, height=SIZE, max_render_passes=4, max_ray_depth=4,
                         intersect_backend=backend, **kw)
    return integrator.render(cornell_box(light="both", with_spheres=True), _camera(), opts,
                             num_passes=1, device="cpu")


def test_bvh_render_matches_pallas():
    """``"bvh"`` and ``"pallas"`` trace the same raw Woop rows with the same
    float32 arithmetic and shade from triangle-order tables, so the image is
    the same to the bit (only an exact tie in t could go to another
    triangle: lowest slot against lowest id)."""
    bvh_accum, ctx = _render("bvh")
    pack = ctx.accel_pack
    assert pack.backend == "bvh" and pack.bvh.leaf_size == 64 and pack.bvh_occl is pack.bvh
    assert pack.shade_table.shape[0] == pack.accel.num_triangles  # triangle order
    chunk_accum, _ = _render("pallas")
    assert torch.equal(bvh_accum, chunk_accum)


def test_sorted_gated_bvh_equals_unsorted():
    """The bounce sort and gating under ``"bvh"``: the same accumulation to
    the bit and the same ray count."""
    scene = cornell_box(light="both", with_spheres=True)
    zero = torch.zeros((4, SIZE, SIZE))
    out = {}
    for on in (False, True):
        opts = RenderOptions(width=SIZE, height=SIZE, max_render_passes=4, max_ray_depth=4,
                             intersect_backend="bvh", sort_bounces=on, gate_bounces=on)
        ctx = integrator.make_context(opts, scene, device="cpu")
        out[on] = integrator.render_pass(scene, _camera(), ctx, opts, FrameGlobals.create(1), zero,
                                         with_stats=True)
    assert torch.equal(out[True][0], out[False][0]) and out[True][1] == out[False][1]


def test_cpu_wrappers_take_the_plain_versions():
    bvh = bvh_mod.build_bvh(_port_soup(300, 5), leaf_size=16)
    _, (o, d) = _rays(128, 3)
    k = traverse_pallas
    before = (k.intersect_closest_bvh.launches, k.intersect_any_bvh.launches)
    got = k.intersect_closest_bvh(bvh, o, d)
    assert all(torch.equal(a, b) for a, b in zip(got, k.closest_bvh_plain(bvh, o, d)))
    assert torch.equal(k.intersect_any_bvh(bvh, o, d, t_max=3.0),
                       k.any_bvh_plain(bvh, o, d, t_max=3.0))
    assert (k.intersect_closest_bvh.launches, k.intersect_any_bvh.launches) == before
