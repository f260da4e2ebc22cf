"""The port's large-scene slice against the JAX package: ``high_poly``,
``scene_aabb`` and ``frame_scene``; the streaming queries' plain versions
and an emulation of the streaming kernels' packet walk; the bounce sort
key, the backend rule, and renders with the bounce sort and segment gating
(also through the transposed leaf math, ``stream_leaf_math="vpu"``).

All inputs are made from numpy seeds and handed to both packages.  The
streaming CUDA kernels themselves are checked in test_torch_cuda.py.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heatray_tpu.ops import intersect_closest as jax_intersect_closest
from heatray_tpu.ops.wide_bvh import build_wide_bvh as jax_build_wide_bvh
from heatray_tpu.ops.wide_bvh import intersect_any_stream as jax_any_stream
from heatray_tpu.options import RenderOptions as JaxRenderOptions
from heatray_tpu.render import render as jax_render
from heatray_tpu.render import resolve as jax_resolve
from heatray_tpu.render.integrator import _wavefront_sort_key as jax_sort_key
from heatray_tpu.scene.builtin import high_poly as jax_high_poly
from heatray_tpu.scene.geometry import scene_aabb as jax_scene_aabb
from heatray_tpu.utils.framing import frame_scene as jax_frame_scene
from heatray_tpu_torch import (
    RenderOptions,
    cornell_box,
    frame_scene,
    high_poly,
    orbit_camera,
    resolve,
    scene_aabb,
)
from heatray_tpu_torch.bridge import scene_from_arrays
from heatray_tpu_torch.ops import intersect, wide_bvh
from heatray_tpu_torch.options import FrameGlobals
from heatray_tpu_torch.render import integrator
from heatray_tpu_torch.utils.threads import share_cores
from heatray_tpu_torch.vec import Vec3

from test_bvh import v3
from test_torch_wide_bvh import _rays, _soup, cornell_edge_rays

share_cores(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))


TRIANGLES = 5_000


def _arrays(obj):
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


def _vec(a):
    """Port Vec3 of the columns of a float32 (R, 3) numpy array."""
    return Vec3(*(torch.from_numpy(np.ascontiguousarray(a[:, k])) for k in range(3)))


@pytest.fixture(scope="module")
def scenes():
    """(JAX, port) ``high_poly`` at 5,000 triangles."""
    return jax_high_poly(triangles=TRIANGLES), high_poly(triangles=TRIANGLES)


def test_high_poly_matches_jax(scenes):
    """Geometry, materials and lights: floats within 1e-6, the rest exact."""
    ref, ours = scenes
    bridged = scene_from_arrays(
        _arrays(ref.geometry), _arrays(ref.materials), _arrays(ref.lights),
        has_alpha_mask=ref.has_alpha_mask, has_textures=ref.has_textures, device="cpu",
    )
    assert (ours.has_alpha_mask, ours.has_textures) == (ref.has_alpha_mask, ref.has_textures)
    assert 0.9 * TRIANGLES < ours.geometry.num_triangles < 1.1 * TRIANGLES
    for part in ("geometry", "materials", "lights"):
        a, b = getattr(ours, part), getattr(bridged, part)
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, torch.Tensor) and x.is_floating_point():
                torch.testing.assert_close(x, y, rtol=0, atol=1e-6, msg=f.name)
            elif isinstance(x, torch.Tensor):
                assert torch.equal(x, y), f.name
            else:
                assert x == y, f.name


def test_framing_matches_jax(scenes):
    ref, ours = scenes
    aabb, ref_aabb = scene_aabb(ours.geometry), np.asarray(jax_scene_aabb(ref.geometry))
    np.testing.assert_allclose(aabb, ref_aabb, rtol=0, atol=1e-6)
    camera = frame_scene(aabb, 32, 24, theta=0.35)
    ref_camera = jax_frame_scene(ref_aabb, 32, 24, theta=0.35)
    for f in dataclasses.fields(camera):
        np.testing.assert_allclose(
            getattr(camera, f.name).numpy(), np.asarray(getattr(ref_camera, f.name)),
            rtol=1e-6, atol=1e-6, err_msg=f.name,
        )


@pytest.mark.parametrize("leaf_size", [64, 128])
def test_closest_stream_plain_matches_xla(leaf_size):
    """Against the JAX package's XLA brute force, through ``slot_tri``."""
    jax_accel, accel = _soup(700, 11)
    bvh = wide_bvh.build_wide_bvh(accel, leaf_size=leaf_size)
    (jo, jd), (o, d) = _rays(512, 7)
    t_ref, id_ref, _, hit_ref = (np.asarray(a) for a in jax_intersect_closest(jax_accel, jo, jd))
    t, slot, hit = wide_bvh.intersect_closest_stream(bvh, o, d)
    np.testing.assert_array_equal(hit.numpy(), hit_ref)
    np.testing.assert_allclose(t.numpy()[hit_ref], t_ref[hit_ref], rtol=1e-5, atol=1e-5)
    assert (t.numpy()[~hit_ref] == intersect.MISS_T).all()
    assert (slot.numpy()[~hit_ref] == -1).all()
    tri = bvh.slot_tri.numpy()[slot.numpy()[hit_ref]]
    assert (tri == id_ref[hit_ref]).mean() > 0.999


def test_any_stream_plain_matches_jax_kernel():
    """Against the JAX package's streaming occlusion kernel in interpret
    mode, on the same leaf-128 tree."""
    jax_accel, accel = _soup(700, 13)
    ref_bvh = jax_build_wide_bvh(jax_accel, leaf_size=128, schedule="f32")
    bvh = wide_bvh.build_wide_bvh(accel, leaf_size=128)
    (jo, jd), (o, d) = _rays(512, 17)
    t_max = np.random.default_rng(0).uniform(1.0, 12.0, 512).astype(np.float32)
    blocked = wide_bvh.intersect_any_stream(bvh, o, d, t_max=torch.from_numpy(t_max))
    ref = jax_any_stream(ref_bvh, jo, jd, t_max=t_max, ray_tile=256, interpret=True)
    np.testing.assert_array_equal(blocked.numpy(), np.asarray(ref))
    assert 0 < int(blocked.sum()) < 512


def _packet_walk(bvh, o, d, t_max=None, t_min=1e-4, tile=256):
    """Plain-torch emulation of the streaming kernels' walk.  Per tile of
    rays: one shared stack; a child is visited if any ray of the tile
    enters its widened box before that ray's far end (its best t, or for
    occlusion its t_max until it is blocked, then t_min - 1); children in
    near-to-far order by the tile's summed direction along the node's axis;
    internal children pushed far to near; the tile stops when every ray is
    blocked.  Returns (t, slot) for closest hit (``t_max`` None), else the
    blocked mask."""
    rows, anchor = wide_bvh.slot_rows(bvh)
    codes = bvh.wchild.view(-1, wide_bvh.ARITY).tolist()
    axes = bvh.waxis.tolist()
    tc, big = bvh.leaf_size, intersect.MISS_T
    closest = t_max is None
    outs = []
    for lo in range(0, o.x.shape[0], tile):
        ob, db = o.map(lambda c: c[lo:lo + tile]), d.map(lambda c: c[lo:lo + tile])
        n = ob.x.shape[0]
        org = (ob.x, ob.y, ob.z)
        rcp = tuple(torch.where(c < 0, -1.0, 1.0) / torch.clamp(c.abs(), min=1e-18)
                    for c in (db.x, db.y, db.z))
        low_first = [float(c.sum()) >= 0.0 for c in (db.x, db.y, db.z)]
        best = torch.full((n,), big)
        slot = torch.full((n,), -1, dtype=torch.int32)
        hi = None if closest else torch.as_tensor(t_max, dtype=torch.float32)[lo:lo + tile]
        blocked = torch.zeros((n,), dtype=torch.bool)
        stack, node = [], 0
        while node >= 0 and (closest or not bool(blocked.all())):
            t_far = best if closest else torch.where(blocked, t_min - 1.0, hi)
            live = []
            for k in range(wide_bvh.ARITY):
                code, b = codes[node][k], bvh.wbox[node, k]
                if code == -1:
                    live.append(False)
                    continue
                near, far_t = [], []
                for a in range(3):
                    p = (b[3 + a] - b[a]) * wide_bvh.BOX_PAD
                    t0 = ((b[a] - p) - org[a]) * rcp[a]
                    t1 = ((b[3 + a] + p) - org[a]) * rcp[a]
                    near.append(torch.minimum(t0, t1))
                    far_t.append(torch.maximum(t0, t1))
                tn = torch.clamp(torch.maximum(torch.maximum(near[0], near[1]), near[2]), min=t_min)
                tf = torch.minimum(torch.minimum(torch.minimum(far_t[0], far_t[1]), far_t[2]), t_far)
                live.append(bool((tn <= tf * wide_bvh.FAR_SCALE).any()))
            order = range(wide_bvh.ARITY) if low_first[axes[node]] else range(wide_bvh.ARITY - 1, -1, -1)
            for k in order:
                code = codes[node][k]
                if not live[k] or code > -2:
                    continue
                cols = slice((-2 - code) * tc, (-1 - code) * tc)
                t = intersect.pair_t(ob, db, rows[:, cols], t_min, big if closest else hi,
                                     anchor[:, cols])
                if closest:
                    cand, arg = torch.min(t, dim=1)
                    cand_slot = (arg + cols.start).int()
                    better = (cand < best) | ((cand == best) & (cand < big) & (cand_slot < slot))
                    best = torch.where(better, cand, best)
                    slot = torch.where(better, cand_slot, slot)
                else:
                    blocked |= (t < big).any(dim=1)
            stack += [codes[node][k] for k in reversed(order) if live[k] and codes[node][k] >= 0]
            node = stack.pop() if stack else -1
        outs.append((best, slot) if closest else blocked)
    if closest:
        return torch.cat([a for a, _ in outs]), torch.cat([b for _, b in outs])
    return torch.cat(outs)


def test_packet_walk_reaches_every_plain_hit():
    """Rays aimed just past the Cornell box's triangle edges (and the one
    that grazes the floor's open front edge) hit in the plain version; the
    streaming walk, with its tile-wide live mask, tile-summed order and
    widened slab, must give the same hits, and the same occlusion."""
    bvh, o, d = cornell_edge_rays(767, leaf_size=128)
    t_p, slot_p, hit_p = wide_bvh.closest_stream_plain(bvh, o, d)
    assert bool(hit_p[-1]) and int(hit_p.sum()) > 700
    t_w, slot_w = _packet_walk(bvh, o, d)
    assert torch.equal(t_w, t_p) and torch.equal(slot_w, slot_p)

    t_max = torch.where(hit_p, t_p * 1.001, 5.0)
    blocked = _packet_walk(bvh, o, d, t_max=t_max)
    assert torch.equal(blocked, wide_bvh.any_stream_plain(bvh, o, d, t_max=t_max))
    assert bool(blocked[-1])


def test_sort_key_matches_jax():
    """Bit-equal int32 keys on random origins (some outside the box, some
    parked far away), directions and active masks."""
    rng = np.random.default_rng(3)
    r = 4096
    org = rng.uniform(-3.0, 3.0, (r, 3)).astype(np.float32)
    org[rng.random(r) < 0.1] = 3.0e37  # parked lanes
    d = rng.normal(size=(r, 3)).astype(np.float32)
    d[rng.random((r, 3)) < 0.05] = 0.0  # +0 counts as the positive octant
    active = rng.random(r) < 0.7
    lo, hi = np.float32([-2.0, -1.0, -2.5]), np.float32([2.0, 2.5, 1.5])

    ref = jax_sort_key(v3(org), v3(d), jnp.asarray(active), jnp.asarray(lo), jnp.asarray(hi))
    key = integrator._wavefront_sort_key(
        _vec(org), _vec(d), torch.from_numpy(active), torch.from_numpy(lo), torch.from_numpy(hi)
    )
    assert key.dtype == torch.int32
    np.testing.assert_array_equal(key.numpy(), np.asarray(ref))


def test_select_backend_switches_past_250k_triangles():
    auto = RenderOptions()
    assert integrator._select_backend(auto, 250_000) == "wide"
    assert integrator._select_backend(auto, 250_001) == "stream"
    forced = RenderOptions(intersect_backend="stream")
    assert integrator._select_backend(forced, 4_000) == "stream"


def test_sorted_gated_render_equals_unsorted():
    """Cornell 16x16, depth 4: the bounce sort and segment gating permute
    per-lane work and skip only dead segments, so the accumulation is the
    same to the bit, and the ray count is the same."""
    size = 16
    scene = cornell_box(light="both", with_spheres=True)
    camera = orbit_camera(size, size, distance=6.2, focal_length_mm=35.0)
    zero = torch.zeros((4, size, size))
    out = {}
    for on in (False, True):
        opts = RenderOptions(width=size, height=size, max_render_passes=4, max_ray_depth=4,
                             sort_bounces=on, gate_bounces=on)
        ctx = integrator.make_context(opts, scene, device="cpu")
        assert integrator._bounce_modes(ctx, opts, size * size) == (on, on)
        out[on] = integrator.render_pass(scene, camera, ctx, opts, FrameGlobals.create(1), zero,
                                         with_stats=True)
    assert torch.equal(out[True][0], out[False][0])
    assert out[True][1] == out[False][1]


def test_auto_sorts_only_on_the_card():
    opts = RenderOptions(width=8, height=8)
    ctx = integrator.make_context(opts, cornell_box(), device="cpu")
    assert integrator._bounce_modes(ctx, opts, 64) == (False, False)
    assert ctx.accel_pack.backend == "wide"


@pytest.fixture(scope="module")
def jax_image(scenes):
    """The JAX package's brute-force render (unsorted) of ``high_poly`` at
    5,000 triangles, 16x16, depth 2, one pass (its JIT compile dominates
    this file's time), and the port's options of the same render."""
    ref, _ = scenes
    size = 16
    jax_opts = JaxRenderOptions(width=size, height=size, max_render_passes=4, max_ray_depth=2,
                                intersect_backend="xla", sort_bounces=False)
    jax_camera = jax_frame_scene(np.asarray(jax_scene_aabb(ref.geometry)), size, size, theta=0.35)
    jax_accum, _ = jax_render(ref, jax_camera, jax_opts, num_passes=1)
    opts = RenderOptions(width=size, height=size, max_render_passes=4, max_ray_depth=2,
                         intersect_backend="stream", sort_bounces=True, gate_bounces=True)
    return np.asarray(jax_resolve(jax_accum)), opts


def _port_render(scenes, opts):
    _, ours = scenes
    camera = frame_scene(scene_aabb(ours.geometry), opts.width, opts.height, theta=0.35)
    accum, ctx = integrator.render(ours, camera, opts, num_passes=1, device="cpu")
    img = resolve(accum).numpy()
    assert np.isfinite(img).all() and img.max() > 0.0
    return img, ctx.accel_pack


def test_high_poly_stream_render_matches_jax(scenes, jax_image):
    """``high_poly`` at 5,000 triangles, 16x16, depth 2, forced through the
    streaming backend (leaf 128), against the JAX package's brute-force
    render (unsorted) at ``test_small_render_matches_jax``'s tolerance."""
    ref_img, opts = jax_image
    img, pack = _port_render(scenes, opts)
    assert pack.backend == "stream" and pack.wide.leaf_size == 128
    np.testing.assert_allclose(img, ref_img, rtol=1e-3, atol=1e-4)


def test_high_poly_stream_vpu_render_matches_jax(scenes, jax_image):
    """Route B, ``stream_leaf_math="vpu"``: the same render through the
    transposed streaming kernels' queries (their plain versions here),
    against the same JAX render at the same tolerance."""
    ref_img, opts = jax_image
    img, pack = _port_render(scenes, dataclasses.replace(opts, stream_leaf_math="vpu"))
    assert (pack.route, pack.wide.leaf_size) == ("stream/vpu", 128)
    np.testing.assert_allclose(img, ref_img, rtol=1e-3, atol=1e-4)


def test_entry_points_default_to_the_card():
    """With no card, a call that names no device raises instead of
    rendering on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    scene = cornell_box()
    opts = RenderOptions(width=8, height=8)
    camera = orbit_camera(8, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        integrator.render(scene, camera, opts)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        integrator.make_context(opts, scene)
    from heatray_tpu_torch.bridge import camera_from_arrays

    with pytest.raises((RuntimeError, AssertionError)):
        camera_from_arrays({f.name: getattr(camera, f.name).numpy()
                            for f in dataclasses.fields(camera)})
