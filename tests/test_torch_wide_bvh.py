"""The port's wide BVH: the build against the JAX package's arrays, and the
plain closest/any-hit versions against the JAX oracles.  The CUDA kernels
are checked against the plain versions in test_torch_cuda.py."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from heatray_tpu.ops import build_woop as jax_build_woop
from heatray_tpu.ops import intersect_any as jax_intersect_any
from heatray_tpu.ops import intersect_closest as jax_intersect_closest
from heatray_tpu.ops.wide_bvh import build_wide_bvh as jax_build_wide_bvh
from heatray_tpu.ops.wide_bvh import intersect_any_wide as jax_any_wide
from heatray_tpu.ops.wide_bvh import intersect_closest_vpu as jax_closest_vpu
from heatray_tpu_torch.bridge import wide_bvh_from_arrays
from heatray_tpu_torch.ops import intersect, wide_bvh
from heatray_tpu_torch.utils.threads import share_cores
from heatray_tpu_torch.vec import Vec3

from test_bvh import make_rays, make_soup, planar, v3

share_cores(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))


def _soup(t, seed):
    """(JAX accel, port accel) of one numpy triangle soup."""
    positions, indices = make_soup(t, seed=seed)
    jax_accel = jax_build_woop(planar(positions), planar(indices))
    accel = intersect.build_woop(
        torch.from_numpy(np.ascontiguousarray(positions.T)),
        torch.from_numpy(np.ascontiguousarray(indices.T)),
    )
    return jax_accel, accel


def _rays(r, seed):
    """(JAX rays, port rays) from one numpy ray set."""
    orig, dirs = make_rays(r, seed=seed)
    jax_rays = (v3(planar(orig).T), v3(planar(dirs).T))

    def vec(a):
        return Vec3(*(torch.from_numpy(np.ascontiguousarray(a[:, k])) for k in range(3)))

    return jax_rays, (vec(orig), vec(dirs))


def test_build_woop_matches_jax():
    jax_accel, accel = _soup(500, 3)
    np.testing.assert_array_equal(accel.w.numpy(), np.asarray(jax_accel.w))
    np.testing.assert_array_equal(accel.tri_min.numpy(), np.asarray(jax_accel.tri_min))
    np.testing.assert_array_equal(accel.tri_max.numpy(), np.asarray(jax_accel.tri_max))
    # rsqrt may round differently by one ulp.
    np.testing.assert_allclose(
        accel.geo_normal.numpy(), np.asarray(jax_accel.geo_normal), rtol=0, atol=1e-6
    )


@pytest.mark.parametrize(
    "t, seed, leaf_size", [(500, 3, 16), (700, 11, 64), (300, 5, 32), (1500, 13, 128)]
)
def test_build_matches_jax(t, seed, leaf_size):
    jax_accel, accel = _soup(t, seed)
    ref = jax_build_wide_bvh(jax_accel, leaf_size=leaf_size, schedule="f32")
    ours = wide_bvh.build_wide_bvh(accel, leaf_size=leaf_size)
    for name in ("wbox", "wchild", "waxis", "w", "slot_tri", "wanchor"):
        np.testing.assert_array_equal(
            getattr(ours, name).numpy(), np.asarray(getattr(ref, name)), err_msg=name
        )
    assert (ours.leaf_size, ours.num_triangles) == (ref.leaf_size, ref.num_triangles)

    arrays = {f.name: np.asarray(getattr(ref, f.name)) for f in dataclasses.fields(ref)}
    boxes = {k: np.asarray(getattr(jax_accel, k)) for k in ("tri_min", "tri_max")}
    bridged = wide_bvh_from_arrays(arrays, ref.leaf_size, ref.num_triangles, boxes,
                                   device="cpu")
    for f in dataclasses.fields(ours):
        a, b = getattr(ours, f.name), getattr(bridged, f.name)
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b, f.name


def test_max_stack_depth_bounds_every_walk():
    """The recorded depth bounds the stack of walks in which every child of
    every node is live, in either push order, and is the tight bound over
    all orders: a node's own pushes on top of every other internal child
    of each of its ancestors."""
    _, accel = _soup(2000, 7)
    bvh = wide_bvh.build_wide_bvh(accel, leaf_size=8)
    codes = bvh.wchild.numpy().reshape(-1, wide_bvh.ARITY)
    for order in (1, -1):
        stack, node, deepest = [], 0, 0
        while node >= 0:
            stack.extend(int(c) for c in codes[node][::order] if c >= 0)
            deepest = max(deepest, len(stack))
            node = stack.pop() if stack else -1
        assert deepest <= bvh.max_stack

    def bound(node, below):
        kids = [int(c) for c in codes[node] if c >= 0]
        return max([below + len(kids)] + [bound(k, below + len(kids) - 1) for k in kids])

    assert bvh.max_stack == bound(0, 0) > wide_bvh.ARITY


@pytest.mark.parametrize("leaf_size", [16, 64])
def test_closest_plain_matches_xla(leaf_size):
    jax_accel, accel = _soup(700, 11)
    bvh = wide_bvh.build_wide_bvh(accel, leaf_size=leaf_size)
    (jo, jd), (o, d) = _rays(512, 7)

    t_ref, id_ref, _, hit_ref = (np.asarray(a) for a in jax_intersect_closest(jax_accel, jo, jd))
    t, slot, hit = wide_bvh.intersect_closest_wide(bvh, o, d)
    np.testing.assert_array_equal(hit.numpy(), hit_ref)
    m = hit_ref
    np.testing.assert_allclose(t.numpy()[m], t_ref[m], rtol=1e-5, atol=1e-5)
    assert (t.numpy()[~m] == intersect.MISS_T).all() and (slot.numpy()[~m] == -1).all()
    tri = bvh.slot_tri.numpy()[slot.numpy()[m]]
    assert (tri == id_ref[m]).mean() > 0.999


def test_closest_plain_matches_vpu_kernel():
    """Second oracle: the TPU VPU-leaf kernel in interpret mode.  Its pair
    test uses an approximate reciprocal, hence rtol 1e-4 on t."""
    jax_accel, accel = _soup(700, 11)
    ref_bvh = jax_build_wide_bvh(jax_accel, leaf_size=128, schedule="f32")
    bvh = wide_bvh.build_wide_bvh(accel, leaf_size=128)
    (jo, jd), (o, d) = _rays(512, 7)

    t_ref, slot_ref, hit_ref = (
        np.asarray(a)
        for a in jax_closest_vpu(ref_bvh, jo, jd, ray_tile=256, interpret=True, return_slots=True)
    )
    t, slot, hit = wide_bvh.intersect_closest_wide(bvh, o, d)
    np.testing.assert_array_equal(hit.numpy(), hit_ref)
    np.testing.assert_allclose(t.numpy()[hit_ref], t_ref[hit_ref], rtol=1e-4)
    assert (slot.numpy()[hit_ref] == slot_ref[hit_ref]).mean() > 0.999


def test_any_plain_matches_jax():
    jax_accel, accel = _soup(700, 13)
    ref_bvh = jax_build_wide_bvh(jax_accel, leaf_size=32, schedule="f32")
    bvh = wide_bvh.build_wide_bvh(accel, leaf_size=32)
    (jo, jd), (o, d) = _rays(512, 17)
    t_max = np.random.default_rng(0).uniform(1.0, 12.0, 512).astype(np.float32)

    blocked = wide_bvh.intersect_any_wide(bvh, o, d, t_max=torch.from_numpy(t_max))
    ref_kernel = jax_any_wide(ref_bvh, jo, jd, t_max=t_max, ray_tile=256, interpret=True)
    ref_brute = jax_intersect_any(jax_accel, jo, jd, t_max=t_max)
    np.testing.assert_array_equal(blocked.numpy(), np.asarray(ref_kernel))
    np.testing.assert_array_equal(blocked.numpy(), np.asarray(ref_brute))
    assert 0 < blocked.sum() < 512


def test_triangle_order_queries_match_jax():
    """The port's brute-force pair over triangle-ordered Woop rows."""
    jax_accel, accel = _soup(400, 19)
    (jo, jd), (o, d) = _rays(256, 23)
    t_ref, id_ref, _, hit_ref = (np.asarray(a) for a in jax_intersect_closest(jax_accel, jo, jd))
    t, tri, hit = intersect.intersect_closest(accel, o, d)
    np.testing.assert_array_equal(hit.numpy(), hit_ref)
    np.testing.assert_allclose(t.numpy()[hit_ref], t_ref[hit_ref], rtol=1e-5, atol=1e-5)
    assert (tri.numpy()[hit_ref] == id_ref[hit_ref]).mean() > 0.999
    blocked = intersect.intersect_any(accel, o, d, t_max=4.0)
    np.testing.assert_array_equal(
        blocked.numpy(), np.asarray(jax_intersect_any(jax_accel, jo, jd, t_max=4.0))
    )


def _reachable_leaves(bvh, o, d, pad, far):
    """(R, C): which leaf chunks the kernels' slab tests let each ray reach
    (their float32 arithmetic in their order, without pruning by the best
    hit so far)."""
    def inv(v):
        return torch.where(v < 0, -1.0, 1.0) / torch.clamp(v.abs(), min=1e-18)

    org, rcp = (o.x, o.y, o.z), (inv(d.x), inv(d.y), inv(d.z))
    codes = bvh.wchild.view(-1, wide_bvh.ARITY)
    node_ok = torch.zeros((o.x.shape[0], bvh.num_nodes), dtype=torch.bool)
    node_ok[:, 0] = True
    leaf_ok = torch.zeros((o.x.shape[0], bvh.num_chunks), dtype=torch.bool)
    for n in range(bvh.num_nodes):  # a child's id is larger than its parent's
        for k in range(wide_bvh.ARITY):
            code, b = int(codes[n, k]), bvh.wbox[n, k]
            if code == -1:
                continue
            near, far_t = [], []
            for a in range(3):
                p = (b[3 + a] - b[a]) * pad
                t0 = ((b[a] - p) - org[a]) * rcp[a]
                t1 = ((b[3 + a] + p) - org[a]) * rcp[a]
                near.append(torch.minimum(t0, t1))
                far_t.append(torch.maximum(t0, t1))
            tn = torch.clamp(torch.maximum(torch.maximum(near[0], near[1]), near[2]), min=1e-4)
            tf = torch.clamp(torch.minimum(torch.minimum(far_t[0], far_t[1]), far_t[2]), max=3e38)
            ok = node_ok[:, n] & (tn <= tf * far)
            if code >= 0:
                node_ok[:, code] |= ok
            else:
                leaf_ok[:, -2 - code] |= ok
    return leaf_ok


def cornell_edge_rays(n, leaf_size):
    """The Cornell box's tree at ``leaf_size`` and ``n`` rays aimed just past
    its triangles' edges (up to 1.5e-6 outside, in barycentric units), then
    one that grazes the floor's open front edge in the 48x48 config2
    render: (bvh, origins, directions)."""
    from heatray_tpu_torch import cornell_box

    scene = cornell_box(light="both", with_spheres=True)
    accel = intersect.build_woop(scene.geometry.positions, scene.geometry.indices)
    bvh = wide_bvh.build_wide_bvh(accel, leaf_size=leaf_size)

    rng = np.random.default_rng(5)
    pos = scene.geometry.positions.double().numpy()
    tri = scene.geometry.indices.long().numpy()[:, rng.integers(0, accel.num_triangles, n)]
    v0, v1, v2 = (pos[:, tri[k]].T for k in range(3))
    s = rng.uniform(0.0, 1.0, (tri.shape[1], 1))
    out = rng.uniform(0.0, 1.5e-6, (tri.shape[1], 1))
    target = v0 + s * (v1 - v0) - out * (v2 - v0)
    origin = rng.uniform(-1.9, 1.9, target.shape)
    dirs = target - origin
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    floor_edge = ([1.999899983406067, 0.021646535024046898, 0.026903629302978516],
                  [-0.643088698387146, -0.5480369329452515, 0.5348762273788452])
    origin = np.vstack([origin, floor_edge[0]]).astype(np.float32)
    dirs = np.vstack([dirs, floor_edge[1]]).astype(np.float32)
    o = Vec3(*(torch.from_numpy(origin[:, k].copy()) for k in range(3)))
    d = Vec3(*(torch.from_numpy(dirs[:, k].copy()) for k in range(3)))
    return bvh, o, d


def test_widened_slab_reaches_every_plain_hit():
    """The pair test accepts hits up to BARY_EPS outside a triangle, so
    outside its box.  Rays aimed just past the Cornell box's triangle edges
    hit in the plain version; the kernels' widened slab test must reach
    every such leaf, where an exact one culls some."""
    bvh, o, d = cornell_edge_rays(2047, leaf_size=32)
    _, slot, hit = wide_bvh.closest_wide_plain(bvh, o, d)
    rays = hit.nonzero()[:, 0]
    leaf = slot[rays].long() // bvh.leaf_size
    assert hit[-1]

    def culled(pad, far):
        return ~_reachable_leaves(bvh, o, d, pad, far)[rays, leaf]

    assert not culled(wide_bvh.BOX_PAD, wide_bvh.FAR_SCALE).any()
    exact = culled(0.0, 1.0)
    assert exact[-1] and exact.sum() > 1


def test_cpu_wrappers_take_the_plain_versions():
    _, accel = _soup(300, 5)
    bvh = wide_bvh.build_wide_bvh(accel, leaf_size=32)
    _, (o, d) = _rays(128, 3)
    before = (wide_bvh.intersect_closest_wide.launches, wide_bvh.intersect_any_wide.launches)
    got = wide_bvh.intersect_closest_wide(bvh, o, d)
    want = wide_bvh.closest_wide_plain(bvh, o, d)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(
        wide_bvh.intersect_any_wide(bvh, o, d, t_max=3.0),
        wide_bvh.any_wide_plain(bvh, o, d, t_max=3.0),
    )
    after = (wide_bvh.intersect_closest_wide.launches, wide_bvh.intersect_any_wide.launches)
    assert after == before
