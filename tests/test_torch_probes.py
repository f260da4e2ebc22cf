"""The port's traversal probes (``heatray_tpu_torch.probes``) against the
reference probe kernels of the root scripts ``tpu_visit_stats.py`` (P3),
``tpu_kernel_probe.py`` (P1), ``tpu_vpu_leaf.py`` (P4) and
``tpu_kernel_variants_probe.py`` (P2), on the Cornell box.

The scripts build a 1080p scene when imported, so they are not imported:
only their ``import`` statements and the kernels' ``def``s (and the few
statements named below) are taken from their source with ``ast`` and run in
a namespace whose ``pl`` is the Pallas module with ``pallas_call`` in
interpret mode.  Nothing in the reference changes.

Every input is made from a numpy seed and handed to both packages.  The
plain versions are checked here; the CUDA kernels against them in
test_torch_cuda.py and chip_smoke.py.
"""

import ast
import dataclasses
import functools
import os
import re
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heatray_tpu.ops import build_woop as jax_build_woop
from heatray_tpu.ops.intersect_pallas import _pack_rays, _rays_spec, _row_spec
from heatray_tpu.ops.wide_bvh import _smem_spec
from heatray_tpu.ops.wide_bvh import build_wide_bvh as jax_build_wide_bvh
from heatray_tpu.vec import Vec3 as JaxVec3
from heatray_tpu_torch import cornell_box
from heatray_tpu_torch.bridge import wide_bvh_from_arrays
from heatray_tpu_torch.ops import intersect, wide_bvh
from heatray_tpu_torch.ops.intersect import MISS_T
from heatray_tpu_torch.probes import kernel_probe, kernel_variants, visit_stats, vpu_leaf
from heatray_tpu_torch.utils.threads import share_cores
from heatray_tpu_torch.vec import Vec3

share_cores(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))


REPO = Path(__file__).resolve().parents[1]
T_MIN = 1e-4


class _Interpret:
    """The Pallas module, with every ``pallas_call`` in interpret mode."""

    def __init__(self, pl):
        self._pl = pl

    def __getattr__(self, name):
        return getattr(self._pl, name)

    def pallas_call(self, *args, **kwargs):
        return self._pl.pallas_call(*args, interpret=True, **kwargs)


def _reference(script, defs=(), statements=None, env=None):
    """Run the imports, the ``defs`` and the top-level statements from line
    ``statements[0]`` to ``statements[1]`` of a root probe script in a fresh
    namespace (``env`` first), its ``pl`` in interpret mode."""
    tree = ast.parse((REPO / script).read_text())
    keep = []
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            keep.append(node)
        elif isinstance(node, ast.FunctionDef) and node.name in defs:
            keep.append(node)
        elif statements and statements[0] <= node.lineno <= statements[1]:
            keep.append(node)
    ns = dict(env or {}, __name__=f"reference_{Path(script).stem}")
    exec(compile(ast.Module(body=keep, type_ignores=[]), script, "exec"), ns)
    ns["pl"] = _Interpret(ns["pl"])
    return ns


def _line(script, text):
    """The line number of the first line of ``script`` that starts with ``text``."""
    lines = (REPO / script).read_text().splitlines()
    return next(i + 1 for i, s in enumerate(lines) if s.startswith(text))


@pytest.fixture(scope="module")
def cornell():
    """The Cornell box in both packages, from the same numpy arrays: (port
    scene, JAX accel, port accel)."""
    scene = cornell_box(light="both", with_spheres=True)
    pos, idx = scene.geometry.positions.numpy(), scene.geometry.indices.numpy()
    jax_accel = jax_build_woop(jnp.asarray(pos), jnp.asarray(idx))
    accel = intersect.build_woop(torch.from_numpy(pos.copy()), torch.from_numpy(idx.copy()))
    return scene, jax_accel, accel


def _cornell_rays(n, seed):
    """Half the rays start inside the box in random directions (bounce-like),
    half near the camera aimed at random points inside it: (JAX rays, port
    rays)."""
    rng = np.random.default_rng(seed)
    inner = rng.uniform(-1.9, 1.9, (n // 2, 3))
    d_inner = rng.normal(size=(n // 2, 3))
    cam = np.array([0.0, 0.0, 6.2]) + rng.uniform(-0.5, 0.5, (n - n // 2, 3))
    d_cam = rng.uniform(-1.9, 1.9, cam.shape) - cam
    org = np.concatenate([inner, cam]).astype(np.float32)
    dirs = np.concatenate([d_inner, d_cam])
    dirs = (dirs / np.linalg.norm(dirs, axis=1, keepdims=True)).astype(np.float32)
    port = (Vec3(*(torch.from_numpy(org[:, k].copy()) for k in range(3))),
            Vec3(*(torch.from_numpy(dirs[:, k].copy()) for k in range(3))))
    return (JaxVec3.from_array(jnp.asarray(org)), JaxVec3.from_array(jnp.asarray(dirs))), port


def _row_call(ns, kernel, rays, inputs, rt, in_specs=(), scratch_shapes=()):
    """A probe kernel with a (1, R) row out, over the packed rays and
    ``inputs`` (their specs ``in_specs``)."""
    jo, jd = rays
    packed, n_tiles, r = _pack_rays(jo, jd, rt)
    f = ns["pl"].pallas_call(
        kernel,
        grid=(n_tiles,),
        in_specs=[_rays_spec(rt), *in_specs],
        out_specs=_row_spec(rt),
        out_shape=jax.ShapeDtypeStruct((1, n_tiles * rt), jnp.float32),
        scratch_shapes=list(scratch_shapes),
    )
    return np.asarray(f(packed, *inputs)[0, :r])


def _vmem(ns):
    return ns["pl"].BlockSpec(memory_space=ns["pltpu"].VMEM)


# --- P3 ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def p3(cornell):
    """The reference's ``visit_stats`` and seed, the JAX fused tree and the
    port's f32 tree of the same build, and 2,048 rays (8 tiles)."""
    scene, jax_accel, accel = cornell
    start = _line("tpu_visit_stats.py", "SEED_K = 32")
    stop = _line("tpu_visit_stats.py", "seed_anchor = jnp.asarray")
    ns = _reference(
        "tpu_visit_stats.py", ("_stats_kernel", "visit_stats"), (start, stop),
        env={"scene": _jax_scene(scene), "pack": types.SimpleNamespace(accel=jax_accel)},
    )
    fused = jax_build_wide_bvh(jax_accel, leaf_size=32)
    f32 = jax_build_wide_bvh(jax_accel, leaf_size=32, schedule="f32")
    arrays = {f.name: np.asarray(getattr(f32, f.name)) for f in dataclasses.fields(f32)}
    boxes = {k: np.asarray(getattr(jax_accel, k)) for k in ("tri_min", "tri_max")}
    bvh = wide_bvh_from_arrays(arrays, f32.leaf_size, f32.num_triangles, boxes, device="cpu")
    assert np.array_equal(np.asarray(fused.wchild), np.asarray(f32.wchild))
    return ns, fused, bvh, _cornell_rays(2048, 3)


def _jax_scene(scene):
    """What the reference's seed block reads of a scene: ``geometry.positions``
    indexable by axis and ``geometry.indices``."""
    geom = types.SimpleNamespace(positions=jnp.asarray(scene.geometry.positions.numpy()),
                                 indices=jnp.asarray(scene.geometry.indices.numpy()))
    return types.SimpleNamespace(geometry=geom)


def test_seed_chunk_matches_reference(p3, cornell):
    """``seed_chunk`` is the reference's numpy build of the horizon seed:
    equal to the bit."""
    ns = p3[0]
    scene, _, accel = cornell
    seed_w, seed_anchor, share = visit_stats.seed_chunk(scene, accel, ns["SEED_K"])
    np.testing.assert_array_equal(seed_w.numpy(), np.asarray(ns["seed_w"]))
    np.testing.assert_array_equal(seed_anchor.numpy(), np.asarray(ns["seed_anchor"]))
    assert 0.5 < share < 1.0


@pytest.mark.parametrize("seed_k", [0, 32])
def test_visit_stats_plain_matches_reference(p3, cornell, seed_k):
    """Per-tile node, leaf and improving counts and overlap sums of the
    plain walk against ``_stats_kernel`` in interpret mode, over 8 tiles.

    Unseeded, all four are equal on every tile.  Seeded, node and leaf
    visits are equal on every tile, but a ray whose seeded best t lies on a
    wall sits on the edge of that wall's leaf box: the reference's bf16x3 t
    falls on either side of the exact one and its unwidened box (F2, F5)
    then culls the leaf for some of those rays, where the port's widened box
    keeps every one.  So the port's overlap sums are at least the
    reference's and at most 20% above them (found: 13%), and its improving
    visits within 10% of the reference's (found: 7% fewer; a leaf's t and
    the seed's, anchored differently, round apart in bf16x3)."""
    ns, fused, bvh, ((jo, jd), (o, d)) = p3
    scene, _, accel = cornell
    seed_w, seed_anchor, _ = visit_stats.seed_chunk(scene, accel)
    ref = ns["visit_stats"](fused, jo, jd, jnp.asarray(seed_w.numpy()),
                            jnp.asarray(seed_anchor.numpy()), ray_tile=256, seed_k=seed_k)
    ref = np.stack([np.asarray(a, np.float64) for a in ref])
    ours = np.stack([a.double().numpy() for a in visit_stats.visit_stats(
        bvh, o, d, seed_w, seed_anchor, seed_k=seed_k)])
    assert ours.shape == ref.shape == (4, 8)
    assert ours[1].sum() > ours[0].sum() > 8 and 0 < ours[3].sum() < ours[1].sum()
    if not seed_k:
        np.testing.assert_array_equal(ours, ref)
        return
    np.testing.assert_array_equal(ours[:2], ref[:2])
    assert (ours[2] >= ref[2]).all() and ours[2].sum() <= 1.2 * ref[2].sum()
    assert abs(ours[3].sum() - ref[3].sum()) <= 0.1 * ref[3].sum()


def test_visit_stats_seed_lowers_improving_visits(p3, cornell):
    """Seeding cannot open a leaf the unseeded walk skips (every ray's best t
    only falls), and it makes fewer leaf visits improve some ray."""
    _, _, bvh, (_, (o, d)) = p3
    scene, _, accel = cornell
    seed_w, seed_anchor, _ = visit_stats.seed_chunk(scene, accel)
    plain = visit_stats.visit_stats(bvh, o, d)
    seeded = visit_stats.visit_stats(bvh, o, d, seed_w, seed_anchor, seed_k=32)
    assert (seeded[1] <= plain[1]).all() and (seeded[0] <= plain[0]).all()
    assert seeded[3].sum() < plain[3].sum()


def test_visit_stats_work_counts(p3):
    """The work the counts need, per tile: each visited node's filled
    children times the tile's 256 rays; each opened leaf's filled triangles
    times the rays that entered it (so between the overlap share times the
    fewest and the most filled triangles of a leaf, times 256); and of those
    pairs, the ones in range, at least one for each ray that hits."""
    _, _, bvh, (_, (o, d)) = p3
    nodes, _, overlap, _, work = visit_stats.visit_stats(bvh, o, d, work=True)
    box_tests, pair_tests, in_range = work.double().T
    filled = (bvh.wchild.view(-1, wide_bvh.ARITY) != -1).sum(dim=1)
    fill = (bvh.slot_tri.view(-1, bvh.leaf_size) >= 0).sum(dim=1)
    entered = overlap.double() * 256
    assert int(fill.min()) < bvh.leaf_size
    assert (box_tests >= 256 * int(filled.min()) * nodes).all()
    assert (box_tests <= 256 * int(filled.max()) * nodes).all()
    assert (pair_tests >= entered * int(fill.min())).all()
    assert (pair_tests <= entered * bvh.leaf_size).all()
    hits = (wide_bvh.closest_wide_plain(bvh, o, d)[0] < MISS_T).view(-1, 256).sum(dim=1)
    assert (in_range >= hits).all() and (in_range < pair_tests).all() and hits.sum() > 0


@pytest.mark.parametrize("every_ray", [False, True])
def test_group_walk_gives_the_plain_hits(p3, every_ray):
    """The block walk, with every ray of a block tested at each opened leaf
    (K3, P3) or only the rays that enter it (K4): t and slots of the brute
    force bit for bit; the skip skips only in the second."""
    _, _, bvh, (_, (o, d)) = p3
    (t, slot), stats = visit_stats.group_walk(bvh, o, d, 256, every_ray=every_ray)
    t_p, slot_p, _ = wide_bvh.closest_wide_plain(bvh, o, d)
    assert torch.equal(t, t_p) and torch.equal(slot, slot_p)
    assert (stats[:, 4].sum() == 0) == every_ray


@pytest.fixture(scope="module")
def entering_cases():
    """The cases of the rule P3's kernel serves its leaves by: the Cornell
    box's primary rays and first-bounce wavefront at 32x32 over its leaf-32
    tree, with its seed chunk; and a seeded soup of 400 triangles whose
    rays partly miss every box.  Port only: no JAX compile."""
    from heatray_tpu_torch.options import FrameGlobals
    from heatray_tpu_torch.render import integrator

    scene, camera, opts, ctx, tree = visit_stats.setup("cornell", 32, 32, 2, torch.device("cpu"))
    seed_w, seed_anchor, _ = visit_stats.seed_chunk(scene, ctx.accel_pack.accel)
    primary = integrator.start_paths(camera, ctx, opts, 0)
    bounced, _ = integrator.bounce(scene, ctx, opts, FrameGlobals.create(0), 1, primary,
                                   ctx.accel_pack)
    rng = np.random.default_rng(19)
    centre = rng.uniform(-1.0, 1.0, (400, 3))
    pos = np.concatenate([centre + rng.uniform(-0.15, 0.15, (400, 3)) for _ in range(3)])
    idx = np.arange(1200).reshape(3, 400)
    geometry = types.SimpleNamespace(positions=torch.from_numpy(pos.T.astype(np.float32).copy()),
                                     indices=torch.from_numpy(idx.astype(np.int32)))
    accel = intersect.build_woop(geometry.positions, geometry.indices)
    soup = wide_bvh.build_wide_bvh(accel, leaf_size=32)
    soup_seed = visit_stats.seed_chunk(types.SimpleNamespace(geometry=geometry), accel)[:2]
    n = 640
    org = np.concatenate([rng.uniform(-1.0, 1.0, (n // 2, 3)),
                          rng.uniform(-1.0, 1.0, (n // 2, 3)) + np.array([0.0, 0.0, 4.0])])
    aim = rng.uniform(-1.0, 1.0, (n, 3)) - org
    aim[n // 2 + n // 4:] *= -1.0  # a quarter of the rays leave the soup's box
    aim /= np.linalg.norm(aim, axis=1, keepdims=True)
    rays = tuple(Vec3(*(torch.from_numpy(a[:, k].astype(np.float32).copy()) for k in range(3)))
                 for a in (org, aim))
    return {"primary": (tree, primary.org, primary.direction, (seed_w, seed_anchor)),
            "bounce": (tree, bounced.org, bounced.direction, (seed_w, seed_anchor)),
            "soup": (soup, *rays, soup_seed)}


@pytest.mark.parametrize("case", ["primary", "bounce", "soup"])
@pytest.mark.parametrize("seeded", [False, True])
def test_entering_rays_alone_give_the_counts(entering_cases, case, seeded):
    """A ray whose own slab did not enter a leaf's widened box cannot lower
    its best t there (ROADMAP F5), so serving each opened leaf only to the
    rays that entered it (P3's kernel) gives the four counts, the three work
    counts and every ray's t and slot of testing every ray (its plain
    version); and it skips pairs."""
    tree, o, d, seed = entering_cases[case]
    seed = seed if seeded else None
    (t, slot), every = visit_stats.group_walk(tree, o, d, 256, every_ray=True, seed=seed)
    (t_e, slot_e), entering = visit_stats.group_walk(tree, o, d, 256, every_ray=False, seed=seed)
    keep = [0, 1, 2, 3, 5, 6, 7]
    assert torch.equal(entering[:, keep], every[:, keep])
    assert torch.equal(t_e, t) and torch.equal(slot_e, slot)
    assert float(entering[:, 4].sum()) > 0 and float(every[:, 4].sum()) == 0
    assert float(every[:, 3].sum()) > 0 and float(every[:, 7].sum()) > 0
    if case == "soup":
        assert 0 < int((t == MISS_T).sum()) < t.numel()


def test_group_signs_follow_the_kernels_sum_order():
    """A block whose directions sum to exactly 0 (so +axis), but to -2^-23
    in the kernels' float32 order (a butterfly within each warp of 32, then
    the warps in turn): the signs are the kernels'."""
    v = torch.zeros(256)
    v[0], v[1], v[2], v[32] = 2.0**-24, 2.0**-24, 1.0, -(1.0 + 2.0**-23)
    assert float(v.double().sum()) == 0.0
    assert visit_stats.group_signs(Vec3(v, v, -v)) == [False, False, True]


# --- P1 ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def p1():
    return _reference("tpu_kernel_probe.py",
                      ("_nodes_kernel", "_leaves_kernel", "_empty_kernel", "run_probe"))


@pytest.fixture(scope="module")
def rays512():
    return _cornell_rays(512, 11)


def test_nodes_matches_reference(p1, cornell, rays512):
    """``_nodes_kernel`` writes t = MISS_T for every ray, as ``node_walk``
    does.  Its walk is counted here: a callback at each of its node
    iterations (its one ``_children_slab`` call) gives the nodes it visits
    per tile of 64 rays, which must equal the nodes that some ray of the
    tile reaches in a widened-slab walk written out here in numpy; each
    ray's count in that walk must equal ``node_walk``'s visits."""
    _, jax_accel, accel = cornell
    (jo, jd), (o, d) = rays512
    rt = 64
    ns = dict(p1)
    visited = {}  # the origin x of a tile's first ray -> node iterations

    def counted(boxes, rays, *args):
        jax.debug.callback(lambda x: visited.update({float(x): visited.get(float(x), 0) + 1}),
                           rays[0, 0])
        return p1["_children_slab"](boxes, rays, *args)

    ns["_children_slab"] = counted
    kernel = types.FunctionType(p1["_nodes_kernel"].__code__, ns)
    jbvh = jax_build_wide_bvh(jax_accel, leaf_size=32)
    pltpu = ns["pltpu"]
    ref = _row_call(ns, functools.partial(kernel, T_MIN), (jo, jd),
                    (jbvh.wbox, jbvh.wchild, jbvh.waxis), rt,
                    (_vmem(ns), _smem_spec(), _smem_spec()),
                    (pltpu.SMEM((ns["STACK_DEPTH"],), jnp.int32), pltpu.VMEM((1, rt), jnp.float32)))
    bvh = wide_bvh.build_wide_bvh(accel, leaf_size=32)
    t, visits = kernel_probe.node_walk(bvh, o, d)
    np.testing.assert_array_equal(t.numpy(), ref)
    assert (ref == np.float32(MISS_T)).all()
    reach = _reach(bvh, o, d)
    np.testing.assert_array_equal(visits.numpy(), reach.sum(axis=1))
    first_x = o.x.numpy()[::rt]
    per_tile = [visited[float(x)] for x in first_x]
    assert len(visited) == len(first_x)
    assert per_tile == [int(reach[i:i + rt].any(axis=0).sum()) for i in range(0, 512, rt)]
    assert int(visits.min()) >= 1 and int(visits.max()) > 5


def _reach(bvh, o, d):
    """(rays, nodes) bool: does each ray reach each node, its widened slab
    (boxes grown by BOX_PAD, the far end by FAR_SCALE, no hit to cull by)
    entering the node's box and every box above it.  Plain numpy float32."""
    codes, box = bvh.wchild.view(-1, wide_bvh.ARITY).numpy(), bvh.wbox.numpy()
    org = np.stack([o.x.numpy(), o.y.numpy(), o.z.numpy()])
    dirs = np.stack([d.x.numpy(), d.y.numpy(), d.z.numpy()])
    one = np.float32(1.0)
    rcp = np.where(dirs < 0, -one, one) / np.maximum(np.abs(dirs), np.float32(1e-18))
    pad, scale = np.float32(wide_bvh.BOX_PAD), np.float32(wide_bvh.FAR_SCALE)
    reach = np.zeros((org.shape[1], codes.shape[0]), bool)
    reach[:, 0] = True
    todo = [0]
    while todo:
        node = todo.pop()
        for k, code in enumerate(codes[node]):
            if code < 0:
                continue
            lo, hi = box[node, k, 0:3, None], box[node, k, 3:6, None]
            p = (hi - lo) * pad
            t0, t1 = ((lo - p) - org) * rcp, ((hi + p) - org) * rcp
            near = np.minimum(t0, t1).max(axis=0)
            far = np.maximum(t0, t1).min(axis=0)
            enters = np.maximum(near, np.float32(T_MIN)) <= np.minimum(far, np.float32(MISS_T)) * scale
            reach[:, code] = reach[:, node] & enters
            todo.append(code)
    return reach


def test_leaves_matches_reference(p1, cornell, rays512):
    """``_leaves_kernel`` over the un-anchored chunk pack of P4 (the layout
    its pair test reads) against the port's ``leaves`` over the anchored
    tree with its anchors: hit masks equal, t at rtol 1e-4 (the reference's
    approximate reciprocal), and ``leaves`` equal to the tree's brute force
    ``closest_wide_plain``."""
    _, jax_accel, accel = cornell
    (jo, jd), (o, d) = rays512
    ns = p1
    p4 = _reference("tpu_vpu_leaf.py", ("pack_chunks",))
    w = p4["pack_chunks"](jax_accel, 32)
    kernel = functools.partial(ns["_leaves_kernel"], 32, w.shape[0], T_MIN)
    ref = _row_call(ns, kernel, (jo, jd), (w,), 256,
                    (_vmem(ns),))
    bvh = wide_bvh.build_wide_bvh(accel, leaf_size=32)
    t = kernel_probe.leaves(bvh, o, d).numpy()
    hit = ref < MISS_T
    np.testing.assert_array_equal(t < MISS_T, hit)
    np.testing.assert_allclose(t[hit], ref[hit], rtol=1e-4)
    np.testing.assert_array_equal(t, wide_bvh.closest_wide_plain(bvh, o, d)[0].numpy())
    assert 100 < hit.sum() < 512


def test_reference_leaves_probe_raises(p1, cornell, rays512):
    """The reference's own ``leaves`` probe, over the tree its ``run_probe``
    builds (the default fused schedule), raises: ``_pair_hits`` contracts
    4 rows of a (12, 3 Tc) bf16 chunk."""
    _, jax_accel, _ = cornell
    (jo, jd), _ = rays512
    ns = dict(p1, org=jo, dirn=jd)
    fused = jax_build_wide_bvh(jax_accel, leaf_size=32)
    probe = types.FunctionType(p1["run_probe"].__code__, ns)
    with pytest.raises(TypeError, match="contracting dimensions"):
        probe("leaves", fused, 256)()


def test_reference_leaves_probe_ignores_anchors(p1, cornell, rays512):
    """Fed a ``schedule="f32"`` tree instead, ``_leaves_kernel`` runs but
    tests the anchor-centred rows against uncentred origins: it loses hits
    the tree's brute force finds (390 of 475 here), where the port's
    ``leaves`` equals that brute force."""
    _, jax_accel, accel = cornell
    (jo, jd), (o, d) = rays512
    f32 = jax_build_wide_bvh(jax_accel, leaf_size=32, schedule="f32")
    kernel = functools.partial(p1["_leaves_kernel"], 32, f32.num_chunks, T_MIN)
    ref = _row_call(p1, kernel, (jo, jd), (f32.w,), 256,
                    (_vmem(p1),))
    exact = wide_bvh.closest_wide_plain(wide_bvh.build_wide_bvh(accel, leaf_size=32), o, d)[0]
    assert int((ref < MISS_T).sum()) < int((exact < MISS_T).sum()) - 50
    np.testing.assert_array_equal(kernel_probe.leaves(
        wide_bvh.build_wide_bvh(accel, leaf_size=32), o, d).numpy(), exact.numpy())


def test_empty_matches_reference(p1, rays512):
    (jo, jd), (o, _) = rays512
    ref = _row_call(p1, p1["_empty_kernel"], (jo, jd), (), 256)
    np.testing.assert_array_equal(kernel_probe.empty(o).numpy(), ref)


def test_empty_keeps_special_values_like_reference(p1):
    """``empty_plain`` against ``_empty_kernel`` in interpret mode on origins
    x of -1, -0, 0, +-inf, NaN and +-3e37, bit for bit: the sign of a zero
    product and the NaN of inf * 0 included."""
    x = np.array([-1.0, -0.0, 0.0, np.inf, -np.inf, np.nan, 3e37, -3e37], np.float32)
    org = np.stack([np.tile(x, 4), np.zeros(32), np.ones(32)], axis=1).astype(np.float32)
    dirs = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (32, 1))
    ref = _row_call(p1, p1["_empty_kernel"], (JaxVec3.from_array(jnp.asarray(org)),
                                              JaxVec3.from_array(jnp.asarray(dirs))), (), 256)
    got = kernel_probe.empty(Vec3(*(torch.from_numpy(org[:, k].copy()) for k in range(3)))).numpy()
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    zeros = [0, 1, 2, 6, 7]
    assert (got[zeros] == 0).all() and np.signbit(got[zeros]).tolist() == [True, True, False,
                                                                           False, True]
    assert np.isnan(got[3:6]).all()


# --- P4 ------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["row", "warp"])
def test_brute_layouts_match_reference(cornell, rays512, layout):
    """``_mxu_kernel`` at HIGHEST (row) and ``_vpu_kernel`` (warp-transposed)
    in interpret mode against ``rows_closest`` and ``warp_closest`` over the
    port's own ``pack_chunks`` (equal to the reference's): hit masks equal,
    t at rtol 1e-4 (the reference's approximate reciprocal in the row
    layout; the transposed one divides exactly, and agrees to 1e-6)."""
    _, jax_accel, accel = cornell
    (jo, jd), (o, d) = rays512
    ns = _reference("tpu_vpu_leaf.py", ("pack_chunks", "_mxu_kernel", "_vpu_pair_hits_t",
                                        "_vpu_kernel"), env={})
    ns["_DZ_EPS"], ns["_BARY_EPS"] = 1e-15, 1e-6
    tc = 128
    w_ref = ns["pack_chunks"](jax_accel, tc)
    w = vpu_leaf.pack_chunks(accel, tc)
    np.testing.assert_array_equal(w.numpy(), np.asarray(w_ref))
    if layout == "row":
        kernel = functools.partial(ns["_mxu_kernel"], tc, w.shape[0], T_MIN,
                                   jax.lax.Precision.HIGHEST)
        t = vpu_leaf.rows_closest(w, o, d).numpy()
    else:
        kernel = functools.partial(ns["_vpu_kernel"], tc, w.shape[0], T_MIN)
        t = vpu_leaf.warp_closest(w, o, d).numpy()
    ref = _row_call(ns, kernel, (jo, jd), (w_ref,), 256,
                    (_vmem(ns),))
    hit = ref < MISS_T
    np.testing.assert_array_equal(t < MISS_T, hit)
    np.testing.assert_allclose(t[hit], ref[hit], rtol=1e-4 if layout == "row" else 1e-6)
    assert 100 < hit.sum() < 512


def _cu_constant(source, name):
    """A ``constexpr int`` of a CUDA source of the port."""
    text = (REPO / "heatray_tpu_torch" / "csrc" / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def _warp_schedule_t(w, o, d, anchor, ray_tile, t_min=T_MIN):
    """A model of ``warp_brute_kernel``'s schedule (``csrc/probes.cu``, its
    constants read from the source): per tile of ``ray_tile`` rays (the
    last one partial), the (slice of one chunk, part of the rays) units,
    slice-major, in equal runs over the block's warps, the warps taking one
    unit each in turn; each unit's pairs culled by each ray's best t as the
    units before it left it.  Returns (t, the units that culled by a bound
    below MISS_T)."""
    lane_cols, threads, part = (_cu_constant("probes.cu", n)
                                for n in ("kWarpCols", "kWarpThreads", "kPartRays"))
    warps, slice_cols = threads // 32, 32 * lane_cols
    n_chunks, tc = w.shape[0], w.shape[2] // 3
    rows = intersect.chunk_rows(w)
    anchor = torch.zeros((3, n_chunks)) if anchor is None else anchor
    per_chunk = -(-tc // slice_cols)
    out, culled = [], 0
    for base in range(0, o.x.numel(), ray_tile):
        n = min(ray_tile, o.x.numel() - base)
        parts = -(-n // part)
        units = n_chunks * per_chunk * parts
        runs = [range(k * units // warps, (k + 1) * units // warps) for k in range(warps)]
        best = torch.full((n,), MISS_T)
        for step in range(max(len(run) for run in runs)):
            for run in runs:
                if step >= len(run):
                    continue
                piece, part_no = divmod(run[step], parts)
                chunk, k = divmod(piece, per_chunk)
                lo, hi = k * slice_cols, min(tc, (k + 1) * slice_cols)
                cols = slice(chunk * tc + lo, chunk * tc + hi)
                rays = slice(part_no * part, min(n, (part_no + 1) * part))
                sub = [v.map(lambda c: c[base:base + n][rays]) for v in (o, d)]
                bound = best[rays]
                culled += bool((bound < MISS_T).any())
                t = intersect.pair_t(*sub, rows[:, cols], t_min, bound,
                                     anchor[:, chunk, None].expand(3, hi - lo))
                best[rays] = torch.minimum(bound, t.min(dim=1).values)
        out.append(best)
    return torch.cat(out), culled


@pytest.mark.parametrize("source", ["pack", "tree"])
@pytest.mark.parametrize("tc", [100, 128])
def test_warp_schedule_gives_the_plain_brute_force(cornell, rays512, source, tc):
    """``warp_brute_kernel``'s schedule, modelled in PyTorch, gives
    ``closest_brute_plain``'s t bit for bit on the Cornell rays, over the
    pack (P4) and over a tree's anchored leaves, at tc 128 and at tc 100
    (slices part-empty past each chunk's last column), with tiles of 192
    rays (the last of 128): the best t carried from unit to unit culls
    pairs and drops no value the minimum keeps."""
    _, _, accel = cornell
    _, (o, d) = rays512
    if source == "pack":
        w, anchor = vpu_leaf.pack_chunks(accel, tc), None
    else:
        bvh = wide_bvh.build_wide_bvh(accel, leaf_size=tc)
        w, anchor = bvh.w, bvh.wanchor
    t, culled = _warp_schedule_t(w, o, d, anchor, 192)
    want = vpu_leaf.closest_brute_plain(w, o, d, anchor)
    assert torch.equal(t, want)
    assert culled > 0 and 100 < int((want < MISS_T).sum()) < 512


# --- P2 ------------------------------------------------------------------------

P2_SCRIPT = "tpu_kernel_variants_probe.py"


@pytest.fixture(scope="module")
def p2(p3, cornell):
    """The reference's four ``pallas_call`` families (``make_kernel*`` and
    ``run_*``) and its leaf packs (:643-664, built from ``pack``: the JAX
    fused leaf-32 tree and Woop rows), the port's tree of the same build and
    its unanchored rows, and 2 tiles of 256 seeded rays."""
    _, fused, bvh, _ = p3
    _, jax_accel, accel = cornell
    ns = _reference(
        P2_SCRIPT,
        ("make_kernel_v7", "make_kernel_v8", "make_kernel_v6", "make_kernel", "run_variant",
         "run_v7", "run_v6", "run_v8"),
        (_line(P2_SCRIPT, "import ml_dtypes"), _line(P2_SCRIPT, "WSF = ")),
        env={"pack": types.SimpleNamespace(wide=fused, accel=jax_accel)},
    )
    return ns, fused, bvh, kernel_variants.unanchored_rows(accel, bvh), _cornell_rays(512, 7)


def _assert_like_reference(t, slot, ref, bvh, o, d, slots=True):
    """Hit masks equal, t at the reference's rtol 1e-4 / atol 1e-5 (its
    bf16x3 products and approximate reciprocal), slots equal except on ties:
    where they differ, the reference's slot is a hit at the port's t within
    that tolerance."""
    t_ref, slot_ref = (np.asarray(a) for a in ref)
    t, slot = t.numpy(), slot.numpy()
    hit = t_ref < MISS_T
    np.testing.assert_array_equal(t < MISS_T, hit)
    np.testing.assert_allclose(t, t_ref, rtol=1e-4, atol=1e-5)
    assert 100 < hit.sum() < 512
    if not slots:
        assert (slot == -1).all() and (slot_ref == -1).all()
        return
    odd = np.flatnonzero(slot != slot_ref)
    if odd.size:
        rows, anchor = wide_bvh.slot_rows(bvh)
        cols = torch.from_numpy(slot_ref[odd]).long()
        sub = (o.map(lambda c: c[odd]), d.map(lambda c: c[odd]))
        t_odd = intersect.pair_t(*sub, rows[:, cols], T_MIN, MISS_T, anchor[:, cols])
        np.testing.assert_allclose(t_odd.diagonal().numpy(), t[odd], rtol=1e-4)
    assert odd.size <= 2


@pytest.mark.parametrize("variant", ["v0", "v1", "v2", "v3", "v4"])
def test_walk_variants_match_reference(p2, variant):
    """``run_variant`` (``make_kernel``) at tile 256, group 128, in interpret
    mode, against ``variant_walk``'s plain version: K1's function for each
    (its t only for v3, whose ids stay -1 on both sides)."""
    ns, fused, bvh, _, ((jo, jd), (o, d)) = p2
    ref = ns["run_variant"](fused, jo, jd, variant=variant, ray_tile=256, group=128)
    t, slot, tests = kernel_variants.variant_walk(bvh, o, d, variant, 256, 128)
    assert tests is None
    _assert_like_reference(t, slot, ref, bvh, o, d, slots=variant != "v3")


@pytest.mark.parametrize("variant, batch", [("v7", 4), ("v8", 8)])
def test_queue_variants_match_reference(p2, variant, batch):
    """``run_v7`` (unanchored f32 rows at HIGHEST) at batch 4 and ``run_v8``
    (per-chunk anchors) at batch 8, tile 256, in interpret mode, against
    the plain versions of ``closest_v7`` (the brute force over the
    unanchored rows) and ``closest_v8`` (K1's)."""
    ns, fused, bvh, rows, ((jo, jd), (o, d)) = p2
    if variant == "v7":
        ref = ns["run_v7"](fused, ns["WB1F"], ns["WB2F"], ns["WSF"], jo, jd, ray_tile=256,
                           batch=batch)
        t, slot, _ = kernel_variants.closest_v7(bvh, rows, o, d, 256, batch)
    else:
        ref = ns["run_v8"](fused, jo, jd, ray_tile=256, batch=batch)
        t, slot, _ = kernel_variants.closest_v8(bvh, o, d, 256, batch)
    _assert_like_reference(t, slot, ref, bvh, o, d)


def _take(t, slot, best, best_slot):
    """``take`` of ``csrc/variants.cu``: the lower t, on ties the lower slot."""
    better = (t < best) | ((t == best) & (t < MISS_T) & (slot < best_slot))
    return torch.where(better, t, best), torch.where(better, slot, best_slot)


def _staged_chunk(cw, tc, o, d, lim, t_min=T_MIN):
    """``staged_closest`` over one chunk's columns ``cw`` (4, 3 Tc), the rays'
    origins ``o`` re-centred: column by column, each ray's t first, then,
    only where it lies in (t_min, lim) and below the ray's t so far in the
    chunk, its barycentrics (``woop_t``'s expressions).  (t, col) per ray."""
    t = torch.full_like(d.x, MISS_T)
    col = torch.full(d.x.shape, -1, dtype=torch.int32)
    for j in range(tc):
        s, u, v = (cw[:, g * tc + j] for g in (2, 0, 1))
        tj = -(o.x * s[0] + o.y * s[1] + o.z * s[2] + s[3]) / (d.x * s[0] + d.y * s[1]
                                                              + d.z * s[2])
        live = ((tj > t_min) & (tj < lim) & (tj < t)).nonzero()[:, 0]
        if not live.numel():
            continue
        oj, dj, tl = o.map(lambda c: c[live]), d.map(lambda c: c[live]), tj[live]
        b1 = (oj.x * u[0] + oj.y * u[1] + oj.z * u[2] + u[3]) + tl * (dj.x * u[0] + dj.y * u[1]
                                                                    + dj.z * u[2])
        b2 = (oj.x * v[0] + oj.y * v[1] + oj.z * v[2] + v[3]) + tl * (dj.x * v[0] + dj.y * v[1]
                                                                    + dj.z * v[2])
        inside = (b1 >= -intersect.BARY_EPS) & (b2 >= -intersect.BARY_EPS) & (
            b1 + b2 <= 1.0 + intersect.BARY_EPS)
        hit = live[inside]
        t[hit], col[hit] = tl[inside], j
    return t, col


def _drain(w, anchor, chunks, o, d, best, best_slot, tightened):
    """One drain of ``queue_walk_kernel``: every ray tests the chunks in
    queue order, each against ``nextafter(min(bound, t_batch))`` (the
    redesign: ``bound`` its best t before the drain, ``t_batch`` the
    drain's best so far) or against ``nextafter(bound)`` (the parent's
    rule), and merges the drain's best once."""
    tc = w.shape[2] // 3
    inf = torch.tensor(float("inf"))
    t_batch = torch.full_like(best, MISS_T)
    slot_batch = torch.full_like(best_slot, -1)
    for c in chunks:
        oc = o if anchor is None else Vec3(o.x - anchor[0, c], o.y - anchor[1, c],
                                           o.z - anchor[2, c])
        lim = torch.nextafter(torch.minimum(best, t_batch) if tightened else best, inf)
        t, col = _staged_chunk(w[c], tc, oc, d, lim)
        t_batch, slot_batch = _take(t, c * tc + col, t_batch, slot_batch)
    return _take(t_batch, slot_batch, best, best_slot)


def _queue_walk_model(bvh, w, anchor, o, d, ray_tile, batch):
    """``queue_walk_kernel``'s walk and queue (``csrc/variants.cu``, its
    constants read from the source) per tile of ``ray_tile`` rays, each
    drain run by both rules of ``_drain``, which must leave every ray's t
    and slot equal bit for bit.  Returns (t, slot, drains)."""
    queue_size, max_batch = (_cu_constant("variants.cu", n) for n in ("kQueueSize", "kMaxBatch"))
    assert 1 <= batch <= max_batch
    codes = bvh.wchild.view(-1, wide_bvh.ARITY)
    code_list, axes = codes.tolist(), bvh.waxis.tolist()
    filled = codes != -1
    ts, slots, drains = [], [], 0
    for lo in range(0, o.x.numel(), ray_tile):
        ob, db = o.map(lambda c: c[lo:lo + ray_tile]), d.map(lambda c: c[lo:lo + ray_tile])
        n = ob.x.numel()
        signs = [bool(kernel_variants.tile_sums(c, ray_tile)[0] >= 0) for c in (db.x, db.y, db.z)]
        rcp = wide_bvh.reciprocals(db)
        best = torch.full((n,), MISS_T)
        slot = torch.full((n,), -1, dtype=torch.int32)
        queue, stack, node = [], [], 0

        def drain(chunks):
            nonlocal best, slot, drains
            new = _drain(w, anchor, chunks, ob, db, best, slot, True)
            old = _drain(w, anchor, chunks, ob, db, best, slot, False)
            assert all(torch.equal(a, b) for a, b in zip(new, old))
            best, slot = new
            drains += 1

        while node >= 0:
            b = bvh.wbox[node].T[:, :, None]
            enter = wide_bvh.widened_slab(b[0:3], b[3:6], (ob.x, ob.y, ob.z), rcp, best, T_MIN)
            live = (enter & filled[node][:, None]).any(dim=1).tolist()
            order = (range(wide_bvh.ARITY) if signs[axes[node]]
                     else range(wide_bvh.ARITY - 1, -1, -1))
            queue += [-2 - code_list[node][k] for k in order
                      if live[k] and code_list[node][k] <= -2]
            assert len(queue) <= queue_size
            while len(queue) >= batch:
                drain(queue[-batch:])
                del queue[-batch:]
            stack += [code_list[node][k] for k in reversed(order)
                      if live[k] and code_list[node][k] >= 0]
            node = stack.pop() if stack else -1
        if queue:
            drain(queue)
        ts.append(best)
        slots.append(slot)
    return torch.cat(ts), torch.cat(slots), drains


@pytest.mark.parametrize("variant, batch", [("v7", 1), ("v7", 4), ("v8", 8), ("v8", 16)])
def test_queue_drain_model_keeps_the_parent_rule(p2, variant, batch):
    """A PyTorch model of the redesigned drain (each chunk against the lower
    of the ray's bound and the drain's best so far, nextafter kept; t first,
    barycentrics behind the branch) gives, drain by drain, the (t, slot) of
    the parent's rule (each chunk against the stale bound), bit for bit,
    through the queue walk on the leaf-32 Cornell tree and 512 seeded rays
    in tiles of 256; and the plain versions of ``closest_v7`` and
    ``closest_v8`` (masks equal, t within 1e-5, slots equal)."""
    _, _, bvh, rows, (_, (o, d)) = p2
    w, anchor = (rows, None) if variant == "v7" else (bvh.w, bvh.wanchor)
    t, slot, drains = _queue_walk_model(bvh, w, anchor, o, d, 256, batch)
    if variant == "v7":
        t_p, slot_p = kernel_variants.closest_rows_plain(rows, o, d, None)
    else:
        t_p, slot_p, _ = wide_bvh.closest_wide_plain(bvh, o, d)
    hit = t_p < MISS_T
    assert torch.equal(t < MISS_T, hit) and 100 < int(hit.sum()) < 512
    torch.testing.assert_close(t, t_p, rtol=1e-5, atol=1e-5)
    assert torch.equal(slot, slot_p.int())
    assert drains >= 2


def test_queue_drain_keeps_a_tie_for_the_later_lower_slot(p2):
    """A tie across two drained chunks: the same triangle in chunks 0 and 1,
    drained as [1, 0], so that the later chunk holds the lower slot.  The
    tightened bound keeps the tie (nextafter of the drain's best), and the
    lower slot wins, as under the parent's rule; a bound without nextafter
    would drop it."""
    _, _, bvh, _, (_, (o, d)) = p2
    tc = bvh.leaf_size
    t0, slot0, _ = wide_bvh.closest_wide_plain(bvh, o, d)
    ray = int((t0 < MISS_T).nonzero()[0, 0])
    c = int(slot0[ray]) // tc
    w = torch.stack([bvh.w[c], bvh.w[c]])
    anchor = bvh.wanchor[:, [c, c]]
    one = (o.map(lambda x: x[ray:ray + 1]), d.map(lambda x: x[ray:ray + 1]))
    start = (torch.full((1,), MISS_T), torch.full((1,), -1, dtype=torch.int32))
    col = int(slot0[ray]) % tc
    for tightened in (True, False):
        t, slot = _drain(w, anchor, [1, 0], *one, *start, tightened)
        assert float(t[0]) == float(t0[ray]) and int(slot[0]) == col
    t1, slot1 = _drain(w, anchor, [1], *one, *start, True)
    assert int(slot1[0]) == tc + col
    oc = Vec3(*(x[ray:ray + 1] - anchor[k, 0] for k, x in enumerate((o.x, o.y, o.z))))
    assert int(_staged_chunk(w[0], tc, oc, one[1], t1)[1][0]) == -1


def test_unanchored_rows_match_reference(p2):
    """``unanchored_rows`` is the reference's f32 pack of v7 (WB1F, WB2F,
    WSF side by side), to the bit, and its rows are the tree's anchored rows
    with the anchors taken out: the same closest hits, at rtol 1e-5."""
    ns, _, bvh, rows, (_, (o, d)) = p2
    ref = np.concatenate([np.asarray(ns[k]) for k in ("WB1F", "WB2F", "WSF")], axis=2)
    np.testing.assert_array_equal(rows.numpy(), ref)
    t7, s7 = kernel_variants.closest_rows_plain(rows, o, d, None)
    t0, s0, _ = wide_bvh.closest_wide_plain(bvh, o, d)
    assert torch.equal(t7 < MISS_T, t0 < MISS_T)
    torch.testing.assert_close(t7, t0, rtol=1e-5, atol=1e-5)


def test_reference_v6_moves_rays_by_the_tile_centroid(p2):
    """``run_v6`` (batch 4, tile 256) re-centres the origins on the tile's
    centroid but tests them against rows with no anchor folded in, so it
    tests rays moved by minus the centroid: its t agrees with K1's on the
    misses only (found: 7% of lanes), and with the brute force over those
    moved rays on 98.8% (its walk culls by the rays' true origins).  The
    port's v6 re-centres the rows too: its t equals K1's at rtol 1e-4, hit
    masks equal."""
    ns, fused, bvh, rows, ((jo, jd), (o, d)) = p2
    t_ref, _ = (np.asarray(a) for a in ns["run_v6"](fused, ns["WB1"], ns["WB2"], ns["WS"], jo,
                                                      jd, ray_tile=256, batch=4))
    t0 = wide_bvh.closest_wide_plain(bvh, o, d)[0]
    centroid = kernel_variants.tile_centroids(o, 256).repeat_interleave(256, dim=0)
    moved = Vec3(o.x - centroid[:, 0], o.y - centroid[:, 1], o.z - centroid[:, 2])
    t_moved = kernel_variants.closest_rows_plain(rows, moved, d, None)[0].numpy()
    close = functools.partial(np.isclose, rtol=1e-4, atol=1e-5)
    assert close(t_ref, t0.numpy()).mean() < 0.2
    assert close(t_ref, t_moved).mean() > 0.95
    t6, s6, _ = kernel_variants.closest_v6(bvh, rows, o, d, 256, 4)
    assert torch.equal(t6 < MISS_T, t0 < MISS_T)
    torch.testing.assert_close(t6, t0, rtol=1e-4, atol=1e-5)


def test_reference_cases_and_batch_from_group(monkeypatch):
    """The default cases are the reference's (:736-738), batch for v8.  Under
    ``VARIANTS=`` the reference runs each named variant at tiles 512 and
    1024 with group 128, which v6-v8 take as their batch (over a queue of 64
    entries); the port's cases keep the batch apart (a bare v6-v8 takes
    the ``run_v*`` default of 4)."""
    span = (_line(P2_SCRIPT, "cases = [("), _line(P2_SCRIPT, 'if os.environ.get("VARIANTS")'))
    monkeypatch.delenv("VARIANTS", raising=False)
    ref = _reference(P2_SCRIPT, (), span)["cases"]
    assert [(c.name, c.ray_tile, c.batch) for c in kernel_variants.default_cases()[1:]] == ref
    monkeypatch.setenv("VARIANTS", "v1,v4,v6")
    ref = _reference(P2_SCRIPT, (), span)["cases"]
    ours = kernel_variants.variant_cases(["v1", "v4", "v6"])
    assert [(c.variant, c.ray_tile) for c in ours] == [(v[:2], rt) for v, rt, _ in ref]
    assert [g for _, _, g in ref] == [128] * 7
    assert [(c.group, c.batch) for c in ours if c.variant == "v4"] == [(128, 4)] * 2
    assert [c.batch for c in ours if c.variant == "v6"] == [4, 4]
    assert kernel_variants.parse_case("v8b16", 2048) == kernel_variants.Case("v8", 2048,
                                                                             batch=16)
    for bad in ("v9", "v4b8", "v8g32", "v0g32", "x"):
        with pytest.raises(ValueError):
            kernel_variants.parse_case(bad, 512)


def test_tile_sums_follow_the_kernel_order():
    """Tile sums and centroids in the kernels' float32 order (a butterfly
    within each warp of 32, then the warps in turn), with a partial last tile
    whose absent lanes add nothing and count for nothing."""
    v = torch.zeros(2 * 64 + 40)
    v[0], v[1], v[2], v[32] = 2.0**-24, 2.0**-24, 1.0, -(1.0 + 2.0**-23)
    v[128:] = 3.0
    sums = kernel_variants.tile_sums(v, 64)
    assert float(v[:64].double().sum()) == 0.0 and float(sums[0]) == -(2.0**-23)
    assert sums.tolist() == [-(2.0**-23), 0.0, 120.0]
    centroid = kernel_variants.tile_centroids(Vec3(v, -v, v * 0), 64)
    assert centroid[2].tolist() == [3.0, -3.0, 0.0]


def test_wavefront_is_the_sorted_bounce():
    """``wavefront`` at 48x32 is sample 2's first bounce, sorted by
    ``_sort_paths``: its key nondecreasing over all lanes, dead ones last."""
    from heatray_tpu_torch.options import FrameGlobals
    from heatray_tpu_torch.probes import cornell as probe_cornell
    from heatray_tpu_torch.render import integrator

    scene, camera, opts, ctx = probe_cornell(48, 32, 4, "cpu")
    paths = kernel_variants.wavefront(scene, camera, ctx, opts)
    pack = ctx.accel_pack
    bounced, _ = integrator.bounce(scene, ctx, opts, FrameGlobals.create(2), 1,
                                   integrator.start_paths(camera, ctx, opts, 2), pack)
    want = integrator._sort_paths(bounced, *integrator._sort_bounds(pack))
    for a, b in ((paths.org, want.org), (paths.direction, want.direction)):
        assert all(torch.equal(x, y) for x, y in zip((a.x, a.y, a.z), (b.x, b.y, b.z)))
    key = integrator._wavefront_sort_key(paths.org, paths.direction, paths.active,
                                         *integrator._sort_bounds(pack))
    assert bool((key[1:] >= key[:-1]).all())
    n_live = int(paths.active.sum())
    assert 0 < n_live < 48 * 32 and bool(paths.active[:n_live].all())


# --- wrappers and entry points ---------------------------------------------------


def test_cpu_wrappers_take_the_plain_versions(p3, cornell, rays512):
    """On the CPU every probe wrapper returns its plain version and counts no
    launch; what the kernels do not take raises."""
    _, _, bvh, _ = p3
    _, _, accel = cornell
    _, (o, d) = rays512
    counters = (visit_stats.visit_stats, kernel_probe.node_walk, kernel_probe.empty,
                vpu_leaf.rows_closest, vpu_leaf.warp_closest)
    before = [f.launches for f in counters]
    w = vpu_leaf.pack_chunks(accel, 128)
    want = vpu_leaf.closest_brute_plain(w, o, d)
    assert torch.equal(vpu_leaf.rows_closest(w, o, d, ray_tile=512), want)
    assert torch.equal(vpu_leaf.warp_closest(w, o, d), want)
    assert torch.equal(kernel_probe.node_walk(bvh, o, d)[1],
                       kernel_probe.node_walk_plain(bvh, o, d)[1])
    assert all(torch.equal(a, b) for a, b in zip(visit_stats.visit_stats(bvh, o, d),
                                                 visit_stats.visit_stats_plain(bvh, o, d)))
    assert [f.launches for f in counters] == before
    with pytest.raises(ValueError, match="ray_tile"):
        vpu_leaf.rows_closest(w, o, d, ray_tile=100)
    with pytest.raises(ValueError, match="ray_tile"):
        kernel_probe.empty(o, ray_tile=2048)
    with pytest.raises(ValueError, match="seed_w"):
        visit_stats.visit_stats(bvh, o, d, seed_k=32)


def test_variant_wrappers_take_the_plain_versions(p2):
    """On the CPU the P2 wrappers return their plain versions, with no tests
    per tile, and count no launch; settings the kernels do not take raise."""
    _, _, bvh, rows, (_, (o, d)) = p2
    kv = kernel_variants
    counters = (kv.variant_walk, kv.closest_v6, kv.closest_v7, kv.closest_v8)
    before = [f.launches for f in counters]
    t0, s0, _ = wide_bvh.closest_wide_plain(bvh, o, d)
    for out in (kv.variant_walk(bvh, o, d, "v2", 1024), kv.closest_v8(bvh, o, d, 2048, 16)):
        assert torch.equal(out[0], t0) and torch.equal(out[1], s0) and out[2] is None
    t6, s6, _ = kv.closest_v6(bvh, rows, o, d, 512, 8)
    t6_p, s6_p = kv.closest_rows_plain(rows, o, d, "tile", 512)
    assert torch.equal(t6, t6_p) and torch.equal(s6, s6_p)
    assert [f.launches for f in counters] == before
    for bad in (dict(ray_tile=2048), dict(group=96), dict(ray_tile=256, group=512)):
        with pytest.raises(ValueError, match="ray_tile"):
            kv.variant_walk(bvh, o, d, **bad)
    with pytest.raises(ValueError, match="variant"):
        kv.variant_walk(bvh, o, d, "v6")
    with pytest.raises(ValueError, match="batch"):
        kv.closest_v7(bvh, rows, o, d, batch=17)
    with pytest.raises(ValueError, match="v0"):
        kv.run(bvh, rows, o, d, kv.variant_cases(["v1"])[1:])


@pytest.mark.parametrize("probe, argv", [
    (visit_stats, ["--size", "16", "16", "--depth", "2"]),
    (kernel_probe, ["quick", "--size", "16", "16"]),
    (vpu_leaf, ["--size", "16", "16"]),
    (kernel_variants, ["--size", "16", "16", "--variants", "v1,v4g32,v6b8,v7"]),
])
def test_entry_points_run_on_the_cpu_only_when_asked(probe, argv, capsys):
    """Each ``python -m`` entry point refuses to run without a card unless
    given ``--device cpu``, and then prints its lines."""
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="--device cpu"):
            probe.main(argv)
    assert probe.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "cpu (plain versions)" in out and " ms" in out
