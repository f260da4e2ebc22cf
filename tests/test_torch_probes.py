"""The port's traversal probes (``heatray_tpu_torch.probes``) against the
reference probe kernels of the root scripts ``tpu_visit_stats.py`` (P3),
``tpu_kernel_probe.py`` (P1) and ``tpu_vpu_leaf.py`` (P4), on the Cornell box.

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
from heatray_tpu_torch.probes import kernel_probe, visit_stats, vpu_leaf
from heatray_tpu_torch.vec import Vec3

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
    bvh = wide_bvh_from_arrays(arrays, f32.leaf_size, f32.num_triangles, device="cpu")
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


@pytest.mark.parametrize("probe, argv", [
    (visit_stats, ["--size", "16", "16", "--depth", "2"]),
    (kernel_probe, ["quick", "--size", "16", "16"]),
    (vpu_leaf, ["--size", "16", "16"]),
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
