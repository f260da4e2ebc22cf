"""The port's host-sharded geometry (``heatray_tpu_torch.parallel.geometry``)
against the JAX package's on the CPU, mirroring
``tests/test_geometry_sharding.py`` (a 700-triangle soup, 512 rays).

The brute-force forest runs in this process, against the JAX package's
``shard_accel``/``make_sharded_intersectors`` on its 8 virtual CPU devices
and its monolithic queries.  The wide forest's build is held against the
JAX package's ``build_sharded_wide`` (host numpy), shard by shard, directly
and through ``bridge.sharded_wide_from_arrays``.  Four gloo ranks, spawned
once for the module (``torch_ranks.forest``, which imports no jax), run the
wide forest's intersectors (K1/K2's plain versions on the CPU, one shard a
rank) and the ``"sharded"`` backend end to end; the JAX package's own
sharded-wide path raises (``intersect_closest_wide``'s missing arguments),
so they are held against its monolithic queries and its ``"xla"`` render
(one render compile), as its own test holds its path."""

import dataclasses
import os

import numpy as np
import pytest

import torch_ranks
from heatray_tpu.camera import orbit_camera as jax_orbit_camera
from heatray_tpu.ops import build_woop as jax_build_woop
from heatray_tpu.ops import intersect_any as jax_intersect_any
from heatray_tpu.ops import intersect_closest as jax_intersect_closest
from heatray_tpu.options import RenderOptions as JaxRenderOptions
from heatray_tpu.parallel.geometry import build_sharded_wide as jax_build_sharded_wide
from heatray_tpu.parallel.geometry import make_sharded_intersectors as jax_sharded_intersectors
from heatray_tpu.parallel.geometry import shard_accel as jax_shard_accel
from heatray_tpu.parallel.sharding import make_mesh as jax_make_mesh
from heatray_tpu.render import render as jax_render
from heatray_tpu.scene.builtin import cornell_box as jax_cornell_box
from heatray_tpu_torch import cornell_box, make_context, render
from heatray_tpu_torch.bridge import sharded_wide_from_arrays
from heatray_tpu_torch.parallel import geometry
from heatray_tpu_torch.utils.threads import share_cores
from test_bvh import make_rays, make_soup, planar, v3

share_cores(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))

TREE_FIELDS = ("wbox", "wchild", "waxis", "w", "slot_tri", "wanchor")


@pytest.fixture(scope="module")
def soup():
    positions, indices = make_soup(700, seed=31)
    orig, dirs = make_rays(512, seed=37)
    jax_accel = jax_build_woop(planar(positions), planar(indices))
    jo, jd = v3(planar(orig).T), v3(planar(dirs).T)
    t_ref, id_ref, _, hit_ref = jax_intersect_closest(jax_accel, jo, jd)
    return {
        "np": ((positions, indices), (orig, dirs)),
        "jax": (jax_accel, jo, jd),
        "accel": torch_ranks.soup_accel(positions, indices),
        "rays": torch_ranks.rays(orig, dirs),
        "ref": tuple(np.asarray(a) for a in (t_ref, id_ref, hit_ref)),
        "blocked": np.asarray(jax_intersect_any(jax_accel, jo, jd, t_max=5.0)),
    }


@pytest.fixture(scope="module")
def started(soup, tmp_path_factory):
    soup_np, rays_np = soup["np"]
    return torch_ranks.start(torch_ranks.forest, 4, tmp_path_factory.mktemp("ranks"), soup_np,
                             rays_np)


@pytest.fixture(scope="module")
def xla_image(started):
    """The JAX package's ``"xla"`` render of the ``"sharded"`` scenario's
    scene and options, made while the ranks run."""
    opts = torch_ranks.sharded_options()
    j_opts = JaxRenderOptions(width=opts.width, height=opts.height, max_render_passes=2,
                              max_ray_depth=opts.max_ray_depth, intersect_backend="xla")
    j_camera = jax_orbit_camera(opts.width, opts.height, distance=6.2, focal_length_mm=35.0)
    ref, _ = jax_render(jax_cornell_box(light="both", with_spheres=True), j_camera, j_opts,
                        num_passes=2)
    return np.asarray(ref)


@pytest.fixture(scope="module")
def ranks(started, xla_image):
    return started.results()


def _hold_closest(t, ids, hit, ref, share=0.999):
    """F2's contract against the exact brute force: masks equal, t within
    rtol 1e-5 / atol 1e-6, ids equal but on ties."""
    t_ref, id_ref, hit_ref = ref
    np.testing.assert_array_equal(hit, hit_ref)
    np.testing.assert_allclose(t[hit_ref], t_ref[hit_ref], rtol=1e-5, atol=1e-6)
    assert (ids[hit_ref] == id_ref[hit_ref]).mean() >= share


@pytest.mark.parametrize("n_shards", [2, 8])
def test_brute_forest_matches_jax(soup, n_shards):
    accel, (org, d) = soup["accel"], soup["rays"]
    sharded = geometry.shard_accel(accel, n_shards)
    closest, any_hit = geometry.make_sharded_intersectors(sharded)
    t, ids, hit = (a.numpy() for a in closest(org, d, 1e-4))
    _hold_closest(t, ids, hit, soup["ref"])

    jax_accel, jo, jd = soup["jax"]
    jax_sharded = jax_shard_accel(jax_accel, jax_make_mesh(n_shards), axis="dp")
    j_closest, j_any = jax_sharded_intersectors(jax_sharded, ray_block=512)
    t_j, id_j, _, hit_j = (np.asarray(a) for a in j_closest(jo, jd, 1e-4))
    _hold_closest(t, ids, hit, (t_j, id_j, hit_j))
    np.testing.assert_array_equal(sharded.offsets.numpy(), np.asarray(jax_sharded.offsets))

    # Global ids: inside [0, T), and hits land in every shard's range.
    assert ids[hit].min() >= 0 and ids[hit].max() < accel.num_triangles
    tp = -(-accel.num_triangles // n_shards)
    assert set(np.unique(ids[hit] // tp)) == set(range(n_shards))

    blocked = any_hit(org, d, 1e-4, 5.0).numpy()
    np.testing.assert_array_equal(blocked, soup["blocked"])
    np.testing.assert_array_equal(blocked, np.asarray(j_any(jo, jd, 1e-4, 5.0)))


def test_wide_forest_build_matches_jax(soup):
    """The port's forest of 8 shards against the JAX package's (f32 leaf
    layout), shard by shard, each of the JAX package's arrays trimmed to the
    port's shard's own node and chunk counts; and the JAX forest bridged
    into the port's gives the same trees, block boxes included."""
    accel, jax_accel = soup["accel"], soup["jax"][0]
    ours = geometry.build_sharded_wide(accel, 8)
    ref = jax_build_sharded_wide(jax_accel, 8, schedule="f32")
    arrays = {f.name: np.asarray(getattr(ref, f.name)) for f in dataclasses.fields(ref)
              if f.name in (*TREE_FIELDS, "slot_offset")}
    np.testing.assert_array_equal(ours.slot_tri.numpy(), arrays["slot_tri"])
    np.testing.assert_array_equal(ours.slot_offset.numpy(), arrays["slot_offset"])
    assert ours.slots_per_shard == ref.slots_per_shard and ours.leaf_size == ref.leaf_size
    boxes = {k: np.asarray(getattr(jax_accel, k)) for k in ("tri_min", "tri_max")}
    bridged = sharded_wide_from_arrays(arrays, ref.leaf_size, ref.num_triangles, 8, boxes,
                                       device="cpu")
    one = sharded_wide_from_arrays(arrays, ref.leaf_size, ref.num_triangles, 8, boxes,
                                   rank=5, device="cpu")
    assert one.shard == 5 and all(s is None for i, s in enumerate(one.shards) if i != 5)
    for i, tree in enumerate(ours.shards):
        nw, c = tree.num_nodes, tree.num_chunks
        trim = {"wbox": arrays["wbox"][i][:nw], "wchild": arrays["wchild"][i][:nw * 8],
                "waxis": arrays["waxis"][i][:nw], "w": arrays["w"][i][:c],
                "slot_tri": arrays["slot_tri"][i][:c * tree.leaf_size],
                "wanchor": arrays["wanchor"][i][:, :c]}
        for name in TREE_FIELDS:
            np.testing.assert_array_equal(getattr(tree, name).numpy(), trim[name],
                                          err_msg=f"shard {i} {name}")
        for other in (bridged.shards[i], one.shards[5] if i == 5 else None):
            if other is None:
                continue
            assert other.max_stack == tree.max_stack
            np.testing.assert_array_equal(other.blocks[:c].numpy(), tree.blocks.numpy())
            np.testing.assert_array_equal(other.wchild[:nw * 8].numpy(), tree.wchild.numpy())


def test_wide_forest_intersectors_match_monolithic(soup, ranks):
    """K1/K2's plain versions over 4 shards, one a rank, reduced over the
    ranks: every rank gets the same (t, global slot, hit) and blocked mask,
    held to F2's contract against the JAX package's monolithic queries
    through the concatenated slot table."""
    for r, out in enumerate(ranks):
        assert int(out["shard"]) == r
        for key in ("t", "slot", "hit", "blocked", "slot_tri"):
            np.testing.assert_array_equal(out[key], ranks[0][key], err_msg=key)
    out = ranks[0]
    slot_tri = out["slot_tri"].reshape(-1)
    ids = np.where(out["hit"], slot_tri[np.maximum(out["slot"], 0)], -1)
    _hold_closest(out["t"], ids, out["hit"], soup["ref"])
    np.testing.assert_array_equal(out["blocked"], soup["blocked"])


def test_sharded_render_matches_xla(ranks, xla_image):
    """``make_context(opts, scene, mesh=...)`` and ``render`` through the
    ``"sharded"`` backend on 4 ranks (sorted and gated) against the JAX
    package's ``"xla"`` render of the same scene and options (rtol = atol =
    2e-4, as ``tests/test_geometry_sharding.py`` holds its path), and
    against the port's one-device ``"wide"`` render; every rank's image is
    the same."""
    for out in ranks:
        assert str(out["backend"]) == "sharded"
        np.testing.assert_array_equal(out["image"], ranks[0]["image"])
    image = ranks[0]["image"]
    np.testing.assert_allclose(image, xla_image, rtol=2e-4, atol=2e-4)

    wide = dataclasses.replace(torch_ranks.sharded_options(), intersect_backend="wide")
    one, _ = render(cornell_box(light="both", with_spheres=True), torch_ranks.sharded_camera(),
                    wide, num_passes=2, device="cpu")
    np.testing.assert_allclose(image, one.numpy(), rtol=2e-4, atol=2e-4)


def test_sharded_needs_a_mesh():
    opts = dataclasses.replace(torch_ranks.sharded_options(), width=8, height=8)
    with pytest.raises(ValueError, match="mesh"):
        make_context(opts, cornell_box(light="point", with_spheres=False), device="cpu")
