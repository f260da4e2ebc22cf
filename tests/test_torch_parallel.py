"""The port's row and sample axes (``heatray_tpu_torch.parallel.sharding``)
against the JAX package's on the CPU.

Four gloo ranks, spawned once for the module (``torch_ranks.rows_and_samples``,
which imports no jax), run every scenario: the row-sharded render on
``make_mesh(4)``, nine block passes over it, the 2x2 ``(sp, dp)`` render and
the two sharded train steps.  The JAX package renders the same scene and
options (``tests/test_sharding.py``: 16x16, depth 2) with ``render_sharded``
on ``make_mesh(4)`` and ``render_sharded_2d`` on ``make_mesh_2d(2, 2)`` over
its 8 virtual CPU devices: two render compiles.  The train steps are held
against the port's one-device ``make_loss_fn``, and the row-sharded step at
depth 1 against the JAX package's ``make_sharded_train_step`` on
``make_mesh(2)``: one ``value_and_grad`` compile (depth 2 takes minutes)."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
import optax

from heatray_tpu.camera import orbit_camera as jax_orbit_camera
from heatray_tpu.options import RenderOptions as JaxRenderOptions
from heatray_tpu.parallel.sharding import make_mesh as jax_make_mesh
from heatray_tpu.parallel.sharding import make_mesh_2d as jax_make_mesh_2d
from heatray_tpu.parallel.sharding import make_sharded_train_step as jax_make_sharded_train_step
from heatray_tpu.parallel.sharding import render_sharded as jax_render_sharded
from heatray_tpu.parallel.sharding import render_sharded_2d as jax_render_sharded_2d
from heatray_tpu.render import make_context as jax_make_context
from heatray_tpu.scene.builtin import cornell_box as jax_cornell_box
from heatray_tpu_torch import cornell_box, make_context, make_loss_fn, render
from heatray_tpu_torch.parallel import sharding
from heatray_tpu_torch.utils.threads import share_cores

share_cores(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))

# A target that differs from the render, so that the loss and its
# gradients are not zero.
TARGET = np.random.default_rng(21).uniform(0.0, 1.0, (16, 16, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    return torch_ranks.start(torch_ranks.rows_and_samples, 4, tmp_path_factory.mktemp("ranks"),
                             TARGET)


@pytest.fixture(scope="module")
def ranks(started, jax_images, jax_step, one_device):
    """The ranks' results, waited for after the references (computed while
    the ranks run)."""
    return started.results()


@pytest.fixture(scope="module")
def jax_images(started):
    opts = JaxRenderOptions(width=16, height=16, max_render_passes=4, max_ray_depth=2)
    scene = jax_cornell_box(light="point", with_spheres=False)
    camera = jax_orbit_camera(16, 16, distance=6.0, focal_length_mm=35.0)
    ctx = jax_make_context(opts)
    rows = jax_render_sharded(scene, camera, ctx, opts, jax_make_mesh(4), num_passes=2)
    sp_dp = jax_render_sharded_2d(scene, camera, ctx, opts, jax_make_mesh_2d(2, 2),
                                  num_passes=4)
    return {"rows": np.asarray(rows), "sp_dp": np.asarray(sp_dp)}


@pytest.fixture(scope="module")
def jax_step(started):
    """The JAX package's row-sharded step (SGD at lr 1.0) on ``make_mesh(2)``
    at depth 1, pass 1, on the ranks' scene: the box with its spheres and
    a roughness of 0.5.  Returns (loss, gradients)."""
    opts = JaxRenderOptions(width=16, height=16, max_render_passes=4, max_ray_depth=1,
                            intersect_backend="xla", sort_bounces=False, remat_bounces=False)
    scene = jax_cornell_box(light="point", with_spheres=True)
    camera = jax_orbit_camera(16, 16, distance=6.0, focal_length_mm=35.0)
    ctx = jax_make_context(opts, scene, static_shading=False)
    params = {"base_color": scene.materials.base_color,
              "roughness": jnp.full_like(scene.materials.roughness, 0.5)}
    optimizer = optax.sgd(1.0)
    step = jax_make_sharded_train_step(scene, camera, ctx, opts, jnp.asarray(TARGET),
                                       jax_make_mesh(2), optimizer)
    new, _, loss = step(params, optimizer.init(params), 1)
    return float(loss), {k: np.asarray(params[k] - new[k]) for k in torch_ranks.TRAIN_KEYS}


@pytest.fixture(scope="module")
def one_device(started):
    """The port's one-device renders of the same passes."""
    scene, camera, ctx = torch_ranks.parallel_setup()
    opts = torch_ranks.parallel_options()
    out = {}
    for key, o, n in (("rows", opts, 2), ("sp_dp", opts, 4),
                      ("blocks", dataclasses.replace(opts, interactive_block=True), 9)):
        out[key] = render(scene, camera, o, num_passes=n, ctx=ctx, device="cpu")[0].numpy()
    return out


def test_rows_match_jax(ranks, jax_images):
    for out in ranks:
        np.testing.assert_allclose(out["rows"], jax_images["rows"], rtol=0, atol=1e-5)


def test_rows_match_one_device(ranks, one_device):
    for out in ranks:
        np.testing.assert_allclose(out["rows"], one_device["rows"], rtol=0, atol=1e-5)


def test_block_passes_match_one_device(ranks, one_device):
    """Nine block passes over 4 ranks of 4 rows: rows 4, 8 and 12 start
    off the 3x3 grid, so each rank must pick its block's rows by their
    global index."""
    np.testing.assert_array_equal(ranks[0]["blocks"][3], np.ones((16, 16), np.float32))
    for out in ranks:
        np.testing.assert_allclose(out["blocks"], one_device["blocks"], rtol=0, atol=1e-5)


def test_sp_dp_matches_jax(ranks, jax_images):
    for out in ranks:
        np.testing.assert_allclose(out["sp_dp"], jax_images["sp_dp"], rtol=0, atol=1e-4)
        np.testing.assert_array_equal(out["sp_dp"][3], np.full((16, 16), 4.0, np.float32))


def test_sp_dp_matches_serial(ranks, one_device):
    for out in ranks:
        np.testing.assert_allclose(out["sp_dp"], one_device["sp_dp"], rtol=0, atol=1e-4)


def test_ranks_agree(ranks):
    for out in ranks[1:]:
        for key, value in ranks[0].items():
            np.testing.assert_array_equal(out[key], value, err_msg=key)


@pytest.mark.parametrize("step", ["dp", "2d"])
def test_train_step_matches_one_device(ranks, step):
    """One step's loss and gradients (the parameters' change under SGD at lr
    1.0) against the one-device loss over the same passes: pass 1 over
    2-rank rows for ``dp``, passes 2 and 3 (sample index 1 times S = 2, plus
    the slice) for ``2d``."""
    scene, camera, ctx = torch_ranks.parallel_setup(static_shading=False, spheres=True)
    opts = torch_ranks.parallel_options()
    passes = 1 if step == "dp" else 2
    loss_fn = make_loss_fn(scene, camera, ctx, opts, TARGET, num_passes=passes)
    params = torch_ranks.train_params(scene)
    loss = loss_fn(params, 1 * passes)
    loss.backward()
    out = ranks[0]
    np.testing.assert_allclose(out[f"{step}_loss"], loss.item(), rtol=1e-5, atol=0)
    for key in torch_ranks.TRAIN_KEYS:
        ref = params[key].grad.numpy()
        assert np.abs(ref).max() > 0, key
        np.testing.assert_allclose(out[f"{step}_grad_{key}"], ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max(), err_msg=key)


def test_train_step_matches_jax(ranks, jax_step):
    """The row-sharded step at depth 1 (``dp1``) against the JAX package's
    on the same inputs: the loss within rtol 1e-5 and each gradient within
    1e-5 of its largest |g|, as the steps are held against one device."""
    loss_ref, grads_ref = jax_step
    for out in ranks:
        np.testing.assert_allclose(out["dp1_loss"], loss_ref, rtol=1e-5, atol=0)
        for key in torch_ranks.TRAIN_KEYS:
            ref = grads_ref[key]
            assert np.abs(ref).max() > 0, key
            np.testing.assert_allclose(out[f"dp1_grad_{key}"], ref, rtol=0,
                                       atol=1e-5 * np.abs(ref).max(), err_msg=key)


def test_mesh_needs_a_group_of_its_size(ranks):
    """``make_mesh(n)`` refuses a process group of another size, and one
    process without a group is a mesh of 1; nothing falls back to the CPU.
    A ``"sharded"`` context is refused by the row and sample axes, whose
    ranks trace other rays."""
    assert all(bool(out["mesh_of_2_raises"]) for out in ranks)
    with pytest.raises(ValueError, match="process group of 2"):
        sharding.make_mesh(2, device="cpu")
    mesh = sharding.make_mesh(device="cpu")
    assert mesh.shape == {"dp": 1} and mesh.coordinate("dp") == 0
    t = torch.ones(3)
    assert mesh.all_reduce(t, "sum") is t and torch.equal(t, torch.ones(3))
    sharded = make_context(dataclasses.replace(torch_ranks.parallel_options(),
                                               intersect_backend="sharded"),
                           cornell_box(light="point"), device="cpu", mesh=mesh)
    assert sharded.accel_pack.backend == "sharded"
    with pytest.raises(ValueError, match="sharded"):
        sharding.shard_context(sharded, mesh)
    with pytest.raises(ValueError, match="divide"):
        sharding.sharded_accum(torch_ranks.parallel_options(), sharding.Mesh(
            ("dp",), (3,), 0, torch.device("cpu"), {"dp": None}, False))
