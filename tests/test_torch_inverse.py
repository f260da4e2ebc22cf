"""The port's gradient path (``heatray_tpu_torch.diff.inverse``) against the
JAX package's.

One JAX ``value_and_grad`` of ``make_loss_fn`` over ``base_color``,
``roughness`` and ``light.point_color`` (16x16, one pass, depth 1, on its
exact-f32 XLA backend) is held against the port's loss and gradients on
``"wide"`` with ``static_shading=False`` and in the rebuild mode; the
overlay clamps' tie gradients against ``jax.grad`` of the reference's.
Everything else mirrors ``tests/test_inverse.py`` and
``tests/test_gating.py`` on the port alone, at their eps and tolerances:
finite differences for light and environment parameters, the camera,
the baked-table guard, an optimization, sorted and gated gradients against
unsorted ones, and remat on against off.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heatray_tpu.camera import orbit_camera as jax_orbit_camera
from heatray_tpu.camera import orbit_view_matrix_jnp
from heatray_tpu.diff import inverse as jax_inverse
from heatray_tpu.options import RenderOptions as JaxRenderOptions
from heatray_tpu.render import make_context as jax_make_context
from heatray_tpu.scene.builtin import cornell_box as jax_cornell_box
from heatray_tpu_torch import RenderOptions, cornell_box, make_context, orbit_camera, render
from heatray_tpu_torch import resolve
from heatray_tpu_torch.bridge import camera_from_arrays, params_from_arrays, scene_from_arrays
from heatray_tpu_torch.camera import orbit_view_matrix_torch
from heatray_tpu_torch.diff.inverse import (
    apply_camera_params,
    apply_light_params,
    apply_material_params,
    make_loss_fn,
    optimize,
)
from heatray_tpu_torch.options import FrameGlobals
from heatray_tpu_torch.render import integrator
from heatray_tpu_torch.utils.threads import share_cores

share_cores(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))


SMALL = 16
KEYS = ("base_color", "roughness", "light.point_color")
# tests/test_inverse.py's OPTS: 24x24, depth 2.
OPTS = RenderOptions(width=24, height=24, max_render_passes=4, max_ray_depth=2)


def _arrays(obj):
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


@pytest.fixture(scope="module")
def jax_grads():
    """The JAX package's loss and gradients of bench.py's scene and camera
    at 16x16, one pass, depth 1, ``remat_bounces=False``, on its XLA
    backend with an in-graph shading table, against a seeded target.  Its
    one trace and compile dominates this file: 33 s on an 8-core CPU host
    with the file alone in its process (depth 2, or remat, takes minutes,
    so neither is compared with JAX)."""
    opts = JaxRenderOptions(
        width=SMALL, height=SMALL, max_render_passes=4, max_ray_depth=1,
        intersect_backend="xla", sort_bounces=False, remat_bounces=False,
    )
    scene = jax_cornell_box(light="both", with_spheres=True)
    camera = jax_orbit_camera(SMALL, SMALL, distance=6.2, focal_length_mm=35.0)
    target = np.random.default_rng(3).uniform(0.0, 1.0, (SMALL, SMALL, 3)).astype(np.float32)
    ctx = jax_make_context(opts, scene, static_shading=False)
    loss_fn = jax_inverse.make_loss_fn(scene, camera, ctx, opts, jnp.asarray(target))
    params = {"base_color": scene.materials.base_color, "roughness": scene.materials.roughness,
              "light.point_color": scene.lights.point_color}
    loss, grads = jax.value_and_grad(loss_fn)(params)
    return (scene, camera, target, {k: np.asarray(v) for k, v in params.items()}, float(loss),
            {k: np.asarray(v) for k, v in grads.items()})


def _port_scene(jax_scene):
    return scene_from_arrays(
        _arrays(jax_scene.geometry), _arrays(jax_scene.materials), _arrays(jax_scene.lights),
        has_alpha_mask=jax_scene.has_alpha_mask, has_textures=jax_scene.has_textures,
        device="cpu",
    )


@pytest.mark.parametrize("mode", ["wide", "rebuild"])
def test_loss_and_grads_match_jax(jax_grads, mode):
    """The port's loss within rtol 1e-4 and each gradient within rtol 1e-3,
    atol 1e-4 of its largest |g| (the forward render's tolerance in
    test_torch_render.py), on ``"wide"`` with a per-pass slot-order table
    and in the rebuild mode; roughness' gradient is nonzero on the metal
    sphere (material 5) on both sides, so the comparison is not of zeros."""
    jax_scene, jax_camera, target, params, loss_ref, grads_ref = jax_grads
    scene = _port_scene(jax_scene)
    camera = camera_from_arrays(_arrays(jax_camera), device="cpu")
    opts = RenderOptions(width=SMALL, height=SMALL, max_render_passes=4, max_ray_depth=1)
    if mode == "wide":
        ctx = make_context(opts, scene, device="cpu", static_shading=False)
        assert ctx.accel_pack.route == "wide" and ctx.accel_pack.shade_table is None
    else:
        ctx = make_context(opts, device="cpu")
    p = params_from_arrays(params, device="cpu")
    loss = make_loss_fn(scene, camera, ctx, opts, target)(p)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), loss_ref, rtol=1e-4)
    for k in KEYS:
        g_ref, g = grads_ref[k], p[k].grad.numpy()
        assert np.isfinite(g).all(), k
        np.testing.assert_allclose(g, g_ref, rtol=1e-3, atol=1e-4 * np.abs(g_ref).max(),
                                   err_msg=k)
    assert grads_ref["roughness"][5] != 0.0 and p["roughness"].grad[5] != 0.0


def test_material_clip_ties_match_jax():
    """``apply_material_params``' gradient where the clamps sit on their
    bounds (roughness 1.0, metallic 0.0, base_color 0 and 1, as on the
    Cornell box) equals ``jax.grad`` of the reference's: half at a tie."""
    rng = np.random.default_rng(5)
    values = {
        "roughness": np.array([1.0, 0.01, 0.5, 1.2, 0.0], np.float32),
        "metallic": np.array([0.0, 1.0, 0.3, -0.1, 1.5], np.float32),
        "base_color": np.array([[0.0, 1.0, 0.5, 1.0, 0.0]] * 3, np.float32),
        "clearcoat_roughness": np.array([1.0, 0.01, 0.2, 0.0, 2.0], np.float32),
    }
    fields = ("roughness", "roughness_alpha", "metallic", "base_color",
              "clearcoat_roughness", "clearcoat_roughness_alpha")
    weights = {f: rng.uniform(0.5, 2.0, (3, 5) if f == "base_color" else (5,)).astype(np.float32)
               for f in fields}
    jax_scene = jax_cornell_box(light="point", with_spheres=True)

    def jax_f(p):
        m = jax_inverse.apply_material_params(jax_scene, p).materials
        return sum(jnp.sum(getattr(m, f) * weights[f]) for f in fields)

    want = jax.grad(jax_f)({k: jnp.asarray(v) for k, v in values.items()})
    scene = cornell_box(light="point", with_spheres=True)
    p = params_from_arrays(values, device="cpu")
    m = apply_material_params(scene, p).materials
    sum((getattr(m, f) * torch.from_numpy(weights[f])).sum() for f in fields).backward()
    for k in values:
        np.testing.assert_array_equal(p[k].grad.numpy(), np.asarray(want[k]), err_msg=k)
    assert p["roughness"].grad[0] != 0.0  # half, not zero, at the tie


# --- the port alone (tests/test_inverse.py's cases) ------------------------------


def _fd_check(loss_fn, params, key, eps, rtol, idx=()):
    """Central difference of d loss / d params[key] at one element."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    loss_fn(p).backward()
    an = float(p[key].grad[idx])
    with torch.no_grad():
        delta = torch.zeros_like(params[key])
        delta[idx] = eps
        lp = float(loss_fn({**params, key: params[key] + delta}))
        lm = float(loss_fn({**params, key: params[key] - delta}))
    fd = (lp - lm) / (2 * eps)
    assert np.isfinite(an) and np.isfinite(fd)
    assert fd != 0.0, f"{key}: FD is zero, a bad probe"
    assert np.isclose(an, fd, rtol=rtol), f"{key}: grad {an} vs FD {fd}"


@pytest.fixture(scope="module")
def setup():
    scene = cornell_box(light="point", with_spheres=False)
    camera = orbit_camera(24, 24, distance=6.0, focal_length_mm=35.0)
    ctx = make_context(OPTS, device="cpu")  # the rebuild mode: every parameter differentiable
    loss_fn = make_loss_fn(scene, camera, ctx, OPTS, torch.zeros((24, 24, 3)))
    return scene, camera, ctx, loss_fn


def test_point_color_fd(setup):
    scene, _, _, loss_fn = setup
    _fd_check(loss_fn, {"light.point_color": scene.lights.point_color}, "light.point_color",
              1e-2, 0.03, (0, 1))


def test_point_position_fd(setup):
    scene, _, _, loss_fn = setup
    _fd_check(loss_fn, {"light.point_position": scene.lights.point_position},
              "light.point_position", 2e-3, 0.08, (0, 0))


@pytest.fixture(scope="module")
def env_loss():
    """The environment as the only light: exposure also moves the
    light-selection CDF, and the discrete selection takes no gradient."""
    scene = cornell_box(light="point", with_spheres=False)
    scene = dataclasses.replace(scene, lights=dataclasses.replace(
        scene.lights, env_enabled=1, num_point=0))
    camera = orbit_camera(24, 24, distance=6.0, focal_length_mm=35.0)
    return make_loss_fn(scene, camera, make_context(OPTS, device="cpu"), OPTS,
                        torch.zeros((24, 24, 3)))


def test_env_solid_color_fd(env_loss):
    _fd_check(env_loss, {"env.solid_color": torch.tensor([0.5, 0.5, 0.5])}, "env.solid_color",
              1e-2, 0.03, (0,))


def test_env_exposure_fd(env_loss):
    params = {"env.solid_color": torch.tensor([0.5, 0.5, 0.5]), "env.exposure": torch.tensor(0.5)}
    _fd_check(env_loss, params, "env.exposure", 1e-2, 0.03)


def test_orbit_grad_is_descent_direction(setup):
    """Camera gradients cross visibility edges (a biased estimator): a step
    against the gradient lowers the loss toward a target rendered at
    another orbit angle."""
    scene, camera, ctx, _ = setup
    target_cam = orbit_camera(24, 24, distance=6.0, phi=0.12, focal_length_mm=35.0)
    with torch.no_grad():
        accum, _ = render(scene, target_cam, OPTS, num_passes=2, ctx=ctx, device="cpu")
    loss_fn = make_loss_fn(scene, camera, ctx, OPTS, resolve(accum), num_passes=2)
    orbit = torch.tensor([6.0, 0.0, 0.0], requires_grad=True)
    loss0 = loss_fn({"camera.orbit": orbit})
    loss0.backward()
    g = orbit.grad
    assert torch.isfinite(g).all() and float(g.abs().sum()) > 0
    with torch.no_grad():
        loss1 = loss_fn({"camera.orbit": orbit - 0.02 * g / g.abs().max().clamp(min=1e-9)})
    assert float(loss1) < float(loss0), (float(loss0), float(loss1))


def test_focus_aperture_finite(setup):
    _, _, _, loss_fn = setup
    p = params_from_arrays({"camera.focus_distance": np.float32(6.0),
                            "camera.aperture_radius": np.float32(0.05)}, device="cpu")
    loss_fn(p).backward()
    assert all(torch.isfinite(v.grad).all() for v in p.values())


def test_orbit_matrix_matches_jax():
    """The torch orbit matrix equals ``orbit_view_matrix_jnp``'s, and every
    orbit input takes a gradient."""
    for args in ((6.0, 0.0, 0.0, (0.0, 0.0, 0.0)), (4.2, 0.3, -0.7, (0.1, -0.5, 2.0))):
        want = np.asarray(orbit_view_matrix_jnp(*args))
        np.testing.assert_allclose(orbit_view_matrix_torch(*args).numpy(), want, atol=1e-6)
    d, phi, theta, target = (torch.tensor(v, requires_grad=True)
                             for v in (4.2, 0.3, -0.7, [0.1, -0.5, 2.0]))
    orbit_view_matrix_torch(d, phi, theta, target)[:3, 3].sum().backward()
    assert all(float(v.grad.abs().sum()) > 0 for v in (d, phi, theta, target))


def test_apply_light_params_normalizes_direction():
    scene = cornell_box(light="point", with_spheres=False)
    s = apply_light_params(scene, {"light.dir_direction": torch.ones((5, 3))})
    torch.testing.assert_close(s.lights.dir_direction.norm(dim=-1), torch.ones(5))


def test_apply_camera_orbit_matches_host():
    cam = orbit_camera(24, 24, distance=6.0, focal_length_mm=35.0)
    cam2 = apply_camera_params(cam, {"camera.orbit": torch.tensor([6.0, 0.0, 0.0])})
    torch.testing.assert_close(cam2.view_matrix, cam.view_matrix, rtol=0, atol=1e-5)


def test_material_params_guarded_against_baked_table():
    scene = cornell_box(light="point", with_spheres=False)
    camera = orbit_camera(24, 24, distance=6.0, focal_length_mm=35.0)
    ctx = make_context(OPTS, scene, device="cpu")  # a baked shading table
    loss_fn = make_loss_fn(scene, camera, ctx, OPTS, torch.zeros((24, 24, 3)))
    with pytest.raises(ValueError, match="static_shading"):
        loss_fn({"base_color": scene.materials.base_color})


def test_recovers_light_color():
    """Optimize a wrong light colour toward a target render; colours are
    O(100) W, so the step size matches that scale, and a fixed QMC window
    keeps the losses comparable."""
    scene = cornell_box(light="point", with_spheres=False)
    camera = orbit_camera(24, 24, distance=6.0, focal_length_mm=35.0)
    ctx = make_context(OPTS, device="cpu")
    with torch.no_grad():
        accum, _ = render(scene, camera, OPTS, num_passes=2, ctx=ctx, device="cpu")
    wrong = scene.lights.point_color * torch.tensor([[0.3, 1.6, 0.6]] * 5)
    params, losses = optimize(scene, camera, ctx, OPTS, resolve(accum),
                              {"light.point_color": wrong}, steps=25, learning_rate=15.0,
                              num_passes=1, rotate_samples=False)
    assert losses[-1] < losses[0] * 0.5, losses
    assert not params["light.point_color"].requires_grad


def _material_grads(opts, scene, camera, static_shading=False, count=None):
    """d mean(img^2) / d (base_color, roughness) of one pass (bench.py's
    step); ``count`` collects the intersector calls of the forward and of
    the backward."""
    ctx = make_context(opts, scene, device="cpu", static_shading=static_shading)
    params = params_from_arrays({"base_color": scene.materials.base_color.numpy(),
                                 "roughness": scene.materials.roughness.numpy()}, device="cpu")
    zero = torch.zeros((4, opts.height, opts.width))
    a = integrator.render_pass(apply_material_params(scene, params), camera, ctx, opts,
                               FrameGlobals.create(0), zero)
    img = a[:3] / torch.clamp(a[3:], min=1.0)
    loss = torch.mean(img * img)
    if count is not None:
        count["forward"], count["calls"] = count["calls"], 0
    loss.backward()
    return {k: v.grad for k, v in params.items()}


@pytest.mark.parametrize("gate", [False, True])
def test_sorted_gradients_match_unsorted(gate, monkeypatch):
    """The bounce sort, with and without gating, is a permutation under
    autograd too: test_gating.py's case (depth 3) at 24x24 and 16 segments,
    so that the gate cuts lanes at depth 3, forcing the sort on the CPU, at
    its tolerance."""
    scene = cornell_box(light="both", with_spheres=True)
    camera = orbit_camera(24, 24, distance=6.2, focal_length_mm=35.0)
    base = RenderOptions(width=24, height=24, max_render_passes=4, max_ray_depth=3,
                         gate_segments=16)
    want = _material_grads(dataclasses.replace(base, sort_bounces=False), scene, camera)
    opts = dataclasses.replace(base, sort_bounces=True, gate_bounces=gate)
    ctx = make_context(opts, scene, device="cpu", static_shading=False)
    assert integrator._bounce_modes(ctx, opts, 24 * 24) == (True, gate)
    lanes, gated = [], integrator._gated_lanes

    def count_lanes(*args):
        lanes.append(gated(*args))
        return lanes[-1]

    monkeypatch.setattr(integrator, "_gated_lanes", count_lanes)
    got = _material_grads(opts, scene, camera)
    assert not gate or min(lanes) < 24 * 24, lanes
    for k in want:
        assert float(want[k].abs().max()) > 0.0, k
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-5, atol=1e-8,
                                   err_msg=k)


def test_remat_is_transparent_and_backward_traces_nothing(monkeypatch):
    """``remat_bounces`` on and off give bit-equal gradients at depth 2;
    each bounce queries both intersectors once in the forward, and the
    backward (with remat, a recompute of each bounce's shading) calls none."""
    count = {"calls": 0}

    def counted(fn):
        def wrapper(*args, **kwargs):
            count["calls"] += 1
            return fn(*args, **kwargs)
        return wrapper

    for route, fns in list(integrator._INTERSECTORS.items()):
        monkeypatch.setitem(integrator._INTERSECTORS, route, tuple(counted(f) for f in fns))
    scene = cornell_box(light="both", with_spheres=True)
    camera = orbit_camera(24, 24, distance=6.2, focal_length_mm=35.0)
    grads = {}
    for remat in (True, False):
        count["calls"] = 0
        grads[remat] = _material_grads(dataclasses.replace(OPTS, remat_bounces=remat), scene,
                                       camera, count=count)
        assert (count["forward"], count["calls"]) == (2 * OPTS.max_ray_depth, 0), (remat, count)
    for k in grads[True]:
        assert torch.equal(grads[True][k], grads[False][k]), k
    assert float(grads[True]["roughness"][5]) != 0.0


def test_in_graph_table_renders_as_baked():
    """Without autograd, a pass through a per-pass table equals one through
    the baked table, bit for bit, on ``"wide"`` (slot order) and ``"bvh"``
    (triangle order)."""
    scene = cornell_box(light="both", with_spheres=True)
    camera = orbit_camera(16, 16, distance=6.2, focal_length_mm=35.0)
    zero = torch.zeros((4, 16, 16))
    for backend in ("wide", "bvh"):
        opts = RenderOptions(width=16, height=16, max_render_passes=4, max_ray_depth=2,
                             intersect_backend=backend)
        out = [integrator.render_pass(
            scene, camera, make_context(opts, scene, device="cpu", static_shading=s), opts,
            FrameGlobals.create(1), zero) for s in (True, False)]
        assert torch.equal(out[0], out[1]), backend
