"""The port's forward render of the Cornell box against the JAX package:
per pixel at 16x16 (one pass, depth 4; also through the transposed leaf
math, ``wide_leaf_math="vpu"``), and against the stored goldens of
``tests/test_goldens.py``'s config2 (the Cornell box), config1 (a
directional light) and config4 (glass and hexagon-bokeh depth of field
under a solid environment) at 48x48, 4 passes."""

import dataclasses
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from heatray_tpu.camera import orbit_camera as jax_orbit_camera
from heatray_tpu.options import RenderOptions as JaxRenderOptions
from heatray_tpu.render import render as jax_render
from heatray_tpu.render import resolve as jax_resolve
from heatray_tpu.scene.builtin import cornell_box as jax_cornell_box
from heatray_tpu_torch import RenderOptions, cornell_box, orbit_camera, render, resolve
from heatray_tpu_torch.bridge import camera_from_arrays, scene_from_arrays
from heatray_tpu_torch.options import FrameGlobals
from heatray_tpu_torch.render.integrator import make_context, render_pass
from heatray_tpu_torch.utils.threads import share_cores

from test_torch_cuda import GOLDEN_PASSES, golden_config

share_cores(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))


GOLDENS = Path(__file__).parent / "goldens"
GOLDEN = GOLDENS / "config2_cornell.npy"
SMALL = 16


def _arrays(obj):
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


def _options(size, passes=4):
    return RenderOptions(width=size, height=size, max_render_passes=passes, max_ray_depth=4)


@pytest.fixture(scope="module")
def jax_small():
    """The JAX package's 16x16 one-pass render on its exact-f32 brute-force
    backend, unsorted (its JIT compile dominates this file's time)."""
    opts = JaxRenderOptions(
        width=SMALL, height=SMALL, max_render_passes=4, max_ray_depth=4,
        intersect_backend="xla", sort_bounces=False,
    )
    scene = jax_cornell_box(light="both", with_spheres=True)
    camera = jax_orbit_camera(SMALL, SMALL, distance=6.2, focal_length_mm=35.0)
    accum, _ = jax_render(scene, camera, opts, num_passes=1)
    return scene, camera, np.asarray(jax_resolve(accum))


@pytest.fixture(scope="module")
def port_small():
    scene = cornell_box(light="both", with_spheres=True)
    camera = orbit_camera(SMALL, SMALL, distance=6.2, focal_length_mm=35.0)
    accum, _ = render(scene, camera, _options(SMALL), num_passes=1, device="cpu")
    return accum


def test_small_render_matches_jax(jax_small, port_small):
    """Per pixel.  Shading agrees to rtol 1e-4 (float reassociation in
    XLA); four bounces and up to nine clamped contributions per pixel grow
    that to rtol 1e-3, atol 1e-4 on radiances up to ~10."""
    img = resolve(port_small).numpy()
    assert img.shape == (SMALL, SMALL, 3) and np.isfinite(img).all()
    np.testing.assert_allclose(img, jax_small[2], rtol=1e-3, atol=1e-4)


def test_small_render_vpu_leaf_math_matches_jax(jax_small):
    """Route A, ``wide_leaf_math="vpu"``: the leaf of 32 rounded up to 128
    and the transposed kernels' queries (their plain versions here), per
    pixel against the same JAX render at the same tolerance."""
    scene = cornell_box(light="both", with_spheres=True)
    camera = orbit_camera(SMALL, SMALL, distance=6.2, focal_length_mm=35.0)
    opts = dataclasses.replace(_options(SMALL), wide_leaf_math="vpu")
    accum, ctx = render(scene, camera, opts, num_passes=1, device="cpu")
    assert (ctx.accel_pack.route, ctx.accel_pack.wide.leaf_size) == ("wide/vpu", 128)
    np.testing.assert_allclose(resolve(accum).numpy(), jax_small[2], rtol=1e-3, atol=1e-4)


def test_bridged_scene_renders_identically(jax_small, port_small):
    """The JAX package's scene and camera, carried over as arrays, render
    bit for bit like the port's own builders."""
    jax_scene, jax_camera, _ = jax_small
    scene = scene_from_arrays(
        _arrays(jax_scene.geometry), _arrays(jax_scene.materials), _arrays(jax_scene.lights),
        has_alpha_mask=jax_scene.has_alpha_mask, has_textures=jax_scene.has_textures,
        device="cpu",
    )
    camera = camera_from_arrays(_arrays(jax_camera), device="cpu")
    own = orbit_camera(SMALL, SMALL, distance=6.2, focal_length_mm=35.0)
    for f in dataclasses.fields(own):
        assert torch.equal(getattr(own, f.name), getattr(camera, f.name)), f.name
    accum, _ = render(scene, camera, _options(SMALL), num_passes=1, device="cpu")
    assert torch.equal(accum, port_small)


def test_config2_golden():
    """The golden config2 (48x48, 4 passes, depth 4) at test_goldens.py's
    tolerance; alpha counts the passes.  The render stops after 3 passes
    and resumes from its accumulation for the last one."""
    size, passes = 48, 4
    scene = cornell_box(light="both", with_spheres=True)
    camera = orbit_camera(size, size, distance=6.2, focal_length_mm=35.0)
    seen = []
    accum, ctx = render(scene, camera, _options(size, passes), num_passes=passes - 1, device="cpu",
                        pass_callback=lambda i, a: seen.append((i, float(a[3].max()))))
    accum, _ = render(scene, camera, _options(size, passes), num_passes=1, ctx=ctx, device="cpu",
                      accum=accum, start_pass=passes - 1,
                      pass_callback=lambda i, a: seen.append((i, float(a[3].max()))))
    assert seen == [(i, float(i + 1)) for i in range(passes)]
    assert torch.equal(accum[3], torch.full((size, size), float(passes)))
    img = resolve(accum).numpy()
    assert np.isfinite(img).all() and img.max() > 0.0
    golden = np.load(GOLDEN).astype(np.float32)
    np.testing.assert_allclose(img, golden, rtol=5e-3, atol=5e-3)


def test_render_pass_stats():
    """``with_stats`` counts per bounce the live closest-hit lanes plus the
    shadow lanes, and does not change the image."""
    size = 8
    opts = _options(size)
    scene = cornell_box(light="both", with_spheres=True)
    camera = orbit_camera(size, size, distance=6.2, focal_length_mm=35.0)
    ctx = make_context(opts, scene, device="cpu")
    zero = torch.zeros((4, size, size))
    frame = FrameGlobals.create(0)
    plain = render_pass(scene, camera, ctx, opts, frame, zero)
    accum, stats = render_pass(scene, camera, ctx, opts, frame, zero, with_stats=True)
    assert torch.equal(plain, accum)
    # Camera rays all live at depth 1, and the closed box keeps most alive.
    assert size * size * 4 < stats["rays"] <= size * size * 2 * opts.max_ray_depth
    # Pass debugging renders exactly the chosen pass, whatever num_passes says.
    debug = dataclasses.replace(opts, debug_pass_rendering=True, debug_pass_index=0)
    single, _ = render(scene, camera, debug, num_passes=3, ctx=ctx, device="cpu")
    assert torch.equal(single, plain)


@pytest.mark.parametrize("name", ["config1_sphere_plane", "config4_glass_dof"])
def test_golden(name):
    """config1 and config4 at test_goldens.py's tolerance."""
    scene, camera, opts = golden_config(name)
    accum, _ = render(scene, camera, opts, num_passes=GOLDEN_PASSES, device="cpu")
    img = resolve(accum).numpy()
    assert np.isfinite(img).all() and img.max() > 0.0
    golden = np.load(GOLDENS / f"{name}.npy").astype(np.float32)
    np.testing.assert_allclose(img, golden, rtol=5e-3, atol=5e-3)
