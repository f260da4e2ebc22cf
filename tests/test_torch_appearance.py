"""The port's appearance modules against the JAX package on the CPU: the
display chain (``post/pipeline.py``), the AOVs (``render/aov.py``), the
procedural environment maps and the lat/long lookup with its gradients, and
the goldens that need them: config3 (a lat/long environment) and config5
(``multi_material`` through ACES), with the NaN and Inf detectors on config2
and config4 (``tests/test_goldens.py``).  No JAX render is compiled here.

Tolerance atol 1e-6 on the elementwise functions: both sides do the same
float32 operations, and XLA may fuse or reassociate them by an ulp.
"""

import dataclasses
import os
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heatray_tpu import post as jax_post
from heatray_tpu.ops import build_woop as jax_build_woop
from heatray_tpu.options import AOV as JaxAOV
from heatray_tpu.render import aov as jax_aov
from heatray_tpu.render import envmap as jax_envmap
from heatray_tpu.render import shade_table as jax_st
from heatray_tpu.render import texture as jax_texture
from heatray_tpu.scene import environments as jax_environments
from heatray_tpu.scene import lights as jax_lights
from heatray_tpu.scene import materials as jax_materials
from heatray_tpu.scene import providers as jax_providers
from heatray_tpu.scene import scene as jax_scene_mod
from heatray_tpu.scene.geometry import translate as jax_translate
from heatray_tpu.vec import Vec3 as JaxVec3
from heatray_tpu_torch import make_context, make_loss_fn, orbit_camera, render, resolve
from heatray_tpu_torch.bridge import scene_from_arrays
from heatray_tpu_torch.options import AOV
from heatray_tpu_torch.post import pipeline
from heatray_tpu_torch.render import aov, envmap, shade_table, texture
from heatray_tpu_torch.scene import environments, lights
from heatray_tpu_torch.utils.threads import share_cores
from heatray_tpu_torch.vec import Vec3

from test_torch_cuda import GOLDEN_PASSES, golden_config

share_cores(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))


GOLDENS = Path(__file__).parent / "goldens"
ATOL = 1e-6


def _arrays(obj):
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(ours, ref, atol=ATOL, name=""):
    if isinstance(ours, Vec3):
        for k in "xyz":
            _close(getattr(ours, k), getattr(ref, k), atol, f"{name}.{k}")
        return
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), rtol=0.0, atol=atol,
                               err_msg=name)


# --- the display chain --------------------------------------------------------

OFF_DEFAULT = dict(tonemapping_enabled=True, exposure=0.7, brightness=0.05, contrast=1.2,
                   hue=0.9, saturation=1.3, vibrance=0.4, red=1.1, green=0.95, blue=0.8,
                   vignette_intensity=0.6, vignette_falloff=0.9)


@pytest.mark.parametrize("params, atol", [({}, ATOL), (OFF_DEFAULT, 5e-6)],
                         ids=["defaults", "every-param-off-default"])
def test_post_pipeline_matches_jax(params, atol):
    """A seeded HDR accumulation of 3 passes, with negatives and zeros.
    Each stage agrees to an ulp or two: XLA's 3x3 ``dot`` rounds in an
    order no elementwise sum reproduces, and its ``sqrt``, like float32
    ``pow``, differs from torch's by an ulp on some inputs.  Two spots of the
    chain grow that: where saturation lifts HSV's s above 1,
    ``hsv_to_rgb``'s ``1 + s * (q - 1)`` cancels, and the vignette's
    smoothstep band is some 20x steeper than the distance it reads.  With
    every parameter off its default both occur, and a few pixels differ by
    a few 1e-6, so that case is held at 5e-6; the defaults at 1e-6."""
    rng = np.random.default_rng(3)
    accum = rng.gamma(0.8, 1.5, (4, 24, 32)).astype(np.float32)
    accum[:3, 2:4] *= -0.1
    accum[:3, 5, :4] = 0.0
    accum[3] = 3.0
    ours = pipeline.apply_post_pipeline(_t(accum), pipeline.PostProcessingParams(**params))
    ref = jax_post.apply_post_pipeline(jnp.asarray(accum), jax_post.PostProcessingParams(**params))
    assert ours.shape == (24, 32, 3)
    _close(ours, ref, atol=atol)


def test_hsv_and_aces_match_jax():
    """Grey (the hue's 0/0 guard), the primaries, the secondaries and
    negatives (``jnp.mod``'s floor modulo of the red sector's hue)."""
    c = np.array([[0.5, 0.5, 0.5], [0.0, 0.0, 0.0], [1, 0, 0], [0, 1, 0], [0, 0, 1],
                  [1, 1, 0], [0, 1, 1], [1, 0, 1], [0.2, -0.3, 0.1], [-0.5, -0.2, -0.9],
                  [0.3, 0.1, 0.6], [5.0, 0.2, 0.1]], np.float32)
    from heatray_tpu.post import pipeline as jax_pipeline

    hsv = pipeline.rgb_to_hsv(_t(c))
    _close(hsv, jax_pipeline.rgb_to_hsv(jnp.asarray(c)))
    _close(pipeline.hsv_to_rgb(hsv), jax_pipeline.hsv_to_rgb(jnp.asarray(hsv.numpy())))
    hdr = np.abs(c) * 4.0
    _close(pipeline.aces_tonemap(_t(hdr)), jax_pipeline.aces_tonemap(jnp.asarray(hdr)))


# --- AOVs ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def aov_setup():
    """A textured scene (a quad with normal and clearcoat-normal maps, a
    glass sphere, a double-sided PBR sphere), its JAX table with the texture
    tail, and 512 seeded rows of it with barycentrics and facing, beside the
    bridged port scene and the same rows."""
    rng = np.random.default_rng(5)
    b = jax_scene_mod.SceneBuilder()
    nm = b.add_texture(rng.random((8, 16, 3)).astype(np.float32))
    ccn = b.add_texture(rng.random((4, 4, 3)).astype(np.float32))
    b.add_mesh(jax_providers.plane_mesh(4, 4), jax_materials.PBRParams(
        base_color=(0.7, 0.6, 0.5), roughness=0.4, metallic=0.3, clearcoat=0.5,
        clearcoat_roughness=0.2, emissive=(0.1, 0.0, 0.2), normal_tex=nm,
        clearcoat_normal_tex=ccn))
    b.add_mesh(jax_providers.sphere_mesh(8, 8, 0.7), jax_materials.GlassParams(),
               transform=jax_translate([1.0, 0.7, 0.0]))
    b.add_mesh(jax_providers.sphere_mesh(8, 8, 0.5), jax_materials.PBRParams(double_sided=True),
               transform=jax_translate([-1.0, 0.5, 0.0]))
    jscene = b.build()
    accel = jax_build_woop(jscene.geometry.positions, jscene.geometry.indices)
    table = jax_st.build_shade_table(jscene, accel, textured=True)
    r = 512
    ids = rng.integers(0, table.shape[0], r).astype(np.int32)
    b1 = rng.uniform(0, 0.6, r).astype(np.float32)
    b2 = rng.uniform(0, 0.4, r).astype(np.float32)
    front = rng.random(r) < 0.5
    hit = rng.random(r) < 0.9
    scene = scene_from_arrays(
        _arrays(jscene.geometry), _arrays(jscene.materials), _arrays(jscene.lights),
        has_alpha_mask=jscene.has_alpha_mask, has_textures=jscene.has_textures,
        atlas=_arrays(jscene.atlas), device="cpu")
    ours = shade_table.build_shade_table(scene, _accel_of(scene), textured=True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(table), rtol=1e-6, atol=1e-7)
    jrows = jax_st.HitRows(jnp.take(table, ids, axis=0))
    rows = shade_table.HitRows(_t(np.asarray(jrows.rows)))
    return (jscene, jrows, scene, rows, b1, b2, front, hit)


def _accel_of(scene):
    from heatray_tpu_torch.ops.intersect import build_woop

    return build_woop(scene.geometry.positions, scene.geometry.indices)


@pytest.mark.parametrize("mode", sorted(aov.SURFACE_AOVS, key=lambda m: m.value),
                         ids=lambda m: m.value)
def test_surface_aov_matches_jax(aov_setup, mode):
    jscene, jrows, scene, rows, b1, b2, front, hit = aov_setup
    ours = aov.compute_surface_aov(scene, mode, rows, _t(b1), _t(b2), _t(front), _t(hit))
    ref = jax_aov.compute_surface_aov(jscene, JaxAOV(mode.value), jrows, jnp.asarray(b1),
                                      jnp.asarray(b2), jnp.asarray(front), jnp.asarray(hit))
    _close(ours, ref, name=mode.value)
    if mode in (AOV.NORMALMAP, AOV.CLEARCOAT_NORMALMAP, AOV.SHADER):
        assert float(ours.x.abs().max()) > 0.0


def test_accum_visualize():
    """A contribution with a NaN (an Inf) component shows as 100, any other
    as min(c, 1) * 0.1, a NaN passing through ``minimum``."""
    nan, inf = float("nan"), float("inf")
    c = Vec3(torch.tensor([nan, 0.5, 2.0, inf, -1.0]),
             torch.tensor([0.1, inf, 0.3, 0.2, 0.0]),
             torch.tensor([0.2, 0.3, nan, -inf, 7.0]))
    nans = aov.accum_visualize(AOV.NANS, c)
    infs = aov.accum_visualize(AOV.INFS, c)
    torch.testing.assert_close(nans.x, torch.tensor([100.0, 0.05, 100.0, 0.1, -0.1]))
    torch.testing.assert_close(infs.z, torch.tensor([0.02, 100.0, nan, 100.0, 0.1]),
                               equal_nan=True)
    jc = JaxVec3(*(jnp.asarray(v.numpy()) for v in (c.x, c.y, c.z)))
    for mode, ours in ((AOV.NANS, nans), (AOV.INFS, infs)):
        ref = jax_aov.accum_visualize(JaxAOV(mode.value), jc)
        for k in "xyz":
            np.testing.assert_array_equal(getattr(ours, k).numpy(), np.asarray(getattr(ref, k)))
    with pytest.raises(ValueError, match="accumulator"):
        aov.accum_visualize(AOV.UVS, c)


# --- the built-in scenes ------------------------------------------------------

@pytest.mark.parametrize("name", ["editable_pbr", "editable_glass", "multi_material",
                                  "sphere_array", "box_mesh"])
def test_builtin_scenes_equal_jax(name):
    """Every array of the port's built-in scene (under the studio map) equals
    the JAX package's; ``box_mesh`` (its own and inward) as a scene's only
    meshes."""
    if name == "box_mesh":
        def build(pkg, lights_mod):
            b = pkg.SceneBuilder()
            b.add_mesh(pkg.box_mesh((1.0, 2.0, 0.5)), pkg.PBRParams())
            b.add_mesh(pkg.box_mesh(inward=True), pkg.PBRParams(),
                       transform=pkg.translate([3, 0, 0]))
            return b.build()
    else:
        def build(pkg, lights_mod):
            env = lights_mod.EnvironmentLightDesc(image=environments.get_environment("studio"))
            return getattr(pkg, name)(env=env)

    from heatray_tpu.scene import builtin as jax_builtin
    from heatray_tpu_torch.scene import builtin, geometry, materials, providers
    from heatray_tpu_torch.scene.scene import SceneBuilder

    port = types.SimpleNamespace(SceneBuilder=SceneBuilder, box_mesh=providers.box_mesh,
                                 PBRParams=materials.PBRParams, translate=geometry.translate,
                                 **{k: getattr(builtin, k) for k in ("editable_pbr",
                                    "editable_glass", "multi_material", "sphere_array")})
    ref_pkg = types.SimpleNamespace(SceneBuilder=jax_scene_mod.SceneBuilder,
                                    box_mesh=jax_providers.box_mesh,
                                    PBRParams=jax_materials.PBRParams, translate=jax_translate,
                                    **{k: getattr(jax_builtin, k) for k in ("editable_pbr",
                                       "editable_glass", "multi_material", "sphere_array")})
    ours, ref = build(port, lights), build(ref_pkg, jax_lights)
    assert (ours.has_textures, ours.has_alpha_mask) == (ref.has_textures, ref.has_alpha_mask)
    for part in ("geometry", "materials", "lights"):
        want = _arrays(getattr(ref, part))
        for f in dataclasses.fields(getattr(ours, part)):
            got = getattr(getattr(ours, part), f.name)
            got = got.numpy() if isinstance(got, torch.Tensor) else got
            np.testing.assert_array_equal(got, want[f.name], err_msg=f"{part}.{f.name}")


# --- environments and the lat/long lookup -------------------------------------

@pytest.mark.parametrize("name", sorted(environments.BUILTIN_ENVIRONMENTS))
def test_environments_equal_jax(name):
    ours = environments.get_environment(name, 24, 40)
    assert ours.shape == (24, 40, 3) and ours.dtype == np.float32
    np.testing.assert_array_equal(ours, jax_environments.get_environment(name, 24, 40))


def _directions():
    """Seeded unit directions, the poles, the seam (x = +-0 behind -z) and
    lanes just either side of it."""
    rng = np.random.default_rng(11)
    d = rng.normal(size=(200, 3)).astype(np.float32)
    special = np.array([[0, 1, 0], [0, -1, 0], [0.0, 0.3, 1.0], [-0.0, -0.2, 1.0],
                        [1e-6, 0.0, 1.0], [-1e-6, 0.0, 1.0], [0, 0, -1], [1, 0, 0]], np.float32)
    d = np.concatenate([special, d])
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def _env_banks(rotation, exposure, noise=True):
    """Light banks of a 16x32 map: seeded noise in [0, 3), or a smooth sky
    (config3's vertical ramp with a slow wave around the horizon)."""
    if noise:
        img = np.random.default_rng(2).random((16, 32, 3)).astype(np.float32) * 3.0
    else:
        v = np.linspace(3.0, 0.05, 16, dtype=np.float32)[:, None, None]
        u = np.linspace(0.0, 2.0 * np.pi, 32, dtype=np.float32)[None, :, None]
        img = (v * (1.0 + 0.05 * np.sin(u + np.array([0.0, 1.0, 2.0], np.float32)))
               ).astype(np.float32)
    desc = dict(image=img, rotation=rotation, exposure=exposure)
    return (lights.build_light_bank(environment=lights.EnvironmentLightDesc(**desc)),
            jax_lights.build_light_bank(environment=jax_lights.EnvironmentLightDesc(**desc)))


@pytest.mark.parametrize("noise", [False, True], ids=["smooth", "noise"])
@pytest.mark.parametrize("rotation, exposure", [(0.0, 0.0), (4.0, 1.5), (-1.2, -0.5)])
def test_env_radiance_matches_jax(rotation, exposure, noise):
    """A 16x32 map under rotation (4.0 takes the theta wrap) and exposure,
    and the bilinear and nearest lookups themselves on the same (u, v).  The
    lookups agree to 1e-6; the radiance of the smooth sky too.  XLA's
    ``atan2`` and torch's round some directions an ulp apart, and an ulp of
    u moves the bilinear weight by 32 ulps: over the noise, whose
    neighbouring texels differ by up to 8.5 after exposure, that is a few
    1e-6 of radiance, so the noise map's radiance is held at rtol 1e-5."""
    bank, jbank = _env_banks(rotation, exposure, noise)
    d = _directions()
    ours = envmap.env_radiance(bank, Vec3(*(_t(d[:, k]) for k in range(3))))
    ref = jax_envmap.env_radiance(jbank, JaxVec3(*(jnp.asarray(d[:, k]) for k in range(3))))
    for k in "xyz":
        np.testing.assert_allclose(getattr(ours, k).numpy(), np.asarray(getattr(ref, k)),
                                   rtol=1e-5 if noise else 0.0, atol=ATOL, err_msg=k)
    u = np.linspace(-0.3, 1.3, 97, dtype=np.float32)
    v = np.linspace(1.2, -0.2, 97, dtype=np.float32)
    for wrap in ((True, False), (False, True), (False, False)):
        got = texture.sample_bilinear_planar(bank.env_map, _t(u), _t(v), *wrap)
        want = jax_texture.sample_bilinear_planar(jbank.env_map, jnp.asarray(u), jnp.asarray(v),
                                                  *wrap)
        for a, b in zip(got, want):
            _close(a, b)
    _close(texture.sample_bilinear_scalar(bank.env_map[1], _t(u), _t(v), True, True),
           jax_texture.sample_bilinear_scalar(jbank.env_map[1], jnp.asarray(u), jnp.asarray(v),
                                              True, True))
    got = texture.sample_nearest_planar(bank.env_map, _t(u), _t(v))
    want = jax_texture.sample_nearest_planar(jbank.env_map, jnp.asarray(u), jnp.asarray(v))
    for a, b in zip(got, want):
        _close(a, b, atol=0.0)


def test_env_radiance_gradients_match_jax():
    """d(sum of the radiance)/d(map) and /d(rotation) against ``jax.grad``:
    the gradients run through the bilinear weights."""
    bank, jbank = _env_banks(4.0, 0.5)
    d = _directions()
    env_map = bank.env_map.clone().requires_grad_(True)
    rot = torch.tensor(4.0, requires_grad=True)
    out = envmap.env_radiance(dataclasses.replace(bank, env_map=env_map, env_rotation=rot),
                              Vec3(*(_t(d[:, k]) for k in range(3))))
    (out.x.sum() + out.y.sum() + out.z.sum()).backward()
    jd = JaxVec3(*(jnp.asarray(d[:, k]) for k in range(3)))

    def loss(m, r):
        o = jax_envmap.env_radiance(jbank.replace(env_map=m, env_rotation=r), jd)
        return o.x.sum() + o.y.sum() + o.z.sum()

    g_map, g_rot = jax.grad(loss, argnums=(0, 1))(jbank.env_map, jnp.float32(4.0))
    assert float(env_map.grad.abs().sum()) > 0.0 and float(rot.grad) != 0.0
    np.testing.assert_allclose(env_map.grad.numpy(), np.asarray(g_map), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(rot.grad), float(g_rot), rtol=1e-4)


# --- goldens config3 and config5; the NaN and Inf detectors -------------------

@pytest.mark.parametrize("name", ["config3_pbr_env", "config5_full_aces"])
def test_golden(name):
    """config3 (a 16x32 lat/long sky) and config5 (``multi_material`` under
    the default solid environment, through ACES) at test_goldens.py's
    tolerance."""
    scene, camera, opts = golden_config(name)
    accum, _ = render(scene, camera, opts, num_passes=GOLDEN_PASSES, device="cpu")
    img = resolve(accum).numpy()
    if name == "config5_full_aces":
        img = pipeline.apply_post_pipeline(
            accum, pipeline.PostProcessingParams(tonemapping_enabled=True)).numpy()
    assert np.isfinite(img).all() and img.max() > 0.0
    golden = np.load(GOLDENS / f"{name}.npy").astype(np.float32)
    np.testing.assert_allclose(img, golden, rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("name", ["config2_cornell", "config4_glass_dof"])
def test_nan_inf_cleanliness(name):
    """test_goldens.py's gate: a clean contribution dims to min(c, 1) * 0.1,
    so a clean depth-D pass stays under 0.1 * (2D + 1); a fired detector
    adds 100."""
    scene, camera, opts = golden_config(name)
    for mode in (AOV.NANS, AOV.INFS):
        accum, _ = render(scene, camera, dataclasses.replace(opts, aov=mode), num_passes=1,
                          device="cpu")
        img = resolve(accum).numpy()
        assert np.isfinite(img).all() and img.max() > 0.0
        assert img.max() <= 0.1 * (2 * opts.max_ray_depth + 1) + 1e-5, (name, mode, img.max())


def test_env_map_gradients_through_the_pass():
    """``diff.inverse``'s ``env.map`` and ``env.rotation`` over config3's
    sphere under the studio map (16x16, depth 2, a baked table: no material
    key): finite, nonzero, and the same with ``remat_bounces`` on and off,
    bit for bit."""
    scene, _, opts = golden_config("config3_pbr_env")
    studio = _t(environments.get_environment("studio", 16, 32).transpose(2, 0, 1))
    camera = orbit_camera(16, 16, distance=4.0, theta=0.3)
    grads = {}
    for remat in (True, False):
        o = dataclasses.replace(opts, width=16, height=16, max_ray_depth=2, remat_bounces=remat)
        ctx = make_context(o, scene, device="cpu")
        params = {"env.map": studio.clone().requires_grad_(True),
                  "env.rotation": torch.tensor(0.3, requires_grad=True)}
        make_loss_fn(scene, camera, ctx, o, np.zeros((16, 16, 3), np.float32))(params).backward()
        grads[remat] = {k: v.grad for k, v in params.items()}
    g = grads[True]
    assert all(bool(torch.isfinite(v).all()) for v in g.values())
    assert int((g["env.map"] != 0).sum()) > 0 and float(g["env.rotation"]) != 0.0
    for k, v in g.items():
        assert torch.equal(v, grads[False][k]), k
