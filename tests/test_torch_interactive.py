"""The port's interactive slice against the JAX package on the CPU: the 3x3
block mode (24x24, depth 2, the plane of ``tests/test_interactive.py``), an
edit script through both ``InteractiveRenderer``s (the Cornell box of
``tests/test_interactive_edit.py`` at 32x32, depth 2; one step after each
edit, each step a case), the material edit on the ``"wide"`` route against a
fresh context, the light rows' round trip, ``OrbitCamera``, the multiscatter
table (``ms_impl="lut"``), the ``"xla"`` backend's queries and the
subpackages' public names.

One JAX session, module-scoped, with two render compiles: the script's first
pass, and its options edit, which also turns the block mode on, so that its
step holds a block pass (depth 3, ``ms_impl="lut"``) against the JAX
package's."""

import dataclasses
import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heatray_tpu import interactive as jax_interactive
from heatray_tpu.camera import OrbitCamera as JaxOrbitCamera
from heatray_tpu.camera import orbit_camera as jax_orbit_camera
from heatray_tpu.ops import hit_attributes as jax_hit_attributes
from heatray_tpu.ops import intersect_any as jax_intersect_any
from heatray_tpu.ops import intersect_closest as jax_intersect_closest
from heatray_tpu.options import RenderOptions as JaxRenderOptions
from heatray_tpu.render import multiscatter as jax_multiscatter
from heatray_tpu.scene import DirectionalLight as JaxDirectionalLight
from heatray_tpu.scene import PBRParams as JaxPBRParams
from heatray_tpu.scene import SceneBuilder as JaxSceneBuilder
from heatray_tpu.scene import edit as jax_edit
from heatray_tpu.scene import plane_mesh as jax_plane_mesh
from heatray_tpu.scene.builtin import cornell_box as jax_cornell_box
from heatray_tpu.scene.lights import PointLight as JaxPointLight
from heatray_tpu.scene.lights import SpotLight as JaxSpotLight
from heatray_tpu_torch import AOV, RenderOptions, cornell_box, make_context, orbit_camera, render
from heatray_tpu_torch import interactive
from heatray_tpu_torch.camera import OrbitCamera
from heatray_tpu_torch.options import FrameGlobals
from heatray_tpu_torch.ops import intersect
from heatray_tpu_torch.render import multiscatter
from heatray_tpu_torch.render.integrator import render_pass
from heatray_tpu_torch.scene import DirectionalLight, PBRParams, SceneBuilder, plane_mesh
from heatray_tpu_torch.scene import edit as scene_edit
from heatray_tpu_torch.scene.lights import PointLight, SpotLight
from heatray_tpu_torch.utils.threads import share_cores
from heatray_tpu_torch.vec import Vec3

from test_torch_wide_bvh import _rays, _soup

share_cores(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))

# The tolerance of test_torch_render.py's test_small_render_matches_jax.
RTOL, ATOL = 1e-3, 1e-4
BLOCK = 24
EDIT = 32


# --------------------------------------------------------------------------
# The 3x3 block mode
# --------------------------------------------------------------------------


def _plane(builder, mesh, pbr, light):
    b = builder()
    b.add_mesh(mesh(30, 30), pbr(base_color=(1.0, 1.0, 1.0), roughness=1.0, specular_f0=0.0))
    b.add_directional_light(light(direction=(0.0, 1.0, 0.0), illuminance=683.0))
    return b.build()


def _block_options(cls, **kw):
    return cls(width=BLOCK, height=BLOCK, max_render_passes=8, max_ray_depth=2, **kw)


@pytest.fixture(scope="module")
def block_session():
    """The plane scene and camera of ``tests/test_interactive.py``, and the
    port's view of its geometry under the JAX package's."""
    scene = _plane(SceneBuilder, plane_mesh, PBRParams, DirectionalLight)
    ref = _plane(JaxSceneBuilder, jax_plane_mesh, JaxPBRParams, JaxDirectionalLight)
    np.testing.assert_array_equal(scene.geometry.positions.numpy(),
                                  np.asarray(ref.geometry.positions))
    return scene, orbit_camera(BLOCK, BLOCK, distance=5.0, theta=1.2)


def test_one_block_pass_covers_ninth(block_session):
    scene, camera = block_session
    opts = _block_options(RenderOptions, interactive_block=True)
    accum, _ = render(scene, camera, opts, num_passes=1, device="cpu")
    alpha = accum[3].numpy()
    assert np.isclose(alpha.mean(), 1.0 / 9.0)
    ys, xs = np.nonzero(alpha > 0)  # the block-0 lattice
    assert np.all(xs % 3 == 0) and np.all(ys % 3 == 0)
    assert (accum[:3].numpy()[:, alpha == 0] == 0).all()


@pytest.mark.parametrize("sort", [False, True], ids=["unsorted", "sorted"])
def test_nine_block_passes_equal_one_full_pass(block_session, sort):
    """Also sorted and gated (lanes in another order, each block's own
    live prefix): per pixel, the same samples as one full pass."""
    scene, camera = block_session
    modes = dict(sort_bounces=sort, gate_bounces=sort, gate_segments=4)
    full, _ = render(scene, camera, _block_options(RenderOptions, **modes), num_passes=1,
                     device="cpu")
    opts = _block_options(RenderOptions, interactive_block=True, **modes)
    blocks, _ = render(scene, camera, opts, num_passes=9, device="cpu")
    assert (blocks[3] == 1.0).all()  # every pixel once
    np.testing.assert_allclose(blocks.numpy(), full.numpy(), rtol=0, atol=1e-5)


def test_debug_pass_in_block_mode(block_session):
    """``debug_pass_rendering`` renders the chosen pass alone: pass 13 is
    block 4 at sample index 1."""
    scene, camera = block_session
    opts = _block_options(RenderOptions, interactive_block=True, debug_pass_rendering=True,
                          debug_pass_index=13)
    accum, ctx = render(scene, camera, opts, device="cpu")
    ys, xs = np.nonzero(accum[3].numpy())
    assert np.all(xs % 3 == 1) and np.all(ys % 3 == 1) and len(xs) == 64
    ref = render_pass(scene, camera, ctx, opts, FrameGlobals.create(13),
                      torch.zeros((4, BLOCK, BLOCK)))
    assert torch.equal(accum, ref)


def test_block_pass_surface_aov_counts_every_pixel(block_session):
    """A surface AOV in block mode counts the pass on every pixel, as the
    JAX package's does (ROADMAP F18): the block's pixels hold the
    attribute, the others a miss's zero."""
    scene, camera = block_session
    opts = _block_options(RenderOptions, interactive_block=True, aov=AOV.GEOMETRIC_NORMALS)
    accum, _ = render(scene, camera, opts, num_passes=1, device="cpu")
    full, _ = render(scene, camera, dataclasses.replace(opts, interactive_block=False),
                     num_passes=1, device="cpu")
    assert (accum[3] == 1.0).all()
    on = torch.zeros(BLOCK, BLOCK, dtype=torch.bool)
    on[::3, ::3] = True
    assert torch.equal(accum[:3, on], full[:3, on])
    assert (accum[:3, ~on] == 0).all() and (full[:3, ~on] != 0).any()


@pytest.mark.parametrize("backend", ["wide", "xla"])
def test_block_passes_agree_across_backends(block_session, backend):
    """Blocks 4 and 8 (sample index 0) and 9 (block 0, sample index 1) on
    the plain "wide" walk and on the "xla" brute force, against the rebuild
    mode's chunks: the same pixels, the same values."""
    scene, camera = block_session
    out = {}
    for name in (backend, "pallas"):
        opts = _block_options(RenderOptions, interactive_block=True, intersect_backend=name)
        ctx = make_context(opts, None if name == "pallas" else scene, "cpu")
        out[name] = [render_pass(scene, camera, ctx, opts, FrameGlobals.create(k),
                                 torch.zeros((4, BLOCK, BLOCK))) for k in (4, 8, 9)]
    for got, ref in zip(out[backend], out["pallas"]):
        assert torch.equal(got[3], ref[3])
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------
# The edit script through both InteractiveRenderers
# --------------------------------------------------------------------------

EDIT_SCRIPT = [
    ("first pass", None),
    ("material", {"type": "material", "index": 0, "base_color": [1.0, 0.05, 0.05],
                  "roughness": 0.5, "specular_f0": 0.5}),
    ("point light", {"type": "point_light", "index": 0, "color": [1.0, 0.5, 0.25]}),
    ("spot add", {"type": "spot_light", "index": 9, "position": [0.0, 1.9, 0.0],
                  "direction": [0.0, -1.0, 0.0], "inner_angle": 0.3, "outer_angle": 0.6,
                  "luminous_intensity": 300.0}),
    ("spot remove", {"type": "spot_light", "index": 0, "remove": True}),
    ("env", {"type": "env", "solid_color": [0.2, 0.3, 0.4], "exposure": 1.0,
             "enabled": True}),
    ("camera", {"type": "camera", "distance": 5.5, "phi": 0.2}),
    ("post", {"type": "post", "exposure": 1.0}),
    ("transform", {"type": "transform", "yaw": 15.0, "scale": 0.9}),
    ("options", {"type": "options", "max_ray_depth": 3, "ms_impl": "lut",
                 "interactive_block": True}),
]


class _Queue:
    """A viewer stand-in: hands ``poll_and_apply`` one edit at a time."""

    def __init__(self):
        self.edits = []

    def poll_edits(self):
        edits, self.edits = self.edits, []
        return edits

    def update(self, *args):
        pass


def _drive(renderer, to_numpy):
    """Each step of the script: the edit through ``poll_and_apply``, then
    one pass.  Returns per step (accum, pass_index, scene_info, lights)."""
    renderer.viewer = _Queue()
    out = []
    for _, edit in EDIT_SCRIPT:
        if edit is not None:
            renderer.viewer.edits = [edit]
            assert renderer.poll_and_apply() == 1
        renderer.step()
        lights = renderer.scene.lights
        out.append((to_numpy(renderer.accum), renderer.pass_index, renderer.scene_info(),
                    {k: to_numpy(getattr(lights, k)) for k in (
                        "dir_color", "point_position", "point_color", "spot_position",
                        "spot_direction", "spot_color", "spot_cos_angles", "env_map")}))
    return out


@pytest.fixture(scope="module")
def edit_script():
    orbit = dict(distance=6.2, focal_length=35.0)
    jax_r = jax_interactive.InteractiveRenderer(
        jax_cornell_box(light="point", with_spheres=False),
        jax_orbit_camera(EDIT, EDIT, distance=6.2, focal_length_mm=35.0),
        JaxRenderOptions(width=EDIT, height=EDIT, max_render_passes=4, max_ray_depth=2),
        orbit=orbit,
    )
    port_r = interactive.InteractiveRenderer(
        cornell_box(light="point", with_spheres=False),
        orbit_camera(EDIT, EDIT, distance=6.2, focal_length_mm=35.0),
        RenderOptions(width=EDIT, height=EDIT, max_render_passes=4, max_ray_depth=2),
        orbit=orbit, device="cpu",
    )
    return _drive(jax_r, np.asarray), _drive(port_r, lambda t: t.numpy()), port_r


@pytest.mark.parametrize("step", range(len(EDIT_SCRIPT)), ids=[s for s, _ in EDIT_SCRIPT])
def test_edit_script_step_matches_jax(edit_script, step):
    """The accumulation after the step's pass, the pass count (1 after a
    reset, 2 after the display-only post edit), the editable surface and
    the light bank, against the JAX package's.  The options step is a block
    pass: the port traces the block's lanes alone, the JAX package parks
    the other 8/9; every pixel must agree, alpha bit for bit."""
    (ref_accum, ref_index, ref_info, ref_lights) = edit_script[0][step]
    (accum, index, info, lights) = edit_script[1][step]
    assert index == ref_index == (2 if EDIT_SCRIPT[step][0] == "post" else 1)
    assert info == ref_info
    for k, v in ref_lights.items():
        np.testing.assert_allclose(lights[k], v, rtol=1e-6, atol=1e-7, err_msg=k)
    assert np.isfinite(accum).all()
    np.testing.assert_array_equal(accum[3], ref_accum[3])
    np.testing.assert_allclose(accum, ref_accum, rtol=RTOL, atol=ATOL)
    if step:  # every edit but post changed the image
        before = edit_script[1][step - 1][0]
        assert EDIT_SCRIPT[step][0] == "post" or not np.allclose(accum[:3], before[:3])


def test_edit_script_left_its_options(edit_script):
    r = edit_script[2]
    assert (r.options.max_ray_depth, r.options.ms_impl, r.options.interactive_block) == (
        3, "lut", True)
    assert edit_script[1][-1][0][3].sum() == 11 * 11  # block 0 of 32x32
    assert r.post.exposure == 1.0 and r.ctx.accel_pack.backend == "wide"


def test_material_edit_on_wide_equals_fresh_context():
    """A material edit on the "wide" route re-bakes the shading table in
    slot order (the JAX package's edit bakes it in triangle order, right
    only for its "xla" ids): the next pass equals, bit for bit, a fresh
    context's pass over the edited scene."""
    opts = RenderOptions(width=EDIT, height=EDIT, max_render_passes=4, max_ray_depth=2,
                         intersect_backend="wide")
    r = interactive.InteractiveRenderer(
        cornell_box(light="point", with_spheres=True),
        orbit_camera(EDIT, EDIT, distance=6.2, focal_length_mm=35.0), opts, device="cpu")
    r.step()
    before = r.accum.clone()
    assert r.apply_edit({"type": "material", "index": 2, "base_color": [0.1, 0.9, 0.2],
                         "metallic": 1.0, "roughness": 0.3})
    r.reset()
    r.step()
    fresh = render_pass(r.scene, r.camera, make_context(opts, r.scene, "cpu"), opts,
                        FrameGlobals.create(0), torch.zeros_like(r.accum))
    assert torch.equal(r.accum, fresh)
    assert not torch.equal(r.accum, before)


def test_run_stops_after_max_passes():
    opts = RenderOptions(width=8, height=8, max_render_passes=4, max_ray_depth=1)
    r = interactive.InteractiveRenderer(cornell_box(), orbit_camera(8, 8), opts, device="cpu")
    accum = r.run(max_passes=2)
    assert r.pass_index == 2 and (accum[3] == 2.0).all()


# --------------------------------------------------------------------------
# Light rows, OrbitCamera, the multiscatter table, "xla", public names
# --------------------------------------------------------------------------

_LIGHT_CASES = {
    "directional_light": (JaxDirectionalLight, DirectionalLight, "add_directional_light",
                          dict(direction=(0.3, 1.0, -0.2), color=(0.5, 1.0, 0.25),
                               illuminance=900.0)),
    "point_light": (JaxPointLight, PointLight, "add_point_light",
                    dict(position=(0.25, 1.5, -0.5), color=(1.0, 0.8, 0.6),
                         luminous_intensity=500.0)),
    "spot_light": (JaxSpotLight, SpotLight, "add_spot_light",
                   dict(position=(0.0, 1.9, 0.0), direction=(0.1, -1.0, 0.0),
                        color=(0.9, 0.9, 1.0), inner_angle=0.2, outer_angle=0.6,
                        luminous_intensity=2000.0)),
}


@pytest.mark.parametrize("kind", list(_LIGHT_CASES))
def test_bank_row_kwargs_match_jax(kind):
    jax_cls, cls, add, kw = _LIGHT_CASES[kind]
    jax_scene = getattr(jax_edit, add)(jax_cornell_box(light="point"), jax_cls(**kw))
    scene = getattr(scene_edit, add)(cornell_box(light="point"), cls(**kw))
    idx = {"directional_light": "num_directional", "point_light": "num_point",
           "spot_light": "num_spot"}[kind]
    i = int(getattr(scene.lights, idx)) - 1
    ref = jax_interactive._bank_row_kwargs(kind, jax_scene.lights, i)
    got = interactive._bank_row_kwargs(kind, scene.lights, i)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(ref[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    # The round trip: the light made from the row has the same row.
    again = interactive._light_from_edit(cls, got, {})
    np.testing.assert_allclose(again.radiometric_color(), cls(**kw).radiometric_color(),
                               rtol=1e-6)


def test_orbit_camera_matches_jax():
    for kw in (dict(), dict(distance=6.2, phi=0.7, theta=-0.3),
               dict(distance=3.0, phi=4.0, theta=1.2, target=(0.5, -1.0, 2.0))):
        np.testing.assert_array_equal(OrbitCamera(**kw).view_matrix(),
                                      JaxOrbitCamera(**kw).view_matrix())


def test_multiscatter_table_matches_jax():
    packed = multiscatter.multiscatter_lut_packed("cpu")
    ref_packed = np.asarray(jax_multiscatter.multiscatter_lut_packed())
    np.testing.assert_array_equal(packed.numpy(), ref_packed)
    rng = np.random.default_rng(5)
    n = 4096
    # Inside [0, 1] and a little past it: the row clamp of the lookup.
    n_dot = rng.uniform(-0.05, 1.05, n).astype(np.float32)
    rough = rng.uniform(0.0, 1.0, n).astype(np.float32)
    c_spec = rng.uniform(0.0, 1.0, (3, n)).astype(np.float32)
    ref = jax_multiscatter.compute_multiscattering(
        jnp.asarray(ref_packed), jnp.asarray(c_spec), jnp.asarray(n_dot), jnp.asarray(rough))
    got = multiscatter.compute_multiscattering(
        packed, torch.from_numpy(c_spec), torch.from_numpy(n_dot), torch.from_numpy(rough))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_xla_queries_match_jax():
    """``intersect_closest``, ``intersect_any`` and ``hit_attributes`` over
    the same Woop rows as the JAX package's XLA brute force."""
    jax_accel, accel = _soup(600, 21)
    (jo, jd), (o, d) = _rays(512, 23)
    t_ref, id_ref, _, hit_ref = (np.asarray(a) for a in jax_intersect_closest(jax_accel, jo, jd))
    t, tri, hit = intersect.intersect_closest(accel, o, d)
    np.testing.assert_array_equal(hit.numpy(), hit_ref)
    np.testing.assert_allclose(t.numpy()[hit_ref], t_ref[hit_ref], rtol=1e-5, atol=1e-5)
    assert (tri.numpy()[hit_ref] == id_ref[hit_ref]).mean() > 0.999
    assert (tri.numpy()[~hit_ref] == -1).all()

    t_max = np.random.default_rng(3).uniform(0.5, 8.0, 512).astype(np.float32)
    blocked_ref = np.asarray(jax_intersect_any(jax_accel, jo, jd, t_max=jnp.asarray(t_max)))
    blocked = intersect.intersect_any(accel, o, d, t_max=torch.from_numpy(t_max))
    np.testing.assert_array_equal(blocked.numpy(), blocked_ref)

    ref = jax_hit_attributes(jax_accel, jo, jd, jnp.asarray(id_ref), jnp.asarray(hit_ref))
    got = intersect.hit_attributes(accel, o, d, torch.from_numpy(id_ref),
                                   torch.from_numpy(hit_ref))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)
    n = intersect.gather_geo_normal(accel, torch.from_numpy(id_ref))
    assert isinstance(n, Vec3)
    np.testing.assert_allclose(n.to_planar().numpy(),
                               np.asarray(jax_accel.geo_normal)[:, np.maximum(id_ref, 0)],
                               rtol=0, atol=1e-6)


# The JAX package's names that the port does not have: its jnp table
# (the port's is ``multiscatter_lut_packed(device)``).
_NOT_IN_PORT = {"render": {"multiscatter_lut_jnp"}}


@pytest.mark.parametrize("sub", ["scene", "render", "sampling", "ops", "utils", "diff", "post",
                                 "parallel"])
def test_public_names_match_jax(sub):
    ref = importlib.import_module(f"heatray_tpu.{sub}").__all__
    port = importlib.import_module(f"heatray_tpu_torch.{sub}")
    assert port.__all__ == [n for n in ref if n not in _NOT_IN_PORT.get(sub, ())]
    for name in port.__all__:
        assert getattr(port, name) is not None
