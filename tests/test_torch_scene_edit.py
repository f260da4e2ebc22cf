"""The port's scene edits (``scene.edit``) against the JAX package's on the
CPU, on the same scene (the JAX package's Cornell box carried over as
arrays): transforms (a session-style rotation and scale, a sheared affine
map, a mirror that flips the winding), mesh add and remove, and every light
edit.  Positions, normals and tangent frames within atol 1e-6 (torch's and
XLA's ``inv`` and matrix products round apart by ulps, ROADMAP F14), the
rest equal.  Also: the gradient of a loss through ``apply_transform``'s
matrix against ``jax.grad``'s; the alpha-mask and texture flags after
``remove_mesh``; and a context for an edited scene, whose wide BVH and block
boxes are those of a fresh build over the edited triangles."""

import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heatray_tpu.scene import edit as jax_edit
from heatray_tpu.scene import lights as jax_lights
from heatray_tpu.scene import materials as jax_materials
from heatray_tpu.scene.builtin import cornell_box as jax_cornell_box
from heatray_tpu.scene.providers import sphere_mesh as jax_sphere_mesh
from heatray_tpu_torch import RenderOptions, make_context, orbit_camera, render, resolve
from heatray_tpu_torch.bridge import scene_from_arrays
from heatray_tpu_torch.ops.intersect import build_woop
from heatray_tpu_torch.ops.wide_bvh import build_wide_bvh
from heatray_tpu_torch.scene import edit, lights, materials
from heatray_tpu_torch.scene.geometry import translate
from heatray_tpu_torch.scene.providers import plane_mesh, sphere_mesh
from heatray_tpu_torch.scene.scene import SceneBuilder
from heatray_tpu_torch.utils.threads import share_cores

share_cores(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))

FRAME_TOL = 1e-6
FRAME_FIELDS = ("positions", "normals", "tangents", "bitangents")


def _arrays(obj):
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


@pytest.fixture(scope="module")
def scenes():
    """(JAX scene, the same scene in the port)."""
    j = jax_cornell_box(light="both", with_spheres=True)
    port = scene_from_arrays(_arrays(j.geometry), _arrays(j.materials), _arrays(j.lights),
                             j.has_alpha_mask, j.has_textures, device="cpu")
    return j, port


def _assert_scene(port, j):
    for part in ("geometry", "materials", "lights"):
        p, q = getattr(port, part), getattr(j, part)
        for f in dataclasses.fields(q):
            a, b = getattr(p, f.name), np.asarray(getattr(q, f.name))
            a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
            assert a.shape == b.shape, f.name
            if part == "geometry" and f.name in FRAME_FIELDS:
                np.testing.assert_allclose(a, b, rtol=0, atol=FRAME_TOL, err_msg=f.name)
            else:
                np.testing.assert_array_equal(a, b, err_msg=f.name)
    assert (port.has_alpha_mask, port.has_textures) == (j.has_alpha_mask, j.has_textures)


def _matrix(kind):
    if kind == "trs":
        return edit.trs_matrix(yaw=0.7, pitch=-0.3, roll=0.2, scale=1.3)
    if kind == "affine":
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = [[1.2, 0.3, 0.0], [0.0, 0.8, -0.2], [0.1, 0.0, 1.5]]
        m[:3, 3] = [0.5, -1.0, 2.0]
        return m
    return np.diag([-1.0, 1.0, 1.0, 1.0]).astype(np.float32)  # mirror


@pytest.mark.parametrize("kind", ["trs", "affine", "mirror"])
def test_apply_transform_matches_jax(scenes, kind):
    j, port = scenes
    m = _matrix(kind)
    out, j_out = edit.apply_transform(port, m), jax_edit.apply_transform(j, jnp.asarray(m))
    _assert_scene(out, j_out)
    flipped = torch.equal(out.geometry.indices, port.geometry.indices[[0, 2, 1]])
    assert flipped == (kind == "mirror")
    assert torch.equal(port.geometry.positions, torch.from_numpy(np.array(j.geometry.positions)))


def test_trs_matrix_matches_jax():
    for args in ((0.0, 0.0, 0.0, 1.0), (0.7, -0.3, 0.2, 1.3), (math.pi, 0.5, -1.0, 0.25)):
        np.testing.assert_array_equal(edit.trs_matrix(*args), jax_edit.trs_matrix(*args))


def test_add_and_remove_mesh_match_jax(scenes):
    j, port = scenes
    t = translate([0.3, 0.5, -0.2])
    out = edit.add_mesh(port, sphere_mesh(8, 6, 0.4), materials.PBRParams(
        base_color=(0.2, 0.6, 0.9), roughness=0.3, metallic=0.5), transform=t)
    j_out = jax_edit.add_mesh(j, jax_sphere_mesh(8, 6, 0.4), jax_materials.PBRParams(
        base_color=(0.2, 0.6, 0.9), roughness=0.3, metallic=0.5), transform=t)
    _assert_scene(out, j_out)
    new_id = int(out.geometry.mesh_ids.max())
    for mesh_id in (2, new_id):
        _assert_scene(edit.remove_mesh(out, mesh_id), jax_edit.remove_mesh(j_out, mesh_id))
    back = edit.remove_mesh(out, new_id)
    assert torch.equal(back.geometry.indices, port.geometry.indices)
    with pytest.raises(ValueError, match="empty scene"):
        one = edit.remove_mesh(port, 0)
        for mesh_id in range(1, 7):
            one = edit.remove_mesh(one, mesh_id)


def _light_edits(mod, e):
    """The same light edits for the port (``mod``, ``e``: lights, edit) or
    the JAX package."""
    d = mod.DirectionalLight(direction=(0.2, 1.0, -0.4), color=(1.0, 0.9, 0.8), illuminance=900.0)
    p = mod.PointLight(position=(0.1, 1.2, 0.3), luminous_intensity=2500.0)
    s = mod.SpotLight(position=(-0.5, 1.8, 0.0), direction=(0.1, -1.0, 0.2),
                      inner_angle=0.3, outer_angle=0.6, luminous_intensity=4000.0)
    return [
        lambda sc: e.add_directional_light(sc, d),
        lambda sc: e.add_point_light(sc, p),
        lambda sc: e.add_spot_light(sc, s),
        lambda sc: e.update_directional_light(sc, 0, dataclasses.replace(d, illuminance=50.0)),
        lambda sc: e.update_point_light(sc, 0, dataclasses.replace(p, position=(0, 0, 1))),
        lambda sc: e.update_spot_light(sc, 1, dataclasses.replace(s, outer_angle=0.9)),
        lambda sc: e.remove_point_light(sc, 0),  # the last point light moves into slot 0
        lambda sc: e.remove_spot_light(sc, 0),
        lambda sc: e.remove_directional_light(sc, 0),
    ]


def test_light_edits_match_jax(scenes):
    j, port = scenes
    for ours, theirs in zip(_light_edits(lights, edit), _light_edits(jax_lights, jax_edit)):
        port, j = ours(port), theirs(j)
        _assert_scene(port, j)
    assert (port.lights.num_directional, port.lights.num_point, port.lights.num_spot) == (0, 1, 1)
    full = port
    for _ in range(lights.MAX_POINT_LIGHTS - 1):
        full = edit.add_point_light(full, lights.PointLight())
    with pytest.raises(ValueError, match="capacity"):
        edit.add_point_light(full, lights.PointLight())
    with pytest.raises(IndexError):
        edit.remove_spot_light(port, 3)


def test_transform_gradient_matches_jax(scenes):
    """d/dM of a weighted sum of positions and normals: finite, nonzero and
    within rtol 1e-5 of ``jax.grad`` of the same loss."""
    j, port = scenes
    m0 = _matrix("affine")
    rng = np.random.default_rng(2)
    wp = rng.standard_normal(j.geometry.positions.shape).astype(np.float32)
    wn = rng.standard_normal(j.geometry.normals.shape).astype(np.float32)

    def jax_loss(m):
        g = jax_edit.apply_transform(j, m).geometry
        return jnp.sum(g.positions * wp) + jnp.sum(g.normals * wn)

    m = torch.tensor(m0, requires_grad=True)
    g = edit.apply_transform(port, m).geometry
    (torch.sum(g.positions * torch.from_numpy(wp)) + torch.sum(g.normals * torch.from_numpy(wn))
     ).backward()
    grad = m.grad.numpy()
    j_grad = np.asarray(jax.grad(jax_loss)(jnp.asarray(m0)))
    assert np.isfinite(grad).all() and np.abs(grad[:3]).min() > 0.0
    np.testing.assert_allclose(grad, j_grad, rtol=1e-5, atol=1e-5 * np.abs(j_grad).max())


def _flag_scene():
    """A sphere, a textured plane and an alpha-masked textured quad."""
    b = SceneBuilder()
    tex = np.random.default_rng(1).random((8, 8, 4)).astype(np.float32)
    b.add_mesh(sphere_mesh(8, 6, 0.5), materials.PBRParams(base_color=(0.8, 0.3, 0.2)))
    b.add_mesh(plane_mesh(4, 4), materials.PBRParams(base_color_tex=b.add_texture(tex[..., :3])),
               transform=translate([0.0, -0.6, 0.0]))
    b.add_mesh(plane_mesh(1, 1), materials.PBRParams(base_color_tex=b.add_texture(tex),
                                                     alpha_masked=True, double_sided=True),
               transform=translate([0.0, 0.0, 1.0]))
    b.set_environment(lights.EnvironmentLightDesc(solid_color=(0.6, 0.6, 0.6)))
    return b.build()


@pytest.mark.parametrize("removed,flags", [(2, (False, True)), (1, (True, True)),
                                           ((1, 2), (False, False))])
def test_remove_mesh_keeps_flags_true(removed, flags):
    """Removing the only alpha-masked mesh clears ``has_alpha_mask``;
    removing every textured one clears ``has_textures``; the edited scene
    renders (a new context: no occluder tree, no texture tail where the
    flags are off)."""
    scene = _flag_scene()
    assert (scene.has_alpha_mask, scene.has_textures) == (True, True)
    for mesh_id in np.atleast_1d(removed):
        scene = edit.remove_mesh(scene, int(mesh_id))
    assert (scene.has_alpha_mask, scene.has_textures) == flags
    opts = RenderOptions(width=8, height=8, max_render_passes=1, max_ray_depth=2)
    accum, ctx = render(scene, orbit_camera(8, 8, distance=4.0, theta=0.3), opts, device="cpu")
    pack = ctx.accel_pack
    assert (pack.wide_occl is not pack.wide) == flags[0]
    assert np.isfinite(resolve(accum).numpy()).all()


def test_edited_scene_gets_a_fresh_tree(scenes):
    """A context made for a transformed scene holds the wide BVH, block
    boxes included, of a fresh build over the transformed triangles (F13),
    and not the old scene's."""
    _, port = scenes
    opts = RenderOptions(width=8, height=8, max_render_passes=1, max_ray_depth=1)
    moved = edit.apply_transform(port, _matrix("trs"))
    tree = make_context(opts, moved, device="cpu").accel_pack.wide
    fresh = build_wide_bvh(build_woop(moved.geometry.positions, moved.geometry.indices),
                           leaf_size=opts.wide_leaf_size)
    old = make_context(opts, port, device="cpu").accel_pack.wide
    for f in dataclasses.fields(fresh):
        a, b = getattr(tree, f.name), getattr(fresh, f.name)
        assert torch.equal(a, b) if torch.is_tensor(a) else a == b, f.name
    assert not torch.equal(tree.blocks, old.blocks)
