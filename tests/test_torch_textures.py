"""The port's texture path against the JAX package on the CPU: the atlas
(``AtlasBuilder`` and ``sample_atlas``, bilinear and trilinear),
``compute_tangents``, and one textured render: base-colour,
metallic-roughness, emissive, normal and clearcoat-normal textures, an
alpha-masked cut-out quad and a lat/long environment, with mips on, so the
ray cone picks the levels.  One JAX render is compiled here (16x16, depth 2,
1 pass).
"""

import dataclasses
import math
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heatray_tpu.camera as jax_camera
import heatray_tpu.render as jax_render
import heatray_tpu.scene as jax_scene_pkg
from heatray_tpu.options import RenderOptions as JaxRenderOptions
from heatray_tpu.scene import environments as jax_environments
from heatray_tpu.scene import geometry as jax_geometry
from heatray_tpu.scene import lights as jax_lights
from heatray_tpu.scene import textures as jax_textures
from heatray_tpu_torch import RenderOptions, orbit_camera, render, resolve
from heatray_tpu_torch.bridge import scene_from_arrays
from heatray_tpu_torch.options import FrameGlobals
from heatray_tpu_torch.render import integrator
from heatray_tpu_torch.scene import environments, geometry, lights, textures
from heatray_tpu_torch.scene import materials, providers
from heatray_tpu_torch.scene.scene import SceneBuilder
from heatray_tpu_torch.utils.threads import share_cores

share_cores(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))


SIZE = 16
# The port's builders under the JAX package's ``heatray_tpu.scene`` names.
PORT = types.SimpleNamespace(
    SceneBuilder=SceneBuilder, MeshData=geometry.MeshData, plane_mesh=providers.plane_mesh,
    sphere_mesh=providers.sphere_mesh, translate=geometry.translate, rotate=geometry.rotate,
    PBRParams=materials.PBRParams, GlassParams=materials.GlassParams)


def _arrays(obj):
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


def _t(a):
    return torch.from_numpy(np.array(a))


# --- the atlas ----------------------------------------------------------------

def _builders():
    """The same adds to the port's and the JAX package's builders: odd and
    non-square sizes, 1, 3 and 4 channels, uint8, sRGB and a deduped key."""
    rng = np.random.default_rng(1)
    adds = [
        (rng.random((5, 7, 3)).astype(np.float32), dict(srgb=True)),
        ((rng.random((9, 4, 4)) * 255).astype(np.uint8), dict(key="tile")),
        (rng.random((1, 6)).astype(np.float32), {}),
        (rng.random((16, 16, 4)).astype(np.float32), dict(srgb=True, key="srgb16")),
        (rng.random((3, 3, 3)).astype(np.float32), dict(key="tile")),  # deduped
    ]
    ours, ref = textures.AtlasBuilder(), jax_textures.AtlasBuilder()
    ids = [(ours.add(img, **kw), ref.add(img, **kw)) for img, kw in adds]
    return ours, ref, ids


@pytest.mark.parametrize("mips", [True, False])
def test_atlas_build_equals_jax(mips):
    ours, ref, ids = _builders()
    assert [a for a, _ in ids] == [b for _, b in ids] == [0, 1, 2, 3, 1]
    a, b = ours.build(mips=mips), ref.build(mips=mips)
    assert (a.num_textures, a.num_levels) == (b.num_textures, b.num_levels)
    for f in dataclasses.fields(a):
        np.testing.assert_array_equal(getattr(a, f.name).numpy(), np.asarray(getattr(b, f.name)),
                                      err_msg=f.name)
    empty = textures.AtlasBuilder().build()
    np.testing.assert_array_equal(empty.data.numpy(), np.asarray(jax_textures.AtlasBuilder()
                                                                 .build().data))
    np.testing.assert_array_equal(textures.srgb_to_linear_np(np.linspace(0, 1, 50)),
                                  jax_textures.srgb_to_linear_np(np.linspace(0, 1, 50)))


@pytest.mark.parametrize("trilinear", [False, True], ids=["bilinear", "trilinear"])
def test_sample_atlas_matches_jax(trilinear):
    """UVs far outside [0, 1] (GL repeat), ids of -1 (read as texture 0 and
    masked by the caller), one and four channels, and footprints from
    sub-texel to wider than the texture."""
    ours, ref, _ = _builders()
    a, b = ours.build(), ref.build()
    rng = np.random.default_rng(4)
    r = 600
    tid = rng.integers(-1, 4, r).astype(np.int32)
    u = rng.uniform(-3.0, 4.0, r).astype(np.float32)
    v = rng.uniform(-2.0, 3.0, r).astype(np.float32)
    fp = (10.0 ** rng.uniform(-4, 1, r)).astype(np.float32) if trilinear else None
    for ch in (4, 1):
        got = textures.sample_atlas(a, _t(tid), _t(u), _t(v), num_channels=ch,
                                    footprint=None if fp is None else _t(fp))
        want = jax_textures.sample_atlas(b, jnp.asarray(tid), jnp.asarray(u), jnp.asarray(v),
                                         num_channels=ch,
                                         footprint=None if fp is None else jnp.asarray(fp))
        assert len(got) == ch
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0.0, atol=1e-6)


def test_compute_tangents_matches_jax():
    """A sphere's frames, and a mesh whose UVs are degenerate (every corner
    the same UV: the fallback frame) or mirrored (left-handed)."""
    sphere = providers.sphere_mesh(6, 5, 1.0)
    pos, nrm, uvs, idx = sphere.positions, sphere.normals, sphere.uvs, sphere.indices
    cases = [(pos, nrm, uvs, idx), (pos, nrm, np.zeros_like(uvs), idx),
             (pos, nrm, uvs * np.float32([-1.0, 1.0]), idx)]
    for case in cases:
        t, b = geometry.compute_tangents(*case)
        jt, jb = jax_geometry.compute_tangents(*case)
        assert t.dtype == np.float32 and b.dtype == np.float32
        np.testing.assert_array_equal(t, jt)
        np.testing.assert_array_equal(b, jb)


def test_merged_geometry_equals_jax():
    """UVs, tangents and bitangents reach the merged geometry as the JAX
    package merges them: generated from UVs, authored (bitangents from the
    normal), and zero without UVs, through a transform."""
    rot = geometry.rotate(0.7, [0.2, 1.0, 0.1])
    meshes = []
    for pkg in (PORT, jax_scene_pkg):
        sphere = pkg.sphere_mesh(6, 5, 1.0)
        plane = pkg.plane_mesh(2, 3)
        authored = pkg.MeshData(positions=plane.positions, indices=plane.indices,
                                normals=plane.normals, uvs=plane.uvs,
                                tangents=np.tile(np.float32([[1, 0, 0]]), (4, 1)))
        bare = pkg.MeshData(positions=plane.positions * 2.0, indices=plane.indices)
        meshes.append([sphere.transformed(rot), authored.transformed(rot), bare])
    ours = geometry.merge_meshes(meshes[0], [0, 1, 2])
    ref = jax_geometry.merge_meshes(meshes[1], [0, 1, 2])
    for name in ("positions", "normals", "uvs", "tangents", "bitangents", "indices",
                 "material_ids"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)


# --- a textured render --------------------------------------------------------

def textured_scene(pkg, lights_mod, env_map):
    """A seeded textured scene built through ``pkg``'s builders (the port's
    or the JAX package's): a ground plane with an sRGB checker base colour,
    a metallic-roughness map and a normal map; a clearcoat metal sphere with
    a clearcoat-normal map and an emissive texture; a double-sided
    alpha-masked cut-out quad (alpha 0 or 1 in a checker) in front of a glass
    sphere; a directional light and a lat/long environment."""
    rng = np.random.default_rng(7)
    b = pkg.SceneBuilder()
    checker = (np.indices((32, 32)).sum(axis=0) // 4 % 2).astype(np.float32)
    base = np.stack([0.2 + 0.6 * checker, 0.5 - 0.3 * checker, 0.4 + 0.1 * checker], -1)
    base = np.clip(base + 0.05 * rng.standard_normal(base.shape), 0, 1).astype(np.float32)
    bc = b.add_texture(base, srgb=True)
    mr = b.add_texture(rng.uniform(0.2, 1.0, (16, 16, 3)).astype(np.float32))
    nrm = rng.normal(0, 0.25, (32, 32, 3)).astype(np.float32)
    nrm[..., 2] = 1.0
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    nm = b.add_texture(nrm * 0.5 + 0.5)
    ccn = b.add_texture((nrm[::2, ::2] * 0.5 + 0.5).copy())
    em = b.add_texture(rng.uniform(0, 0.8, (8, 8, 3)).astype(np.float32))
    cut = np.ones((16, 16, 4), np.float32)
    cut[..., :3] = rng.uniform(0.3, 0.9, (16, 16, 3))
    cut[..., 3] = (np.indices((16, 16)).sum(axis=0) // 3 % 2).astype(np.float32)
    ct = b.add_texture(cut)
    b.add_mesh(pkg.plane_mesh(6, 6), pkg.PBRParams(
        base_color=(1, 1, 1), roughness=0.8, metallic=1.0, base_color_tex=bc,
        metallic_roughness_tex=mr, normal_tex=nm), transform=pkg.translate([0, -1.0, 0]))
    b.add_mesh(pkg.sphere_mesh(12, 10, 0.6), pkg.PBRParams(
        base_color=(0.8, 0.6, 0.4), metallic=1.0, roughness=0.3, clearcoat=1.0,
        clearcoat_roughness=0.1, clearcoat_normal_tex=ccn, emissive_tex=em),
        transform=pkg.translate([-0.7, -0.4, 0.0]))
    b.add_mesh(pkg.sphere_mesh(12, 10, 0.5), pkg.GlassParams(roughness=0.05, ior=1.5,
                                                               density=0.3),
               transform=pkg.translate([0.7, -0.5, -0.3]))
    b.add_mesh(pkg.plane_mesh(1.2, 1.2), pkg.PBRParams(
        base_color_tex=ct, double_sided=True, alpha_masked=True),
        transform=pkg.translate([0.6, -0.3, 0.8]) @ pkg.rotate(math.pi / 2, [1, 0, 0]))
    b.add_directional_light(lights_mod.DirectionalLight(direction=(0.3, 1.0, 0.4),
                                                        illuminance=683.0 * 3.0))
    b.set_environment(lights_mod.EnvironmentLightDesc(image=env_map, rotation=0.5))
    return b.build()


def _options(opts_cls, **kw):
    return opts_cls(width=SIZE, height=SIZE, max_render_passes=4, max_ray_depth=2, **kw)


@pytest.fixture(scope="module")
def scenes():
    ours = textured_scene(PORT, lights, environments.get_environment("studio", 16, 32))
    ref = textured_scene(jax_scene_pkg, jax_lights,
                         jax_environments.get_environment("studio", 16, 32))
    return ours, ref


@pytest.fixture(scope="module")
def jax_textured(scenes):
    """The JAX package's render on its exact-f32 brute-force backend,
    unsorted."""
    _, ref = scenes
    camera = jax_camera.orbit_camera(SIZE, SIZE, distance=4.0, theta=0.35)
    opts = _options(JaxRenderOptions, intersect_backend="xla", sort_bounces=False,
                    gate_bounces=False)
    accum, _ = jax_render.render(ref, camera, opts, num_passes=1)
    return camera, np.asarray(accum)


def test_textured_render_matches_jax(scenes, jax_textured):
    """Per pixel at test_torch_render.py's tolerance; the alpha-masked quad
    has its own occluder tree, and the cone's LOD picks mip levels."""
    ours, ref = scenes
    assert ours.has_textures and ours.has_alpha_mask and ours.atlas.num_levels == 6
    camera = orbit_camera(SIZE, SIZE, distance=4.0, theta=0.35)
    opts = _options(RenderOptions, sort_bounces=False, gate_bounces=False)
    accum, ctx = render(ours, camera, opts, num_passes=1, device="cpu")
    assert ctx.accel_pack.shade_table.shape[1] == 83
    assert ctx.accel_pack.wide_occl is not ctx.accel_pack.wide
    img = resolve(accum).numpy()
    assert np.isfinite(img).all() and img.max() > 0.0
    want = jax_textured[1]
    np.testing.assert_allclose(img, np.transpose(want[:3] / want[3:], (1, 2, 0)),
                               rtol=1e-3, atol=1e-4)


def test_bridged_textured_scene_renders_identically(scenes):
    """The JAX package's textured scene, carried over with its atlas, UVs,
    tangents, texture ids and lat/long map, renders bit for bit like the
    port's own builders."""
    ours, ref = scenes
    bridged = scene_from_arrays(
        _arrays(ref.geometry), _arrays(ref.materials), _arrays(ref.lights),
        has_alpha_mask=ref.has_alpha_mask, has_textures=ref.has_textures,
        atlas=_arrays(ref.atlas), device="cpu")
    for part in ("geometry", "materials", "lights", "atlas"):
        a, b = getattr(ours, part), getattr(bridged, part)
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            assert (torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y), (part, f.name)
    camera = orbit_camera(SIZE, SIZE, distance=4.0, theta=0.35)
    opts = _options(RenderOptions)
    a, _ = render(ours, camera, opts, num_passes=1, device="cpu")
    b, _ = render(bridged, camera, opts, num_passes=1, device="cpu")
    assert torch.equal(a, b)


def test_sorted_cone_equals_unsorted(scenes):
    """Sorting and gating permute the lanes and ``path_len`` with them, so
    the image is the same bit for bit; a pass over the alpha-free scene
    differs (the pass-through ran), and so does one without mips (the cone
    picked coarser levels)."""
    ours, _ = scenes
    camera = orbit_camera(SIZE, SIZE, distance=4.0, theta=0.35)
    out = {}
    for name, kw in (("unsorted", dict(sort_bounces=False, gate_bounces=False)),
                     ("sorted", dict(sort_bounces=True, gate_bounces=True, gate_segments=16)),
                     ("no mips", dict(sort_bounces=False, use_mipmaps=False))):
        out[name], _ = render(ours, camera, _options(RenderOptions, **kw), num_passes=1,
                              device="cpu")
    assert torch.equal(out["sorted"], out["unsorted"])
    assert not torch.equal(out["no mips"], out["unsorted"])
    opaque = dataclasses.replace(ours, atlas=dataclasses.replace(
        ours.atlas, data=torch.cat([ours.atlas.data[:3], torch.ones_like(ours.atlas.data[3:])])))
    solid, _ = render(opaque, camera, _options(RenderOptions, sort_bounces=False), num_passes=1,
                      device="cpu")
    assert not torch.equal(solid, out["unsorted"])


def test_sort_moves_path_len(scenes):
    """``_sort_paths`` gathers ``path_len`` with the lanes, the gate cuts it
    and ``_merge`` joins it; without a cone it stays None."""
    ours, _ = scenes
    camera = orbit_camera(SIZE, SIZE, distance=4.0, theta=0.35)
    opts = _options(RenderOptions, sort_bounces=True)
    ctx = integrator.make_context(opts, ours, device="cpu")
    cone = integrator.pixel_cone(ours, camera, opts)
    paths = integrator.start_paths(camera, ctx, opts, 0, cone=True)
    first, _ = integrator.bounce(ours, ctx, opts, FrameGlobals.create(0), 1, paths,
                                 ctx.accel_pack, cone)
    assert float(first.path_len.max()) > 0.0
    lo, hi = integrator._sort_bounds(ctx.accel_pack)
    moved = integrator._sort_paths(first, lo, hi)
    assert torch.equal(moved.path_len[torch.argsort(moved.pix)], first.path_len)
    n = integrator._gated_lanes(moved, 4)
    joined = integrator._merge(moved.map(lambda p: p[:n]), moved.map(lambda p: p[n:]))
    assert torch.equal(joined.path_len, moved.path_len)
    plain = integrator.start_paths(camera, ctx, opts, 0)
    assert plain.path_len is None and integrator._sort_paths(plain, lo, hi).path_len is None
    with pytest.raises(ValueError, match="path_len"):
        integrator.bounce(ours, ctx, opts, FrameGlobals.create(0), 1, plain, ctx.accel_pack,
                          cone)
