"""The port's model loaders against the JAX package's on the CPU: each
format's ``MeshData`` and materials (PLY ascii/binary with extras, STL
ascii/binary, OFF/COFF, OBJ with and without ``usemtl``, glTF with a
textured material and a light, GLB, COLLADA, FBX 7.4 and 7.5 with zlib
arrays), and ``load_model_scene``'s scene arrays, atlas and lights.  The
inputs are the JAX package's own test fixtures and seeded files, and the
files ``scene.export`` writes.  Arrays are equal bit for bit, vertex
normals that the loader leaves to ``MeshData`` (and the tangents made
against them) too: both packages compute those in their C++ libraries."""

import dataclasses
import os
import struct
import sys

import numpy as np
import pytest
import torch

from heatray_tpu import native as jax_native
from heatray_tpu.scene.loaders import load_model_scene as jax_load_model_scene
from heatray_tpu.scene.loaders.collada import load_dae as jax_load_dae
from heatray_tpu.scene.loaders.fbx import load_fbx as jax_load_fbx
from heatray_tpu.scene.loaders.gltf import load_gltf as jax_load_gltf
from heatray_tpu.scene.loaders.mesh_formats import load_off as jax_load_off
from heatray_tpu.scene.loaders.mesh_formats import load_ply as jax_load_ply
from heatray_tpu.scene.loaders.mesh_formats import load_stl as jax_load_stl
from heatray_tpu.scene.loaders.obj import load_obj as jax_load_obj
from heatray_tpu.scene.textures import AtlasBuilder as JaxAtlasBuilder
from heatray_tpu_torch import cornell_box, load_model_scene
from heatray_tpu_torch.scene import export
from heatray_tpu_torch.scene.loaders import (
    load_dae, load_fbx, load_gltf, load_obj, load_off, load_ply, load_stl,
)
from heatray_tpu_torch.scene.textures import AtlasBuilder
from heatray_tpu_torch.utils.threads import share_cores

from test_fbx import make_fbx
from test_loaders import _minimal_gltf
from test_mesh_formats import _DAE_DOC, _write_ascii_ply, _write_binary_ply, _write_binary_stl

share_cores(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))


def _seeded_obj(path, usemtl):
    """A seeded soup of 60 quads and 40 triangles with vt/vn and negative
    indices, with or without material groups."""
    rng = np.random.default_rng(11)
    lines = ["mtllib s.mtl"] if usemtl else []
    v = rng.normal(size=(120, 3))
    lines += ["v {:.6f} {:.6f} {:.6f}".format(*p) for p in v]
    lines += ["vt {:.4f} {:.4f}".format(*t) for t in rng.random((50, 2))]
    lines += ["vn {:.5f} {:.5f} {:.5f}".format(*n) for n in rng.normal(size=(30, 3))]
    for k in range(100):
        if usemtl and k % 25 == 0:
            lines.append(f"usemtl {['clay', 'glass', 'chrome', 'clay'][k // 25]}")
        n = 4 if k < 60 else 3
        vi, ti, ni = rng.integers(1, 120, n), rng.integers(1, 50, n), rng.integers(1, 30, n)
        if k % 7 == 0:
            vi = vi - 121  # negative: from the end
        lines.append("f " + " ".join(f"{a}/{b}/{c}" for a, b, c in zip(vi, ti, ni)))
    path.write_text("\n".join(lines) + "\n")
    (path.parent / "s.mtl").write_text(
        "newmtl clay\nKd 0.7 0.4 0.3\nNs 40\nKe 0 0 0\n"
        "newmtl glass\nTf 0.9 0.95 1\nNi 1.45\nd 0.3\nPr 0.05\n"
        "newmtl chrome\nKd 0.9 0.9 0.9\nPm 1\nPr 0.2\nPc 0.5\nPcr 0.1\n")


def _write(case, tmp_path):
    """The file of ``case`` and (port loader, JAX loader, keyword args)."""
    p = tmp_path / "m"
    if case.startswith("ply"):
        p = p.with_suffix(".ply")
        if case == "ply_binary":
            _write_binary_ply(p)
        else:
            _write_ascii_ply(p, with_extras=case == "ply_ascii_extras")
        return p, load_ply, jax_load_ply, {}
    if case == "stl_binary":
        p = p.with_suffix(".stl")
        _write_binary_stl(p)
        return p, load_stl, jax_load_stl, {}
    if case == "stl_ascii":
        p = p.with_suffix(".stl")
        p.write_text("solid t\nfacet normal 0 0 1\nouter loop\nvertex 0 0 0\nvertex 1 0 0\n"
                     "vertex 0 1 0\nendloop\nendfacet\nfacet normal 0 0 1\nouter loop\n"
                     "vertex 1 0 0\nvertex 1 1 0\nvertex 0 1 0\nendloop\nendfacet\nendsolid t\n")
        return p, load_stl, jax_load_stl, {}
    if case in ("off", "coff"):
        p = p.with_suffix(".off")
        color = case == "coff"
        rows = ["0 0 0", "1 0 0", "1 1 0", "0 1 0.5", "0.5 0.5 1"]
        if color:
            rows = [r + f" {40 * i} 200 {255 - 30 * i} 255" for i, r in enumerate(rows)]
        p.write_text(("COFF" if color else "OFF") + "\n# comment\n5 3 0\n" + "\n".join(rows)
                     + "\n4 0 1 2 3\n3 0 3 4\n3 1 2 4\n")
        return p, load_off, jax_load_off, {"scale": 2.5}
    if case.startswith("obj"):
        p = p.with_suffix(".obj")
        _seeded_obj(p, usemtl=case == "obj_groups")
        return p, load_obj, jax_load_obj, {"scale": 0.01}
    if case.startswith("gltf"):
        path = _minimal_gltf(tmp_path, with_texture=case == "gltf_textured")
        return path, load_gltf, jax_load_gltf, {"scale": 2.0}
    if case == "glb":
        p = p.with_suffix(".glb")
        tex = np.random.default_rng(5).integers(0, 256, (8, 12, 3), dtype=np.int64)
        export.write_glb(str(p), cornell_box(light="both", with_spheres=False),
                         texture=tex.astype(np.uint8))
        return p, load_gltf, jax_load_gltf, {}
    if case == "dae":
        p = p.with_suffix(".dae")
        p.write_text(_DAE_DOC)
        return p, load_dae, jax_load_dae, {"scale": 3.0}
    version, compress = {"fbx_7400": (7400, False), "fbx_7500_zip": (7500, True)}[case]
    p = p.with_suffix(".fbx")
    p.write_bytes(make_fbx(version=version, compress=compress, unit_scale=250.0))
    return p, load_fbx, jax_load_fbx, {"scale": 1.5}


CASES = ["ply_ascii", "ply_ascii_extras", "ply_binary", "stl_binary", "stl_ascii", "off", "coff",
         "obj_single", "obj_groups", "gltf_textured", "gltf_plain", "glb", "dae", "fbx_7400",
         "fbx_7500_zip"]


def _assert_mesh_equal(a, b):
    assert a.name == b.name
    for f in ("positions", "indices", "uvs", "tangents", "bitangents", "colors", "normals"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is None:
            continue
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def _assert_params_equal(a, b):
    assert type(a).__name__ == type(b).__name__
    da, db = dataclasses.asdict(a), dataclasses.asdict(b)
    assert da.keys() == db.keys()
    for k in da:
        np.testing.assert_array_equal(np.asarray(da[k]), np.asarray(db[k]), err_msg=k)


@pytest.mark.parametrize("case", CASES)
def test_loader_matches_jax(case, tmp_path):
    path, ours, theirs, kw = _write(case, tmp_path)
    if case.startswith(("gltf", "glb")):
        sink, jax_sink = AtlasBuilder(), JaxAtlasBuilder()
        meshes, mats, lights = ours(str(path), texture_sink=sink, **kw)
        j_meshes, j_mats, j_lights = theirs(str(path), texture_sink=jax_sink, **kw)
        assert len(lights) == len(j_lights) > 0
        for a, b in zip(lights, j_lights):
            _assert_params_equal(a, b)
        assert sink.num_textures == jax_sink.num_textures
        for a, b in zip(sink._images, jax_sink._images):
            np.testing.assert_array_equal(a, b)
    else:
        meshes, mats = ours(str(path), **kw)
        j_meshes, j_mats = theirs(str(path), **kw)
    assert len(meshes) == len(j_meshes) > 0 and len(mats) == len(j_mats)
    if case == "obj_single" and not jax_native.available():
        # Without its native library the JAX package parses such a file in
        # Python, which names the mesh and material "default", not the file.
        for m in (*j_meshes, *j_mats):
            m.name = "m"
    for a, b in zip(meshes, j_meshes):
        _assert_mesh_equal(a, b)
    for a, b in zip(mats, j_mats):
        _assert_params_equal(a, b)


def _assert_fields(port_obj, jax_obj):
    for f in dataclasses.fields(jax_obj):
        a, b = getattr(port_obj, f.name), np.asarray(getattr(jax_obj, f.name))
        a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
        np.testing.assert_array_equal(a, b, err_msg=f.name)


@pytest.mark.parametrize("case", ["ply_ascii_extras", "stl_binary", "coff", "obj_single",
                                  "obj_groups", "gltf_textured", "glb", "dae", "fbx_7500_zip"])
def test_load_model_scene_matches_jax(case, tmp_path):
    """The merged, Morton-ordered scene: geometry (with mesh ids), material
    table, light bank, atlas and flags."""
    path, *_ = _write(case, tmp_path)
    scene = load_model_scene(str(path))
    j_scene = jax_load_model_scene(str(path))
    _assert_fields(scene.geometry, j_scene.geometry)
    _assert_fields(scene.materials, j_scene.materials)
    _assert_fields(scene.lights, j_scene.lights)
    _assert_fields(scene.atlas, j_scene.atlas)
    assert (scene.has_alpha_mask, scene.has_textures) == (j_scene.has_alpha_mask,
                                                          j_scene.has_textures)


@pytest.mark.parametrize("fmt", ["ply", "obj", "glb"])
def test_export_round_trip(fmt, tmp_path):
    """``scene.export`` files load (in both packages) to the scene's own
    triangles; the OBJ's MTL gives the table's materials back but for
    ``specular_f0``, which MTL does not carry (the loader sets 0.5), and the
    squared roughnesses, within an ulp (the file's float32 roughness squared,
    where the builder squared the double it was given); the GLB gives the
    bank's lights back within float32 rounding."""
    scene = cornell_box(light="both", with_spheres=True)
    path = str(tmp_path / f"box.{fmt}")
    {"ply": export.write_ply, "obj": export.write_obj, "glb": export.write_glb}[fmt](path, scene)

    def triangles(s):
        p = np.asarray(s.geometry.positions).T
        t = p[np.asarray(s.geometry.indices).T].reshape(-1, 9)
        return t[np.lexsort(t.T[::-1])]

    loaded, j_loaded = load_model_scene(path), jax_load_model_scene(path)
    np.testing.assert_array_equal(triangles(loaded), triangles(scene))
    np.testing.assert_array_equal(triangles(j_loaded), triangles(scene))
    if fmt == "obj":
        for f in dataclasses.fields(scene.materials):
            a, b = getattr(loaded.materials, f.name), getattr(scene.materials, f.name)
            if f.name.endswith("roughness_alpha"):
                np.testing.assert_allclose(a, b, rtol=1.2e-7, atol=0, err_msg=f.name)
            elif f.name != "specular_f0":
                assert torch.equal(a, b), f.name
    if fmt == "glb":
        for f in ("point_position", "point_color", "spot_position", "spot_direction",
                  "spot_color", "spot_cos_angles"):
            np.testing.assert_allclose(getattr(loaded.lights, f), getattr(scene.lights, f),
                                       rtol=1e-6, atol=1e-6, err_msg=f)
        assert (loaded.lights.num_point, loaded.lights.num_spot) == (1, 1)


def test_gltf_texture_without_pil(tmp_path, monkeypatch):
    """A glTF's PNG texture decodes with the port's own codec when PIL is
    absent, to the JAX package's (PIL-decoded) atlas."""
    path = _minimal_gltf(tmp_path, with_texture=True)
    j_scene = jax_load_model_scene(path)
    for name in ("PIL", "PIL.Image"):  # None in sys.modules: importing it fails
        monkeypatch.setitem(sys.modules, name, None)
    scene = load_model_scene(path)
    assert scene.has_textures
    _assert_fields(scene.atlas, j_scene.atlas)


def test_rejects_what_it_cannot_load(tmp_path):
    ascii_fbx = tmp_path / "a.fbx"
    ascii_fbx.write_text("; FBX 7.4.0 project file\nFBXHeaderExtension:  {\n}\n")
    with pytest.raises(ValueError, match="ASCII FBX"):
        load_model_scene(str(ascii_fbx))
    bad_glb = tmp_path / "b.glb"
    bad_glb.write_bytes(struct.pack("<III", 0x12345678, 2, 12))
    with pytest.raises(ValueError, match="not a GLB"):
        load_model_scene(str(bad_glb))
    with pytest.raises(ValueError, match="unsupported model format"):
        load_model_scene(str(tmp_path / "c.3ds"))
