"""The port's image and session I/O against the JAX package on the CPU:
EXR and HDR files byte for byte and read across, the PNG codec against PIL
for every colour type, bit depth and filter, ``save_ldr``/``load_image``
across the packages and without PIL, the session JSON and ``load_session``
(options, camera and scene arrays), and render-state files written by one
package and resumed in the other."""

import dataclasses
import io
import os
import sys
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from heatray_tpu.io_utils import exr as jax_exr
from heatray_tpu.io_utils import hdr as jax_hdr
from heatray_tpu.io_utils import image as jax_image
from heatray_tpu.io_utils import session as jax_session
from heatray_tpu_torch import RenderOptions, cornell_box, orbit_camera, render, resolve
from heatray_tpu_torch.io_utils import exr, hdr, image, png, session
from heatray_tpu_torch.scene import export
from heatray_tpu_torch.utils.threads import share_cores

share_cores(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))


def _hdr_image(h=21, w=13, seed=0):
    """Seeded linear radiance over six decades, with zeros (RGBE's 0 path)
    and a row count that is not a multiple of EXR's 16-line blocks."""
    rng = np.random.default_rng(seed)
    img = (10.0 ** rng.uniform(-3, 3, (h, w, 3))).astype(np.float32)
    img[0, :3] = 0.0
    return img


# --- EXR and HDR ----------------------------------------------------------------

@pytest.mark.parametrize("half", [True, False], ids=["half", "float"])
def test_exr_bytes_and_reads_match(tmp_path, half):
    img = _hdr_image()
    ours, theirs = tmp_path / "port.exr", tmp_path / "jax.exr"
    exr.write_exr(str(ours), img, half=half)
    jax_exr.write_exr(str(theirs), img, half=half)
    assert ours.read_bytes() == theirs.read_bytes()
    a, names_a = exr.read_exr(str(theirs))
    b, names_b = jax_exr.read_exr(str(ours))
    assert names_a == names_b == ["B", "G", "R"]
    np.testing.assert_array_equal(a, b)
    expect = img.astype(np.float16).astype(np.float32) if half else img
    np.testing.assert_array_equal(exr.read_exr_rgb(str(theirs)), expect)


def test_hdr_bytes_and_reads_match(tmp_path):
    img = _hdr_image()
    ours, theirs = tmp_path / "port.hdr", tmp_path / "jax.hdr"
    hdr.write_hdr(str(ours), img)
    jax_hdr.write_hdr(str(theirs), img)
    assert ours.read_bytes() == theirs.read_bytes()
    np.testing.assert_array_equal(hdr.read_hdr(str(theirs)), jax_hdr.read_hdr(str(ours)))
    # RGBE shares one exponent per pixel: 8 bits of mantissa on its largest channel.
    err = np.abs(hdr.read_hdr(str(ours)) - img)
    assert (err <= img.max(axis=-1, keepdims=True) * 2.0 ** -7).all()


@pytest.mark.parametrize("suffix", [".exr", ".hdr", ".npy"])
def test_save_hdr_matches_jax(tmp_path, suffix):
    """``save_hdr`` writes the bytes the JAX package writes (rows flipped to
    top first) and ``load_image`` reads them back as it does."""
    img = _hdr_image(9, 17, seed=1)
    ours, theirs = tmp_path / f"port{suffix}", tmp_path / f"jax{suffix}"
    image.save_hdr(str(ours), img)
    jax_image.save_hdr(str(theirs), img)
    assert ours.read_bytes() == theirs.read_bytes()
    np.testing.assert_array_equal(image.load_image(str(ours)), jax_image.load_image(str(ours)))


def test_save_hdr_rejects_unknown_suffix(tmp_path):
    with pytest.raises(ValueError, match="no float image format"):
        image.save_hdr(str(tmp_path / "x.bmp"), _hdr_image())


# --- PNG --------------------------------------------------------------------------

def _random_pixels(channels, dtype, seed, h=9, w=11):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, np.iinfo(dtype).max + 1, (h, w, channels), dtype=np.int64).astype(dtype)
    return a[..., 0] if channels == 1 else a


@pytest.mark.parametrize("channels", [1, 2, 3, 4], ids=["grey", "grey_alpha", "rgb", "rgba"])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16], ids=["8bit", "16bit"])
def test_png_writer_read_by_pil(channels, dtype):
    """Every filter type; PIL keeps 16-bit samples for grey only and gives the
    high byte (and grey+alpha as RGBA) otherwise."""
    a = _random_pixels(channels, dtype, seed=channels)
    for kind in range(len(png.FILTERS)):
        data = png.encode_png(a, kind)
        np.testing.assert_array_equal(png.decode_png(data), a)
        seen = np.asarray(Image.open(io.BytesIO(data)))
        expect = a if seen.dtype == dtype else (a >> 8).astype(np.uint8)
        if channels == 2 and seen.shape[-1] == 4:
            expect = expect[..., [0, 0, 0, 1]]
        np.testing.assert_array_equal(seen, expect, err_msg=png.FILTERS[kind])


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "I;16", "P"])
def test_png_reader_reads_pil(mode):
    """Files PIL writes (its own filter choice per line, over smooth and
    noisy rows so that it picks several) read as PIL reads them; a palette
    file reads as its RGB colours."""
    h, w = 24, 40
    rng = np.random.default_rng(7)
    ramp = (np.add.outer(np.arange(h), 3 * np.arange(w)) % 256).astype(np.uint8)
    noise = rng.integers(0, 256, (h, w), dtype=np.int64).astype(np.uint8)
    base = np.where(np.arange(h)[:, None] % 3 == 0, noise, ramp)
    if mode == "I;16":
        im = Image.fromarray(base.astype(np.uint16) * 257 + 3)
    elif mode == "P":
        im = Image.fromarray(np.stack([base, ramp, noise], -1)).quantize(200)
    else:
        n = len(mode)
        im = Image.fromarray(np.stack([base, ramp, noise, 255 - base][:n], -1)
                             if n > 1 else base, mode)
    buf = io.BytesIO()
    im.save(buf, format="PNG")
    data = buf.getvalue()
    seen = Image.open(io.BytesIO(data))
    expect = np.asarray(seen.convert("RGB") if mode == "P" else seen)
    np.testing.assert_array_equal(png.decode_png(data), expect)


def test_png_rejects_what_it_cannot_read():
    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 4), np.uint8)).convert("1").save(buf, format="PNG")
    with pytest.raises(ValueError, match="bit depth 1"):
        png.decode_png(buf.getvalue())
    data = bytearray(png.encode_png(np.zeros((4, 4), np.uint8)))
    data[28] = 1  # IHDR's interlace byte (Adam7), with its CRC made anew
    data[29:33] = (zlib.crc32(bytes(data[12:29])) & 0xFFFFFFFF).to_bytes(4, "big")
    with pytest.raises(ValueError, match="interlaced"):
        png.decode_png(bytes(data))
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode_png(b"GIF89a")


def test_ldr_files_across_packages(tmp_path):
    """``save_ldr`` of each package read by the other's ``load_image``:
    equal floats (the port's own PNG writer against the JAX package's PIL
    one)."""
    img = np.random.default_rng(3).random((13, 19, 3)).astype(np.float32)
    ours, theirs = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    image.save_ldr(ours, img)
    jax_image.save_ldr(theirs, img)
    for linear in (True, False):
        a = image.load_image(theirs, to_linear=linear)
        b = jax_image.load_image(ours, to_linear=linear)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.asarray(Image.open(ours)),
                                  (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)[::-1])


def test_png_without_pil(tmp_path, monkeypatch):
    """With PIL absent, PNG still writes and reads; JPEG raises an error that
    names the format (nothing is written in its place)."""
    for name in ("PIL", "PIL.Image"):  # None in sys.modules: importing it fails
        monkeypatch.setitem(sys.modules, name, None)
    img = np.random.default_rng(4).random((6, 5, 3)).astype(np.float32)
    path = str(tmp_path / "x.png")
    image.save_ldr(path, img)
    back = image.load_image(path, to_linear=False)
    np.testing.assert_array_equal(np.round(back * 255).astype(np.uint8),
                                  (img * 255 + 0.5).astype(np.uint8))
    with pytest.raises(ValueError, match=r"\.jpg images need PIL"):
        image.save_ldr(str(tmp_path / "x.jpg"), img)
    assert sorted(os.listdir(tmp_path)) == ["x.png"]


# --- sessions ---------------------------------------------------------------------

def _session_values():
    return {
        "RenderOptions": {"Scene": "cornell-box", "MaxRayDepth": 3, "SampleMode": 1,
                          "BokehShape": 2, "CameraFocalLength": 85.0, "CameraFStop": 2.8,
                          "EnvironmentBuiltIn": False, "EnvironmentMapSolidColorY": 0.25},
        "Camera": {"OrbitDistance": 7.5, "OrbitPhi": 0.4, "OrbitTheta": -0.2,
                   "OrbitTargetY": 0.5},
        "PostProcessing": {"TonemapEnable": True, "Contrast": 1.2},
    }


def test_session_table_and_files_match(tmp_path):
    assert session.SESSION_VARIABLES == jax_session.SESSION_VARIABLES
    ours, theirs = session.Session(_session_values()), jax_session.Session(_session_values())
    assert ours.values == theirs.values
    ours.write(str(tmp_path / "port.json"))
    theirs.write(str(tmp_path / "jax.json"))
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    assert session.Session.parse(str(tmp_path / "jax.json")).values == theirs.values
    assert dataclasses.asdict(ours.to_post_params()) == dataclasses.asdict(
        theirs.to_post_params())


def _assert_arrays_equal(port_obj, jax_obj, atol=0.0, skip=()):
    for f in dataclasses.fields(port_obj):
        if f.name in skip:
            continue
        a, b = getattr(port_obj, f.name), getattr(jax_obj, f.name)
        a = a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=atol, err_msg=f.name)


def test_load_session_builtin_matches(tmp_path):
    """A session naming a built-in: options, camera and scene arrays equal
    the JAX package's."""
    path = str(tmp_path / "s.json")
    jax_session.Session(_session_values()).write(path)
    scene, camera, opts = session.load_session(path, override_size=(24, 16))
    j_scene, j_camera, j_opts = jax_session.load_session(path, override_size=(24, 16))
    for f in dataclasses.fields(opts):
        a, b = getattr(opts, f.name), getattr(j_opts, f.name)
        assert getattr(a, "value", a) == getattr(b, "value", b), f.name
    _assert_arrays_equal(camera, j_camera)
    _assert_arrays_equal(scene.geometry, j_scene.geometry)
    _assert_arrays_equal(scene.materials, j_scene.materials)
    _assert_arrays_equal(scene.lights, j_scene.lights)


def test_load_session_model_with_transform_matches(tmp_path):
    """A session naming a model file, with the Scene group's yaw, pitch and
    scale: the transformed scene within 1e-6 of the JAX package's (torch's
    and XLA's matrix products round apart), the solid environment equal."""
    model = str(tmp_path / "box.obj")
    export.write_obj(model, cornell_box(light="point", with_spheres=False))
    values = _session_values()
    values["RenderOptions"]["Scene"] = model
    values["Scene"] = {"RotationYaw": 0.7, "RotationPitch": -0.3, "Scale": 1.5,
                       "DistanceScale": 2.0}
    path = str(tmp_path / "s.json")
    jax_session.Session(values).write(path)
    scene, _, _ = session.load_session(path)
    j_scene, _, _ = jax_session.load_session(path)
    _assert_arrays_equal(scene.geometry, j_scene.geometry, atol=1e-6)
    _assert_arrays_equal(scene.materials, j_scene.materials)
    _assert_arrays_equal(scene.lights, j_scene.lights)


def test_render_state_interchangeable_and_resumes(tmp_path):
    """A render-state file written by either package loads in the other, and
    2 passes, saved, loaded and 2 more equal 4 straight passes bit for bit."""
    size = 12
    opts = RenderOptions(width=size, height=size, max_render_passes=4, max_ray_depth=2)
    scene = cornell_box(light="both", with_spheres=True)
    camera = orbit_camera(size, size, distance=6.2, focal_length_mm=35.0)
    straight, ctx = render(scene, camera, opts, num_passes=4, device="cpu")
    half, _ = render(scene, camera, opts, num_passes=2, ctx=ctx, device="cpu")
    s = session.Session({"RenderOptions": {"MaxRenderPasses": 4}})
    path = str(tmp_path / "port.npz")
    session.save_render_state(path, half, next_pass=2, session=s)
    accum, next_pass, s2 = jax_session.load_render_state(path)
    assert next_pass == 2 and s2.values == s.values and accum.shape == (4, size, size)
    jax_path = str(tmp_path / "jax.npz")
    jax_session.save_render_state(jax_path, accum, next_pass, s2)
    accum, next_pass, s3 = session.load_render_state(jax_path)
    assert s3.values == s.values
    resumed, _ = render(scene, camera, opts, num_passes=2, ctx=ctx, device="cpu",
                        accum=torch.from_numpy(accum), start_pass=next_pass)
    assert torch.equal(resumed, straight)
    assert np.isfinite(resolve(resumed).numpy()).all()
