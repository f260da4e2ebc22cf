"""The port's command line (``python -m heatray_tpu_torch.cli``) on the CPU:
``render --cpu`` of a built-in, of a session file and of a model file in
every format the loaders read; one ``.npy`` render of a loaded OBJ against
the JAX package's CLI (its one JAX render compile here: 16x16, depth 2);
``optimize`` for 2 steps; ``sequence-vis`` against the JAX package's
scatter image; ``--trace``; ``--preview`` and ``--edit``, the command that
is not ported yet, and the card that must be there without ``--cpu``."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from heatray_tpu.cli import main as jax_main
from heatray_tpu_torch import cornell_box
from heatray_tpu_torch.cli import main
from heatray_tpu_torch.io_utils import hdr
from heatray_tpu_torch.io_utils.image import load_image
from heatray_tpu_torch.io_utils.session import Session
from heatray_tpu_torch.scene import export
from heatray_tpu_torch.utils.threads import share_cores

from test_fbx import make_fbx
from test_loaders import _minimal_gltf
from test_mesh_formats import _DAE_DOC, _write_ascii_ply, _write_binary_stl

share_cores(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))

REPO = Path(__file__).resolve().parents[1]
TINY = ["--size", "8", "6", "--passes", "1", "--depth", "1", "--cpu"]


def _sky(path):
    """A small lat/long map: bright above the horizon, dim below."""
    rows = np.linspace(4.0, 0.1, 8, dtype=np.float32)[:, None, None]
    hdr.write_hdr(str(path), np.broadcast_to(rows, (8, 16, 3)).copy())
    return str(path)


def _model(fmt, tmp_path):
    """A model file of ``fmt`` (the JAX package's fixtures, or the Cornell
    box written by ``scene.export``)."""
    p = tmp_path / f"m.{fmt}"
    if fmt == "obj":
        export.write_obj(str(p), cornell_box(light="point", with_spheres=True))
    elif fmt == "ply":
        _write_ascii_ply(p, with_extras=True)
    elif fmt == "stl":
        _write_binary_stl(p)
    elif fmt == "off":
        p.write_text("OFF\n4 2 0\n0 0 0\n1 0 0\n1 1 0\n0 1 0\n3 0 1 2\n3 0 2 3\n")
    elif fmt == "gltf":
        return _minimal_gltf(tmp_path, with_texture=True)
    elif fmt == "glb":
        export.write_glb(str(p), cornell_box(light="both", with_spheres=False),
                         texture=np.full((4, 4, 3), 200, np.uint8))
    elif fmt == "dae":
        p.write_text(_DAE_DOC)
    else:
        p.write_bytes(make_fbx())
    return str(p)


@pytest.mark.parametrize("fmt", ["obj", "ply", "stl", "off", "gltf", "glb", "dae", "fbx"])
def test_render_model_file(fmt, tmp_path):
    out = str(tmp_path / "out.png")
    assert main(["render", "--scene", _model(fmt, tmp_path), *TINY, "--out", out]) == 0
    img = load_image(out)
    assert img.shape == (6, 8, 3) and np.isfinite(img).all()


def test_render_builtin_and_session(tmp_path):
    """A built-in by its name, and a session naming a PLY with its Scene
    group's yaw and scale set, to ``.exr`` and ``.hdr``."""
    out = str(tmp_path / "box.exr")
    assert main(["render", "--scene", "cornell-box", *TINY, "--out", out]) == 0
    img = load_image(out)
    assert img.shape == (6, 8, 3) and np.isfinite(img).all() and img.max() > 0.0
    s = Session()
    s.set("RenderOptions", "Scene", _model("ply", tmp_path))
    s.set("RenderOptions", "MaxRayDepth", 1)
    s.set("Scene", "RotationYaw", 0.6)
    s.set("Scene", "Scale", 2.0)
    s.set("Camera", "OrbitDistance", 4.0)
    session = str(tmp_path / "s.json")
    s.write(session)
    out = str(tmp_path / "session.hdr")
    assert main(["render", "--scene", session, *TINY, "--out", out]) == 0
    img = load_image(out)
    assert img.shape == (6, 8, 3) and np.isfinite(img).all() and img.max() > 0.0


@pytest.fixture
def jax_cache(tmp_path, monkeypatch):
    """The JAX CLI's compile cache under ``tmp_path``, and the JAX settings
    it changes put back afterwards."""
    import jax

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jax_cache"))
    names = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {n: getattr(jax.config, n) for n in names}
    yield
    for n, v in saved.items():
        jax.config.update(n, v)


def test_npy_render_matches_jax_cli(tmp_path, jax_cache):
    """The Cornell box as an OBJ under a small lat/long sky, 16x16, depth 2,
    one pass, through both CLIs to ``.npy``: per pixel within rtol 1e-3,
    atol 1e-4 (``tests/test_torch_render.py``'s bound: XLA reassociates the
    shading's float sums)."""
    argv = ["render", "--scene", _model("obj", tmp_path), "--env", _sky(tmp_path / "sky.hdr"),
            "--size", "16", "16", "--passes", "1", "--depth", "2", "--orbit", "6.2", "0", "0",
            "--focal-length", "35", "--cpu"]
    ours, theirs = str(tmp_path / "port.npy"), str(tmp_path / "jax.npy")
    assert main([*argv, "--out", ours]) == 0
    assert jax_main([*argv, "--out", theirs]) == 0
    a, b = np.load(ours), np.load(theirs)
    assert a.shape == b.shape == (16, 16, 3) and a.max() > 0.0
    np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4)


def test_optimize_two_steps(tmp_path, capsys):
    target = str(tmp_path / "target.npy")
    common = ["--scene", "editable-pbr", "--size", "8", "8", "--depth", "2", "--cpu"]
    assert main(["render", *common, "--passes", "1", "--out", target]) == 0
    capsys.readouterr()
    assert main(["optimize", *common, "--target", target, "--steps", "2",
                 "--passes-per-step", "1"]) == 0
    params = json.loads(capsys.readouterr().out)
    assert set(params) == {"base_color", "roughness"}
    assert np.asarray(params["base_color"]).shape == (3, 1)
    assert np.isfinite(np.asarray(params["roughness"])).all()


@pytest.mark.parametrize("args", [["--sample-mode", "sobol"], ["--sample-mode", "halton"],
                                  ["--aperture", "--bokeh", "hexagon", "--sequence", "3"]],
                         ids=["sobol", "halton", "aperture"])
def test_sequence_vis_matches_jax(tmp_path, args):
    argv = ["sequence-vis", *args, "--count", "48", "--plot-size", "64"]
    ours, theirs = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    assert main([*argv, "--out", ours]) == 0
    assert jax_main([*argv, "--out", theirs]) == 0
    a, b = np.asarray(Image.open(ours)), np.asarray(Image.open(theirs))
    assert a.shape == (64, 64, 3) and a.max() == 255
    np.testing.assert_array_equal(a, b)


def test_trace_writes_a_chrome_trace(tmp_path):
    trace = tmp_path / "trace"
    assert main(["render", "--scene", "editable-pbr", *TINY, "--trace", str(trace),
                 "--out", str(tmp_path / "x.png")]) == 0
    events = json.loads((trace / "trace.json").read_text())["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)


@pytest.mark.parametrize("argv", [["render", "--preview", "0"], ["render", "--edit"], ["benchmark"]],
                         ids=["preview", "edit", "benchmark"])
def test_not_ported_yet(argv, tmp_path):
    """``benchmark`` is not ported yet and raises.  The preview has been
    ported: on port 0 it renders and writes the file; the edit loop needs
    the preview's server, and without it the command returns 2."""
    out = tmp_path / "x.png"
    argv = [*argv, *TINY, *(["--out", str(out)] if argv[0] == "render" else [])]
    if "--preview" in argv:
        assert main(argv) == 0 and out.exists()
    elif "--edit" in argv:
        assert main(argv) == 2 and not out.exists()
    else:
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item"):
            main(argv)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is there")
def test_render_needs_the_card_without_cpu(tmp_path):
    """Without ``--cpu`` the render is the card's: no card, no image (no
    fallback to the CPU)."""
    out = tmp_path / "x.png"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["render", "--scene", "editable-pbr", "--size", "8", "6", "--passes", "1",
              "--out", str(out)])
    assert not out.exists()


def test_module_entry_point(tmp_path):
    """``python -m heatray_tpu_torch.cli`` runs, and its path imports neither
    JAX nor PIL."""
    out = tmp_path / "seq.png"
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['cli', 'sequence-vis', '--count', '16', '--plot-size', '32', "
        f"'--out', {str(out)!r}]\n"
        "try:\n"
        "    runpy.run_module('heatray_tpu_torch.cli', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'PIL', 'heatray_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=tmp_path, timeout=120)
    assert load_image(str(out)).shape == (32, 32, 3)
