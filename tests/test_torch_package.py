"""The port's package boundary: it imports without jax or flax (and
without the imaging libraries, which only a format that needs them
imports), options
that select a path it does not have yet raise instead of being ignored, and
values no path takes raise ``ValueError``."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from heatray_tpu_torch.options import AOV, RenderOptions
from heatray_tpu_torch.utils.threads import share_cores

share_cores(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))


_REPO = Path(__file__).resolve().parents[1]

_NO_JAX = """
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax"):
            raise ImportError("blocked: " + name)

sys.meta_path.insert(0, Block())
import heatray_tpu_torch
for mod in pkgutil.walk_packages(heatray_tpu_torch.__path__, "heatray_tpu_torch."):
    importlib.import_module(mod.name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "heatray_tpu", "PIL", "imageio"))
assert not bad, bad
print("imported", len([m for m in sys.modules if m.startswith("heatray_tpu_torch")]))
"""


def test_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=str(_REPO))
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX], cwd=_REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) > 20


_OPTION_CASES = [
    ("intersect_backend", "xla", True),
    ("intersect_backend", "sharded", True),
    ("image_height", 540, True),
    ("interactive_block", True, True),
    ("ms_impl", "lut", True),
]


@pytest.mark.parametrize("field, value, ported", _OPTION_CASES,
                         ids=[f"{f}-{v}" for f, v, _ in _OPTION_CASES])
def test_unported_options_raise(field, value, ported):
    """Every option of the JAX package has been ported and is taken: the
    multi-device ones, the "xla" backend, the 3x3 block mode and the
    multiscatter table."""
    if ported:
        assert getattr(RenderOptions(**{field: value}), field) == value
        return
    with pytest.raises(NotImplementedError, match=field):
        RenderOptions(**{field: value})


@pytest.mark.parametrize("mode", list(AOV))
def test_every_aov_accepted(mode):
    """Every visualizer mode is ported (``render/aov.py``)."""
    assert RenderOptions(width=8, height=8, aov=mode).aov == mode


def test_supported_options_accepted():
    for kw in ({}, {"intersect_backend": "wide"}, {"intersect_backend": "stream"},
               {"intersect_backend": "bvh"}, {"intersect_backend": "pallas"},
               {"sort_bounces": False}, {"gate_bounces": False},
               {"sort_bounces": True, "gate_bounces": True}, {"stream_ray_tile": 512}):
        RenderOptions(width=8, height=8, **kw)


@pytest.mark.parametrize("field", ["sort_bounces", "gate_bounces"])
def test_sort_and_gate_take_true_false_or_auto(field):
    with pytest.raises(ValueError, match=field):
        RenderOptions(**{field: "yes"})


@pytest.mark.parametrize("field, value", [("wide_leaf_math", "vpu"), ("stream_leaf_math", "vpu")])
def test_ported_options_accepted(field, value):
    """The transposed leaf math of the wide and streaming trees (K5, K4)."""
    assert getattr(RenderOptions(width=8, height=8, **{field: value}), field) == value


@pytest.mark.parametrize("field", ["wide_leaf_math", "stream_leaf_math"])
@pytest.mark.parametrize("value", ["bf16", "VPU"])
def test_leaf_math_takes_mxu_or_vpu(field, value):
    with pytest.raises(ValueError, match=field):
        RenderOptions(**{field: value})
