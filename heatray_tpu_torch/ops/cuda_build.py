"""Build and load the sources of ``heatray_tpu_torch/csrc`` at first use.

Each CUDA source (``<name>.cu``) is compiled by ``nvcc`` into a shared
library with a plain C interface under ``build/`` at the root of the
checkout, named by a hash of the source, the shared headers and the flags,
so an edited source is rebuilt and an unchanged one is reused.  The host
source ``native.cpp`` is compiled the same way by ``$CXX`` (else ``g++``):
``build_host``/``load_host``.  The libraries are loaded with ``ctypes``.
Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build"

# --fmad=false keeps every product and sum rounded separately, in the order
# of the plain PyTorch versions the kernels are checked against.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "--fmad=false", "-Xptxas=-v",
)
# -ffp-contract=off for the same reason on the host: GCC fuses multiply-adds
# by default wherever the target has FMA (aarch64, x86 with -march=native),
# which would round the normals' cross products and the SAH costs otherwise
# than numpy and the JAX package's library (and on a near tie pick another
# split).
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-Wall", "-ffp-contract=off")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found on PATH or at {path}")
    return str(path)


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives (named by the
    source, the shared headers ``csrc/*.cuh`` and the flags)."""
    files = [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]
    src = b"".join(f.read_bytes() for f in files)
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _compile(cmd: list, out: Path, label: str) -> Path:
    """Run ``cmd`` with ``-o`` a temporary file beside ``out``, then move it
    to ``out``; the compiler's output goes to a ``.log`` beside it."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([*cmd, "-o", tmp], capture_output=True, text=True)
    except OSError as e:
        os.unlink(tmp)
        raise RuntimeError(f"cannot run {cmd[0]} on {label}: {e}") from e
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"{cmd[0]} failed ({proc.returncode}) on {label}:\n{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built.
    The compiler's resource report goes to a ``.log`` beside the library."""
    out = library_path(name)
    if out.exists():
        return out
    return _compile([_nvcc(), *NVCC_FLAGS, str(CSRC_DIR / f"{name}.cu")], out, f"{name}.cu")


def host_library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cpp`` lives (named by the
    source, the flags and the host's architecture, so a checkout shared by
    two kinds of host keeps one library for each)."""
    src = (CSRC_DIR / f"{name}.cpp").read_bytes()
    key = " ".join((*CXX_FLAGS, platform.machine())).encode()
    digest = hashlib.sha256(src + key).hexdigest()[:16]
    return BUILD_DIR / f"{name}-host-{digest}.so"


def build_host(name: str) -> Path:
    """Compile the host source ``csrc/<name>.cpp`` with ``$CXX`` (else
    ``g++``) unless its library is already built; raises ``RuntimeError``
    with the compiler's errors if it fails."""
    out = host_library_path(name)
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or "g++"
    return _compile([cxx, *CXX_FLAGS, str(CSRC_DIR / f"{name}.cpp")], out, f"{name}.cpp")


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build if needed, then load, the library of ``csrc/<name>.cu``."""
    return ctypes.CDLL(str(build(name)))


@functools.lru_cache(maxsize=None)
def load_host(name: str) -> ctypes.CDLL:
    """Build if needed, then load, the library of ``csrc/<name>.cpp``."""
    return ctypes.CDLL(str(build_host(name)))
