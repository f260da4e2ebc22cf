"""Image I/O (port of ``heatray_tpu.io_utils.image``): LDR images (sRGB,
8-bit) and linear float images, in place of the original renderer's
FreeImage/stb stack (``Utility/TextureLoader.cpp``,
``HeatrayRenderer::saveScreenshot``).

PNG, EXR, HDR and ``.npy`` need no imaging library (``png``, ``exr``,
``hdr``).  Other LDR formats (JPEG, BMP, ...) go through PIL, imported
when one is asked for; without PIL they raise an error naming the format.
Float TIFF goes through imageio likewise.

The renderer's row 0 is the image BOTTOM (OpenRL convention); files are
written top row first.
"""

from __future__ import annotations

import importlib
import os

import numpy as np


def _suffix(path: str) -> str:
    return os.path.splitext(path)[1].lower()


def _library(module: str, fmt: str):
    """Import ``module`` for format ``fmt``, or say which format needs it."""
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ValueError(f"{fmt or 'this'} images need {module.split('.')[0]}, which is not "
                         "installed; PNG, EXR, HDR and .npy need no imaging library") from e


def save_ldr(path: str, image) -> None:
    """Save an sRGB [0, 1] (H, W, 3) image (row 0 = bottom) as PNG (or, with
    PIL, JPEG and the other formats PIL writes)."""
    img = np.clip(np.asarray(image), 0.0, 1.0)
    img8 = (img * 255.0 + 0.5).astype(np.uint8)[::-1]  # top row first
    if _suffix(path) == ".png":
        from .png import write_png

        write_png(path, img8)
        return
    _library("PIL.Image", _suffix(path)).fromarray(img8).save(path)


def save_hdr(path: str, image) -> None:
    """Save a linear float (H, W, 3/4) image (row 0 = bottom) as ``.exr``
    (half, ZIP), ``.hdr`` (RGBE), ``.npy``, or with imageio float TIFF."""
    img = np.asarray(image, dtype=np.float32)[::-1]
    suffix = _suffix(path)
    if suffix == ".exr":
        from .exr import write_exr

        write_exr(path, img[..., :3])
    elif suffix == ".hdr":
        from .hdr import write_hdr

        write_hdr(path, img[..., :3])
    elif suffix == ".npy":
        np.save(path, img)
    elif suffix in (".tif", ".tiff"):
        _library("imageio.v3", suffix).imwrite(path, img)
    else:
        raise ValueError(f"no float image format for {path!r}: use .exr, .hdr, .npy or .tiff")


def load_image(path: str, to_linear: bool = True) -> np.ndarray:
    """Load an image as linear float (H, W, C), row 0 = bottom.

    8-bit files are turned from sRGB to linear as the original texture
    loader does (``TextureLoader.cpp:106-133``), 16-bit ones scaled to [0,
    1]; float formats (.exr, .hdr, .npy) load as they are
    (``TextureLoader.cpp:44-81``)."""
    suffix = _suffix(path)
    if suffix == ".npy":
        return np.load(path)[::-1]
    if suffix == ".exr":
        from .exr import read_exr_rgb

        return read_exr_rgb(path)[::-1].copy()
    if suffix == ".hdr":
        from .hdr import read_hdr

        return read_hdr(path)[::-1].copy()
    if suffix == ".png":
        from .png import read_png

        img = read_png(path)
    else:
        img = np.asarray(_library("PIL.Image", suffix).open(path))
    img = img[::-1]
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
        if to_linear:
            a = 0.055
            img = np.where(img <= 0.04045, img / 12.92, ((img + a) / (1 + a)) ** 2.4)
        return img.astype(np.float32)
    if img.dtype == np.uint16:
        return (img.astype(np.float32) / 65535.0).astype(np.float32)
    return img.astype(np.float32)
