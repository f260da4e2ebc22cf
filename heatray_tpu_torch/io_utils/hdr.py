"""Radiance HDR (RGBE, .hdr) codec in numpy (port of
``heatray_tpu.io_utils.hdr``; it writes the same bytes).

The original renderer loads HDR environment maps through FreeImage
(``Utility/TextureLoader.cpp:44-81``) and ships ``Resources/Environments/``
lat/long maps; this reads them without an imaging library.

Format: text header, then H scanlines of RGBE bytes, either flat or
adaptive-RLE (the common ``#?RADIANCE`` 32-bit_rle_rgbe encoding).
"""

from __future__ import annotations

import numpy as np


def _rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    """(..., 4) uint8 RGBE -> (..., 3) float32."""
    rgbe = rgbe.astype(np.int32)
    exp = rgbe[..., 3]
    scale = np.where(exp > 0, np.ldexp(1.0, exp - 136), 0.0)  # 2^(e-128-8)
    return (rgbe[..., :3].astype(np.float32) + 0.5) * scale[..., None]


def _float_to_rgbe(rgb: np.ndarray) -> np.ndarray:
    """(..., 3) float32 -> (..., 4) uint8 RGBE."""
    rgb = np.maximum(np.asarray(rgb, np.float32), 0.0)
    maxc = rgb.max(axis=-1)
    mant, exp = np.frexp(maxc)
    scale = np.where(maxc > 1e-38, np.ldexp(1.0, 8 - exp), 0.0)
    out = np.zeros(rgb.shape[:-1] + (4,), np.uint8)
    q = np.minimum(rgb * scale[..., None], 255.0).astype(np.uint8)
    nonzero = maxc > 1e-38
    out[..., :3] = np.where(nonzero[..., None], q, 0)
    out[..., 3] = np.where(nonzero, (exp + 128).astype(np.uint8), 0)
    return out


def read_hdr(path: str) -> np.ndarray:
    """Read a Radiance .hdr file -> (H, W, 3) float32, top row first."""
    with open(path, "rb") as f:
        data = f.read()
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError(f"{path}: not a Radiance HDR file")
    # Header: lines until a blank line, then the resolution line.
    pos = 0
    while True:
        nl = data.index(b"\n", pos)
        line = data[pos:nl]
        pos = nl + 1
        if line == b"":
            break
        if line.startswith(b"FORMAT=") and b"rgbe" not in line:
            raise ValueError(f"{path}: unsupported FORMAT {line!r}")
    nl = data.index(b"\n", pos)
    res = data[pos:nl].split()
    pos = nl + 1
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"{path}: unsupported orientation {res!r}")
    h, w = int(res[1]), int(res[3])

    buf = np.frombuffer(data, np.uint8, offset=pos)
    out = np.empty((h, w, 4), np.uint8)
    ptr = 0
    for y in range(h):
        # Adaptive RLE scanline marker: 0x02 0x02 then 16-bit width.
        if (
            w >= 8
            and w < 32768
            and buf[ptr] == 2
            and buf[ptr + 1] == 2
            and (int(buf[ptr + 2]) << 8 | int(buf[ptr + 3])) == w
        ):
            ptr += 4
            for c in range(4):
                x = 0
                while x < w:
                    count = int(buf[ptr])
                    ptr += 1
                    if count > 128:  # run of one value
                        count -= 128
                        out[y, x : x + count, c] = buf[ptr]
                        ptr += 1
                    else:  # literal dump
                        out[y, x : x + count, c] = buf[ptr : ptr + count]
                        ptr += count
                    x += count
        else:
            # Flat scanline (possibly with old-style 1,1,1,n repeats).
            row = buf[ptr : ptr + 4 * w].reshape(w, 4)
            out[y] = row
            ptr += 4 * w
    return _rgbe_to_float(out)


def write_hdr(path: str, image: np.ndarray) -> None:
    """Write (H, W, 3) float32 (top row first) as flat-RGBE .hdr."""
    img = np.asarray(image, np.float32)
    if img.ndim != 3 or img.shape[2] < 3:
        raise ValueError(f"write_hdr needs an (H, W, 3+) image, not {img.shape}")
    h, w = img.shape[:2]
    rgbe = _float_to_rgbe(img[..., :3])
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())
