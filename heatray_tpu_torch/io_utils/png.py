"""PNG codec in numpy, ``zlib`` and ``struct``: no imaging library.

Reads non-interlaced 8- and 16-bit greyscale, grey+alpha, RGB and RGBA
files and 8-bit palette files (as their RGB or RGBA colours), with any of
the five scanline filters; writes 8- and 16-bit grey, grey+alpha, RGB and
RGBA with one filter for every scanline.
Arrays are top row first, as stored: (H, W) for grey, (H, W, C) otherwise,
uint8 or uint16.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}  # channels -> colour type (writing)
FILTERS = ("none", "sub", "up", "average", "paeth")


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _predict(kind: int, a, b, c):
    """The predictor of filter ``kind`` from the left, upper and upper-left
    bytes (int32 arrays)."""
    if kind == 1:
        return a
    if kind == 2:
        return b
    if kind == 3:
        return (a + b) >> 1
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_rows(raw: np.ndarray, bpp: int, kind: int) -> np.ndarray:
    """(H, stride) uint8 scanlines -> (H, 1 + stride) filtered lines."""
    x = raw.astype(np.int32)
    out = np.empty((raw.shape[0], raw.shape[1] + 1), np.uint8)
    out[:, 0] = kind
    if kind == 0:
        out[:, 1:] = raw
        return out
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    out[:, 1:] = (x - _predict(kind, a, b, c)) & 0xFF
    return out


def _unfilter_row(kind: int, line: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """One filtered scanline (uint8) back to its bytes, given the previous
    decoded one."""
    if kind == 0:
        return line
    if kind == 2:
        return ((line.astype(np.int32) + prev) & 0xFF).astype(np.uint8)
    if kind == 1:
        # x[i] = f[i] + x[i - bpp]: a running sum over each byte lane.
        lanes = line.reshape(-1, bpp).astype(np.int64)
        return (np.cumsum(lanes, axis=0) & 0xFF).astype(np.uint8).reshape(-1)
    if kind not in (3, 4):
        raise ValueError(f"PNG: unknown filter type {kind}")
    # Average and Paeth depend on the decoded byte to the left: a byte loop.
    f, up = line.tolist(), prev.tolist()
    x = [0] * len(f)
    for i in range(len(f)):
        a = x[i - bpp] if i >= bpp else 0
        b = up[i]
        if kind == 3:
            x[i] = (f[i] + ((a + b) >> 1)) & 0xFF
            continue
        c = up[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        x[i] = (f[i] + (a if pa <= pb and pa <= pc else b if pb <= pc else c)) & 0xFF
    return np.asarray(x, np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """The pixels of a PNG file's bytes (see the module docstring)."""
    if not data.startswith(_SIGNATURE):
        raise ValueError("not a PNG file")
    pos, header, palette, alpha, idat = 8, None, None, None, []
    while pos < len(data):
        (length,) = struct.unpack_from(">I", data, pos)
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            alpha = np.frombuffer(body, np.uint8)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS:
        raise ValueError(f"PNG: unknown colour type {ctype}")
    if interlace:
        raise ValueError("PNG: interlaced files are not supported")
    if depth not in (8, 16) or (ctype == 3 and depth != 8):
        raise ValueError(f"PNG: bit depth {depth} of colour type {ctype} is not supported")
    channels = _CHANNELS[ctype]
    bpp = channels * depth // 8
    stride = w * bpp
    lines = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if lines.size < h * (stride + 1):
        raise ValueError("PNG: truncated image data")
    lines = lines[: h * (stride + 1)].reshape(h, stride + 1)
    raw = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        prev = raw[y] = _unfilter_row(int(lines[y, 0]), lines[y, 1:], prev, bpp)
    if depth == 16:
        px = raw.view(">u2").astype(np.uint16).reshape(h, w, channels)
    else:
        px = raw.reshape(h, w, channels)
    if ctype == 3:
        if palette is None:
            raise ValueError("PNG: palette image without a PLTE chunk")
        idx = px[..., 0]
        px = palette[idx]
        if alpha is not None:
            a = np.full(len(palette), 255, np.uint8)
            a[: len(alpha)] = alpha
            px = np.concatenate([px, a[idx][..., None]], axis=-1)
    return px[..., 0] if px.shape[-1] == 1 else px


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def encode_png(image: np.ndarray, filter_type: int = 2) -> bytes:
    """PNG bytes of an (H, W) or (H, W, 1-4) uint8 or uint16 image, top row
    first, every scanline with ``filter_type`` (an index of ``FILTERS``)."""
    img = np.asarray(image)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG: uint8 or uint16 pixels, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"PNG: an (H, W) or (H, W, 1-4) image, not {image.shape}")
    if filter_type not in range(len(FILTERS)):
        raise ValueError(f"PNG: filter type {filter_type} is not one of 0-4")
    h, w, channels = img.shape
    depth = 8 * img.itemsize
    raw = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img).view(np.uint8)
    lines = _filter_rows(raw.reshape(h, -1), channels * img.itemsize, filter_type)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, _COLOR_TYPE[channels], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(lines.tobytes(), 6)) + _chunk(b"IEND", b""))


def write_png(path: str, image: np.ndarray, filter_type: int = 2) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(image, filter_type))
