"""Minimal OpenEXR 2.0 scanline codec in numpy and zlib (port of
``heatray_tpu.io_utils.exr``; it writes the same bytes).

The original renderer reads and writes float images through FreeImage
(``Utility/TextureLoader.cpp:44-81``, ``HeatrayRenderer::saveScreenshot``);
this codec covers real-world lat/long environments and the renderer's own
output without an imaging library:

- single-part scanline files, compression NONE or ZIP/ZIPS,
- HALF and FLOAT channels, any channel set (R/G/B[/A] extracted),
- writing: ZIP-compressed HALF or FLOAT RGB.

Not supported (raises): tiled/deep/multi-part files, PIZ/PXR24/B44/DWA
compression, subsampled channels.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = 20000630
_PIXEL_UINT, _PIXEL_HALF, _PIXEL_FLOAT = 0, 1, 2
_DTYPE = {_PIXEL_UINT: np.uint32, _PIXEL_HALF: np.float16, _PIXEL_FLOAT: np.float32}


def _read_cstr(data: bytes, pos: int):
    end = data.index(b"\x00", pos)
    return data[pos:end].decode("latin-1"), end + 1


def _predictor_decode(buf: bytearray) -> bytes:
    """EXR zip post-filter: delta-decode then de-interleave halves.

    The spec's sequential ``d[i] = d[i-1] + d[i] - 128`` (mod 256) equals
    ``cumsum(d - 128) + 128`` with d[0] preserved."""
    arr = np.frombuffer(bytes(buf), np.uint8).astype(np.int32)
    arr = (np.cumsum(arr - 128, dtype=np.int64) + 128).astype(np.uint8)
    n = arr.size
    out = np.empty(n, np.uint8)
    half = (n + 1) // 2
    out[0::2] = arr[:half]
    out[1::2] = arr[half:]
    return out.tobytes()


def _predictor_encode(raw: bytes) -> bytes:
    arr = np.frombuffer(raw, np.uint8)
    n = arr.size
    half = (n + 1) // 2
    inter = np.empty(n, np.uint8)
    inter[:half] = arr[0::2]
    inter[half:] = arr[1::2]
    i32 = inter.astype(np.int32)
    delta = np.empty(n, np.int32)
    delta[0] = i32[0]
    delta[1:] = i32[1:] - i32[:-1] + 128
    return delta.astype(np.uint8).tobytes()


def read_exr(path: str):
    """Read an EXR file.  Returns ((H, W, C) float32, channel_names) with
    channels in file (alphabetical) order, top row first."""
    with open(path, "rb") as f:
        data = f.read()
    magic, version = struct.unpack_from("<ii", data, 0)
    if magic != _MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    if version & 0x200 or version & 0x800 or version & 0x1000:
        raise ValueError(f"{path}: tiled/deep/multi-part EXR not supported")

    pos = 8
    channels = []  # (name, pixel_type)
    compression = 0
    dw = None
    while True:
        if data[pos] == 0:  # end of header
            pos += 1
            break
        name, pos = _read_cstr(data, pos)
        attr_type, pos = _read_cstr(data, pos)
        size = struct.unpack_from("<i", data, pos)[0]
        pos += 4
        payload = data[pos : pos + size]
        pos += size
        if name == "channels":
            cp = 0
            while payload[cp] != 0:
                cname_end = payload.index(b"\x00", cp)
                cname = payload[cp:cname_end].decode("latin-1")
                ptype, _, xs, ys = struct.unpack_from(
                    "<iiii", payload, cname_end + 1
                )
                if xs != 1 or ys != 1:
                    raise ValueError(f"{path}: subsampled channels unsupported")
                channels.append((cname, ptype))
                cp = cname_end + 1 + 16
        elif name == "compression":
            compression = payload[0]
        elif name == "dataWindow":
            dw = struct.unpack("<iiii", payload)
    if dw is None:
        raise ValueError(f"{path}: missing dataWindow")
    x0, y0, x1, y1 = dw
    w, h = x1 - x0 + 1, y1 - y0 + 1

    if compression == 0:
        lines_per_block = 1
    elif compression in (2, 3):  # ZIPS, ZIP
        lines_per_block = 1 if compression == 2 else 16
    else:
        raise ValueError(
            f"{path}: compression {compression} unsupported (NONE/ZIP only)"
        )

    n_blocks = -(-h // lines_per_block)
    offsets = struct.unpack_from(f"<{n_blocks}q", data, pos)

    dtypes = [_DTYPE[t] for _, t in channels]
    bpp = [np.dtype(d).itemsize for d in dtypes]
    out = np.empty((h, w, len(channels)), np.float32)
    for b, off in enumerate(offsets):
        y_block, size = struct.unpack_from("<ii", data, off)
        raw = data[off + 8 : off + 8 + size]
        rows = min(lines_per_block, h - (y_block - y0))
        expect = rows * w * sum(bpp)
        if compression and size < expect:
            raw = _predictor_decode(bytearray(zlib.decompress(raw)))
        # Block layout: per scanline, per channel (alphabetical), w values.
        rp = 0
        for r in range(rows):
            y = y_block - y0 + r
            for c, dt in enumerate(dtypes):
                nb = w * bpp[c]
                out[y, :, c] = np.frombuffer(
                    raw, dt, count=w, offset=rp
                ).astype(np.float32)
                rp += nb
    return out, [n for n, _ in channels]


def read_exr_rgb(path: str) -> np.ndarray:
    """(H, W, 3) float32 from an EXR's R/G/B channels (or Y replicated)."""
    img, names = read_exr(path)
    upper = [n.upper().split(".")[-1] for n in names]
    if all(k in upper for k in ("R", "G", "B")):
        idx = [upper.index(k) for k in ("R", "G", "B")]
        return img[..., idx]
    if "Y" in upper:
        return np.repeat(img[..., upper.index("Y") : upper.index("Y") + 1], 3, -1)
    return img[..., :3]


def write_exr(path: str, image: np.ndarray, half: bool = True) -> None:
    """Write (H, W, 3) float (top row first) as ZIP-compressed scanline EXR."""
    img = np.asarray(image, np.float32)
    if img.ndim != 3 or img.shape[2] < 3:
        raise ValueError(f"write_exr needs an (H, W, 3+) image, not {img.shape}")
    h, w = img.shape[:2]
    dt = np.float16 if half else np.float32
    ptype = _PIXEL_HALF if half else _PIXEL_FLOAT
    bpp = np.dtype(dt).itemsize

    def attr(name: bytes, atype: bytes, payload: bytes) -> bytes:
        return (
            name + b"\x00" + atype + b"\x00"
            + struct.pack("<i", len(payload)) + payload
        )

    chans = b""
    for cname in (b"B", b"G", b"R"):  # alphabetical
        chans += cname + b"\x00" + struct.pack("<iiii", ptype, 0, 1, 1)
    chans += b"\x00"
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = (
        struct.pack("<ii", _MAGIC, 2)
        + attr(b"channels", b"chlist", chans)
        + attr(b"compression", b"compression", b"\x03")  # ZIP
        + attr(b"dataWindow", b"box2i", box)
        + attr(b"displayWindow", b"box2i", box)
        + attr(b"lineOrder", b"lineOrder", b"\x00")
        + attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
        + attr(b"screenWindowCenter", b"v2f", struct.pack("<ff", 0.0, 0.0))
        + attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
        + b"\x00"
    )

    lines_per_block = 16
    n_blocks = -(-h // lines_per_block)
    blocks = []
    for b in range(n_blocks):
        y = b * lines_per_block
        rows = min(lines_per_block, h - y)
        raw = bytearray()
        for r in range(rows):
            for c in (2, 1, 0):  # B, G, R
                raw += img[y + r, :, c].astype(dt).tobytes()
        comp = zlib.compress(_predictor_encode(bytes(raw)))
        if len(comp) >= len(raw):
            comp = bytes(raw)
        blocks.append((y, comp))

    table_pos = len(header)
    data_pos = table_pos + 8 * n_blocks
    offsets = []
    cur = data_pos
    for y, comp in blocks:
        offsets.append(cur)
        cur += 8 + len(comp)
    with open(path, "wb") as f:
        f.write(header)
        f.write(struct.pack(f"<{n_blocks}q", *offsets))
        for y, comp in blocks:
            f.write(struct.pack("<ii", y, len(comp)))
            f.write(comp)
