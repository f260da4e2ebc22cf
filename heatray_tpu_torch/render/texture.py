"""Texture sampling as gathers (port of ``heatray_tpu.render.texture``).

Images are planar ``(C, H, W)``: the four bilinear corners are gathers of
flat ``(R,)`` index tensors per channel.  Indices are clamped into the image
before the gather, as the reference's ``mode="clip"`` does, so a garbage
coordinate on a dead lane reads a texel instead of failing.  The corner
arithmetic follows the reference's ``_corner_indices``: ``floor`` in
float32, a truncating cast to int32, and the wrap by ``torch.remainder``
(a floor modulo, as ``jnp.remainder``; ``torch.fmod`` keeps the sign).
"""

from __future__ import annotations

import torch


def _corner_indices(h, w, u, v, wrap_u, wrap_v):
    x = u * w - 0.5
    y = v * h - 0.5
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = x - x0f
    fy = y - y0f
    x0 = x0f.to(torch.int32)
    y0 = y0f.to(torch.int32)
    x1 = x0 + 1
    y1 = y0 + 1
    if wrap_u:
        x0, x1 = torch.remainder(x0, w), torch.remainder(x1, w)
    else:
        x0, x1 = x0.clamp(0, w - 1), x1.clamp(0, w - 1)
    if wrap_v:
        y0, y1 = torch.remainder(y0, h), torch.remainder(y1, h)
    else:
        y0, y1 = y0.clamp(0, h - 1), y1.clamp(0, h - 1)
    return x0, x1, y0, y1, fx, fy


def take_clipped(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take(flat, idx, mode="clip")`` of a 1-D tensor.  An
    ``index_select``, whose backward adds into the source with
    ``index_add_``; ``torch.take``'s sums each run of duplicate indices in
    one thread on the card, as the row gather's ``table[slot]`` did (1.24 s
    of a step against 13 ms, ``shade_table.gather_rows``)."""
    return flat.index_select(0, idx.clamp(0, flat.numel() - 1).long())


def sample_bilinear_planar(image: torch.Tensor, u, v, wrap_u=False, wrap_v=False):
    """Bilinear sample of a planar ``(C, H, W)`` image at (u, v) in [0, 1]
    (v = 0 is row 0); returns a list of C tensors of ``u``'s shape."""
    c, h, w = image.shape
    x0, x1, y0, y1, fx, fy = _corner_indices(h, w, u, v, wrap_u, wrap_v)
    flat = image.reshape(c, h * w)
    i00, i10 = y0 * w + x0, y0 * w + x1
    i01, i11 = y1 * w + x0, y1 * w + x1
    out = []
    for ch in range(c):
        f = flat[ch]
        c00, c10 = take_clipped(f, i00), take_clipped(f, i10)
        c01, c11 = take_clipped(f, i01), take_clipped(f, i11)
        top = c00 + (c10 - c00) * fx
        bot = c01 + (c11 - c01) * fx
        out.append(top + (bot - top) * fy)
    return out


def sample_bilinear_scalar(image: torch.Tensor, u, v, wrap_u=False, wrap_v=False):
    """Bilinear sample of a single-channel ``(H, W)`` image."""
    return sample_bilinear_planar(image[None], u, v, wrap_u, wrap_v)[0]


def sample_nearest_planar(image: torch.Tensor, u, v):
    c, h, w = image.shape
    x = (u * w).to(torch.int32).clamp(0, w - 1)
    y = (v * h).to(torch.int32).clamp(0, h - 1)
    flat = image.reshape(c, h * w)
    idx = y * w + x
    return [take_clipped(flat[ch], idx) for ch in range(c)]
