"""Texture atlas: every scene texture in one flat planar buffer (port of
``heatray_tpu.scene.textures``).

One ``(4, A)`` RGBA planar tensor holds every texture and its mip chain,
flattened row-major and concatenated, with descriptor rows per texture id;
each material slot stores a texture id (-1 = unused), as the seven texture
slots of ``PhysicallyBasedMaterial::Parameters``
(``PhysicallyBasedMaterial.h:22-41``).  Sampling is gathers: four corners a
level, eight for the trilinear mip sample of a ray cone.  LDR colour
textures turn sRGB to linear when added (``TextureLoader.cpp:106-133``);
data textures (normals, metallic-roughness) stay linear.  The atlas is
built on the host in numpy (``AtlasBuilder``) and moves to the device with
the scene.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from ..render.texture import take_clipped


def srgb_to_linear_np(srgb: np.ndarray) -> np.ndarray:
    a = 0.055
    return np.where(
        srgb <= 0.04045,
        srgb / 12.92,
        np.power(np.maximum((srgb + a) / (1.0 + a), 1e-10), 2.4),
    ).astype(np.float32)


@dataclasses.dataclass
class TextureAtlas:
    """Packed texture data.  A texture's level-l texel (x, y) lives at
    ``mip_offset[id, l] + y * mip_width[id, l] + x``; ``offset``, ``width``
    and ``height`` are level 0.  A chain shorter than ``num_levels``
    repeats its 1x1 tail, so an LOD clamped to ``num_levels - 1`` is always
    safe (the reference's default ``RL_LINEAR_MIPMAP_LINEAR`` samplers,
    ``RLWrapper/Texture.h:51,86``)."""

    data: torch.Tensor  # (4, A) f32
    offset: torch.Tensor  # (N,) i32
    width: torch.Tensor  # (N,) i32
    height: torch.Tensor  # (N,) i32
    mip_offset: torch.Tensor  # (N, L) i32
    mip_width: torch.Tensor  # (N, L) i32
    mip_height: torch.Tensor  # (N, L) i32

    @property
    def num_textures(self) -> int:
        return self.offset.shape[0]

    @property
    def num_levels(self) -> int:
        return self.mip_offset.shape[1]


def _downsample2x(img: np.ndarray) -> np.ndarray:
    """One mip level down: a 2x2 box filter ((H, W, 4) -> (ceil(H/2),
    ceil(W/2), 4)); an odd dimension repeats its last row or column."""
    h, w, _ = img.shape
    if h & 1:
        img = np.concatenate([img, img[-1:]], axis=0)
    if w & 1:
        img = np.concatenate([img, img[:, -1:]], axis=1)
    h2, w2 = img.shape[0] // 2, img.shape[1] // 2
    return img.reshape(h2, 2, w2, 2, 4).mean(axis=(1, 3)).astype(np.float32)


class AtlasBuilder:
    """Host-side accumulation of texture images into one atlas."""

    def __init__(self):
        self._images: List[np.ndarray] = []
        self._keys = {}

    def add(self, image: np.ndarray, srgb: bool = False, key=None) -> int:
        """Add an (H, W), (H, W, 3) or (H, W, 4) float or uint8 image and
        return its texture id.  ``srgb`` turns the RGB channels linear (LDR
        colour textures); ``key`` dedupes repeated adds of one source."""
        if key is not None and key in self._keys:
            return self._keys[key]
        img = np.asarray(image)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        img = img.astype(np.float32)
        if img.ndim == 2:
            img = img[:, :, None]
        if img.shape[2] == 1:
            img = np.repeat(img, 3, axis=2)
        if img.shape[2] == 3:
            img = np.concatenate([img, np.ones_like(img[:, :, :1])], axis=2)
        if srgb:
            img = np.concatenate([srgb_to_linear_np(img[:, :, :3]), img[:, :, 3:]], axis=2)
        tex_id = len(self._images)
        self._images.append(img)
        if key is not None:
            self._keys[key] = tex_id
        return tex_id

    @property
    def num_textures(self) -> int:
        return len(self._images)

    def build(self, mips: bool = True) -> TextureAtlas:
        """The atlas of CPU tensors; with no texture, a 1x1 white one."""
        images = self._images or [np.ones((1, 1, 4), np.float32)]
        # Full mip chains down to 1x1 (``Texture.h:86``); ~1/3 more memory.
        chains = []
        for img in images:
            chain = [img]
            while mips and (chain[-1].shape[0] > 1 or chain[-1].shape[1] > 1):
                chain.append(_downsample2x(chain[-1]))
            chains.append(chain)
        num_levels = max(len(c) for c in chains)

        chunks = []
        mip_off = np.zeros((len(images), num_levels), np.int32)
        mip_w = np.zeros((len(images), num_levels), np.int32)
        mip_h = np.zeros((len(images), num_levels), np.int32)
        off = 0
        for i, chain in enumerate(chains):
            for lvl in range(num_levels):
                img = chain[min(lvl, len(chain) - 1)]
                h, w, _ = img.shape
                if lvl < len(chain):
                    chunks.append(img.reshape(h * w, 4))
                    mip_off[i, lvl] = off
                    off += h * w
                else:  # a short chain aliases its 1x1 tail
                    mip_off[i, lvl] = mip_off[i, len(chain) - 1]
                mip_w[i, lvl] = w
                mip_h[i, lvl] = h
        t = torch.from_numpy
        return TextureAtlas(
            data=t(np.ascontiguousarray(np.concatenate(chunks, axis=0).T)),
            offset=t(mip_off[:, 0].copy()),
            width=t(mip_w[:, 0].copy()),
            height=t(mip_h[:, 0].copy()),
            mip_offset=t(mip_off),
            mip_width=t(mip_w),
            mip_height=t(mip_h),
        )


def _bilinear(atlas: TextureAtlas, base, w, h, u, v, num_channels):
    """Bilinear GL-REPEAT sample at one mip level (per-ray base, w, h)."""
    # GL REPEAT (the reference's default sampler): the fractional part.
    uu = u - torch.floor(u)
    vv = v - torch.floor(v)
    x = uu * w.float() - 0.5
    y = vv * h.float() - 0.5
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = x - x0f
    fy = y - y0f
    x0 = torch.remainder(x0f.to(torch.int32), w)
    y0 = torch.remainder(y0f.to(torch.int32), h)
    x1 = torch.remainder(x0 + 1, w)
    y1 = torch.remainder(y0 + 1, h)

    i00, i10 = base + y0 * w + x0, base + y0 * w + x1
    i01, i11 = base + y1 * w + x0, base + y1 * w + x1
    out = []
    for ch in range(num_channels):
        # Clipped: a garbage uv on a dead lane reads a texel, never NaN.
        plane = atlas.data[ch]
        c00, c10 = take_clipped(plane, i00), take_clipped(plane, i10)
        c01, c11 = take_clipped(plane, i01), take_clipped(plane, i11)
        top = c00 + (c10 - c00) * fx
        bot = c01 + (c11 - c01) * fx
        out.append(top + (bot - top) * fy)
    return out


def _mip_descr(atlas: TextureAtlas, tid, lvl):
    """Per-ray (base, w, h) of mip level ``lvl``."""
    flat = (tid * atlas.num_levels + lvl).long()
    return (atlas.mip_offset.reshape(-1)[flat], atlas.mip_width.reshape(-1)[flat],
            atlas.mip_height.reshape(-1)[flat])


def sample_atlas(atlas: TextureAtlas, tex_id, u, v, num_channels: int = 4, footprint=None):
    """Bilinear (with ``footprint``, trilinear) GL-REPEAT sample of each
    ray's texture: ``tex_id`` (R,) int32 (the caller masks id < 0 after),
    ``u``/``v`` (R,) float32.  ``footprint`` (R,) is the ray cone's width in
    UV units: the LOD is ``log2(footprint * texture_resolution)``, blended
    between the two mip levels around it, and carries no gradient (a
    piecewise-constant choice, as the reference's ``stop_gradient``).
    Returns ``num_channels`` (R,) tensors."""
    tid = tex_id.clamp(min=0).long()
    if footprint is None or atlas.num_levels <= 1:
        return _bilinear(atlas, atlas.offset[tid], atlas.width[tid], atlas.height[tid], u, v,
                         num_channels)

    w0 = atlas.width[tid].float()
    h0 = atlas.height[tid].float()
    # Texels the footprint covers at level 0 (isotropic).
    texels = torch.clamp(footprint.detach(), min=1e-8) * torch.sqrt(w0 * h0)
    lod = torch.clamp(torch.log2(texels), 0.0, float(atlas.num_levels - 1))
    # The clamp after the cast reads level 0 where the LOD is NaN, as
    # XLA's float-to-int conversion does (the CPU's gives INT_MIN).
    l0 = lod.to(torch.int32).clamp(0, atlas.num_levels - 1)
    l1 = torch.clamp(l0 + 1, max=atlas.num_levels - 1)
    fl = lod - l0.float()

    lo = _bilinear(atlas, *_mip_descr(atlas, tid, l0), u, v, num_channels)
    hi = _bilinear(atlas, *_mip_descr(atlas, tid, l1), u, v, num_channels)
    return [a + (b - a) * fl for a, b in zip(lo, hi)]
