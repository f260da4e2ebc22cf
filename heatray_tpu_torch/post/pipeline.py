"""Display post-processing pipeline (port of ``heatray_tpu.post.pipeline``,
after the reference's display shader ``displayGL.frag:74-151``): pass-count
resolve, the fitted ACES tonemap, brightness and contrast, hue, saturation
and vibrance in HSV, RGB gains, vignette, exposure and the final sRGB
encode.  Differentiable; every clamp is ``vec.clip``, whose gradient at a
bound is ``jnp.clip``'s.  The 3x3 colour matrices are applied as sums of
products, so no matrix kernel of either device rounds them.
"""

from __future__ import annotations

import dataclasses

import torch

from ..render.onb import linear_to_srgb, srgb_to_linear
from ..vec import clip

# ACES matrices (``displayGL.frag:29-39``), as rows: out_i = sum_j M[i][j] c_j.
ACES_INPUT = (
    (0.59719, 0.35458, 0.04823),
    (0.07600, 0.90834, 0.01566),
    (0.02840, 0.13383, 0.83777),
)
ACES_OUTPUT = (
    (1.60475, -0.53108, -0.07367),
    (-0.10208, 1.10813, -0.00605),
    (-0.00327, -0.07276, 1.07602),
)


@dataclasses.dataclass(frozen=True)
class PostProcessingParams:
    """``HeatrayRenderer.h:104-117`` defaults."""

    tonemapping_enabled: bool = False
    exposure: float = 0.0  # EV; scale = 2^exposure
    brightness: float = 0.0
    contrast: float = 1.0
    hue: float = 1.0
    saturation: float = 1.0
    vibrance: float = 0.0
    red: float = 1.0
    green: float = 1.0
    blue: float = 1.0
    vignette_intensity: float = 0.0
    vignette_falloff: float = 1.0


def _mat3(m, c):
    """(..., 3) colours times the rows of ``m``."""
    return torch.stack(
        [c[..., 0] * row[0] + c[..., 1] * row[1] + c[..., 2] * row[2] for row in m], dim=-1)


def rrt_and_odt_fit(v):
    """``displayGL.frag:41-46``."""
    a = v * (v + 0.0245786) - 0.000090537
    b = v * (0.983729 * v + 0.4329510) + 0.238081
    return a / b


def aces_tonemap(color):
    """The fitted ACES chain with the reference's sRGB encode before and
    decode after (``displayGL.frag:82-90``)."""
    c = _mat3(ACES_INPUT, linear_to_srgb(color))
    c = _mat3(ACES_OUTPUT, rrt_and_odt_fit(c))
    return srgb_to_linear(clip(c, 0.0, 1.0))


def rgb_to_hsv(c):
    """GLSL branchless RGB->HSV (``displayGL.frag:101-111``).  The hue of
    the red sector is a floor modulo (``torch.remainder``, as ``jnp.mod``)."""
    r, g, b = c[..., 0], c[..., 1], c[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    d = maxc - minc
    e = 1.0e-10
    hr = torch.remainder((g - b) / (6.0 * d + e), 1.0)
    hg = ((b - r) / (6.0 * d + e)) + 1.0 / 3.0
    hb = ((r - g) / (6.0 * d + e)) + 2.0 / 3.0
    h = torch.abs(torch.where(maxc == r, hr, torch.where(maxc == g, hg, hb)))
    return torch.stack([h, d / (maxc + e), maxc], dim=-1)


def hsv_to_rgb(hsv):
    """GLSL HSV->RGB (``displayGL.frag:122-127``)."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    out = []
    for k in (1.0, 2.0 / 3.0, 1.0 / 3.0):
        p = torch.abs(torch.remainder(h + k, 1.0) * 6.0 - 3.0)
        out.append(v * (1.0 + s * (clip(p - 1.0, 0.0, 1.0) - 1.0)))
    return torch.stack(out, dim=-1)


def glsl_smoothstep(e0: float, e1: float, x):
    den = e1 - e0 if abs(e1 - e0) > 1e-12 else 1e-12
    t = clip((x - e0) / den, 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def apply_post_pipeline(accum: torch.Tensor,
                        params: PostProcessingParams | None = None) -> torch.Tensor:
    """Planar (4, H, W) accumulation -> (H, W, 3) sRGB display image in
    [0, 1], row 0 = image bottom, on ``accum``'s device."""
    if params is None:
        params = PostProcessingParams()
    h, w = accum.shape[1], accum.shape[2]
    color = (accum[:3] / clip(accum[3:], 1e-10)).permute(1, 2, 0)

    if params.tonemapping_enabled:
        color = aces_tonemap(color)

    # Brightness and contrast (``displayGL.frag:96``).
    color = (color - 0.5) * params.contrast + 0.5 + params.brightness

    # Hue, saturation and vibrance (``displayGL.frag:100-128``).
    hsv = rgb_to_hsv(color)
    sat = hsv[..., 1] * params.saturation
    sat = sat * (1.0 + torch.sqrt(clip(sat, 0.0)) * params.vibrance)
    color = hsv_to_rgb(torch.stack([hsv[..., 0] * params.hue, sat, hsv[..., 2]], dim=-1))

    # RGB gains (``displayGL.frag:131-135``).
    color = torch.stack([color[..., 0] * params.red, color[..., 1] * params.green,
                         color[..., 2] * params.blue], dim=-1)

    # Vignette, with the reference's ``+ blue`` term (``displayGL.frag:138-142``).
    ys = ((torch.arange(h, dtype=torch.float32, device=accum.device) + 0.5) / h)[:, None]
    xs = ((torch.arange(w, dtype=torch.float32, device=accum.device) + 0.5) / w)[None, :]
    dist = torch.sqrt((0.5 - xs) ** 2 + (0.5 - ys) ** 2)
    vig = glsl_smoothstep(0.8, params.vignette_falloff * 0.799,
                          dist * (params.vignette_intensity + params.blue))
    color = color * vig[..., None]

    # Exposure compensation, then the sRGB encode (``displayGL.frag:145-148``).
    color = color * (2.0 ** params.exposure)
    return clip(linear_to_srgb(clip(color, 0.0)), 0.0, 1.0)
