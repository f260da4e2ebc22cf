"""GGX multiscattering energy compensation (port of
``heatray_tpu.render.multiscatter``).

The directional albedo E(roughness, NdotV) is tabulated on the host by the
reference's Monte Carlo tool (``MultiScatterUtil.cpp:91-139``) as
(1 - E) / E, and evaluated per lane as ``f_ms = 1 + Cspec (1 - E) / E``
either from a degree-16 Chebyshev product surface fitted to E
(``ms_impl="fit"``, no gather) or by a bilinear lookup in the table,
packed so that one row gather fetches a cell's four corners
(``ms_impl="lut"``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..sampling import qmc
from ..vec import clip

LUT_SIZE = 128
SAMPLE_COUNT = 4096
FIT_DEGREE = 16


def _g1_smith_ggx(n_dot_i, alpha):
    a2 = alpha * alpha
    denom = np.sqrt(a2 + (1.0 - a2) * n_dot_i * n_dot_i) + n_dot_i
    return (2.0 * n_dot_i) / np.maximum(denom, 1e-5)


def _importance_sample_ggx(rand, alpha):
    """NDF-proportional half vectors (Z-up), ``MultiScatterUtil.cpp:34-47``."""
    a2 = alpha * alpha
    cos_theta = np.sqrt(
        np.maximum(0.0, (1.0 - rand[:, 0]) / ((a2 - 1.0) * rand[:, 0] + 1.0))
    )
    sin_theta = np.sqrt(np.maximum(0.0, 1.0 - cos_theta * cos_theta))
    phi = 2.0 * np.pi * rand[:, 1]
    h = np.stack([sin_theta * np.cos(phi), sin_theta * np.sin(phi), cos_theta], axis=-1)
    return h / np.maximum(np.linalg.norm(h, axis=-1, keepdims=True), 1e-20)


@functools.lru_cache(maxsize=1)
def generate_multiscatter_lut() -> np.ndarray:
    """(LUT_SIZE, LUT_SIZE) float32: rows = roughness, cols = NdotV, value
    (1 - E) / E."""
    rand = qmc.sobol(SAMPLE_COUNT, 0).astype(np.float64)
    grid = (np.arange(LUT_SIZE, dtype=np.float64) + 0.5) / LUT_SIZE
    n_dot_v = grid
    v = np.stack(
        [np.sqrt(np.maximum(0.0, 1.0 - n_dot_v**2)), np.zeros_like(n_dot_v), n_dot_v],
        axis=-1,
    )
    lut = np.empty((LUT_SIZE, LUT_SIZE), np.float64)
    for row, roughness in enumerate(grid):
        alpha = roughness * roughness
        h = _importance_sample_ggx(rand, alpha)
        v_dot_h = h @ v.T
        l_z = 2.0 * v_dot_h * h[:, 2:3] - v[:, 2][None, :]
        n_dot_l = np.clip(l_z, 0.0, 1.0)
        vdh = np.clip(v_dot_h, 0.0, 1.0)
        ndh = np.clip(h[:, 2], 0.0, 1.0)[:, None]
        g2 = _g1_smith_ggx(n_dot_l, alpha) * _g1_smith_ggx(n_dot_v[None, :], alpha)
        contrib = np.where(
            l_z > 0.0, (g2 * vdh) / np.maximum(n_dot_v[None, :] * ndh, 1e-12), 0.0
        )
        e = contrib.mean(axis=0)
        lut[row] = (1.0 - e) / np.maximum(e, 1e-6)
    return lut.astype(np.float32)


@functools.lru_cache(maxsize=1)
def _packed_lut_np() -> np.ndarray:
    """((L+1)^2, 4): row (y0+1)*(L+1) + (x0+1) holds the four edge-clamped
    corner texels [c00, c10, c01, c11] of cell (x0, y0)."""
    pad = np.pad(generate_multiscatter_lut(), 1, mode="edge")
    lp1 = LUT_SIZE + 1
    rows = np.empty((lp1 * lp1, 4), np.float32)
    rows[:, 0] = pad[:lp1, :lp1].reshape(-1)  # c00 = [y0,   x0  ]
    rows[:, 1] = pad[:lp1, 1:].reshape(-1)  # c10 = [y0,   x0+1]
    rows[:, 2] = pad[1:, :lp1].reshape(-1)  # c01 = [y0+1, x0  ]
    rows[:, 3] = pad[1:, 1:].reshape(-1)  # c11 = [y0+1, x0+1]
    return rows


def multiscatter_lut_packed(device) -> torch.Tensor:
    """The corner-packed table of ``compute_multiscattering`` on ``device``."""
    return torch.from_numpy(_packed_lut_np()).to(device)


@functools.lru_cache(maxsize=1)
def _fit_coeffs_np() -> np.ndarray:
    """(D+1, D+1) Chebyshev-product coefficients of E = 1 / (1 + LUT),
    least squares weighted by 1/E^2; row = roughness degree, column =
    NdotV degree."""
    from numpy.polynomial import chebyshev as cheb

    lut = generate_multiscatter_lut().astype(np.float64)
    e = 1.0 / (1.0 + np.maximum(lut, 0.0))
    xs = 2.0 * ((np.arange(LUT_SIZE, dtype=np.float64) + 0.5) / LUT_SIZE) - 1.0
    tv = cheb.chebvander(xs, FIT_DEGREE)
    a = np.einsum("ri,cj->rcij", tv, tv).reshape(LUT_SIZE * LUT_SIZE, -1)
    w = (1.0 / e**2).reshape(-1)
    coef, *_ = np.linalg.lstsq(a * w[:, None], e.reshape(-1) * w, rcond=None)
    return coef.reshape(FIT_DEGREE + 1, FIT_DEGREE + 1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def fit_coeffs(device) -> torch.Tensor:
    """The fit's coefficients on ``device``."""
    return torch.from_numpy(_fit_coeffs_np()).to(device)


def _cheb_planes(x, degree: int) -> torch.Tensor:
    """(degree+1, *x.shape): T_0..T_degree of ``x`` by the recurrence."""
    t = [torch.ones_like(x), x]
    for _ in range(degree - 1):
        t.append(2.0 * x * t[-1] - t[-2])
    return torch.stack(t)


def compute_multiscattering_fit(c_spec, n_dot_i, roughness):
    """``1 + c_spec (1 - E) / E`` with E from the Chebyshev surface;
    ``c_spec`` a Vec3 or an (R,) tensor."""
    cs = fit_coeffs(n_dot_i.device)
    x = clip(2.0 * n_dot_i - 1.0, -1.0, 1.0)
    y = clip(2.0 * roughness - 1.0, -1.0, 1.0)
    inner = cs @ _cheb_planes(x, FIT_DEGREE)  # (D+1, R): sum over NdotV degrees
    e = torch.sum(_cheb_planes(y, FIT_DEGREE) * inner, dim=0)
    e = clip(e, 1e-3, 1.0)
    return 1.0 + c_spec * ((1.0 - e) / e)


def compute_multiscattering(packed_lut: torch.Tensor, c_spec, n_dot_i, roughness):
    """``f_ms = 1 + c_spec * LUT(n_dot_i, roughness)`` (``microfacet.rlsl:17-23``),
    bilinear in the table from ``multiscatter_lut_packed``; the row index is
    clamped to the table, as the JAX package's ``take(mode="clip")``."""
    lp1 = int(round(packed_lut.shape[0] ** 0.5))
    size = lp1 - 1
    x = n_dot_i * size - 0.5
    y = roughness * size - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    key = ((y0.long() + 1) * lp1 + x0.long() + 1).clamp(0, packed_lut.shape[0] - 1)
    rows = packed_lut[key]
    c00, c10, c01, c11 = rows.unbind(-1)
    top = c00 + (c10 - c00) * fx
    bot = c01 + (c11 - c01) * fx
    return 1.0 + c_spec * (top + (bot - top) * fy)
