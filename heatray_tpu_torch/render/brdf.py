"""BRDF terms: GGX distribution, Fresnel and Smith masking (port of the
terms of ``heatray_tpu.render.brdf`` the shading path uses)."""

from __future__ import annotations

import torch

from ..vec import clip
from .onb import ONE_OVER_PI, greater_than_zero, pow5, square


def f_schlick(c_spec, cos_theta):
    """Schlick Fresnel with F90 = 1 (``brdfs.rlsl:46-57``); scalar or RGB
    F0."""
    return c_spec + (1.0 - c_spec) * pow5(1.0 - cos_theta)


def f_fresnel(eta, cos_theta_i):
    """Exact dielectric Fresnel (``brdfs.rlsl:59-71``); 1 past the critical
    angle."""
    sin_theta_t2 = square(eta) * (1.0 - square(cos_theta_i))
    cos_theta_t = torch.sqrt(clip(1.0 - sin_theta_t2, 1e-12))
    perp = square(
        (eta * cos_theta_i - cos_theta_t)
        / greater_than_zero(eta * cos_theta_i + cos_theta_t)
    )
    para = square(
        (cos_theta_i - eta * cos_theta_t)
        / greater_than_zero(cos_theta_i + eta * cos_theta_t)
    )
    return torch.where(sin_theta_t2 < 1.0, 0.5 * (perp + para), 1.0)


def d_ggx(n_dot_h, alpha):
    """GGX NDF (``brdfs.rlsl:73-78``)."""
    a2 = square(alpha)
    denom = square(square(n_dot_h) * (a2 - 1.0) + 1.0)
    return ONE_OVER_PI * a2 / greater_than_zero(denom)


def g1_smith_ggx(n_dot_i, alpha):
    """Smith G1 (``brdfs.rlsl:88-93``)."""
    a2 = square(alpha)
    denom = torch.sqrt(a2 + (1.0 - a2) * greater_than_zero(square(n_dot_i))) + n_dot_i
    return (2.0 * n_dot_i) / greater_than_zero(denom)


def g2_smith_ggx(n_dot_o, n_dot_i, alpha):
    """Separable Smith G2 (``brdfs.rlsl:95-98``)."""
    return g1_smith_ggx(n_dot_o, alpha) * g1_smith_ggx(n_dot_i, alpha)
