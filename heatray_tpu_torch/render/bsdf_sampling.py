"""BSDF importance sampling in the local Y-up shading frame (port of
``heatray_tpu.render.bsdf_sampling``, after ``utility.rlsl:62-139``)."""

from __future__ import annotations

import torch

from ..vec import Vec3, clip
from .onb import TWO_PI, square


def cosine_weighted_sample(u1, u2):
    """Cosine-weighted hemisphere direction (PDF cos/pi).  Returns
    (lx, ly, lz)."""
    r = torch.sqrt(u1)
    phi = TWO_PI * u2
    x = r * torch.cos(phi)
    y = torch.sqrt(clip(1.0 - u1, 1e-12))
    z = r * torch.sin(phi)
    inv = 1.0 / torch.sqrt(x * x + y * y + z * z + 1e-12)
    return x * inv, y * inv, z * inv


def sample_visible_ggx(local_v, u1, u2, alpha):
    """Heitz 2018 visible-NDF GGX half vector.  ``local_v`` (lx, ly, lz) in
    the Y-up frame; returns (hx, hy, hz)."""
    vx, vy, vz = local_v[0], local_v[2], local_v[1]  # Y-up -> Z-up

    sx, sy, sz = vx * alpha, vy * alpha, vz
    inv = 1.0 / torch.sqrt(sx * sx + sy * sy + sz * sz + 1e-12)
    vhx, vhy, vhz = sx * inv, sy * inv, sz * inv

    len_sq = square(vhx) + square(vhy)
    inv_len = 1.0 / torch.sqrt(len_sq + 1e-12)
    has = len_sq > 0.0
    t1x = torch.where(has, -vhy * inv_len, 1.0)
    t1y = torch.where(has, vhx * inv_len, 0.0)
    t1z = torch.zeros_like(t1x)
    t2x = vhy * t1z - vhz * t1y
    t2y = vhz * t1x - vhx * t1z
    t2z = vhx * t1y - vhy * t1x

    r = torch.sqrt(u1)
    phi = TWO_PI * u2
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vhz)
    p1_sq = square(p1)
    p2 = (1.0 - s) * torch.sqrt(clip(1.0 - p1_sq, 1e-12)) + s * p2
    pz = torch.sqrt(clip(1.0 - p1_sq - square(p2), 1e-12))

    nhx = p1 * t1x + p2 * t2x + pz * vhx
    nhy = p1 * t1y + p2 * t2y + pz * vhy
    nhz = p1 * t1z + p2 * t2z + pz * vhz

    hx, hy, hz = alpha * nhx, alpha * nhy, clip(nhz, 0.0)
    inv = 1.0 / torch.sqrt(hx * hx + hy * hy + hz * hz + 1e-12)
    return hx * inv, hz * inv, hy * inv  # Z-up -> Y-up


def refract(incident: Vec3, n: Vec3, eta):
    """GLSL-style refract (incident toward the surface, n away from it);
    a zero vector on total internal reflection."""
    cos_i = n.dot(incident)
    k = 1.0 - square(eta) * (1.0 - square(cos_i))
    out = incident * eta - n * (eta * cos_i + torch.sqrt(clip(k, 1e-12)))
    return Vec3.where(k >= 0.0, out, 0.0)
