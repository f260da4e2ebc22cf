"""Frames and color helpers (port of ``heatray_tpu.render.onb``, after
``Resources/shaders/utility.rlsl``)."""

from __future__ import annotations

import torch

from ..vec import Vec3, clip

PI = 3.14159265359
TWO_PI = 2.0 * PI
ONE_OVER_PI = 1.0 / PI


def saturate(x):
    return clip(x, 0.0, 1.0)


def square(x):
    return x * x


def pow5(x):
    x2 = x * x
    return x * x2 * x2


def greater_than_zero(x):
    """``max(1e-5, x)`` (``utility.rlsl:153-156``)."""
    return clip(x, 1e-5)


def get_sign(x):
    """Sign that never returns 0 (``utility.rlsl:37-40``)."""
    return torch.where(x < 0.0, -1.0, 1.0)


def luminosity(color: Vec3):
    """``dot(c, (0.33, 0.59, 0.11))`` (``utility.rlsl:163-166``)."""
    return color.x * 0.33 + color.y * 0.59 + color.z * 0.11


def orthonormal_frame(n: Vec3):
    """Pixar-revised Frisvad basis, Y-up right-handed
    (``utility.rlsl:42-60``).  Returns (X, Z); local (x, y, z) maps to
    ``x X + y N + z Z``."""
    nx, ny, nz = n.x, n.z, n.y  # left-handed Z-up permutation
    s = get_sign(nz)
    a = -1.0 / (s + nz)
    b = nx * ny * a
    x = Vec3(1.0 + s * nx * nx * a, -s * nx, s * b)
    z = Vec3(b, -ny, s + ny * ny * a)
    return x, z


def frame_to_world(lx, ly, lz, x: Vec3, n: Vec3, z: Vec3) -> Vec3:
    return x * lx + n * ly + z * lz


def world_to_frame(w: Vec3, x: Vec3, n: Vec3, z: Vec3):
    return w.dot(x), w.dot(n), w.dot(z)


def linear_to_srgb(linear):
    """``utility.rlsl:168-180`` / ``displayGL.frag:48-59``."""
    return torch.where(linear <= 0.0031308, 12.92 * linear,
                       1.055 * torch.pow(clip(linear, 1e-10), 1.0 / 2.4) - 0.055)


def srgb_to_linear(srgb):
    """``utility.rlsl:182-194`` / ``displayGL.frag:61-72``."""
    return torch.where(srgb <= 0.04045, srgb / 12.92,
                       torch.pow(clip((srgb + 0.055) / 1.055, 1e-10), 2.4))
