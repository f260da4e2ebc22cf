"""Environment radiance (port of ``heatray_tpu.render.envmap``): the
lat/long lookup of ``environmentLight.rlsl:19-33`` with its u/v conventions,
theta wrap, rotation and exposure, and the solid-colour environment as a
1x1 map (``EnvironmentLight.cpp:48-72``).  The map is planar (3, H, W);
gradients reach it and the rotation through the bilinear weights."""

from __future__ import annotations

import torch

from ..scene.lights import LightBank
from ..vec import Vec3
from .onb import ONE_OVER_PI, TWO_PI
from .texture import sample_bilinear_planar


def env_radiance(lights: LightBank, directions: Vec3) -> Vec3:
    """Radiance of the environment along unit ``directions``; zero when the
    environment is disabled."""
    d = directions
    zeros = torch.zeros_like(d.x)
    if not lights.env_enabled:
        return Vec3(zeros, zeros, zeros)
    comp = lights.env_exposure_compensation
    if lights.env_map.shape[1:] == (1, 1):
        color = lights.env_map[:, 0, 0] * comp
        return Vec3(zeros + color[0], zeros + color[1], zeros + color[2])

    theta = torch.atan2(d.x, -d.z) + lights.env_rotation
    theta = torch.where(theta > TWO_PI, theta - TWO_PI, theta)
    phi = torch.atan2(d.y, torch.sqrt(d.x * d.x + d.z * d.z))
    u = theta / TWO_PI + 0.5
    v = -phi * ONE_OVER_PI + 0.5
    # The shader samples (u, 1 - v) of a texture whose row 0 is the bottom;
    # with the map's top row first the two flips cancel: row v directly.
    r, g, b = sample_bilinear_planar(lights.env_map, u, v, wrap_u=True, wrap_v=False)
    return Vec3(r, g, b) * comp
