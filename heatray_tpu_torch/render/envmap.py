"""Environment radiance (port of ``heatray_tpu.render.envmap``) for the
solid-color environment, a 1x1 map (``EnvironmentLight.cpp:48-72``)."""

from __future__ import annotations

import torch

from ..scene.lights import LightBank
from ..vec import Vec3


def env_radiance(lights: LightBank, directions: Vec3) -> Vec3:
    """Radiance of the environment along unit ``directions``; zero when the
    environment is disabled."""
    if lights.env_map.shape[1:] != (1, 1):
        raise NotImplementedError("lat/long environment maps are not ported yet")
    zeros = torch.zeros_like(directions.x)
    if not lights.env_enabled:
        return Vec3(zeros, zeros, zeros)
    color = lights.env_map[:, 0, 0] * lights.env_exposure_compensation
    return Vec3(zeros + color[0], zeros + color[1], zeros + color[2])
