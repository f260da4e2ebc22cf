"""Fixed-capacity light bank (port of ``heatray_tpu.scene.lights``): up to
5 each of directional, point and spot lights plus one environment light (a
lat/long map or a solid colour), with the reference's
photometric-to-radiometric conversions."""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

MAX_DIRECTIONAL_LIGHTS = 5
MAX_POINT_LIGHTS = 5
MAX_SPOT_LIGHTS = 5

WATTS_TO_LUMENS = 683.0
LUMENS_TO_WATTS = 1.0 / 683.0

LIGHT_TYPE_NONE = 0
LIGHT_TYPE_DIRECTIONAL = 1
LIGHT_TYPE_POINT = 2
LIGHT_TYPE_SPOT = 3
LIGHT_TYPE_ENVIRONMENT = 4


def orientation_to_direction(phi: float, theta: float) -> np.ndarray:
    """Spherical orientation -> unit direction toward the light
    (``DirectionalLight.cpp:64-78``: Y up, ``phi`` about Y, ``theta`` the
    elevation)."""
    x = math.cos(theta) * math.sin(phi)
    y = math.sin(theta)
    z = math.cos(theta) * math.cos(phi)
    return np.array([x, y, z], dtype=np.float32)


@dataclasses.dataclass
class DirectionalLight:
    """``DirectionalLight.h:32-47``; watts = illuminance / 683."""

    direction: Tuple[float, float, float] = (0.0, 1.0, 0.0)  # toward light
    color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    illuminance: float = WATTS_TO_LUMENS * math.pi
    name: str = "directional"

    def radiometric_color(self) -> np.ndarray:
        return np.asarray(self.color, np.float32) * np.float32(
            self.illuminance * LUMENS_TO_WATTS
        )


@dataclasses.dataclass
class PointLight:
    """``PointLight.h``; watts = lm / 683 * 4 pi."""

    position: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    luminous_intensity: float = WATTS_TO_LUMENS * 4.0 * math.pi
    name: str = "point"

    def radiometric_color(self) -> np.ndarray:
        watts = (self.luminous_intensity * LUMENS_TO_WATTS) * (4.0 * math.pi)
        return np.asarray(self.color, np.float32) * np.float32(watts)


@dataclasses.dataclass
class SpotLight:
    """``SpotLight.h``; watts = lm / 683 * pi, angles stored as cosines."""

    position: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    direction: Tuple[float, float, float] = (0.0, -1.0, 0.0)  # emission dir
    color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    inner_angle: float = math.radians(20.0)
    outer_angle: float = math.radians(40.0)
    luminous_intensity: float = WATTS_TO_LUMENS * math.pi * math.pi
    name: str = "spot"

    def __post_init__(self):
        # Angle validation, ``SpotLight.cpp:58-69``.
        if self.inner_angle > self.outer_angle:
            self.inner_angle = max(0.0, self.outer_angle - math.radians(1.0))
        if self.inner_angle > 0.0 and self.inner_angle == self.outer_angle:
            self.inner_angle -= math.radians(1.0)

    def radiometric_color(self) -> np.ndarray:
        watts = (self.luminous_intensity * LUMENS_TO_WATTS) * math.pi
        return np.asarray(self.color, np.float32) * np.float32(watts)


@dataclasses.dataclass
class EnvironmentLightDesc:
    """``EnvironmentLight.h``: a lat/long HDR map or a solid colour (0.5,
    "so that it's obvious if there is more energy being emitted than
    should be", ``EnvironmentLight.cpp:52-53``)."""

    # (H, W, 3) float linear lat/long, top row first (row 0 = the +Y pole).
    image: Optional[np.ndarray] = None
    solid_color: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    exposure: float = 0.0  # EV; compensation = 2^exposure
    rotation: float = 0.0
    name: str = "environment"


@dataclasses.dataclass
class LightBank:
    """Dense light arrays.  Counts are host values; the environment's
    exposure compensation and rotation are host floats, or 0-d tensors
    where they take gradients (``diff.inverse.apply_light_params``)."""

    num_directional: int
    dir_direction: torch.Tensor  # (5, 3) toward light
    dir_color: torch.Tensor  # (5, 3) radiometric
    num_point: int
    point_position: torch.Tensor  # (5, 3)
    point_color: torch.Tensor  # (5, 3)
    num_spot: int
    spot_position: torch.Tensor  # (5, 3)
    spot_direction: torch.Tensor  # (5, 3) emission direction
    spot_color: torch.Tensor  # (5, 3)
    spot_cos_angles: torch.Tensor  # (5, 2) [cos(inner), cos(outer)]
    env_enabled: int
    env_map: torch.Tensor  # (3, He, We) planar linear; 1x1 for solid color
    env_exposure_compensation: float | torch.Tensor
    env_rotation: float | torch.Tensor


def build_light_bank(
    directional: Optional[List[DirectionalLight]] = None,
    point: Optional[List[PointLight]] = None,
    spot: Optional[List[SpotLight]] = None,
    environment: Optional[EnvironmentLightDesc] = None,
) -> LightBank:
    directional = directional or []
    point = point or []
    spot = spot or []
    if (len(directional) > MAX_DIRECTIONAL_LIGHTS or len(point) > MAX_POINT_LIGHTS
            or len(spot) > MAX_SPOT_LIGHTS):
        raise ValueError("at most 5 lights of each punctual kind")

    dd = np.zeros((MAX_DIRECTIONAL_LIGHTS, 3), np.float32)
    dc = np.zeros((MAX_DIRECTIONAL_LIGHTS, 3), np.float32)
    for i, light in enumerate(directional):
        d = np.asarray(light.direction, np.float32)
        dd[i] = d / max(np.linalg.norm(d), 1e-20)
        dc[i] = light.radiometric_color()

    pp = np.zeros((MAX_POINT_LIGHTS, 3), np.float32)
    pc = np.zeros((MAX_POINT_LIGHTS, 3), np.float32)
    for i, light in enumerate(point):
        pp[i] = light.position
        pc[i] = light.radiometric_color()

    sp = np.zeros((MAX_SPOT_LIGHTS, 3), np.float32)
    sd = np.zeros((MAX_SPOT_LIGHTS, 3), np.float32)
    sc = np.zeros((MAX_SPOT_LIGHTS, 3), np.float32)
    sa = np.ones((MAX_SPOT_LIGHTS, 2), np.float32)
    for i, light in enumerate(spot):
        sp[i] = light.position
        d = np.asarray(light.direction, np.float32)
        sd[i] = d / max(np.linalg.norm(d), 1e-20)
        sc[i] = light.radiometric_color()
        sa[i] = (math.cos(light.inner_angle), math.cos(light.outer_angle))

    if environment is not None:
        if environment.image is not None:
            # (H, W, 3) -> planar (3, H, W).
            env_map = np.ascontiguousarray(
                np.asarray(environment.image, np.float32).transpose(2, 0, 1))
        else:
            env_map = np.asarray(environment.solid_color, np.float32).reshape(3, 1, 1)
        env_enabled, env_comp, env_rot = 1, 2.0 ** environment.exposure, environment.rotation
    else:
        env_map = np.zeros((3, 1, 1), np.float32)
        env_enabled, env_comp, env_rot = 0, 1.0, 0.0

    t = torch.from_numpy
    return LightBank(
        num_directional=len(directional),
        dir_direction=t(dd),
        dir_color=t(dc),
        num_point=len(point),
        point_position=t(pp),
        point_color=t(pc),
        num_spot=len(spot),
        spot_position=t(sp),
        spot_direction=t(sd),
        spot_color=t(sc),
        spot_cos_angles=t(sa),
        env_enabled=env_enabled,
        env_map=t(env_map),
        env_exposure_compensation=float(np.float32(env_comp)),
        env_rotation=float(np.float32(env_rot)),
    )
