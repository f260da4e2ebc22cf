"""Next-event-estimation light selection (port of
``heatray_tpu.render.light_sampling``, after ``lightSampling.rlsl:11-161``).

Every light slot gets an importance per shading point; importances
normalize into a CDF that the ray's light-select random walks, and the
environment is the fall-through.  Slot-major ``(S, R)`` matrices, as in the
JAX package; the chosen slot's row is gathered.
"""

from __future__ import annotations

import dataclasses

import torch

from ..scene.lights import (
    LIGHT_TYPE_DIRECTIONAL,
    LIGHT_TYPE_ENVIRONMENT,
    LIGHT_TYPE_POINT,
    LIGHT_TYPE_SPOT,
    MAX_DIRECTIONAL_LIGHTS,
    MAX_POINT_LIGHTS,
    MAX_SPOT_LIGHTS,
    LightBank,
)
from ..vec import Vec3, clip
from .onb import greater_than_zero, saturate

_ND = MAX_DIRECTIONAL_LIGHTS
_NP = MAX_POINT_LIGHTS
_NS = MAX_SPOT_LIGHTS


def glsl_smoothstep(edge0, edge1, x):
    """GLSL smoothstep, as drivers compute it even for edge0 > edge1."""
    e = edge1 - edge0
    t = clip(
        (x - edge0) / torch.where(torch.abs(e) > 1e-12, e, 1e-12), 0.0, 1.0
    )
    return t * t * (3.0 - 2.0 * t)


@dataclasses.dataclass
class LightSample:
    """Per-ray light selection ((R,) tensors / Vec3s)."""

    light_type: torch.Tensor  # i32 LIGHT_TYPE_*
    direction: Vec3  # toward the light
    probability: torch.Tensor  # selection probability of the chosen light
    max_distance: torch.Tensor  # shadow-ray maxT (3e38 for directional/env)
    radiance: Vec3  # radiance along the shadow ray, attenuation included


def _lum_rows(colors):
    return colors[:, 0] * 0.33 + colors[:, 1] * 0.59 + colors[:, 2] * 0.11


def _active(n_slots: int, count: int, device):
    return (torch.arange(n_slots, device=device) < count)[:, None]


def compute_light_sample(lights: LightBank, n: Vec3, p: Vec3, u: torch.Tensor) -> LightSample:
    """Select one light per ray: ``n`` shading normal, ``p`` shading point,
    ``u`` (R,) selection random."""
    dev = n.x.device
    inf = 3.0e38
    nx, ny, nz = n.x[None], n.y[None], n.z[None]
    px, py, pz = p.x[None], p.y[None], p.z[None]

    dd = lights.dir_direction
    ndl_d = dd[:, 0:1] * nx + dd[:, 1:2] * ny + dd[:, 2:3] * nz
    w_dir = saturate(ndl_d) * _lum_rows(lights.dir_color)[:, None]
    w_dir = torch.where(_active(_ND, lights.num_directional, dev), w_dir, 0.0)

    pp = lights.point_position
    tpx, tpy, tpz = pp[:, 0:1] - px, pp[:, 1:2] - py, pp[:, 2:3] - pz
    point_dist = torch.sqrt(tpx * tpx + tpy * tpy + tpz * tpz)
    inv_pd = 1.0 / greater_than_zero(point_dist)
    pdx, pdy, pdz = tpx * inv_pd, tpy * inv_pd, tpz * inv_pd
    ndl_p = pdx * nx + pdy * ny + pdz * nz
    w_point = saturate(ndl_p) * _lum_rows(lights.point_color)[:, None]
    w_point = torch.where(_active(_NP, lights.num_point, dev), w_point, 0.0)

    sp, sd = lights.spot_position, lights.spot_direction
    tsx, tsy, tsz = sp[:, 0:1] - px, sp[:, 1:2] - py, sp[:, 2:3] - pz
    spot_dist = torch.sqrt(tsx * tsx + tsy * tsy + tsz * tsz)
    inv_sd = 1.0 / greater_than_zero(spot_dist)
    sdx, sdy, sdz = tsx * inv_sd, tsy * inv_sd, tsz * inv_sd
    # Cone terms (``lightSampling.rlsl:60-65``): emission direction against
    # light -> surface.
    ray_angle = -(sd[:, 0:1] * sdx + sd[:, 1:2] * sdy + sd[:, 2:3] * sdz)
    inner = lights.spot_cos_angles[:, 0:1]
    outer = lights.spot_cos_angles[:, 1:2]
    vis = torch.where(ray_angle > 0.0, 1.0, 0.0) * torch.where(ray_angle < outer, 0.0, 1.0)
    spot_fall = 1.0 - glsl_smoothstep(inner, outer, ray_angle)
    ndl_s = sdx * nx + sdy * ny + sdz * nz
    w_spot = saturate(ndl_s) * _lum_rows(lights.spot_color)[:, None] * (vis * spot_fall)
    w_spot = torch.where(_active(_NS, lights.num_spot, dev), w_spot, 0.0)

    # Environment importance: ``50 * exposureCompensation``.
    w_env = 50.0 * lights.env_exposure_compensation if lights.env_enabled else 0.0

    w_all = torch.cat([w_dir, w_point, w_spot], dim=0)  # (S, R)
    norm = 1.0 / greater_than_zero(torch.sum(w_all, dim=0) + w_env)
    probs = w_all * norm[None]
    env_prob = w_env * norm

    # First slot with prob > 0 and u <= cdf; none -> environment.
    eligible = (u[None] <= torch.cumsum(probs, dim=0)) & (probs > 0.0)
    any_punctual = torch.any(eligible, dim=0)
    slot = torch.argmax(eligible.to(torch.uint8), dim=0)[None]

    def pick(rows):
        return torch.gather(rows, 0, slot)[0]

    def broadcast(col):
        return col[:, None].expand(-1, u.shape[0])

    inv_pd2 = 1.0 / greater_than_zero(point_dist * point_dist)
    spot_att = (
        torch.where(ray_angle >= 0.0, 1.0, 0.0)
        * spot_fall
        / greater_than_zero(spot_dist * spot_dist)
    )
    sel_dir = [
        pick(torch.cat([broadcast(dd[:, k]), pd, sdk], dim=0))
        for k, pd, sdk in ((0, pdx, sdx), (1, pdy, sdy), (2, pdz, sdz))
    ]
    sel_dist = pick(
        torch.cat([torch.full_like(point_dist, inf), point_dist, spot_dist], dim=0)
    )
    sel_rad = [
        pick(
            torch.cat(
                [
                    broadcast(lights.dir_color[:, ch]),
                    lights.point_color[:, ch : ch + 1] * inv_pd2,
                    lights.spot_color[:, ch : ch + 1] * spot_att,
                ],
                dim=0,
            )
        )
        for ch in range(3)
    ]
    sel_type = torch.where(
        slot[0] < _ND,
        LIGHT_TYPE_DIRECTIONAL,
        torch.where(slot[0] < _ND + _NP, LIGHT_TYPE_POINT, LIGHT_TYPE_SPOT),
    )
    return LightSample(
        light_type=torch.where(any_punctual, sel_type, LIGHT_TYPE_ENVIRONMENT).to(torch.int32),
        direction=Vec3.where(any_punctual, Vec3(*sel_dir), 0.0),
        probability=torch.where(any_punctual, pick(probs), env_prob),
        max_distance=torch.where(any_punctual, sel_dist, inf),
        radiance=Vec3.where(any_punctual, Vec3(*sel_rad), 0.0),
    )
