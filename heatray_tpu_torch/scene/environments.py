"""Built-in lat/long environment maps (a numpy copy of
``heatray_tpu.scene.environments``): procedural generators standing in for
the reference's binary maps under ``Resources/Environments/``
(``EnvironmentLight.cpp:36``).  Each returns a linear (H, W, 3) float32
lat/long image, top row = +Y pole, made on the host; nothing is read or
downloaded.  ``night``'s star hash is numpy ``uint32`` arithmetic and stays
on the host (torch has no uint32 shifts).
"""

from __future__ import annotations

import math

import numpy as np


def _latlong_dirs(height: int, width: int):
    """Unit direction per texel of a lat-long map (top row = +Y)."""
    v = (np.arange(height, dtype=np.float32) + 0.5) / height  # 0 top
    u = (np.arange(width, dtype=np.float32) + 0.5) / width
    theta = v * math.pi  # polar from +Y
    phi = u * 2.0 * math.pi - math.pi
    st = np.sin(theta)[:, None]
    y = np.cos(theta)[:, None] * np.ones((1, width), np.float32)
    x = st * np.sin(phi)[None, :]
    z = st * -np.cos(phi)[None, :]
    return x, y, z


def _soft_box(x, y, z, center, half_angle, edge):
    """Smooth rectangular-ish highlight around a direction (a softbox)."""
    c = np.asarray(center, np.float32)
    c /= np.linalg.norm(c)
    d = x * c[0] + y * c[1] + z * c[2]
    t = (d - math.cos(half_angle)) / max(edge, 1e-4)
    return np.clip(t, 0.0, 1.0) ** 2


def studio(height: int = 256, width: int = 512) -> np.ndarray:
    """A neutral photo-studio lat-long map: graded grey dome, bright soft
    key/fill/rim boxes, and a dark floor.  Average radiance ~0.5 to match
    the reference's deliberate solid-color default
    (``EnvironmentLight.cpp:52-53``)."""
    x, y, z = _latlong_dirs(height, width)
    # Base dome: horizon 0.35 -> zenith 0.65; floor falls to 0.08.
    up = np.clip(y, 0.0, 1.0)
    down = np.clip(-y, 0.0, 1.0)
    base = 0.35 + 0.3 * up - 0.27 * down
    img = np.repeat(base[..., None], 3, axis=-1).astype(np.float32)
    # Key (warm, high left), fill (cool, right), rim (behind).
    key = _soft_box(x, y, z, (-0.5, 0.7, -0.4), 0.35, 0.1)
    fill = _soft_box(x, y, z, (0.7, 0.4, -0.3), 0.45, 0.15)
    rim = _soft_box(x, y, z, (0.1, 0.5, 0.85), 0.25, 0.08)
    img += key[..., None] * np.array([6.0, 5.6, 5.0], np.float32)
    img += fill[..., None] * np.array([1.6, 1.8, 2.2], np.float32)
    img += rim[..., None] * np.array([3.0, 3.0, 3.2], np.float32)
    return img.astype(np.float32)


def sunset(height: int = 256, width: int = 512) -> np.ndarray:
    """A warm gradient sky with a low sun disc (for DoF/glass demos)."""
    x, y, z = _latlong_dirs(height, width)
    up = np.clip(y, 0.0, 1.0)
    down = np.clip(-y, 0.0, 1.0)
    sky = (
        np.array([0.9, 0.5, 0.3], np.float32)[None, None] * (1.0 - up[..., None])
        + np.array([0.2, 0.35, 0.6], np.float32)[None, None] * up[..., None]
    )
    sky *= (1.0 - 0.9 * down[..., None]).astype(np.float32)
    sun = _soft_box(x, y, z, (0.3, 0.08, -0.95), 0.03, 0.01)
    sky += sun[..., None] * np.array([400.0, 280.0, 160.0], np.float32)
    return sky.astype(np.float32)


def daylight(height: int = 256, width: int = 512) -> np.ndarray:
    """Clear midday sky: Rayleigh-ish blue gradient (brighter toward the
    horizon), circumsolar glow + sun disc, warm horizon haze, and a dim
    ground bounce — the all-purpose outdoor IBL."""
    x, y, z = _latlong_dirs(height, width)
    up = np.clip(y, 0.0, 1.0)
    down = np.clip(-y, 0.0, 1.0)
    # Zenith deep blue -> horizon pale blue (1/(cos+k) haze ramp).
    haze = 1.0 / (up + 0.25)
    zen = np.array([0.18, 0.34, 0.85], np.float32)
    hor = np.array([0.65, 0.78, 0.95], np.float32)
    w = np.clip((haze - 0.8) / 3.2, 0.0, 1.0)[..., None]
    sky = zen[None, None] * (1.0 - w) + hor[None, None] * w
    sun_dir = (0.45, 0.65, -0.6)
    glow = _soft_box(x, y, z, sun_dir, 0.35, 0.5)
    disc = _soft_box(x, y, z, sun_dir, 0.018, 0.004)
    sky = sky + glow[..., None] * np.array([1.2, 1.1, 0.8], np.float32)
    sky = sky + disc[..., None] * np.array([900.0, 850.0, 700.0], np.float32)
    ground = np.array([0.22, 0.2, 0.17], np.float32)
    sky = sky * (1.0 - down[..., None]) + ground[None, None] * down[..., None]
    return sky.astype(np.float32)


def night(height: int = 256, width: int = 512) -> np.ndarray:
    """Moonlit night: near-black blue dome, a cool moon disc, and a
    deterministic scatter of stars (hash-based, no RNG state)."""
    x, y, z = _latlong_dirs(height, width)
    up = np.clip(y, 0.0, 1.0)
    down = np.clip(-y, 0.0, 1.0)
    base = (
        np.array([0.004, 0.006, 0.014], np.float32)[None, None]
        * (0.4 + 0.6 * up[..., None])
    )
    base *= (1.0 - 0.95 * down[..., None]).astype(np.float32)
    moon = _soft_box(x, y, z, (-0.35, 0.55, -0.75), 0.025, 0.006)
    glow = _soft_box(x, y, z, (-0.35, 0.55, -0.75), 0.2, 0.4)
    img = base + glow[..., None] * np.array(
        [0.02, 0.025, 0.04], np.float32
    )
    img += moon[..., None] * np.array([18.0, 19.5, 22.0], np.float32)
    # Stars: FNV-style texel hash, thresholded, above the horizon only.
    yy, xx = np.meshgrid(
        np.arange(height, dtype=np.uint32),
        np.arange(width, dtype=np.uint32),
        indexing="ij",
    )
    h = (xx * np.uint32(374761393) + yy * np.uint32(668265263)) ^ np.uint32(
        0x9E3779B9
    )
    h = (h ^ (h >> np.uint32(13))) * np.uint32(1274126177)
    r01 = ((h >> np.uint32(8)) & np.uint32(0xFFFF)).astype(np.float32) / 65535.0
    stars = np.where(r01 > 0.9985, (r01 - 0.9985) / 0.0015, 0.0) ** 2
    img += (stars * (y > 0.05))[..., None] * np.array(
        [2.5, 2.5, 2.8], np.float32
    )
    return img.astype(np.float32)


BUILTIN_ENVIRONMENTS = {
    "studio": studio,
    "sunset": sunset,
    "daylight": daylight,
    "night": night,
}


def get_environment(name: str, height: int = 256, width: int = 512) -> np.ndarray:
    """Built-in lat/long map by name, generated anew on each call."""
    return BUILTIN_ENVIRONMENTS[name](height, width)
