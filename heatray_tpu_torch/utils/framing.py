"""Camera auto-framing from the scene AABB (port of
``heatray_tpu.utils.framing``): orbit target = AABB centre, distance = 3x
the bounding radius, auto-focus at the target."""

from __future__ import annotations

import numpy as np

from ..camera import CameraParams, orbit_camera


def frame_scene(
    aabb: np.ndarray,
    width: int,
    height: int,
    phi: float = 0.0,
    theta: float = 0.0,
    focal_length_mm: float = 50.0,
    aperture_radius: float = 0.0,
) -> CameraParams:
    """Auto-framed orbit camera for a scene with (2, 3) min/max ``aabb``."""
    aabb = np.asarray(aabb, np.float64)
    center = 0.5 * (aabb[0] + aabb[1])
    radius = float(np.linalg.norm(aabb[1] - aabb[0]) * 0.5)
    distance = radius * 3.0
    return orbit_camera(
        width,
        height,
        distance=distance,
        phi=phi,
        theta=theta,
        target=tuple(center),
        focal_length_mm=focal_length_mm,
        focus_distance=distance,
        aperture_radius=aperture_radius,
    )
