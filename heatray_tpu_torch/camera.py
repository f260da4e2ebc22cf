"""Cameras: the orbit parameterization and the thin-lens camera parameters
(port of ``heatray_tpu.camera``).  The view matrix is camera-to-world."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

# 35mm film dimensions, ``PassGenerator.cpp:341``.
SENSOR_HEIGHT_MM = 24.0


def fov_y_from_focal_length(focal_length_mm: float) -> float:
    """``fovY = 2 atan2(24, 2 f)`` (``PassGenerator.cpp:342-343``)."""
    return 2.0 * math.atan2(SENSOR_HEIGHT_MM, 2.0 * focal_length_mm)


def _quat_mul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ]
    )


def _quat_angle_axis(angle, axis):
    s = math.sin(angle * 0.5)
    return np.array([math.cos(angle * 0.5), axis[0] * s, axis[1] * s, axis[2] * s])


def _quat_to_mat3(q):
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def orbit_view_matrix(distance, phi=0.0, theta=0.0, target=(0.0, 0.0, 0.0)) -> np.ndarray:
    """Camera-to-world matrix of an orbit camera (``OrbitCamera.h:32-45``:
    ``mat4(inverse(rotTheta * rotPhi)) * translate(target + (0, 0, d))``)."""
    orientation = _quat_mul(
        _quat_angle_axis(theta, (1.0, 0.0, 0.0)), _quat_angle_axis(phi, (0.0, 1.0, 0.0))
    )
    rot = _quat_to_mat3(orientation * np.array([1.0, -1.0, -1.0, -1.0]))
    trans = np.eye(4, dtype=np.float64)
    trans[:3, 3] = np.asarray(target) + np.array([0.0, 0.0, distance])
    m = np.eye(4, dtype=np.float64)
    m[:3, :3] = rot
    return (m @ trans).astype(np.float32)


@dataclasses.dataclass
class OrbitCamera:
    """Orbital camera controller on the host (``OrbitCamera.h``)."""

    distance: float = 19.0
    phi: float = 0.0  # [0, 2pi], about +Y
    theta: float = 0.0  # [-pi/2, pi/2], about +X
    target: tuple = (0.0, 0.0, 0.0)
    max_distance: float = 100.0

    def view_matrix(self) -> np.ndarray:
        """Camera-to-world matrix (``orbit_view_matrix``)."""
        return orbit_view_matrix(self.distance, self.phi, self.theta, self.target)


def orbit_view_matrix_torch(distance, phi, theta, target=(0.0, 0.0, 0.0)) -> torch.Tensor:
    """``orbit_view_matrix`` on tensors, for camera optimization (the twin of
    ``heatray_tpu.camera.orbit_view_matrix_jnp``): gradients flow to
    ``distance``, ``phi``, ``theta`` and ``target``.  Returns a (4, 4)
    float32 camera-to-world matrix on the device of ``distance``."""
    distance = torch.as_tensor(distance, dtype=torch.float32)
    dev = distance.device
    phi, theta, target = (torch.as_tensor(v, dtype=torch.float32, device=dev)
                          for v in (phi, theta, target))
    ct, st = torch.cos(theta * 0.5), torch.sin(theta * 0.5)
    cp, sp = torch.cos(phi * 0.5), torch.sin(phi * 0.5)
    # q = rotTheta(x) * rotPhi(y); its inverse is the conjugate.
    w, x, y, z = ct * cp, -(st * cp), -(ct * sp), -(st * sp)
    rot = torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)]),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)]),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]),
    ])
    trans = target + torch.tensor([0.0, 0.0, 1.0], device=dev) * distance
    # rot @ translate: the translation column is rot @ trans.
    top = torch.cat([rot, (rot @ trans)[:, None]], dim=1)
    return torch.cat([top, torch.tensor([[0.0, 0.0, 0.0, 1.0]], device=dev)])


@dataclasses.dataclass
class CameraParams:
    """Camera parameters of the ray generator: a (4, 4) camera-to-world
    matrix and float32 scalars."""

    view_matrix: torch.Tensor
    fov_tan: torch.Tensor
    aspect: torch.Tensor
    focus_distance: torch.Tensor
    aperture_radius: torch.Tensor

    def to(self, device) -> "CameraParams":
        return CameraParams(
            **{f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)}
        )


def make_camera(
    view_matrix: np.ndarray,
    width: int,
    height: int,
    focal_length_mm: float = 50.0,
    focus_distance: float = 1.0,
    aperture_radius: float = 0.0,
) -> CameraParams:
    fov_y = fov_y_from_focal_length(focal_length_mm)

    def f32(v):
        return torch.tensor(v, dtype=torch.float32)

    return CameraParams(
        view_matrix=torch.as_tensor(np.asarray(view_matrix, np.float32)),
        fov_tan=f32(math.tan(fov_y * 0.5)),
        aspect=f32(width / height),
        focus_distance=f32(focus_distance),
        aperture_radius=f32(aperture_radius),
    )


def orbit_camera(
    width: int,
    height: int,
    distance: float = 5.0,
    phi: float = 0.0,
    theta: float = 0.0,
    target=(0.0, 0.0, 0.0),
    focal_length_mm: float = 50.0,
    focus_distance: float | None = None,
    aperture_radius: float = 0.0,
) -> CameraParams:
    """Orbit parameters -> CameraParams, focused at the orbit target by
    default (``HeatrayRenderer.cpp:126``)."""
    return make_camera(
        orbit_view_matrix(distance, phi, theta, target),
        width,
        height,
        focal_length_mm=focal_length_mm,
        focus_distance=distance if focus_distance is None else focus_distance,
        aperture_radius=aperture_radius,
    )
