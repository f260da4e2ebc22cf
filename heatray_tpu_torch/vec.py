"""Planar 3-vectors: three separate tensors of one shape.

Every per-ray quantity of the renderer is a flat ``(R,)`` tensor or a
``Vec3`` of them, as in ``heatray_tpu.vec``, so that BRDF formulas written for
scalars (Schlick, Smith) apply unchanged to colors and the public functions
keep the JAX package's layout.  Every operation is differentiable; ``clip``
takes the place of ``torch.clamp`` where a gradient may reach a bound, so that
the gradients there are the JAX package's (see ``clip``).
"""

from __future__ import annotations

import dataclasses

import torch


def clip(x: torch.Tensor, lo: float | None = None, hi: float | None = None) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)``, also in its gradient: where ``x`` sits
    exactly on a bound, ``jnp.clip`` (``jnp.maximum``/``jnp.minimum``) passes
    half of the gradient and ``torch.clamp`` all of it.  A bound of 1.0 is
    common (a roughness of 1, a saturated cosine), so under autograd this is
    ``torch.minimum(torch.maximum(x, lo), hi)``, which splits ties as JAX
    does; without autograd, the one ``torch.clamp`` of the same values."""
    if not (x.requires_grad and torch.is_grad_enabled()):
        return torch.clamp(x, lo, hi)
    if lo is not None:
        x = torch.maximum(x, torch.full((), lo, dtype=x.dtype, device=x.device))
    if hi is not None:
        x = torch.minimum(x, torch.full((), hi, dtype=x.dtype, device=x.device))
    return x


@dataclasses.dataclass
class Vec3:
    """Three planar components (identically shaped float tensors)."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    # --- construction -----------------------------------------------------
    @staticmethod
    def zeros(shape, device=None) -> "Vec3":
        z = torch.zeros(shape, dtype=torch.float32, device=device)
        return Vec3(z, z, z)

    @staticmethod
    def ones(shape, device=None) -> "Vec3":
        o = torch.ones(shape, dtype=torch.float32, device=device)
        return Vec3(o, o, o)

    @staticmethod
    def splat(s) -> "Vec3":
        return Vec3(s, s, s)

    @staticmethod
    def from_planar(arr) -> "Vec3":
        """(3, ...) planar tensor -> Vec3 (views)."""
        return Vec3(arr[0], arr[1], arr[2])

    def to_planar(self) -> torch.Tensor:
        return torch.stack([self.x, self.y, self.z], dim=0)

    # --- arithmetic (elementwise; scalars broadcast per component) ---------
    @staticmethod
    def _coerce(other) -> "Vec3":
        if isinstance(other, Vec3):
            return other
        return Vec3(other, other, other)

    def __add__(self, o):
        o = self._coerce(o)
        return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)

    __radd__ = __add__

    def __sub__(self, o):
        o = self._coerce(o)
        return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __rsub__(self, o):
        o = self._coerce(o)
        return Vec3(o.x - self.x, o.y - self.y, o.z - self.z)

    def __mul__(self, o):
        o = self._coerce(o)
        return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)

    __rmul__ = __mul__

    def __truediv__(self, o):
        o = self._coerce(o)
        return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)

    # --- geometry -----------------------------------------------------------
    def dot(self, o: "Vec3"):
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "Vec3") -> "Vec3":
        return Vec3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def length_sq(self):
        return self.dot(self)

    def norm(self, eps=1e-24):
        return torch.sqrt(clip(self.length_sq(), eps))

    def normalized(self, eps=1e-12) -> "Vec3":
        """``rsqrt(len_sq + eps)`` scaling, the JAX package's additive
        softening (see ``heatray_tpu.vec.Vec3.normalized``)."""
        return self * torch.rsqrt(self.length_sq() + eps)

    # --- elementwise helpers ------------------------------------------------
    def exp(self) -> "Vec3":
        return Vec3(torch.exp(self.x), torch.exp(self.y), torch.exp(self.z))

    def minimum(self, o) -> "Vec3":
        o = self._coerce(o)
        return Vec3(
            torch.minimum(self.x, torch.as_tensor(o.x, device=self.x.device)),
            torch.minimum(self.y, torch.as_tensor(o.y, device=self.y.device)),
            torch.minimum(self.z, torch.as_tensor(o.z, device=self.z.device)),
        )

    def max_component(self):
        return torch.maximum(torch.maximum(self.x, self.y), self.z)

    def map(self, fn) -> "Vec3":
        return Vec3(fn(self.x), fn(self.y), fn(self.z))

    @property
    def shape(self):
        return self.x.shape

    # --- selection -----------------------------------------------------------
    @staticmethod
    def where(mask, a, b) -> "Vec3":
        """Per-lane select; ``a``/``b`` are Vec3 or scalars."""
        a = Vec3._coerce(a)
        b = Vec3._coerce(b)
        return Vec3(
            torch.where(mask, a.x, b.x),
            torch.where(mask, a.y, b.y),
            torch.where(mask, a.z, b.z),
        )
