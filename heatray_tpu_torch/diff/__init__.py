"""Inverse rendering: gradients of image losses through the port's pass."""

from .inverse import apply_material_params, make_loss_fn, optimize

__all__ = ["apply_material_params", "make_loss_fn", "optimize"]
