"""Inverse rendering: gradients of image losses through the port's pass."""
