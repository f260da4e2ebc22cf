"""heatray_tpu_torch: the PyTorch and CUDA port of heatray_tpu.

A differentiable wavefront path tracer's forward render, on PyTorch tensors,
with the wide-BVH traversal kernels written in CUDA for Hopper
(``csrc/wide_bvh.cu``).  It imports torch and numpy, never jax.
"""

from .camera import CameraParams, orbit_camera
from .options import FrameGlobals, RenderOptions
from .render.integrator import make_context, render, render_pass, resolve
from .scene.builtin import cornell_box

__all__ = [
    "CameraParams",
    "FrameGlobals",
    "RenderOptions",
    "cornell_box",
    "make_context",
    "orbit_camera",
    "render",
    "render_pass",
    "resolve",
]
