"""Render configuration (port of ``heatray_tpu.options``).

``RenderOptions`` keeps the JAX package's field names and defaults, and
every field the JAX package takes is ported.  Fields that only tune the
TPU kernels have no effect here and change nothing the port computes:
``wide_ray_tile`` and ``stream_ray_tile`` (each kernel fixes its own group
of rays: a thread or a warp), ``wide_precision`` (every kernel is exact
float32), ``pallas_ray_tile``, ``tri_chunk``, ``ray_block``, ``sort_impl``
and ``unroll_bounces``.
``remat_bounces`` changes only what a backward keeps: under autograd each
bounce's shading is recomputed in the backward instead of kept (values and
gradients are the same).  ``wide_leaf_math`` and ``stream_leaf_math`` ("mxu" or
"vpu") do choose the kernels (K1/K3 or K5/K4) and, for ``"wide"``, the leaf
size (rounded up to a multiple of 128), but every route runs the same exact
pair test; only a different leaf size, whose leaf anchors round otherwise,
can move a t by an ulp.  ``interactive_block`` traces one pixel of each
3x3 block a pass, block ``k % 9`` with sample index ``k // 9``
(``render.integrator.render_pass``); ``ms_impl`` "lut" reads the packed
multiscatter table instead of evaluating its fit (``render.multiscatter``).
``image_height`` is the full image's height when the options describe one
rank's rows of a row-sharded image (``parallel.sharding``), and
``intersect_backend="sharded"`` traverses a forest of wide trees, one per
rank (``parallel.geometry``).
"""

from __future__ import annotations

import dataclasses
import enum

import torch

from .ops.wide_bvh import LEAF_MATHS

# ``intersect_backend``: "xla" is the exact brute force over every triangle
# (``ops.intersect``, no kernel, as in the JAX package); "sharded" needs a
# context made with a mesh (``make_context(..., mesh=...)``).
BACKENDS = ("auto", "wide", "stream", "bvh", "pallas", "xla", "sharded")


class AOV(enum.Enum):
    """Debug visualization modes (``PassGenerator.h:123-141``)."""

    NONE = "none"
    GEOMETRIC_NORMALS = "geometric_normals"
    UVS = "uvs"
    TANGENTS = "tangents"
    BITANGENTS = "bitangents"
    # Raw normal-map texel (``physicallyBased.rlsl:175-176``); black where
    # the material has no normal map.
    NORMALMAP = "normalmap"
    FINAL_NORMALS = "final_normals"
    BASE_COLOR = "base_color"
    EMISSIVE = "emissive"
    ROUGHNESS = "roughness"
    METALLIC = "metallic"
    CLEARCOAT = "clearcoat"
    CLEARCOAT_ROUGHNESS = "clearcoat_roughness"
    # Raw clearcoat-normal-map texel (``physicallyBased.rlsl:198-199``).
    CLEARCOAT_NORMALMAP = "clearcoat_normalmap"
    SHADER = "shader"
    NANS = "nans"
    INFS = "infs"


@dataclasses.dataclass(frozen=True)
class RenderOptions:
    """Static render configuration; see ``heatray_tpu.options.RenderOptions``
    for what each field means."""

    width: int = 512
    height: int = 512
    image_height: int | None = None
    max_render_passes: int = 32
    max_ray_depth: int = 10
    interactive_block: bool = False
    sample_mode: str = "sobol"
    bokeh_shape: str = "circular"
    aov: AOV = AOV.NONE
    rr_start_depth: int = 3
    ray_epsilon: float = 1e-4
    tri_chunk: int = 512
    ray_block: int = 16384
    intersect_backend: str = "auto"
    pallas_ray_tile: int = 1024
    pallas_tri_chunk: int = 512
    bvh_leaf_size: int = 64
    wide_leaf_math: str = "mxu"
    wide_precision: str = "bf16x3"
    wide_leaf_size: int = 32
    wide_ray_tile: int = 512
    stream_leaf_size: int = 128
    stream_ray_tile: int = 256
    stream_leaf_math: str = "mxu"
    # The bounce sort and segment gating: True, False or "auto" (on where
    # the tree lies on a CUDA device, off on the CPU).  Sorting is an exact
    # permutation of the wavefront, so the image is the same either way.
    sort_bounces: bool | str = "auto"
    sort_impl: str = "auto"
    gate_bounces: bool | str = "auto"
    gate_segments: int = 8
    ms_impl: str = "fit"
    remat_bounces: bool = True
    unroll_bounces: bool = False
    use_mipmaps: bool = True
    debug_pass_rendering: bool = False
    debug_pass_index: int = 0

    def __post_init__(self):
        if self.max_ray_depth < 1 or self.max_render_passes < 1:
            raise ValueError("max_ray_depth and max_render_passes must be >= 1")
        for name in ("sort_bounces", "gate_bounces"):
            if getattr(self, name) not in (True, False, "auto"):
                raise ValueError(f"RenderOptions.{name} must be True, False or 'auto'")
        for name in ("wide_leaf_math", "stream_leaf_math"):
            if getattr(self, name) not in LEAF_MATHS:
                raise ValueError(f"RenderOptions.{name} must be one of {LEAF_MATHS}")
        if self.intersect_backend not in BACKENDS:
            raise ValueError(f"RenderOptions.intersect_backend must be one of {BACKENDS}")
        if self.ms_impl not in ("fit", "lut"):
            raise ValueError("RenderOptions.ms_impl must be 'fit' or 'lut'")
        if self.image_height is not None and self.image_height < self.height:
            raise ValueError("RenderOptions.image_height must be at least height")


@dataclasses.dataclass
class FrameGlobals:
    """Per-pass values: the sample index, the firefly clamp and the global
    row of the pass's row 0 (0 unless it renders one rank's rows of a
    row-sharded image)."""

    sample_index: int
    max_channel_value: torch.Tensor
    row_offset: int = 0

    @classmethod
    def create(cls, sample_index: int = 0, max_channel_value: float = 3.14159265,
               device=None, row_offset: int = 0):
        # Default clamp is pi (``PassGenerator.h:64``).
        return cls(
            sample_index=int(sample_index),
            max_channel_value=torch.tensor(
                max_channel_value, dtype=torch.float32, device=device
            ),
            row_offset=int(row_offset),
        )
