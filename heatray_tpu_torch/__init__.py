"""heatray_tpu_torch: the PyTorch and CUDA port of heatray_tpu.

A differentiable wavefront path tracer on PyTorch tensors: the forward render
(PBR and glass materials with their textures, punctual lights and lat/long
environment maps, the debug AOVs), the ACES display chain (``post``) and
its gradients through autograd (``diff.inverse``: the parameter
overlays, the image loss and the optimizer loop), with the traversal
kernels written in CUDA for Hopper: the wide BVH (``csrc/wide_bvh.cu``, and
``csrc/wide_bvh_stream.cu`` for scenes past 250,000 triangles;
``csrc/wide_bvh_t.cu`` for the transposed "vpu" leaf math of either), the
binary BVH (``csrc/bvh2.cu``) and the flat chunks of the rebuild mode
(``csrc/chunks.cu``); ``probes/`` holds the traversal
probes and their kernels (``csrc/probes.cu``, ``csrc/variants.cu``).
Scenes come from the built-ins (``BUILTIN_SCENES``), from model files
(``load_model_scene``: OBJ, PLY, STL, OFF, glTF/GLB, DAE, FBX) or from
session files (``io_utils.session``); ``scene.edit`` edits them,
``io_utils`` writes images (PNG, EXR, HDR) and ``cli`` drives it all from a
command line; ``interactive`` and ``viewer`` serve the live preview and its
edit loop over HTTP; ``parallel`` renders and trains over several ranks of a
``torch.distributed`` process group (pixel rows, sample slices) and holds
the ``"sharded"`` backend's forest of trees, one per rank.  The host side of
ingestion, the tree build, Morton order, vertex normals and the OBJ
tokenizer, runs in C++ (``native``, ``csrc/native.cpp``, built by g++ at
first use).  It imports torch and numpy, never jax.
"""

from .camera import CameraParams, orbit_camera
from .diff.inverse import (
    apply_camera_params,
    apply_light_params,
    apply_material_params,
    apply_scene_params,
    make_loss_fn,
    optimize,
)
from .options import AOV, FrameGlobals, RenderOptions
from .post import PostProcessingParams, apply_post_pipeline
from .render.integrator import make_context, render, render_pass, resolve
from .scene.builtin import (
    BUILTIN_SCENES,
    cornell_box,
    editable_glass,
    editable_pbr,
    high_poly,
    multi_material,
    sphere_array,
)
from .scene.environments import get_environment
from .scene.geometry import scene_aabb
from .scene.loaders import load_model_scene
from .utils.framing import frame_scene

__all__ = [
    "AOV",
    "BUILTIN_SCENES",
    "CameraParams",
    "FrameGlobals",
    "PostProcessingParams",
    "RenderOptions",
    "apply_camera_params",
    "apply_light_params",
    "apply_material_params",
    "apply_post_pipeline",
    "apply_scene_params",
    "cornell_box",
    "editable_glass",
    "editable_pbr",
    "frame_scene",
    "get_environment",
    "high_poly",
    "load_model_scene",
    "make_context",
    "make_loss_fn",
    "multi_material",
    "optimize",
    "orbit_camera",
    "render",
    "render_pass",
    "resolve",
    "scene_aabb",
    "sphere_array",
]
