"""Inverse rendering: optimize scene parameters against target images (port
of ``heatray_tpu.diff.inverse``).

The pass is differentiable with autograd (see
``render.integrator``), so material, light, environment and camera
parameters take gradients through the whole estimator and optimize with a
``torch.optim`` optimizer.  Material parameters need a context whose pass
builds its own shading table: ``make_context(options, scene,
static_shading=False)``, or the rebuild mode (a context without a scene).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from ..camera import CameraParams, orbit_view_matrix_torch
from ..options import FrameGlobals, RenderOptions
from ..render.integrator import RenderContext, render_pass
from ..scene.scene import Scene
from ..vec import clip

Params = Dict[str, torch.Tensor]


def apply_material_params(scene: Scene, params: Params) -> Scene:
    """Overlay a dict of ``MaterialTable`` field tensors onto the scene.

    Derived fields stay consistent: roughness is clamped and re-squared into
    roughness_alpha (matching ``PhysicallyBasedMaterial::modify``).  The
    clamps are ``vec.clip``: under autograd ``torch.minimum(torch.maximum(x,
    lo), hi)``, whose gradient is half at a bound, as ``jnp.clip``'s is (the
    Cornell box's roughness is exactly 1.0 and its metallic 0.0 on most
    materials); ``torch.clamp`` would pass all of it.
    """
    updates = {}
    for key, value in params.items():
        if key in ("roughness", "clearcoat_roughness"):
            rough = clip(torch.as_tensor(value), 0.01, 1.0)
            updates[key] = rough
            updates[key + "_alpha"] = rough * rough
        elif key in ("base_color", "emissive", "metallic"):
            updates[key] = clip(torch.as_tensor(value), 0.0, 1.0)
        else:
            updates[key] = value
    return dataclasses.replace(scene, materials=dataclasses.replace(scene.materials, **updates))


def apply_light_params(scene: Scene, params: Params) -> Scene:
    """Overlay ``light.*`` / ``env.*`` keys onto the scene's LightBank.

    Light keys map to LightBank fields (``light.point_color``,
    ``light.point_position``, ``light.dir_direction`` (re-normalized),
    ``light.spot_color``, ...); env keys: ``env.exposure`` (EV ->
    compensation 2^ev), ``env.solid_color`` ((3,) -> 1x1 map),
    ``env.rotation``, ``env.map`` ((3, H, W)).
    """
    updates = {}
    for key, value in params.items():
        if not key.startswith(("light.", "env.")):
            continue
        value = torch.as_tensor(value)
        if key == "env.exposure":
            updates["env_exposure_compensation"] = 2.0 ** value
        elif key == "env.solid_color":
            updates["env_map"] = value.reshape(3, 1, 1)
        elif key == "env.map":
            updates["env_map"] = value
        elif key == "env.rotation":
            updates["env_rotation"] = value
        elif key == "light.dir_direction":
            updates["dir_direction"] = value / clip(
                torch.linalg.vector_norm(value, dim=-1, keepdim=True), 1e-12)
        else:
            updates[key.split(".", 1)[1]] = value
    if not updates:
        return scene
    return dataclasses.replace(scene, lights=dataclasses.replace(scene.lights, **updates))


def apply_camera_params(camera: CameraParams, params: Params) -> CameraParams:
    """Overlay ``camera.*`` keys onto CameraParams.

    ``camera.orbit`` = (distance, phi, theta) rebuilds the view matrix
    differentiably (``orbit_view_matrix_torch``, about
    ``camera.orbit_target``, default the origin); scalar keys:
    ``camera.focus_distance``, ``camera.aperture_radius``,
    ``camera.fov_tan``; ``camera.view_matrix`` overrides the matrix raw.
    """
    updates = {}
    for key, value in params.items():
        if not key.startswith("camera."):
            continue
        field = key.split(".", 1)[1]
        if field == "orbit":
            target = params.get("camera.orbit_target",
                                torch.zeros(3, device=torch.as_tensor(value).device))
            updates["view_matrix"] = orbit_view_matrix_torch(value[0], value[1], value[2], target)
        elif field != "orbit_target":  # consumed by camera.orbit
            updates[field] = torch.as_tensor(value)
    return dataclasses.replace(camera, **updates) if updates else camera


def apply_scene_params(scene: Scene, params: Params) -> Scene:
    """Materials (bare keys, ``apply_material_params``) + lights/env
    (namespaced keys, ``apply_light_params``) in one overlay."""
    mat = {k: v for k, v in params.items() if "." not in k}
    scene = apply_material_params(scene, mat) if mat else scene
    return apply_light_params(scene, params)


def make_loss_fn(
    scene: Scene,
    camera: CameraParams,
    ctx: RenderContext,
    options: RenderOptions,
    target,
    num_passes: int = 1,
    apply_params: Callable[[Scene, Params], Scene] = apply_scene_params,
):
    """L2 image loss of a ``num_passes``-pass render against ``target``
    ((H, W, 3) linear), on the context's device.  Parameters may target
    materials (bare keys), lights/env (``light.*``/``env.*``) and the
    camera (``camera.*``).  Returns ``loss_fn(params, sample_offset=0)``,
    a 0-d tensor to call ``backward()`` on."""
    device = ctx.device
    scene, camera = scene.to(device), camera.to(device)
    target_planar = torch.as_tensor(target, dtype=torch.float32).to(device).permute(2, 0, 1)

    def _check_params(params):
        # A baked shade table freezes material parameters: optimizing them
        # through it would silently produce zero gradients.
        if (
            any("." not in k for k in params)
            and ctx.accel_pack is not None
            and ctx.accel_pack.shade_table is not None
        ):
            raise ValueError(
                "material parameters need a context built with "
                "make_context(options, scene, static_shading=False)"
            )

    def loss_fn(params: Params, sample_offset: int = 0) -> torch.Tensor:
        _check_params(params)
        s = apply_params(scene, params)
        cam = apply_camera_params(camera, params)
        accum = torch.zeros((4, options.height, options.width), dtype=torch.float32,
                            device=device)
        for i in range(num_passes):
            frame = FrameGlobals.create(sample_offset + i, device=device)
            accum = render_pass(s, cam, ctx, options, frame, accum)
        img = accum[:3] / torch.clamp(accum[3:], min=1.0)
        return torch.mean((img - target_planar) ** 2)

    return loss_fn


def optimize(
    scene: Scene,
    camera: CameraParams,
    ctx: RenderContext,
    options: RenderOptions,
    target,
    init_params: Params,
    steps: int = 100,
    learning_rate: float = 5e-2,
    num_passes: int = 1,
    optimizer: Callable[[list], torch.optim.Optimizer] | None = None,
    rotate_samples: bool = True,
    callback: Callable[[int, float, Params], None] | None = None,
):
    """Gradient-descend scene parameters toward a target image.

    ``optimizer`` maps the list of parameter tensors to a
    ``torch.optim.Optimizer`` (default ``torch.optim.Adam`` at
    ``learning_rate``).  Returns (params, losses): detached tensors and
    each step's loss before its update.  ``rotate_samples`` advances the
    QMC pass window each step so gradients see fresh sample sets (forward
    and backward share one stream within a step; discrete choices carry no
    gradient).
    """
    params = {k: torch.as_tensor(v, dtype=torch.float32).to(ctx.device).detach().clone()
              .requires_grad_(True) for k, v in init_params.items()}
    if optimizer is None:
        def optimizer(tensors):
            return torch.optim.Adam(tensors, lr=learning_rate)
    opt = optimizer(list(params.values()))
    loss_fn = make_loss_fn(scene, camera, ctx, options, target, num_passes=num_passes)
    losses = []
    for i in range(steps):
        offset = (i * num_passes) % options.max_render_passes if rotate_samples else 0
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params, offset)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if callback is not None:
            callback(i, losses[-1], params)
    return {k: v.detach() for k, v in params.items()}, losses
