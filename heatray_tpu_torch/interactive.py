"""The interactive edit loop (port of ``heatray_tpu.interactive``): the
headless analog of the reference's material, light and camera editors
(``HeatrayRenderer::renderUI``, ``HeatrayRenderer.cpp:690-946,948-1599``).

``InteractiveRenderer`` owns the progressive loop on one device.  Between
passes it drains the viewer's edit queue (HTTP ``POST /edit``), applies each
edit to its scene, camera, options or display settings, and, as the
reference's ``resetRenderer`` does (``HeatrayRenderer.cpp:1601-1608``),
restarts accumulation from pass 0 whenever an edit changes the light
transport.  Display (``post``) edits never reset.

Edit messages (JSON):
  {"type": "material", "index": 0, "base_color": [r,g,b], "roughness": r,
   "metallic": m, "emissive": [r,g,b], "specular_f0": s, "clearcoat": c,
   "clearcoat_roughness": r, "ior": x, "density": d}       (any subset)
  {"type": "directional_light" | "point_light" | "spot_light",
   "index": i, ...DirectionalLight/PointLight/SpotLight fields}
   (an index past the last light adds one; "remove": true removes it)
  {"type": "env", "exposure": ev, "rotation": rad, "solid_color": [r,g,b],
   "enabled": bool}
  {"type": "load", "path": file, "kind": "scene" | "env"}
  {"type": "camera", "distance": d, "phi": p, "theta": t, "fstop": f,
   "focal_length": mm, "focus_distance": m}
  {"type": "post", ...PostProcessingParams fields}
  {"type": "transform", "yaw": deg, "pitch": deg, "roll": deg, "scale": s}
  {"type": "options", ...RenderOptions fields, "max_channel_value": c}

A material edit bakes the shading table again in the id order of the
context's backend (slot order for the wide trees); a transform, a load or an
options edit builds a new context, its trees and their block boxes included.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch

from .camera import CameraParams, orbit_camera
from .options import AOV, FrameGlobals, RenderOptions
from .post import PostProcessingParams, apply_post_pipeline
from .render.integrator import RenderContext, _device, make_context, pass_pack, render_pass
from .render.shade_table import NUM_COLS
from .scene import edit as scene_edit
from .scene.lights import LUMENS_TO_WATTS, WATTS_TO_LUMENS, DirectionalLight, PointLight, SpotLight
from .scene.scene import Scene
from .utils.log import get_logger

_LIGHTS = {
    "directional_light": (DirectionalLight, "num_directional", scene_edit.update_directional_light,
                          scene_edit.add_directional_light, scene_edit.remove_directional_light),
    "point_light": (PointLight, "num_point", scene_edit.update_point_light,
                    scene_edit.add_point_light, scene_edit.remove_point_light),
    "spot_light": (SpotLight, "num_spot", scene_edit.update_spot_light,
                   scene_edit.add_spot_light, scene_edit.remove_spot_light),
}


def _cond_material(table, index: int, edit: dict):
    """A copy of material table ``table`` with the user-facing parameters of
    ``edit`` conditioned into material ``index``, as
    ``PhysicallyBasedMaterial.cpp:133-145`` does (roughness at least 0.01,
    F0 x0.08, clearcoat x0.2, alpha = roughness^2)."""
    out = {}

    def put(name, value, col=False):
        arr = out.get(name, getattr(table, name)).clone()
        value = torch.as_tensor(value, dtype=arr.dtype, device=arr.device)
        if col:
            arr[:, index] = value
        else:
            arr[index] = value
        out[name] = arr

    if "base_color" in edit:
        put("base_color", edit["base_color"], col=True)
    if "emissive" in edit:
        put("emissive", edit["emissive"], col=True)
    if "metallic" in edit:
        put("metallic", float(edit["metallic"]))
    if "roughness" in edit:
        r = max(float(edit["roughness"]), 0.01)
        put("roughness", r)
        put("roughness_alpha", r * r)
    if "specular_f0" in edit:
        put("specular_f0", 0.08 * float(edit["specular_f0"]))
    if "clearcoat" in edit:
        put("clearcoat", 0.2 * float(edit["clearcoat"]))
    if "clearcoat_roughness" in edit:
        r = max(float(edit["clearcoat_roughness"]), 0.01)
        put("clearcoat_roughness", r)
        put("clearcoat_roughness_alpha", r * r)
    if "ior" in edit:
        put("ior", float(edit["ior"]))
    if "density" in edit:
        put("density", float(edit["density"]))
    return dataclasses.replace(table, **out)


def _light_from_edit(cls, current_kwargs: dict, edit: dict):
    """A ``cls`` light from ``current_kwargs`` with the fields ``edit`` names."""
    fields = {f.name for f in dataclasses.fields(cls)}
    kwargs = dict(current_kwargs)
    for k, v in edit.items():
        if k in fields:
            kwargs[k] = tuple(v) if isinstance(v, list) else v
    return cls(**kwargs)


def _bank_row_kwargs(kind: str, lights, idx: int) -> dict:
    """The constructor arguments of light ``idx`` of ``kind``, recovered
    from its light bank row, so that a partial edit keeps the light's other
    parameters (the reference edits the stored parameters in place,
    ``HeatrayRenderer.cpp:875-946``).

    The bank stores the radiometric colour, colour x intensity scale; it is
    split with max(colour) == 1, which gives back exactly a light made with
    a normalised colour and keeps the product of untouched fields either
    way."""

    def row(arr):
        return arr[idx].detach().cpu().numpy()

    def decompose(rad, to_intensity):
        rad = np.asarray(rad, np.float64)
        peak = float(rad.max())
        if peak <= 0.0:
            return (0.0, 0.0, 0.0), 0.0
        return tuple((rad / peak).tolist()), to_intensity(peak)

    if kind == "directional_light":
        color, lux = decompose(row(lights.dir_color), lambda w: w * WATTS_TO_LUMENS)
        return {"direction": tuple(row(lights.dir_direction).tolist()), "color": color,
                "illuminance": lux}
    if kind == "point_light":
        color, lm = decompose(row(lights.point_color),
                              lambda w: w / (LUMENS_TO_WATTS * 4.0 * math.pi))
        return {"position": tuple(row(lights.point_position).tolist()), "color": color,
                "luminous_intensity": lm}
    if kind == "spot_light":
        color, lm = decompose(row(lights.spot_color), lambda w: w / (LUMENS_TO_WATTS * math.pi))
        cos_in, cos_out = row(lights.spot_cos_angles).tolist()
        return {
            "position": tuple(row(lights.spot_position).tolist()),
            "direction": tuple(row(lights.spot_direction).tolist()),
            "color": color,
            "inner_angle": math.acos(float(np.clip(cos_in, -1.0, 1.0))),
            "outer_angle": math.acos(float(np.clip(cos_out, -1.0, 1.0))),
            "luminous_intensity": lm,
        }
    raise ValueError(kind)


def display_rgb8(img: torch.Tensor) -> np.ndarray:
    """(H, W, 3) display image in [0, 1], row 0 the image bottom ->
    (H, W, 3) uint8, top row first, rounded on the image's device and
    copied to the host once."""
    return (img.flip(0) * 255.0 + 0.5).to(torch.uint8).cpu().numpy()


class InteractiveRenderer:
    """Progressive renderer and edit loop (the ``HeatrayRenderer``
    orchestrator) on ``device``: the card unless the caller names another."""

    def __init__(
        self,
        scene: Scene,
        camera: CameraParams,
        options: RenderOptions,
        post: Optional[PostProcessingParams] = None,
        viewer=None,
        orbit: Optional[dict] = None,
        max_channel_value: float = 3.14159265,
        device="cuda",
    ):
        self.device = _device(device)
        self.scene = scene.to(self.device)
        self.camera = camera.to(self.device)
        self.options = options
        self.post = post or PostProcessingParams()
        self.viewer = viewer
        # Orbit state for camera edits (the UI's orbit parameters).
        self.orbit = dict(
            distance=6.0, phi=0.0, theta=0.3, focal_length=50.0,
            fstop=0.0, focus_distance=None, target=(0.0, 0.0, 0.0),
        )
        if orbit:
            self.orbit.update(orbit)
        self.max_channel_value = max_channel_value
        self.ctx: RenderContext = make_context(options, self.scene, self.device)
        self.accum = self._zeros()
        self.pass_index = 0

    def _zeros(self) -> torch.Tensor:
        return torch.zeros((4, self.options.height, self.options.width), dtype=torch.float32,
                           device=self.device)

    def scene_info(self) -> dict:
        """The editable surface served at /scene.json (what the reference's
        material and light editor panels show)."""
        m = self.scene.materials
        lights = self.scene.lights
        return {
            "materials": [
                {
                    "index": i,
                    "kind": "glass" if int(m.kind[i]) else "pbr",
                    "base_color": m.base_color[:, i].tolist(),
                    "roughness": float(m.roughness[i]),
                    "metallic": float(m.metallic[i]),
                }
                for i in range(m.num_materials)
            ],
            "lights": {
                "directional": int(lights.num_directional),
                "point": int(lights.num_point),
                "spot": int(lights.num_spot),
                "environment": bool(int(lights.env_enabled)),
            },
            "camera": dict(self.orbit),
            "options": {
                "width": self.options.width,
                "height": self.options.height,
                "max_ray_depth": self.options.max_ray_depth,
                "max_render_passes": self.options.max_render_passes,
            },
        }

    # -- resetRenderer (``HeatrayRenderer.cpp:1601-1608``) ------------------
    def reset(self):
        self.accum = torch.zeros_like(self.accum)
        self.pass_index = 0

    def _rebuild_shade_table(self):
        """Bake the scene's materials into the shading table again, in the
        id order of the context's backend (``pass_pack``: slot order for
        the wide trees)."""
        pack = self.ctx.accel_pack
        if pack is not None and pack.shade_table is not None:
            pack = pass_pack(self.scene, dataclasses.replace(pack, shade_table=None),
                             with_tail=pack.shade_table.shape[1] == NUM_COLS)
            self.ctx = dataclasses.replace(self.ctx, accel_pack=pack)

    def _rebuild_camera(self):
        o = self.orbit
        aperture = 0.0
        if o["fstop"] and o["fstop"] > 0.0:
            aperture = (o["focal_length"] / o["fstop"]) / 1000.0
        self.camera = orbit_camera(
            self.options.width, self.options.height,
            distance=o["distance"], phi=o["phi"], theta=o["theta"],
            target=tuple(o.get("target", (0.0, 0.0, 0.0))),
            focal_length_mm=o["focal_length"],
            focus_distance=o["focus_distance"],
            aperture_radius=aperture,
        ).to(self.device)

    def _set_lights(self, **fields):
        self.scene = dataclasses.replace(
            self.scene, lights=dataclasses.replace(self.scene.lights, **fields))

    def apply_edit(self, edit: dict) -> bool:
        """Apply one edit message; returns True if accumulation must reset."""
        kind = edit.get("type")
        if kind == "material":
            self.scene = dataclasses.replace(self.scene, materials=_cond_material(
                self.scene.materials, int(edit.get("index", 0)), edit))
            self._rebuild_shade_table()
            return True
        if kind in _LIGHTS:
            idx = int(edit.get("index", 0))
            cls, count, update, add, remove = _LIGHTS[kind]
            n = getattr(self.scene.lights, count)
            if edit.get("remove"):
                self.scene = remove(self.scene, idx)
                return True
            # Unspecified fields come from the light's current bank row (a
            # new light starts from the class defaults): a partial edit must
            # not reset its position or intensity.
            current = _bank_row_kwargs(kind, self.scene.lights, idx) if 0 <= idx < n else {}
            light = _light_from_edit(cls, current, edit)
            self.scene = add(self.scene, light) if idx >= n else update(self.scene, idx, light)
            return True
        if kind == "env":
            fields = {}
            if "exposure" in edit:
                fields["env_exposure_compensation"] = 2.0 ** float(edit["exposure"])
            if "rotation" in edit:
                fields["env_rotation"] = float(edit["rotation"])
            if "solid_color" in edit:
                fields["env_map"] = torch.tensor(edit["solid_color"], dtype=torch.float32,
                                                 device=self.device).reshape(3, 1, 1)
            if "enabled" in edit:
                fields["env_enabled"] = 1 if edit["enabled"] else 0
            self._set_lights(**fields)
            return True
        if kind == "load":
            self._load(str(edit["path"]), edit.get("kind"))
            return True
        if kind == "camera":
            for k in ("distance", "phi", "theta", "fstop", "focal_length", "focus_distance"):
                if k in edit:
                    self.orbit[k] = float(edit[k]) if edit[k] is not None else None
            self._rebuild_camera()
            return True
        if kind == "post":
            fields = {f.name for f in dataclasses.fields(PostProcessingParams)}
            self.post = dataclasses.replace(self.post, **{
                k: (tuple(v) if isinstance(v, list) else v)
                for k, v in edit.items() if k in fields
            })
            return False  # display-side only: no reset
        if kind == "transform":
            m = scene_edit.trs_matrix(
                yaw=np.radians(float(edit.get("yaw", 0.0))),
                pitch=np.radians(float(edit.get("pitch", 0.0))),
                roll=np.radians(float(edit.get("roll", 0.0))),
                scale=float(edit.get("scale", 1.0)),
            )
            self.scene = scene_edit.apply_transform(self.scene, m)
            # The geometry moved: new trees, block boxes included.
            self.ctx = make_context(self.options, self.scene, self.device)
            return True
        if kind == "options":
            # The options panel (``HeatrayRenderer.cpp:948-1599``): any
            # RenderOptions field, and the firefly clamp (a per-pass value).
            if "max_channel_value" in edit:
                self.max_channel_value = float(edit["max_channel_value"])
            fields = {f.name for f in dataclasses.fields(RenderOptions)}
            updates = {k: v for k, v in edit.items() if k in fields}
            if "aov" in updates:
                updates["aov"] = AOV(updates["aov"])
            if updates:
                self.options = dataclasses.replace(self.options, **updates)
                self.ctx = make_context(self.options, self.scene, self.device)
                self.accum = self._zeros()
            return True
        return False

    def _load(self, path: str, what: Optional[str]):
        """Load a dropped scene or environment file (``main.cpp:58``,
        ``HeatrayRenderer::changeScene/changeEnvironment``)."""
        what = what or ("env" if path.lower().endswith((".hdr", ".exr")) else "scene")
        if what == "env":
            from .io_utils.image import load_image

            # EnvironmentLightDesc convention: top row first.
            img = np.ascontiguousarray(load_image(path)[::-1].transpose(2, 0, 1))
            self._set_lights(env_map=torch.from_numpy(img.astype(np.float32)).to(self.device),
                             env_enabled=1)
            return
        from .scene.geometry import scene_aabb
        from .scene.loaders import load_model_scene

        new_scene = load_model_scene(path).to(self.device)
        cur = self.scene.lights
        if not new_scene.lights.env_enabled and cur.env_enabled:
            # A scene change keeps the current environment (``changeScene``
            # swaps only geometry and materials).
            new_scene = dataclasses.replace(new_scene, lights=dataclasses.replace(
                new_scene.lights, env_enabled=cur.env_enabled, env_map=cur.env_map,
                env_exposure_compensation=cur.env_exposure_compensation,
                env_rotation=cur.env_rotation))
        self.scene = new_scene
        # Frame the orbit camera on the new scene's box
        # (``HeatrayRenderer.cpp:288-296,300-310``).
        aabb = scene_aabb(self.scene.geometry)
        center = 0.5 * (aabb[0] + aabb[1])
        radius = float(np.linalg.norm(aabb[1] - aabb[0]) * 0.5)
        self.orbit["target"] = tuple(center.tolist())
        self.orbit["distance"] = max(radius * 3.0, 1e-3)
        self.orbit["focus_distance"] = self.orbit["distance"]
        self._rebuild_camera()
        self.ctx = make_context(self.options, self.scene, self.device)

    def poll_and_apply(self) -> int:
        """Drain the viewer's edit queue; returns the number of edits.  An
        edit that fails is logged and skipped: it must not end the loop."""
        if self.viewer is None:
            return 0
        edits = self.viewer.poll_edits()
        need_reset = False
        for e in edits:
            try:
                need_reset |= self.apply_edit(e)
            except Exception:
                get_logger("interactive").exception("edit failed: %r", e)
        if need_reset:
            self.reset()
        return len(edits)

    def step(self):
        """Render one progressive pass (one block pass with
        ``interactive_block``)."""
        frame = FrameGlobals.create(self.pass_index, self.max_channel_value, self.device)
        with torch.no_grad():
            self.accum = render_pass(self.scene, self.camera, self.ctx, self.options, frame,
                                     self.accum)
        self.pass_index += 1

    def frame_rgb8(self) -> np.ndarray:
        """The display image of the accumulation: (H, W, 3) uint8, top row
        first, made on the device and copied to the host once."""
        with torch.no_grad():
            return display_rgb8(apply_post_pipeline(self.accum, self.post).clamp(0.0, 1.0))

    def publish(self):
        if self.viewer is None:
            return
        self.viewer.update(self.frame_rgb8(), self.pass_index, self.options.max_render_passes)

    def run(self, max_passes: Optional[int] = None, publish_every: int = 1):
        """The main loop: render until ``max_passes`` passes (None: serve
        until interrupted, idling once the budget is spent, as the
        reference's vsync loop does)."""
        try:
            while True:
                budget = max_passes if max_passes is not None else self.options.max_render_passes
                if self.pass_index < budget:
                    self.step()
                    if self.pass_index % publish_every == 0 or self.pass_index == budget:
                        self.publish()
                else:
                    if max_passes is not None:
                        break
                    time.sleep(0.05)  # converged: idle until an edit arrives
                if self.poll_and_apply():
                    self.publish()
        except KeyboardInterrupt:
            pass
        return self.accum
