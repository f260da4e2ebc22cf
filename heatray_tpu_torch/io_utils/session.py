"""Session files: the settings checkpoint and the render-state checkpoint
(port of ``heatray_tpu.io_utils.session``).

A JSON form of the original renderer's tinyxml2 Session system
(``Source/HeatrayRenderer/Session/Session.{h,cpp}``): the same variable
groups (RenderOptions / Camera / Scene / PostProcessing) and the same ~45
variables (``Session.h:20-75``), as a declarative table.  A session file
written by either package loads in the other.

``save_render_state`` / ``load_render_state`` also checkpoint the
accumulation buffer (planar (4, H, W), as ``render`` returns it in both
packages) and the next pass index, so a progressive render resumes exactly,
in either package.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional, Tuple

import numpy as np

SAMPLE_MODES = ["random", "halton", "hammersley", "bluenoise", "sobol"]
BOKEH_SHAPES = ["circular", "pentagon", "hexagon", "octagon"]

# The session variable table (group, name, type, default), mirroring
# ``HEATRAY_SESSION_VARIABLES`` (``Session.h:20-75``).
SESSION_VARIABLES = [
    ("RenderOptions", "InteractiveMode", bool, False),
    ("RenderOptions", "MaxRenderPasses", int, 32),
    ("RenderOptions", "MaxChannelValue", float, 1.0),
    ("RenderOptions", "Scene", str, "multi-material"),
    ("RenderOptions", "MaxRayDepth", int, 10),
    ("RenderOptions", "SampleMode", int, 4),  # sobol
    ("RenderOptions", "BokehShape", int, 0),  # circular
    ("RenderOptions", "EnvironmentMap", str, ""),
    ("RenderOptions", "EnvironmentBuiltIn", bool, True),
    ("RenderOptions", "EnvironmentExposureCompensation", float, 0.0),
    ("RenderOptions", "EnvironmentThetaRotation", float, 0.0),
    ("RenderOptions", "EnvironmentMapSolidColorX", float, 0.5),
    ("RenderOptions", "EnvironmentMapSolidColorY", float, 0.5),
    ("RenderOptions", "EnvironmentMapSolidColorZ", float, 0.5),
    ("RenderOptions", "CameraAspectRatio", float, -1.0),
    ("RenderOptions", "CameraFocusDistance", float, 1.0),
    ("RenderOptions", "CameraFocalLength", float, 50.0),
    ("RenderOptions", "CameraApertureRadius", float, 0.0),
    ("RenderOptions", "CameraFStop", float, 0.0),
    ("Camera", "OrbitDistance", float, 10.0),
    ("Camera", "OrbitPhi", float, 0.0),
    ("Camera", "OrbitTheta", float, 0.0),
    ("Camera", "OrbitTargetX", float, 0.0),
    ("Camera", "OrbitTargetY", float, 0.0),
    ("Camera", "OrbitTargetZ", float, 0.0),
    ("Camera", "OrbitMaxDistance", float, 100.0),
    ("Scene", "Units", int, 0),
    ("Scene", "AABB_MinX", float, 0.0),
    ("Scene", "AABB_MinY", float, 0.0),
    ("Scene", "AABB_MinZ", float, 0.0),
    ("Scene", "AABB_MaxX", float, 0.0),
    ("Scene", "AABB_MaxY", float, 0.0),
    ("Scene", "AABB_MaxZ", float, 0.0),
    ("Scene", "DistanceScale", float, 1.0),
    ("Scene", "RotationYaw", float, 0.0),
    ("Scene", "RotationPitch", float, 0.0),
    ("Scene", "RotationRoll", float, 0.0),
    ("Scene", "Scale", float, 1.0),
    ("PostProcessing", "TonemapEnable", bool, False),
    ("PostProcessing", "Exposure", float, 0.0),
    ("PostProcessing", "Brightness", float, 0.0),
    ("PostProcessing", "Contrast", float, 1.0),
    ("PostProcessing", "Hue", float, 1.0),
    ("PostProcessing", "Saturation", float, 1.0),
    ("PostProcessing", "Vibrance", float, 0.0),
    ("PostProcessing", "Red", float, 1.0),
    ("PostProcessing", "Green", float, 1.0),
    ("PostProcessing", "Blue", float, 1.0),
    ("PostProcessing", "VignetteIntensity", float, 0.0),
    ("PostProcessing", "VignetteFalloff", float, 1.0),
]


class Session:
    """Typed grouped variable store, the analog of the reference Session."""

    def __init__(self, values: Optional[Dict[str, Dict[str, Any]]] = None):
        self.values: Dict[str, Dict[str, Any]] = {}
        for group, name, typ, default in SESSION_VARIABLES:
            self.values.setdefault(group, {})[name] = default
        if values:
            for group, entries in values.items():
                for name, value in entries.items():
                    self.set(group, name, value)

    def get(self, group: str, name: str):
        return self.values[group][name]

    def set(self, group: str, name: str, value):
        table = {(g, n): t for g, n, t, _ in SESSION_VARIABLES}
        typ = table.get((group, name))
        if typ is None:
            raise KeyError(f"unknown session variable {group}.{name}")
        self.values[group][name] = typ(value)

    # -- file IO ----------------------------------------------------------
    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.values, f, indent=2, sort_keys=True)

    @classmethod
    def parse(cls, path: str) -> "Session":
        with open(path) as f:
            return cls(json.load(f))

    # -- conversions ------------------------------------------------------
    def to_render_options(self, width: int, height: int):
        from ..options import RenderOptions

        ro = self.values["RenderOptions"]
        return RenderOptions(
            width=width,
            height=height,
            max_render_passes=int(ro["MaxRenderPasses"]),
            max_ray_depth=int(ro["MaxRayDepth"]),
            sample_mode=SAMPLE_MODES[int(ro["SampleMode"]) % len(SAMPLE_MODES)],
            bokeh_shape=BOKEH_SHAPES[int(ro["BokehShape"]) % len(BOKEH_SHAPES)],
        )

    def to_camera(self, width: int, height: int):
        from ..camera import make_camera, orbit_view_matrix

        ro = self.values["RenderOptions"]
        cam = self.values["Camera"]
        view = orbit_view_matrix(
            cam["OrbitDistance"], cam["OrbitPhi"], cam["OrbitTheta"],
            (cam["OrbitTargetX"], cam["OrbitTargetY"], cam["OrbitTargetZ"]),
        )
        aperture = ro["CameraApertureRadius"]
        if ro["CameraFStop"] > 0.0:
            aperture = (ro["CameraFocalLength"] / ro["CameraFStop"]) / 1000.0
        return make_camera(
            view, width, height,
            focal_length_mm=ro["CameraFocalLength"],
            focus_distance=ro["CameraFocusDistance"],
            aperture_radius=aperture,
        )

    def to_post_params(self):
        from ..post.pipeline import PostProcessingParams

        pp = self.values["PostProcessing"]
        return PostProcessingParams(
            tonemapping_enabled=bool(pp["TonemapEnable"]),
            exposure=pp["Exposure"], brightness=pp["Brightness"],
            contrast=pp["Contrast"], hue=pp["Hue"],
            saturation=pp["Saturation"], vibrance=pp["Vibrance"],
            red=pp["Red"], green=pp["Green"], blue=pp["Blue"],
            vignette_intensity=pp["VignetteIntensity"],
            vignette_falloff=pp["VignetteFalloff"],
        )


def load_session(path: str, override_size: Optional[Tuple[int, int]] = None):
    """Restore a full render setup from a session file.

    The analog of ``HeatrayRenderer::readSessionFile``
    (``HeatrayRenderer.cpp:584-688``): parses the variable table, rebuilds
    the scene named by ``RenderOptions.Scene`` (a built-in name or a model
    file path), wires the environment light (map path / solid color),
    applies the Scene group's rotation and scale (``scene.edit``), and
    reconstructs camera + options.  Returns ``(scene, camera, options)``,
    the scene and camera as CPU tensors.  As the JAX package does, a map
    named by ``EnvironmentMap`` is passed on as ``load_image`` returns it,
    bottom row first (ROADMAP F16).
    """
    from ..scene.builtin import BUILTIN_SCENES
    from ..scene.lights import EnvironmentLightDesc

    session = Session.parse(path)
    ro = session.values["RenderOptions"]
    width, height = override_size if override_size else (512, 512)

    env = None
    env_map = str(ro.get("EnvironmentMap", ""))
    if env_map:
        from .image import load_image

        env = EnvironmentLightDesc(
            image=load_image(env_map)[..., :3],
            exposure=float(ro["EnvironmentExposureCompensation"]),
            rotation=float(ro["EnvironmentThetaRotation"]),
        )
    elif bool(ro.get("EnvironmentBuiltIn", False)):
        env = EnvironmentLightDesc(
            exposure=float(ro["EnvironmentExposureCompensation"]),
            rotation=float(ro["EnvironmentThetaRotation"]),
        )
    else:
        env = EnvironmentLightDesc(
            solid_color=(
                float(ro["EnvironmentMapSolidColorX"]),
                float(ro["EnvironmentMapSolidColorY"]),
                float(ro["EnvironmentMapSolidColorZ"]),
            ),
            exposure=float(ro["EnvironmentExposureCompensation"]),
            rotation=float(ro["EnvironmentThetaRotation"]),
        )

    name = str(ro["Scene"])
    if name in BUILTIN_SCENES:
        builder = BUILTIN_SCENES[name]
        try:
            scene = builder(env=env)
        except TypeError:
            scene = builder()
    else:
        from ..scene.loaders import load_model_scene

        scene = load_model_scene(
            name, env=env, scale=float(session.get("Scene", "DistanceScale"))
        )

    # Scene-group transform variables (``Session.h:20-75`` RotationYaw/
    # Pitch/Roll/Scale), applied as the reference's modifyScene does
    # (``HeatrayRenderer.cpp:674-683``).
    sc = session.values["Scene"]
    yaw = float(sc.get("RotationYaw", 0.0))
    pitch = float(sc.get("RotationPitch", 0.0))
    roll = float(sc.get("RotationRoll", 0.0))
    uniform = float(sc.get("Scale", 1.0))
    if (yaw, pitch, roll) != (0.0, 0.0, 0.0) or uniform != 1.0:
        from ..scene.edit import apply_transform, trs_matrix

        scene = apply_transform(
            scene, trs_matrix(yaw=yaw, pitch=pitch, roll=roll, scale=uniform)
        )

    options = session.to_render_options(width, height)
    camera = session.to_camera(width, height)
    return scene, camera, options


def save_render_state(path: str, accum, next_pass: int, session: Session) -> None:
    """Checkpoint settings, the accumulation buffer (a tensor on any device,
    or an array) and the next pass index (the original renderer checkpoints
    settings only)."""
    if hasattr(accum, "detach"):
        accum = accum.detach().cpu().numpy()
    np.savez_compressed(
        path,
        accum=np.asarray(accum),
        next_pass=np.int64(next_pass),
        session=json.dumps(session.values),
    )


def load_render_state(path: str) -> Tuple[np.ndarray, int, Session]:
    """(accumulation as a float32 array, next pass index, session)."""
    data = np.load(path, allow_pickle=False)
    session = Session(json.loads(str(data["session"])))
    return data["accum"], int(data["next_pass"]), session
