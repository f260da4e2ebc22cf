"""Built-in scenes (port of ``heatray_tpu.scene.builtin``): the reference's
"Editable PBR Material", "Editable Glass Material", "Multi-Material" and
"Sphere Array" (``HeatrayRenderer.cpp:115-298``), the Cornell box (the scene
of ``bench.py``'s first row and of the golden config2) and ``high_poly``
(its large-scene row)."""

from __future__ import annotations

import math

import numpy as np

from .geometry import MeshData, rotate, translate
from .lights import DirectionalLight, EnvironmentLightDesc, PointLight, SpotLight
from .materials import GlassParams, PBRParams
from .providers import plane_mesh, sphere_mesh
from .scene import Scene, SceneBuilder


def editable_pbr(env: EnvironmentLightDesc | None = None) -> Scene:
    """``HeatrayRenderer.cpp:123-138``."""
    b = SceneBuilder()
    b.add_mesh(
        sphere_mesh(50, 50, 1.0, "PBR Sphere"),
        PBRParams(
            base_color=(0.8, 0.8, 0.8), metallic=0.0, roughness=1.0,
            specular_f0=0.0, name="PBR",
        ),
    )
    b.set_environment(env or EnvironmentLightDesc())
    return b.build()


def editable_glass(env: EnvironmentLightDesc | None = None) -> Scene:
    """``HeatrayRenderer.cpp:139-153``."""
    b = SceneBuilder()
    b.add_mesh(
        sphere_mesh(50, 50, 1.0, "Glass Sphere"),
        GlassParams(
            base_color=(0.8, 0.8, 0.8), ior=1.33, roughness=0.0, density=0.8,
            name="Glass",
        ),
    )
    b.set_environment(env or EnvironmentLightDesc())
    return b.build()


def multi_material(env: EnvironmentLightDesc | None = None) -> Scene:
    """``HeatrayRenderer.cpp:154-243``: ground plane + metal and glass
    spheres."""
    b = SceneBuilder()
    b.add_mesh(
        plane_mesh(15, 15, "Plane"),
        PBRParams(base_color=(0.9, 0.9, 0.9), metallic=0.0, roughness=1.0,
                  specular_f0=0.0, name="Ground"),
        transform=translate([0.0, -1.5, 0.0]),
    )
    b.add_mesh(
        sphere_mesh(50, 50, 1.0, "Sphere"),
        PBRParams(base_color=(0.4, 0.4, 0.4), metallic=1.0, roughness=0.1,
                  specular_f0=0.3, name="PBR"),
        transform=translate([-0.9, -0.5, -0.8]),
    )
    b.add_mesh(
        sphere_mesh(50, 50, 1.0, "Sphere"),
        GlassParams(base_color=(0.9, 0.6, 0.6), roughness=0.1, ior=1.57,
                    density=0.5, name="Glass"),
        transform=translate([1.2, -0.5, 0.8]),
    )
    b.set_environment(env or EnvironmentLightDesc())
    return b.build()


def sphere_array(env: EnvironmentLightDesc | None = None) -> Scene:
    """``HeatrayRenderer.cpp:244-285``: 10 dielectric + 10 metal spheres with
    roughness ramps."""
    b = SceneBuilder()
    radius = 0.5
    padding = radius * 0.2
    sphere = sphere_mesh(50, 50, radius, "Sphere")
    for metallic, y in ((0.0, 0.0), (1.0, 1.5)):
        start_x = (-5.0 * (radius * 2.0 + padding)) + (radius * 2.0 + padding) * 0.5
        for i in range(10):
            b.add_mesh(
                sphere,
                PBRParams(
                    base_color=(1.0, 1.0, 1.0), metallic=metallic,
                    roughness=i * 0.1, specular_f0=0.0,
                ),
                transform=translate([start_x, y, 0.0]),
            )
            start_x += radius * 2.0 + padding
    b.set_environment(env or EnvironmentLightDesc())
    return b.build()


def cornell_box(light: str = "point", with_spheres: bool = True) -> Scene:
    """Cornell-box-style scene: colored walls, an NEE-lit interior and
    optional PBR and glass spheres.  ``light``: "point", "spot" or "both"."""
    b = SceneBuilder()
    white = PBRParams(base_color=(0.73, 0.73, 0.73), roughness=1.0, specular_f0=0.0)
    red = PBRParams(base_color=(0.65, 0.05, 0.05), roughness=1.0, specular_f0=0.0)
    green = PBRParams(base_color=(0.12, 0.45, 0.15), roughness=1.0, specular_f0=0.0)

    s = 2.0  # box half-size
    b.add_mesh(plane_mesh(2 * s, 2 * s), white, transform=translate([0, -s, 0]))
    b.add_mesh(
        plane_mesh(2 * s, 2 * s), white,
        transform=translate([0, s, 0]) @ rotate(math.pi, [1, 0, 0]),
    )
    b.add_mesh(
        plane_mesh(2 * s, 2 * s), white,
        transform=translate([0, 0, -s]) @ rotate(math.pi / 2, [1, 0, 0]),
    )
    b.add_mesh(
        plane_mesh(2 * s, 2 * s), red,
        transform=translate([-s, 0, 0]) @ rotate(-math.pi / 2, [0, 0, 1]),
    )
    b.add_mesh(
        plane_mesh(2 * s, 2 * s), green,
        transform=translate([s, 0, 0]) @ rotate(math.pi / 2, [0, 0, 1]),
    )
    if with_spheres:
        b.add_mesh(
            sphere_mesh(32, 32, 0.6),
            PBRParams(base_color=(0.9, 0.9, 0.9), metallic=0.9, roughness=0.2,
                      specular_f0=0.5),
            transform=translate([-0.8, -1.4, -0.7]),
        )
        b.add_mesh(
            sphere_mesh(32, 32, 0.6),
            GlassParams(base_color=(0.95, 0.95, 0.95), roughness=0.05,
                        ior=1.5, density=0.2),
            transform=translate([0.8, -1.4, 0.5]),
        )
    if light == "point":
        b.add_point_light(
            PointLight(position=(0.0, 1.7, 0.0), luminous_intensity=683.0 * 12.0)
        )
    elif light == "spot":
        b.add_spot_light(
            SpotLight(
                position=(0.0, 1.9, 0.0), direction=(0.0, -1.0, 0.0),
                inner_angle=math.radians(25.0), outer_angle=math.radians(50.0),
                luminous_intensity=683.0 * 25.0,
            )
        )
    elif light == "both":
        b.add_point_light(
            PointLight(position=(-0.6, 1.7, 0.4), luminous_intensity=683.0 * 8.0)
        )
        b.add_spot_light(
            SpotLight(
                position=(0.6, 1.9, -0.3), direction=(0.0, -1.0, 0.0),
                inner_angle=math.radians(25.0), outer_angle=math.radians(50.0),
                luminous_intensity=683.0 * 18.0,
            )
        )
    else:
        raise ValueError(f"unknown light setup {light!r}")
    return b.build()


def high_poly(env: EnvironmentLightDesc | None = None, triangles: int = 300_000) -> Scene:
    """Large scene: an FBM-displaced sphere ("boulder") of about
    ``triangles`` triangles over a ground plane, lit by a directional sun
    and a solid-colour environment.  The displacement is the JAX package's
    numpy float32 value noise with the same seed, so both packages build
    the same arrays."""
    # u x v lat/long grid -> 2 * u * (v + 1) triangles.
    u = max(int(math.sqrt(triangles / 2.0)), 8)
    v = max(triangles // (2 * u) - 1, 3)
    base = sphere_mesh(u, v, radius=1.0, name="boulder")

    # 3 octaves of trilinear-interpolated hash noise over the unit direction
    # -> radial displacement.
    rng = np.random.default_rng(1234)
    grids = [rng.random((8 << o,) * 3).astype(np.float32) for o in range(3)]
    p = base.positions / np.maximum(np.linalg.norm(base.positions, axis=1, keepdims=True), 1e-9)

    def value_noise(g, q):
        n = g.shape[0]
        x = (q * 0.5 + 0.5) * (n - 1)
        i = np.clip(x.astype(np.int64), 0, n - 2)
        f = x - i
        f = f * f * (3.0 - 2.0 * f)  # smoothstep
        acc = np.zeros(len(q), np.float32)
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    wgt = (
                        (f[:, 0] if dx else 1 - f[:, 0])
                        * (f[:, 1] if dy else 1 - f[:, 1])
                        * (f[:, 2] if dz else 1 - f[:, 2])
                    )
                    acc += wgt * g[i[:, 0] + dx, i[:, 1] + dy, i[:, 2] + dz]
        return acc

    disp = sum(value_noise(g, p) * (0.5 ** (o + 1)) for o, g in enumerate(grids))
    radius = 1.0 + 0.55 * (disp - 0.75)
    boulder = MeshData(positions=p * radius[:, None], indices=base.indices, name="boulder")

    b = SceneBuilder()
    b.add_mesh(boulder, PBRParams(base_color=(0.55, 0.5, 0.45), roughness=0.7, name="rock"))
    b.add_mesh(
        plane_mesh(20.0, 20.0).transformed(translate((0.0, -1.05, 0.0))),
        PBRParams(base_color=(0.35, 0.38, 0.35), roughness=0.9, name="ground"),
    )
    b.add_directional_light(
        DirectionalLight(direction=(0.4, 1.0, 0.3), illuminance=683.0 * math.pi * 2.0)
    )
    b.set_environment(env or EnvironmentLightDesc(solid_color=(0.4, 0.45, 0.55)))
    return b.build()


# The built-in scenes by the names ``cli`` and session files use (the JAX
# package's ``BUILTIN_SCENES``).
BUILTIN_SCENES = {
    "editable-pbr": editable_pbr,
    "editable-glass": editable_glass,
    "multi-material": multi_material,
    "sphere-array": sphere_array,
    "cornell-box": cornell_box,
    "high-poly": high_poly,
}
