"""Built-in scenes (port of ``heatray_tpu.scene.builtin``): the Cornell box,
the scene of ``bench.py`` and of the golden config2."""

from __future__ import annotations

import math

from .geometry import rotate, translate
from .lights import PointLight, SpotLight
from .materials import GlassParams, PBRParams
from .providers import plane_mesh, sphere_mesh
from .scene import Scene, SceneBuilder


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
