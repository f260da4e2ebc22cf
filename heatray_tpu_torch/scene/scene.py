"""Scene assembly: the Scene container and its host-side builder (port of
``heatray_tpu.scene.scene``)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from .geometry import Geometry, MeshData, merge_meshes
from .lights import (
    DirectionalLight,
    EnvironmentLightDesc,
    LightBank,
    PointLight,
    SpotLight,
    build_light_bank,
)
from .materials import GlassParams, MaterialTable, PBRParams, build_material_table
from .textures import AtlasBuilder, TextureAtlas


def tensors_to(obj, device):
    """A copy of dataclass ``obj`` with every tensor field on ``device``."""
    return dataclasses.replace(
        obj,
        **{
            f.name: getattr(obj, f.name).to(device)
            for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), torch.Tensor)
        },
    )


@dataclasses.dataclass
class Scene:
    """A renderable scene.  ``has_alpha_mask``: alpha-masked geometry does
    not block shadow rays (``Mesh.cpp:95-100``), so the renderer builds a
    second, occluder-only tree.  ``has_textures``: the atlas holds textures,
    so the shading table carries the texture tail and shading samples it;
    without textures both are left out (``atlas`` is then a 1x1 dummy)."""

    geometry: Geometry
    materials: MaterialTable
    lights: LightBank
    has_alpha_mask: bool = False
    has_textures: bool = False
    atlas: TextureAtlas = dataclasses.field(default_factory=lambda: AtlasBuilder().build())

    def to(self, device) -> "Scene":
        return dataclasses.replace(
            self,
            geometry=tensors_to(self.geometry, device),
            materials=tensors_to(self.materials, device),
            lights=tensors_to(self.lights, device),
            atlas=tensors_to(self.atlas, device),
        )


class SceneBuilder:
    """Host-side accumulation of meshes, materials and lights (the analog of
    ``Scene::addMesh`` and the ``Lighting`` registry)."""

    def __init__(self):
        self._meshes: List[MeshData] = []
        self._mesh_material: List[int] = []
        self._materials: List = []
        self._directional: List[DirectionalLight] = []
        self._point: List[PointLight] = []
        self._spot: List[SpotLight] = []
        self._environment: Optional[EnvironmentLightDesc] = None
        self.textures = AtlasBuilder()

    def add_texture(self, image, srgb: bool = False, key=None) -> int:
        """Register a texture image (``AtlasBuilder.add``); returns its
        atlas texture id, for the texture slots of ``PBRParams`` and
        ``GlassParams``."""
        return self.textures.add(image, srgb=srgb, key=key)

    def add_material(self, material) -> int:
        if not isinstance(material, (PBRParams, GlassParams)):
            raise TypeError(f"unknown material type: {type(material)}")
        self._materials.append(material)
        return len(self._materials) - 1

    def add_mesh(self, mesh: MeshData, material, transform=None) -> "SceneBuilder":
        """Add a mesh with a material (instance or existing id) and an
        optional 4x4 transform."""
        mid = material if isinstance(material, int) else self.add_material(material)
        if transform is not None:
            mesh = mesh.transformed(transform)
        self._meshes.append(mesh)
        self._mesh_material.append(mid)
        return self

    def add_directional_light(self, light: DirectionalLight) -> "SceneBuilder":
        self._directional.append(light)
        return self

    def add_point_light(self, light: PointLight) -> "SceneBuilder":
        self._point.append(light)
        return self

    def add_spot_light(self, light: SpotLight) -> "SceneBuilder":
        self._spot.append(light)
        return self

    def set_environment(self, env: Optional[EnvironmentLightDesc]) -> "SceneBuilder":
        self._environment = env
        return self

    def build(self) -> Scene:
        """Merge everything into a Scene of CPU tensors (``Scene.to`` moves
        it)."""
        if not self._meshes:
            raise ValueError("scene has no geometry")
        materials = self._materials or [PBRParams()]
        return Scene(
            geometry=merge_meshes(self._meshes, self._mesh_material),
            materials=build_material_table(materials),
            lights=build_light_bank(
                directional=self._directional,
                point=self._point,
                spot=self._spot,
                environment=self._environment,
            ),
            has_alpha_mask=any(getattr(m, "alpha_masked", False) for m in materials),
            has_textures=self.textures.num_textures > 0,
            atlas=self.textures.build(),
        )
