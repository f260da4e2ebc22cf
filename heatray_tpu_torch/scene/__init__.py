"""Scene model: flat geometry, the material table, the light bank, mesh
providers and the Scene builder (numpy on the host, tensors at the end)."""

from .geometry import (
    Geometry,
    MeshData,
    compute_vertex_normals,
    merge_meshes,
    rotate,
    scale,
    scene_aabb,
    translate,
)
from .lights import (
    LIGHT_TYPE_DIRECTIONAL,
    LIGHT_TYPE_ENVIRONMENT,
    LIGHT_TYPE_POINT,
    LIGHT_TYPE_SPOT,
    DirectionalLight,
    EnvironmentLightDesc,
    LightBank,
    PointLight,
    SpotLight,
    build_light_bank,
)
from .materials import (
    KIND_GLASS,
    KIND_PBR,
    GlassParams,
    MaterialTable,
    PBRParams,
    build_material_table,
)
from .providers import box_mesh, plane_mesh, sphere_mesh
from .scene import Scene, SceneBuilder

__all__ = [
    "Geometry",
    "MeshData",
    "compute_vertex_normals",
    "merge_meshes",
    "rotate",
    "scale",
    "scene_aabb",
    "translate",
    "DirectionalLight",
    "EnvironmentLightDesc",
    "LightBank",
    "PointLight",
    "SpotLight",
    "build_light_bank",
    "LIGHT_TYPE_DIRECTIONAL",
    "LIGHT_TYPE_ENVIRONMENT",
    "LIGHT_TYPE_POINT",
    "LIGHT_TYPE_SPOT",
    "KIND_GLASS",
    "KIND_PBR",
    "GlassParams",
    "MaterialTable",
    "PBRParams",
    "build_material_table",
    "box_mesh",
    "plane_mesh",
    "sphere_mesh",
    "Scene",
    "SceneBuilder",
]
