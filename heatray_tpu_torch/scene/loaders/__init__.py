"""Model loaders (OBJ/MTL, glTF/GLB, COLLADA, FBX, PLY, STL, OFF) with the
original renderer's material mapping (port of
``heatray_tpu.scene.loaders``)."""

import os

from .collada import load_dae
from .fbx import load_fbx
from .gltf import load_gltf
from .mesh_formats import load_off, load_ply, load_stl
from .obj import load_obj

_LOADERS = {".obj": load_obj, ".ply": load_ply, ".stl": load_stl, ".off": load_off,
            ".dae": load_dae}


def load_model_scene(path: str, env=None, scale: float = 1.0):
    """Load a model file into a Scene of CPU tensors (the analog of
    ``Scene::loadFromDisk``): its meshes with their materials, a glTF's
    textures in the scene's atlas and its ``KHR_lights_punctual`` lights,
    and the environment ``env``."""
    from ..lights import DirectionalLight, PointLight, SpotLight
    from ..scene import SceneBuilder

    b = SceneBuilder()
    lights = []
    suffix = os.path.splitext(path)[1]
    if suffix in (".gltf", ".glb"):
        meshes, materials, lights = load_gltf(path, scale=scale, texture_sink=b.textures)
    elif suffix.lower() == ".fbx":
        meshes, materials = load_fbx(path, scale=scale)
    elif suffix in _LOADERS:
        meshes, materials = _LOADERS[suffix](path, scale=scale)
    else:
        raise ValueError(f"unsupported model format: {path}")
    for mesh, mat in zip(meshes, materials):
        b.add_mesh(mesh, mat)
    add = {DirectionalLight: b.add_directional_light, PointLight: b.add_point_light,
           SpotLight: b.add_spot_light}
    for light in lights:
        add[type(light)](light)
    b.set_environment(env)
    return b.build()


__all__ = ["load_dae", "load_fbx", "load_gltf", "load_model_scene", "load_obj", "load_off",
           "load_ply", "load_stl"]
