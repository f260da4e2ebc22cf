"""glTF 2.0 loader (.gltf / .glb) in Python and numpy (port of
``heatray_tpu.scene.loaders.gltf``).

Replaces the original renderer's Assimp glTF path with the same semantic mapping
(``AssimpMeshProvider.cpp:375-434``): KHR_materials_transmission / BLEND
alpha -> glass; pbrMetallicRoughness + KHR_materials_clearcoat -> PBR;
KHR_materials_emissive / emissiveFactor -> emission; doubleSided; punctual
lights via KHR_lights_punctual (``ProcessLight``, ``:528-662``).
"""

from __future__ import annotations

import base64
import json
import os
import struct
from typing import List

import numpy as np

from ..geometry import MeshData
from ..lights import DirectionalLight, PointLight, SpotLight
from ..materials import GlassParams, PBRParams

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNTS = {
    "SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16,
}


def _load_glb(path: str):
    with open(path, "rb") as f:
        magic, version, _length = struct.unpack("<III", f.read(12))
        if magic != 0x46546C67:
            raise ValueError(f"not a GLB file: {path}")
        gltf = None
        buffers = []
        while True:
            header = f.read(8)
            if len(header) < 8:
                break
            chunk_len, chunk_type = struct.unpack("<II", header)
            data = f.read(chunk_len)
            if chunk_type == 0x4E4F534A:  # JSON
                gltf = json.loads(data.decode("utf-8"))
            elif chunk_type == 0x004E4942:  # BIN
                buffers.append(data)
        return gltf, buffers


def _load_buffers(gltf: dict, base_dir: str, glb_buffers: List[bytes]):
    buffers = []
    for i, buf in enumerate(gltf.get("buffers", [])):
        uri = buf.get("uri")
        if uri is None:
            buffers.append(glb_buffers[i] if i < len(glb_buffers) else b"")
        elif uri.startswith("data:"):
            buffers.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            with open(os.path.join(base_dir, uri), "rb") as f:
                buffers.append(f.read())
    return buffers


def _read_accessor(gltf: dict, buffers: List[bytes], index: int) -> np.ndarray:
    acc = gltf["accessors"][index]
    view = gltf["bufferViews"][acc["bufferView"]]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    count = acc["count"]
    ncomp = _TYPE_COUNTS[acc["type"]]
    offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = view.get("byteStride") or dtype().itemsize * ncomp
    buf = buffers[view["buffer"]]
    itemsize = dtype().itemsize
    if stride == itemsize * ncomp:
        arr = np.frombuffer(
            buf, dtype=dtype, count=count * ncomp, offset=offset
        ).reshape(count, ncomp)
    else:
        arr = np.stack(
            [
                np.frombuffer(
                    buf, dtype=dtype, count=ncomp, offset=offset + i * stride
                )
                for i in range(count)
            ]
        )
    if acc.get("normalized") and dtype != np.float32:
        arr = arr.astype(np.float32) / np.iinfo(dtype).max
    return np.ascontiguousarray(arr)


def _decode_image(gltf: dict, buffers, base_dir: str, image_index: int):
    """Decode a glTF image (uri, data-uri, or bufferView) to an (H, W, C)
    uint8 or float array: PNG with the port's own codec, other formats
    (JPEG) through PIL."""
    import io

    img = gltf["images"][image_index]
    if "uri" in img:
        uri = img["uri"]
        if uri.startswith("data:"):
            data = base64.b64decode(uri.split(",", 1)[1])
        else:
            with open(os.path.join(base_dir, uri), "rb") as f:
                data = f.read()
    else:
        view = gltf["bufferViews"][img["bufferView"]]
        off = view.get("byteOffset", 0)
        data = buffers[view["buffer"]][off : off + view["byteLength"]]
    from ...io_utils.png import decode_png

    if data[:8] == b"\x89PNG\r\n\x1a\n":
        px = decode_png(data)
        # 16-bit samples as floats in [0, 1] (the atlas scales uint8 only).
        return px.astype(np.float32) / 65535.0 if px.dtype == np.uint16 else px
    try:
        from PIL import Image
    except ImportError as e:
        raise ValueError(f"glTF image {image_index} ({img.get('mimeType', 'not PNG')}) needs "
                         "PIL, which is not installed") from e
    return np.asarray(Image.open(io.BytesIO(data)))


def _texture_resolver(gltf: dict, buffers, base_dir: str, sink):
    """Returns ``resolve(texture_ref, srgb) -> atlas texture id`` loading
    images on demand into the scene's atlas (``sink``); -1 when absent."""

    def resolve(ref, srgb: bool) -> int:
        if sink is None or ref is None:
            return -1
        tex = gltf["textures"][ref["index"]]
        image_index = tex.get("source")
        if image_index is None:
            return -1
        key = ("gltf-image", image_index, srgb)
        if key in sink._keys:
            return sink._keys[key]
        return sink.add(
            _decode_image(gltf, buffers, base_dir, image_index),
            srgb=srgb,
            key=key,
        )

    return resolve


def _convert_material(mat: dict, resolve=lambda ref, srgb: -1):
    """glTF material -> framework material (reference classification,
    ``AssimpMeshProvider.cpp:375-434`` incl. the texture slots)."""
    name = mat.get("name", "material")
    ext = mat.get("extensions", {})
    pbr = mat.get("pbrMetallicRoughness", {})
    transmission = ext.get("KHR_materials_transmission", {}).get(
        "transmissionFactor", 0.0
    )
    # ``AssimpMeshProvider.cpp:380-389``: BLEND or transmission -> glass.
    if mat.get("alphaMode") == "BLEND" or transmission != 0.0:
        ior = ext.get("KHR_materials_ior", {}).get("ior", 1.5)
        base = pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0])
        return GlassParams(
            base_color=tuple(base[:3]),
            roughness=pbr.get("roughnessFactor", 0.0),
            ior=ior,
            density=0.0,
            base_color_tex=resolve(pbr.get("baseColorTexture"), True),
            metallic_roughness_tex=resolve(
                pbr.get("metallicRoughnessTexture"), False
            ),
            normal_tex=resolve(mat.get("normalTexture"), False),
            name=name,
        )
    cc = ext.get("KHR_materials_clearcoat", {})
    emissive = mat.get("emissiveFactor", [0.0, 0.0, 0.0])
    strength = ext.get("KHR_materials_emissive_strength", {}).get(
        "emissiveStrength", 1.0
    )
    base = pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0])
    return PBRParams(
        base_color=tuple(base[:3]),
        emissive=tuple(np.asarray(emissive) * strength),
        metallic=pbr.get("metallicFactor", 1.0),
        roughness=pbr.get("roughnessFactor", 1.0),
        specular_f0=0.5,
        clearcoat=cc.get("clearcoatFactor", 0.0),
        clearcoat_roughness=cc.get("clearcoatRoughnessFactor", 0.0),
        double_sided=mat.get("doubleSided", False),
        base_color_tex=resolve(pbr.get("baseColorTexture"), True),
        metallic_roughness_tex=resolve(
            pbr.get("metallicRoughnessTexture"), False
        ),
        emissive_tex=resolve(mat.get("emissiveTexture"), True),
        normal_tex=resolve(mat.get("normalTexture"), False),
        clearcoat_tex=resolve(cc.get("clearcoatTexture"), False),
        clearcoat_roughness_tex=resolve(
            cc.get("clearcoatRoughnessTexture"), False
        ),
        clearcoat_normal_tex=resolve(cc.get("clearcoatNormalTexture"), False),
        alpha_masked=mat.get("alphaMode") == "MASK",
        name=name,
    )


def _node_matrix(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float64).reshape(4, 4).T
    m = np.eye(4)
    if "scale" in node:
        m[:3, :3] *= np.asarray(node["scale"], np.float64)
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        rot = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            ]
        )
        m[:3, :3] = rot @ m[:3, :3]
    t = np.eye(4)
    if "translation" in node:
        t[:3, 3] = node["translation"]
    return t @ m


def load_gltf(path: str, scale: float = 1.0, texture_sink=None):
    """Load a glTF/GLB file.

    Returns (meshes, materials, lights) where ``lights`` is a list of
    DirectionalLight/PointLight/SpotLight (KHR_lights_punctual with the
    reference's photometric treatment: glTF intensities are lux / candela,
    which is what our light classes take).  ``texture_sink`` is the scene's
    ``AtlasBuilder``; textures are loaded into it and their ids wired into
    the material slots (skipped entirely when None).
    """
    base_dir = os.path.dirname(path)
    if path.endswith(".glb"):
        gltf, glb_buffers = _load_glb(path)
    else:
        with open(path) as f:
            gltf = json.load(f)
        glb_buffers = []
    buffers = _load_buffers(gltf, base_dir, glb_buffers)

    resolve = _texture_resolver(gltf, buffers, base_dir, texture_sink)
    materials = [
        _convert_material(m, resolve) for m in gltf.get("materials", [])
    ] or [PBRParams(name="default")]

    khr_lights = (
        gltf.get("extensions", {})
        .get("KHR_lights_punctual", {})
        .get("lights", [])
    )

    meshes: List[MeshData] = []
    mesh_materials: List[int] = []
    lights: List[object] = []

    def walk(node_index: int, parent: np.ndarray):
        node = gltf["nodes"][node_index]
        world = parent @ _node_matrix(node)
        if "mesh" in node:
            mesh = gltf["meshes"][node["mesh"]]
            for prim in mesh.get("primitives", []):
                if prim.get("mode", 4) != 4:  # triangles only
                    continue
                attrs = prim["attributes"]
                pos = _read_accessor(gltf, buffers, attrs["POSITION"]).astype(
                    np.float32
                )
                nrm = (
                    _read_accessor(gltf, buffers, attrs["NORMAL"]).astype(np.float32)
                    if "NORMAL" in attrs
                    else None
                )
                uv = (
                    _read_accessor(gltf, buffers, attrs["TEXCOORD_0"]).astype(
                        np.float32
                    )
                    if "TEXCOORD_0" in attrs
                    else None
                )
                col = (
                    _read_accessor(gltf, buffers, attrs["COLOR_0"]).astype(
                        np.float32
                    )[:, :3]
                    if "COLOR_0" in attrs
                    else None
                )
                tan = bitan = None
                if "TANGENT" in attrs and nrm is not None:
                    # glTF TANGENT is vec4; w is the bitangent handedness.
                    t4 = _read_accessor(gltf, buffers, attrs["TANGENT"]).astype(
                        np.float32
                    )
                    tan = t4[:, :3]
                    bitan = np.cross(nrm, tan) * t4[:, 3:4]
                if "indices" in prim:
                    idx = _read_accessor(gltf, buffers, prim["indices"])
                    idx = idx.reshape(-1, 3).astype(np.int32)
                else:
                    idx = np.arange(len(pos), dtype=np.int32).reshape(-1, 3)
                md = MeshData(
                    positions=pos * np.float32(scale),
                    indices=idx,
                    normals=nrm,
                    uvs=uv,
                    colors=col,
                    tangents=tan,
                    bitangents=bitan,
                    name=mesh.get("name", "mesh"),
                ).transformed(world.astype(np.float32) @ np.diag(
                    [1.0, 1.0, 1.0, 1.0]
                ).astype(np.float32))
                meshes.append(md)
                mesh_materials.append(prim.get("material", 0))
        light_ref = node.get("extensions", {}).get("KHR_lights_punctual", {})
        if "light" in light_ref:
            light = khr_lights[light_ref["light"]]
            color = tuple(light.get("color", [1.0, 1.0, 1.0]))
            intensity = light.get("intensity", 1.0)
            pos = (world @ np.array([0.0, 0.0, 0.0, 1.0]))[:3]
            direction = (world @ np.array([0.0, 0.0, -1.0, 0.0]))[:3]
            kind = light.get("type")
            if kind == "directional":
                lights.append(
                    DirectionalLight(
                        direction=tuple(-direction), color=color,
                        illuminance=intensity,
                        name=light.get("name", "directional"),
                    )
                )
            elif kind == "point":
                lights.append(
                    PointLight(
                        position=tuple(pos * scale), color=color,
                        luminous_intensity=intensity,
                        name=light.get("name", "point"),
                    )
                )
            elif kind == "spot":
                spot = light.get("spot", {})
                lights.append(
                    SpotLight(
                        position=tuple(pos * scale),
                        direction=tuple(direction),
                        color=color,
                        inner_angle=spot.get("innerConeAngle", 0.0),
                        outer_angle=spot.get("outerConeAngle", np.pi / 4),
                        luminous_intensity=intensity,
                        name=light.get("name", "spot"),
                    )
                )
        for child in node.get("children", []):
            walk(child, world)

    scene_index = gltf.get("scene", 0)
    scene_nodes = gltf.get("scenes", [{}])[scene_index].get("nodes", [])
    for n in scene_nodes:
        walk(n, np.eye(4))

    final_materials = materials
    return meshes, [final_materials[i] for i in mesh_materials], lights
