"""Write a scene's geometry, materials and punctual lights as model files
that ``scene.loaders`` reads back: binary PLY (positions and normals), OBJ
with one ``usemtl`` group per material and its MTL, and GLB (one primitive
per material, an optional embedded PNG base-colour texture on material 0,
``KHR_lights_punctual`` lights).  Positions and normals are written as the
scene holds them, so a loaded file's triangles equal the scene's."""

from __future__ import annotations

import json
import math
import os
import struct

import numpy as np

from .materials import KIND_GLASS, MAX_CLEARCOAT
from .scene import Scene


def _arrays(scene: Scene):
    """Host arrays: positions, normals, uvs (V, k), indices (T, 3) and
    material ids (T,)."""
    g = scene.geometry
    rows = (g.positions, g.normals, g.uvs, g.indices)
    return (*(np.ascontiguousarray(a.detach().cpu().numpy().T) for a in rows),
            g.material_ids.cpu().numpy())


def _materials(scene: Scene):
    """Each material of the table as a dict of host values."""
    t = scene.materials
    n = t.kind.shape[0]
    host = {f: getattr(t, f).detach().cpu().numpy() for f in (
        "kind", "base_color", "emissive", "metallic", "roughness", "clearcoat",
        "clearcoat_roughness", "ior", "density")}
    return [{k: (v[:, i] if v.ndim == 2 else v[i]).tolist() for k, v in host.items()}
            for i in range(n)]


def _used_ids(mids: np.ndarray):
    return [int(m) for m in np.unique(mids)]


def write_ply(path: str, scene: Scene) -> None:
    """Binary little-endian PLY of every vertex (position, normal) and
    triangle; no material (the loader gives a default one)."""
    pos, nrm, _, idx, _ = _arrays(scene)
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {len(pos)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property float nx\nproperty float ny\nproperty float nz\n"
        f"element face {len(idx)}\n"
        "property list uchar int vertex_indices\nend_header\n"
    ).encode()
    faces = np.empty(len(idx), np.dtype([("n", "u1"), ("v", "<i4", 3)]))
    faces["n"], faces["v"] = 3, idx
    with open(path, "wb") as f:
        f.write(header)
        f.write(np.concatenate([pos, nrm], axis=1).astype("<f4").tobytes())
        f.write(faces.tobytes())


def write_obj(path: str, scene: Scene) -> None:
    """OBJ (``v``/``vn``, one ``usemtl m<id>`` group per material in id
    order) and its MTL beside it (same name, ``.mtl``)."""
    pos, nrm, _, idx, mids = _arrays(scene)
    mtl_path = os.path.splitext(path)[0] + ".mtl"
    mats = _materials(scene)
    with open(mtl_path, "w") as f:
        for m in _used_ids(mids):
            p = mats[m]
            f.write(f"newmtl m{m}\n")
            if p["kind"] == KIND_GLASS:
                f.write("illum 7\nTf {!r} {!r} {!r}\n".format(*p["base_color"]))
                f.write(f"Pr {p['roughness']!r}\nNi {p['ior']!r}\nd {1.0 - p['density']!r}\n")
            else:
                f.write("Kd {!r} {!r} {!r}\nKe {!r} {!r} {!r}\n".format(
                    *p["base_color"], *p["emissive"]))
                f.write(f"Pr {p['roughness']!r}\nPm {p['metallic']!r}\n"
                        f"Pc {p['clearcoat'] / MAX_CLEARCOAT!r}\n"
                        f"Pcr {p['clearcoat_roughness']!r}\n")
    lines = [f"mtllib {os.path.basename(mtl_path)}\n"]
    lines += ["v {!r} {!r} {!r}\n".format(*v) for v in pos.tolist()]
    lines += ["vn {!r} {!r} {!r}\n".format(*n) for n in nrm.tolist()]
    for m in _used_ids(mids):
        lines.append(f"usemtl m{m}\n")
        lines += ["f {0}//{0} {1}//{1} {2}//{2}\n".format(a, b, c)
                  for a, b, c in (idx[mids == m] + 1).tolist()]
    with open(path, "w") as f:
        f.writelines(lines)


def _quat_from_neg_z(v) -> list:
    """The unit quaternion (x, y, z, w) turning -Z onto the direction ``v``."""
    a = np.array([0.0, 0.0, -1.0])
    b = np.asarray(v, np.float64) / np.linalg.norm(v)
    w = 1.0 + float(a @ b)
    if w < 1e-9:
        return [1.0, 0.0, 0.0, 0.0]
    q = np.array([*np.cross(a, b), w])
    return (q / np.linalg.norm(q)).tolist()


def _lights(scene: Scene):
    """(glTF light records, light nodes) of the scene's punctual lights."""
    b = scene.lights
    lights, nodes = [], []

    def add(kind, rad, factor, node, **extra):
        rad = np.asarray(rad.detach().cpu().numpy(), np.float64)
        peak = max(float(rad.max()), 1e-30)
        lights.append({"type": kind, "color": (rad / peak).tolist(),
                       "intensity": peak * 683.0 / factor, **extra})
        node["extensions"] = {"KHR_lights_punctual": {"light": len(lights) - 1}}
        nodes.append(node)

    for i in range(b.num_directional):
        d = -b.dir_direction[i].cpu().numpy()
        add("directional", b.dir_color[i], 1.0, {"rotation": _quat_from_neg_z(d)})
    for i in range(b.num_point):
        add("point", b.point_color[i], 4.0 * math.pi,
            {"translation": b.point_position[i].cpu().numpy().tolist()})
    for i in range(b.num_spot):
        cos_in, cos_out = b.spot_cos_angles[i].cpu().numpy().tolist()
        add("spot", b.spot_color[i], math.pi,
            {"translation": b.spot_position[i].cpu().numpy().tolist(),
             "rotation": _quat_from_neg_z(b.spot_direction[i].cpu().numpy())},
            spot={"innerConeAngle": math.acos(min(cos_in, 1.0)),
                  "outerConeAngle": math.acos(min(cos_out, 1.0))})
    return lights, nodes


def write_glb(path: str, scene: Scene, texture: np.ndarray | None = None) -> None:
    """GLB: one mesh with a primitive per material (positions, normals, UVs,
    uint32 indices), the table's materials, the bank's punctual lights, and
    ``texture`` ((H, W, 3|4) uint8, written as PNG) as material 0's base
    colour."""
    from ..io_utils.png import encode_png

    pos, nrm, uv, idx, mids = _arrays(scene)
    blob, views, accessors = bytearray(), [], []

    def view(data: bytes) -> int:
        blob.extend(b"\0" * (-len(blob) % 4))
        views.append({"buffer": 0, "byteOffset": len(blob), "byteLength": len(data)})
        blob.extend(data)
        return len(views) - 1

    def accessor(arr: np.ndarray, kind: str, component: int) -> int:
        entry = {"bufferView": view(arr.tobytes()), "componentType": component,
                 "count": len(arr), "type": kind}
        if kind == "VEC3":
            entry.update(min=arr.min(axis=0).tolist(), max=arr.max(axis=0).tolist())
        accessors.append(entry)
        return len(accessors) - 1

    attrs = {"POSITION": accessor(pos.astype("<f4"), "VEC3", 5126),
             "NORMAL": accessor(nrm.astype("<f4"), "VEC3", 5126),
             "TEXCOORD_0": accessor(uv.astype("<f4"), "VEC2", 5126)}
    prims, materials = [], []
    for i, p in enumerate(_materials(scene)):
        if p["kind"] == KIND_GLASS:
            materials.append({
                "name": f"m{i}",
                "pbrMetallicRoughness": {"baseColorFactor": [*p["base_color"], 1.0],
                                         "roughnessFactor": p["roughness"]},
                "extensions": {"KHR_materials_transmission": {"transmissionFactor": 1.0},
                               "KHR_materials_ior": {"ior": p["ior"]}}})
        else:
            materials.append({
                "name": f"m{i}", "emissiveFactor": p["emissive"],
                "pbrMetallicRoughness": {"baseColorFactor": [*p["base_color"], 1.0],
                                         "metallicFactor": p["metallic"],
                                         "roughnessFactor": p["roughness"]}})
    for m in _used_ids(mids):
        prims.append({"attributes": attrs, "material": m,
                      "indices": accessor(idx[mids == m].reshape(-1).astype("<u4"),
                                          "SCALAR", 5125)})
    gltf = {"asset": {"version": "2.0"}, "scene": 0, "meshes": [{"primitives": prims}],
            "materials": materials, "accessors": accessors}
    if texture is not None:
        gltf["images"] = [{"bufferView": view(encode_png(np.asarray(texture, np.uint8))),
                           "mimeType": "image/png"}]
        gltf["textures"] = [{"source": 0}]
        materials[0]["pbrMetallicRoughness"]["baseColorTexture"] = {"index": 0}
    lights, light_nodes = _lights(scene)
    gltf["nodes"] = [{"mesh": 0}, *light_nodes]
    gltf["scenes"] = [{"nodes": list(range(len(gltf["nodes"])))}]
    if lights:
        gltf["extensionsUsed"] = ["KHR_lights_punctual"]
        gltf["extensions"] = {"KHR_lights_punctual": {"lights": lights}}
    gltf["bufferViews"] = views
    blob.extend(b"\0" * (-len(blob) % 4))
    gltf["buffers"] = [{"byteLength": len(blob)}]
    text = json.dumps(gltf).encode()
    text += b" " * (-len(text) % 4)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, 28 + len(text) + len(blob)))
        f.write(struct.pack("<II", len(text), 0x4E4F534A) + text)
        f.write(struct.pack("<II", len(blob), 0x004E4942) + bytes(blob))
