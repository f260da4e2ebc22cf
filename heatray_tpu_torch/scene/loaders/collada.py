"""COLLADA (.dae) importer in stdlib XML and numpy (port of
``heatray_tpu.scene.loaders.collada``).

Widens the importer surface toward the original renderer's any-Assimp-format reach
(``AssimpMeshProvider.cpp:677-694``) with the format Assimp itself was
born from.  Covers the common interchange subset:

- ``library_geometries``: <mesh> sources (positions/normals/texcoords),
  <triangles> and <polylist> primitives with multi-offset <p> index tuples
  (fan triangulation for polylist faces, ``AssimpMeshProvider.cpp:270-278``)
- ``library_effects``/``library_materials``: phong/lambert/blinn diffuse,
  emission, transparency -> the original renderer's material classification
  (transparency -> glass, shininess -> roughness) matching
  ``AssimpMeshProvider.cpp:375-435``
- ``library_visual_scenes``: node hierarchy with <matrix>, <translate>,
  <rotate>, <scale> composed in document order; instance_geometry material
  binding; the scene-level unit/meter scale (``AssimpMeshProvider.cpp:692``)
- up-axis conversion (Z_UP / X_UP -> Y_UP)
"""

from __future__ import annotations

import math
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..geometry import MeshData
from ..materials import GlassParams, PBRParams

_NS = "{http://www.collada.org/2005/11/COLLADASchema}"


def _tag(e) -> str:
    return e.tag.split("}")[-1]


def _floats(text: Optional[str]) -> np.ndarray:
    return np.asarray((text or "").split(), dtype=np.float64)


def _ints(text: Optional[str]) -> np.ndarray:
    return np.asarray((text or "").split(), dtype=np.int64)


def _find(e, name):
    return e.find(_NS + name) if e is not None else None


def _findall(e, name):
    return e.findall(_NS + name) if e is not None else []


def _local_transform(node) -> np.ndarray:
    """Compose a node's transform elements in DOCUMENT ORDER (the COLLADA
    rule: each element post-multiplies)."""
    m = np.eye(4)
    for child in node:
        t = _tag(child)
        if t == "matrix":
            m = m @ _floats(child.text).reshape(4, 4)
        elif t == "translate":
            v = _floats(child.text)
            tm = np.eye(4)
            tm[:3, 3] = v[:3]
            m = m @ tm
        elif t == "scale":
            v = _floats(child.text)
            m = m @ np.diag([v[0], v[1], v[2], 1.0])
        elif t == "rotate":
            v = _floats(child.text)
            axis = v[:3]
            n = np.linalg.norm(axis)
            if n < 1e-12:
                continue
            x, y, z = axis / n
            a = math.radians(v[3])
            c, s = math.cos(a), math.sin(a)
            cc = 1.0 - c
            rm = np.eye(4)
            rm[:3, :3] = [
                [c + x * x * cc, x * y * cc - z * s, x * z * cc + y * s],
                [y * x * cc + z * s, c + y * y * cc, y * z * cc - x * s],
                [z * x * cc - y * s, z * y * cc + x * s, c + z * z * cc],
            ]
            m = m @ rm
    return m


def _color_of(elem) -> Optional[Tuple[float, float, float]]:
    c = _find(elem, "color")
    if c is None or c.text is None:
        return None
    v = _floats(c.text)
    return (float(v[0]), float(v[1]), float(v[2])) if v.size >= 3 else None


def _float_of(elem) -> Optional[float]:
    f = _find(elem, "float")
    if f is None or f.text is None:
        return None
    return float(_floats(f.text)[0])


def _parse_effects(root) -> Dict[str, dict]:
    """effect id -> raw shading dict (diffuse/emission/shininess/...)."""
    effects: Dict[str, dict] = {}
    for eff in _findall(_find(root, "library_effects"), "effect"):
        eid = eff.get("id", "")
        raw: dict = {}
        for shader in eff.iter():
            if _tag(shader) not in ("phong", "lambert", "blinn", "constant"):
                continue
            for prop in shader:
                p = _tag(prop)
                if p in ("diffuse", "emission", "specular", "reflective"):
                    col = _color_of(prop)
                    if col is not None:
                        raw[p] = col
                elif p in ("shininess", "transparency", "index_of_refraction"):
                    val = _float_of(prop)
                    if val is not None:
                        raw[p] = val
                elif p == "transparent":
                    raw["transparent_color"] = _color_of(prop)
        effects[eid] = raw
    return effects


def _parse_materials(root, effects) -> Dict[str, dict]:
    """material id -> effect dict (+ name)."""
    mats: Dict[str, dict] = {}
    for mat in _findall(_find(root, "library_materials"), "material"):
        mid = mat.get("id", "")
        inst = _find(mat, "instance_effect")
        url = (inst.get("url", "") if inst is not None else "").lstrip("#")
        d = dict(effects.get(url, {}))
        d["name"] = mat.get("name", mid)
        mats[mid] = d
    return mats


def _material_params(raw: dict):
    """Map raw COLLADA shading values onto the original renderer's material model
    (same split as the Assimp path, ``AssimpMeshProvider.cpp:375-435``)."""
    name = raw.get("name", "dae")
    transparency = raw.get("transparency")
    # Some exporters write transparency as opacity (1 = opaque); treat
    # values < 1 as "some transmission" exactly like Assimp's opacity.
    if transparency is not None and transparency < 1.0 - 1e-6:
        return GlassParams(
            name=name,
            base_color=raw.get("diffuse", (1.0, 1.0, 1.0)),
            ior=raw.get("index_of_refraction", 1.5) or 1.5,
            roughness=_shininess_to_roughness(raw.get("shininess")),
        )
    return PBRParams(
        name=name,
        base_color=raw.get("diffuse", (1.0, 1.0, 1.0)),
        emissive=raw.get("emission", (0.0, 0.0, 0.0)),
        roughness=_shininess_to_roughness(raw.get("shininess")),
        metallic=0.0,
    )


def _shininess_to_roughness(shininess: Optional[float]) -> float:
    """Phong exponent -> GGX roughness (Assimp's specular-exponent
    convention; sqrt(2 / (n + 2)) is the standard Phong->Beckmann map)."""
    if shininess is None or shininess <= 0.0:
        return 1.0
    return float(np.clip(math.sqrt(2.0 / (shininess + 2.0)), 0.04, 1.0))


def _parse_geometry(geo) -> Optional[dict]:
    """One <geometry><mesh> -> dict of arrays + primitive batches."""
    mesh = _find(geo, "mesh")
    if mesh is None:
        return None
    sources: Dict[str, np.ndarray] = {}
    strides: Dict[str, int] = {}
    for src in _findall(mesh, "source"):
        arr = _find(src, "float_array")
        if arr is None:
            continue
        acc = None
        tech = _find(src, "technique_common")
        if tech is not None:
            acc = _find(tech, "accessor")
        stride = int(acc.get("stride", 3)) if acc is not None else 3
        sources[src.get("id", "")] = _floats(arr.text)
        strides[src.get("id", "")] = stride

    verts = _find(mesh, "vertices")
    vert_pos_src = ""
    if verts is not None:
        for inp in _findall(verts, "input"):
            if inp.get("semantic") == "POSITION":
                vert_pos_src = inp.get("source", "").lstrip("#")
    vertices_id = verts.get("id", "") if verts is not None else ""

    prims = []
    for prim in mesh:
        t = _tag(prim)
        if t not in ("triangles", "polylist", "polygons"):
            continue
        inputs = []  # (semantic, source_id, offset)
        max_off = 0
        for inp in _findall(prim, "input"):
            sem = inp.get("semantic", "")
            sid = inp.get("source", "").lstrip("#")
            off = int(inp.get("offset", 0))
            if sem == "VERTEX" and sid == vertices_id:
                sid = vert_pos_src
                sem = "POSITION"
            inputs.append((sem, sid, off))
            max_off = max(max_off, off)
        stride = max_off + 1
        idx = np.concatenate(
            [_ints(p.text) for p in _findall(prim, "p")]
        ) if _findall(prim, "p") else np.zeros((0,), np.int64)
        vcount = None
        vc = _find(prim, "vcount")
        if t == "polylist" and vc is not None:
            vcount = _ints(vc.text)
        prims.append({
            "material": prim.get("material", ""),
            "inputs": inputs,
            "stride": stride,
            "indices": idx,
            "vcount": vcount,
        })
    return {"sources": sources, "strides": strides, "prims": prims,
            "name": geo.get("name", geo.get("id", "dae"))}


def _fan_counts(vcount: np.ndarray) -> np.ndarray:
    """Corner index positions of the fan triangulation of polys with the
    given vertex counts: returns (T, 3) positions into the corner stream."""
    tris = []
    base = 0
    for n in vcount:
        for k in range(1, int(n) - 1):
            tris.append((base, base + k, base + k + 1))
        base += int(n)
    return np.asarray(tris, np.int64).reshape(-1, 3)


def load_dae(
    path: str, scale: float = 1.0
) -> Tuple[List[MeshData], List[object]]:
    """Load a COLLADA document -> ([MeshData], [material params]).

    ``scale`` multiplies the document's own unit/meter factor.
    """
    root = ET.parse(path).getroot()

    asset = _find(root, "asset")
    unit = _find(asset, "unit")
    doc_scale = float(unit.get("meter", 1.0)) if unit is not None else 1.0
    up = _find(asset, "up_axis")
    up_axis = (up.text or "Y_UP").strip() if up is not None else "Y_UP"
    # Up-axis conversion to the renderer's Y-up convention.
    if up_axis == "Z_UP":
        up_m = np.array(
            [[1, 0, 0, 0], [0, 0, 1, 0], [0, -1, 0, 0], [0, 0, 0, 1]],
            np.float64,
        )
    elif up_axis == "X_UP":
        up_m = np.array(
            [[0, -1, 0, 0], [1, 0, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
            np.float64,
        )
    else:
        up_m = np.eye(4)

    effects = _parse_effects(root)
    materials = _parse_materials(root, effects)
    geometries: Dict[str, dict] = {}
    for geo in _findall(_find(root, "library_geometries"), "geometry"):
        g = _parse_geometry(geo)
        if g is not None:
            geometries[geo.get("id", "")] = g

    total = np.float32(scale * doc_scale)
    meshes: List[MeshData] = []
    mats: List[object] = []

    def emit(geo_id: str, world: np.ndarray, mat_bind: Dict[str, str]):
        g = geometries.get(geo_id)
        if g is None:
            return
        for prim in g["prims"]:
            idx, stride = prim["indices"], prim["stride"]
            if idx.size == 0:
                continue
            tuples = idx.reshape(-1, stride)  # one row per corner
            if prim["vcount"] is not None:
                corner_tri = _fan_counts(prim["vcount"])
            else:
                n_tri = tuples.shape[0] // 3
                corner_tri = np.arange(n_tri * 3).reshape(-1, 3)

            # Re-index corners into a compact vertex buffer keyed by the
            # full input tuple (positions/normals/uvs may index separately).
            uniq, inverse = np.unique(tuples, axis=0, return_inverse=True)
            tri_idx = inverse[corner_tri].astype(np.int32)

            def fetch(sem):
                for s, sid, off in prim["inputs"]:
                    if s == sem and sid in g["sources"]:
                        st = g["strides"].get(sid, 3)
                        data = g["sources"][sid].reshape(-1, st)
                        return data[uniq[:, off]]
                return None

            pos = fetch("POSITION")
            if pos is None:
                continue
            pos4 = np.concatenate(
                [pos[:, :3], np.ones((pos.shape[0], 1))], axis=1
            )
            m = up_m @ world
            pos_w = (pos4 @ m.T)[:, :3] * total
            nrm = fetch("NORMAL")
            if nrm is not None:
                nmat = np.linalg.inv(m[:3, :3]).T
                nrm = nrm[:, :3] @ nmat.T
                ln = np.linalg.norm(nrm, axis=1, keepdims=True)
                nrm = (nrm / np.maximum(ln, 1e-12)).astype(np.float32)
            uv = fetch("TEXCOORD")
            uv = uv[:, :2].astype(np.float32) if uv is not None else None
            col = fetch("COLOR")
            col = col[:, :3].astype(np.float32) if col is not None else None

            # Negative-determinant transforms flip winding (the analog of
            # ``Mesh.cpp:86-91``); MeshData.transformed does this for its
            # own path — replicate here since we bake the transform.
            if np.linalg.det(m[:3, :3]) < 0:
                tri_idx = tri_idx[:, ::-1]

            sym = prim["material"]
            raw = materials.get(mat_bind.get(sym, sym), {"name": sym or g["name"]})
            meshes.append(MeshData(
                positions=pos_w.astype(np.float32),
                indices=tri_idx,
                normals=nrm,
                uvs=uv,
                colors=col,
                name=g["name"],
            ))
            mats.append(_material_params(raw))

    def walk(node, parent_m: np.ndarray):
        m = parent_m @ _local_transform(node)
        for inst in _findall(node, "instance_geometry"):
            gid = inst.get("url", "").lstrip("#")
            bind: Dict[str, str] = {}
            bm = _find(inst, "bind_material")
            tech = _find(bm, "technique_common") if bm is not None else None
            for im in _findall(tech, "instance_material"):
                bind[im.get("symbol", "")] = im.get("target", "").lstrip("#")
            emit(gid, m, bind)
        for child in _findall(node, "node"):
            walk(child, m)

    scenes = _find(root, "library_visual_scenes")
    found_scene = False
    for vs in _findall(scenes, "visual_scene"):
        found_scene = True
        for node in _findall(vs, "node"):
            walk(node, np.eye(4))
    if not found_scene:
        # No scene graph: emit every geometry untransformed.
        for gid in geometries:
            emit(gid, np.eye(4), {})

    if not meshes:
        raise ValueError(f"COLLADA file has no triangle geometry: {path}")
    return meshes, mats
