"""Minimal FBX binary importer: meshes, materials and transforms (port of
``heatray_tpu.scene.loaders.fbx``).

Closes the one real-world-weight gap in the importer surface vs the
reference's any-Assimp-format reach (``AssimpMeshProvider.cpp:677-694``).
Pure numpy + stdlib zlib; reads the Kaydara FBX *binary* container
(versions 7100-7700, both the 32-bit and the 7500+ 64-bit record
headers) and understands the FBX 7.x document model:

- ``Objects/Geometry``: ``Vertices``, ``PolygonVertexIndex`` (negative
  value = last corner of a polygon, index = ~v), ``LayerElementNormal`` /
  ``LayerElementUV`` with ByPolygonVertex / ByControlPoint mappings
  (Direct or IndexToDirect), ``LayerElementMaterial`` (AllSame /
  ByPolygon).
- ``Objects/Model``: local TRS from ``Properties70`` (``Lcl Translation/
  Rotation/Scaling`` in degrees, XYZ order, plus ``PreRotation``).
- ``Objects/Material``: Phong/Lambert surface properties; classification
  mirrors the original renderer's PBR-vs-glass split (``AssimpMeshProvider.cpp:
  375-389``): Opacity < 1 (or TransparencyFactor > 0) -> glass.
- ``Connections``: Geometry->Model and Material->Model wiring.
- ``GlobalSettings/UnitScaleFactor``: FBX units are cm-relative; the
  reference's importer scales cm -> m (``AssimpMeshProvider.cpp:692``),
  reproduced here as ``unit_scale / 100``.

Polygons are fan-triangulated like every other loader
(``AssimpMeshProvider.cpp:270-278``).  ASCII FBX is rejected with a clear
error (export binary, or convert).
"""

from __future__ import annotations

import math
import struct
import zlib
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..geometry import MeshData
from ..materials import GlassParams, PBRParams

_MAGIC = b"Kaydara FBX Binary  \x00"

_ARRAY_TYPES = {
    b"f": np.dtype("<f4"),
    b"d": np.dtype("<f8"),
    b"l": np.dtype("<i8"),
    b"i": np.dtype("<i4"),
    b"b": np.dtype("<u1"),
}
_SCALAR_TYPES = {
    b"Y": ("<h", 2),
    b"C": ("<B", 1),
    b"I": ("<i", 4),
    b"F": ("<f", 4),
    b"D": ("<d", 8),
    b"L": ("<q", 8),
}


@dataclass
class _Node:
    name: str
    props: list
    children: List["_Node"] = field(default_factory=list)

    def child(self, name: str) -> Optional["_Node"]:
        for c in self.children:
            if c.name == name:
                return c
        return None

    def all(self, name: str) -> List["_Node"]:
        return [c for c in self.children if c.name == name]


def _read_property(data: bytes, pos: int):
    t = data[pos : pos + 1]
    pos += 1
    if t in _SCALAR_TYPES:
        fmt, size = _SCALAR_TYPES[t]
        (v,) = struct.unpack_from(fmt, data, pos)
        return (bool(v) if t == b"C" else v), pos + size
    if t in _ARRAY_TYPES:
        n, enc, comp_len = struct.unpack_from("<III", data, pos)
        pos += 12
        dt = _ARRAY_TYPES[t]
        if enc == 0:
            raw = data[pos : pos + n * dt.itemsize]
            pos += n * dt.itemsize
        else:
            raw = zlib.decompress(data[pos : pos + comp_len])
            pos += comp_len
        return np.frombuffer(raw, dt, n), pos
    if t in (b"S", b"R"):
        (n,) = struct.unpack_from("<I", data, pos)
        pos += 4
        raw = data[pos : pos + n]
        pos += n
        return (raw.decode("utf-8", "replace") if t == b"S" else raw), pos
    raise ValueError(f"unknown FBX property type {t!r} at {pos - 1}")


def _read_node(data: bytes, pos: int, big: bool):
    """Parse one node record; returns (node | None, next_pos)."""
    if big:
        end, nprops, _plen = struct.unpack_from("<QQQ", data, pos)
        pos += 24
    else:
        end, nprops, _plen = struct.unpack_from("<III", data, pos)
        pos += 12
    name_len = data[pos]
    pos += 1
    if end == 0 and nprops == 0 and name_len == 0:
        return None, pos  # null sentinel
    name = data[pos : pos + name_len].decode("utf-8", "replace")
    pos += name_len
    props = []
    for _ in range(nprops):
        v, pos = _read_property(data, pos)
        props.append(v)
    children = []
    while pos < end:
        child, pos = _read_node(data, pos, big)
        if child is None:
            break
        children.append(child)
    return _Node(name, props, children), end


def parse_fbx(data: bytes) -> Tuple[_Node, int]:
    """Parse an FBX binary blob -> (root node, version)."""
    if not data.startswith(_MAGIC):
        if data[:1] == b";" or b"FBXHeaderExtension:" in data[:4096]:
            raise ValueError(
                "ASCII FBX is not supported; export as binary FBX"
            )
        raise ValueError("not an FBX binary file")
    (version,) = struct.unpack_from("<I", data, 23)
    big = version >= 7500
    pos = 27
    root = _Node("", [])
    while pos < len(data):
        node, pos = _read_node(data, pos, big)
        if node is None:
            break
        root.children.append(node)
    return root, version


def _props70(node: Optional[_Node]) -> dict:
    """Properties70 -> {name: value} (vec3 props -> (x, y, z) tuple)."""
    out = {}
    p70 = node.child("Properties70") if node is not None else None
    if p70 is None:
        return out
    for p in p70.all("P"):
        if not p.props:
            continue
        name = p.props[0]
        vals = [v for v in p.props[4:] if isinstance(v, (int, float, bool))]
        if len(vals) >= 3:
            out[name] = tuple(float(v) for v in vals[:3])
        elif vals:
            out[name] = float(vals[0])
        elif len(p.props) > 4:
            out[name] = p.props[4]
    return out


def _rot_xyz(rx: float, ry: float, rz: float) -> np.ndarray:
    """FBX Euler (degrees, XYZ order): R = Rz @ Ry @ Rx."""
    rx, ry, rz = (math.radians(a) for a in (rx, ry, rz))
    cx, sx, cy, sy, cz, sz = (
        math.cos(rx), math.sin(rx), math.cos(ry),
        math.sin(ry), math.cos(rz), math.sin(rz),
    )
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def _model_matrix(props: dict) -> np.ndarray:
    t = np.asarray(props.get("Lcl Translation", (0.0, 0.0, 0.0)))
    r = props.get("Lcl Rotation", (0.0, 0.0, 0.0))
    s = np.asarray(props.get("Lcl Scaling", (1.0, 1.0, 1.0)))
    pre = props.get("PreRotation")
    R = _rot_xyz(*r)
    if pre is not None:
        R = _rot_xyz(*pre) @ R
    m = np.eye(4)
    m[:3, :3] = R * s[None, :]
    m[:3, 3] = t
    return m


def _layer_values(elem: Optional[_Node], value_name: str, width: int,
                  polyvert_cp: np.ndarray, num_cp: int):
    """Decode a LayerElement (normals/UVs) to per-polygon-vertex rows.

    ``polyvert_cp``: control-point index per polygon corner (in file
    order).  Returns (N_corners, width) float32 or None."""
    if elem is None:
        return None
    values = elem.child(value_name)
    if values is None or not isinstance(values.props[0], np.ndarray):
        return None
    vals = np.asarray(values.props[0], np.float64).reshape(-1, width)
    mapping = elem.child("MappingInformationType")
    ref = elem.child("ReferenceInformationType")
    mapping = mapping.props[0] if mapping else "ByPolygonVertex"
    ref = ref.props[0] if ref else "Direct"
    idx_node = elem.child(value_name + "Index") or elem.child("UVIndex")
    if ref == "IndexToDirect" and idx_node is not None:
        idx = np.asarray(idx_node.props[0], np.int64)
        # -1 entries mean "no value"; clamp and zero later if needed.
        vals = vals[np.clip(idx, 0, len(vals) - 1)]
    if mapping == "ByPolygonVertex":
        rows = vals
    elif mapping in ("ByControlPoint", "ByVertice", "ByVertex"):
        rows = vals[np.clip(polyvert_cp, 0, num_cp - 1)]
    elif mapping == "AllSame":
        rows = np.broadcast_to(vals[:1], (len(polyvert_cp), width))
    else:
        return None
    if len(rows) != len(polyvert_cp):
        return None
    return np.ascontiguousarray(rows, dtype=np.float32)


def _material_from_node(mat: _Node):
    """FBX surface material -> PBRParams / GlassParams, mirroring the
    reference's classification (``AssimpMeshProvider.cpp:375-434``)."""
    p = _props70(mat)
    name = mat.props[1].split("\x00")[0] if len(mat.props) > 1 else "fbx"
    diffuse = p.get("DiffuseColor", (1.0, 1.0, 1.0))
    opacity = p.get("Opacity")
    transparency = p.get("TransparencyFactor", 0.0)
    if isinstance(transparency, tuple):
        transparency = transparency[0]
    if opacity is None:
        opacity = 1.0 - float(transparency or 0.0)
    if float(opacity) < 1.0 - 1e-6:
        return GlassParams(base_color=tuple(diffuse), name=name)
    emissive = np.asarray(p.get("EmissiveColor", (0.0, 0.0, 0.0)))
    emissive = emissive * float(p.get("EmissiveFactor", 1.0))
    shininess = p.get("ShininessExponent", p.get("Shininess", 0.0)) or 0.0
    # Blinn-Phong exponent -> GGX roughness (energy-matched heuristic).
    roughness = float(np.clip(math.sqrt(2.0 / (2.0 + shininess)), 0.01, 1.0))
    metallic = float(np.clip(p.get("ReflectionFactor", 0.0), 0.0, 1.0))
    return PBRParams(
        base_color=tuple(diffuse),
        emissive=tuple(emissive.tolist()),
        roughness=roughness,
        metallic=metallic,
        name=name,
    )


def load_fbx(
    path: str, scale: float = 1.0
) -> Tuple[List[MeshData], List[object]]:
    """Load a binary FBX file -> ([MeshData], [PBRParams | GlassParams])."""
    with open(path, "rb") as f:
        data = f.read()
    root, _version = parse_fbx(data)

    # Unit scaling: FBX UnitScaleFactor is relative to cm; the reference
    # imports at cm -> m (``AssimpMeshProvider.cpp:692``).
    unit = _props70(
        (root.child("GlobalSettings") or _Node("", []))
    ).get("UnitScaleFactor", 100.0)
    total_scale = scale * float(unit) / 100.0

    objects = root.child("Objects")
    if objects is None:
        raise ValueError(f"FBX file has no Objects section: {path}")
    geoms, models, materials = {}, {}, {}
    for n in objects.children:
        if not n.props or not isinstance(n.props[0], (int, np.integer)):
            continue
        oid = int(n.props[0])
        if n.name == "Geometry":
            geoms[oid] = n
        elif n.name == "Model":
            models[oid] = n
        elif n.name == "Material":
            materials[oid] = n

    # Connections: geometry -> model, materials -> model (file order).
    geom_of_model: dict = {}
    mats_of_model: dict = {}
    conns = root.child("Connections")
    for c in conns.all("C") if conns is not None else []:
        if len(c.props) < 3 or c.props[0] != "OO":
            continue
        src, dst = int(c.props[1]), int(c.props[2])
        if src in geoms and dst in models:
            geom_of_model[dst] = src
        elif src in materials and dst in models:
            mats_of_model.setdefault(dst, []).append(src)

    out_meshes: List[MeshData] = []
    out_mats: List[object] = []
    default_mat = PBRParams(name="fbx-default")

    model_items = list(geom_of_model.items()) or [
        (None, gid) for gid in geoms
    ]
    for model_id, geom_id in model_items:
        g = geoms[geom_id]
        verts_node = g.child("Vertices")
        idx_node = g.child("PolygonVertexIndex")
        if verts_node is None or idx_node is None:
            continue
        cp = np.asarray(verts_node.props[0], np.float64).reshape(-1, 3)
        pvi = np.asarray(idx_node.props[0], np.int64)
        # Decode polygons: negative entry ends a polygon, index = ~v.
        corner_cp = np.where(pvi < 0, ~pvi, pvi)
        poly_end = np.flatnonzero(pvi < 0)
        # Fan triangulation per polygon, in polygon-corner space.
        tri_corners = []
        tri_poly = []
        start = 0
        for pi, end in enumerate(poly_end):
            m = end - start + 1  # corners in this polygon
            for k in range(1, m - 1):
                tri_corners.append((start, start + k, start + k + 1))
                tri_poly.append(pi)
            start = end + 1
        if not tri_corners:
            continue
        tri_corners = np.asarray(tri_corners, np.int64)
        tri_poly = np.asarray(tri_poly, np.int64)

        name = g.props[1].split("\x00")[0] if len(g.props) > 1 else "fbx"
        normals = _layer_values(
            g.child("LayerElementNormal"), "Normals", 3, corner_cp, len(cp)
        )
        uvs = _layer_values(
            g.child("LayerElementUV"), "UV", 2, corner_cp, len(cp)
        )
        colors = _layer_values(
            g.child("LayerElementColor"), "Colors", 4, corner_cp, len(cp)
        )

        # Transform + unit scale (normals by the inverse-transpose).
        model = models.get(model_id)
        matrix = _model_matrix(_props70(model)) if model is not None else np.eye(4)
        world = cp @ matrix[:3, :3].T + matrix[:3, 3]
        world = world * total_scale
        if normals is not None:
            n_mat = np.linalg.inv(matrix[:3, :3]).T
            normals = normals @ n_mat.astype(np.float32).T
            normals = normals / np.maximum(
                np.linalg.norm(normals, axis=1, keepdims=True), 1e-20
            )

        # Per-triangle material ids from LayerElementMaterial.
        mat_ids = np.zeros(len(tri_corners), np.int64)
        lem = g.child("LayerElementMaterial")
        if lem is not None:
            mnode = lem.child("Materials")
            mapping = lem.child("MappingInformationType")
            mapping = mapping.props[0] if mapping else "AllSame"
            if (
                mapping == "ByPolygon"
                and mnode is not None
                and isinstance(mnode.props[0], np.ndarray)
            ):
                per_poly = np.asarray(mnode.props[0], np.int64)
                if len(per_poly) >= len(poly_end):
                    mat_ids = per_poly[tri_poly]

        mat_nodes = [
            materials[m]
            for m in mats_of_model.get(model_id, [])
            if m in materials
        ]

        for slot in np.unique(mat_ids):
            sel = mat_ids == slot
            corners = tri_corners[sel]
            if normals is not None or uvs is not None or colors is not None:
                # Per-corner attributes: emit unshared vertices.
                flat = corners.reshape(-1)
                mesh = MeshData(
                    positions=world[corner_cp[flat]],
                    indices=np.arange(len(flat), dtype=np.int32).reshape(
                        -1, 3
                    ),
                    normals=None if normals is None else normals[flat],
                    uvs=None if uvs is None else uvs[flat],
                    colors=(
                        None if colors is None else colors[flat][:, :3]
                    ),
                    name=name,
                )
            else:
                mesh = MeshData(
                    positions=world,
                    indices=corner_cp[corners.reshape(-1)].reshape(-1, 3),
                    name=name,
                )
            if 0 <= slot < len(mat_nodes):
                mat = _material_from_node(mat_nodes[int(slot)])
            elif mat_nodes:
                mat = _material_from_node(mat_nodes[0])
            else:
                mat = default_mat
            out_meshes.append(mesh)
            out_mats.append(mat)

    if not out_meshes:
        raise ValueError(f"FBX file contains no triangle geometry: {path}")
    return out_meshes, out_mats
