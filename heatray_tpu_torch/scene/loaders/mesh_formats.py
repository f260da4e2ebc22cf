"""PLY, STL and OFF mesh loaders in numpy (port of
``heatray_tpu.scene.loaders.mesh_formats``).

Widens the importer surface toward the original renderer's any-Assimp-format reach
(``AssimpMeshProvider.cpp:677-694``): scanned-mesh formats that carry no
material, imported with the same semantics as the OBJ path — fan
triangulation for polygonal faces, optional per-vertex normals/uvs/colors,
caller-supplied unit ``scale`` (cm->m etc., ``AssimpMeshProvider.cpp:692``).
"""

from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np

from ..geometry import MeshData
from ..materials import PBRParams

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def _fan(faces: List[List[int]]) -> np.ndarray:
    """Fan-triangulate polygon index lists -> (T, 3) int32
    (``AssimpMeshProvider.cpp:270-278``)."""
    tris = []
    for f in faces:
        for k in range(1, len(f) - 1):
            tris.append((f[0], f[k], f[k + 1]))
    return np.asarray(tris, np.int32).reshape(-1, 3)


def load_ply(
    path: str, scale: float = 1.0, name: str | None = None
) -> Tuple[List[MeshData], List[object]]:
    """Load a PLY file (ascii / binary little- or big-endian).

    Supports the common vertex properties (x y z, nx ny nz, u v | s t,
    red green blue [alpha]) and a face element with a vertex-index list.
    Returns ([mesh], [default PBR material]).
    """
    with open(path, "rb") as f:
        data = f.read()

    # --- header ---
    end = data.find(b"end_header")
    if not data.startswith(b"ply") or end < 0:
        raise ValueError(f"not a PLY file: {path}")
    end = data.find(b"\n", end) + 1
    header = data[:end].decode("ascii", errors="replace").splitlines()
    body = data[end:]

    fmt = None
    elements = []  # (name, count, [(prop_name, dtype, is_list, count_dtype)])
    for line in header[1:]:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append(
                    (parts[4], _PLY_DTYPES[parts[3]], True, _PLY_DTYPES[parts[2]])
                )
            else:
                elements[-1][2].append((parts[2], _PLY_DTYPES[parts[1]], False, None))

    endian = {"binary_little_endian": "<", "binary_big_endian": ">"}.get(fmt)
    parsed: dict = {}

    if fmt == "ascii":
        tokens = body.split()
        pos = 0
        for ename, count, props in elements:
            if any(p[2] for p in props):  # list property: per-row parse
                rows = []
                for _ in range(count):
                    row = {}
                    for pname, dt, is_list, _cdt in props:
                        if is_list:
                            n = int(tokens[pos]); pos += 1
                            row[pname] = [int(tokens[pos + i]) for i in range(n)]
                            pos += n
                        else:
                            row[pname] = float(tokens[pos]); pos += 1
                    rows.append(row)
                parsed[ename] = rows
            else:
                width = len(props)
                arr = np.asarray(
                    tokens[pos : pos + count * width], np.float64
                ).reshape(count, width)
                pos += count * width
                parsed[ename] = {
                    p[0]: arr[:, i] for i, p in enumerate(props)
                }
    else:
        if endian is None:
            raise ValueError(f"unknown PLY format {fmt!r}")
        off = 0
        for ename, count, props in elements:
            if any(p[2] for p in props):
                rows = []
                for _ in range(count):
                    row = {}
                    for pname, dt, is_list, cdt in props:
                        if is_list:
                            cdtype = np.dtype(endian + cdt)
                            n = int(
                                np.frombuffer(body, cdtype, 1, off)[0]
                            )
                            off += cdtype.itemsize
                            idt = np.dtype(endian + dt)
                            row[pname] = np.frombuffer(
                                body, idt, n, off
                            ).astype(np.int64)
                            off += idt.itemsize * n
                        else:
                            idt = np.dtype(endian + dt)
                            row[pname] = float(
                                np.frombuffer(body, idt, 1, off)[0]
                            )
                            off += idt.itemsize
                    rows.append(row)
                parsed[ename] = rows
            else:
                rec = np.dtype(
                    [(p[0], endian + p[1]) for p in props]
                )
                arr = np.frombuffer(body, rec, count, off)
                off += rec.itemsize * count
                parsed[ename] = {p[0]: arr[p[0]] for p in props}

    if "vertex" not in parsed:
        raise ValueError(f"PLY file has no vertex element: {path}")
    vtx = parsed["vertex"]
    positions = np.stack(
        [np.asarray(vtx["x"]), np.asarray(vtx["y"]), np.asarray(vtx["z"])],
        axis=1,
    ).astype(np.float32) * np.float32(scale)

    normals = None
    if all(k in vtx for k in ("nx", "ny", "nz")):
        normals = np.stack(
            [np.asarray(vtx["nx"]), np.asarray(vtx["ny"]), np.asarray(vtx["nz"])],
            axis=1,
        ).astype(np.float32)

    uvs = None
    for ukey, vkey in (("u", "v"), ("s", "t"), ("texture_u", "texture_v")):
        if ukey in vtx and vkey in vtx:
            uvs = np.stack(
                [np.asarray(vtx[ukey]), np.asarray(vtx[vkey])], axis=1
            ).astype(np.float32)
            break

    colors = None
    if all(k in vtx for k in ("red", "green", "blue")):
        colors = np.stack(
            [np.asarray(vtx["red"]), np.asarray(vtx["green"]), np.asarray(vtx["blue"])],
            axis=1,
        ).astype(np.float32)
        if colors.max() > 1.0 + 1e-6:  # uchar colors -> [0, 1]
            colors = colors / 255.0

    faces = []
    for row in parsed.get("face", []):
        for key in ("vertex_indices", "vertex_index"):
            if key in row:
                faces.append([int(i) for i in row[key]])
                break
    indices = _fan(faces)

    mesh = MeshData(
        positions=positions,
        indices=indices,
        normals=normals,
        uvs=uvs,
        colors=colors,
        name=name or "ply",
    )
    return [mesh], [PBRParams(name=name or "ply")]


def load_stl(
    path: str, scale: float = 1.0, name: str | None = None
) -> Tuple[List[MeshData], List[object]]:
    """Load an STL file (binary or ascii).  STL is a raw triangle soup with
    facet normals only; vertices are deduplicated so shading normals can be
    area-averaged by the geometry builder."""
    with open(path, "rb") as f:
        data = f.read()

    is_ascii = data[:5] == b"solid" and b"facet" in data[:1024]
    if is_ascii:
        tris = []
        for line in data.decode("ascii", errors="replace").splitlines():
            parts = line.split()
            if parts[:1] == ["vertex"]:
                tris.append([float(v) for v in parts[1:4]])
        v = np.asarray(tris, np.float32).reshape(-1, 3)
    else:
        if len(data) < 84:
            raise ValueError(f"truncated STL: {path}")
        (n_tri,) = struct.unpack("<I", data[80:84])
        rec = np.dtype(
            [("n", "<f4", 3), ("v", "<f4", (3, 3)), ("attr", "<u2")]
        )
        arr = np.frombuffer(data, rec, n_tri, 84)
        v = np.ascontiguousarray(arr["v"]).reshape(-1, 3)

    v = v * np.float32(scale)
    uniq, inverse = np.unique(v.round(7), axis=0, return_inverse=True)
    positions = uniq.astype(np.float32)
    indices = inverse.reshape(-1, 3).astype(np.int32)
    mesh = MeshData(positions=positions, indices=indices, name=name or "stl")
    return [mesh], [PBRParams(name=name or "stl")]


def load_off(
    path: str, scale: float = 1.0, name: str | None = None
) -> Tuple[List[MeshData], List[object]]:
    """Load an OFF (Object File Format) mesh: ``OFF / V F E / vertices /
    faces`` with optional per-vertex colors (COFF) — another scanned-mesh
    staple of the Assimp import surface."""
    with open(path, "r", errors="replace") as f:
        tokens = []
        for line in f:
            line = line.split("#", 1)[0].strip()
            if line:
                tokens.extend(line.split())
    if not tokens or not tokens[0].upper().endswith("OFF"):
        raise ValueError(f"not an OFF file: {path}")
    has_color = tokens[0].upper().startswith("C")
    pos = 1
    nv, nf = int(tokens[pos]), int(tokens[pos + 1])
    pos += 3  # skip edge count
    width = 7 if has_color else 3  # x y z [r g b a]
    vdata = np.asarray(tokens[pos : pos + nv * width], np.float64)
    # Some COFF files write rgb without alpha; re-detect from token budget.
    if has_color and vdata.size != nv * width:
        width = 6
        vdata = np.asarray(tokens[pos : pos + nv * width], np.float64)
    vdata = vdata.reshape(nv, width)
    pos += nv * width
    positions = (vdata[:, :3] * scale).astype(np.float32)
    colors = None
    if has_color:
        colors = vdata[:, 3:6].astype(np.float32)
        if colors.max() > 1.0 + 1e-6:
            colors = colors / 255.0
    faces = []
    for _ in range(nf):
        n = int(tokens[pos]); pos += 1
        faces.append([int(tokens[pos + i]) for i in range(n)])
        pos += n
    mesh = MeshData(
        positions=positions,
        indices=_fan(faces),
        colors=colors,
        name=name or "off",
    )
    return [mesh], [PBRParams(name=name or "off")]
