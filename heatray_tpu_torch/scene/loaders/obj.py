"""Wavefront OBJ/MTL loader (port of ``heatray_tpu.scene.loaders.obj``).

Parses OBJ geometry into numpy buffers, one mesh per material group, and
maps MTL materials with the original renderer's classification
(transmission -> glass, ``AssimpMeshProvider.cpp:377-389``; PBR factors
otherwise, ``:394-435``).  A file without ``usemtl`` (a scanned mesh, say)
goes through the host library's tokenizer (``native.parse_obj``), as in
the JAX package; a grouped file through the Python loop below.  Both give
the same ``MeshData`` for a file without groups: fan order, the
``np.unique`` vertex order, and one mesh named after the file.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ... import native
from ..geometry import MeshData
from ..materials import GlassParams, PBRParams


def parse_mtl(path: str) -> Dict[str, dict]:
    """Parse an MTL file into raw material dicts."""
    materials: Dict[str, dict] = {}
    current: Optional[dict] = None
    if not os.path.exists(path):
        return materials
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "newmtl":
                current = {"name": parts[1] if len(parts) > 1 else "mtl"}
                materials[current["name"]] = current
            elif current is None:
                continue
            elif key in ("Kd", "Ks", "Ke"):
                current[key] = [float(v) for v in parts[1:4]]
            elif key in ("Ns", "Ni", "d", "Tr", "Pr", "Pm", "Pc", "Pcr"):
                current[key] = float(parts[1])
            elif key == "Tf":
                current[key] = [float(v) for v in parts[1:4]]
            elif key == "illum":
                current[key] = int(parts[1])
            elif key.startswith("map_"):
                current[key] = parts[-1]
    return materials


def mtl_to_material(raw: dict):
    """MTL -> framework material, following the reference's classification:
    transmissive materials become glass, everything else PBR."""
    name = raw.get("name", "mtl")
    dissolve = raw.get("d", 1.0 if "Tr" not in raw else 1.0 - raw["Tr"])
    illum = raw.get("illum", 2)
    transmissive = dissolve < 1.0 or illum in (4, 6, 7, 9)
    if transmissive:
        return GlassParams(
            base_color=tuple(raw.get("Tf", raw.get("Kd", (1.0, 1.0, 1.0)))),
            roughness=raw.get("Pr", 0.0),
            ior=raw.get("Ni", 1.5),
            density=max(0.0, 1.0 - dissolve),
            name=name,
        )
    # PBR: prefer PBR extension keys (Pr/Pm), fall back to classic Phong
    # mappings (shininess -> roughness).
    if "Pr" in raw:
        roughness = raw["Pr"]
    elif "Ns" in raw:
        roughness = float(np.clip(1.0 - np.sqrt(raw["Ns"]) / 31.62, 0.0, 1.0))
    else:
        roughness = 1.0
    return PBRParams(
        base_color=tuple(raw.get("Kd", (1.0, 1.0, 1.0))),
        emissive=tuple(raw.get("Ke", (0.0, 0.0, 0.0))),
        metallic=raw.get("Pm", 0.0),
        roughness=roughness,
        specular_f0=0.5,
        clearcoat=raw.get("Pc", 0.0),
        clearcoat_roughness=raw.get("Pcr", 0.0),
        name=name,
    )


def load_obj(
    path: str, scale: float = 1.0
) -> Tuple[List[MeshData], List[object]]:
    """Load an OBJ file -> (meshes, materials), one mesh per used material
    (a file without ``usemtl``: one mesh and a default material, both named
    after the file).

    Faces are fan-triangulated like the original renderer
    (``AssimpMeshProvider.cpp:270-278``); cm->m unit scaling is the caller's
    ``scale`` (``:692``).
    """
    with open(path, "rb") as f:
        raw = f.read()
    if b"usemtl" not in raw:
        return _from_native(native.parse_obj(raw), path, scale)
    return _load_python(path, scale)


def _load_python(path: str, scale: float) -> Tuple[List[MeshData], List[object]]:
    """``load_obj`` through a Python loop over the lines, for files with
    material groups (and, in the tests, without)."""
    positions: List[List[float]] = []
    normals: List[List[float]] = []
    uvs: List[List[float]] = []
    # Per-material corner lists of (pos_idx, uv_idx, nrm_idx).
    groups: Dict[str, List[Tuple[int, int, int]]] = {}
    current_mtl = ""
    grouped = False
    mtl_files: List[str] = []

    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "v":
                positions.append([float(v) for v in parts[1:4]])
            elif key == "vn":
                normals.append([float(v) for v in parts[1:4]])
            elif key == "vt":
                uvs.append([float(v) for v in parts[1:3]])
            elif key == "mtllib":
                mtl_files.append(" ".join(parts[1:]))
            elif key == "usemtl":
                current_mtl = parts[1] if len(parts) > 1 else ""
                grouped = True
            elif key == "f":
                corners = []
                for corner in parts[1:]:
                    ids = corner.split("/")
                    vi = int(ids[0])
                    ti = int(ids[1]) if len(ids) > 1 and ids[1] else 0
                    ni = int(ids[2]) if len(ids) > 2 and ids[2] else 0
                    # OBJ indices are 1-based; negatives count from the end.
                    vi = vi - 1 if vi > 0 else len(positions) + vi
                    ti = ti - 1 if ti > 0 else (len(uvs) + ti if ti else -1)
                    ni = ni - 1 if ni > 0 else (len(normals) + ni if ni else -1)
                    corners.append((vi, ti, ni))
                tris = groups.setdefault(current_mtl, [])
                for k in range(1, len(corners) - 1):  # fan triangulation
                    tris.extend([corners[0], corners[k], corners[k + 1]])

    raw_mtls: Dict[str, dict] = {}
    if grouped:
        base = os.path.dirname(path)
        for mtl in mtl_files:
            raw_mtls.update(parse_mtl(os.path.join(base, mtl)))
    file_name = os.path.splitext(os.path.basename(path))[0]

    pos_arr = np.asarray(positions, np.float32).reshape(-1, 3) * np.float32(scale)
    nrm_arr = np.asarray(normals, np.float32) if normals else None
    uv_arr = np.asarray(uvs, np.float32) if uvs else None

    meshes: List[MeshData] = []
    materials: List[object] = []
    for mtl_name, corners in groups.items():
        if not corners:
            continue
        # A compact vertex buffer per group, keyed by the corner tuple.
        flat = np.asarray(corners, np.int64).reshape(-1, 3)
        uniq, inverse = np.unique(flat, axis=0, return_inverse=True)
        uv = (uv_arr[np.maximum(uniq[:, 1], 0)] if uv_arr is not None
              else np.zeros((len(uniq), 2), np.float32))
        nrm = (nrm_arr[np.maximum(uniq[:, 2], 0)]
               if nrm_arr is not None and (uniq[:, 2] >= 0).all() else None)
        name = (mtl_name or "default") if grouped else file_name
        meshes.append(
            MeshData(
                positions=pos_arr[uniq[:, 0]], indices=inverse.reshape(-1, 3).astype(np.int32),
                normals=nrm, uvs=uv, name=name,
            )
        )
        if mtl_name in raw_mtls:
            materials.append(mtl_to_material(raw_mtls[mtl_name]))
        else:
            materials.append(PBRParams(name=name))
    return meshes, materials


def _from_native(parsed, path: str, scale: float):
    """One mesh and its default material, both named after the file, from
    ``native.parse_obj``'s streams and corner references."""
    v, vt, vn, fv, ft, fn = parsed
    if fv.shape[0] == 0:
        return [], []
    corners = np.stack([fv, ft, fn], axis=-1).reshape(-1, 3)  # (3T, ids)
    uniq, inverse = np.unique(corners, axis=0, return_inverse=True)
    uv = (vt[np.maximum(uniq[:, 1], 0)] if vt.shape[0]
          else np.zeros((len(uniq), 2), np.float32))
    nrm = (vn[np.maximum(uniq[:, 2], 0)]
           if vn.shape[0] and (uniq[:, 2] >= 0).all() else None)
    name = os.path.splitext(os.path.basename(path))[0]
    mesh = MeshData(positions=v[uniq[:, 0]] * np.float32(scale),
                    indices=inverse.reshape(-1, 3).astype(np.int32), normals=nrm, uvs=uv,
                    name=name)
    return [mesh], [PBRParams(name=name)]
