"""Material table for PBR and glass materials (port of
``heatray_tpu.scene.materials``).

Parameters are conditioned exactly as ``PhysicallyBasedMaterial::modify``
and ``GlassMaterial::modify`` do, and packed into one flat table that the
shader indexes by per-triangle material id.  Texture slots hold atlas
texture ids (``scene.textures``), -1 = unused.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

KIND_PBR = 0
KIND_GLASS = 1

MIN_ROUGHNESS = 0.01
MAX_SPECULAR_F0 = 0.08
MAX_CLEARCOAT = 0.2

TEXTURE_SLOTS = (
    "base_color_tex", "metallic_roughness_tex", "emissive_tex", "normal_tex",
    "clearcoat_tex", "clearcoat_roughness_tex", "clearcoat_normal_tex",
)


@dataclasses.dataclass
class PBRParams:
    """User-facing PBR parameters (``PhysicallyBasedMaterial.h:22-41``);
    texture fields are atlas texture ids, -1 = unused.  ``alpha_masked``
    is the ALPHA_MASK variant: texels whose base-colour alpha is below 1
    pass the ray through, and the geometry does not occlude shadow rays
    (``Mesh.cpp:95-100``)."""

    base_color: tuple = (1.0, 1.0, 1.0)
    emissive: tuple = (0.0, 0.0, 0.0)
    metallic: float = 0.0
    roughness: float = 1.0
    specular_f0: float = 0.5  # raw slider value; conditioned by * 0.08
    clearcoat: float = 0.0  # raw slider value; conditioned by * 0.2
    clearcoat_roughness: float = 0.0
    double_sided: bool = False
    base_color_tex: int = -1
    metallic_roughness_tex: int = -1
    emissive_tex: int = -1
    normal_tex: int = -1
    clearcoat_tex: int = -1
    clearcoat_roughness_tex: int = -1
    clearcoat_normal_tex: int = -1
    alpha_masked: bool = False
    name: str = "pbr"


@dataclasses.dataclass
class GlassParams:
    """User-facing glass parameters (``GlassMaterial.h``); glass samples
    base-colour, metallic-roughness (g = roughness) and normal textures
    (``glass.rlsl:145-175``)."""

    base_color: tuple = (1.0, 1.0, 1.0)
    roughness: float = 0.0
    ior: float = 1.5
    density: float = 0.0  # Beer's-law absorption density
    base_color_tex: int = -1
    metallic_roughness_tex: int = -1
    normal_tex: int = -1
    name: str = "glass"


@dataclasses.dataclass
class MaterialTable:
    """Conditioned material parameters: (M,) or planar (3, M) tensors."""

    kind: torch.Tensor  # (M,) i32: 0 = PBR, 1 = glass
    base_color: torch.Tensor  # (3, M)
    emissive: torch.Tensor  # (3, M)
    metallic: torch.Tensor
    roughness: torch.Tensor  # >= MIN_ROUGHNESS
    roughness_alpha: torch.Tensor  # roughness^2
    specular_f0: torch.Tensor
    clearcoat: torch.Tensor
    clearcoat_roughness: torch.Tensor
    clearcoat_roughness_alpha: torch.Tensor
    ior: torch.Tensor
    density: torch.Tensor
    double_sided: torch.Tensor  # (M,) i32
    base_color_tex: torch.Tensor  # (M,) i32 texture ids, -1 = unused
    metallic_roughness_tex: torch.Tensor
    emissive_tex: torch.Tensor
    normal_tex: torch.Tensor
    clearcoat_tex: torch.Tensor
    clearcoat_roughness_tex: torch.Tensor
    clearcoat_normal_tex: torch.Tensor
    alpha_mask: torch.Tensor  # (M,) i32

    @property
    def num_materials(self) -> int:
        return self.kind.shape[0]


def build_material_table(materials: List) -> MaterialTable:
    """Condition and pack a list of PBRParams / GlassParams."""
    m = len(materials)
    out = {f.name: np.zeros(m, np.float32) for f in dataclasses.fields(MaterialTable)}
    out["kind"] = np.zeros(m, np.int32)
    out["base_color"] = np.zeros((m, 3), np.float32)
    out["emissive"] = np.zeros((m, 3), np.float32)
    out["ior"] = np.ones(m, np.float32)
    out["double_sided"] = np.zeros(m, np.int32)
    out["alpha_mask"] = np.zeros(m, np.int32)
    for slot in TEXTURE_SLOTS:
        out[slot] = np.full(m, -1, np.int32)
    for i, mat in enumerate(materials):
        if isinstance(mat, PBRParams):
            # ``PhysicallyBasedMaterial.cpp:133-145``
            rough = max(max(min(float(mat.roughness), 1.0), 0.0), MIN_ROUGHNESS)
            cc_rough = max(max(min(float(mat.clearcoat_roughness), 1.0), 0.0), MIN_ROUGHNESS)
            out["kind"][i] = KIND_PBR
            out["base_color"][i] = np.clip(mat.base_color, 0.0, 1.0)
            out["emissive"][i] = np.clip(mat.emissive, 0.0, 1.0)
            out["metallic"][i] = max(min(float(mat.metallic), 1.0), 0.0)
            out["roughness"][i] = rough
            out["roughness_alpha"][i] = rough * rough
            out["specular_f0"][i] = float(mat.specular_f0) * MAX_SPECULAR_F0
            out["clearcoat"][i] = float(mat.clearcoat) * MAX_CLEARCOAT
            out["clearcoat_roughness"][i] = cc_rough
            out["clearcoat_roughness_alpha"][i] = cc_rough * cc_rough
            out["double_sided"][i] = int(bool(mat.double_sided))
            out["alpha_mask"][i] = int(bool(mat.alpha_masked))
            for slot in TEXTURE_SLOTS:
                out[slot][i] = int(getattr(mat, slot))
        elif isinstance(mat, GlassParams):
            # ``GlassMaterial.cpp:90-104``
            rough = max(max(min(float(mat.roughness), 1.0), 0.0), MIN_ROUGHNESS)
            ior = max(0.0, float(mat.ior))
            f0 = abs((1.0 - ior) / (1.0 + ior))
            out["kind"][i] = KIND_GLASS
            out["base_color"][i] = np.clip(mat.base_color, 0.0, 1.0)
            out["roughness"][i] = rough
            out["roughness_alpha"][i] = rough * rough
            out["specular_f0"][i] = f0 * f0
            out["ior"][i] = ior
            out["density"][i] = float(mat.density)
            out["double_sided"][i] = 1  # glass shades both faces
            for slot in ("base_color_tex", "metallic_roughness_tex", "normal_tex"):
                out[slot][i] = int(getattr(mat, slot))
        else:
            raise TypeError(f"unknown material type: {type(mat)}")
    out["base_color"] = np.ascontiguousarray(out["base_color"].T)
    out["emissive"] = np.ascontiguousarray(out["emissive"].T)
    return MaterialTable(**{k: torch.from_numpy(v) for k, v in out.items()})
