"""Debug visualization AOVs (port of ``heatray_tpu.render.aov``).

The reference's visualizer modes (``PassGenerator.h:123-141``; shader
branches ``physicallyBased.rlsl:159-203``, ``glass.rlsl:179-211``; the
accumulator's NaN and Inf detectors ``accumulator.rlsl:16-21``).  Surface
AOVs evaluate at the primary hit from the gathered shading rows, which
carry the texture tail; the NaN and Inf modes transform each contribution
of the main render instead (see ``integrator``).
"""

from __future__ import annotations

import torch

from ..options import AOV
from ..scene.scene import Scene
from ..scene.textures import sample_atlas
from ..vec import Vec3
from . import shade_table as st

SURFACE_AOVS = {
    AOV.GEOMETRIC_NORMALS,
    AOV.UVS,
    AOV.TANGENTS,
    AOV.BITANGENTS,
    AOV.NORMALMAP,
    AOV.FINAL_NORMALS,
    AOV.BASE_COLOR,
    AOV.EMISSIVE,
    AOV.ROUGHNESS,
    AOV.METALLIC,
    AOV.CLEARCOAT,
    AOV.CLEARCOAT_ROUGHNESS,
    AOV.CLEARCOAT_NORMALMAP,
    AOV.SHADER,
}

ACCUM_AOVS = {AOV.NANS, AOV.INFS}


def compute_surface_aov(scene: Scene, mode: AOV, rows: st.HitRows, b1, b2, front, hit) -> Vec3:
    """The AOV's colour at the primary hit (zero on a miss); ``rows`` must
    carry the texture tail."""
    w0 = 1.0 - b1 - b2
    is_glass = rows.col(st.KIND) > 0.5

    if mode == AOV.GEOMETRIC_NORMALS:
        value = (rows.interp_vec(st.N0, w0, b1, b2).normalized() + 1.0) * 0.5
    elif mode == AOV.FINAL_NORMALS:
        n = rows.interp_vec(st.N0, w0, b1, b2).normalized()
        flip = (~front) & ((rows.col(st.DOUBLE_SIDED) > 0.5) | is_glass)
        value = (Vec3.where(flip, -n, n) + 1.0) * 0.5
    elif mode == AOV.UVS:
        u, v = rows.interp_uv(w0, b1, b2)
        value = Vec3(u, v, torch.zeros_like(u))
    elif mode == AOV.TANGENTS:
        value = (rows.interp_vec(st.TAN0, w0, b1, b2).normalized() + 1.0) * 0.5
    elif mode == AOV.BITANGENTS:
        value = (rows.interp_vec(st.BTN0, w0, b1, b2).normalized() + 1.0) * 0.5
    elif mode == AOV.BASE_COLOR:
        value = rows.vec(st.BASE_COLOR) * rows.interp_vec(st.COL0, w0, b1, b2)
    elif mode == AOV.EMISSIVE:
        value = rows.vec(st.EMISSIVE)
    elif mode == AOV.ROUGHNESS:
        value = Vec3.splat(rows.col(st.ROUGHNESS))
    elif mode == AOV.METALLIC:
        value = Vec3.splat(rows.col(st.METALLIC))
    elif mode == AOV.CLEARCOAT:
        # The raw (conditioned) clearcoat scalar, as the reference shows it.
        value = Vec3.splat(rows.col(st.CLEARCOAT))
    elif mode == AOV.CLEARCOAT_ROUGHNESS:
        value = Vec3.splat(rows.col(st.CC_ROUGH))
    elif mode in (AOV.NORMALMAP, AOV.CLEARCOAT_NORMALMAP):
        # The raw texel (``physicallyBased.rlsl:175-176,198-199``); black
        # where the material lacks the map (the shader branch is compiled out).
        if scene.has_textures:
            u, v = rows.interp_uv(w0, b1, b2)
            tex = rows.icol(st.NM_TEX if mode == AOV.NORMALMAP else st.CCN_TEX)
            r, g, b, _ = sample_atlas(scene.atlas, tex, u, v)
            value = Vec3.where(tex >= 0, Vec3(r, g, b), 0.0)
        else:
            value = Vec3.zeros(b1.shape, device=b1.device)
    elif mode == AOV.SHADER:
        # PBR red, glass green (``physicallyBased.rlsl:195``, ``glass.rlsl:191``).
        g = torch.where(is_glass, 1.0, 0.0)
        value = Vec3(1.0 - g, g, torch.zeros_like(g))
    else:
        raise ValueError(f"not a surface AOV: {mode}")
    return Vec3.where(hit, value, 0.0)


def accum_visualize(mode: AOV, color: Vec3) -> Vec3:
    """The NaN and Inf detectors (``accumulator.rlsl:16-21``): an offending
    contribution shows as 100, any other dims to ``min(c, 1) * 0.1``."""
    if mode == AOV.NANS:
        test = torch.isnan
    elif mode == AOV.INFS:
        test = torch.isinf
    else:
        raise ValueError(f"not an accumulator AOV: {mode}")
    bad = test(color.x) | test(color.y) | test(color.z)
    return Vec3.where(bad, 100.0, color.minimum(1.0) * 0.1)
