"""Unified surface shading: PBR (roughness, metallic, clearcoat,
multiscatter) and rough glass with Beer absorption, evaluated branchlessly
per ray and selected by material kind.

Port of ``heatray_tpu.render.shade``, which ports the estimator of
``physicallyBased.rlsl``, ``glass.rlsl`` and ``microfacet.rlsl``: one NEE
shadow ray and one extension ray per hit, luminance-weighted lobe and light
selection with the environment as the fall-through, Russian roulette above
``rr_start_depth``, QMC draws from five consecutive sequences per bounce,
and, for a scene with textures, the seven PBR texture slots, normal and
clearcoat-normal maps and alpha masking (``physicallyBased.rlsl:56-157``),
sampled from the atlas with gathers (trilinear along a ray cone).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from ..sampling.qmc_fly import sobol_value
from ..sampling.tables import SampleTables, get_sequence_value
from ..scene.lights import LIGHT_TYPE_ENVIRONMENT, LIGHT_TYPE_NONE
from ..scene.scene import Scene
from ..scene.textures import sample_atlas
from ..vec import Vec3, clip
from . import brdf, shade_table as st
from .bsdf_sampling import cosine_weighted_sample, refract, sample_visible_ggx
from .envmap import env_radiance
from .light_sampling import compute_light_sample
from .multiscatter import compute_multiscattering, compute_multiscattering_fit
from .onb import (
    frame_to_world,
    greater_than_zero,
    luminosity,
    orthonormal_frame,
    saturate,
    world_to_frame,
)

_EMIT_EPS = 1e-5  # ``dot(w, w) > 1e-5`` thresholds


@dataclasses.dataclass
class ShadeResult:
    """Outputs of shading one wavefront of hits ((R,) tensors / Vec3s)."""

    emission: Vec3
    shadow_dir: Vec3
    shadow_weight: Vec3
    shadow_radiance: Vec3
    shadow_max_t: torch.Tensor
    shadow_active: torch.Tensor
    ext_dir: Vec3
    ext_weight: Vec3
    ext_env_on_miss: torch.Tensor
    ext_active: torch.Tensor


def make_sequence_lookup(tables: SampleTables, sample_mode: str):
    """``(seq, idx) -> (u, v)``: the Sobol chain recomputed for "sobol",
    a table gather otherwise."""
    if sample_mode == "sobol":
        s, length = tables.num_sequences, tables.sequence_length
        return lambda seq, idx: sobol_value(seq, idx, s, length)
    return lambda seq, idx: get_sequence_value(tables, seq, idx)


def shade_hits(
    scene: Scene,
    tables: SampleTables,
    sample_index: int,
    depth: int,
    org: Vec3,
    ray_dir: Vec3,
    weight: Vec3,
    env_on_miss,
    seq_id,
    seq_off,
    rows: st.HitRows,
    t,
    b1,
    b2,
    front,
    active,
    max_ray_depth: int,
    rr_start_depth: int = 3,
    sample_mode: str = "sobol",
    footprint_world=None,
    ms_impl: str = "fit",
    ms_lut=None,
) -> ShadeResult:
    """Shade one wavefront of surface hits, masked by ``active``.

    ``footprint_world`` (R,) is the ray cone's width at the hit (world
    units); with it, texture fetches are trilinear mip samples
    (``Texture.h:51``).  ``ms_impl`` "lut" takes the multiscatter factor
    from ``ms_lut`` (``multiscatter_lut_packed``), "fit" from the fit."""
    lights = scene.lights

    def multiscatter(c_spec, n_dot, rough):
        if ms_impl == "fit":
            return compute_multiscattering_fit(c_spec, n_dot, rough)
        return compute_multiscattering(ms_lut, c_spec, n_dot, rough)

    w0 = 1.0 - b1 - b2
    p = org + ray_dir * t
    n_shading = rows.interp_vec(st.N0, w0, b1, b2).normalized()
    vtx_color = rows.interp_vec(st.COL0, w0, b1, b2)

    is_glass = rows.col(st.KIND) > 0.5
    base_color = rows.vec(st.BASE_COLOR) * vtx_color
    emissive_c = rows.vec(st.EMISSIVE)
    metallic = rows.col(st.METALLIC)
    roughness = rows.col(st.ROUGHNESS)
    alpha = rows.col(st.ROUGHNESS_ALPHA)
    spec_f0 = rows.col(st.SPECULAR_F0)
    clearcoat = rows.col(st.CLEARCOAT)
    cc_rough = rows.col(st.CC_ROUGH)
    cc_alpha = rows.col(st.CC_ALPHA)
    ior = rows.col(st.IOR)
    density = rows.col(st.DENSITY)
    double_sided = rows.col(st.DOUBLE_SIDED) > 0.5

    # --- Textures (``physicallyBased.rlsl:56-157``, ``glass.rlsl:145-175``),
    # left out for a scene without textures.
    alpha_texel = torch.ones_like(t)
    if scene.has_textures:
        uv_u, uv_v = rows.interp_uv(w0, b1, b2)
        atlas = scene.atlas
        # The ray cone's footprint in UV units; the 1/cos widens it at
        # grazing incidence (an isotropic stand-in for the ellipse).
        uv_fp = None
        if footprint_world is not None:
            cos_in = torch.abs(rows.vec(st.GEO_N).dot(ray_dir))
            uv_fp = footprint_world * rows.col(st.UV_DENSITY) / clip(cos_in, 0.05)
        sample_tx = functools.partial(sample_atlas, footprint=uv_fp)

        bc_tex = rows.icol(st.BC_TEX)
        has_bc = bc_tex >= 0
        bcr, bcg, bcb, bca = sample_tx(atlas, bc_tex, uv_u, uv_v)
        base_color = base_color * Vec3.where(has_bc, Vec3(bcr, bcg, bcb), 1.0)
        alpha_texel = torch.where(has_bc, bca, 1.0)

        mr_tex = rows.icol(st.MR_TEX)
        has_mr = mr_tex >= 0
        _, mr_g, mr_b, _ = sample_tx(atlas, mr_tex, uv_u, uv_v)
        metallic = torch.where(has_mr, metallic * mr_b, metallic)
        roughness = torch.where(has_mr, roughness * mr_g, roughness)
        alpha = torch.where(has_mr, roughness * roughness, alpha)

        em_tex = rows.icol(st.EM_TEX)
        em_r, em_g, em_b, _ = sample_tx(atlas, em_tex, uv_u, uv_v)
        # The texture replaces the emissive colour (``:154-157``).
        emissive_c = Vec3.where(em_tex >= 0, Vec3(em_r, em_g, em_b), emissive_c)

        cc_tex = rows.icol(st.CC_TEX)
        ccr_tex = rows.icol(st.CCR_TEX)
        cc_texel = sample_tx(atlas, cc_tex, uv_u, uv_v, num_channels=1)[0]
        ccr_texel = sample_tx(atlas, ccr_tex, uv_u, uv_v, num_channels=1)[0]
        clearcoat = torch.where(cc_tex >= 0, clearcoat * cc_texel, clearcoat)
        cc_rough = torch.where(ccr_tex >= 0, cc_rough * ccr_texel, cc_rough)
        cc_alpha = torch.where(ccr_tex >= 0, cc_rough * cc_rough, cc_alpha)

    v = -ray_dir

    # --- Face orientation: double-sided PBR and glass flip N on backface;
    # single-sided PBR backface hits, and alpha-masked PBR texels whose
    # alpha is below 1 (``physicallyBased.rlsl:70-91``), pass the ray
    # through unchanged.
    flip = (~front) & (double_sided | is_glass)
    n = Vec3.where(flip, -n_shading, n_shading)
    alpha_passthrough = (rows.col(st.ALPHA_MASK) > 0.5) & (alpha_texel < 1.0) & (~is_glass)
    pbr_passthrough = ((~front) & (~double_sided) & (~is_glass)) | alpha_passthrough

    cc_n = n
    if scene.has_textures:
        # --- Normal mapping (``physicallyBased.rlsl:110-126``); the
        # clearcoat normal comes from the normal before the map (:111, 119-126).
        nm_tex = rows.icol(st.NM_TEX)
        ccn_tex = rows.icol(st.CCN_TEX)
        tang = rows.interp_vec(st.TAN0, w0, b1, b2).normalized()
        bitang = rows.interp_vec(st.BTN0, w0, b1, b2).normalized()
        nm_r, nm_g, nm_b, _ = sample_tx(atlas, nm_tex, uv_u, uv_v)
        ts = Vec3(nm_r, nm_g, nm_b) * 2.0 - 1.0
        n_mapped = (tang * ts.x + bitang * ts.y + n * ts.z).normalized()
        ccn_r, ccn_g, ccn_b, _ = sample_tx(atlas, ccn_tex, uv_u, uv_v)
        cts = Vec3(ccn_r, ccn_g, ccn_b) * 2.0 - 1.0
        cc_n = Vec3.where(ccn_tex >= 0, (tang * cts.x + bitang * cts.y + n * cts.z).normalized(), n)
        n = Vec3.where(nm_tex >= 0, n_mapped, n)

    # Glass Beer's-law absorption when exiting the medium.
    beer = ((1.0 - base_color) * (-density * t)).exp()
    glass_weight = Vec3.where(is_glass & ~front, weight * beer, weight)

    # --- QMC draws: 5 consecutive sequences ------------------------------
    seq_lookup = make_sequence_lookup(tables, sample_mode)
    sidx = sample_index + seq_off
    rnd_u, rnd_v = [], []
    for k in range(5):
        u, vv = seq_lookup(seq_id + depth + k, sidx)
        rnd_u.append(u)
        rnd_v.append(vv)

    fx, fz = orthonormal_frame(n)
    n_dot_v = saturate(n.dot(v))

    # ======================================================================
    # PBR lobes (``physicallyBased.rlsl:205-330``)
    # ======================================================================
    cc_n_dot_v = saturate(cc_n.dot(v))
    cc_scale = brdf.f_schlick(0.04, cc_n_dot_v) * clearcoat
    bottom = 1.0 - cc_scale

    c_diff = base_color * ((1.0 - metallic) * bottom)
    c_spec = (Vec3.splat(spec_f0) + (base_color - spec_f0) * metallic) * bottom

    diff_lum = luminosity(c_diff)
    spec_lum = luminosity(c_spec)
    p_norm = 1.0 / greater_than_zero(diff_lum + spec_lum + cc_scale)
    p_diff = diff_lum * p_norm
    p_spec = spec_lum * p_norm
    p_cc = cc_scale * p_norm

    def select_lobe(u):
        """Lobe pick in reference order: diffuse, clearcoat, specular."""
        sel_d = u <= p_diff
        sel_c = (~sel_d) & (u <= p_diff + p_cc)
        sel_s = (~sel_d) & (~sel_c) & (u <= p_diff + p_cc + p_spec)
        return sel_d, sel_c, sel_s

    def spec_lobe_params(sel_c):
        a = torch.where(sel_c, cc_alpha, alpha)
        rough = torch.where(sel_c, cc_rough, roughness)
        cs = Vec3.where(sel_c, Vec3.splat(cc_scale), c_spec)
        lobe_p = torch.where(sel_c, p_cc, p_spec)
        return a, rough, cs, lobe_p

    local_v = world_to_frame(v, fx, n, fz)

    # ---- PBR direct (NEE) ------------------------------------------------
    sel_d, sel_c, sel_s = select_lobe(rnd_u[1])
    ls = compute_light_sample(lights, n, p, rnd_v[1])
    env_sel = ls.light_type == LIGHT_TYPE_ENVIRONMENT

    a_sp, rough_sp, cs_sp, lobep_sp = spec_lobe_params(sel_c)
    ms = multiscatter(cs_sp, n_dot_v, rough_sp)

    # Punctual branch: the BRDF toward the chosen light.
    l_dir = ls.direction
    n_dot_l = n.dot(l_dir)
    h = (v + l_dir).normalized()
    n_dot_h = saturate(n.dot(h))
    i_dot_h = saturate(v.dot(h))
    f_diff_punct = c_diff * (saturate(n_dot_l) / math.pi)
    d_term = brdf.d_ggx(n_dot_h, a_sp)
    f_term = brdf.f_schlick(cs_sp, i_dot_h)
    g_term = brdf.g2_smith_ggx(saturate(n_dot_l), n_dot_v, a_sp)
    f_spec_punct = (f_term * (d_term * g_term / greater_than_zero(4.0 * n_dot_v))) * ms
    f_punct = Vec3.where(sel_d, f_diff_punct, f_spec_punct)
    lobe_p_sel = torch.where(sel_d, p_diff, lobep_sp)
    sw_punct = (
        f_punct
        * weight
        * (1.0 / greater_than_zero(lobe_p_sel))
        * (1.0 / greater_than_zero(ls.probability))
    )
    punct_ok = (
        (~env_sel)
        & (ls.light_type != LIGHT_TYPE_NONE)
        & (n_dot_l > 0.0)
        & (sel_d | sel_c | sel_s)
    )

    # Environment branch: sample the BSDF, occlusion-test toward the env.
    o_diff = frame_to_world(*cosine_weighted_sample(rnd_u[0], rnd_v[0]), fx, n, fz)
    h_env = frame_to_world(*sample_visible_ggx(local_v, rnd_u[0], rnd_v[0], a_sp), fx, n, fz)
    i_dot_h_env = saturate(v.dot(h_env))
    o_spec = (h_env * (2.0 * i_dot_h_env) - v).normalized()
    o_env = Vec3.where(sel_d, o_diff, o_spec)
    n_dot_o_env = n.dot(o_env)
    f_env = brdf.f_schlick(cs_sp, i_dot_h_env)
    g2 = brdf.g2_smith_ggx(n_dot_v, saturate(n_dot_o_env), a_sp)
    g1 = brdf.g1_smith_ggx(n_dot_v, a_sp)
    w_spec_env = f_env * (g2 / greater_than_zero(g1)) * ms
    w_env_lobe = Vec3.where(sel_d, c_diff, w_spec_env)
    sw_env = (
        w_env_lobe
        * weight
        * (1.0 / greater_than_zero(lobe_p_sel))
        * (1.0 / greater_than_zero(ls.probability))
    )
    env_ok = env_sel & (ls.probability > 0.0) & (n_dot_o_env > 0.0) & (sel_d | sel_c | sel_s)

    pbr_shadow_dir = Vec3.where(env_sel, o_env, l_dir)
    pbr_shadow_w = Vec3.where(env_sel, sw_env, sw_punct)
    pbr_shadow_rad = Vec3.where(env_sel, env_radiance(lights, o_env), ls.radiance)
    pbr_shadow_maxt = torch.where(env_sel, 3.0e37, ls.max_distance)
    pbr_shadow_ok = torch.where(env_sel, env_ok, punct_ok)

    # ---- PBR indirect: Russian roulette, then a lobe sample ---------------
    rr_p = weight.max_component()
    rr_on = depth > rr_start_depth
    rr_kill = rr_on & (rnd_u[2] >= rr_p)
    ind_weight = Vec3.where(rr_on & ~rr_kill, weight * (1.0 / greater_than_zero(rr_p)), weight)

    isel_d, isel_c, isel_s = select_lobe(rnd_u[4])
    a_isp, rough_isp, cs_isp, lobep_isp = spec_lobe_params(isel_c)
    ms_i = multiscatter(cs_isp, n_dot_v, rough_isp)

    io_diff = frame_to_world(*cosine_weighted_sample(rnd_u[3], rnd_v[3]), fx, n, fz)
    ih = frame_to_world(*sample_visible_ggx(local_v, rnd_u[3], rnd_v[3], a_isp), fx, n, fz)
    i_dot_ih = saturate(v.dot(ih))
    io_spec = (ih * (2.0 * i_dot_ih) - v).normalized()
    io = Vec3.where(isel_d, io_diff, io_spec)
    n_dot_io = n.dot(io)
    fi = brdf.f_schlick(cs_isp, i_dot_ih)
    g2i = brdf.g2_smith_ggx(n_dot_v, saturate(n_dot_io), a_isp)
    g1i = brdf.g1_smith_ggx(n_dot_v, a_isp)
    iw_spec = fi * (g2i / greater_than_zero(g1i)) * ms_i
    iw_lobe = Vec3.where(isel_d, c_diff, iw_spec)
    ilobe_p = torch.where(isel_d, p_diff, lobep_isp)
    pbr_ext_w = ind_weight * iw_lobe * (1.0 / greater_than_zero(ilobe_p))
    pbr_ext_ok = (~rr_kill) & (n_dot_io > 0.0) & (isel_d | isel_c | isel_s)

    pbr_emission = weight * emissive_c

    # ======================================================================
    # Glass (``glass.rlsl:138-280``)
    # ======================================================================
    eta = torch.where(front, 1.0 / greater_than_zero(ior), ior)
    gw = glass_weight

    gh = frame_to_world(*sample_visible_ggx(local_v, rnd_u[0], rnd_v[0], alpha), fx, n, fz)
    fres = brdf.f_fresnel(eta, saturate(gh.dot(v)))
    refract_u = torch.where(front, rnd_v[1], 0.0)  # inside: force refract
    do_refract = refract_u < (1.0 - fres)
    g_n_dot_i = saturate(n_dot_v)

    # Refraction: transmission = baseColor * G2/G1.
    o_refr = refract(-v, gh, eta)
    o_refr_len = o_refr.norm()
    o_refr = o_refr * (1.0 / greater_than_zero(o_refr_len))
    n_dot_or = torch.abs(n.dot(o_refr))
    g2g = brdf.g2_smith_ggx(g_n_dot_i, n_dot_or, alpha)
    g1g = brdf.g1_smith_ggx(g_n_dot_i, alpha)
    trans_w = base_color * (g2g / greater_than_zero(g1g)) * gw
    refr_ok = do_refract & (o_refr_len > 1e-8)

    # Reflection direct: light probability refractProbability.x, the env
    # fallback microfacet from a fresh rand (k2).
    g_ls = compute_light_sample(lights, n, p, rnd_u[1])
    g_env_sel = g_ls.light_type == LIGHT_TYPE_ENVIRONMENT
    gl_dir = g_ls.direction
    g_n_dot_l = n.dot(gl_dir)
    gh2 = (v + gl_dir).normalized()
    gd = brdf.d_ggx(saturate(n.dot(gh2)), alpha)
    gg = brdf.g2_smith_ggx(saturate(g_n_dot_l), g_n_dot_i, alpha)
    g_spec = gd * gg / greater_than_zero(4.0 * g_n_dot_i)
    g_sw_punct = base_color * (g_spec / greater_than_zero(g_ls.probability)) * gw
    g_punct_ok = (~g_env_sel) & (g_n_dot_l > 0.0) & (~do_refract)

    gh3 = frame_to_world(*sample_visible_ggx(local_v, rnd_u[2], rnd_v[2], alpha), fx, n, fz)
    gi_dot_h3 = saturate(v.dot(gh3))
    go3 = (gh3 * (2.0 * gi_dot_h3) - v).normalized()
    g_n_dot_o3 = n.dot(go3)
    g_n_dot_h3 = saturate(n.dot(gh3))
    gg3 = brdf.g2_smith_ggx(saturate(g_n_dot_o3), g_n_dot_i, alpha)
    # Reference weight baseColor * (G * IdotH) / (NdotH * NdotI): a VNDF
    # sample weighted with the plain-NDF PDF, kept for parity.
    g_w3 = (
        base_color
        * (gg3 * gi_dot_h3 / greater_than_zero(g_n_dot_h3 * g_n_dot_i))
        * gw
        * (1.0 / greater_than_zero(g_ls.probability))
    )
    g_env_ok = g_env_sel & (g_ls.probability > 0.0) & (g_n_dot_o3 > 0.0) & (~do_refract)

    glass_shadow_dir = Vec3.where(g_env_sel, go3, gl_dir)
    glass_shadow_w = Vec3.where(g_env_sel, g_w3, g_sw_punct)
    glass_shadow_rad = Vec3.where(g_env_sel, env_radiance(lights, go3), g_ls.radiance)
    glass_shadow_maxt = torch.where(g_env_sel, 3.0e37, g_ls.max_distance)
    glass_shadow_ok = torch.where(g_env_sel, g_env_ok, g_punct_ok)

    # Reflection indirect: RR with k3, sample k4.
    g_rr_p = gw.max_component()
    g_rr_kill = rr_on & (rnd_u[3] >= g_rr_p)
    g_ind_w = Vec3.where(rr_on & ~g_rr_kill, gw * (1.0 / greater_than_zero(g_rr_p)), gw)
    gh4 = frame_to_world(*sample_visible_ggx(local_v, rnd_u[4], rnd_v[4], alpha), fx, n, fz)
    gi_dot_h4 = saturate(v.dot(gh4))
    go4 = (gh4 * (2.0 * gi_dot_h4) - v).normalized()
    g_n_dot_o4 = n.dot(go4)
    g_n_dot_h4 = saturate(n.dot(gh4))
    gg4 = brdf.g2_smith_ggx(saturate(g_n_dot_o4), g_n_dot_i, alpha)
    g_w4 = base_color * (gg4 * gi_dot_h4 / greater_than_zero(g_n_dot_h4 * g_n_dot_i)) * g_ind_w
    g_refl_ext_ok = (~do_refract) & (~g_rr_kill) & (g_n_dot_o4 > 0.0)

    glass_ext_dir = Vec3.where(do_refract, o_refr, go4)
    glass_ext_w = Vec3.where(do_refract, trans_w, g_w4)
    glass_ext_ok = torch.where(do_refract, refr_ok, g_refl_ext_ok)

    # ======================================================================
    # Combine PBR / glass / passthrough
    # ======================================================================
    emission = Vec3.where(is_glass, 0.0, pbr_emission)
    shadow_dir = Vec3.where(is_glass, glass_shadow_dir, pbr_shadow_dir)
    shadow_w = Vec3.where(is_glass, glass_shadow_w, pbr_shadow_w)
    shadow_rad = Vec3.where(is_glass, glass_shadow_rad, pbr_shadow_rad)
    shadow_maxt = torch.where(is_glass, glass_shadow_maxt, pbr_shadow_maxt)
    shadow_ok = torch.where(is_glass, glass_shadow_ok, pbr_shadow_ok)

    ext_dir = Vec3.where(is_glass, glass_ext_dir, io)
    ext_w = Vec3.where(is_glass, glass_ext_w, pbr_ext_w)
    ext_ok = torch.where(is_glass, glass_ext_ok, pbr_ext_ok)
    ext_env = is_glass & do_refract  # refraction rays see the env on miss

    # Single-sided PBR backface or alpha-masked texel: pass through unchanged.
    ext_dir = Vec3.where(pbr_passthrough, ray_dir, ext_dir)
    ext_w = Vec3.where(pbr_passthrough, weight, ext_w)
    ext_ok = ext_ok | pbr_passthrough
    ext_env = torch.where(pbr_passthrough, env_on_miss, ext_env)
    emission = Vec3.where(pbr_passthrough, 0.0, emission)
    shadow_ok = shadow_ok & ~pbr_passthrough

    # Extensions only while depth < maxRayDepth; emission thresholds; and
    # everything masked by 'this lane is a live hit'.
    ext_ok = ext_ok & (depth < max_ray_depth)
    shadow_ok = shadow_ok & (shadow_w.length_sq() > _EMIT_EPS) & active
    ext_ok = ext_ok & (ext_w.length_sq() > _EMIT_EPS) & active
    emission = Vec3.where(active, emission, 0.0)

    return ShadeResult(
        emission=emission,
        shadow_dir=shadow_dir,
        shadow_weight=Vec3.where(shadow_ok, shadow_w, 0.0),
        shadow_radiance=shadow_rad,
        shadow_max_t=shadow_maxt,
        shadow_active=shadow_ok,
        ext_dir=ext_dir,
        ext_weight=Vec3.where(ext_ok, ext_w, 0.0),
        ext_env_on_miss=ext_env,
        ext_active=ext_ok,
    )
