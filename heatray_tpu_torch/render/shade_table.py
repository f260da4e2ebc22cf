"""Per-triangle shading rows: one row gather per bounce (port of
``heatray_tpu.render.shade_table``).

Everything shading reads per hit triangle (Woop rows, geometric normal,
corner normals and colors, material parameters) is packed into one
``(T, K)`` table at setup, reordered into the wide BVH's slot order so that
the closest-hit kernel's raw slot ids index it directly.  The columns only
texturing reads (corner UVs, tangents and bitangents, the seven texture
ids and the UV density of the ray-cone LOD) form a tail after the first
``NUM_BASE_COLS``, built only for a textured table, so an untextured scene
gathers the base columns alone.
"""

from __future__ import annotations

import torch

from ..ops.intersect import MISS_T, WoopAccel
from ..scene.materials import TEXTURE_SLOTS
from ..scene.scene import Scene
from ..vec import Vec3, clip

WOOP = 0           # 12: Woop affine rows
GEO_N = 12         # 3
N0 = 15            # 9: shading normal per corner
COL0 = 24          # 9: vertex color per corner
KIND = 33
BASE_COLOR = 34    # 3
EMISSIVE = 37      # 3
METALLIC = 40
ROUGHNESS = 41
ROUGHNESS_ALPHA = 42
SPECULAR_F0 = 43
CLEARCOAT = 44
CC_ROUGH = 45
CC_ALPHA = 46
IOR = 47
DENSITY = 48
DOUBLE_SIDED = 49
ALPHA_MASK = 50
NUM_BASE_COLS = 51
# --- the texture tail ---
UV0 = 51           # 6: uv per corner
TAN0 = 57          # 9: tangent per corner
BTN0 = 66          # 9: bitangent per corner
BC_TEX = 75
MR_TEX = 76
EM_TEX = 77
NM_TEX = 78
CC_TEX = 79
CCR_TEX = 80
CCN_TEX = 81
# sqrt(uv_area / world_area): UV length per world unit, the texel-density
# term of the ray-cone LOD (zero for degenerate UVs, which pins level 0).
UV_DENSITY = 82
NUM_COLS = 83


def build_shade_table(scene: Scene, accel: WoopAccel, textured: bool | None = None
                      ) -> torch.Tensor:
    """(T, K) float32 rows in triangle order: K = NUM_COLS when
    ``textured`` (default ``scene.has_textures``), NUM_BASE_COLS otherwise."""
    if textured is None:
        textured = scene.has_textures
    geom, mats = scene.geometry, scene.materials
    corners = [geom.indices[k].long() for k in range(3)]
    mid = geom.material_ids.long()

    cols = list(accel.w) + list(accel.geo_normal)
    for c in corners:
        cols.extend(geom.normals[k][c] for k in range(3))
    for c in corners:
        cols.extend(geom.colors[k][c] for k in range(3))

    def mat(param):
        return param[mid].float()

    cols.append(mat(mats.kind))
    cols.extend(mat(mats.base_color[k]) for k in range(3))
    cols.extend(mat(mats.emissive[k]) for k in range(3))
    for name in ("metallic", "roughness", "roughness_alpha", "specular_f0",
                 "clearcoat", "clearcoat_roughness", "clearcoat_roughness_alpha",
                 "ior", "density", "double_sided", "alpha_mask"):
        cols.append(mat(getattr(mats, name)))
    assert len(cols) == NUM_BASE_COLS

    if textured:
        for c in corners:
            cols.extend(geom.uvs[k][c] for k in range(2))
        for c in corners:
            cols.extend(geom.tangents[k][c] for k in range(3))
        for c in corners:
            cols.extend(geom.bitangents[k][c] for k in range(3))
        for slot in TEXTURE_SLOTS:
            cols.append(mat(getattr(mats, slot)))

        # The per-triangle UV density of the ray-cone LOD.
        p0, p1, p2 = ([geom.positions[k][c] for k in range(3)] for c in corners)
        e1 = [p1[k] - p0[k] for k in range(3)]
        e2 = [p2[k] - p0[k] for k in range(3)]
        cx = e1[1] * e2[2] - e1[2] * e2[1]
        cy = e1[2] * e2[0] - e1[0] * e2[2]
        cz = e1[0] * e2[1] - e1[1] * e2[0]
        world_2area = torch.sqrt(cx * cx + cy * cy + cz * cz)
        (u0, v0), (u1, v1), (u2, v2) = ((geom.uvs[0][c], geom.uvs[1][c]) for c in corners)
        uv_2area = torch.abs((u1 - u0) * (v2 - v0) - (u2 - u0) * (v1 - v0))
        cols.append(torch.sqrt(uv_2area / clip(world_2area, 1e-12)))
        assert len(cols) == NUM_COLS
    return torch.stack(cols, dim=1)


def slot_order_table(table: torch.Tensor, slot_tri: torch.Tensor) -> torch.Tensor:
    """Reorder a triangle-ordered table into slot order (S = chunks * leaf
    size rows; padding slots get zero rows)."""
    rows = table[slot_tri.clamp(min=0).long()]
    return rows * (slot_tri >= 0).to(table.dtype)[:, None]


class HitRows:
    """Column accessors over gathered (R, K) rows."""

    def __init__(self, rows: torch.Tensor):
        self.rows = rows

    def col(self, k) -> torch.Tensor:
        return self.rows[:, k]

    def icol(self, k) -> torch.Tensor:
        return self.rows[:, k].to(torch.int32)

    def vec(self, k) -> Vec3:
        return Vec3(self.rows[:, k], self.rows[:, k + 1], self.rows[:, k + 2])

    def interp_vec(self, base: int, w0, b1, b2) -> Vec3:
        """Barycentric interpolation of a block of three corner Vec3s."""
        return self.vec(base) * w0 + self.vec(base + 3) * b1 + self.vec(base + 6) * b2

    def interp_uv(self, w0, b1, b2):
        u = self.col(UV0) * w0 + self.col(UV0 + 2) * b1 + self.col(UV0 + 4) * b2
        v = self.col(UV0 + 1) * w0 + self.col(UV0 + 3) * b1 + self.col(UV0 + 5) * b2
        return u, v


def gather_rows(table: torch.Tensor, slot) -> HitRows:
    """One row gather for a wavefront of hits (ids clamped by the caller).

    ``index_select``, whose backward adds each lane's row gradient into the
    table with ``index_add_``.  The backward of ``table[slot]`` sorts the
    lanes and sums each row's run of duplicates in one thread: a wall holds
    hundreds of thousands of a 1080p wavefront's hits, and that sum took
    1.25 s of a 1.9 s gradient step on the card."""
    return HitRows(table.index_select(0, slot.long()))


def hit_attributes_rows(rows: HitRows, origins: Vec3, directions: Vec3, hit_mask):
    """(t, b1, b2) re-evaluated from the gathered Woop rows."""

    def affine(k, v, with_b):
        r = (
            rows.col(WOOP + 4 * k) * v.x
            + rows.col(WOOP + 4 * k + 1) * v.y
            + rows.col(WOOP + 4 * k + 2) * v.z
        )
        if with_b:
            r = r + rows.col(WOOP + 4 * k + 3)
        return r

    dz = affine(2, directions, False)
    safe_dz = torch.where(torch.abs(dz) > 1e-15, dz, 1.0)
    t = -affine(2, origins, True) / safe_dz
    b1 = affine(0, origins, True) + t * affine(0, directions, False)
    b2 = affine(1, origins, True) + t * affine(1, directions, False)
    t = torch.where(hit_mask, t, MISS_T)
    b1 = clip(torch.where(hit_mask, b1, 0.0), 0.0, 1.0)
    b2 = clip(torch.where(hit_mask, b2, 0.0), 0.0, 1.0)
    return t, b1, b2
