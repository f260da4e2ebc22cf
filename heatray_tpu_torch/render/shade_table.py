"""Per-triangle shading rows: one row gather per bounce (port of the
untextured table of ``heatray_tpu.render.shade_table``).

Everything shading reads per hit triangle (Woop rows, geometric normal,
corner normals and colors, material parameters) is packed into one
``(T, NUM_BASE_COLS)`` table at setup, reordered into the wide BVH's slot
order so that the closest-hit kernel's raw slot ids index it directly.
"""

from __future__ import annotations

import torch

from ..ops.intersect import MISS_T, WoopAccel
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


def build_shade_table(scene: Scene, accel: WoopAccel) -> torch.Tensor:
    """(T, NUM_BASE_COLS) float32 rows in triangle order."""
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

    def vec(self, k) -> Vec3:
        return Vec3(self.rows[:, k], self.rows[:, k + 1], self.rows[:, k + 2])

    def interp_vec(self, base: int, w0, b1, b2) -> Vec3:
        """Barycentric interpolation of a block of three corner Vec3s."""
        return self.vec(base) * w0 + self.vec(base + 3) * b1 + self.vec(base + 6) * b2


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
