"""Ray-triangle intersection: Woop preconditioning and the brute-force
closest-hit / any-hit queries (port of ``heatray_tpu.ops.intersect``).

Triangles are stored as Woop affine transforms, a 3x4 matrix per triangle
mapping world space to unit-triangle space, in the planar ``(12, T)`` layout:

    op_k = A_k . o + b_k        dp_k = A_k . d        (k in {b1, b2, s})
    t = -op_s / dp_s,  b1 = op_b1 + t dp_b1,  b2 = op_b2 + t dp_b2

The brute-force queries test every ray against every row of a row table.
They are the plain versions behind the wide-BVH traversal kernels
(``wide_bvh.py``): the same pair arithmetic, in the same operation order, so
that on identical rows a kernel and its plain version round identically.
Over the Woop rows of every triangle they are the ``"xla"`` backend
(``intersect_closest``, ``intersect_any``), whose ids are triangle ids; the
JAX package computes that backend outside any Pallas kernel too.
"""

from __future__ import annotations

import dataclasses

import torch

from ..vec import Vec3, clip

BARY_EPS = 1e-6
MISS_T = 3.0e38
_DZ_EPS = 1e-15
# Elements of one (rays x rows) intermediate: bounds the memory of the
# brute-force queries (32 MB per float32 temporary).
_PAIR_BUDGET = 1 << 23


@dataclasses.dataclass
class WoopAccel:
    """Preconditioned triangle data, planar layout.

    ``w`` (12, T): rows 0-3 = (a0, a1, a2, b) of the b1 output row, rows 4-7
    the b2 row, rows 8-11 the s row, with (b1, b2, s) = A p + b,
    A = [e1 e2 n]^-1 and b = -A v0.  ``geo_normal`` (3, T) is the unit
    geometric normal; ``tri_min``/``tri_max`` (3, T) the triangle AABBs.
    """

    w: torch.Tensor
    geo_normal: torch.Tensor
    tri_min: torch.Tensor
    tri_max: torch.Tensor

    @property
    def num_triangles(self) -> int:
        return self.w.shape[1]


def build_woop(positions: torch.Tensor, indices: torch.Tensor) -> WoopAccel:
    """Precondition triangles: ``positions`` (3, V) f32, ``indices`` (3, T)."""
    idx = indices.long()
    p = Vec3.from_planar(positions)
    v0 = p.map(lambda c: c[idx[0]])
    v1 = p.map(lambda c: c[idx[1]])
    v2 = p.map(lambda c: c[idx[2]])
    e1 = v1 - v0
    e2 = v2 - v0
    n = e1.cross(e2)

    # M = [e1 | e2 | n] columns, inverted through its adjugate (each c_ij
    # below is the cofactor of entry (j, i), so inv[i][j] = c_ij / det).
    m00, m01, m02 = e1.x, e2.x, n.x
    m10, m11, m12 = e1.y, e2.y, n.y
    m20, m21, m22 = e1.z, e2.z, n.z
    c00 = m11 * m22 - m12 * m21
    c01 = m02 * m21 - m01 * m22
    c02 = m01 * m12 - m02 * m11
    c10 = m12 * m20 - m10 * m22
    c11 = m00 * m22 - m02 * m20
    c12 = m02 * m10 - m00 * m12
    c20 = m10 * m21 - m11 * m20
    c21 = m01 * m20 - m00 * m21
    c22 = m00 * m11 - m01 * m10
    det = m00 * c00 + m01 * c10 + m02 * c20
    ok = torch.abs(det) > 1e-20
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    a00, a01, a02 = c00 * inv_det, c01 * inv_det, c02 * inv_det
    a10, a11, a12 = c10 * inv_det, c11 * inv_det, c12 * inv_det
    a20, a21, a22 = c20 * inv_det, c21 * inv_det, c22 * inv_det
    b0 = -(a00 * v0.x + a01 * v0.y + a02 * v0.z)
    b1 = -(a10 * v0.x + a11 * v0.y + a12 * v0.z)
    b2 = -(a20 * v0.x + a21 * v0.y + a22 * v0.z)
    w = torch.stack([a00, a01, a02, b0, a10, a11, a12, b1, a20, a21, a22, b2])
    tri_min = torch.stack(
        [torch.minimum(torch.minimum(v0.x, v1.x), v2.x),
         torch.minimum(torch.minimum(v0.y, v1.y), v2.y),
         torch.minimum(torch.minimum(v0.z, v1.z), v2.z)]
    )
    tri_max = torch.stack(
        [torch.maximum(torch.maximum(v0.x, v1.x), v2.x),
         torch.maximum(torch.maximum(v0.y, v1.y), v2.y),
         torch.maximum(torch.maximum(v0.z, v1.z), v2.z)]
    )
    return WoopAccel(
        w=w.float(),
        geo_normal=n.normalized().to_planar().float(),
        tri_min=tri_min.float(),
        tri_max=tri_max.float(),
    )


def pair_t(org: Vec3, d: Vec3, rows: torch.Tensor, t_min, t_max, anchor=None):
    """Masked hit distance of every ray against every row: (R, S).

    ``rows`` (12, S) Woop rows; ``anchor`` (3, S) or None re-centres each
    ray origin on the row's anchor point (the wide BVH folds the anchor into
    the rows' translation column).  ``t_max`` is a float or an (R,) tensor.
    Misses are ``MISS_T``.  A zero ``dp_s`` gives a NaN or infinite ``t``,
    which fails every comparison below.
    """
    ox, oy, oz = org.x[:, None], org.y[:, None], org.z[:, None]
    if anchor is not None:
        ox, oy, oz = ox - anchor[0], oy - anchor[1], oz - anchor[2]
    dx, dy, dz = d.x[:, None], d.y[:, None], d.z[:, None]

    def aff_o(g):
        return ox * rows[4 * g] + oy * rows[4 * g + 1] + oz * rows[4 * g + 2] + rows[4 * g + 3]

    def aff_d(g):
        return dx * rows[4 * g] + dy * rows[4 * g + 1] + dz * rows[4 * g + 2]

    t = -aff_o(2) / aff_d(2)
    b1 = aff_o(0) + t * aff_d(0)
    b2 = aff_o(1) + t * aff_d(1)
    if isinstance(t_max, torch.Tensor):
        t_max = t_max[:, None]
    valid = (
        (b1 >= -BARY_EPS)
        & (b2 >= -BARY_EPS)
        & (b1 + b2 <= 1.0 + BARY_EPS)
        & (t > t_min)
        & (t < t_max)
    )
    return torch.where(valid, t, MISS_T)


def _row_chunk(r: int, s: int) -> int:
    return max(1, min(s, _PAIR_BUDGET // max(r, 1)))


def closest_rows(org: Vec3, d: Vec3, rows, t_min, anchor=None):
    """Closest hit over a row table: (t, row id, hit).  Ties in ``t`` go to
    the lowest row id; misses are (``MISS_T``, -1)."""
    r, s = org.x.shape[0], rows.shape[1]
    best_t = torch.full((r,), MISS_T, dtype=torch.float32, device=org.x.device)
    best_id = torch.full((r,), -1, dtype=torch.int32, device=org.x.device)
    step = _row_chunk(r, s)
    for lo in range(0, s, step):
        hi = min(s, lo + step)
        t = pair_t(
            org, d, rows[:, lo:hi], t_min, MISS_T,
            None if anchor is None else anchor[:, lo:hi],
        )
        cand_t, arg = torch.min(t, dim=1)
        better = cand_t < best_t  # strict: earlier (lower) rows win ties
        best_t = torch.where(better, cand_t, best_t)
        best_id = torch.where(better, (arg + lo).int(), best_id)
    return best_t, best_id, best_id >= 0


def any_rows(org: Vec3, d: Vec3, rows, t_min, t_max, anchor=None):
    """Any hit in (t_min, t_max) over a row table: (R,) bool."""
    r, s = org.x.shape[0], rows.shape[1]
    blocked = torch.zeros((r,), dtype=torch.bool, device=org.x.device)
    step = _row_chunk(r, s)
    for lo in range(0, s, step):
        hi = min(s, lo + step)
        t = pair_t(
            org, d, rows[:, lo:hi], t_min, t_max,
            None if anchor is None else anchor[:, lo:hi],
        )
        blocked |= torch.any(t < MISS_T, dim=1)
    return blocked


def chunk_boxes(accel: WoopAccel, chunk: int, n_chunks: int) -> torch.Tensor:
    """(n_chunks, 6) AABBs [min xyz, max xyz] of consecutive ``chunk``-triangle
    runs; padding triangles form empty (inverted) boxes."""
    big = 3.0e38
    pad = n_chunks * chunk - accel.num_triangles
    tmin = torch.nn.functional.pad(accel.tri_min, (0, pad), value=big)
    tmax = torch.nn.functional.pad(accel.tri_max, (0, pad), value=-big)
    cmin = tmin.reshape(3, n_chunks, chunk).amin(dim=2)
    cmax = tmax.reshape(3, n_chunks, chunk).amax(dim=2)
    return torch.cat([cmin, cmax]).T.contiguous()


def chunk_rows(w: torch.Tensor) -> torch.Tensor:
    """Chunk-packed leaf columns (C, 4, 3 Tc) back to (12, C Tc) Woop rows,
    ``rows[4 g + f, c Tc + j] = w[c, f, g Tc + j]``."""
    c, tc = w.shape[0], w.shape[2] // 3
    return w.view(c, 4, 3, tc).permute(2, 1, 0, 3).reshape(12, c * tc)


def intersect_closest(accel: WoopAccel, origins: Vec3, directions: Vec3, t_min=1e-4):
    """Closest-hit query of rays (Vec3 of (R,)) against all triangles.
    Returns (t, tri_id, hit); misses get (``MISS_T``, -1)."""
    return closest_rows(origins, directions, accel.w, t_min)


def intersect_any(accel: WoopAccel, origins: Vec3, directions: Vec3, t_min=1e-4, t_max=3.0e37):
    """Any-hit (occlusion) query; ``t_max`` a float or per-ray (R,)."""
    return any_rows(origins, directions, accel.w, t_min, t_max)


def hit_attributes(accel: WoopAccel, origins: Vec3, directions: Vec3, tri_id, hit_mask):
    """(t, b1, b2) of each ray against its triangle ``tri_id``, evaluated
    again from the gathered Woop rows, so that gradients reach the rays and
    ``accel.w``; misses get (``MISS_T``, 0, 0), barycentrics clamped to
    [0, 1]."""
    rows = accel.w[:, tri_id.clamp(min=0).long()]  # (12, R)

    def affine(k, v, with_b):
        r = rows[4 * k] * v.x + rows[4 * k + 1] * v.y + rows[4 * k + 2] * v.z
        return r + rows[4 * k + 3] if with_b else r

    dz = affine(2, directions, False)
    safe_dz = torch.where(torch.abs(dz) > _DZ_EPS, dz, 1.0)
    t = -affine(2, origins, True) / safe_dz
    b1 = affine(0, origins, True) + t * affine(0, directions, False)
    b2 = affine(1, origins, True) + t * affine(1, directions, False)
    t = torch.where(hit_mask, t, MISS_T)
    b1 = clip(torch.where(hit_mask, b1, 0.0), 0.0, 1.0)
    b2 = clip(torch.where(hit_mask, b2, 0.0), 0.0, 1.0)
    return t, b1, b2


def gather_geo_normal(accel: WoopAccel, tri_id) -> Vec3:
    """The unit geometric normal of each ray's triangle ``tri_id``."""
    return Vec3.from_planar(accel.geo_normal[:, tri_id.clamp(min=0).long()])
