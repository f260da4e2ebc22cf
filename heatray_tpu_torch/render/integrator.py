"""The wavefront path-tracing integrator (port of
``heatray_tpu.render.integrator``).

Per pass every pixel traces one camera ray; a Python loop over bounce depth
intersects (closest-hit kernel), gathers one shading row per hit, shades
(NEE shadow ray plus extension ray), tests occlusion (any-hit kernel) and
accumulates into a planar ``(4, H, W)`` buffer whose channel 3 counts
passes.  The wavefront is a flat ``(R,)`` set of tensors; dead lanes are
parked outside every box rather than compacted.

Backends, on the card and the CPU alike (``intersect_backend``):

- ``"wide"``: arity-8 BVH, 32-triangle leaves (``csrc/wide_bvh.cu``), what
  ``"auto"`` picks up to 250,000 triangles;
- ``"stream"``: the same with 128-triangle leaves, a walk per ray and each
  leaf test shared by the warp (``csrc/wide_bvh_stream.cu``), what
  ``"auto"`` picks above;
- either of the two with the transposed leaf math (``wide_leaf_math`` or
  ``stream_leaf_math`` ``"vpu"``; ``csrc/wide_bvh_t.cu``): leaves of a
  multiple of 128 triangles, each tested by a warp only on the rays that
  enter it (``"wide"`` rounds its leaf size up to that);
- ``"bvh"``: binary skip-pointer BVH, ``bvh_leaf_size`` leaves
  (``csrc/bvh2.cu``);
- ``"pallas"``: no tree, ``pallas_tri_chunk``-triangle chunks culled by
  their boxes (``csrc/chunks.cu``);
- ``"xla"``: no tree and no kernel, the exact brute force over every
  triangle (``ops/intersect.py``), as the JAX package's backend of that name;
- ``"sharded"``: host-sharded geometry, a forest of ``"wide"`` trees, one per
  Morton-contiguous piece of the triangles, each held by one rank of a mesh
  axis (``parallel/geometry.py``): every rank traverses the whole wavefront
  against its own tree with K1/K2, and the results are reduced over the
  axis, so every rank shades the same wavefront.  A context made with a mesh
  (``make_context(..., mesh=...)``) holds it.

A context made without a scene is the rebuild mode: every pass rebuilds the
Woop rows, the chunk packs and the shading table from the scene it is given
and traces them through the chunk kernels, whatever the backend.  The
wide-BVH backends return slots and shade from a table in slot order; the
others return triangle ids and shade from one in triangle order.

A pass may render one rank's rows of a row-sharded image
(``parallel.sharding``): ``options.height`` is then the rank's row count,
``options.image_height`` the image's, and ``frame.row_offset`` the global
row of the rank's row 0; raygen, the pixel cone and the block mode read the
global rows.  The per-pixel sample tables are then the rank's rows of the
full image's tables.

With ``interactive_block`` pass k traces only the pixels (x, y) with
``x % 3 == k % 9 % 3`` and ``y % 3 == k % 9 // 3`` (y the global row), at
sample index ``k // 9`` (``PassGenerator.cpp:372-384``): its wavefront holds those
pixels' lanes alone, and the accumulation's channel 3 counts a pass on
them only, so nine block passes equal one full pass.

From the second bounce on, the wavefront can be sorted by direction octant
and origin Morton code (coherent kernel tiles, live lanes first) and the
bounce then run only on the segments that hold live lanes.  Both are an
exact permutation of per-lane work, undone at accumulation through each
lane's pixel index, so the image does not change.

A scene with textures shades from a table with the texture tail
(``shade_table.NUM_COLS`` columns), and with ``use_mipmaps`` each lane
carries the distance its path has travelled (``Paths.path_len``), whose ray
cone picks the mip levels; without textures neither exists.  A surface AOV
(``options.aov``) stops after the primary hit and accumulates the
attribute; the NaN and Inf AOVs replace the firefly clamp by their
detectors (``render/aov.py``).

The pass is differentiable with autograd (``diff.inverse``).  Traversal is
not: every query gets detached rays, hit ids are discrete, and t and the
barycentrics are evaluated again from the gathered Woop rows, as in the JAX
package, so no backward launches a traversal kernel.  A context made with
``static_shading=False`` bakes no shading table; each pass builds its own
from the scene it is given, so gradients reach the materials.  Under
autograd, ``remat_bounces`` recomputes each bounce's shading in the backward
(``torch.utils.checkpoint``) instead of keeping its intermediates; the
traversal results are kept.

Image convention: row 0 is the BOTTOM of the image.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
from torch.utils.checkpoint import checkpoint

from ..camera import CameraParams
from ..ops.bvh import BVH, build_bvh
from ..ops.intersect import WoopAccel, build_woop, intersect_any, intersect_closest
from ..ops.intersect_pallas import (
    WoopPallas,
    intersect_any_pallas,
    intersect_closest_pallas,
    pack_for_pallas,
)
from ..ops.traverse_pallas import intersect_any_bvh, intersect_closest_bvh
from ..ops.wide_bvh import (
    VPU_LEAF_ALIGN,
    WideBVH,
    build_wide_bvh,
    intersect_any_stream,
    intersect_any_stream_vpu,
    intersect_any_vpu,
    intersect_any_wide,
    intersect_closest_stream,
    intersect_closest_stream_vpu,
    intersect_closest_vpu,
    intersect_closest_wide,
)
from ..options import AOV, FrameGlobals, RenderOptions
from ..sampling.tables import SampleTables, build_tables, get_aperture_sample
from ..scene.scene import Scene
from ..vec import Vec3
from .aov import ACCUM_AOVS, SURFACE_AOVS, accum_visualize, compute_surface_aov
from .envmap import env_radiance
from .multiscatter import multiscatter_lut_packed
from .shade import make_sequence_lookup, shade_hits
from .shade_table import (
    GEO_N,
    NUM_COLS,
    build_shade_table,
    gather_rows,
    hit_attributes_rows,
    slot_order_table,
)

_PARK_ORG = 3.0e37
# Past this many triangles the "auto" backend is "stream" (the JAX package's
# VMEM budget, ``integrator.py:124``; kept as the port's rule).
STREAM_THRESHOLD = 250_000

# (closest hit, occlusion) per route: a backend, and for the wide trees
# their leaf math (``AccelPack.route``).
_INTERSECTORS = {
    "wide": (intersect_closest_wide, intersect_any_wide),
    "wide/vpu": (intersect_closest_vpu, intersect_any_vpu),
    "stream": (intersect_closest_stream, intersect_any_stream),
    "stream/vpu": (intersect_closest_stream_vpu, intersect_any_stream_vpu),
    "bvh": (intersect_closest_bvh, intersect_any_bvh),
    "pallas": (intersect_closest_pallas, intersect_any_pallas),
    "xla": (intersect_closest, intersect_any),
}


@dataclasses.dataclass
class AccelPack:
    """Acceleration state: the Woop rows, the backend's structure for all
    triangles and its occluder counterpart (the same object unless some
    material is alpha-masked), the shading table in the order of the ids
    the backend returns, the backend and, for the wide trees, the leaf math
    their leaves were built for.  Only the backend's pair of structures is
    set: ``wide``/``wide_occl`` (``"wide"``, ``"stream"``),
    ``bvh``/``bvh_occl``, ``packed``/``packed_occl``, for ``"xla"`` the
    Woop rows themselves and ``accel_occl``, or for ``"sharded"`` the
    forests ``swide``/``swide_occl`` (``parallel.geometry.ShardedWideBVH``)
    with the ``mesh`` and its ``shard_axis``.  ``shade_table`` is None where
    each pass builds its own (``static_shading=False``)."""

    accel: WoopAccel
    shade_table: torch.Tensor | None
    backend: str
    leaf_math: str = "mxu"
    accel_occl: WoopAccel | None = None
    wide: WideBVH | None = None
    wide_occl: WideBVH | None = None
    bvh: BVH | None = None
    bvh_occl: BVH | None = None
    packed: WoopPallas | None = None
    packed_occl: WoopPallas | None = None
    swide: object | None = None  # parallel.geometry.ShardedWideBVH
    swide_occl: object | None = None
    mesh: object | None = None  # parallel.sharding.Mesh
    shard_axis: str = "dp"

    @property
    def route(self) -> str:
        """The key of ``_INTERSECTORS`` (``"sharded"`` has none: its
        intersectors close over the mesh): the backend, with ``/vpu`` for a
        wide tree built for the transposed leaf math."""
        return self.backend + ("/vpu" if self.leaf_math == "vpu" else "")

    def structures(self):
        """(closest-hit structure, occluder structure) of the backend."""
        name = {"wide": "wide", "stream": "wide", "bvh": "bvh", "pallas": "packed",
                "xla": "accel", "sharded": "swide"}[self.backend]
        return getattr(self, name), getattr(self, name + "_occl")


def _select_backend(options: RenderOptions, num_triangles: int) -> str:
    """``"auto"``: the 32-triangle-leaf kernels up to ``STREAM_THRESHOLD``
    triangles, the streaming kernels above, on every device."""
    if options.intersect_backend != "auto":
        return options.intersect_backend
    return "wide" if num_triangles <= STREAM_THRESHOLD else "stream"


@dataclasses.dataclass
class RenderContext:
    """Per-configuration constant data on one device."""

    tables: SampleTables
    accel_pack: AccelPack | None
    device: torch.device
    # ((L+1)^2, 4) corner-packed multiscatter table (``ms_impl="lut"``).
    ms_lut: torch.Tensor


def _device(device) -> torch.device:
    """The device to render on; the card must be there if it is named."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to render with the plain versions")
    return device


def _occluder_mask(scene: Scene) -> torch.Tensor:
    """(T,) bool: the triangles that block shadow rays (alpha-masked ones do
    not, ``Mesh.cpp:95-100``)."""
    return scene.materials.alpha_mask[scene.geometry.material_ids.long()] == 0


def _occluder_accel(accel: WoopAccel, scene: Scene) -> WoopAccel:
    """The accel without its alpha-masked triangles: zeroed Woop rows are
    never hit, and their boxes become empty."""
    mask = _occluder_mask(scene)[None, :]
    return WoopAccel(
        w=accel.w * mask.float(),
        geo_normal=accel.geo_normal,
        tri_min=torch.where(mask, accel.tri_min, 3.0e38),
        tri_max=torch.where(mask, accel.tri_max, -3.0e38),
    )


def texture_tail(scene: Scene, options: RenderOptions) -> bool:
    """Whether the pass shades from a table with the texture tail: a scene
    with textures, or any AOV (the surface AOVs read UVs, tangents and
    texture ids; ``heatray_tpu/render/integrator.py:259-262``)."""
    return scene.has_textures or options.aov != AOV.NONE


def rebuild_pack(scene: Scene, options: RenderOptions) -> AccelPack:
    """The ``"pallas"`` pack, which the rebuild mode makes every pass: Woop
    rows, chunk packs and a triangle-order shading table, all built on the
    scene's device with no host step."""
    accel = build_woop(scene.geometry.positions, scene.geometry.indices)
    packed = pack_for_pallas(accel, options.pallas_tri_chunk)
    packed_occl = (
        pack_for_pallas(_occluder_accel(accel, scene), options.pallas_tri_chunk)
        if scene.has_alpha_mask else packed
    )
    return AccelPack(accel=accel, shade_table=build_shade_table(scene, accel,
                                                                texture_tail(scene, options)),
                     backend="pallas", packed=packed, packed_occl=packed_occl)


def build_accel(scene: Scene, options: RenderOptions, static_shading: bool = True,
                mesh=None, shard_axis: str = "dp") -> AccelPack:
    """Build the acceleration state on the scene's device (the trees
    themselves are built on the host).  With ``static_shading=False`` the
    pack holds no shading table: each pass builds one from its scene
    (``pass_pack``), so material gradients reach it.

    ``intersect_backend="sharded"`` needs a ``mesh``
    (``parallel.sharding.make_mesh``): one wide tree of ``wide_leaf_size`` is
    built per Morton-contiguous piece of the triangles, one piece per rank of
    ``mesh[shard_axis]``, and this rank keeps its own on the scene's
    device."""
    backend = _select_backend(options, scene.geometry.num_triangles)
    if backend == "sharded" and mesh is None:
        raise ValueError('intersect_backend="sharded" needs make_context(..., mesh=...)')
    if backend == "pallas":
        pack = rebuild_pack(scene, options)
        return pack if static_shading else dataclasses.replace(pack, shade_table=None)
    accel = build_woop(scene.geometry.positions, scene.geometry.indices)
    include = _occluder_mask(scene).cpu().numpy() if scene.has_alpha_mask else None
    if backend == "sharded":
        from ..parallel.geometry import build_sharded_wide, place_sharded_wide

        d, dev = mesh.shape[shard_axis], accel.w.device
        swide = place_sharded_wide(build_sharded_wide(accel, d, options.wide_leaf_size),
                                   mesh, shard_axis, dev)
        swide_occl = swide if include is None else place_sharded_wide(
            build_sharded_wide(accel, d, options.wide_leaf_size, include=include),
            mesh, shard_axis, dev)
        pack = AccelPack(accel=accel, shade_table=None, backend=backend, swide=swide,
                         swide_occl=swide_occl, mesh=mesh, shard_axis=shard_axis)
    elif backend == "xla":
        pack = AccelPack(accel=accel, shade_table=None, backend=backend,
                         accel_occl=_occluder_accel(accel, scene) if scene.has_alpha_mask
                         else accel)
    elif backend == "bvh":
        bvh = build_bvh(accel, leaf_size=options.bvh_leaf_size)
        bvh_occl = bvh if include is None else build_bvh(
            accel, leaf_size=options.bvh_leaf_size, include=include)
        pack = AccelPack(accel=accel, shade_table=None, backend=backend,
                         bvh=bvh, bvh_occl=bvh_occl)
    else:
        leaf, math = _wide_leaf(options, backend)
        wide = build_wide_bvh(accel, leaf_size=leaf)
        wide_occl = wide if include is None else build_wide_bvh(accel, leaf_size=leaf,
                                                                include=include)
        pack = AccelPack(accel=accel, shade_table=None, backend=backend, leaf_math=math,
                         wide=wide, wide_occl=wide_occl)
    return pass_pack(scene, pack, texture_tail(scene, options)) if static_shading else pack


def pass_pack(scene: Scene, pack: AccelPack, with_tail: bool = False) -> AccelPack:
    """``pack`` with a shading table: its own, or one built from ``scene``
    in the id order of its backend (slot order for the wide trees, triangle
    order otherwise; ``heatray_tpu/render/integrator.py:752-771``).
    ``with_tail``: the table must carry the texture tail, so a baked table
    without it is built again, as the reference does for a surface AOV over
    a context made without one (``:837-851``)."""
    if pack.shade_table is not None and (not with_tail or pack.shade_table.shape[1] == NUM_COLS):
        return pack
    table = build_shade_table(scene, pack.accel, with_tail)
    if pack.backend in ("wide", "stream"):
        table = slot_order_table(table, pack.wide.slot_tri)
    elif pack.backend == "sharded":
        # The forest's global slots: shard i's base is ``slot_offset[i]``.
        table = slot_order_table(table, pack.swide.slot_tri.reshape(-1))
    return dataclasses.replace(pack, shade_table=table)


def _wide_leaf(options: RenderOptions, backend: str):
    """(leaf size, leaf math) of the ``"wide"`` or ``"stream"`` tree
    (``heatray_tpu/render/integrator.py:217-223``): ``"wide"`` with the
    ``"vpu"`` leaf math rounds its leaf size up to a multiple of 128;
    ``"stream"`` with it needs one."""
    if backend == "stream":
        leaf, math = options.stream_leaf_size, options.stream_leaf_math
        if math == "vpu" and leaf % VPU_LEAF_ALIGN:
            raise ValueError(f"stream_leaf_math='vpu' needs a stream_leaf_size that is a "
                             f"multiple of {VPU_LEAF_ALIGN}, not {leaf}")
        return leaf, math
    leaf, math = options.wide_leaf_size, options.wide_leaf_math
    if math == "vpu":
        leaf = -(-leaf // VPU_LEAF_ALIGN) * VPU_LEAF_ALIGN
    return leaf, math


def make_context(options: RenderOptions, scene: Scene | None = None, device="cuda",
                 static_shading: bool = True, mesh=None,
                 shard_axis: str = "dp") -> RenderContext:
    """Sample tables and, given a scene (already on ``device``), its
    acceleration state; without a scene, the rebuild mode (see the module
    docstring).  ``static_shading=False`` bakes no shading table, so that
    material parameters take gradients (``build_accel``).  ``mesh`` and
    ``shard_axis``: the ranks that share the ``"sharded"`` backend's forest
    (``build_accel``); every rank of the axis makes its context together."""
    device = _device(device)
    return RenderContext(
        tables=build_tables(
            options.width,
            options.height,
            options.max_render_passes,
            sample_mode=options.sample_mode,
            bokeh_shape=options.bokeh_shape,
            device=device,
        ),
        accel_pack=(build_accel(scene, options, static_shading=static_shading, mesh=mesh,
                                shard_axis=shard_axis)
                    if scene is not None else None),
        device=device,
        ms_lut=multiscatter_lut_packed(device),
    )


def _mat3_apply(m, v: Vec3) -> Vec3:
    """Apply the upper-left 3x3 of a (4, 4) matrix to a Vec3."""
    return Vec3(
        m[0, 0] * v.x + m[0, 1] * v.y + m[0, 2] * v.z,
        m[1, 0] * v.x + m[1, 1] * v.y + m[1, 2] * v.z,
        m[2, 0] * v.x + m[2, 1] * v.y + m[2, 2] * v.z,
    )


def generate_primary_rays(
    camera: CameraParams, tables: SampleTables, options: RenderOptions, sample_index: int,
    row_offset: int = 0,
):
    """Camera rays (``perspective.rlsl:59-93``): pixel jitter from the
    pixel's QMC stream and the thin-lens aperture offset.  Returns
    (origin, direction, seq_id, seq_off) as flat (H * W,) tensors.
    ``row_offset``: the global row of row 0 in a row-sharded image; the
    camera maps rows over the full ``image_height``."""
    h, w = options.height, options.width
    full_h = options.image_height or options.height
    dev = tables.pixel_sequence_id.device
    seq_id = tables.pixel_sequence_id.reshape(-1)
    seq_off = tables.pixel_sequence_offset.reshape(-1)
    px = torch.arange(w, dtype=torch.float32, device=dev).repeat(h)
    py = torch.arange(h, dtype=torch.float32, device=dev).repeat_interleave(w) + float(row_offset)

    ju, jv = make_sequence_lookup(tables, options.sample_mode)(seq_id, sample_index + seq_off)
    u = (px + ju) / w
    v = (py + jv) / full_h

    # Image-plane direction, 1 unit in front of the camera; row 0 is the
    # image bottom (``perspective.rlsl:72-74``).
    x = (2.0 * u - 1.0) * camera.aspect * camera.fov_tan
    y = (1.0 - 2.0 * v) * camera.fov_tan * -1.0
    dir_cam = Vec3(x, y, -torch.ones_like(x)).normalized()

    focal_point = dir_cam * camera.focus_distance
    au, av = get_aperture_sample(tables, seq_id, sample_index)
    origin_cam = Vec3(
        (au * 2.0 - 1.0) * camera.aperture_radius,
        (av * 2.0 - 1.0) * camera.aperture_radius,
        torch.zeros_like(au),
    )
    d_cam = focal_point - origin_cam

    m = camera.view_matrix
    org = _mat3_apply(m, origin_cam) + Vec3(m[0, 3], m[1, 3], m[2, 3])
    direction = _mat3_apply(m, d_cam).normalized()
    return org, direction, seq_id, seq_off


def _offset_origin(p: Vec3, geo_n: Vec3, direction: Vec3, eps) -> Vec3:
    """Offset a secondary-ray origin off the surface along the geometric
    normal, toward the ray direction's side."""
    sign = torch.where(geo_n.dot(direction) >= 0.0, 1.0, -1.0)
    return p + geo_n * (sign * eps)


def _park_dead(org: Vec3, direction: Vec3, active):
    """Park inactive rays far outside every box with a +X direction, so
    their walk ends at the root."""
    return (
        Vec3.where(active, org, _PARK_ORG),
        Vec3.where(active, direction, Vec3(1.0, 0.0, 0.0)),
    )


def _accum_update(contrib: Vec3, h: int, w: int, alpha=None) -> torch.Tensor:
    """Flat per-pixel contribution -> planar (4, H, W) update; channel 3
    counts the pass: 1 everywhere, or the per-pixel ``alpha`` (H * W,)."""
    if alpha is None:
        alpha = torch.ones((h, w), dtype=torch.float32, device=contrib.x.device)
    return torch.stack(
        [contrib.x.reshape(h, w), contrib.y.reshape(h, w), contrib.z.reshape(h, w),
         alpha.reshape(h, w)]
    )


@dataclasses.dataclass
class Paths:
    """The wavefront between bounces: flat (R,) per-path state."""

    org: Vec3
    direction: Vec3
    weight: Vec3
    env_on_miss: torch.Tensor
    active: torch.Tensor
    contrib: Vec3
    seq_id: torch.Tensor
    seq_off: torch.Tensor
    pix: torch.Tensor  # (R,) int64: the pixel each lane accumulates into
    # (R,) distance travelled, whose ray cone picks mip levels; None
    # unless the scene has textures and ``use_mipmaps`` is on.
    path_len: torch.Tensor | None = None

    def map(self, fn) -> "Paths":
        """Apply ``fn`` to every (R,) plane."""
        def one(v):
            if v is None:
                return None
            return v.map(fn) if isinstance(v, Vec3) else fn(v)

        return Paths(**{f.name: one(getattr(self, f.name)) for f in dataclasses.fields(self)})


def _merge(head: Paths, tail: Paths) -> Paths:
    """The lanes of ``head`` followed by those of ``tail``."""
    def cat(a, b):
        if a is None:
            return None
        if isinstance(a, Vec3):
            return Vec3(cat(a.x, b.x), cat(a.y, b.y), cat(a.z, b.z))
        return torch.cat([a, b])

    return Paths(**{f.name: cat(getattr(head, f.name), getattr(tail, f.name))
                    for f in dataclasses.fields(Paths)})


@dataclasses.dataclass
class ShadowRays:
    """The NEE shadow rays one bounce traced (dead lanes parked)."""

    org: Vec3
    direction: Vec3
    t_max: torch.Tensor
    active: torch.Tensor


def pixel_cone(scene: Scene, camera: CameraParams, options: RenderOptions):
    """The angular width of a pixel's ray cone, whose width at a hit picks
    the texture's mip levels, or None where no cone is traced: a scene
    without textures, or ``use_mipmaps`` off (``integrator.py:872-874``).
    Its width is over the full image's rows (``image_height``)."""
    if not (options.use_mipmaps and scene.has_textures):
        return None
    return 2.0 * camera.fov_tan / float(options.image_height or options.height)


def start_paths(camera: CameraParams, ctx: RenderContext, options: RenderOptions,
                sample_index: int, cone: bool = False, row_offset: int = 0) -> Paths:
    """Camera rays with unit weight, all live, seeing the environment;
    ``cone``: with a zero ``path_len`` (see ``pixel_cone``); ``row_offset``:
    see ``generate_primary_rays``."""
    org, direction, seq_id, seq_off = generate_primary_rays(
        camera, ctx.tables, options, sample_index, row_offset
    )
    r = options.height * options.width
    return Paths(
        org=org,
        direction=direction,
        weight=Vec3.ones((r,), device=ctx.device),
        env_on_miss=torch.ones((r,), dtype=torch.bool, device=ctx.device),
        active=torch.ones((r,), dtype=torch.bool, device=ctx.device),
        contrib=Vec3.zeros((r,), device=ctx.device),
        seq_id=seq_id,
        seq_off=seq_off,
        pix=torch.arange(r, device=ctx.device),
        path_len=torch.zeros((r,), dtype=torch.float32, device=ctx.device) if cone else None,
    )


def _make_intersectors(pack: AccelPack):
    """(closest, any) over the pack's structures: ``closest(org, dir, t_min)``
    gives (t, id, hit) with the ids of ``pack.shade_table``,
    ``any(org, dir, t_min, t_max)`` the blocked mask.  For ``"sharded"``
    both reduce over the pack's mesh axis: every rank of it must call them
    together, on the same rays."""
    if pack.backend == "sharded":
        from ..parallel.geometry import make_sharded_wide_intersectors

        return make_sharded_wide_intersectors(pack.swide, pack.swide_occl, pack.mesh,
                                              pack.shard_axis)
    closest_k, any_k = _INTERSECTORS[pack.route]
    tree, tree_occl = pack.structures()

    def closest(org, direction, t_min):
        return closest_k(tree, org, direction, t_min)

    def any_hit(org, direction, t_min, t_max):
        return any_k(tree_occl, org, direction, t_min, t_max)

    return closest, any_hit


def _detach(v: Vec3) -> Vec3:
    return v.map(torch.Tensor.detach)


def _requires_grad(*objs) -> bool:
    """Whether a tensor among ``objs`` (tensors, or dataclasses of them, such
    as ``Paths``, ``Vec3`` or ``LightBank``) requires a gradient."""
    for o in objs:
        if isinstance(o, torch.Tensor):
            if o.requires_grad:
                return True
        elif dataclasses.is_dataclass(o) and _requires_grad(
                *(getattr(o, f.name) for f in dataclasses.fields(o))):
            return True
    return False


def bounce(scene: Scene, ctx: RenderContext, options: RenderOptions,
           frame: FrameGlobals, depth: int, paths: Paths, pack: AccelPack, cone=None):
    """One bounce of the wavefront against ``pack``: closest hit, one row
    gather, shading, NEE occlusion, and the extension rays.  Returns the
    next ``Paths`` and the ``ShadowRays`` traced.  ``cone``: the pixel cone
    (``pixel_cone``), which paths with a ``path_len`` need.

    Both queries take detached rays.  Under autograd with
    ``remat_bounces``, the shading between them is checkpointed: the
    backward recomputes it from this bounce's inputs and the query results,
    and launches no traversal kernel."""
    if (paths.path_len is None) != (cone is None):
        raise ValueError("paths with a path_len need the pixel cone, and only they")
    pack = pass_pack(scene, pack, texture_tail(scene, options))
    closest_fn, any_fn = _make_intersectors(pack)
    eps = options.ray_epsilon

    _, hit_id, hit = closest_fn(_detach(paths.org), _detach(paths.direction), eps)
    hit = hit & paths.active

    shade = functools.partial(_shade_bounce, scene, ctx, options, frame, depth, pack, cone)
    if options.remat_bounces and torch.is_grad_enabled() and _requires_grad(
            paths, pack.shade_table, scene.lights):
        shadow, shadow_c, nxt = checkpoint(
            shade, paths, hit_id, hit, use_reentrant=False, preserve_rng_state=False)
    else:
        shadow, shadow_c, nxt = shade(paths, hit_id, hit)

    blocked = any_fn(_detach(shadow.org), _detach(shadow.direction), eps,
                     shadow.t_max.detach())
    lit = shadow.active & ~blocked
    nxt.contrib = nxt.contrib + Vec3.where(lit, shadow_c, 0.0)
    return nxt, shadow


def _shade_bounce(scene: Scene, ctx: RenderContext, options: RenderOptions,
                  frame: FrameGlobals, depth: int, pack: AccelPack, cone, paths: Paths,
                  hit_id: torch.Tensor, hit: torch.Tensor):
    """The part of ``bounce`` between its two queries: the environment on
    misses, one row gather, shading, and the shadow and extension rays.
    Returns the ``ShadowRays``, the clamped contribution of each shadow ray
    that reaches its light, and the next ``Paths``, whose ``contrib`` lacks
    that contribution."""
    eps = options.ray_epsilon
    lights = scene.lights
    org, direction, weight = paths.org, paths.direction, paths.weight
    active, env_on_miss, contrib = paths.active, paths.env_on_miss, paths.contrib

    def clamp(c: Vec3) -> Vec3:
        if options.aov in ACCUM_AOVS:
            # The NaN and Inf detectors replace the firefly clamp
            # (``accumulator.rlsl:12-24``).
            return accum_visualize(options.aov, c)
        return c.minimum(frame.max_channel_value)

    # Miss: the environment, for camera and glass-refraction rays.
    if lights.env_enabled:
        miss_env = active & ~hit & env_on_miss
        env_c = env_radiance(lights, direction) * weight
        contrib = contrib + Vec3.where(miss_env, clamp(env_c), 0.0)

    # One row gather; t and barycentrics re-evaluated from the gathered
    # Woop rows; facing from the geometric normal.
    rows = gather_rows(pack.shade_table, hit_id.clamp(min=0))
    geo_n = rows.vec(GEO_N)
    front = direction.dot(geo_n) < 0.0
    t_d, b1, b2 = hit_attributes_rows(rows, org, direction, hit)
    t_sane = torch.where(hit, t_d, 1.0)
    path_len = None if paths.path_len is None else paths.path_len + torch.where(hit, t_sane, 0.0)

    res = shade_hits(
        scene, ctx.tables, frame.sample_index, depth, org, direction, weight,
        env_on_miss, paths.seq_id, paths.seq_off, rows, t_sane, b1, b2, front, hit,
        max_ray_depth=options.max_ray_depth,
        rr_start_depth=options.rr_start_depth,
        sample_mode=options.sample_mode,
        footprint_world=None if path_len is None else cone * path_len,
        ms_impl=options.ms_impl,
        ms_lut=ctx.ms_lut,
    )
    contrib = contrib + clamp(res.emission)
    p = org + direction * t_sane

    # NEE shadow rays: an occlusion query with per-ray maxT.
    s_org, s_dir = _park_dead(
        _offset_origin(p, geo_n, res.shadow_dir, eps), res.shadow_dir, res.shadow_active
    )
    shadow = ShadowRays(s_org, s_dir, res.shadow_max_t - 2.0 * eps, res.shadow_active)

    # Extension rays, dead lanes parked.
    e_org, e_dir = _park_dead(
        _offset_origin(p, geo_n, res.ext_dir, eps), res.ext_dir, res.ext_active
    )
    nxt = Paths(
        org=e_org, direction=e_dir, weight=res.ext_weight,
        env_on_miss=res.ext_env_on_miss, active=res.ext_active, contrib=contrib,
        seq_id=paths.seq_id, seq_off=paths.seq_off, pix=paths.pix, path_len=path_len,
    )
    return shadow, clamp(res.shadow_weight * res.shadow_radiance), nxt


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 6 bits of ``x`` so they interleave 3 ways (Morton)."""
    x = x & 0x3F
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _wavefront_sort_key(org: Vec3, direction: Vec3, active, lo, hi) -> torch.Tensor:
    """int32 coherence key of each lane, bit-equal to the JAX package's:
    3-bit direction octant (major) and a 6-bit-per-axis Morton code of the
    origin within the scene box ``lo``..``hi`` (minor).  Inactive lanes sort
    last, so live lanes form a prefix."""

    def q(c, lo_a, hi_a):
        s = (c - lo_a) / torch.clamp(hi_a - lo_a, min=1e-6) * 64.0
        # XLA's float -> int32 saturates (NaN -> 0); clamp first so the
        # truncating cast below sees only values it converts exactly.
        s = torch.nan_to_num(s, nan=0.0).clamp(-1.0, 64.0)
        return s.to(torch.int32).clamp(0, 63)

    morton = (
        _part1by2(q(org.x, lo[0], hi[0]))
        | (_part1by2(q(org.y, lo[1], hi[1])) << 1)
        | (_part1by2(q(org.z, lo[2], hi[2])) << 2)
    )
    octant = (
        (direction.x >= 0).int()
        | ((direction.y >= 0).int() << 1)
        | ((direction.z >= 0).int() << 2)
    )
    key = (octant << 18) | morton
    return torch.where(active, key, torch.tensor(1 << 28, dtype=torch.int32, device=key.device))


def _sort_bounds(pack: AccelPack):
    """(lo, hi): the scene box the sort key quantises origins in (no
    gradient, as in the JAX package)."""
    tri = pack.accel
    return tri.tri_min.detach().min(dim=1).values, tri.tri_max.detach().max(dim=1).values


def _sort_paths(paths: Paths, lo, hi) -> Paths:
    """Reorder the wavefront by ``_wavefront_sort_key`` (stable), every
    plane with one gather; under autograd the gathers' backward scatters
    each gradient back to its lane."""
    key = _wavefront_sort_key(_detach(paths.org), _detach(paths.direction), paths.active, lo, hi)
    order = torch.sort(key, stable=True).indices
    return paths.map(lambda p: p.index_select(0, order))


def _bounce_modes(ctx: RenderContext, options: RenderOptions, r: int):
    """(sort, gate) for this pass: "auto" sorts where the context lies on a
    CUDA device (the kernels), and gates whenever it sorts (gating needs the
    sorted prefix)."""
    if options.sort_bounces == "auto":
        sort_on = ctx.device.type == "cuda"
    else:
        sort_on = bool(options.sort_bounces)
    sort_on = sort_on and options.max_ray_depth > 1
    gate_on = sort_on if options.gate_bounces == "auto" else bool(options.gate_bounces) and sort_on
    return sort_on, gate_on and options.gate_segments > 1 and r > 1


def block_pixels(block: int, h: int, w: int, device, row_offset: int = 0) -> torch.Tensor:
    """(N,) int64 ids, in row order, of the pixels (x, y) of 3x3 block
    coordinate ``block``: ``x % 3 == block % 3``, ``(y + row_offset) % 3 ==
    block // 3`` (``perspective.rlsl:42-57``; the block's rows are global
    rows of a row-sharded image)."""
    ys = torch.arange((block // 3 - row_offset) % 3, h, 3, device=device)
    xs = torch.arange(block % 3, w, 3, device=device)
    return (ys[:, None] * w + xs[None, :]).reshape(-1)


def _gated_lanes(paths: Paths, segments: int) -> int:
    """How many leading lanes of a sorted wavefront the bounce must run: the
    live prefix rounded up to whole segments of ``ceil(R / segments)``
    (one host sync)."""
    r = paths.active.shape[0]
    seg = -(-r // segments)
    n_live = int(paths.active.sum())
    return min(r, -(-n_live // seg) * seg)


def render_pass(
    scene: Scene,
    camera: CameraParams,
    ctx: RenderContext,
    options: RenderOptions,
    frame: FrameGlobals,
    accum: torch.Tensor,
    with_stats: bool = False,
):
    """Trace one progressive pass and return ``accum`` plus its update.

    With ``with_stats=True`` returns ``(accum, {"rays": n})``, ``n`` the
    traced rays: per bounce, the live closest-hit lanes plus the shadow
    lanes (the rays/s benchmark count).  A context without a pack renders
    in the rebuild mode; a context made with ``static_shading=False``
    builds the pass's shading table here, from ``scene``.  With
    ``interactive_block`` the pass traces block ``frame.sample_index % 9``
    at sample index ``frame.sample_index // 9`` (see the module
    docstring).  ``frame.row_offset``: the global row of row 0 when the pass
    renders one rank's rows of a row-sharded image."""
    pack = ctx.accel_pack if ctx.accel_pack is not None else rebuild_pack(scene, options)
    pack = pass_pack(scene, pack, texture_tail(scene, options))
    cone = pixel_cone(scene, camera, options)
    h, w = options.height, options.width
    pixels = alpha = None
    if options.interactive_block:
        # Raygen and shading both draw at the block pass's sample index.
        block = frame.sample_index % 9
        frame = dataclasses.replace(frame, sample_index=frame.sample_index // 9)
        pixels = block_pixels(block, h, w, ctx.device, frame.row_offset)
    paths = start_paths(camera, ctx, options, frame.sample_index, cone=cone is not None,
                        row_offset=frame.row_offset)
    if pixels is not None:
        # The block's lanes alone, each keeping its pixel id in ``pix``.
        paths = paths.map(lambda p: p.index_select(0, pixels))
        alpha = torch.zeros(h * w, dtype=torch.float32, device=ctx.device).index_fill_(
            0, pixels, 1.0)
    r = paths.active.shape[0]
    if options.aov in SURFACE_AOVS:
        value = _surface_aov(scene, options, paths, pack)
        if pixels is not None:
            # As in the JAX package, a surface AOV counts the pass on every
            # pixel; the pixels off the block get a miss's zero.
            value = _to_pixels(value, paths.pix, h * w)
        accum = accum + _accum_update(value, h, w)
        return (accum, {"rays": r}) if with_stats else accum
    sort_on, gate_on = _bounce_modes(ctx, options, r)
    if sort_on:
        lo, hi = _sort_bounds(pack)
    ray_count = torch.zeros((), dtype=torch.int64, device=ctx.device)
    for depth in range(1, options.max_ray_depth + 1):
        # Camera rays arrive in pixel order, already coherent: the first
        # bounce runs unsorted.
        n = r
        if sort_on and depth > 1:
            paths = _sort_paths(paths, lo, hi)
            if gate_on:
                n = _gated_lanes(paths, options.gate_segments)
        if n == 0:
            continue  # no live lane: the carry passes through unchanged
        head = paths if n == r else paths.map(lambda p: p[:n])
        nxt, shadow = bounce(scene, ctx, options, frame, depth, head, pack, cone)
        if with_stats:
            ray_count += head.active.sum() + shadow.active.sum()
        # Lanes past the live prefix keep their carry unchanged.
        paths = nxt if n == r else _merge(nxt, paths.map(lambda p: p[n:]))

    contrib = paths.contrib
    if sort_on or pixels is not None:
        # Undo the permutations: lane i accumulates into pixel pix[i].
        contrib = _to_pixels(contrib, paths.pix, h * w)
    accum = accum + _accum_update(contrib, h, w, alpha)
    if with_stats:
        return accum, {"rays": int(ray_count)}
    return accum


def _to_pixels(v: Vec3, pix: torch.Tensor, n: int) -> Vec3:
    """Per-lane values to (n,) per-pixel planes: lane i into pixel
    ``pix[i]``, zero in pixels no lane holds."""
    return v.map(lambda c: torch.zeros(n, dtype=c.dtype, device=c.device).index_copy_(0, pix, c))


def _surface_aov(scene: Scene, options: RenderOptions, paths: Paths, pack: AccelPack) -> Vec3:
    """The attribute of a surface AOV at each camera ray's closest hit
    (``physicallyBased.rlsl:159-203``)."""
    _, hit_id, hit = _make_intersectors(pack)[0](
        _detach(paths.org), _detach(paths.direction), options.ray_epsilon)
    rows = gather_rows(pack.shade_table, hit_id.clamp(min=0))
    front = paths.direction.dot(rows.vec(GEO_N)) < 0.0
    _, b1, b2 = hit_attributes_rows(rows, paths.org, paths.direction, hit)
    return compute_surface_aov(scene, options.aov, rows, b1, b2, front, hit)


def render(
    scene: Scene,
    camera: CameraParams,
    options: RenderOptions,
    num_passes: int | None = None,
    ctx: RenderContext | None = None,
    max_channel_value: float = 3.14159265,
    accum: torch.Tensor | None = None,
    start_pass: int = 0,
    pass_callback=None,
    device="cuda",
):
    """Progressive render of ``num_passes`` passes on ``device`` (the card
    unless the caller names another).

    Returns (accum, ctx); ``accum`` is planar (4, H, W) and
    ``resolve(accum)`` the linear (H, W, 3) image.  ``accum``/``start_pass``
    resume a render; ``pass_callback(i, accum)`` fires after every pass."""
    device = _device(device)
    scene = scene.to(device)
    camera = camera.to(device)
    if ctx is None:
        ctx = make_context(options, scene, device)
    if num_passes is None:
        num_passes = options.max_render_passes
    if accum is None:
        accum = torch.zeros((4, options.height, options.width), dtype=torch.float32, device=device)
    if options.debug_pass_rendering:
        # Render exactly the chosen pass, without accumulation.
        frame = FrameGlobals.create(options.debug_pass_index, max_channel_value, device)
        return render_pass(scene, camera, ctx, options, frame, accum), ctx
    for i in range(start_pass, start_pass + num_passes):
        frame = FrameGlobals.create(i, max_channel_value, device)
        accum = render_pass(scene, camera, ctx, options, frame, accum)
        if pass_callback is not None:
            pass_callback(i, accum)
    return accum, ctx


def resolve(accum: torch.Tensor) -> torch.Tensor:
    """Planar (4, H, W) accumulation -> (H, W, 3) linear image (divide by
    the per-pixel pass count, ``displayGL.frag:76-78``)."""
    img = accum[:3] / torch.clamp(accum[3:], min=1.0)
    return img.permute(1, 2, 0)
