"""Wide (arity-8) BVH: the host builder and its traversal queries.

Port of ``heatray_tpu.ops.wide_bvh`` (``collapse_topology``,
``build_wide_bvh`` with the f32 leaf layout, ``intersect_closest_wide``,
``intersect_any_wide``, the large-leaf ``intersect_closest_stream``,
``intersect_any_stream``, and the transposed leaf math:
``intersect_closest_vpu``, ``intersect_any_vpu`` and the streaming pair's
``leaf_math="vpu"``).  The queries keep the JAX package's contract: closest
hit returns ``(t, slot, hit)`` with raw chunk-slot ids
(``chunk * leaf_size + j``) and ``(MISS_T, -1)`` on a miss; any hit returns
an (R,) blocked mask.

Each query has two versions.  On a CUDA tensor the wrapper launches the
hand-written kernel of ``csrc/wide_bvh.cu``, ``csrc/wide_bvh_stream.cu`` or
``csrc/wide_bvh_t.cu`` (built at first use) and counts the launch in its
``launches`` attribute; on a CPU tensor it runs the plain PyTorch version, a
brute force over the same slot-ordered, anchor-centred leaf rows
(``ops.intersect``).  The brute force has no tree, stack or visit order, so
it checks the kernel's walk independently.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ..vec import Vec3
from . import cuda_build
from .bvh import BLOCK, BVHTopology, build_topology, leaf_blocks, slot_boxes
from .intersect import BARY_EPS, MISS_T, WoopAccel, any_rows, chunk_rows, closest_rows

ARITY = 8
_BIG = np.float32(3.0e38)
# The kernels' slab test grows each box by BOX_PAD times its extent on every
# side: the pair test accepts points up to BARY_EPS outside a triangle, up to
# 3 BARY_EPS times the extent outside its box, and one more BARY_EPS covers
# the pair test's own rounding.  FAR_SCALE widens the far end of the slab
# interval against the slab's rounding.  Without them the walk culls hits
# the plain version finds.
BOX_PAD = 4.0 * BARY_EPS
FAR_SCALE = 1.0 + 2.0**-20
# Leaf pair-test math of the wide trees: "mxu" (K1/K3, exact f32 pair tests
# in the row layout of the TPU's MXU path) or "vpu" (K5/K4, the reference's
# transposed leaf math), whose leaves are a multiple of VPU_LEAF_ALIGN
# triangles.
LEAF_MATHS = ("mxu", "vpu")
VPU_LEAF_ALIGN = 128


@dataclasses.dataclass
class WideBVH:
    """Arity-8 BVH.

    ``wbox`` (Nw, 8, 8) f32: per node, 8 child boxes [min xyz, max xyz, pad];
    empty slots hold an inverted box.  ``wchild`` (Nw * 8,) i32 child codes:
    ``>= 0`` wide node, ``-1`` empty, ``<= -2`` leaf chunk ``-2 - code``.
    ``waxis`` (Nw,) i32: the axis children are sorted along.  ``w``
    (C, 4, 3 Tc) f32: per chunk, feature rows x, y, z, 1 against columns
    b1[Tc], b2[Tc], s[Tc] of the Woop rows, the translation re-centred on
    ``wanchor`` (3, C) in float64 at build time.  ``slot_tri`` (C * Tc,) i32
    maps slots to triangle ids (-1 padding).  ``max_stack`` is the deepest
    traversal stack the tree can need (every child of every node live).
    ``blocks`` (C, ceil(Tc / BLOCK), 6) f32: the world-space AABBs of each
    leaf's runs of BLOCK slots (``leaf_blocks``), which K5 and K4 cull by;
    the reference has none.
    """

    wbox: torch.Tensor
    wchild: torch.Tensor
    waxis: torch.Tensor
    w: torch.Tensor
    slot_tri: torch.Tensor
    wanchor: torch.Tensor
    leaf_size: int
    num_triangles: int
    max_stack: int
    blocks: torch.Tensor

    @property
    def num_nodes(self) -> int:
        return self.wbox.shape[0]

    @property
    def num_chunks(self) -> int:
        return self.w.shape[0]

    def to(self, device) -> "WideBVH":
        return dataclasses.replace(
            self,
            **{
                f.name: getattr(self, f.name).to(device)
                for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)
            },
        )


def collapse_topology(topo: BVHTopology, arity: int = ARITY):
    """Collapse a binary topology into arity-N nodes (host, numpy).

    Greedy: from a binary subtree root, repeatedly expand the internal slot
    of largest surface area until ``arity`` slots (or only leaves) remain;
    children are then sorted by centroid along the root box's widest axis.
    Returns numpy (wbox (Nw, 8, 8), wchild (Nw * 8,), waxis (Nw,)).
    """
    nbox, lc, skip = topo.nbox, topo.leaf_chunk, topo.skip

    def area(s: int) -> float:
        b = nbox[s]
        d = np.maximum(b[3:] - b[:3], 0.0)
        return float(d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

    wbox: list = [None]
    wchild: list = [None]
    waxis: list = [0]
    work = [(0, 0)]  # (binary root, wide node id to fill)
    while work:
        root, my = work.pop()
        slots = [root]
        while len(slots) < arity:
            cand = [s for s in slots if lc[s] < 0]
            if not cand:
                break
            s = max(cand, key=area)
            left = s + 1
            slots.remove(s)
            slots += [int(left), int(skip[left])]

        b = nbox[root]
        axis = int(np.argmax(b[3:] - b[:3]))
        cent = np.array([0.5 * (nbox[s][axis] + nbox[s][3 + axis]) for s in slots])
        slots = [slots[o] for o in np.argsort(cent, kind="stable")]

        boxes = np.empty((arity, 8), np.float32)
        boxes[:, 0:3] = _BIG
        boxes[:, 3:6] = -_BIG
        boxes[:, 6:8] = 0.0
        codes = np.full((arity,), -1, np.int32)
        for k, s in enumerate(slots):
            boxes[k, 0:6] = nbox[s]
            if lc[s] >= 0:
                codes[k] = -2 - lc[s]
            else:
                child_id = len(wbox)
                wbox.append(None)
                wchild.append(None)
                waxis.append(0)
                work.append((s, child_id))
                codes[k] = child_id
        wbox[my] = boxes
        wchild[my] = codes
        waxis[my] = axis

    return (
        np.stack(wbox, axis=0),
        np.concatenate(wchild),
        np.asarray(waxis, np.int32),
    )


def max_stack_depth(wchild: np.ndarray) -> int:
    """Deepest LIFO stack a traversal of the tree can reach: when a node is
    popped the stack holds at most its ancestors' other internal children,
    and the node then pushes all of its own."""
    codes = np.asarray(wchild).reshape(-1, ARITY)
    deepest = 0
    work = [(0, 0)]  # (node, entries below it when it is popped)
    while work:
        node, below = work.pop()
        kids = codes[node][codes[node] >= 0]
        peak = below + len(kids)
        deepest = max(deepest, peak)
        work.extend((int(k), peak - 1) for k in kids)
    return deepest


def build_wide_bvh(
    accel: WoopAccel, leaf_size: int = 32, include: np.ndarray | None = None
) -> WideBVH:
    """Binned-SAH binary build, arity-8 collapse and f32 Woop chunk packing,
    on the host.  ``include`` (T,) bool filters triangles (the occluder-only
    tree).  The result lies on ``accel``'s device."""
    tri_min = accel.tri_min.cpu().numpy()
    tri_max = accel.tri_max.cpu().numpy()
    topo = build_topology(tri_min, tri_max, leaf_size=leaf_size, include=include)
    wbox, wchild, waxis = collapse_topology(topo)

    tc = topo.leaf_size
    c = topo.num_chunks
    valid = (topo.slot_tri >= 0).astype(np.float32)
    safe = np.maximum(topo.slot_tri, 0)
    w = np.take(accel.w.cpu().numpy(), safe, axis=1).astype(np.float64) * valid[None, :]

    # Per-chunk anchors (chunk AABB centres), folded into the translation
    # column in float64: the fold is the cancellation-prone sum, so doing it
    # in double leaves the re-centred column accurate to its own f32 ulp.
    vmask = valid[None, :] > 0
    tmn = np.where(vmask, np.take(tri_min, safe, axis=1), np.inf)
    tmx = np.where(vmask, np.take(tri_max, safe, axis=1), -np.inf)
    lo = tmn.reshape(3, c, tc).min(axis=2)
    hi = tmx.reshape(3, c, tc).max(axis=2)
    ok = np.isfinite(lo) & np.isfinite(hi)
    anchors = np.where(ok, 0.5 * (lo + hi), 0.0).astype(np.float64)  # (3, C)
    a_slot = np.repeat(anchors, tc, axis=1)
    for g in range(3):
        w[4 * g + 3] += (
            a_slot[0] * w[4 * g + 0] + a_slot[1] * w[4 * g + 1] + a_slot[2] * w[4 * g + 2]
        )
    w = w.astype(np.float32)
    w = w.reshape(12, c, tc).transpose(1, 0, 2)
    w = w.reshape(c, 3, 4, tc).transpose(0, 2, 1, 3).reshape(c, 4, 3 * tc)

    dev = accel.w.device
    slot_tri = torch.from_numpy(topo.slot_tri).to(dev)
    return WideBVH(
        wbox=torch.from_numpy(np.ascontiguousarray(wbox)).to(dev),
        wchild=torch.from_numpy(np.ascontiguousarray(wchild)).to(dev),
        waxis=torch.from_numpy(waxis).to(dev),
        w=torch.from_numpy(np.ascontiguousarray(w)).to(dev),
        slot_tri=slot_tri,
        wanchor=torch.from_numpy(anchors.astype(np.float32)).to(dev),
        leaf_size=tc,
        num_triangles=accel.num_triangles,
        max_stack=max_stack_depth(wchild),
        blocks=leaf_blocks(*slot_boxes(slot_tri, accel.tri_min, accel.tri_max), tc),
    )


# --- plain versions ----------------------------------------------------------


def widened_slab(lo, hi, org, rcp, t_far, t_min):
    """The kernels' widened slab test (``wide_bvh_common.cuh`` ``slab``, the
    box grown by BOX_PAD, the far end by FAR_SCALE), broadcast: box corners
    ``lo``/``hi``, ray origins and reciprocal directions, three tensors
    each, and the far end ``t_far``."""
    near = far = None
    for a in range(3):
        p = (hi[a] - lo[a]) * BOX_PAD
        t0 = ((lo[a] - p) - org[a]) * rcp[a]
        t1 = ((hi[a] + p) - org[a]) * rcp[a]
        n, f = torch.minimum(t0, t1), torch.maximum(t0, t1)
        near = n if near is None else torch.maximum(near, n)
        far = f if far is None else torch.minimum(far, f)
    return near.clamp(min=t_min) <= torch.minimum(far, t_far) * FAR_SCALE


def reciprocals(directions: Vec3):
    """The kernels' safe reciprocal directions (``safe_inv``), three tensors."""
    return tuple(torch.where(c < 0, -1.0, 1.0) / c.abs().clamp(min=1e-18)
                 for c in (directions.x, directions.y, directions.z))


def slot_rows(bvh: WideBVH):
    """The leaf data as slot-ordered Woop rows: (rows (12, S), anchor (3, S))
    with ``rows[4 g + f, c Tc + j] = w[c, f, g Tc + j]``."""
    return chunk_rows(bvh.w), bvh.wanchor.repeat_interleave(bvh.leaf_size, dim=1)


def closest_wide_plain(bvh: WideBVH, origins: Vec3, directions: Vec3, t_min=1e-4):
    """Brute-force closest hit over the tree's slot rows: (t, slot, hit)."""
    rows, anchor = slot_rows(bvh)
    return closest_rows(origins, directions, rows, t_min, anchor)


def any_wide_plain(bvh: WideBVH, origins: Vec3, directions: Vec3, t_min=1e-4, t_max=3.0e37):
    """Brute-force any hit in (t_min, t_max) over the tree's slot rows."""
    rows, anchor = slot_rows(bvh)
    return any_rows(origins, directions, rows, t_min, t_max, anchor)


def closest_stream_plain(bvh: WideBVH, origins: Vec3, directions: Vec3, t_min=1e-4):
    """The streaming kernel's plain version: the same brute force, over a
    tree with larger leaves."""
    return closest_wide_plain(bvh, origins, directions, t_min)


def any_stream_plain(bvh: WideBVH, origins: Vec3, directions: Vec3, t_min=1e-4, t_max=3.0e37):
    """The streaming occlusion kernel's plain version (see
    ``closest_stream_plain``)."""
    return any_wide_plain(bvh, origins, directions, t_min, t_max)


# --- kernel wrappers ---------------------------------------------------------

_P = ctypes.c_void_p
_CLOSEST_ARGS = (
    [_P] * 6 + [ctypes.c_int] + [_P] * 5
    + [ctypes.c_int, ctypes.c_int] + [ctypes.c_float] * 3 + [_P, _P, _P]
)
_ANY_ARGS = (
    [_P] * 7 + [ctypes.c_int] + [_P] * 5
    + [ctypes.c_int, ctypes.c_int] + [ctypes.c_float] * 3 + [_P, _P]
)
# K5's and K4's: the tree's block boxes after the ray count.
_CLOSEST_BLOCK_ARGS = _CLOSEST_ARGS[:7] + [_P] + _CLOSEST_ARGS[7:]
_ANY_BLOCK_ARGS = _ANY_ARGS[:8] + [_P] + _ANY_ARGS[8:]


def _bind(name: str, depth_fns: tuple, pairs: tuple) -> ctypes.CDLL:
    """Load ``csrc/<name>.cu`` and declare its stack-depth getters and its
    (closest hit, occlusion) entry points."""
    lib = cuda_build.load(name)
    for fn in depth_fns:
        getattr(lib, fn).argtypes = []
        getattr(lib, fn).restype = ctypes.c_int
    for closest, any_ in pairs:
        for fn, args in ((closest, _CLOSEST_ARGS), (any_, _ANY_ARGS)):
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _kernels() -> ctypes.CDLL:
    return _bind("wide_bvh", ("wide_bvh_stack_depth",), (("closest_wide", "any_wide"),))


@functools.lru_cache(maxsize=None)
def _stream_kernels() -> ctypes.CDLL:
    return _bind("wide_bvh_stream", ("wide_bvh_stream_stack_depth",),
                 (("closest_stream", "any_stream"),))


@functools.lru_cache(maxsize=None)
def _t_kernels() -> ctypes.CDLL:
    lib = _bind("wide_bvh_t", ("wide_t_stack_depth", "stream_t_stack_depth"),
                (("closest_wide_t", "any_wide_t"), ("closest_stream_t", "any_stream_t")))
    for fn in (lib.closest_wide_t, lib.closest_stream_t):
        fn.argtypes = _CLOSEST_BLOCK_ARGS
    for fn in (lib.any_wide_t, lib.any_stream_t):
        fn.argtypes = _ANY_BLOCK_ARGS
    return lib


def on_cpu(tree) -> bool:
    """True for a tree, chunk pack or tensor on the CPU (plain version);
    raises unless it lies on a CUDA device (kernel)."""
    device = tree.device if isinstance(tree, torch.Tensor) else tree.w.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no traversal kernel for device {device}")
    return device.type == "cpu"


def _ray_ptrs(origins: Vec3, directions: Vec3, device):
    comps = [origins.x, origins.y, origins.z, directions.x, directions.y, directions.z]
    for c in comps:
        if (c.dtype != torch.float32 or c.device != device or c.dim() != 1
                or c.shape != comps[0].shape):
            raise ValueError("rays must be float32 (R,) tensors on the tree's device")
    comps = [c.contiguous() for c in comps]
    return comps, [c.data_ptr() for c in comps]


def _tree_args(bvh: WideBVH, depth: int) -> list:
    if bvh.max_stack > depth:
        raise ValueError(
            f"tree needs a traversal stack of {bvh.max_stack}, the kernel has {depth}"
        )
    for name, dtype in (("wbox", torch.float32), ("wchild", torch.int32),
                        ("waxis", torch.int32), ("w", torch.float32),
                        ("wanchor", torch.float32)):
        a = getattr(bvh, name)
        if a.dtype != dtype or not a.is_contiguous():
            raise ValueError(f"WideBVH.{name} must be a contiguous {dtype} tensor")
    return [bvh.wbox.data_ptr(), bvh.wchild.data_ptr(), bvh.waxis.data_ptr(),
            bvh.w.data_ptr(), bvh.wanchor.data_ptr(), bvh.num_chunks, bvh.leaf_size]


def _block_tree_args(bvh: WideBVH, depth: int) -> list:
    """``_tree_args`` after the tree's block boxes (K5, K4), which it must
    carry."""
    tree = _tree_args(bvh, depth)
    blocks = bvh.blocks
    if blocks is None:
        raise ValueError("the kernel culls by the leaves' block boxes: the tree has no "
                         "WideBVH.blocks")
    if (blocks.dtype != torch.float32 or not blocks.is_contiguous()
            or blocks.shape != (bvh.num_chunks, -(-bvh.leaf_size // BLOCK), 6)
            or blocks.device != bvh.w.device):
        raise ValueError("WideBVH.blocks must be a contiguous float32 (C, leaf_size / 32, 6) "
                         "tensor on the tree's device")
    return [blocks.data_ptr()] + tree


def launch(fn, device, *args) -> None:
    """Call the C entry point ``fn(*args, stream)`` with the raw handle of
    ``device``'s current stream, and raise on a refused launch.  The
    handle is read without building a ``torch.cuda.Stream``, and the device
    guard is entered only when ``device`` is not the current device: both
    cost more host time than the launch itself."""
    index = device.index
    if index == torch._C._cuda_getDevice():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"{fn.__name__} kernel launch failed with CUDA error {err}")


def launch_closest(kernel, tree: list, bvh, origins: Vec3, directions: Vec3, t_min: float):
    """Launch a closest-hit kernel whose C entry takes the six ray planes,
    their count, ``tree``, t_min, the slab widening, t and slot outputs and
    the stream: (t, slot, hit) on ``bvh.w``'s device."""
    device = bvh.w.device
    comps, ptrs = _ray_ptrs(origins, directions, device)
    r = comps[0].shape[0]
    t = torch.empty((r,), dtype=torch.float32, device=device)
    slot = torch.empty((r,), dtype=torch.int32, device=device)
    launch(kernel, device, *ptrs, r, *tree, float(t_min), BOX_PAD, FAR_SCALE, t.data_ptr(),
           slot.data_ptr())
    return t, slot, slot >= 0


def launch_any(kernel, tree: list, bvh, origins: Vec3, directions: Vec3, t_min: float, t_max):
    """As ``launch_closest``, for an occlusion kernel: per-ray t_max after the
    ray planes, one blocked byte per ray out."""
    device = bvh.w.device
    comps, ptrs = _ray_ptrs(origins, directions, device)
    r = comps[0].shape[0]
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=device)
    t_max = t_max.expand(r).contiguous()
    blocked = torch.empty((r,), dtype=torch.bool, device=device)
    launch(kernel, device, *ptrs, t_max.data_ptr(), r, *tree, float(t_min), BOX_PAD, FAR_SCALE,
           blocked.data_ptr())
    return blocked


def intersect_closest_wide(bvh: WideBVH, origins: Vec3, directions: Vec3, t_min: float = 1e-4):
    """Closest hit of each ray (Vec3 of (R,)): ``(t, slot, hit)``.

    CPU tensors take the plain version; CUDA tensors launch
    ``closest_wide_kernel`` (``csrc/wide_bvh.cu``) on the tree's device and
    its current stream: a walk per ray, and the warp tests each (ray, leaf)
    pair that a walk reaches, one triangle per lane in blocks of 32."""
    if on_cpu(bvh):
        return closest_wide_plain(bvh, origins, directions, t_min)
    lib = _kernels()
    out = launch_closest(lib.closest_wide, _tree_args(bvh, lib.wide_bvh_stack_depth()),
                          bvh, origins, directions, t_min)
    if origins.x.numel():
        intersect_closest_wide.launches += 1
    return out


def intersect_any_wide(
    bvh: WideBVH, origins: Vec3, directions: Vec3, t_min: float = 1e-4, t_max=3.0e37
):
    """Occlusion: is there any hit in (t_min, t_max) of each ray?  ``t_max``
    is a float or an (R,) tensor.  Returns an (R,) bool mask.

    CPU tensors take the plain version; CUDA tensors launch
    ``any_wide_kernel`` on the tree's device and its current stream (the
    walk of ``intersect_closest_wide``, a blocked ray's walk ended)."""
    if on_cpu(bvh):
        return any_wide_plain(bvh, origins, directions, t_min, t_max)
    lib = _kernels()
    out = launch_any(lib.any_wide, _tree_args(bvh, lib.wide_bvh_stack_depth()),
                      bvh, origins, directions, t_min, t_max)
    if origins.x.numel():
        intersect_any_wide.launches += 1
    return out


def _check_leaf_math(leaf_math: str) -> None:
    if leaf_math not in LEAF_MATHS:
        raise ValueError(f"leaf_math must be one of {LEAF_MATHS}, not {leaf_math!r}")


def intersect_closest_stream(bvh: WideBVH, origins: Vec3, directions: Vec3,
                             t_min: float = 1e-4, leaf_math: str = "mxu"):
    """Closest hit over a tree with large leaves (``stream_leaf_size``), the
    contract of ``intersect_closest_wide``.

    CPU tensors take the plain version; CUDA tensors launch
    ``closest_stream_kernel`` (``csrc/wide_bvh_stream.cu``), in which each
    thread walks its own ray and the warp tests each (ray, leaf) pair that
    a walk reaches with the leaf's triangles spread across its lanes, or
    with ``leaf_math="vpu"`` ``intersect_closest_stream_vpu``'s kernel."""
    _check_leaf_math(leaf_math)
    if leaf_math == "vpu":
        return intersect_closest_stream_vpu(bvh, origins, directions, t_min)
    if on_cpu(bvh):
        return closest_stream_plain(bvh, origins, directions, t_min)
    lib = _stream_kernels()
    out = launch_closest(lib.closest_stream, _tree_args(bvh, lib.wide_bvh_stream_stack_depth()),
                         bvh, origins, directions, t_min)
    if origins.x.numel():
        intersect_closest_stream.launches += 1
    return out


def intersect_any_stream(
    bvh: WideBVH, origins: Vec3, directions: Vec3, t_min: float = 1e-4, t_max=3.0e37,
    leaf_math: str = "mxu",
):
    """Occlusion over a tree with large leaves, the contract of
    ``intersect_any_wide``.

    CPU tensors take the plain version; CUDA tensors launch
    ``any_stream_kernel`` (``csrc/wide_bvh_stream.cu``: a walk per ray, the
    leaf tests shared by the warp, a blocked ray's walk ended), or with
    ``leaf_math="vpu"`` ``intersect_any_stream_vpu``'s kernel."""
    _check_leaf_math(leaf_math)
    if leaf_math == "vpu":
        return intersect_any_stream_vpu(bvh, origins, directions, t_min, t_max)
    if on_cpu(bvh):
        return any_stream_plain(bvh, origins, directions, t_min, t_max)
    lib = _stream_kernels()
    out = launch_any(lib.any_stream, _tree_args(bvh, lib.wide_bvh_stream_stack_depth()),
                     bvh, origins, directions, t_min, t_max)
    if origins.x.numel():
        intersect_any_stream.launches += 1
    return out


# --- the transposed ("vpu") leaf math ------------------------------------------


def _check_t_leaf(bvh: WideBVH) -> None:
    """The transposed kernels, like the reference's, take leaves of a
    multiple of 128 triangles (4 per lane of a warp, or more)."""
    if bvh.leaf_size % VPU_LEAF_ALIGN:
        raise ValueError(
            f"the 'vpu' leaf math needs a leaf size that is a multiple of {VPU_LEAF_ALIGN}, "
            f"not {bvh.leaf_size}"
        )


def intersect_closest_vpu(bvh: WideBVH, origins: Vec3, directions: Vec3, t_min: float = 1e-4):
    """Closest hit with the transposed leaf math (``wide_leaf_math="vpu"``),
    the contract of ``intersect_closest_wide``; the leaf size must be a
    multiple of 128.

    CPU tensors take the plain version (``closest_wide_plain``); CUDA tensors
    launch ``closest_wide_t_kernel`` (``csrc/wide_bvh_t.cu``): a walk per
    ray, and each leaf a walk reaches served block of 32 by block, each block
    only to the rays that enter its box (``WideBVH.blocks``: a tree without
    them raises), one triangle per lane."""
    _check_t_leaf(bvh)
    if on_cpu(bvh):
        return closest_wide_plain(bvh, origins, directions, t_min)
    lib = _t_kernels()
    out = launch_closest(lib.closest_wide_t, _block_tree_args(bvh, lib.wide_t_stack_depth()),
                         bvh, origins, directions, t_min)
    if origins.x.numel():
        intersect_closest_vpu.launches += 1
    return out


def intersect_any_vpu(
    bvh: WideBVH, origins: Vec3, directions: Vec3, t_min: float = 1e-4, t_max=3.0e37
):
    """Occlusion with the transposed leaf math, the contract of
    ``intersect_any_wide``; CUDA tensors launch ``any_wide_t_kernel``
    (``csrc/wide_bvh_t.cu``), the kernel of ``intersect_any_stream_vpu``
    over Route A's tree: a walk per ray, each leaf it reaches served block
    of 32 by block, each block only to the unblocked rays that enter its box
    (``WideBVH.blocks``: a tree without them raises) before their
    ``t_max``, a blocked ray's walk ended."""
    _check_t_leaf(bvh)
    if on_cpu(bvh):
        return any_wide_plain(bvh, origins, directions, t_min, t_max)
    lib = _t_kernels()
    out = launch_any(lib.any_wide_t, _block_tree_args(bvh, lib.wide_t_stack_depth()),
                     bvh, origins, directions, t_min, t_max)
    if origins.x.numel():
        intersect_any_vpu.launches += 1
    return out


def intersect_closest_stream_vpu(bvh: WideBVH, origins: Vec3, directions: Vec3,
                                 t_min: float = 1e-4):
    """``intersect_closest_stream(..., leaf_math="vpu")``: CPU tensors take
    the plain version (``closest_stream_plain``); CUDA tensors launch
    ``closest_stream_t_kernel`` (``csrc/wide_bvh_t.cu``), the kernel of
    ``intersect_closest_vpu`` over the streaming backend's tree: a walk per
    ray with a stack of 64, each leaf it reaches served block of 32 by
    block, each block only to the rays that enter its box
    (``WideBVH.blocks``: a tree without them raises) before their best."""
    _check_t_leaf(bvh)
    if on_cpu(bvh):
        return closest_stream_plain(bvh, origins, directions, t_min)
    lib = _t_kernels()
    out = launch_closest(lib.closest_stream_t,
                         _block_tree_args(bvh, lib.stream_t_stack_depth()),
                         bvh, origins, directions, t_min)
    if origins.x.numel():
        intersect_closest_stream_vpu.launches += 1
    return out


def intersect_any_stream_vpu(
    bvh: WideBVH, origins: Vec3, directions: Vec3, t_min: float = 1e-4, t_max=3.0e37
):
    """``intersect_any_stream(..., leaf_math="vpu")``: CPU tensors take the
    plain version (``any_stream_plain``); CUDA tensors launch
    ``any_stream_t_kernel``: the walk of ``intersect_closest_stream_vpu``
    with the leaves in the walk's order, each block served only to the
    unblocked rays that enter its box before their ``t_max``, a blocked
    ray's walk ended (``WideBVH.blocks``: a tree without them raises)."""
    _check_t_leaf(bvh)
    if on_cpu(bvh):
        return any_stream_plain(bvh, origins, directions, t_min, t_max)
    lib = _t_kernels()
    out = launch_any(lib.any_stream_t, _block_tree_args(bvh, lib.stream_t_stack_depth()),
                     bvh, origins, directions, t_min, t_max)
    if origins.x.numel():
        intersect_any_stream_vpu.launches += 1
    return out


intersect_closest_wide.launches = 0
intersect_any_wide.launches = 0
intersect_closest_stream.launches = 0
intersect_any_stream.launches = 0
intersect_closest_vpu.launches = 0
intersect_any_vpu.launches = 0
intersect_closest_stream_vpu.launches = 0
intersect_any_stream_vpu.launches = 0
