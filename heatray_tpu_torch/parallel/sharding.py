"""Multi-device rendering and inverse rendering over ``torch.distributed``
(port of ``heatray_tpu.parallel.sharding``).

The parallel axes:

- ``dp`` (data parallel over pixels): each rank renders its own image rows
  with the single-device ``render_pass``, from its rows of the full image's
  per-pixel sample tables (``shard_context``); the scene and its trees are
  replicated.  The forward pass needs no communication until the rows are
  gathered.
- ``sp`` (sample parallel over passes): the ranks of the ``sp`` axis render
  different QMC pass indices, and their accumulations are summed over the
  axis once per render.

Every rank calls the same function (SPMD), as every device runs the
``shard_map`` body in the JAX package; a collective that one rank issues and
another does not hangs, so the process group's timeout is what ends it.

The collectives are ``all_reduce`` (SUM, MIN, MAX) and ``broadcast`` alone,
on tensors on the rank's device.  NCCL takes one rank per card; gloo also
takes CUDA tensors, but for these two collectives only, and lets several
ranks share one card.  So rows are gathered by an ``all_reduce(SUM)`` of each
rank's rows placed in a zeroed full image (exact: every other rank adds
zeros), and the same code runs on NCCL with one rank per card, on gloo with
several ranks on one card and on gloo over the CPU.  The backend is the
caller's choice (``initialize_distributed``), "nccl" by default for the
card and "gloo" for the CPU; nothing switches it.

Parameter gradients: each rank's loss is its rows' squared error over the
full image's element count, and one ``all_reduce(SUM)`` of the loss and of
each parameter's gradient gives the single-device mean and its gradient.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os

import torch
import torch.distributed as dist

from ..camera import CameraParams
from ..options import FrameGlobals, RenderOptions
from ..render.integrator import RenderContext, render_pass
from ..scene.scene import Scene

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """The ranks of a process group laid out on named axes, row-major
    (rank = the coordinates' row-major index), and this rank's device.
    ``groups`` maps an axis to the process group of the ranks that share
    this rank's other coordinates (None: the whole group).  Without an
    initialised process group the mesh is one rank and its collectives do
    nothing."""

    axis_names: tuple
    sizes: tuple
    rank: int
    device: torch.device
    groups: dict
    distributed: bool

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    def coordinate(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        i = self.axis_names.index(axis)
        return self.rank // math.prod(self.sizes[i + 1:]) % self.sizes[i]

    def all_reduce(self, tensor: torch.Tensor, op: str = "sum", axis: str | None = None):
        """Reduce ``tensor`` in place over ``axis`` (None: the whole mesh)
        with ``op`` ("sum", "min" or "max"); returns it."""
        if self.distributed:
            dist.all_reduce(tensor, _OPS[op], group=self.groups[axis] if axis else None)
        return tensor

    def broadcast(self, tensor: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Overwrite ``tensor`` in place with rank ``src``'s over the whole
        mesh; returns it."""
        if self.distributed:
            if tensor.dtype == torch.bool:
                dist.broadcast(tensor.view(torch.uint8), src)
            else:
                dist.broadcast(tensor, src)
        return tensor


def _world() -> tuple[bool, int, int]:
    """(initialised, world size, rank) of the default process group."""
    if dist.is_available() and dist.is_initialized():
        return True, dist.get_world_size(), dist.get_rank()
    return False, 1, 0


def _rank_device(device, rank: int) -> torch.device:
    """The caller's device, or ``cuda:{LOCAL_RANK % device_count}``."""
    if device is not None:
        device = torch.device(device)
    else:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("no CUDA device: pass device='cpu' to shard over the CPU")
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device(f"cuda:{local % count}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return device


def make_mesh(n_devices: int | None = None, axis: str = "dp", device=None) -> Mesh:
    """1D mesh over the ranks of the default process group; it must have
    exactly ``n_devices`` ranks (all of them when None), and without one
    ``n_devices`` must be 1.  ``device``: this rank's (default
    ``cuda:{LOCAL_RANK % device_count}``).  Nothing falls back to the CPU."""
    distributed, world, rank = _world()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"a mesh of {n} ranks needs a process group of {n}, this one has {world}")
    return Mesh((axis,), (n,), rank, _rank_device(device, rank), {axis: None}, distributed)


def make_mesh_2d(n_sample: int, n_pixel: int, device=None) -> Mesh:
    """2D ``("sp", "dp")`` mesh: sample parallelism on the outer axis (it
    communicates once per render, so it may span hosts), pixel rows on the
    inner one.  The process group must have exactly ``n_sample * n_pixel``
    ranks; rank r sits at (r // n_pixel, r % n_pixel).  Every rank makes the
    axes' subgroups, in the same order."""
    distributed, world, rank = _world()
    if n_sample * n_pixel != world:
        raise ValueError(f"a {n_sample}x{n_pixel} mesh needs a process group of "
                         f"{n_sample * n_pixel}, this one has {world}")
    groups = {"sp": None, "dp": None}
    if distributed:
        dp = [dist.new_group([s * n_pixel + p for p in range(n_pixel)]) for s in range(n_sample)]
        sp = [dist.new_group([s * n_pixel + p for s in range(n_sample)]) for p in range(n_pixel)]
        groups = {"sp": sp[rank % n_pixel], "dp": dp[rank // n_pixel]}
    return Mesh(("sp", "dp"), (n_sample, n_pixel), rank, _rank_device(device, rank), groups,
                distributed)


def initialize_distributed(
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    backend: str | None = None,
    device="cuda",
    timeout_s: float | None = None,
) -> None:
    """Join the default process group: ``torch.distributed.init_process_group``
    from explicit arguments (``init_method`` such as ``tcp://localhost:PORT``
    or ``file:///path``, ``world_size``, ``rank``) or from the environment
    ``torchrun`` sets (``MASTER_ADDR``, ``WORLD_SIZE``, ``RANK``).  A no-op
    when already initialised, or when there are neither arguments nor that
    environment (one process).  ``backend``: "nccl" by default where the
    tensors lie on the card (``device``), "gloo" on the CPU; several ranks
    on one card need "gloo".  ``timeout_s``: how long a collective may wait
    before it fails."""
    if dist.is_initialized():
        return
    if init_method is None:
        if "MASTER_ADDR" not in os.environ:
            return
        init_method = "env://"
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    kw = {}
    if world_size is not None:
        kw.update(world_size=world_size, rank=rank)
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method, **kw)


def replicate(tree, mesh: Mesh):
    """A copy of ``tree`` (tensors, dataclasses, dicts, lists or tuples of
    them) on the mesh's device, every tensor broadcast from rank 0."""

    def walk(x):
        if isinstance(x, torch.Tensor):
            return mesh.broadcast(x.detach().to(mesh.device, copy=True).contiguous())
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return dataclasses.replace(x, **{f.name: walk(getattr(x, f.name))
                                             for f in dataclasses.fields(x) if f.init})
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        return x

    return walk(tree)


def _rows(mesh: Mesh, axis: str, height: int) -> slice:
    """This rank's image rows along ``axis``."""
    n = mesh.shape[axis]
    if height % n:
        raise ValueError(f"image rows ({height}) must divide over the mesh axis ({n})")
    h = height // n
    k = mesh.coordinate(axis)
    return slice(k * h, (k + 1) * h)


def _canonical(device) -> torch.device:
    """``device`` with its index ("cuda" is the current card)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def shard_context(ctx: RenderContext, mesh: Mesh, axis: str = "dp") -> RenderContext:
    """This rank's context: the rows of the full image's per-pixel sample
    tables that it renders, the rest of the tables and the multiscatter
    table whole, all on the mesh's device.  ``ctx`` is the full image's; an
    acceleration pack must already lie on the mesh's device, and must not
    be the ``"sharded"`` backend's: its reductions take every rank's lanes
    to be the same rays, which rows or slices of other ranks are not."""
    if ctx.accel_pack is not None and ctx.accel_pack.backend == "sharded":
        raise ValueError("a context of the \"sharded\" backend renders the whole image on "
                         "every rank: render it with render(), not over rows or slices")
    if ctx.accel_pack is not None and _canonical(ctx.device) != mesh.device:
        raise ValueError(f"the context's pack lies on {ctx.device}, the mesh's rank on "
                         f"{mesh.device}: make the context on the mesh's device")
    rows = _rows(mesh, axis, ctx.tables.pixel_sequence_id.shape[0])
    dev = mesh.device
    t = ctx.tables
    tables = dataclasses.replace(
        t,
        seq_u=t.seq_u.to(dev), seq_v=t.seq_v.to(dev),
        aperture_u=t.aperture_u.to(dev), aperture_v=t.aperture_v.to(dev),
        pixel_sequence_id=t.pixel_sequence_id[rows].contiguous().to(dev),
        pixel_sequence_offset=t.pixel_sequence_offset[rows].contiguous().to(dev),
    )
    return dataclasses.replace(ctx, tables=tables, ms_lut=ctx.ms_lut.to(dev), device=dev)


def sharded_accum(options: RenderOptions, mesh: Mesh, axis: str = "dp") -> torch.Tensor:
    """This rank's zero planar (4, H / n, W) accumulation rows."""
    rows = _rows(mesh, axis, options.height)
    return torch.zeros((4, rows.stop - rows.start, options.width), dtype=torch.float32,
                       device=mesh.device)


def _rank_view(ctx: RenderContext, options: RenderOptions, mesh: Mesh, axis: str):
    """(this rank's options, its context, its global rows) on ``axis``."""
    return (_local_options(options, mesh.shape[axis]), shard_context(ctx, mesh, axis),
            _rows(mesh, axis, options.height))


def _target_rows(target, rows: slice, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of an (H, W, 3) target, planar (3, h, W)."""
    t = torch.as_tensor(target, dtype=torch.float32).permute(2, 0, 1)[:, rows]
    return t.contiguous().to(mesh.device)


def _local_options(options: RenderOptions, n: int) -> RenderOptions:
    """Per-rank options: the rank's row count, the full image's camera
    mapping (``image_height``)."""
    if options.height % n:
        raise ValueError(f"image rows ({options.height}) must divide over the mesh axis ({n})")
    return dataclasses.replace(options, height=options.height // n,
                               image_height=options.image_height or options.height)


def _gather_rows(rows_accum: torch.Tensor, mesh: Mesh, axis: str, height: int) -> torch.Tensor:
    """The full (C, H, W) image on every rank of ``axis``: each rank's rows
    placed in a zeroed image, summed over the axis (exact)."""
    full = rows_accum.new_zeros((rows_accum.shape[0], height, rows_accum.shape[2]))
    full[:, _rows(mesh, axis, height)] = rows_accum
    return mesh.all_reduce(full, "sum", axis)


def make_sharded_pass(
    scene: Scene,
    camera: CameraParams,
    ctx: RenderContext,
    options: RenderOptions,
    mesh: Mesh,
    axis: str = "dp",
):
    """One pass over this rank's rows: ``pass_fn(accum_rows, frame) ->
    accum_rows`` runs the single-device ``render_pass`` on its rows
    (``frame.row_offset`` set to its first global row) with no
    communication.  ``ctx`` is the full image's context; ``scene`` and
    ``camera`` must be the same on every rank (``replicate``)."""
    local_opts, ctx_local, rows = _rank_view(ctx, options, mesh, axis)

    def pass_fn(accum_rows: torch.Tensor, frame: FrameGlobals) -> torch.Tensor:
        frame = dataclasses.replace(frame, row_offset=rows.start)
        return render_pass(scene, camera, ctx_local, local_opts, frame, accum_rows)

    return pass_fn


def render_sharded(
    scene: Scene,
    camera: CameraParams,
    ctx: RenderContext,
    options: RenderOptions,
    mesh: Mesh,
    num_passes: int,
    max_channel_value: float = 3.14159265,
    axis: str = "dp",
) -> torch.Tensor:
    """Progressive render with pixel rows sharded over ``mesh[axis]`` (see
    ``make_sharded_pass``).  Returns the full planar (4, H, W) accumulation
    on every rank of the axis, gathered once after the passes."""
    scene, camera = replicate(scene, mesh), replicate(camera, mesh)
    pass_fn = make_sharded_pass(scene, camera, ctx, options, mesh, axis)
    accum = sharded_accum(options, mesh, axis)
    for i in range(num_passes):
        accum = pass_fn(accum, FrameGlobals.create(i, max_channel_value, mesh.device))
    return _gather_rows(accum, mesh, axis, options.height)


class _Stepper:
    """The optimizer a train step makes from its parameter tensors
    (``optimizer(list of tensors)``, as ``diff.inverse.optimize`` takes
    one), made again when the step is given other tensors; the tensors are
    broadcast from rank 0 first, so every rank starts from the same values."""

    def __init__(self, optimizer, mesh: Mesh):
        self.factory, self.mesh, self.key, self.opt = optimizer, mesh, None, None

    def zero_grad(self, params: dict) -> list:
        tensors = list(params.values())
        key = tuple(id(t) for t in tensors)
        if key != self.key:
            with torch.no_grad():
                for t in tensors:
                    self.mesh.broadcast(t)
            self.key, self.opt = key, self.factory(tensors)
        self.opt.zero_grad(set_to_none=True)
        return tensors

    def step(self, tensors: list, axis: str | None) -> None:
        """Sum each gradient over ``axis`` (None: the whole mesh), then step."""
        for t in tensors:
            if t.grad is None:  # no path on this rank reached it
                t.grad = torch.zeros_like(t)
            self.mesh.all_reduce(t.grad, "sum", axis)
        self.opt.step()


def make_sharded_train_step(
    scene: Scene,
    camera: CameraParams,
    ctx: RenderContext,
    options: RenderOptions,
    target,
    mesh: Mesh,
    optimizer,
    axis: str = "dp",
):
    """Inverse-rendering step with pixel rows sharded over ``mesh[axis]``:
    ``step_fn(params, sample_index) -> (params, loss)``.

    ``params`` is a dict of material-parameter leaf tensors that require
    gradients (``diff.inverse.apply_material_params``; ``ctx`` made with
    ``static_shading=False``); ``optimizer`` maps the list of those tensors
    to a ``torch.optim.Optimizer`` and keeps its state, so the step updates
    ``params`` in place and returns them with the loss, where the JAX
    package returns ``(params, opt_state, loss)``.  Each rank renders one
    pass at ``sample_index`` over its rows; its loss is its rows' squared
    error over the full image's element count, and the loss and every
    gradient are summed over the axis: the single-device
    ``mean((img - target)**2)`` and its gradient.  ``target`` is the full
    (H, W, 3) linear image."""
    from ..diff.inverse import apply_material_params

    scene, camera = replicate(scene, mesh), replicate(camera, mesh)
    local_opts, ctx_local, rows = _rank_view(ctx, options, mesh, axis)
    target_rows = _target_rows(target, rows, mesh)
    count = 3 * options.height * options.width
    stepper = _Stepper(optimizer, mesh)

    def step_fn(params: dict, sample_index: int):
        tensors = stepper.zero_grad(params)
        frame = FrameGlobals.create(sample_index, device=mesh.device, row_offset=rows.start)
        accum = render_pass(apply_material_params(scene, params), camera, ctx_local, local_opts,
                            frame, sharded_accum(options, mesh, axis))
        img = accum[:3] / torch.clamp(accum[3:], min=1.0)
        loss = ((img - target_rows) ** 2).sum() / count
        loss.backward()
        stepper.step(tensors, axis)
        return params, mesh.all_reduce(loss.detach().clone(), "sum", axis)

    return step_fn


# ---------------------------------------------------------------------------
# 2D (sp, dp): sample parallelism x pixel-row parallelism
# ---------------------------------------------------------------------------


def _sp_accum(options: RenderOptions, mesh: Mesh) -> torch.Tensor:
    """This rank's zero accumulation: its sample slice's (4, H / dp, W) rows."""
    return sharded_accum(options, mesh, "dp")


def render_sharded_2d(
    scene: Scene,
    camera: CameraParams,
    ctx: RenderContext,
    options: RenderOptions,
    mesh: Mesh,
    num_passes: int,
    max_channel_value: float = 3.14159265,
) -> torch.Tensor:
    """Progressive render over a 2D ``("sp", "dp")`` mesh.  Pass indices
    interleave over ``sp`` (slice k traces passes k, k + S, ...), each slice
    keeps its own accumulation of its ``dp`` rows, and ONE sum over ``sp``
    at the end merges them: the sample-parallel axis the reference runs
    serially (``PassGenerator.cpp:346-400``).  Returns the merged full
    (4, H, W) accumulation on every rank."""
    s = mesh.shape["sp"]
    if num_passes % s:
        raise ValueError(f"num_passes ({num_passes}) must divide over the sp axis ({s})")
    scene, camera = replicate(scene, mesh), replicate(camera, mesh)
    local_opts, ctx_local, rows = _rank_view(ctx, options, mesh, "dp")
    k = mesh.coordinate("sp")
    accum = _sp_accum(options, mesh)
    for r in range(num_passes // s):
        frame = FrameGlobals.create(r * s + k, max_channel_value, mesh.device, rows.start)
        accum = render_pass(scene, camera, ctx_local, local_opts, frame, accum)
    merged = mesh.all_reduce(accum, "sum", "sp")
    return _gather_rows(merged, mesh, "dp", options.height)


def make_sharded_train_step_2d(
    scene: Scene,
    camera: CameraParams,
    ctx: RenderContext,
    options: RenderOptions,
    target,
    mesh: Mesh,
    optimizer,
):
    """Inverse-rendering step over the 2D mesh: ``step_fn(params,
    sample_index) -> (params, loss)`` (see ``make_sharded_train_step`` for
    ``params`` and ``optimizer``).  Slice k renders pass
    ``sample_index * S + k`` over its ``dp`` rows; the slices' accumulations
    are summed over ``sp`` and the merged image drives the loss.  The sum
    enters autograd as ``merged + (accum - accum.detach())``, so each rank's
    backward runs through its own pass alone, with the merged image's
    gradient; the gradients are then summed over the whole mesh, and the
    loss over ``dp``."""
    from ..diff.inverse import apply_material_params

    s = mesh.shape["sp"]
    scene, camera = replicate(scene, mesh), replicate(camera, mesh)
    local_opts, ctx_local, rows = _rank_view(ctx, options, mesh, "dp")
    target_rows = _target_rows(target, rows, mesh)
    count = 3 * options.height * options.width
    k = mesh.coordinate("sp")
    stepper = _Stepper(optimizer, mesh)

    def step_fn(params: dict, sample_index: int):
        tensors = stepper.zero_grad(params)
        frame = FrameGlobals.create(sample_index * s + k, device=mesh.device,
                                    row_offset=rows.start)
        accum = render_pass(apply_material_params(scene, params), camera, ctx_local, local_opts,
                            frame, _sp_accum(options, mesh))
        merged = mesh.all_reduce(accum.detach().clone(), "sum", "sp")
        total = merged + (accum - accum.detach())
        img = total[:3] / torch.clamp(total[3:], min=1.0)
        loss = ((img - target_rows) ** 2).sum() / count
        loss.backward()
        stepper.step(tensors, None)
        return params, mesh.all_reduce(loss.detach().clone(), "sum", "dp")

    return step_fn
