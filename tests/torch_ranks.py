"""Rank scenarios of the port's multi-device tests (``tests/test_torch_parallel.py``,
``tests/test_torch_geometry_sharding.py``), on gloo over the CPU.

The tests start them with ``heatray_tpu_torch.parallel.launch.spawn``, whose
ranks unpickle a scenario by module, so the scenarios live here: this module
imports torch, numpy and the port alone, never jax or the JAX package.  Each
scenario returns a dict of numpy arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

TIMEOUT_S = 120  # s: a collective that waits longer fails; the group gets twice that


def start(scenario, world: int, store_dir, *args):
    """``world`` gloo ranks over the CPU running ``scenario(*args)``;
    ``.results()`` waits for them."""
    from heatray_tpu_torch.parallel.launch import spawn

    return spawn(scenario, world, store_dir, *args, device="cpu", timeout_s=TIMEOUT_S)


def _npy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


# --- tests/test_torch_parallel.py ----------------------------------------------


def parallel_options(depth: int = 2):
    """The options of ``tests/test_sharding.py`` (16x16, depth 2) on the
    exact ``"xla"`` backend, the bounce sort and gating off as the JAX
    package runs that backend."""
    from heatray_tpu_torch import RenderOptions

    return RenderOptions(width=16, height=16, max_render_passes=4, max_ray_depth=depth,
                         intersect_backend="xla", sort_bounces=False, gate_bounces=False)


def parallel_setup(static_shading: bool = True, spheres: bool = False, depth: int = 2):
    """(scene, camera, context) of ``tests/test_sharding.py`` on the CPU;
    ``spheres``: the box with its spheres, whose metal one makes the image
    depend on roughness."""
    from heatray_tpu_torch import cornell_box, make_context, orbit_camera

    scene = cornell_box(light="point", with_spheres=spheres)
    camera = orbit_camera(16, 16, distance=6.0, focal_length_mm=35.0)
    return scene, camera, make_context(parallel_options(depth), scene, device="cpu",
                                       static_shading=static_shading)


TRAIN_KEYS = ("base_color", "roughness")


def train_params(scene) -> dict:
    """The scene's base colours and a roughness of 0.5 on every material
    (the Cornell box's 1.0 sits on the clamp's bound), as leaf tensors."""
    return {"base_color": scene.materials.base_color.clone().requires_grad_(True),
            "roughness": torch.full_like(scene.materials.roughness, 0.5).requires_grad_(True)}


def rows_and_samples(target: np.ndarray) -> dict:
    """Every scenario of the row and sample axes on 4 ranks: the row-sharded
    render (``make_mesh(4)``, 2 passes), nine block passes over it, the 2x2
    ``(sp, dp)`` render (4 passes), ``make_sharded_train_step`` over the
    2x2 mesh's ``dp`` axis (two ranks a step) at depth 2 and at depth 1
    (``dp1``: the JAX package's step is compiled at that depth to be held
    against it) and one ``make_sharded_train_step_2d`` on the box with its
    spheres (SGD at lr 1.0, so that each gradient is the parameters'
    change), and whether ``make_mesh(2)`` refuses the group of 4."""
    from heatray_tpu_torch.parallel import sharding

    scene, camera, ctx = parallel_setup()
    opts = parallel_options()
    out = {}
    try:
        sharding.make_mesh(2, device="cpu")
        out["mesh_of_2_raises"] = np.array(False)
    except ValueError:
        out["mesh_of_2_raises"] = np.array(True)
    mesh = sharding.make_mesh(4, device="cpu")
    out["rows"] = _npy(sharding.render_sharded(scene, camera, ctx, opts, mesh, num_passes=2))
    block_opts = dataclasses.replace(opts, interactive_block=True)
    out["blocks"] = _npy(sharding.render_sharded(scene, camera, ctx, block_opts, mesh,
                                                 num_passes=9))
    mesh2 = sharding.make_mesh_2d(2, 2, device="cpu")
    out["sp_dp"] = _npy(sharding.render_sharded_2d(scene, camera, ctx, opts, mesh2,
                                                   num_passes=4))

    scene, camera, grad_ctx = parallel_setup(static_shading=False, spheres=True)
    _, _, ctx1 = parallel_setup(static_shading=False, spheres=True, depth=1)
    sgd = lambda tensors: torch.optim.SGD(tensors, lr=1.0)  # noqa: E731
    for name, step in (
        ("dp", sharding.make_sharded_train_step(scene, camera, grad_ctx, opts, target, mesh2,
                                                sgd, axis="dp")),
        ("dp1", sharding.make_sharded_train_step(scene, camera, ctx1, parallel_options(1),
                                                 target, mesh2, sgd, axis="dp")),
        ("2d", sharding.make_sharded_train_step_2d(scene, camera, grad_ctx, opts, target,
                                                   mesh2, sgd)),
    ):
        params = train_params(scene)
        before = {k: v.detach().clone() for k, v in params.items()}
        params, loss = step(params, 1)
        out[f"{name}_loss"] = _npy(loss)
        for k in TRAIN_KEYS:
            out[f"{name}_grad_{k}"] = _npy(before[k] - params[k])
    return out


# --- tests/test_torch_geometry_sharding.py -------------------------------------


def soup_accel(positions: np.ndarray, indices: np.ndarray):
    """The port's Woop accel of a numpy soup ((V, 3) positions, (T, 3) ids)."""
    from heatray_tpu_torch.ops.intersect import build_woop

    return build_woop(torch.from_numpy(np.ascontiguousarray(positions.T)),
                      torch.from_numpy(np.ascontiguousarray(indices.T)))


def rays(orig: np.ndarray, dirs: np.ndarray):
    from heatray_tpu_torch.vec import Vec3

    return tuple(Vec3(*(torch.from_numpy(np.ascontiguousarray(a[:, k])) for k in range(3)))
                 for a in (orig, dirs))


def sharded_options():
    """The ``"sharded"`` render of ``tests/test_geometry_sharding.py`` cut to
    24x24 (depth 3, 2 passes), the bounce sort and gating on, as the card
    runs them, so that every rank's lane counts must agree."""
    from heatray_tpu_torch import RenderOptions

    return RenderOptions(width=24, height=24, max_render_passes=2, max_ray_depth=3,
                         intersect_backend="sharded", sort_bounces=True, gate_bounces=True)


def sharded_camera():
    from heatray_tpu_torch import orbit_camera

    return orbit_camera(24, 24, distance=6.2, focal_length_mm=35.0)


def forest(soup: tuple, ray_set: tuple) -> dict:
    """On 4 ranks: the wide forest's intersectors over a soup (4 shards, one
    a rank) on the whole ray set, and the ``"sharded"`` backend end to end
    through ``make_context(..., mesh=...)`` and ``render`` (the Cornell box
    with both lights and its spheres)."""
    from heatray_tpu_torch import cornell_box, make_context, render
    from heatray_tpu_torch.parallel import geometry, sharding

    mesh = sharding.make_mesh(4, device="cpu")
    accel = soup_accel(*soup)
    swide = geometry.place_sharded_wide(geometry.build_sharded_wide(accel, 4), mesh)
    closest, any_hit = geometry.make_sharded_wide_intersectors(swide, None, mesh)
    org, d = rays(*ray_set)
    t, slot, hit = closest(org, d, 1e-4)
    blocked = any_hit(org, d, 1e-4, 5.0)
    out = {"t": _npy(t), "slot": _npy(slot), "hit": _npy(hit), "blocked": _npy(blocked),
           "slot_tri": _npy(swide.slot_tri), "shard": np.array(swide.shard)}

    scene = cornell_box(light="both", with_spheres=True)
    opts = sharded_options()
    ctx = make_context(opts, scene, device="cpu", mesh=mesh)
    out["backend"] = np.array(ctx.accel_pack.backend)
    out["image"] = _npy(render(scene, sharded_camera(), opts, num_passes=2, ctx=ctx,
                               device="cpu")[0])
    return out
