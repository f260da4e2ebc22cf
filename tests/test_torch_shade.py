"""The port's shading stack against the JAX package on the same synthetic
hits of the Cornell box: the shading table, ``compute_light_sample``,
``compute_multiscattering_fit`` and ``shade_hits``.

Tolerance rtol 1e-4, atol 1e-5: XLA may reassociate and fuse the float
math, so results agree to a few float32 ulps of the largest intermediate,
not bit for bit.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heatray_tpu.ops import build_woop as jax_build_woop
from heatray_tpu.render import light_sampling as jax_ls
from heatray_tpu.render import multiscatter as jax_ms
from heatray_tpu.render import shade as jax_shade
from heatray_tpu.render import shade_table as jax_st
from heatray_tpu.sampling.tables import build_tables as jax_build_tables
from heatray_tpu.scene.builtin import cornell_box as jax_cornell_box
from heatray_tpu.vec import Vec3 as JaxVec3
from heatray_tpu_torch.bridge import scene_from_arrays
from heatray_tpu_torch.ops.intersect import build_woop
from heatray_tpu_torch.render import light_sampling, multiscatter, shade, shade_table
from heatray_tpu_torch.sampling.tables import build_tables
from heatray_tpu_torch.scene.builtin import cornell_box
from heatray_tpu_torch.utils.threads import share_cores
from heatray_tpu_torch.vec import Vec3

share_cores(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))


RTOL, ATOL = 1e-4, 1e-5
R = 512


def _arrays(obj):
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


def _close(ours, ref, name=""):
    if isinstance(ours, Vec3):
        for k in "xyz":
            _close(getattr(ours, k), getattr(ref, k), f"{name}.{k}")
        return
    ref = np.asarray(ref)
    if ref.dtype == bool:
        np.testing.assert_array_equal(ours.numpy(), ref, err_msg=name)
    else:
        np.testing.assert_allclose(ours.numpy(), ref, rtol=RTOL, atol=ATOL, err_msg=name)


def _pair(a):
    """(JAX, port) copies of one float32 numpy array."""
    return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))


def _vec_pair(a):
    (jx, tx), (jy, ty), (jz, tz) = (_pair(a[:, k]) for k in range(3))
    return JaxVec3(jx, jy, jz), Vec3(tx, ty, tz)


def _build():
    """Both packages' Cornell box and shading tables, and R synthetic hits:
    random triangles, barycentrics, directions and distances, from one
    numpy seed."""
    jax_scene = jax_cornell_box(light="both", with_spheres=True)
    scene = scene_from_arrays(
        _arrays(jax_scene.geometry), _arrays(jax_scene.materials), _arrays(jax_scene.lights),
        device="cpu",
    )
    jax_accel = jax_build_woop(jax_scene.geometry.positions, jax_scene.geometry.indices)
    accel = build_woop(scene.geometry.positions, scene.geometry.indices)
    jax_table = jax_st.build_shade_table(jax_scene, jax_accel, textured=False)
    table = shade_table.build_shade_table(scene, accel)

    rng = np.random.default_rng(5)
    pos = np.asarray(jax_scene.geometry.positions).T
    idx = np.asarray(jax_scene.geometry.indices).T
    tri = rng.integers(0, idx.shape[0], R)
    b = rng.dirichlet((1.0, 1.0, 1.0), R).astype(np.float32)
    p = (b[:, :1] * pos[idx[tri, 0]] + b[:, 1:2] * pos[idx[tri, 1]]
         + b[:, 2:] * pos[idx[tri, 2]])
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    org = (p - d * rng.uniform(0.5, 3.0, (R, 1))).astype(np.float32)
    return {
        "jax_scene": jax_scene, "scene": scene,
        "jax_table": jax_table, "table": table,
        "tri": tri, "org": _vec_pair(org), "dir": _vec_pair(d),
    }


@pytest.fixture(scope="module")
def setup():
    return _build()


def test_shade_table_matches_jax(setup):
    np.testing.assert_allclose(
        setup["table"].numpy(), np.asarray(setup["jax_table"]), rtol=0, atol=1e-6
    )


def test_compute_light_sample_matches_jax(setup):
    rng = np.random.default_rng(11)
    n = rng.normal(size=(R, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    p = rng.uniform(-1.9, 1.9, (R, 3)).astype(np.float32)
    u = rng.uniform(0.0, 1.0, R).astype(np.float32)
    (jn, tn), (jp, tp), (ju, tu) = _vec_pair(n), _vec_pair(p), _pair(u)
    ref = jax_ls.compute_light_sample(setup["jax_scene"].lights, jn, jp, ju)
    ours = light_sampling.compute_light_sample(setup["scene"].lights, tn, tp, tu)
    np.testing.assert_array_equal(ours.light_type.numpy(), np.asarray(ref.light_type))
    for f in ("direction", "probability", "max_distance", "radiance"):
        _close(getattr(ours, f), getattr(ref, f), f)


def test_multiscatter_lut_matches_jax():
    """Both packages tabulate the directional albedo on the host in float64
    numpy, bit for bit."""
    np.testing.assert_array_equal(
        multiscatter.generate_multiscatter_lut(), jax_ms.generate_multiscatter_lut()
    )


def test_multiscattering_fit_matches_jax():
    np.testing.assert_array_equal(multiscatter._fit_coeffs_np(), jax_ms._fit_coeffs_np())
    rng = np.random.default_rng(13)
    c = rng.uniform(0.0, 1.0, (R, 3)).astype(np.float32)
    ndi, rough = (rng.uniform(0.0, 1.0, R).astype(np.float32) for _ in range(2))
    (jc, tc), (jn, tn), (jr, tr) = _vec_pair(c), _pair(ndi), _pair(rough)
    _close(
        multiscatter.compute_multiscattering_fit(tc, tn, tr),
        jax_ms.compute_multiscattering_fit(jc, jn, jr),
    )


@pytest.mark.parametrize("depth", [2, 4])
def test_shade_hits_matches_jax(setup, depth):
    """``depth`` 4 exercises Russian roulette (rr_start_depth 3)."""
    rng = np.random.default_rng(depth)
    (jo, to), (jd, td) = setup["org"], setup["dir"]
    tri = setup["tri"]
    rows_ref = jax_st.gather_rows(setup["jax_table"], jnp.asarray(tri))
    rows = shade_table.gather_rows(setup["table"], torch.from_numpy(tri))
    active = rng.uniform(size=R) < 0.9
    ja, ta = _pair(active)
    t_ref, b1_ref, b2_ref = jax_st.hit_attributes_rows(rows_ref, jo, jd, ja)
    t, b1, b2 = shade_table.hit_attributes_rows(rows, to, td, ta)
    for name, a, b in (("t", t, t_ref), ("b1", b1, b1_ref), ("b2", b2, b2_ref)):
        _close(a[ta], np.asarray(b)[active], name)
    t_sane_ref = jnp.where(ja, t_ref, 1.0)
    t_sane = torch.where(ta, t, 1.0)
    front_ref = jd.dot(rows_ref.vec(jax_st.GEO_N)) < 0.0
    front = td.dot(rows.vec(shade_table.GEO_N)) < 0.0

    weight = rng.uniform(0.2, 1.0, (R, 3)).astype(np.float32)
    env_on_miss = rng.uniform(size=R) < 0.5
    seq_id = rng.integers(0, 16, R).astype(np.int32)
    seq_off = rng.integers(0, 8, R).astype(np.int32)
    (jw, tw), (je, te) = _vec_pair(weight), _pair(env_on_miss)
    (js, ts), (jf, tf) = _pair(seq_id), _pair(seq_off)

    ref = jax_shade.shade_hits(
        setup["jax_scene"], jax_ms.multiscatter_lut_packed(),
        jax_build_tables(8, 8, 8), 3, depth, jo, jd, jw, je, js, jf, rows_ref,
        t_sane_ref, b1_ref, b2_ref, front_ref, ja,
        max_ray_depth=5, rr_start_depth=3, ms_impl="fit",
    )
    ours = shade.shade_hits(
        setup["scene"], build_tables(8, 8, 8), 3, depth, to, td, tw, te, ts, tf,
        rows, t_sane, b1, b2, front, ta, max_ray_depth=5, rr_start_depth=3,
    )
    # Directions, radiance and flags of lanes that spawn no ray are never
    # read; compare them on the lanes that do.
    _close(ours.shadow_active, ref.shadow_active, "shadow_active")
    _close(ours.ext_active, ref.ext_active, "ext_active")
    shadow, ext = ours.shadow_active.numpy(), ours.ext_active.numpy()
    on = {"shadow_dir": shadow, "shadow_radiance": shadow, "shadow_max_t": shadow,
          "ext_dir": ext, "ext_env_on_miss": ext}
    for f in dataclasses.fields(ours):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        m = on.get(f.name, np.ones(R, bool))
        if isinstance(a, Vec3):
            a = a.map(lambda c: c[torch.from_numpy(m)])
            b = JaxVec3(*(np.asarray(getattr(b, k))[m] for k in "xyz"))
        else:
            a, b = a[torch.from_numpy(m)], np.asarray(b)[m]
        _close(a, b, f.name)
    assert shadow.any() and ext.any()


def test_own_scene_equals_bridged(setup):
    """The port's own Cornell builder gives the arrays the JAX one gives."""
    ours, bridged = cornell_box(light="both", with_spheres=True), setup["scene"]
    for part in ("geometry", "materials", "lights"):
        a, b = getattr(ours, part), getattr(bridged, part)
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y, f.name
