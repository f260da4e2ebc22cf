"""The port's host library (``heatray_tpu_torch/native.py``,
``csrc/native.cpp``) against the JAX package's (``heatray_tpu/native.py``)
and against the port's numpy twins, on the CPU.

Trees are equal field for field (``nbox``, ``leaf_chunk``, ``skip``,
``slot_tri``) to the JAX package's ``build_topology`` and to
``build_topology_plain``: the Cornell box, a seeded soup of 20,000
triangles, leaf sizes 16, 32 and 128, an occluder mask and an empty one, a
soup whose centroids all coincide (median splits only) and a chain of
degenerate triangles along x that only a median split past
``MAX_SAH_DEPTH`` ends.  Morton order is equal to the JAX package's and to
``morton_order_plain``.  Normals are bit-equal to the JAX library's, and
within 1e-6 of ``compute_vertex_normals_plain``, which sums each vertex's
face normals in another order; ``high_poly``'s, which the port once
computed in numpy, are bit-equal to the JAX package's.  An OBJ file
without ``usemtl`` loads to the same ``MeshData`` through the tokenizer,
the Python loop and the JAX loader.  A compiler that fails raises.
g++ builds the library into ``build/`` on first use; no card is needed."""

import os

import numpy as np
import pytest

from heatray_tpu import native as jax_native
from heatray_tpu.ops.bvh import build_topology as jax_build_topology
from heatray_tpu.scene.builtin import high_poly as jax_high_poly
from heatray_tpu.scene.geometry import _morton_order as jax_morton_order
from heatray_tpu.scene.loaders.obj import load_obj as jax_load_obj
from heatray_tpu_torch import cornell_box, high_poly, native
from heatray_tpu_torch.ops import cuda_build
from heatray_tpu_torch.ops.bvh import MAX_SAH_DEPTH, build_topology, build_topology_plain
from heatray_tpu_torch.ops.intersect import build_woop
from heatray_tpu_torch.scene.geometry import (
    compute_vertex_normals, compute_vertex_normals_plain, morton_order_plain,
)
from heatray_tpu_torch.scene.loaders import obj as obj_loader
from heatray_tpu_torch.utils.threads import share_cores

share_cores(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))

NORMAL_TOL = 1e-6  # the C++ normals against the numpy twin's summation order
TOPO_FIELDS = ("nbox", "leaf_chunk", "skip", "slot_tri")


def _boxes(tri):
    """Planar (3, T) f32 boxes of triangles ``tri`` (T, 3 corners, 3)."""
    tri = np.asarray(tri, np.float32)
    return np.ascontiguousarray(tri.min(1).T), np.ascontiguousarray(tri.max(1).T)


def _soup(n=20_000, seed=7):
    rng = np.random.default_rng(seed)
    centre = rng.uniform(-4.0, 4.0, (n, 1, 3))
    return _boxes(centre + rng.normal(0.0, 0.08, (n, 3, 3)))


def _coincident(n=3_000, seed=8):
    """Every triangle's box centred on (1, 1, 1) exactly: offsets on a 2^-10
    grid, so c + o and c - o sum to 2 without rounding."""
    off = np.round(np.random.default_rng(seed).normal(0.0, 0.3, (n, 3)) * 1024) / 1024
    return _boxes(np.stack([1.0 + off, 1.0 - off, np.ones_like(off)], 1))


def _chain():
    """Flat triangles on the x axis at x = -2^k: every SAH cost is 0, so
    each node splits off its first bin, one k, and only the forced median
    split past MAX_SAH_DEPTH ends the chain."""
    x = -np.exp2(np.repeat(np.arange(-20, 80), 3).astype(np.float64))
    zero = np.zeros_like(x)
    return _boxes(np.stack([np.stack([x * s, zero, zero], -1)
                            for s in (1.0, 1.0009765625, 0.9990234375)], 1))


def _cornell():
    geo = cornell_box(light="both", with_spheres=True).geometry
    accel = build_woop(geo.positions, geo.indices)
    return accel.tri_min.numpy(), accel.tri_max.numpy()


SCENES = {"cornell": _cornell, "soup": _soup, "coincident": _coincident, "chain": _chain}


@pytest.fixture(scope="module")
def scenes():
    return {name: make() for name, make in SCENES.items()}


def _include(kind, t):
    if kind is None:
        return None
    if kind == "empty":
        return np.zeros(t, bool)
    return np.random.default_rng(t).random(t) < 0.7


def _depth(topo) -> int:
    depth = np.zeros(topo.num_nodes, np.int64)
    for i in np.flatnonzero(topo.leaf_chunk < 0):
        depth[i + 1] = depth[topo.skip[i + 1]] = depth[i] + 1
    return int(depth.max())


def _assert_same_tree(got, ref, label):
    for f in TOPO_FIELDS:
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f"{label}: {f} differs"
    assert got.leaf_size == ref.leaf_size


TREE_CASES = [
    *[(scene, leaf, None) for scene in SCENES for leaf in (16, 32, 128)],
    ("cornell", 32, "mask"), ("soup", 32, "mask"), ("soup", 128, "mask"),
    ("cornell", 16, "empty"), ("soup", 128, "empty"),
]


@pytest.mark.parametrize("scene,leaf,include", TREE_CASES)
def test_tree_matches_jax_and_plain(scenes, scene, leaf, include):
    tri_min, tri_max = scenes[scene]
    inc = _include(include, tri_min.shape[1])
    got = build_topology(tri_min, tri_max, leaf_size=leaf, include=inc)
    _assert_same_tree(got, jax_build_topology(tri_min, tri_max, leaf_size=leaf, include=inc),
                      "against the JAX package")
    _assert_same_tree(got, build_topology_plain(tri_min, tri_max, leaf_size=leaf, include=inc),
                      "against build_topology_plain")
    if include == "empty":
        assert got.num_nodes == 1 and got.skip.tolist() == [1]
    elif scene == "chain":
        assert _depth(got) > MAX_SAH_DEPTH  # the forced median splits ran
    kept = np.flatnonzero(np.ones(tri_min.shape[1], bool) if inc is None else inc)
    assert np.array_equal(np.sort(got.slot_tri[got.slot_tri >= 0]), kept)


def test_coincident_centroids_take_median_splits(scenes):
    """With every centroid equal, each node halves its triangles."""
    topo = build_topology(*scenes["coincident"], leaf_size=16)
    n = scenes["coincident"][0].shape[1]
    assert _depth(topo) == int(np.ceil(np.log2(n / 16)))
    assert set(topo.leaf_chunk[topo.leaf_chunk < 0].tolist()) <= {-1, -2, -3}


def _mesh(seed, n_vert=3_000, n_tri=5_000):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n_vert, 3)).astype(np.float32),
            rng.integers(0, n_vert, (n_tri, 3)).astype(np.int32))


@pytest.mark.parametrize("seed", [3, 4])
def test_morton_order_matches_jax_and_plain(seed):
    pos, idx = _mesh(seed)
    got = native.morton_order(pos, idx)
    assert got.dtype == np.int64
    assert np.array_equal(got, jax_morton_order(pos, idx))
    assert np.array_equal(got, morton_order_plain(pos, idx))


@pytest.fixture(scope="module")
def hp_geometry():
    return high_poly().geometry


@pytest.mark.parametrize("mesh", ["random", "high_poly"])
def test_vertex_normals_match_jax_and_plain(hp_geometry, mesh):
    """Bit-equal to the JAX library on a soup of random corners and on
    ``high_poly``'s closed surface; within NORMAL_TOL of the numpy twin on
    the surface (on the soup, where a vertex's face normals nearly cancel,
    the two summation orders part further)."""
    assert jax_native.available()
    if mesh == "random":
        pos, idx = _mesh(5)
        pos[-10:] = 0.0  # unreferenced or degenerate: zero normals
    else:
        pos = hp_geometry.positions.numpy().T.copy()
        idx = hp_geometry.indices.numpy().T.copy()
    got = compute_vertex_normals(pos, idx)
    assert got.dtype == np.float32
    assert np.array_equal(got, jax_native.vertex_normals(pos, idx))
    if mesh == "high_poly":
        np.testing.assert_allclose(got, compute_vertex_normals_plain(pos, idx), rtol=0,
                                   atol=NORMAL_TOL)


def test_high_poly_normals_match_jax(hp_geometry):
    """The normals that ``MeshData`` computes for ``high_poly`` are the JAX
    package's bit for bit (the numpy twin sums each vertex's face normals
    in another order: many components differ in the last bits)."""
    ref = jax_high_poly().geometry
    assert np.array_equal(hp_geometry.positions.numpy(), np.asarray(ref.positions))
    assert np.array_equal(hp_geometry.indices.numpy(), np.asarray(ref.indices))
    assert np.array_equal(hp_geometry.normals.numpy(), np.asarray(ref.normals))


_OBJ_HEAD = """# no material groups
mtllib unused.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0.5 1.5 0.25
v 2 0 1
v 2 1 1.5
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 0 1
vn 0 0.6 0.8
"""
OBJ_FILES = {
    # Quads, a pentagon, negative indices, v//vn, v/vt and bare v.
    "mixed": _OBJ_HEAD + """f 1/1/1 2/2/1 3/3/2 4/4/2
f 1//1 2//1 6//2
f -6/-4 -5/-3 -4/-2 -3/-1 -7/-4
f 2 6 7 3
f -1 -2 -3
""",
    # Every corner has a normal: the file's normals are kept.
    "normals": _OBJ_HEAD + """f 1/1/1 2/2/1 3/3/2 4/4/2
f 1//1 2//1 6//2
f -7/-4/-2 -6/-3/-1 -5/-2/-1 -4/-1/-1 -3/-4/-2
""",
    # No vt, no vn at all.
    "bare": "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0 0 1\nf 1 2 3 4\nf 1 2 5\nf -1 -2 -4\n",
    "no-faces": "v 0 0 0\nv 1 0 0\n",
}


@pytest.mark.parametrize("kind", OBJ_FILES)
def test_obj_without_usemtl_matches_python_and_jax(tmp_path, kind):
    path = tmp_path / f"{kind}.obj"
    path.write_text(OBJ_FILES[kind])
    fast = obj_loader.load_obj(str(path), scale=0.5)
    slow = obj_loader._load_python(str(path), 0.5)
    ref = jax_load_obj(str(path), scale=0.5)
    assert len(fast[0]) == len(slow[0]) == len(ref[0]) == (0 if kind == "no-faces" else 1)
    for got in (fast, slow):
        assert [m.name for m in got[1]] == [m.name for m in ref[1]]
        for mesh, mesh_ref in zip(got[0], ref[0]):
            assert mesh.name == mesh_ref.name == kind
            for f in ("positions", "indices", "normals", "uvs"):
                a, b = getattr(mesh, f), getattr(mesh_ref, f)
                assert a.dtype == b.dtype and np.array_equal(a, b), f"{kind}: {f}"
    if kind == "mixed":
        assert fast[0][0].indices.shape == (9, 3)  # 2 + 1 + 3 + 2 + 1 fan triangles


def test_parse_obj_streams():
    v, vt, vn, fv, ft, fn = native.parse_obj(OBJ_FILES["mixed"].encode())
    assert v.shape == (7, 3) and vt.shape == (4, 2) and vn.shape == (2, 3)
    assert fv[:2].tolist() == [[0, 1, 2], [0, 2, 3]]
    assert ft[2].tolist() == [-1, -1, -1] and fn[2].tolist() == [0, 0, 1]
    assert fv[3:6].tolist() == [[1, 2, 3], [1, 3, 4], [1, 4, 0]]  # the pentagon's fan
    assert fn[3:6].min() == -1 and ft[3:6].tolist()[0] == [0, 1, 2]


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler that fails makes the first call raise, with no fallback."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", "/bin/false")
    native._lib.cache_clear()
    cuda_build.load_host.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="native.cpp"):
            cuda_build.build_host("native")
        with pytest.raises(RuntimeError, match="failed"):
            native.morton_order(*_mesh(1, 10, 4))
        assert not list((tmp_path / "build").glob("*.so"))
    finally:
        native._lib.cache_clear()
        cuda_build.load_host.cache_clear()


@pytest.mark.parametrize("fn", [native.morton_order, native.vertex_normals])
def test_indices_outside_the_vertices_raise(fn):
    """The C++ reads ``positions`` at every index unchecked: the binding
    refuses an index that names no vertex, and arrays of the wrong shape."""
    pos, idx = _mesh(2, 10, 4)
    for bad in (-1, 10):
        wrong = idx.copy()
        wrong[2, 1] = bad
        with pytest.raises(IndexError):
            fn(pos, wrong)
    with pytest.raises(ValueError):
        fn(pos[:, :2], idx)


def test_bvh_build_checks_its_shapes(scenes):
    tri_min, tri_max = scenes["cornell"]
    with pytest.raises(ValueError):
        native.bvh_build(tri_min, tri_max[:, :-1], None, 32, 16)
    with pytest.raises(ValueError):
        native.bvh_build(tri_min, tri_max, np.ones(5, bool), 32, 16)
