"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs an NVIDIA card and skips without one.  This file
imports no jax, so it also runs where jax is not installed; there, skip the
JAX package's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from heatray_tpu_torch import cornell_box, make_context, make_loss_fn, orbit_camera, render
from heatray_tpu_torch.bridge import params_from_arrays
from heatray_tpu_torch.options import RenderOptions
from heatray_tpu_torch.ops import intersect_pallas, traverse_pallas, wide_bvh
from heatray_tpu_torch.ops.bvh import build_bvh
from heatray_tpu_torch.ops.intersect import MISS_T, build_woop
from heatray_tpu_torch.probes import kernel_probe, kernel_variants, visit_stats, vpu_leaf
from heatray_tpu_torch.render import integrator
from heatray_tpu_torch.scene.builtin import multi_material
from heatray_tpu_torch.scene.geometry import translate
from heatray_tpu_torch.scene.lights import DirectionalLight, EnvironmentLightDesc
from heatray_tpu_torch.scene.materials import GlassParams, PBRParams
from heatray_tpu_torch.scene.providers import plane_mesh, sphere_mesh
from heatray_tpu_torch.scene.scene import SceneBuilder
from heatray_tpu_torch.utils.threads import share_cores
from heatray_tpu_torch.vec import Vec3

share_cores(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))


pytestmark = pytest.mark.cuda

GOLDEN_SIZE, GOLDEN_PASSES = 48, 4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernels have no CPU mode)")
    return torch.device("cuda:0")


def _soup(t, seed, device):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-4, 4, (t, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(-0.5, 0.5, (t, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-0.5, 0.5, (t, 3)).astype(np.float32)
    pos = torch.from_numpy(np.concatenate([v0, v1, v2]).T.copy()).to(device)
    idx = torch.arange(3 * t, dtype=torch.int32, device=device).reshape(t, 3).T.contiguous()
    return build_woop(pos, idx)


def _rays(r, seed, device):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-8, 8, (r, 3)).astype(np.float32)
    d = rng.uniform(-2, 2, (r, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)

    def vec(a):
        return Vec3(*(torch.from_numpy(np.ascontiguousarray(a[:, k])).to(device) for k in range(3)))

    return vec(o), vec(d)


@pytest.mark.parametrize("n_rays", [8192, 8191, 33])
@pytest.mark.parametrize("t, leaf_size", [(700, 16), (5000, 32), (5000, 64), (5000, 128)])
def test_kernels_match_plain(cuda_device, t, leaf_size, n_rays):
    """Both sides do the same float32 arithmetic in the same order, so t
    agrees to rounding (rtol = atol = 1e-5), and ties go to the lowest slot
    across leaves too, so slots are equal everywhere: one triangle per lane
    in one block of columns at leaf 16 and 32, in two and four blocks at 64
    and 128; with whole warps, a last warp of 31 rays, and a second warp of
    one ray."""
    bvh = wide_bvh.build_wide_bvh(_soup(t, 11, cuda_device), leaf_size=leaf_size)
    o, d = _rays(n_rays, 7, cuda_device)
    launches = wide_bvh.intersect_closest_wide.launches
    t_k, slot_k, hit_k = wide_bvh.intersect_closest_wide(bvh, o, d)
    t_p, slot_p, hit_p = wide_bvh.closest_wide_plain(bvh, o, d)
    torch.cuda.synchronize()
    assert wide_bvh.intersect_closest_wide.launches == launches + 1
    assert torch.equal(hit_k, hit_p) and torch.equal(slot_k, slot_p)
    torch.testing.assert_close(t_k, t_p, rtol=1e-5, atol=1e-5)

    t_max = torch.linspace(0.5, 12.0, n_rays, device=cuda_device)
    blocked = wide_bvh.intersect_any_wide(bvh, o, d, t_max=t_max)
    assert torch.equal(blocked, wide_bvh.any_wide_plain(bvh, o, d, t_max=t_max))
    assert n_rays < 8191 or 0 < int(blocked.sum()) < n_rays


def test_kernel_finds_hits_just_past_an_edge(cuda_device):
    """A ray that grazes the Cornell floor's open front edge: the pair test
    accepts it 4e-7 outside the floor in barycentric terms, outside the
    leaf's box, and the widened slab test must still reach that leaf."""
    scene = cornell_box(light="both", with_spheres=True).to(cuda_device)
    bvh = wide_bvh.build_wide_bvh(build_woop(scene.geometry.positions, scene.geometry.indices))
    o = Vec3(*(torch.tensor([c], device=cuda_device)
               for c in (1.999899983406067, 0.021646535024046898, 0.026903629302978516)))
    d = Vec3(*(torch.tensor([c], device=cuda_device)
               for c in (-0.643088698387146, -0.5480369329452515, 0.5348762273788452)))
    t_k, slot_k, hit_k = wide_bvh.intersect_closest_wide(bvh, o, d)
    t_p, slot_p, hit_p = wide_bvh.closest_wide_plain(bvh, o, d)
    assert bool(hit_p[0]) and bool(hit_k[0])
    assert torch.equal(t_k, t_p) and torch.equal(slot_k, slot_p)
    assert bool(wide_bvh.intersect_any_wide(bvh, o, d, t_max=t_p + 1e-3)[0])


def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    bvh = wide_bvh.build_wide_bvh(_soup(300, 5, cuda_device), leaf_size=32)
    o, d = _rays(64, 3, cuda_device)
    with pytest.raises(ValueError, match="float32"):
        wide_bvh.intersect_closest_wide(bvh, o.map(lambda c: c.double()), d)
    with pytest.raises(ValueError, match="stack"):
        wide_bvh.intersect_any_wide(dataclasses.replace(bvh, max_stack=1 << 20), o, d)


@pytest.mark.parametrize("n_rays", [8191, 0, 1, 31, 33])
def test_stream_kernels_match_plain(cuda_device, n_rays):
    """K3a/K3b on a 50k-triangle soup at leaf 128: a ray count that leaves
    the last warp and block part-empty, no rays at all, one ray, and counts
    that leave one warp or the second one part-empty.  Ties go to the
    lowest slot across leaves too, so slots are equal everywhere."""
    bvh = wide_bvh.build_wide_bvh(_soup(50_000, 11, cuda_device), leaf_size=128)
    o, d = _rays(n_rays, 7, cuda_device)
    launches = wide_bvh.intersect_closest_stream.launches
    t_k, slot_k, hit_k = wide_bvh.intersect_closest_stream(bvh, o, d)
    t_p, slot_p, hit_p = wide_bvh.closest_stream_plain(bvh, o, d)
    torch.cuda.synchronize()
    assert wide_bvh.intersect_closest_stream.launches == launches + (n_rays > 0)
    assert t_k.shape == slot_k.shape == (n_rays,)
    assert torch.equal(hit_k, hit_p) and torch.equal(slot_k, slot_p)
    torch.testing.assert_close(t_k, t_p, rtol=1e-5, atol=1e-5)

    t_max = torch.linspace(0.5, 12.0, n_rays, device=cuda_device)
    blocked = wide_bvh.intersect_any_stream(bvh, o, d, t_max=t_max)
    assert torch.equal(blocked, wide_bvh.any_stream_plain(bvh, o, d, t_max=t_max))
    assert n_rays < 8191 or 0 < int(blocked.sum()) < n_rays


def _walk_queries(route):
    """(closest, occlusion) of the walks per ray: K1/K2 (``"wide"``), K5a
    with K5b (``"vpu"``) or K3."""
    if route == "wide":
        return wide_bvh.intersect_closest_wide, wide_bvh.intersect_any_wide
    if route == "vpu":
        return wide_bvh.intersect_closest_vpu, wide_bvh.intersect_any_vpu
    return wide_bvh.intersect_closest_stream, wide_bvh.intersect_any_stream


@pytest.mark.parametrize("route, leaf_size",
                         [("stream", 128), ("wide", 32), ("wide", 64), ("vpu", 128),
                          ("chunks", 64), ("bvh2", 64)])
def test_stream_kernels_break_ties_across_leaves_to_the_lowest_slot(cuda_device, route,
                                                                     leaf_size):
    """300 copies of one triangle, away from a random soup, fill several
    leaves (of 128 for K3a and K5a, of 32 and 64 for K1, of 64 for K6a
    (``"bvh2"``): at 64 the ties also span two blocks of columns, and for
    K5a and K6a two block boxes of one leaf), so a ray through it ties in t
    on every copy; the kernel must keep the lowest slot of all, as the
    plain version does (K6a: the triangle of that slot).  K7a (``"chunks"``,
    chunks of 64): the copies come first, so they
    fill five chunks, and the soup's first triangle lies beside the rays,
    nearer their origin than the copies, so the last chunk of copies is
    entered first, and each warp serves it before the four of lower ids."""
    rng = np.random.default_rng(3)
    n_soup, n_copy = 2000, 300
    v = rng.uniform(-4, 4, (n_soup, 3)).astype(np.float32)
    soup = [v, v + rng.uniform(-0.5, 0.5, (n_soup, 3)).astype(np.float32),
            v + rng.uniform(-0.5, 0.5, (n_soup, 3)).astype(np.float32)]
    tri = np.array([[10.0, -1.0, -1.0], [10.0, 1.0, -1.0], [10.0, 0.0, 1.0]], np.float32)
    copies = [np.repeat(tri[k][None], n_copy, 0) for k in range(3)]
    if route == "chunks":
        for k, corner in enumerate(([12.0, 2.0, 0.0], [12.0, 2.5, 0.0], [12.0, 2.0, 0.5])):
            soup[k][0] = corner
        corners = [np.concatenate([c, s]) for c, s in zip(copies, soup)]
    else:
        corners = [np.concatenate([s, c]) for s, c in zip(soup, copies)]
    t = n_soup + n_copy
    pos = torch.from_numpy(np.concatenate(corners).T.copy()).to(cuda_device)
    idx = torch.arange(3 * t, dtype=torch.int32, device=cuda_device).reshape(3, t).contiguous()
    accel = build_woop(pos, idx)
    r = 4096
    org = np.tile(np.array([[14.0, 0.0, 0.0]], np.float32), (r, 1))
    aim = np.stack([np.full(r, 10.0), rng.uniform(-0.3, 0.3, r), rng.uniform(-0.3, 0.3, r)], 1)
    d = (aim - org).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = Vec3(*(torch.from_numpy(np.ascontiguousarray(org[:, k])).to(cuda_device) for k in range(3)))
    d = Vec3(*(torch.from_numpy(np.ascontiguousarray(d[:, k])).to(cuda_device) for k in range(3)))
    if route == "chunks":
        packed = intersect_pallas.pack_for_pallas(accel, leaf_size)
        copy_chunks = torch.arange(n_copy, device=cuda_device) // leaf_size
        assert copy_chunks.unique().numel() == 5
        # The nearest face of each chunk of copies to the rays' origin (+x).
        near = packed.boxes[:5, 3]
        assert bool((near[4] > near[:4]).all())
        t_k, id_k, hit_k = intersect_pallas.intersect_closest_pallas(packed, o, d)
        t_p, id_p, hit_p = intersect_pallas.closest_chunks_plain(packed, o, d)
        assert bool(hit_p.all()) and bool((id_p == 0).all())
        assert torch.equal(hit_k, hit_p) and torch.equal(id_k, id_p) and torch.equal(t_k, t_p)
        return
    bvh = (build_bvh if route == "bvh2" else wide_bvh.build_wide_bvh)(accel, leaf_size=leaf_size)
    copy_slots = (bvh.slot_tri >= n_soup).nonzero()[:, 0]
    assert (copy_slots // leaf_size).unique().numel() >= 2
    if route in ("vpu", "bvh2"):  # some leaf holds copies in two of its blocks of 32
        leaf, block = copy_slots // leaf_size, copy_slots // 32
        assert any((block[leaf == c]).unique().numel() >= 2 for c in leaf.unique().tolist())
    if route == "bvh2":
        t_k, id_k, hit_k = traverse_pallas.intersect_closest_bvh(bvh, o, d)
        t_p, id_p, hit_p = traverse_pallas.closest_bvh_plain(bvh, o, d)
        assert bool(hit_p.all()) and bool((id_p == bvh.slot_tri[copy_slots.min()]).all())
        assert torch.equal(hit_k, hit_p) and torch.equal(id_k, id_p) and torch.equal(t_k, t_p)
        return
    t_k, slot_k, hit_k = _walk_queries(route)[0](bvh, o, d)
    t_p, slot_p, hit_p = wide_bvh.closest_wide_plain(bvh, o, d)
    assert bool(hit_p.all()) and bool((slot_p == copy_slots.min()).all())
    assert torch.equal(hit_k, hit_p) and torch.equal(slot_k, slot_p) and torch.equal(t_k, t_p)


@pytest.mark.parametrize("route, leaf_size",
                         [("stream", 128), ("wide", 32), ("wide", 64), ("vpu", 128)])
def test_stream_occlusion_ends_before_every_hit(cuda_device, route, leaf_size):
    """K3b (leaf 128), K2 (leaf 32 and 64) and K5b (leaf 128) with each
    ray's t_max short of its closest hit: nothing is blocked, although every
    leaf (or block) the ray enters is tested."""
    bvh = wide_bvh.build_wide_bvh(_soup(50_000, 11, cuda_device), leaf_size=leaf_size)
    o, d = _rays(8191, 7, cuda_device)
    t_hit, _, hit = wide_bvh.closest_wide_plain(bvh, o, d)
    assert int(hit.sum()) > 4000
    t_max = torch.where(hit, t_hit * 0.999, 100.0)
    blocked = _walk_queries(route)[1](bvh, o, d, t_max=t_max)
    assert not bool(blocked.any())
    assert torch.equal(blocked, wide_bvh.any_wide_plain(bvh, o, d, t_max=t_max))


def test_stream_kernel_finds_hits_just_past_an_edge(cuda_device):
    """K3a on the ray of ``test_kernel_finds_hits_just_past_an_edge``, over
    the Cornell box in 128-triangle leaves."""
    scene = cornell_box(light="both", with_spheres=True).to(cuda_device)
    bvh = wide_bvh.build_wide_bvh(
        build_woop(scene.geometry.positions, scene.geometry.indices), leaf_size=128
    )
    o = Vec3(*(torch.tensor([c], device=cuda_device)
               for c in (1.999899983406067, 0.021646535024046898, 0.026903629302978516)))
    d = Vec3(*(torch.tensor([c], device=cuda_device)
               for c in (-0.643088698387146, -0.5480369329452515, 0.5348762273788452)))
    t_k, slot_k, hit_k = wide_bvh.intersect_closest_stream(bvh, o, d)
    t_p, slot_p, hit_p = wide_bvh.closest_stream_plain(bvh, o, d)
    assert bool(hit_p[0]) and bool(hit_k[0])
    assert torch.equal(t_k, t_p) and torch.equal(slot_k, slot_p)
    assert bool(wide_bvh.intersect_any_stream(bvh, o, d, t_max=t_p + 1e-3)[0])


def test_stream_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    """K3 takes float32 rays and a tree whose stack fits its 64 entries; its
    leaf pack needs no alignment and no shared memory."""
    bvh = wide_bvh.build_wide_bvh(_soup(300, 5, cuda_device), leaf_size=128)
    o, d = _rays(64, 3, cuda_device)
    with pytest.raises(ValueError, match="float32"):
        wide_bvh.intersect_closest_stream(bvh, o.map(lambda c: c.double()), d)
    with pytest.raises(ValueError, match="stack of 65"):
        wide_bvh.intersect_any_stream(dataclasses.replace(bvh, max_stack=65), o, d)
    shifted = torch.empty(bvh.w.numel() + 1, device=cuda_device)[1:].view(bvh.w.shape)
    shifted.copy_(bvh.w)
    t_k, slot_k, _ = wide_bvh.intersect_closest_stream(dataclasses.replace(bvh, w=shifted), o, d)
    t_p, slot_p, _ = wide_bvh.closest_stream_plain(bvh, o, d)
    assert torch.equal(t_k, t_p) and torch.equal(slot_k, slot_p)


def _t_queries(route):
    """(closest, any) of the transposed kernels: K5 (``"wide"``) or K4."""
    if route == "wide":
        return wide_bvh.intersect_closest_vpu, wide_bvh.intersect_any_vpu
    return wide_bvh.intersect_closest_stream_vpu, wide_bvh.intersect_any_stream_vpu


def _masked_occluder_trees(accel, seed):
    """Occluder trees of ``accel`` at leaf 128 with about 30% of its
    triangles alpha-masked: the tree ``integrator.build_accel`` builds
    (``include``), and one over the accel ``integrator._occluder_accel``
    makes (the masked triangles' rows zeroed and their boxes emptied to
    +-3e38), whose leaves hold masked triangles and so block boxes that are
    inverted or bound only the unmasked ones."""
    from heatray_tpu_torch.ops.intersect import WoopAccel

    keep = torch.from_numpy(np.random.default_rng(seed).uniform(size=accel.num_triangles) > 0.3)
    keep = keep.to(accel.w.device)[None]
    emptied = WoopAccel(w=accel.w * keep.float(), geo_normal=accel.geo_normal,
                        tri_min=torch.where(keep, accel.tri_min, 3.0e38),
                        tri_max=torch.where(keep, accel.tri_max, -3.0e38))
    with np.errstate(over="ignore"):  # the emptied boxes' extents overflow in the build
        trees = (wide_bvh.build_wide_bvh(accel, leaf_size=128, include=keep[0].cpu().numpy()),
                 wide_bvh.build_wide_bvh(emptied, leaf_size=128))
    inverted = trees[1].blocks[..., 0] > trees[1].blocks[..., 3]
    assert bool(inverted.any()) and not bool(inverted.all(dim=1).all())
    return trees


# "stream-256": K4 at leaf 256 (8 block boxes a leaf); "-occluders": K5b
# (Route A's) or K4b over occluder trees with alpha-masked triangles.
@pytest.mark.parametrize("route", ["wide", "stream", "stream-256", "wide-occluders",
                                   "stream-occluders"])
@pytest.mark.parametrize("n_rays", [8191, 0])
def test_transposed_kernels_match_plain(cuda_device, route, n_rays):
    """K5a/K5b and K4a/K4b on a 50k-triangle soup at leaf 128 (K4 at 256
    too): a ray count that leaves the last warp and block part-empty, and no
    rays at all.  Ties go to the lowest slot across blocks and leaves too,
    so t and slots are equal everywhere.  K5b and K4b over the soup's
    occluder trees with alpha-masked triangles (the ``include`` tree and
    the one over ``_occluder_accel``'s emptied boxes, with inverted block
    boxes): blocked masks equal to the plain version's over the same tree."""
    accel = _soup(50_000, 11, cuda_device)
    o, d = _rays(n_rays, 7, cuda_device)
    closest, any_ = _t_queries(route.split("-")[0])
    if route.endswith("-occluders"):
        t_max = torch.linspace(0.5, 12.0, n_rays, device=cuda_device)
        for tree in _masked_occluder_trees(accel, 2):
            launches = any_.launches
            blocked = any_(tree, o, d, t_max=t_max)
            torch.cuda.synchronize()
            assert any_.launches == launches + (n_rays > 0)
            assert torch.equal(blocked, wide_bvh.any_wide_plain(tree, o, d, t_max=t_max))
            assert n_rays == 0 or 0 < int(blocked.sum()) < n_rays
        return
    bvh = wide_bvh.build_wide_bvh(accel, leaf_size=256 if route == "stream-256" else 128)
    launches = (closest.launches, any_.launches)
    t_k, slot_k, hit_k = closest(bvh, o, d)
    t_p, slot_p, hit_p = wide_bvh.closest_wide_plain(bvh, o, d)
    t_max = torch.linspace(0.5, 12.0, n_rays, device=cuda_device)
    blocked = any_(bvh, o, d, t_max=t_max)
    torch.cuda.synchronize()
    assert (closest.launches, any_.launches) == tuple(n + (n_rays > 0) for n in launches)
    assert t_k.shape == slot_k.shape == blocked.shape == (n_rays,)
    assert torch.equal(hit_k, hit_p) and torch.equal(slot_k, slot_p) and torch.equal(t_k, t_p)
    assert torch.equal(blocked, wide_bvh.any_wide_plain(bvh, o, d, t_max=t_max))
    assert n_rays == 0 or 0 < int(blocked.sum()) < n_rays


@pytest.mark.parametrize("route", ["wide", "stream"])
def test_transposed_kernels_find_hits_just_past_an_edge(cuda_device, route):
    """K5a and K4a on the ray of ``test_kernel_finds_hits_just_past_an_edge``,
    over the Cornell box in 128-triangle leaves: its own slab must enter the
    floor's leaf for the warp to test it."""
    scene = cornell_box(light="both", with_spheres=True).to(cuda_device)
    bvh = wide_bvh.build_wide_bvh(
        build_woop(scene.geometry.positions, scene.geometry.indices), leaf_size=128
    )
    o = Vec3(*(torch.tensor([c], device=cuda_device)
               for c in (1.999899983406067, 0.021646535024046898, 0.026903629302978516)))
    d = Vec3(*(torch.tensor([c], device=cuda_device)
               for c in (-0.643088698387146, -0.5480369329452515, 0.5348762273788452)))
    closest, any_ = _t_queries(route)
    t_k, slot_k, hit_k = closest(bvh, o, d)
    t_p, slot_p, hit_p = wide_bvh.closest_wide_plain(bvh, o, d)
    assert bool(hit_p[0]) and bool(hit_k[0])
    assert torch.equal(t_k, t_p) and torch.equal(slot_k, slot_p)
    assert bool(any_(bvh, o, d, t_max=t_p + 1e-3)[0])


@pytest.mark.parametrize("route", ["wide", "stream"])
def test_transposed_wrappers_reject_what_the_kernels_do_not_take(cuda_device, route):
    """A leaf that is not a multiple of 128, a leaf pack that is not float32,
    a tree deeper than the kernel's stack (64 for K5 and K4), and a tree
    without block boxes, or with boxes of the wrong shape (all four kernels
    cull by them), each raised before any launch."""
    accel = _soup(300, 5, cuda_device)
    bvh = wide_bvh.build_wide_bvh(accel, leaf_size=128)
    o, d = _rays(64, 3, cuda_device)
    closest, any_ = _t_queries(route)
    with pytest.raises(ValueError, match="multiple of 128"):
        closest(wide_bvh.build_wide_bvh(accel, leaf_size=64), o, d)
    with pytest.raises(ValueError, match="float32"):
        any_(dataclasses.replace(bvh, w=bvh.w.double()), o, d)
    with pytest.raises(ValueError, match="stack of 65"):
        closest(dataclasses.replace(bvh, max_stack=65), o, d)
    # K5a, K5b, K4a and K4b cull by the leaves' block boxes, and need them.
    culled = (closest, any_)
    launches = [fn.launches for fn in culled]
    for fn in culled:
        with pytest.raises(ValueError, match="block boxes"):
            fn(dataclasses.replace(bvh, blocks=None), o, d)
        with pytest.raises(ValueError, match="WideBVH.blocks"):
            fn(dataclasses.replace(bvh, blocks=bvh.blocks[:, :2].contiguous()), o, d)
    assert [fn.launches for fn in culled] == launches


def _flat_queries(kind, accel):
    """(structure, closest kernel, closest plain, any kernel, any plain) of
    the chunk kernels (K7) or the binary-BVH kernels (K6; ``"bvh2-16"``:
    leaves of 16, else 64)."""
    if kind == "chunks":
        m = intersect_pallas
        return (m.pack_for_pallas(accel, 512), m.intersect_closest_pallas, m.closest_chunks_plain,
                m.intersect_any_pallas, m.any_chunks_plain)
    m = traverse_pallas
    return (build_bvh(accel, leaf_size=16 if kind == "bvh2-16" else 64), m.intersect_closest_bvh,
            m.closest_bvh_plain, m.intersect_any_bvh, m.any_bvh_plain)


@pytest.mark.parametrize("kind", ["chunks", "bvh2", "bvh2-16"])
@pytest.mark.parametrize("n_rays", [8191, 0])
def test_flat_and_binary_kernels_match_plain(cuda_device, kind, n_rays):
    """K7 and K6 on a 5,000-triangle soup (K6 at leaf 64 and 16): a ray
    count that leaves the last block part-empty, and no rays at all.  K7a's
    and K6a's t and every id equal the plain version's bit for bit; K7b's
    and K6b's masks equal."""
    accel = _soup(5000, 11, cuda_device)
    tree, closest, closest_plain, any_, any_plain = _flat_queries(kind, accel)
    o, d = _rays(n_rays, 7, cuda_device)
    launches = closest.launches
    t_k, id_k, hit_k = closest(tree, o, d)
    t_p, id_p, hit_p = closest_plain(tree, o, d)
    torch.cuda.synchronize()
    assert closest.launches == launches + (n_rays > 0)
    assert t_k.shape == id_k.shape == (n_rays,)
    assert torch.equal(hit_k, hit_p) and torch.equal(t_k, t_p) and torch.equal(id_k, id_p)

    t_max = torch.linspace(0.5, 12.0, n_rays, device=cuda_device)
    launches = any_.launches
    blocked = any_(tree, o, d, t_max=t_max)
    assert torch.equal(blocked, any_plain(tree, o, d, t_max=t_max))
    assert any_.launches == launches + (n_rays > 0)
    assert n_rays == 0 or 0 < int(blocked.sum()) < n_rays


def _cornell_rays(device, size=64):
    """The Cornell box's primary rays at ``size`` x ``size``, and as many
    rays from seeded points inside the box in seeded directions."""
    scene = cornell_box(light="both", with_spheres=True).to(device)
    opts = RenderOptions(width=size, height=size, max_render_passes=4, max_ray_depth=4)
    camera = orbit_camera(size, size, distance=6.2, focal_length_mm=35.0).to(device)
    ctx = make_context(opts, scene, device)
    primary = integrator.start_paths(camera, ctx, opts, 0)
    rng = np.random.default_rng(23)
    o = rng.uniform(-1.8, 1.8, (3, size * size)).astype(np.float32)  # the box spans [-2, 2]
    d = rng.normal(size=(3, size * size)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    org, dirs = (Vec3.from_planar(torch.cat([v.to_planar(), torch.from_numpy(a).to(device)], 1))
                 for v, a in ((primary.org, o), (primary.direction, d)))
    return scene, org, dirs


@pytest.mark.parametrize("tri_chunk", [64, 512])
@pytest.mark.parametrize("where", ["soup", "cornell", "cornell, warps mixed"])
def test_chunk_kernels_match_plain_bit_for_bit(cuda_device, tri_chunk, where):
    """K7a over chunks of 64 and 512 triangles, on the soup and on the
    Cornell box (its primary rays and rays from inside it): t and every id
    equal the plain version's bit for bit, and K7b's masks equal.  "warps
    mixed" deals the Cornell rays out with a stride of 128, so that the
    lanes of a warp hit different chunks: a warp serves each chunk to its
    own lanes alone."""
    if where == "soup":
        accel = _soup(5000, 11, cuda_device)
        o, d = _rays(8192, 7, cuda_device)
    else:
        scene, o, d = _cornell_rays(cuda_device)
        accel = build_woop(scene.geometry.positions, scene.geometry.indices)
        if where == "cornell, warps mixed":
            order = torch.arange(o.x.numel(), device=cuda_device).view(-1, 128).T.reshape(-1)
            o, d = o.map(lambda c: c[order]), d.map(lambda c: c[order])
    packed = intersect_pallas.pack_for_pallas(accel, tri_chunk)
    t_k, id_k, hit_k = intersect_pallas.intersect_closest_pallas(packed, o, d)
    t_p, id_p, hit_p = intersect_pallas.closest_chunks_plain(packed, o, d)
    torch.cuda.synchronize()
    assert torch.equal(hit_k, hit_p) and torch.equal(t_k, t_p) and torch.equal(id_k, id_p)
    assert int(hit_k.sum()) > o.x.numel() // 4
    if where == "cornell, warps mixed":  # most warps' hits lie in more than one chunk
        chunk = torch.where(hit_k, id_k // tri_chunk, -1).view(-1, 32)
        mixed = (chunk.amax(dim=1) != torch.where(chunk < 0, chunk.amax(), chunk).amin(dim=1))
        assert float(mixed.float().mean()) > 0.5
    t_max = torch.where(hit_p, t_p * 0.999, 5.0)
    blocked = intersect_pallas.intersect_any_pallas(packed, o, d, t_max=t_max)
    assert torch.equal(blocked, intersect_pallas.any_chunks_plain(packed, o, d, t_max=t_max))


def test_closest_chunk_kernel_takes_chunks_of_any_size(cuda_device):
    """K7a and K7b keep no chunk in shared memory, so chunks of 64, 512 and
    8,192 triangles (384 KB of columns, more than a block's shared memory,
    which K7b refused before it walked per ray) and of 100 (not a multiple
    of 4: 4-byte reads) give the plain version's t and ids bit for bit, and
    its occlusion masks."""
    accel = _soup(9000, 5, cuda_device)
    o, d = _rays(2048, 3, cuda_device)
    t_max = torch.linspace(0.5, 12.0, 2048, device=cuda_device)
    for tri_chunk in (8192, 100, 64, 512):
        packed = intersect_pallas.pack_for_pallas(accel, tri_chunk)
        got = intersect_pallas.intersect_closest_pallas(packed, o, d)
        want = intersect_pallas.closest_chunks_plain(packed, o, d)
        blocked = intersect_pallas.intersect_any_pallas(packed, o, d, t_max=t_max)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert int(got[2].sum()) > 100
        assert torch.equal(blocked, intersect_pallas.any_chunks_plain(packed, o, d, t_max=t_max))
        assert 0 < int(blocked.sum()) < 2048


@pytest.mark.parametrize("n_rays", [0, 4095])
def test_any_chunk_kernel_on_the_occluder_pack(cuda_device, n_rays):
    """K7b over the rebuild mode's occluder pack of the Cornell box with the
    metal sphere alpha-masked, whose blocks of masked triangles have zero
    rows and inverted boxes: no rays at all, and a ray count that leaves the
    last warp part-empty (the Cornell rays of ``_cornell_rays``, t_max just
    beyond each ray's closest hit in the full pack)."""
    scene, o, d = _cornell_rays(cuda_device)
    mask = torch.zeros_like(scene.materials.alpha_mask)
    mask[5] = 1
    scene = dataclasses.replace(scene, has_alpha_mask=True, materials=dataclasses.replace(
        scene.materials, alpha_mask=mask))
    opts = RenderOptions(width=8, height=8, max_render_passes=4, max_ray_depth=4)
    pack = integrator.rebuild_pack(scene, opts)
    occl = pack.packed_occl
    assert bool((occl.blocks[..., 0] > occl.blocks[..., 3]).any())
    o, d = o.map(lambda c: c[:n_rays].contiguous()), d.map(lambda c: c[:n_rays].contiguous())
    t, _, hit = intersect_pallas.closest_chunks_plain(pack.packed, o, d)
    t_max = torch.where(hit, t * 1.001, 5.0)
    launches = intersect_pallas.intersect_any_pallas.launches
    blocked = intersect_pallas.intersect_any_pallas(occl, o, d, t_max=t_max)
    want = intersect_pallas.any_chunks_plain(occl, o, d, t_max=t_max)
    torch.cuda.synchronize()
    assert intersect_pallas.intersect_any_pallas.launches == launches + (n_rays > 0)
    assert blocked.shape == (n_rays,) and torch.equal(blocked, want)
    if n_rays:
        full = intersect_pallas.any_chunks_plain(pack.packed, o, d, t_max=t_max)
        assert 0 < int(blocked.sum()) < int(full.sum())


@pytest.mark.parametrize("n_rays", [0, 4095])
def test_any_binary_kernel_on_the_occluder_tree(cuda_device, n_rays):
    """K6b over the ``"bvh"`` context's occluder tree of the Cornell box
    with the metal sphere alpha-masked (``build_bvh(include=...)``), whose
    block boxes bound the included triangles alone: no rays at all, and a
    ray count that leaves the last warp part-empty (the Cornell rays of
    ``_cornell_rays``, t_max just beyond each ray's closest hit in the full
    tree).  Its masks equal the plain version's, and it blocks fewer rays
    than the full tree, whose sphere blocks some."""
    scene, o, d = _cornell_rays(cuda_device)
    mask = torch.zeros_like(scene.materials.alpha_mask)
    mask[5] = 1
    scene = dataclasses.replace(scene, has_alpha_mask=True, materials=dataclasses.replace(
        scene.materials, alpha_mask=mask))
    opts = RenderOptions(width=8, height=8, max_render_passes=4, max_ray_depth=4,
                         intersect_backend="bvh")
    pack = make_context(opts, scene, cuda_device).accel_pack
    bvh, occl = pack.bvh, pack.bvh_occl
    assert occl is not bvh and occl.num_nodes < bvh.num_nodes
    o, d = o.map(lambda c: c[:n_rays].contiguous()), d.map(lambda c: c[:n_rays].contiguous())
    t, _, hit = traverse_pallas.closest_bvh_plain(bvh, o, d)
    t_max = torch.where(hit, t * 1.001, 5.0)
    launches = traverse_pallas.intersect_any_bvh.launches
    blocked = traverse_pallas.intersect_any_bvh(occl, o, d, t_max=t_max)
    want = traverse_pallas.any_bvh_plain(occl, o, d, t_max=t_max)
    torch.cuda.synchronize()
    assert traverse_pallas.intersect_any_bvh.launches == launches + (n_rays > 0)
    assert blocked.shape == (n_rays,) and torch.equal(blocked, want)
    if n_rays:
        full = traverse_pallas.any_bvh_plain(bvh, o, d, t_max=t_max)
        assert 0 < int(blocked.sum()) < int(full.sum())


@pytest.mark.parametrize("kind", ["chunks", "bvh2"])
def test_flat_and_binary_kernels_find_hits_just_past_an_edge(cuda_device, kind):
    """The ray of ``test_kernel_finds_hits_just_past_an_edge`` through K7's
    chunk boxes and K6's node boxes."""
    scene = cornell_box(light="both", with_spheres=True).to(cuda_device)
    accel = build_woop(scene.geometry.positions, scene.geometry.indices)
    tree, closest, closest_plain, any_, _ = _flat_queries(kind, accel)
    o = Vec3(*(torch.tensor([c], device=cuda_device)
               for c in (1.999899983406067, 0.021646535024046898, 0.026903629302978516)))
    d = Vec3(*(torch.tensor([c], device=cuda_device)
               for c in (-0.643088698387146, -0.5480369329452515, 0.5348762273788452)))
    t_k, id_k, hit_k = closest(tree, o, d)
    t_p, id_p, hit_p = closest_plain(tree, o, d)
    assert bool(hit_p[0]) and bool(hit_k[0])
    assert torch.equal(t_k, t_p) and torch.equal(id_k, id_p)
    assert bool(any_(tree, o, d, t_max=t_p + 1e-3)[0])


def test_flat_and_binary_wrappers_raise(cuda_device):
    """A tree deeper than K6's stack, rays that are not float32, a binary
    tree without block boxes, or with block boxes or anchors of the wrong
    shape (K6a culls by them), and a misaligned pack: each raised before
    any launch."""
    accel = _soup(300, 5, cuda_device)
    o, d = _rays(64, 3, cuda_device)
    bvh = build_bvh(accel, leaf_size=16)
    closest = traverse_pallas.intersect_closest_bvh
    launches = closest.launches
    with pytest.raises(ValueError, match="stack of 97"):
        closest(dataclasses.replace(bvh, max_stack=97), o, d)
    with pytest.raises(ValueError, match="float32"):
        traverse_pallas.intersect_any_bvh(bvh, o.map(lambda c: c.double()), d)
    with pytest.raises(ValueError, match="block boxes"):
        closest(dataclasses.replace(bvh, blocks=None), o, d)
    with pytest.raises(ValueError, match="BVH.blocks"):
        closest(dataclasses.replace(bvh, blocks=bvh.blocks[:-1].contiguous()), o, d)
    with pytest.raises(ValueError, match="BVH.wanchor"):
        closest(dataclasses.replace(bvh, wanchor=bvh.wanchor[:, :-1].contiguous()), o, d)
    assert closest.launches == launches
    packed = intersect_pallas.pack_for_pallas(accel, 64)
    shifted = torch.empty(packed.w.numel() + 1, device=cuda_device)[1:].view(packed.w.shape)
    launches = intersect_pallas.intersect_any_pallas.launches
    with pytest.raises(ValueError, match="aligned"):
        intersect_pallas.intersect_closest_pallas(dataclasses.replace(packed, w=shifted), o, d)
    with pytest.raises(ValueError, match="aligned"):
        intersect_pallas.intersect_any_pallas(dataclasses.replace(packed, w=shifted), o, d)
    assert intersect_pallas.intersect_any_pallas.launches == launches


def test_render_matches_cpu(cuda_device):
    """The golden configuration config2 (48x48, 4 passes, depth 4) on the
    card (kernels) and on the CPU (plain versions), at the golden's
    tolerance.  PyTorch rounds sqrt, sin, cos, exp and sums differently on
    the two devices, so the images agree to a few ulps of the radiance
    unless one ulp flips a path's choice somewhere."""
    size, passes = 48, 4
    opts = RenderOptions(width=size, height=size, max_render_passes=passes, max_ray_depth=4)
    scene = cornell_box(light="both", with_spheres=True)
    camera = orbit_camera(size, size, distance=6.2, focal_length_mm=35.0)
    on_card, _ = render(scene, camera, opts, num_passes=passes, device=cuda_device)
    on_cpu, _ = render(scene, camera, opts, num_passes=passes, device="cpu")
    torch.testing.assert_close(on_card.cpu(), on_cpu, rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("name", ["config1_sphere_plane", "config3_pbr_env",
                                  "config4_glass_dof", "config5_full_aces"])
def test_golden_configs_match_cpu(cuda_device, name):
    """config1, config3 (a lat/long sky), config4 and config5
    (``multi_material``) on the card and on the CPU at the golden's
    tolerance, as config2 above."""
    scene, camera, opts = golden_config(name)
    out = {}
    for device in (cuda_device, torch.device("cpu")):
        out[device.type], _ = render(scene, camera, opts, num_passes=GOLDEN_PASSES, device=device)
    torch.testing.assert_close(out["cuda"].cpu(), out["cpu"], rtol=5e-3, atol=5e-3)


def test_textured_scene_matches_cpu(cuda_device):
    """``chip_smoke.py``'s Scene B (2048x2048 textures with their mips, an
    alpha-masked cut-out, a 2k lat/long map) at 64x64, 4 passes, depth 5 on
    the card and on the CPU, at the tolerance of ``test_render_matches_cpu``."""
    from chip_smoke import appearance_scenes

    size, passes = 64, 4
    _, scene = appearance_scenes("cpu")
    opts = RenderOptions(width=size, height=size, max_render_passes=passes, max_ray_depth=5)
    camera = orbit_camera(size, size, distance=6.0, theta=0.3)
    on_card, _ = render(scene, camera, opts, num_passes=passes, device=cuda_device)
    on_cpu, _ = render(scene, camera, opts, num_passes=passes, device="cpu")
    assert bool(torch.isfinite(on_card).all()) and float(on_card[:3].max()) > 0.0
    torch.testing.assert_close(on_card.cpu(), on_cpu, rtol=5e-3, atol=5e-3)


def step_grads(device, opts):
    """The gradients of bench.py's fwd+bwd step (``mean(img^2)`` of one pass,
    ``static_shading=False``) over ``base_color``, ``roughness`` and
    ``light.point_color`` of the Cornell box."""
    scene = cornell_box(light="both", with_spheres=True).to(device)
    camera = orbit_camera(opts.width, opts.height, distance=6.2, focal_length_mm=35.0)
    ctx = make_context(opts, scene, device=device, static_shading=False)
    params = params_from_arrays({
        "base_color": scene.materials.base_color.cpu().numpy(),
        "roughness": scene.materials.roughness.cpu().numpy(),
        "light.point_color": scene.lights.point_color.cpu().numpy()}, device=device)
    target = torch.zeros((opts.height, opts.width, 3))
    make_loss_fn(scene, camera, ctx, opts, target)(params).backward()
    return {k: v.grad.cpu() for k, v in params.items()}


def test_step_gradients_match_cpu(cuda_device):
    """At tests/test_inverse.py's size (24x24, depth 2) the card's step
    gradients (K1/K2, sorted and gated) equal the CPU's (plain versions,
    unsorted) within 1e-3 of each key's largest |g| (F6: float32 rounding
    differs by device)."""
    opts = RenderOptions(width=24, height=24, max_render_passes=4, max_ray_depth=2)
    card, cpu = step_grads(cuda_device, opts), step_grads(torch.device("cpu"), opts)
    for k, want in cpu.items():
        assert torch.isfinite(card[k]).all() and float(want.abs().max()) > 0.0, k
        torch.testing.assert_close(card[k], want, rtol=0.0, atol=1e-3 * float(want.abs().max()))


def golden_config(name):
    """(scene, camera, options) of a config of ``tests/test_goldens.py``,
    built with the port's own builders: config1 (a directional light),
    config2 (the Cornell box), config3 (clearcoat under a 16x32 lat/long
    sky), config4 (glass and hexagon-bokeh depth of field under a solid
    environment) or config5 (``multi_material``; its golden is the ACES
    display image)."""
    size, b = GOLDEN_SIZE, SceneBuilder()
    opts = RenderOptions(width=size, height=size, max_render_passes=GOLDEN_PASSES)
    if name == "config1_sphere_plane":
        b.add_mesh(sphere_mesh(24, 24, 1.0), PBRParams(base_color=(0.7, 0.7, 0.7)))
        b.add_mesh(plane_mesh(12, 12), PBRParams(base_color=(0.8, 0.8, 0.8)),
                   transform=translate([0, -1.0, 0]))
        b.add_directional_light(DirectionalLight(direction=(0.4, 0.8, 0.45), illuminance=20000.0))
        camera = orbit_camera(size, size, distance=5.0, theta=0.35)
        return b.build(), camera, dataclasses.replace(opts, max_ray_depth=2)
    if name == "config2_cornell":
        camera = orbit_camera(size, size, distance=6.2, focal_length_mm=35.0)
        return (cornell_box(light="both", with_spheres=True), camera,
                dataclasses.replace(opts, max_ray_depth=4))
    if name == "config3_pbr_env":
        b.add_mesh(sphere_mesh(24, 24, 1.0), PBRParams(
            base_color=(0.6, 0.1, 0.1), metallic=0.8, roughness=0.25, clearcoat=1.0,
            clearcoat_roughness=0.1, specular_f0=0.5))
        sky = np.linspace(3.0, 0.05, 16, dtype=np.float32)[:, None, None]
        b.set_environment(EnvironmentLightDesc(image=np.broadcast_to(sky, (16, 32, 3)).copy(),
                                               exposure=0.0))
        camera = orbit_camera(size, size, distance=4.0, theta=0.3)
        return b.build(), camera, dataclasses.replace(opts, max_ray_depth=3)
    if name == "config5_full_aces":
        camera = orbit_camera(size, size, distance=6.0, theta=0.3)
        return multi_material(), camera, dataclasses.replace(opts, max_ray_depth=5)
    b.add_mesh(sphere_mesh(24, 24, 1.0),
               GlassParams(base_color=(0.8, 0.9, 0.8), roughness=0.1, ior=1.5, density=0.4))
    b.add_mesh(plane_mesh(12, 12), PBRParams(base_color=(0.7, 0.7, 0.9)),
               transform=translate([0, -1.0, 0]))
    b.set_environment(EnvironmentLightDesc(solid_color=(0.5, 0.5, 0.5)))
    camera = orbit_camera(size, size, distance=5.0, theta=0.3, focus_distance=5.0,
                          aperture_radius=0.15)
    return b.build(), camera, dataclasses.replace(opts, max_ray_depth=4, bokeh_shape="hexagon")


@pytest.mark.parametrize("backend", ["bvh", "pallas", "rebuild", "wide-vpu", "stream-vpu"])
def test_other_routes_render_matches_cpu(cuda_device, backend):
    """config2 through the binary BVH (K6), the prebuilt chunk pack and the
    rebuild mode (K7), and the transposed leaf math of the wide (K5) and the
    streaming (K4) trees, on the card and on the CPU, at the golden's
    tolerance."""
    size, passes = 48, 4
    opts = RenderOptions(width=size, height=size, max_render_passes=passes, max_ray_depth=4)
    opts = dataclasses.replace(opts, **{
        "rebuild": {"intersect_backend": "pallas"},
        "wide-vpu": {"wide_leaf_math": "vpu"},
        "stream-vpu": {"intersect_backend": "stream", "stream_leaf_math": "vpu"},
    }.get(backend, {"intersect_backend": backend}))
    scene = cornell_box(light="both", with_spheres=True)
    camera = orbit_camera(size, size, distance=6.2, focal_length_mm=35.0)
    out = {}
    for device in (cuda_device, torch.device("cpu")):
        ctx = make_context(opts, device=device) if backend == "rebuild" else None
        out[device.type], _ = render(scene, camera, opts, num_passes=passes, ctx=ctx,
                                     device=device)
    torch.testing.assert_close(out["cuda"].cpu(), out["cpu"], rtol=5e-3, atol=5e-3)


# --- the traversal probes (csrc/probes.cu) -------------------------------------


def _cornell_tree(device, leaf_size):
    scene = cornell_box(light="both", with_spheres=True).to(device)
    accel = build_woop(scene.geometry.positions, scene.geometry.indices)
    return scene, accel, wide_bvh.build_wide_bvh(accel, leaf_size=leaf_size)


@pytest.mark.parametrize("leaf_size", [32, 128])
def test_visit_stats_kernel_matches_plain(cuda_device, leaf_size):
    """P3: per-tile counts of the kernel's block walk, and the work they
    need, equal the plain walk's, plain and seeded, with a partial last tile
    whose absent lanes count for nothing."""
    scene, accel, bvh = _cornell_tree(cuda_device, leaf_size)
    o, d = _rays(2 * 256 + 100, 5, cuda_device)
    seed_w, seed_anchor, _ = visit_stats.seed_chunk(scene, accel)
    for k in (0, 32):
        launches = visit_stats.visit_stats.launches
        got = visit_stats.visit_stats(bvh, o, d, seed_w, seed_anchor, seed_k=k, work=True)
        want = visit_stats.visit_stats_plain(bvh, o, d, seed_w, seed_anchor, seed_k=k,
                                             work=True)
        torch.cuda.synchronize()
        assert visit_stats.visit_stats.launches == launches + 1
        assert len(got) == len(want) == 5
        for a, b in zip(got, want):
            assert a.shape[0] == 3 and torch.equal(a, b)
        assert float(got[1].sum()) > 0 and int(got[4][:, 2].sum()) > 0


@pytest.fixture(scope="module")
def bounce_wavefronts():
    """The first-bounce wavefront (depth 2) of the Cornell box over its
    leaf-32 tree and of ``high_poly`` over its leaf-128 tree, at 48x38 (1,824
    rays: 7 whole tiles and 32 rays): scene name -> (scene, accel, tree,
    origins, directions)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernels have no CPU mode)")
    from heatray_tpu_torch.options import FrameGlobals

    device = torch.device("cuda:0")
    out = {}
    for name in ("cornell", "high-poly"):
        scene, camera, opts, ctx, tree = visit_stats.setup(name, 48, 38, 2, device)
        paths = integrator.start_paths(camera, ctx, opts, 0)
        paths, _ = integrator.bounce(scene, ctx, opts, FrameGlobals.create(0, device=device), 1,
                                     paths, ctx.accel_pack)
        out[name] = (scene, ctx.accel_pack.accel, tree, paths.org, paths.direction)
    return out


@pytest.mark.parametrize("scene_name", ["cornell", "high-poly"])
@pytest.mark.parametrize("seed_k", [0, 32])
def test_visit_stats_kernel_matches_plain_on_every_tile(bounce_wavefronts, scene_name, seed_k):
    """P3 on a first-bounce wavefront whose rays are no multiple of 256: the
    four counts and the work counts of every tile equal the plain walk's,
    which tests every ray at each opened leaf where the kernel serves only
    the rays that entered it; one launch counted."""
    scene, accel, tree, o, d = bounce_wavefronts[scene_name]
    assert o.x.numel() % 256
    seed_w, seed_anchor, _ = visit_stats.seed_chunk(scene, accel)
    launches = visit_stats.visit_stats.launches
    got = visit_stats.visit_stats(tree, o, d, seed_w, seed_anchor, seed_k=seed_k, work=True)
    torch.cuda.synchronize()
    assert visit_stats.visit_stats.launches == launches + 1
    want = visit_stats.visit_stats_plain(tree, o, d, seed_w, seed_anchor, seed_k=seed_k,
                                         work=True)
    for a, b in zip(got, want):
        assert a.shape[0] == 8 and torch.equal(a, b)
    assert float(got[1].sum()) > 0 and float(got[3].sum()) > 0 and int(got[4][:, 2].sum()) > 0


@pytest.mark.parametrize("ray_tile", [256, 512, 1024])
@pytest.mark.parametrize("n_rays", [8191, 1000])
def test_node_walk_kernel_matches_plain_on_a_deep_tree(bounce_wavefronts, ray_tile, n_rays):
    """P1 ``nodes`` over ``high_poly``'s leaf-32 tree, on ray counts that are
    no multiple of 32 or 128, whatever ``ray_tile`` (the kernel's blocks are
    K1's): t = MISS_T and each ray's node visits equal the plain count; one
    launch counted."""
    _, accel, _, _, _ = bounce_wavefronts["high-poly"]
    bvh = wide_bvh.build_wide_bvh(accel, leaf_size=32)
    rng = np.random.default_rng(n_rays)
    lo = accel.tri_min.min(dim=1).values.cpu().numpy()
    hi = accel.tri_max.max(dim=1).values.cpu().numpy()
    o = rng.uniform(lo - 0.2 * (hi - lo), hi + 0.2 * (hi - lo), (n_rays, 3))
    d = rng.uniform(lo, hi, (n_rays, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = (Vec3(*(torch.from_numpy(a[:, k].astype(np.float32).copy()).to(accel.w.device)
                   for k in range(3))) for a in (o, d))
    launches = kernel_probe.node_walk.launches
    t, visits = kernel_probe.node_walk(bvh, o, d, ray_tile)
    torch.cuda.synchronize()
    assert kernel_probe.node_walk.launches == launches + 1
    t_p, visits_p = kernel_probe.node_walk_plain(bvh, o, d)
    assert torch.equal(t, t_p) and bool((t == MISS_T).all())
    assert torch.equal(visits, visits_p) and int(visits.max()) > 20


@pytest.mark.parametrize("ray_tile, n_rays", [(256, 8191), (1024, 8191), (512, 0)])
def test_node_walk_and_empty_kernels_match_plain(cuda_device, ray_tile, n_rays):
    """P1 ``nodes`` and ``grid``: t = MISS_T and each ray's node visits
    equal the plain frontier count; x * 0 equal; no launch counted for no
    rays."""
    _, _, bvh = _cornell_tree(cuda_device, 32)
    o, d = _rays(n_rays, 9, cuda_device)
    launches = (kernel_probe.node_walk.launches, kernel_probe.empty.launches)
    t, visits = kernel_probe.node_walk(bvh, o, d, ray_tile)
    t_p, visits_p = kernel_probe.node_walk_plain(bvh, o, d)
    zero = kernel_probe.empty(o, ray_tile)
    torch.cuda.synchronize()
    assert torch.equal(t, t_p) and torch.equal(visits, visits_p)
    assert torch.equal(zero, kernel_probe.empty_plain(o))
    n = int(n_rays > 0)
    assert (kernel_probe.node_walk.launches, kernel_probe.empty.launches) == (
        launches[0] + n, launches[1] + n)
    if n_rays:
        assert int(visits.max()) > 1


@pytest.mark.parametrize("ray_tile", [256, 512, 1024])
def test_empty_kernel_matches_plain_on_any_view(cuda_device, ray_tile):
    """P1 ``grid`` on an unaligned view, on 1, 3 and 8,191 floats and on -1,
    -0, 0, +-inf, NaN and +-3e37 (aligned and not): x * 0 equal to
    ``empty_plain`` bit for bit, one launch counted each."""
    o, _ = _rays(8192, 9, cuda_device)
    special = torch.tensor([-1.0, -0.0, 0.0, float("inf"), -float("inf"), float("nan"), 3e37,
                            -3e37], device=cuda_device).repeat(5)
    views = [o.x[1:], o.x[:1], o.x[1:2], o.x[5:8], o.x[:8191], o.x[3:], special, special[1:],
             special[3:6]]
    for x in views:
        v = Vec3(x, x, x)
        launches = kernel_probe.empty.launches
        got = kernel_probe.empty(v, ray_tile)
        want = kernel_probe.empty_plain(v)
        torch.cuda.synchronize()
        assert kernel_probe.empty.launches == launches + 1
        assert got.shape == x.shape
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), x.numel()


@pytest.mark.parametrize("layout", ["rows", "warp"])
@pytest.mark.parametrize("anchored, ray_tile", [(False, 256), (True, 512)])
def test_brute_kernels_match_plain(cuda_device, layout, anchored, ray_tile):
    """P1 ``leaves`` and P4: both layouts of the brute force equal the plain
    version (the same float32 arithmetic: t within 1e-5), over the
    un-anchored pack of P4 and over a tree's anchored chunks with their
    anchors, with a last warp of 31 rays."""
    _, accel, bvh = _cornell_tree(cuda_device, 128)
    w, anchor = (bvh.w, bvh.wanchor) if anchored else (vpu_leaf.pack_chunks(accel, 128), None)
    o, d = _rays(8191, 13, cuda_device)
    fn = vpu_leaf.rows_closest if layout == "rows" else vpu_leaf.warp_closest
    launches = fn.launches
    t = fn(w, o, d, anchor, ray_tile)
    t_p = vpu_leaf.closest_brute_plain(w, o, d, anchor)
    torch.cuda.synchronize()
    assert fn.launches == launches + 1
    assert torch.equal(t < MISS_T, t_p < MISS_T)
    torch.testing.assert_close(t, t_p, rtol=1e-5, atol=1e-5)
    assert 0 < int((t < MISS_T).sum()) < 8191


@pytest.mark.parametrize("n_rays", [8191, 1000, 33])
@pytest.mark.parametrize("source, tc", [("tree", 32), ("tree", 64), ("tree", 128), ("pack", 128),
                                        ("pack", 256), ("pack", 512), ("pack", 100)])
def test_rows_brute_kernel_matches_plain_at_every_probe_setting(cuda_device, source, tc,
                                                                 n_rays):
    """``rows_brute_kernel`` (four rays a thread, columns staged in shared
    memory 128 at a time) at every chunk size P1 (a tree's anchored leaves
    of 32, 64 and 128) and P4 (packs of 128, 256 and 512) sweep, and at 100
    (tiles that span chunks at uneven places), with every ray tile they
    sweep: ray counts that leave the last block part-empty and a thread's
    rays part-valid.  t equals the plain version's within 1e-5, and is the
    same on every ray at every tile (the minimum does not depend on the
    order of the columns)."""
    _, accel, bvh = _cornell_tree(cuda_device, tc if source == "tree" else 32)
    w, anchor = (bvh.w, bvh.wanchor) if source == "tree" else (vpu_leaf.pack_chunks(accel, tc),
                                                              None)
    o, d = _rays(n_rays, 13, cuda_device)
    t_p = vpu_leaf.closest_brute_plain(w, o, d, anchor)
    launches = vpu_leaf.rows_closest.launches
    first = None
    for ray_tile in (256, 512, 1024, 32):
        t = vpu_leaf.rows_closest(w, o, d, anchor, ray_tile)
        torch.cuda.synchronize()
        assert torch.equal(t < MISS_T, t_p < MISS_T)
        torch.testing.assert_close(t, t_p, rtol=1e-5, atol=1e-5)
        first = t if first is None else first
        assert torch.equal(t, first)
    assert vpu_leaf.rows_closest.launches == launches + 4
    assert int((t_p < MISS_T).sum()) > n_rays // 2


@pytest.mark.parametrize("n_rays", [8191, 1000, 33])
@pytest.mark.parametrize("source, tc", [("tree", 32), ("tree", 64), ("tree", 128), ("pack", 128),
                                        ("pack", 256), ("pack", 512), ("pack", 100)])
def test_warp_brute_kernel_matches_plain_at_every_probe_setting(cuda_device, source, tc,
                                                                 n_rays):
    """``warp_brute_kernel`` (columns held in registers, 128-column slices of
    one chunk, the block's rays staged in shared memory) at every chunk size
    P1 and P4 sweep and at 100 (slices part-empty past each chunk's last
    column), with every ray tile they sweep: ray counts that leave the last
    block part-empty.  t equals the plain version's within 1e-5, is the same
    on every ray at every tile, and equals ``rows_brute_kernel``'s bit for
    bit (the minimum does not depend on the order of the columns or on the
    bound the pairs were culled by)."""
    _, accel, bvh = _cornell_tree(cuda_device, tc if source == "tree" else 32)
    w, anchor = (bvh.w, bvh.wanchor) if source == "tree" else (vpu_leaf.pack_chunks(accel, tc),
                                                              None)
    o, d = _rays(n_rays, 13, cuda_device)
    t_p = vpu_leaf.closest_brute_plain(w, o, d, anchor)
    rows = vpu_leaf.rows_closest(w, o, d, anchor)
    launches = vpu_leaf.warp_closest.launches
    for ray_tile in (256, 512, 1024, 32):
        t = vpu_leaf.warp_closest(w, o, d, anchor, ray_tile)
        torch.cuda.synchronize()
        assert torch.equal(t < MISS_T, t_p < MISS_T)
        torch.testing.assert_close(t, t_p, rtol=1e-5, atol=1e-5)
        assert torch.equal(t, rows)
    assert vpu_leaf.warp_closest.launches == launches + 4
    assert int((t_p < MISS_T).sum()) > n_rays // 2


# --- the walk variants (csrc/variants.cu) ---------------------------------------


def _assert_equal_to_plain(case, out, want):
    t, slot, tests = out
    t_p, slot_p = want
    assert torch.equal(t < MISS_T, t_p < MISS_T), case
    torch.testing.assert_close(t, t_p, rtol=1e-5, atol=1e-5)
    assert torch.equal(slot, slot_p), case
    return tests


@pytest.mark.parametrize("ray_tile", [256, 512, 1024])
def test_walk_variant_kernels_match_plain(cuda_device, ray_tile):
    """P2a: every variant of ``variant_walk_kernel`` (v4 at groups 32, 64 and
    128) equals its plain version on whole tiles with a partial last one (t
    within 1e-5, slots equal, all -1 for v3).  v0-v2 and v4 compute K1's
    function: their t and slots equal K1's bit for bit, and so those of v0
    at tile 256, at every tile; v3's t equals them too.  The tests per tile
    say what each variant did: v2 and v3 walk and test as v0; v1 tests every
    child of every visited node; v4 no more than v0."""
    _, _, bvh = _cornell_tree(cuda_device, 32)
    o, d = _rays(3 * ray_tile + 100, 21, cuda_device)
    kv = kernel_variants
    t_k1, slot_k1, _ = wide_bvh.intersect_closest_wide(bvh, o, d)
    t_256, slot_256, _ = kv.variant_walk(bvh, o, d, "v0", 256)
    tests = {}
    for variant, group in [("v0", 128), ("v1", 128), ("v2", 128), ("v3", 128),
                           ("v4", 32), ("v4", 64), ("v4", 128)]:
        case = kv.Case(variant, ray_tile, group)
        launches = kv.variant_walk.launches
        out = kv.variant_walk(bvh, o, d, variant, ray_tile, group)
        torch.cuda.synchronize()
        assert kv.variant_walk.launches == launches + 1
        tests[case.name] = _assert_equal_to_plain(case, out, kv.case_plain(case, bvh, None, o, d))
        for want in (t_k1, t_256):
            assert torch.equal(out[0], want), case
        if variant != "v3":
            assert torch.equal(out[1], slot_k1) and torch.equal(out[1], slot_256), case
    assert tests["v0"].shape == (4,) and int(tests["v0"].min()) > 0
    assert torch.equal(tests["v2"], tests["v0"]) and torch.equal(tests["v3"], tests["v0"])
    assert bool((tests["v1"] > tests["v0"]).all())
    for g in (32, 64, 128):
        assert bool((tests[f"v4g{g}"] <= tests["v0"]).all())
    assert bool((tests["v4g32"] < tests["v0"]).any())


@pytest.mark.parametrize("ray_tile", [256, 512, 1024, 2048])
def test_queue_kernels_match_plain(cuda_device, ray_tile):
    """P2b-d: ``queue_walk_kernel`` with the tile's centroid (v6), no anchor
    (v7) and per-chunk anchors (v8), at batches 4, 8 and 16, equals its plain
    version on whole tiles with a partial last one (at tile 2,048: 1,024
    threads with two rays each)."""
    scene, accel, bvh = _cornell_tree(cuda_device, 32)
    rows = kernel_variants.unanchored_rows(accel, bvh)
    o, d = _rays(3 * ray_tile + 100, 23, cuda_device)
    kv = kernel_variants
    wrappers = {"v6": kv.closest_v6, "v7": kv.closest_v7, "v8": kv.closest_v8}
    for variant, fn in wrappers.items():
        for batch in (4, 8, 16):
            case = kv.Case(variant, ray_tile, batch=batch)
            launches = fn.launches
            args = (bvh, o, d) if variant == "v8" else (bvh, rows, o, d)
            out = fn(*args, ray_tile, batch)
            torch.cuda.synchronize()
            assert fn.launches == launches + 1
            tests = _assert_equal_to_plain(case, out, kv.case_plain(case, bvh, rows, o, d))
            assert tests.shape == (4,) and int(tests.min()) > 0


@pytest.mark.parametrize("ray_tile", [256, 512, 1024, 2048])
def test_queue_v8_equals_k1(cuda_device, ray_tile):
    """P2d: v8 (per-chunk anchors) computes K1's function, and its t and
    slots equal K1's bit for bit at every batch, on whole tiles with a
    partial last one, as v0's do in ``test_walk_variant_kernels_match_plain``."""
    _, _, bvh = _cornell_tree(cuda_device, 32)
    o, d = _rays(3 * ray_tile + 100, 27, cuda_device)
    t_k1, slot_k1, _ = wide_bvh.intersect_closest_wide(bvh, o, d)
    for batch in range(1, kernel_variants.MAX_BATCH + 1):
        t, slot, _ = kernel_variants.closest_v8(bvh, o, d, ray_tile, batch)
        torch.cuda.synchronize()
        assert torch.equal(t, t_k1) and torch.equal(slot, slot_k1), batch
    assert int((t_k1 < MISS_T).sum()) > 0


def test_variant_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    scene, accel, bvh = _cornell_tree(cuda_device, 32)
    o, d = _rays(300, 25, cuda_device)
    rows = kernel_variants.unanchored_rows(accel, bvh)
    with pytest.raises(ValueError, match="leaf rows"):
        kernel_variants.closest_v7(bvh, rows.cpu(), o, d)
    with pytest.raises(ValueError, match="ray_tile"):
        kernel_variants.variant_walk(bvh, o, d, "v0", 2048)
    with pytest.raises(ValueError, match="batch"):
        kernel_variants.closest_v8(bvh, o, d, 512, 32)


@pytest.mark.parametrize("fmt", ["ply", "obj"])
def test_loaded_model_renders_as_on_cpu(cuda_device, fmt, tmp_path):
    """A model file written by ``scene.export`` and loaded back (``high_poly``
    at 20,000 triangles as a PLY, the Cornell box as OBJ+MTL), lit by its
    built-in's lights, 48x48, 4 passes, depth 4, on the card and on the CPU:
    within F6's 5.6e-5 of each other, relative above a radiance of 1 (the
    two devices round float32 transcendentals apart, so the difference
    grows with the radiance: 1.28e-4 at most on the OBJ's pixels, which
    reach several units)."""
    from heatray_tpu_torch import high_poly, load_model_scene, resolve
    from heatray_tpu_torch.scene import export

    source = high_poly(triangles=20_000) if fmt == "ply" else cornell_box(light="both")
    path = str(tmp_path / f"m.{fmt}")
    (export.write_ply if fmt == "ply" else export.write_obj)(path, source)
    scene = dataclasses.replace(load_model_scene(path), lights=source.lights)
    size = GOLDEN_SIZE
    opts = RenderOptions(width=size, height=size, max_render_passes=4, max_ray_depth=4)
    camera = orbit_camera(size, size, distance=6.2 if fmt == "obj" else 4.0, theta=0.2,
                          focal_length_mm=35.0)
    imgs = [resolve(render(scene, camera, opts, num_passes=4, device=d)[0]).cpu()
            for d in (cuda_device, "cpu")]
    assert float(imgs[1].max()) > 0.0
    torch.testing.assert_close(imgs[0], imgs[1], rtol=5.6e-5, atol=5.6e-5)


def test_png_round_trip_without_pil(cuda_device, tmp_path, monkeypatch):
    """A card render's display image through ``save_ldr`` and ``load_image``
    with PIL blocked, as where it is not installed."""
    import sys

    from heatray_tpu_torch import apply_post_pipeline
    from heatray_tpu_torch.io_utils.image import load_image, save_ldr

    for name in ("PIL", "PIL.Image"):  # None in sys.modules: importing it fails
        monkeypatch.setitem(sys.modules, name, None)
    size = 32
    opts = RenderOptions(width=size, height=size, max_render_passes=1, max_ray_depth=2)
    accum, _ = render(cornell_box(light="both"), orbit_camera(size, size, distance=6.2), opts,
                      device=cuda_device)
    shown = apply_post_pipeline(accum).cpu().numpy()
    path = str(tmp_path / "x.png")
    save_ldr(path, shown)
    back = load_image(path, to_linear=False)
    np.testing.assert_array_equal(np.round(back * 255).astype(np.uint8),
                                  (np.clip(shown, 0, 1) * 255 + 0.5).astype(np.uint8))
