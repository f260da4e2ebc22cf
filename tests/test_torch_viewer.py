"""The port's progressive viewer over HTTP on port 0 (its endpoints, the
edit queue, uploads that load a scene), the edit loop driven through it,
and ``render --preview`` from the command line, on the CPU.  PNGs are
decoded by the port's own ``io_utils.png``.  Against the JAX package: the
page, the status keys and the edit queue's messages."""

import json
import os
import urllib.request

import numpy as np
import pytest
import torch

from heatray_tpu.viewer import ProgressiveViewer as JaxProgressiveViewer
from heatray_tpu_torch import RenderOptions, cornell_box, orbit_camera, render
from heatray_tpu_torch.cli import main
from heatray_tpu_torch.interactive import InteractiveRenderer
from heatray_tpu_torch.io_utils.png import decode_png
from heatray_tpu_torch.render.integrator import resolve
from heatray_tpu_torch.utils.threads import share_cores
from heatray_tpu_torch.viewer import ProgressiveViewer

share_cores(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))

SIZE = 16


def _get(viewer, path):
    return urllib.request.urlopen(f"http://127.0.0.1:{viewer.port}{path}", timeout=10).read()


def _post(viewer, path, data, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{viewer.port}{path}", data=data,
                                 headers=headers or {}, method="POST")
    return json.loads(urllib.request.urlopen(req, timeout=10).read())


@pytest.fixture
def viewer():
    v = ProgressiveViewer(port=0, host="127.0.0.1").start()
    yield v
    v.stop()


@pytest.fixture
def jax_viewer():
    v = JaxProgressiveViewer(port=0, host="127.0.0.1").start()
    yield v
    v.stop()


def _renderer(viewer=None, **kw):
    opts = RenderOptions(width=SIZE, height=SIZE, max_render_passes=4, max_ray_depth=2, **kw)
    return InteractiveRenderer(cornell_box(light="point", with_spheres=False),
                               orbit_camera(SIZE, SIZE, distance=6.2, focal_length_mm=35.0),
                               opts, viewer=viewer, orbit=dict(distance=6.2, focal_length=35.0),
                               device="cpu")


def test_endpoints_match_jax(viewer, jax_viewer):
    """The same frame through both viewers: the status, the page and the
    decoded PNG (the port writes its PNGs with ``io_utils.png``)."""
    img = np.random.default_rng(0).integers(0, 256, (13, 7, 3), dtype=np.uint8)
    for v in (viewer, jax_viewer):
        v.update(img, passes_done=3, total_passes=8)
    status, ref = (json.loads(_get(v, "/status.json")) for v in (viewer, jax_viewer))
    assert status.keys() == ref.keys()
    for k in ("passes_done", "total_passes", "width", "height", "version"):
        assert status[k] == ref[k], k
    assert (status["width"], status["height"], status["passes_done"]) == (7, 13, 3)
    np.testing.assert_array_equal(decode_png(_get(viewer, "/frame.png")), img)
    np.testing.assert_array_equal(decode_png(_get(jax_viewer, "/frame.png")), img)
    page = _get(viewer, "/")
    assert b"heatray_tpu_torch" in page
    assert page.replace(b"heatray_tpu_torch", b"heatray_tpu") == _get(jax_viewer, "/")


def test_edit_queue_and_scene_info(viewer):
    assert _post(viewer, "/edit", json.dumps({"type": "post", "exposure": 0.5}).encode(),
                 {"Content-Type": "application/json"}) == {"queued": True}
    viewer.set_scene_info({"materials": []})
    assert json.loads(_get(viewer, "/scene.json")) == {"materials": []}
    assert viewer.poll_edits() == [{"type": "post", "exposure": 0.5}]
    assert viewer.poll_edits() == []  # drained
    with pytest.raises(urllib.error.HTTPError, match="400"):
        _post(viewer, "/edit", b"[1, 2]")
    with pytest.raises(urllib.error.HTTPError, match="404"):
        _post(viewer, "/elsewhere", b"{}")


def test_upload_loads_the_scene(viewer):
    """A dropped OBJ is saved under a sanitised name and queued as a
    ``load`` edit; the edit loop then renders the new scene, framed on
    it."""
    resp = _post(viewer, "/upload", b"v 10 0 0\nv 11 0 0\nv 10 1 0\nf 1 2 3\n",
                 {"X-Filename": "drop me.obj"})
    assert resp == {"queued": True}
    r = _renderer(viewer)
    env_before = r.scene.lights.env_enabled
    assert r.poll_and_apply() == 1
    assert r.scene.geometry.num_triangles == 1
    assert r.orbit["target"][0] > 9.0 and r.orbit["distance"] > 0.0
    assert r.scene.lights.env_enabled == env_before
    assert r.ctx.accel_pack.wide.num_triangles == 1
    r.step()
    assert torch.isfinite(r.accum).all() and r.pass_index == 1


def test_edit_loop_through_the_viewer(viewer):
    """Edits posted over HTTP reach the loop between passes: a transport
    edit resets, a bad one is logged and skipped, and ``run`` publishes
    frames that decode to the loop's display image."""
    r = _renderer(viewer)
    r.step()
    _post(viewer, "/edit", json.dumps({"type": "material", "index": 0, "metallic": 1.0}).encode())
    _post(viewer, "/edit", json.dumps({"type": "point_light", "index": 0,
                                       "luminous_intensity": "bright"}).encode())
    assert r.poll_and_apply() == 2
    assert r.pass_index == 0 and float(r.scene.materials.metallic[0]) == 1.0
    r.run(max_passes=2)
    status = json.loads(_get(viewer, "/status.json"))
    assert (status["passes_done"], status["total_passes"]) == (2, 4)
    np.testing.assert_array_equal(decode_png(_get(viewer, "/frame.png")), r.frame_rgb8())
    # A display edit does not reset.
    _post(viewer, "/edit", json.dumps({"type": "post", "exposure": 2.0}).encode())
    assert r.poll_and_apply() == 1
    assert r.pass_index == 2 and r.post.exposure == 2.0
    r.publish()
    assert json.loads(_get(viewer, "/status.json"))["version"] == status["version"] + 1
    np.testing.assert_array_equal(decode_png(_get(viewer, "/frame.png")), r.frame_rgb8())


def test_make_callback_publishes_the_resolve(viewer):
    """Without post parameters: the clamped, gamma-2.2 resolve, every 2
    passes and after the last."""
    opts = RenderOptions(width=SIZE, height=SIZE, max_render_passes=3, max_ray_depth=1)
    seen = []
    update = viewer.update
    viewer.update = lambda rgb8, done, total: (seen.append(done), update(rgb8, done, total))
    accum, _ = render(cornell_box(), orbit_camera(SIZE, SIZE, distance=6.2), opts,
                      pass_callback=viewer.make_callback(opts, every=2), device="cpu")
    assert seen == [2, 3]
    expect = ((torch.clamp(resolve(accum), 0.0, 1.0) ** (1 / 2.2)).flip(0) * 255.0 + 0.5)
    np.testing.assert_array_equal(decode_png(_get(viewer, "/frame.png")),
                                  expect.to(torch.uint8).numpy())


def test_cli_preview_publishes_each_pass(tmp_path, monkeypatch):
    """``render --preview 0`` renders, publishes every pass and writes its
    file; the server stops when the command returns."""
    seen, servers = [], []
    start, update = ProgressiveViewer.start, ProgressiveViewer.update

    def counted_start(self):
        servers.append(self)
        return start(self)

    monkeypatch.setattr(ProgressiveViewer, "start", counted_start)
    monkeypatch.setattr(ProgressiveViewer, "update",
                        lambda self, rgb8, done, total: (seen.append((done, total)),
                                                         update(self, rgb8, done, total)))
    out = tmp_path / "x.png"
    assert main(["render", "--scene", "cornell-box", "--size", "12", "9", "--passes", "2",
                 "--depth", "2", "--cpu", "--preview", "0", "--out", str(out)]) == 0
    assert out.exists() and seen == [(1, 2), (2, 2)]
    assert len(servers) == 1 and servers[0]._server is None
