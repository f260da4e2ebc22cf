"""Progressive viewer: a live HTTP preview of a converging render (port of
``heatray_tpu.viewer``).

The reference shows the accumulation converging in a window
(``HeatrayRenderer::render`` copies the raytraced pixels into a GL texture
every frame, ``HeatrayRenderer.cpp:319-403``).  Headless, the equivalent is
a small in-process HTTP server: it serves a self-refreshing page with the
latest display image and the pass count, and takes edits.  It uses the
standard library and numpy only; PNGs are written by ``io_utils.png``.  The
render loop stays in charge: ``ProgressiveViewer.update`` is called from
the per-pass callback (the ``m_passCompleteCallback`` analog).

Endpoints: ``/`` (the page), ``/frame.png``, ``/status.json``,
``/scene.json``, ``POST /edit`` (a JSON edit message, queued for
``interactive.InteractiveRenderer``) and ``POST /upload`` (a dropped model
or environment file, saved and queued as a ``load`` edit).

Usage:
    viewer = ProgressiveViewer(port=8000).start()
    render(..., pass_callback=viewer.make_callback(options, post))
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .io_utils.png import encode_png

_PAGE = """<!doctype html>
<html><head><title>heatray_tpu_torch — progressive render</title><style>
body { background: #181818; color: #ddd; font-family: monospace;
       display: flex; flex-direction: column; align-items: center; }
img { image-rendering: pixelated; max-width: 95vw; max-height: 75vh;
      border: 1px solid #444; margin-top: 8px; }
#status { margin-top: 6px; }
#editor { margin-top: 8px; width: 90vw; max-width: 720px; }
textarea { width: 100%; height: 72px; background: #222; color: #ddd;
           border: 1px solid #444; font-family: monospace; }
button, input[type=range] { margin: 4px; }
#msg { color: #8c8; }
details { margin-top: 4px; }
</style></head><body>
<div id="status">waiting for first pass…</div>
<img id="frame" src="/frame.png" draggable="false"
 title="drag: orbit — wheel: zoom — drop a model/.hdr/.exr file to load">
<div id="editor">
 <details><summary>edit (material / light / camera / post — JSON)</summary>
  <textarea id="edit"
   placeholder='{"type": "material", "index": 0, "base_color": [1, 0.2, 0.2]}'
  ></textarea>
  <button onclick="sendEdit()">apply</button>
  <span id="msg"></span>
  <div>
   exposure <input type="range" id="ev" min="-4" max="4" step="0.25" value="0"
    onchange="quick({type: 'post', exposure: parseFloat(this.value)})">
   env EV <input type="range" id="env" min="-4" max="4" step="0.25" value="0"
    onchange="quick({type: 'env', exposure: parseFloat(this.value)})">
  </div>
  <div>
   depth <input type="number" id="depth" min="1" max="30" value="10"
    style="width:3.5em"
    onchange="quick({type: 'options', max_ray_depth: parseInt(this.value)})">
   passes <input type="number" id="passes" min="1" max="8192" value="32"
    style="width:4.5em"
    onchange="quick({type: 'options',
                     max_render_passes: parseInt(this.value)})">
   sampling <select id="smode"
    onchange="quick({type: 'options', sample_mode: this.value})">
    <option>sobol</option><option>halton</option><option>hammersley</option>
    <option>blue_noise</option><option>random</option>
   </select>
   bokeh <select id="bokeh"
    onchange="quick({type: 'options', bokeh_shape: this.value})">
    <option>circular</option><option>pentagon</option>
    <option>hexagon</option><option>octagon</option>
   </select>
  </div>
  <div>
   AOV <select id="aov"
    onchange="quick({type: 'options', aov: this.value})">
    <option>none</option><option>geometric_normals</option>
    <option>final_normals</option><option>uvs</option><option>tangents</option>
    <option>bitangents</option><option>normalmap</option>
    <option>base_color</option><option>emissive</option>
    <option>roughness</option><option>metallic</option>
    <option>clearcoat</option><option>clearcoat_roughness</option>
    <option>clearcoat_normalmap</option><option>shader</option>
    <option>nans</option><option>infs</option>
   </select>
   clamp <input type="number" id="clamp" min="0.1" step="0.5" value="3.14"
    style="width:4em"
    onchange="quick({type: 'options',
                     max_channel_value: parseFloat(this.value)})">
   <label><input type="checkbox" id="iblock"
    onchange="quick({type: 'options', interactive_block: this.checked})">
    3x3 interactive</label>
  </div>
 </details>
</div>
<script>
async function postEdit(obj) {
  const r = await fetch('/edit', {method: 'POST',
    headers: {'Content-Type': 'application/json'},
    body: JSON.stringify(obj)});
  document.getElementById('msg').textContent =
    r.ok ? 'queued' : 'error ' + r.status;
}
function sendEdit() {
  try { postEdit(JSON.parse(document.getElementById('edit').value)); }
  catch (e) { document.getElementById('msg').textContent = '' + e; }
}
function quick(obj) { postEdit(obj); }

// -- mouse orbit / zoom (main.cpp:51-77) --------------------------------
const frame = document.getElementById('frame');
let orbit = null;            // {distance, phi, theta, ...} from /scene.json
let dragging = false, lastX = 0, lastY = 0, sendTimer = null;
async function loadOrbit() {
  try {
    const s = await (await fetch('/scene.json')).json();
    if (s.camera) orbit = s.camera;
  } catch (e) {}
}
loadOrbit();
function sendCamera() {
  if (!orbit || sendTimer) return;
  sendTimer = setTimeout(() => {         // throttle to ~12 edits/s
    sendTimer = null;
    postEdit({type: 'camera', phi: orbit.phi, theta: orbit.theta,
              distance: orbit.distance});
  }, 80);
}
frame.addEventListener('pointerdown', e => {
  dragging = true; lastX = e.clientX; lastY = e.clientY;
  frame.setPointerCapture(e.pointerId);
  if (!orbit) loadOrbit();
  e.preventDefault();
});
frame.addEventListener('pointermove', e => {
  if (!dragging || !orbit) return;
  const dx = e.clientX - lastX, dy = e.clientY - lastY;
  lastX = e.clientX; lastY = e.clientY;
  orbit.phi -= dx * 0.01;                // radians per pixel
  orbit.theta = Math.max(-1.55, Math.min(1.55, orbit.theta + dy * 0.01));
  sendCamera();
});
frame.addEventListener('pointerup', e => { dragging = false; });
frame.addEventListener('wheel', e => {
  if (!orbit) { loadOrbit(); return; }
  orbit.distance *= Math.exp(e.deltaY * 0.001);  // scroll zoom
  sendCamera();
  e.preventDefault();
}, {passive: false});

// -- drag-drop scene / environment loading (main.cpp:58) ----------------
document.body.addEventListener('dragover', e => e.preventDefault());
document.body.addEventListener('drop', async e => {
  e.preventDefault();
  const f = e.dataTransfer.files[0];
  if (!f) return;
  document.getElementById('msg').textContent = 'uploading ' + f.name + '…';
  const r = await fetch('/upload', {method: 'POST',
    headers: {'X-Filename': f.name}, body: f});
  document.getElementById('msg').textContent =
    r.ok ? 'loading ' + f.name : 'upload error ' + r.status;
});

async function tick() {
  try {
    const s = await (await fetch('/status.json')).json();
    document.getElementById('status').textContent =
      `pass ${s.passes_done}/${s.total_passes}  ` +
      `${s.width}x${s.height}  ${s.pass_ms.toFixed(0)} ms/pass`;
    const img = document.getElementById('frame');
    img.src = '/frame.png?t=' + s.version;
  } catch (e) {}
  setTimeout(tick, 500);
}
tick();
</script></body></html>"""


class ProgressiveViewer:
    """Serves the latest frame and status; updated from the render loop."""

    def __init__(self, port: int = 8000, host: str = "0.0.0.0"):
        self.port = port
        self.host = host
        self._lock = threading.Lock()
        self._png: bytes = encode_png(np.zeros((2, 2, 3), np.uint8))
        self._status = {
            "passes_done": 0, "total_passes": 0, "width": 0, "height": 0,
            "pass_ms": 0.0, "version": 0,
        }
        self._last_t = time.time()
        self._server: ThreadingHTTPServer | None = None
        self._edits: list = []  # queued JSON edit messages (POST /edit)
        self._scene_info: dict = {}

    def poll_edits(self) -> list:
        """Drain the queued edit messages (called between passes by the
        edit loop, the ``renderUI -> runOpenRLTask`` analog)."""
        with self._lock:
            edits, self._edits = self._edits, []
        return edits

    def set_scene_info(self, info: dict):
        """Publish the editable surface served at /scene.json."""
        with self._lock:
            self._scene_info = info

    def update(self, rgb8: np.ndarray, passes_done: int, total_passes: int):
        """Publish an (H, W, 3) uint8 frame, top row first."""
        now = time.time()
        png = encode_png(np.ascontiguousarray(rgb8))
        with self._lock:
            self._png = png
            self._status = {
                "passes_done": int(passes_done),
                "total_passes": int(total_passes),
                "width": int(rgb8.shape[1]),
                "height": int(rgb8.shape[0]),
                "pass_ms": (now - self._last_t) * 1000.0,
                "version": self._status["version"] + 1,
            }
        self._last_t = now

    def make_callback(self, options, post_params=None, every: int = 1):
        """A ``render(..., pass_callback=...)`` hook that publishes the
        display image every ``every`` passes and after the last: the ACES
        chain of ``post_params``, or else the clamped, gamma-2.2 resolve.
        The image is made on the accumulation's device and copied to the
        host once per publish."""
        import torch

        from .interactive import display_rgb8
        from .post import apply_post_pipeline
        from .render.integrator import resolve

        total = options.max_render_passes

        def cb(i, accum):
            if (i + 1) % every and (i + 1) != total:
                return
            with torch.no_grad():
                if post_params is not None:
                    img = apply_post_pipeline(accum, post_params)
                else:
                    img = torch.clamp(resolve(accum), 0.0, 1.0) ** (1 / 2.2)
                self.update(display_rgb8(img), i + 1, total)

        return cb

    def start(self):
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _reply(self, body: bytes, ctype: str):
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path.startswith("/frame.png"):
                    with viewer._lock:
                        body = viewer._png
                    ctype = "image/png"
                elif self.path.startswith("/status.json"):
                    with viewer._lock:
                        body = json.dumps(viewer._status).encode()
                    ctype = "application/json"
                elif self.path.startswith("/scene.json"):
                    with viewer._lock:
                        body = json.dumps(viewer._scene_info).encode()
                    ctype = "application/json"
                else:
                    body = _PAGE.encode()
                    ctype = "text/html"
                self._reply(body, ctype)

            def do_POST(self):
                if self.path.startswith("/upload"):
                    # A dropped scene or environment file: save it and queue
                    # a "load" edit (the ``glfwPathDropCallback`` analog).
                    try:
                        n = int(self.headers.get("Content-Length", 0))
                        name = os.path.basename(self.headers.get("X-Filename", "dropped.bin"))
                        name = re.sub(r"[^A-Za-z0-9._-]", "_", name) or "f"
                        dest = os.path.join(tempfile.mkdtemp(prefix="heatray_upload_"), name)
                        with open(dest, "wb") as f:
                            remaining = n
                            while remaining > 0:
                                buf = self.rfile.read(min(remaining, 1 << 20))
                                if not buf:
                                    break
                                f.write(buf)
                                remaining -= len(buf)
                    except Exception:
                        self.send_response(400)
                        self.end_headers()
                        return
                    edit = {"type": "load", "path": dest}
                elif self.path.startswith("/edit"):
                    try:
                        n = int(self.headers.get("Content-Length", 0))
                        edit = json.loads(self.rfile.read(n) or b"{}")
                        assert isinstance(edit, dict)
                    except Exception:
                        self.send_response(400)
                        self.end_headers()
                        return
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                with viewer._lock:
                    viewer._edits.append(edit)
                self._reply(b'{"queued": true}', "application/json")

        self._server = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._server.server_address[1]  # resolve port 0
        threading.Thread(target=self._server.serve_forever, daemon=True).start()
        return self

    def stop(self):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
