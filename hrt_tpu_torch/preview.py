"""Live preview (hrt_tpu/preview.py): frame streaming and an interactive
camera over a small standard-library HTTP server.

- ``GET /``          a single-page viewer (``<img>`` + key capture JS);
- ``GET /frame.png`` the latest tonemapped frame (re-polled by the
                     page: the newest frame wins, stale ones are never
                     fetched);
- ``GET /stream``    a multipart/x-mixed-replace push stream of the same
                     frames (one long-lived response);
- ``POST /keys``     the set of currently held keys; the render loop
                     integrates them at the reference's rates (look
                     1.5 rad/s, move 3 units/s);
- ``POST /resize``   a new render size, taken before the next frame.

``CameraController`` is the pure-math part; ``PreviewServer`` and
``run_preview`` drive a FrameLoop against it.  Frames are encoded by
utils/image.encode_png at zlib level 1.
"""
from __future__ import annotations

import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .graphs import capture_line
from .utils.image import encode_png, tonemap

# Key names as sent by the browser (event.key, lowercased) mapped to
# the reference's bindings (Camera.h:22-34): WASD planar move, E/Q
# up/down (y-down world: up is -y), arrows look.
MOVE_KEYS = ("w", "a", "s", "d", "e", "q")
LOOK_KEYS = ("arrowleft", "arrowright", "arrowup", "arrowdown")

LOOK_SPEED = 1.5   # rad/s   (ref: Camera.cpp:38)
MOVE_SPEED = 3.0   # units/s (ref: Camera.cpp:59)
PITCH_CLAMP = 1.5  # rad     (ref: Camera.cpp:41)


class CameraController:
    """Integrates held keys into camera position/rotation with the
    reference's handleInputs semantics (Camera.cpp:26-61): yaw-planar
    forward/right vectors, world up (0, -1, 0) [y-down], normalized
    move direction, pitch clamp, yaw wrap."""

    def __init__(self, position=(0.0, 0.0, -2.0),
                 rotation=(0.0, 0.0, 0.0)):
        self.position = list(position)
        self.rotation = list(rotation)

    def step(self, keys, dt: float) -> None:
        keys = {k.lower() for k in keys}
        rx = (1.0 if "arrowup" in keys else 0.0) - (
            1.0 if "arrowdown" in keys else 0.0)
        ry = (1.0 if "arrowright" in keys else 0.0) - (
            1.0 if "arrowleft" in keys else 0.0)
        norm = math.sqrt(rx * rx + ry * ry)
        if norm > 0.0:
            self.rotation[0] += LOOK_SPEED * dt * rx / norm
            self.rotation[1] += LOOK_SPEED * dt * ry / norm
        self.rotation[0] = max(-PITCH_CLAMP,
                               min(PITCH_CLAMP, self.rotation[0]))
        self.rotation[1] = self.rotation[1] % (2.0 * math.pi)

        yaw = self.rotation[1]
        fwd = (math.sin(yaw), 0.0, math.cos(yaw))
        right = (fwd[2], 0.0, -fwd[0])
        up = (0.0, -1.0, 0.0)
        mv = [0.0, 0.0, 0.0]

        def add(v, s):
            mv[0] += s * v[0]
            mv[1] += s * v[1]
            mv[2] += s * v[2]

        if "w" in keys:
            add(fwd, 1.0)
        if "s" in keys:
            add(fwd, -1.0)
        if "d" in keys:
            add(right, 1.0)
        if "a" in keys:
            add(right, -1.0)
        if "e" in keys:
            add(up, 1.0)
        if "q" in keys:
            add(up, -1.0)
        norm = math.sqrt(mv[0] ** 2 + mv[1] ** 2 + mv[2] ** 2)
        if norm > 0.0:
            for i in range(3):
                self.position[i] += MOVE_SPEED * dt * mv[i] / norm

    def camera(self):
        from .models.camera import Camera

        return Camera(position=tuple(self.position),
                      rotation=tuple(self.rotation))


_PAGE = """<!doctype html>
<html><head><title>hrt_tpu_torch preview</title><style>
 body { background:#111; color:#ccc; font:13px monospace; margin:0 }
 #bar { padding:6px 10px } img { display:block; margin:0 auto;
 image-rendering:pixelated; max-width:100vw }
</style></head><body>
<div id="bar">hrt_tpu_torch live preview &mdash; WASD move, E/Q up/down,
arrows look &mdash; <span id="fps">-</span> &mdash; size
<select id="res" onchange="fetch('/resize', {method:'POST',
  body: JSON.stringify({size: this.value})})">
<option>keep</option><option>256x192</option><option>512x384</option>
<option>800x600</option><option>1280x720</option>
<option>1920x1080</option></select></div>
<img id="view" src="/frame.png">
<script>
const held = new Set();
const send = () => fetch('/keys', {method:'POST',
  body: JSON.stringify({keys: Array.from(held)})});
addEventListener('keydown', e => { held.add(e.key.toLowerCase());
  send(); e.preventDefault(); });
addEventListener('keyup', e => { held.delete(e.key.toLowerCase());
  send(); });
addEventListener('blur', () => { held.clear(); send(); });
const img = document.getElementById('view');
let n = 0, t0 = performance.now();
function poll() {
  const next = new Image();
  next.onload = () => { img.src = next.src; n++;
    const dt = performance.now() - t0;
    if (dt > 1000) { document.getElementById('fps').textContent =
      (1000*n/dt).toFixed(1) + ' fps'; n = 0; t0 = performance.now(); }
    setTimeout(poll, 10); };
  next.onerror = () => setTimeout(poll, 250);
  next.src = '/frame.png?t=' + Date.now();
}
poll();
</script></body></html>
"""


class PreviewServer:
    """Threaded HTTP server holding the latest encoded frame and the
    currently-held key set.  The render loop calls ``publish`` with
    each finished frame and reads ``held_keys`` each iteration."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8000):
        self._frame_png = b""
        self._frame_event = threading.Event()
        self._lock = threading.Lock()
        self._keys: set = set()
        self._resize = None
        self.frames_served = 0
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/":
                    body = _PAGE.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif path == "/frame.png":
                    with outer._lock:
                        body = outer._frame_png
                    if not body:
                        self.send_response(503)
                        self.end_headers()
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", "image/png")
                    self.send_header("Content-Length", str(len(body)))
                    self.send_header("Cache-Control", "no-store")
                    self.end_headers()
                    self.wfile.write(body)
                    outer.frames_served += 1
                elif path == "/stream":
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary=frame")
                    self.end_headers()
                    try:
                        while True:
                            outer._frame_event.wait(timeout=10.0)
                            outer._frame_event.clear()
                            with outer._lock:
                                body = outer._frame_png
                            if not body:
                                continue
                            self.wfile.write(
                                b"--frame\r\nContent-Type: image/png"
                                b"\r\nContent-Length: "
                                + str(len(body)).encode()
                                + b"\r\n\r\n" + body + b"\r\n")
                    except (BrokenPipeError, ConnectionResetError):
                        return
                else:
                    self.send_response(404)
                    self.end_headers()

            def do_POST(self):
                path = self.path.split("?")[0]
                n = int(self.headers.get("Content-Length", 0))
                try:
                    data = json.loads(self.rfile.read(n) or b"{}")
                except (ValueError, TypeError):
                    data = {}
                if path == "/keys":
                    keys = {str(k).lower()
                            for k in data.get("keys", [])
                            } if isinstance(data, dict) else set()
                    with outer._lock:
                        outer._keys = keys
                elif path == "/resize":
                    # "WxH" (or {"width","height"}): picked up by the
                    # render loop before its next frame — the live-
                    # resize path (ref: RTApp.cpp:214-232).
                    try:
                        if "size" in data and "x" in str(data["size"]):
                            w_, h_ = map(int, data["size"].split("x"))
                        else:
                            w_, h_ = int(data["width"]), int(data["height"])
                        if not (16 <= w_ <= 7680 and 16 <= h_ <= 4320):
                            raise ValueError(data)
                        with outer._lock:
                            outer._resize = (w_, h_)
                    except (ValueError, TypeError, KeyError):
                        pass
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(204)
                self.end_headers()

        self._srv = ThreadingHTTPServer((host, port), Handler)
        self._srv.daemon_threads = True
        self.port = self._srv.server_address[1]
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()

    def publish(self, rgb8: np.ndarray) -> None:
        body = encode_png(rgb8, level=1)
        with self._lock:
            self._frame_png = body
        self._frame_event.set()

    @property
    def held_keys(self) -> set:
        with self._lock:
            return set(self._keys)

    def take_resize(self):
        """Pop the pending resize request, if any: (width, height)."""
        with self._lock:
            req, self._resize = self._resize, None
        return req

    def close(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()


def run_preview(loop, camera, port: int = 8000, gamma: float = 2.2,
                max_frames: int | None = None,
                progressive: bool = True) -> None:
    """Drive a FrameLoop interactively: render, publish, integrate
    input.  Camera motion resets temporal history (accumulation starts
    over, as the reference's moving camera naturally does at 1 spp).

    progressive: keep accumulating (loop.config.accumulate) while the
    camera is still, so the preview refines over time."""
    srv = PreviewServer(host="0.0.0.0", port=port)
    print(f"preview: http://localhost:{srv.port}/  (WASD/EQ move, "
          f"arrows look, Ctrl-C to stop)")
    ctl = CameraController(tuple(camera.position),
                           tuple(camera.rotation))
    last = time.perf_counter()
    n = 0
    try:
        while max_frames is None or n < max_frames:
            req = srv.take_resize()
            if req is not None:
                print(f"preview: resize -> {req[0]}x{req[1]}")
                loop.set_resolution(*req)
            img = loop.step(ctl.camera())
            if n == 0 and (line := capture_line("preview", loop.program)):
                print(f"preview: {line}", flush=True)
            srv.publish(tonemap(img.cpu().numpy(), gamma=gamma))
            now = time.perf_counter()
            dt = min(now - last, 0.1)  # clamp stalls (kernel builds)
            last = now
            keys = srv.held_keys
            before = (tuple(ctl.position), tuple(ctl.rotation))
            ctl.step(keys, dt)
            if progressive and (tuple(ctl.position),
                                tuple(ctl.rotation)) != before:
                loop.reset_history()
            n += 1
    except KeyboardInterrupt:
        pass
    finally:
        srv.close()
