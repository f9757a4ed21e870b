"""hrt_tpu_torch.preview: the camera controller against the JAX
package's on random key sets, the HTTP server's round trip, and
run_preview over a CPU FrameLoop (directly and through the CLI)."""
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
from PIL import Image

from hrt_tpu import preview as jpreview
from hrt_tpu_torch import cli, preview
from hrt_tpu_torch.config import RenderConfig
from hrt_tpu_torch.frameloop import FrameLoop
from hrt_tpu_torch.models.camera import Camera
from hrt_tpu_torch.models.scene import reference_demo_scene
from hrt_tpu_torch.utils.image import tonemap

KEYS = preview.MOVE_KEYS + preview.LOOK_KEYS + ("x", "ArrowUp", "W")
SMALL = dict(width=32, height=24, max_depth=1, sky=True)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_controller_matches_jax(seed):
    """60 steps of random held-key sets and frame times: the same
    position and rotation, float for float."""
    rs = np.random.RandomState(seed)
    pos, rot = tuple(rs.uniform(-3, 3, 3)), tuple(rs.uniform(-1, 1, 3))
    port = preview.CameraController(pos, rot)
    ref = jpreview.CameraController(pos, rot)
    for _ in range(60):
        keys = {k for k in KEYS if rs.rand() < 0.3}
        dt = float(rs.uniform(0.0, 0.1))
        port.step(keys, dt)
        ref.step(keys, dt)
        assert port.position == ref.position
        assert port.rotation == ref.rotation
    cam = port.camera()
    assert cam.position == tuple(ref.position)
    assert cam.rotation == tuple(ref.rotation)
    assert (preview.LOOK_SPEED, preview.MOVE_SPEED, preview.PITCH_CLAMP) \
        == (jpreview.LOOK_SPEED, jpreview.MOVE_SPEED, jpreview.PITCH_CLAMP)


def test_server_roundtrip():
    srv = preview.PreviewServer(port=0)
    try:
        url = f"http://127.0.0.1:{srv.port}"
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"{url}/frame.png", timeout=5)
        assert err.value.code == 503
        frame = np.random.RandomState(3).randint(
            0, 256, (8, 9, 3)).astype(np.uint8)
        srv.publish(frame)
        data = urllib.request.urlopen(f"{url}/frame.png", timeout=5).read()
        assert data[:8] == b"\x89PNG\r\n\x1a\n"
        np.testing.assert_array_equal(np.asarray(Image.open(
            io.BytesIO(data))), frame)
        req = urllib.request.Request(
            f"{url}/keys", data=json.dumps({"keys": ["W", "ArrowUp"]})
            .encode(), method="POST")
        assert urllib.request.urlopen(req, timeout=5).status == 204
        assert srv.held_keys == {"w", "arrowup"}
        for body, want in (({"size": "512x384"}, (512, 384)),
                           ({"width": 64, "height": 48}, (64, 48)),
                           ({"size": "keep"}, None), ({"size": "0x0"}, None)):
            req = urllib.request.Request(
                f"{url}/resize", data=json.dumps(body).encode(),
                method="POST")
            assert urllib.request.urlopen(req, timeout=5).status == 204
            assert srv.take_resize() == want
        page = urllib.request.urlopen(url + "/", timeout=5).read()
        assert b"hrt_tpu_torch" in page and b"/frame.png" in page
    finally:
        srv.close()


def _capture_server(monkeypatch, resize=None):
    """Bind run_preview's server to 127.0.0.1 on a free port (with an
    optional queued resize) and keep a handle on it."""
    captured = {}
    orig_init = preview.PreviewServer.__init__

    def patched(self, host="127.0.0.1", port=0):
        orig_init(self, "127.0.0.1", 0)
        self._resize = resize
        captured["srv"] = self

    monkeypatch.setattr(preview.PreviewServer, "__init__", patched)
    return captured


def test_run_preview_with_frameloop_cpu(monkeypatch):
    """Three frames of a CPU FrameLoop; the last PNG published is the
    tonemapped third frame of the same loop run directly."""
    captured = _capture_server(monkeypatch)
    cfg = RenderConfig(**SMALL)
    loop = FrameLoop(reference_demo_scene(), cfg, cull_threshold_px=0.0,
                     device="cpu")
    cam = Camera(position=(0.0, 0.0, -2.0))
    t = threading.Thread(target=preview.run_preview, kwargs=dict(
        loop=loop, camera=cam, max_frames=3))
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and loop.frame == 3
    ref = FrameLoop(reference_demo_scene(), cfg, cull_threshold_px=0.0,
                    device="cpu")
    for _ in range(3):
        img = ref.step(cam)
    got = np.asarray(Image.open(io.BytesIO(captured["srv"]._frame_png)))
    np.testing.assert_array_equal(got, tonemap(img.numpy()))


def test_run_preview_applies_resize(monkeypatch):
    captured = _capture_server(monkeypatch, resize=(40, 30))
    loop = FrameLoop(reference_demo_scene(), RenderConfig(**SMALL),
                     cull_threshold_px=0.0, device="cpu")
    t = threading.Thread(target=preview.run_preview, kwargs=dict(
        loop=loop, camera=Camera(), max_frames=2))
    t.start()
    t.join(timeout=120)
    assert not t.is_alive()
    assert (loop.config.width, loop.config.height) == (40, 30)
    arr = np.asarray(Image.open(io.BytesIO(captured["srv"]._frame_png)))
    assert arr.shape == (30, 40, 3)


def test_cli_preview_serves_frames(monkeypatch):
    """`--preview --frames 3 --port 0` through the CLI: each frame is
    fetched from /frame.png by urllib as it is published, and decodes to
    the frame published."""
    fetched = []
    orig = preview.PreviewServer.publish

    def publish(self, rgb8):
        orig(self, rgb8)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{self.port}/frame.png", timeout=5) as r:
            fetched.append((np.array(rgb8), r.read()))

    monkeypatch.setattr(preview.PreviewServer, "publish", publish)
    loop = cli.main(["--scene", "demo", "--width", "32", "--height", "24",
                     "--max-depth", "1", "--sky", "--preview", "--frames",
                     "3", "--port", "0", "--device", "cpu"])
    assert loop.frame == 3 and len(fetched) == 3
    for rgb8, body in fetched:
        buf = io.BytesIO(body)
        np.testing.assert_array_equal(np.asarray(Image.open(buf)), rgb8)
