"""hrt_tpu_torch.utils against the JAX package's utils on the same inputs:
the PNG writer (decoded by PIL here), `image:` textures, the image
metrics, the ray count, the frame counters and timers and the `.npz`
upscaler checkpoint."""
import os

import numpy as np
import pytest
import torch
from PIL import Image

import bench
from hrt_tpu.config import CONFIGS as JCONFIGS
from hrt_tpu.models import scenefile as jscenefile
from hrt_tpu.utils import image as jimage
from hrt_tpu.utils import profiling as jprofiling
from hrt_tpu_torch.config import CONFIGS
from hrt_tpu_torch.models import scenefile, upscaler
from hrt_tpu_torch.utils import checkpoint, image, logging as tlogging
from hrt_tpu_torch.utils import profiling, tracing
from hrt_tpu_torch.utils.interop import upscaler_from_numpy


def _img(seed, h=13, w=21):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 256, (h, w, 3)).astype(np.uint8)


def test_write_png_decoded_by_pil_equals_input(tmp_path):
    img = _img(0)
    path = os.path.join(tmp_path, "t.png")
    image.write_png(path, img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    # Float input is tonemapped first, as the JAX writer does.
    hdr = np.random.RandomState(1).uniform(0, 2, (5, 7, 3)).astype(
        np.float32)
    image.write_png(path, hdr)
    np.testing.assert_array_equal(np.asarray(Image.open(path)),
                                  jimage.tonemap(hdr))


@pytest.mark.parametrize("suffix", ["png", "jpg"])
def test_image_texture_matches_jax(tmp_path, suffix):
    """An `image:` texture of a scene file, PNG or JPEG, read through
    PIL by both packages: the packed tables are equal."""
    path = os.path.join(tmp_path, f"wood.{suffix}")
    Image.fromarray(_img(4, 32, 48)).save(path)
    spec = {"meshes": [{"name": "floor", "plane": {"size": 2.0}}],
            "textures": [{"name": "wood", "image": path}],
            "materials": [{"name": "m", "texture": "wood"}],
            "lights": [{"position": [0, -2, 0], "color": [1, 1, 1],
                        "intensity": 5.0}],
            "instances": [{"mesh": "floor", "material": "m"}]}
    port = scenefile.scene_from_dict(spec).build("cpu")
    jax_ = jscenefile.scene_from_dict(spec).build()
    np.testing.assert_array_equal(port.textures.numpy(),
                                  np.asarray(jax_.textures))


def test_tonemap_and_metrics_match_jax():
    rs = np.random.RandomState(5)
    a = rs.uniform(0, 1.5, (16, 12, 3)).astype(np.float32)
    b = a + rs.normal(0, 0.05, a.shape).astype(np.float32)
    for gamma in (1.0, 2.2):
        np.testing.assert_array_equal(image.tonemap(a, 0.8, gamma),
                                      jimage.tonemap(a, 0.8, gamma))
    assert image.psnr(a, b) == jimage.psnr(a, b)
    assert image.psnr(a, a) == float("inf")
    # The same float64 formula: equal to the last ulp or two.
    assert image.ssim(a, b) == pytest.approx(jimage.ssim(a, b), rel=1e-12)
    assert image.ssim(a, a) == pytest.approx(1.0, rel=1e-12)


def test_write_hdr_npz_roundtrip(tmp_path):
    path = os.path.join(tmp_path, "h.npz")
    hdr = np.random.RandomState(6).uniform(0, 9, (4, 5, 3)).astype(
        np.float32)
    image.write_hdr_npz(path, image=hdr, depth=hdr[..., 0])
    with np.load(path) as d:
        np.testing.assert_array_equal(d["image"], hdr)
        np.testing.assert_array_equal(d["depth"], hdr[..., 0])


@pytest.mark.parametrize("name", sorted(JCONFIGS))
def test_rays_per_frame_matches_bench(name):
    for lights in (0, 2, 7):
        assert (tlogging.rays_per_frame(CONFIGS[name], lights)
                == bench.rays_per_frame(JCONFIGS[name], lights))


def test_frame_stats_and_frame_stats_dict():
    st = tlogging.FrameStats()
    st.add(1_000_000, 0.01)
    st.add(1_000_000, 0.01)
    assert abs(st.mrays_per_sec - 100.0) < 1e-6
    assert abs(st.ms_per_frame - 10.0) < 1e-6
    for name in ("primary", "path_tracing"):
        assert (profiling.frame_stats(CONFIGS[name], 3, 0.0123)
                == jprofiling.frame_stats(JCONFIGS[name], 3, 0.0123))


def test_stage_timer_and_memory_stats():
    """Per-stage timers are the tracing module's spans (utils/tracing.py):
    counts and mean ms per stage, off by default."""
    tracing.reset()
    with tracing.span("trace"):
        pass
    assert tracing.snapshot()["spans"] == {}
    tracing.enable()
    try:
        for _ in range(2):
            with tracing.span("trace"):
                torch.zeros(4) + 1
        with tracing.span("shade"):
            pass
        rep = tracing.snapshot()["spans"]
    finally:
        tracing.disable()
        tracing.reset()
    assert set(rep) == {"trace", "shade"} and rep["trace"]["count"] == 2
    assert all(v["total_ms"] >= 0 for v in rep.values())
    assert profiling.device_memory_stats("cpu") == {}


def test_profiler_trace_writes_chrome_trace(tmp_path):
    with profiling.trace(os.path.join(tmp_path, "tr")) as prof:
        torch.ones(64).sum()
    assert os.path.getsize(os.path.join(tmp_path, "tr", "trace.json")) > 0
    assert len(prof.key_averages()) > 0


@pytest.mark.parametrize("mode", ["spatial", "temporal"])
def test_checkpoint_roundtrip(tmp_path, mode):
    """The committed weights through save_params / load_params and
    upscaler_from_numpy give the committed net, parameter for
    parameter; a template with other names or shapes refuses."""
    name = "upscaler_temporal.npz" if mode == "temporal" else "upscaler.npz"
    with np.load(os.path.join(upscaler.WEIGHTS_DIR, name)) as d:
        params = dict(d)
    path = os.path.join(tmp_path, "ckpt.npz")
    checkpoint.save_params(path, params)
    assert os.path.exists(path)
    back = checkpoint.load_params(path, template=params)
    net = upscaler_from_numpy(back, mode == "temporal", "cpu")
    ref = upscaler.load_weights(mode, "cpu")
    for (ka, a), (kb, b) in zip(net.state_dict().items(),
                                ref.state_dict().items()):
        assert ka == kb
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError):
        checkpoint.load_params(path, template={"Conv_0/kernel": 0})
    bad = dict(params, **{"Conv_0/bias": np.zeros(3)})
    with pytest.raises(ValueError):
        checkpoint.load_params(path, template=bad)
