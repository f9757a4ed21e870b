"""What the frame index drives in the port's path tracer, against the
JAX package on the CPU: jittered frames 0 (pixel centres) and 1, three
samples a pixel, and three path-traced FrameLoop steps that accumulate.
Both packages render on the same JAX-built SAH accel (the loops build
their own, bit-equal, test_torch_build.py).  Frames are held at PSNR >
45 (peak 4) and at least 0.99 of pixels within 1e-3; the JAX frames are
rendered once per module.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

import bench
from hrt_tpu.config import RenderConfig as JRenderConfig
from hrt_tpu.frameloop import FrameLoop as JFrameLoop
from hrt_tpu.models.camera import Camera as JCamera
from hrt_tpu.ops import lbvh as jlbvh
from hrt_tpu.renderer import camera_arrays as jcamera_arrays
from hrt_tpu.renderer import render_frames as jrender_frames
from hrt_tpu.utils.image import psnr
from hrt_tpu_torch import renderer
from hrt_tpu_torch.config import RenderConfig
from hrt_tpu_torch.frameloop import FrameLoop
from hrt_tpu_torch.models.camera import Camera
from hrt_tpu_torch.models.scene import bench_scene
from hrt_tpu_torch.ops import lbvh
from hrt_tpu_torch.utils.interop import accel_from_numpy

from test_torch_build import jax_accel_dict
from test_torch_native import jax_native_lib


@pytest.fixture(scope="module", autouse=True)
def _jax_native_sah():
    """JAX's build_bvh_sah through its native builder, never the LBVH
    fallback (test_torch_native.jax_native_lib)."""
    jax_native_lib()


BENCH_CAM = dict(position=(0.0, -1.0, -6.0), rotation=(-0.15, 0.0, 0.0))
SMALL = dict(width=48, height=32, sky=True)
# Jittered frames with bounces; three jittered samples a pixel.
CASES = {"jitter": (dict(max_depth=2, indirect=True, jitter=True), 0, 2),
         "spp3": (dict(max_depth=1, jitter=True, spp=3), 1, 1)}
# The path_tracing loop at 48x32 and depth 3, sorted.
LOOP = dict(width=48, height=32, max_depth=3, sky=True, indirect=True,
            jitter=True, accumulate=True, sort_bounces=True)
STEPS = 3


def _psnr4(a, b) -> float:
    return psnr(np.clip(a, 0, 4), np.clip(b, 0, 4), peak=4.0)


def _check(img, ref):
    assert img.shape == ref.shape
    assert np.isfinite(img).all()
    assert _psnr4(img, ref) > 45.0
    assert (np.abs(img - ref).max(axis=-1) <= 1e-3).mean() >= 0.99


@pytest.fixture(scope="module")
def jax_frames():
    """The JAX accel and each case's frames (render_frames from its
    first frame), rendered once."""
    js = bench.build_bench_scene().build()
    ja = jlbvh.build_bvh_sah(js, leaf_size=32)
    out = {}
    for name, (kw, frame0, k) in CASES.items():
        cfg = JRenderConfig(traversal="bvh", shade_pallas=False, **SMALL, **kw)
        out[name] = np.asarray(jrender_frames(
            js, ja, jcamera_arrays(JCamera(**BENCH_CAM), cfg),
            jnp.uint32(frame0), k, cfg))
    return accel_from_numpy(jax_accel_dict(ja), 32, "cpu"), out


@pytest.mark.parametrize("case", list(CASES))
def test_frames_match_jax(jax_frames, case):
    acc, frames = jax_frames
    kw, frame0, k = CASES[case]
    scene = bench_scene().build("cpu")
    cfg = RenderConfig(**SMALL, **kw)
    cams = renderer.camera_arrays(Camera(**BENCH_CAM), cfg, "cpu")
    imgs = renderer.render_frames(scene, acc, cams, frame0, k, cfg).numpy()
    for img, ref in zip(imgs, frames[case]):
        _check(img, ref)
    if k == 2:
        assert not np.array_equal(imgs[0], imgs[1])


def test_frame0_shoots_through_pixel_centres():
    """Jittered frame 0 is the unjittered frame shifted by half a pixel:
    its rays are primary_rays at the pixel centres."""
    cfg = RenderConfig(max_depth=1, jitter=True, **SMALL)
    scene = bench_scene().build("cpu")
    acc = lbvh.build_bvh_sah(scene, leaf_size=32)
    cams = renderer.camera_arrays(Camera(**BENCH_CAM), cfg, "cpu")
    batches = []
    renderer.render_rows(scene, acc, cams, 0, 32, cfg, frame=0,
                         _batches=batches)
    px, py = renderer.pixel_planes(32, 0, cfg, "cpu")
    o, d = renderer._rays_at(cams, cfg, px.float() + 0.5, py.float() + 0.5)
    for a, b in zip(batches[0]["d"], d):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    batches = []
    renderer.render_rows(scene, acc, cams, 0, 32, cfg, frame=1,
                         _batches=batches)
    assert not np.array_equal(batches[0]["d"].x.numpy(), d.x.numpy())


def test_frameloop_accumulates_like_jax():
    """STEPS path-traced FrameLoop steps with accumulate and the sorted
    wavefront (the path_tracing config at 48x32, depth 3): each step's
    running mean against the JAX FrameLoop's, and the frame counter."""
    jloop = JFrameLoop(bench.build_bench_scene(), JRenderConfig(
        traversal="bvh", shade_pallas=False, **LOOP))
    loop = FrameLoop(bench_scene(), RenderConfig(**LOOP), device="cpu")
    prev = None
    for f in range(STEPS):
        ref = np.asarray(jloop.step(JCamera(**BENCH_CAM)))
        img = loop.step(Camera(**BENCH_CAM)).numpy()
        _check(img, ref)
        if prev is not None:
            assert not np.array_equal(img, prev)
        prev = img
    assert loop.frame == jloop.frame == STEPS
    np.testing.assert_allclose(loop.accum.numpy(), np.asarray(jloop.accum),
                               rtol=1e-3, atol=1e-3)
