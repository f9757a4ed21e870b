"""The ported frame (hrt_tpu_torch.renderer) against the JAX renderer on
the same SAH accel and against the golden frames, at 64x48 on the CPU
(the kernel-path frame is held against the plain one on a card in
test_torch_cuda.py)."""
import os

import numpy as np
import pytest

import bench
from hrt_tpu.config import RenderConfig as JRenderConfig
from hrt_tpu.models.camera import Camera as JCamera
from hrt_tpu.models.scene import reference_demo_scene as jdemo
from hrt_tpu.ops import lbvh as jlbvh
from hrt_tpu.renderer import render as jrender
from hrt_tpu.utils.image import psnr
from hrt_tpu_torch import renderer
from hrt_tpu_torch.config import RenderConfig
from hrt_tpu_torch.models.camera import Camera
from hrt_tpu_torch.models.scene import bench_scene, reference_demo_scene
from hrt_tpu_torch.ops import lbvh
from hrt_tpu_torch.utils.interop import accel_from_numpy

from test_torch_build import jax_accel_dict

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
BENCH_CAM = dict(position=(0.0, -1.0, -6.0), rotation=(-0.15, 0.0, 0.0))
SMALL = dict(width=64, height=48, max_depth=1)


def _psnr4(a, b):
    return psnr(np.clip(a, 0, 4), np.clip(b, 0, 4), peak=4.0)


def test_bench_frame_matches_jax_on_same_accel():
    """JAX renders with its plain references (traversal='bvh',
    shade_pallas=False); both packages get the same JAX-built accel."""
    js = bench.build_bench_scene().build()
    ja = jlbvh.build_bvh_sah(js, leaf_size=32)
    jimg = np.asarray(jrender(js, JCamera(**BENCH_CAM), JRenderConfig(
        sky=True, traversal="bvh", shade_pallas=False, **SMALL), accel=ja))
    acc = accel_from_numpy(jax_accel_dict(ja), 32, "cpu")
    img = renderer.render(bench_scene(), Camera(**BENCH_CAM),
                          RenderConfig(sky=True, **SMALL), acc)
    assert img.shape == jimg.shape == (48, 64, 3)
    assert _psnr4(img, jimg) > 45.0
    assert (np.abs(img - jimg).max(axis=-1) <= 1e-3).mean() >= 0.999


@pytest.mark.parametrize("name", ["bench_direct", "demo_parity",
                                  "demo_sky"])
def test_frame_matches_golden(name):
    """The port's own SAH/BVH8 build against the JAX goldens."""
    if name == "bench_direct":
        sc, cam, sky_on = bench_scene(), Camera(**BENCH_CAM), True
    else:
        sc, cam, sky_on = reference_demo_scene(), Camera(), name == "demo_sky"
    acc = lbvh.build_bvh_sah(sc.build("cpu"), leaf_size=32)
    img = renderer.render(sc, cam, RenderConfig(sky=sky_on, **SMALL), acc)
    golden = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))["image"]
    assert np.isfinite(img).all()
    assert _psnr4(img, golden) > 45.0, name


def test_demo_frame_matches_jax():
    """Three lights, mirror and rough metal: the JAX bruteforce frame."""
    cfg = dict(width=48, height=32, max_depth=1, sky=True)
    jimg = np.asarray(jrender(jdemo(), JCamera(),
                              JRenderConfig(shade_pallas=False, **cfg)))
    sc = reference_demo_scene()
    acc = lbvh.build_bvh_sah(sc.build("cpu"), leaf_size=32)
    img = renderer.render(sc, Camera(), RenderConfig(**cfg), acc)
    assert _psnr4(img, jimg) > 45.0


def test_render_frames_matches_render():
    cfg = RenderConfig(sky=True, **SMALL)
    ts = bench_scene().build("cpu")
    acc = lbvh.build_bvh_sah(ts, leaf_size=32)
    cams = renderer.camera_arrays(Camera(**BENCH_CAM), cfg, "cpu")
    frames = renderer.render_frames(ts, acc, cams, 0, 2, cfg)
    one = renderer.render(ts, Camera(**BENCH_CAM), cfg, acc)
    assert frames.shape == (2, 48, 64, 3)
    np.testing.assert_array_equal(frames[0].numpy(), one)
    np.testing.assert_array_equal(frames[1].numpy(), one)
