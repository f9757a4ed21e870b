"""The port's path tracer (hrt_tpu_torch.renderer.trace_paths with
`indirect`, Russian roulette and the sorted wavefront) against the JAX
renderer on the same JAX-built SAH accel (JAX with traversal="bvh",
shade_pallas=False, as test_torch_render.py), and against the cornell_gi
golden, at small sizes on the CPU.  Frames are held at PSNR > 45 (peak
4, the gate of tests/test_goldens.py) and at a share of pixels within
1e-3 of at least 0.99.  The JAX frames are rendered once per module.
Jitter, spp, the frame index and the frame loop are in
test_torch_path_loop.py; the kernel-path frame is held against the plain
one on a card in test_torch_cuda.py.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import bench
from hrt_tpu.config import RenderConfig as JRenderConfig
from hrt_tpu.models.camera import Camera as JCamera
from hrt_tpu.ops import lbvh as jlbvh
from hrt_tpu.renderer import render as jrender
from hrt_tpu.utils.image import psnr
from hrt_tpu_torch import renderer
from hrt_tpu_torch.config import CONFIGS, RenderConfig
from hrt_tpu_torch.models.camera import Camera
from hrt_tpu_torch.models.mesh import plane
from hrt_tpu_torch.models.scene import Scene, bench_scene
from hrt_tpu_torch.models.scenefile import cornell_box
from hrt_tpu_torch.ops import lbvh
from hrt_tpu_torch.utils.interop import accel_from_numpy

from test_torch_build import jax_accel_dict

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
BENCH_CAM = dict(position=(0.0, -1.0, -6.0), rotation=(-0.15, 0.0, 0.0))
SMALL = dict(width=48, height=32, sky=True)
# Depth 3 with bounces, with and without Russian roulette (from depth 2,
# the default rr_start_depth).
CASES = {"rr": dict(max_depth=3, indirect=True),
         "no_rr": dict(max_depth=3, indirect=True, russian_roulette=False)}


def _psnr4(a, b) -> float:
    return psnr(np.clip(a, 0, 4), np.clip(b, 0, 4), peak=4.0)


def _check(img, ref, share: float = 0.99):
    assert img.shape == ref.shape
    assert np.isfinite(img).all()
    assert _psnr4(img, ref) > 45.0
    assert (np.abs(img - ref).max(axis=-1) <= 1e-3).mean() >= share


@pytest.fixture(scope="module")
def jax_bench():
    """The JAX bench scene, its SAH accel (32-triangle leaves), and the
    JAX frames of CASES."""
    js = bench.build_bench_scene().build()
    ja = jlbvh.build_bvh_sah(js, leaf_size=32)
    frames = {name: np.asarray(jrender(js, JCamera(**BENCH_CAM), JRenderConfig(
        traversal="bvh", shade_pallas=False, **SMALL, **kw), accel=ja))
        for name, kw in CASES.items()}
    return accel_from_numpy(jax_accel_dict(ja), 32, "cpu"), frames


@pytest.mark.parametrize("case", list(CASES))
def test_indirect_matches_jax(jax_bench, case):
    acc, frames = jax_bench
    img = renderer.render(bench_scene(), Camera(**BENCH_CAM),
                          RenderConfig(**SMALL, **CASES[case]), acc)
    _check(img, frames[case])
    # Bounces add light to the direct frame.
    direct = renderer.render(bench_scene(), Camera(**BENCH_CAM),
                             RenderConfig(max_depth=1, **SMALL), acc)
    assert img.sum() > direct.sum()


def _on_tie_diagonals(h: int, w: int) -> np.ndarray:
    """Pixels whose unjittered ray (through the pixel's integer corner)
    meets an edge where two walls of the Cornell box join.  From the
    golden's camera, on the box's axis with aspect w / h, those edges
    project onto the diagonals |px - w/2| = |py - h/2| (in pixels of
    h/2 per unit): there a ray meets both walls at the same t, and which
    triangle wins, and whether a shadow ray from the edge grazes the
    other wall, is decided by rounding (FMA contraction in XLA's fused
    programs; JAX's own frame on a SAH or brute-force walk differs from
    the golden there, PSNR 41.16)."""
    py, px = np.mgrid[0:h, 0:w]
    return np.abs(px - w // 2) == np.abs(py - h // 2)


@pytest.mark.parametrize("build", ["lbvh", "sah"])
def test_cornell_gi_matches_golden(build):
    """tests/goldens/cornell_gi.npz (the Cornell box at 64x48, depth 3,
    bounces, Russian roulette, no sky) through the port's own LBVH (as
    the golden was made, 8-triangle leaves; K3's plain walk) and SAH
    build (K1's plain walk): PSNR > 45 and within 1e-3 on every pixel
    off the box's edge-tie diagonals, and no pixel off them beyond
    1e-3."""
    sc = cornell_box()
    data = sc.build("cpu")
    acc = (lbvh.build_bvh(data, leaf_size=8) if build == "lbvh"
           else lbvh.build_bvh_sah(data, leaf_size=32))
    cfg = RenderConfig(width=64, height=48, max_depth=3, indirect=True)
    img = renderer.render(sc, Camera(position=(0, 0, -3.2), fov_y=0.7), cfg,
                          acc)
    golden = np.load(os.path.join(GOLDEN_DIR, "cornell_gi.npz"))["image"]
    tie = _on_tie_diagonals(48, 64)
    assert tie.mean() < 0.05
    assert np.isfinite(img).all()
    assert _psnr4(img[~tie], golden[~tie]) > 45.0
    off = np.abs(img - golden).max(axis=-1) > 1e-3
    assert not (off & ~tie).any(), np.argwhere(off & ~tie)


@pytest.mark.parametrize("build", ["lbvh", "sah"])
def test_cornell_gi_matches_jax_whole_frame(build):
    """The cornell_gi frame through the port and through the JAX renderer
    on one JAX-built accel (the golden's LBVH with 8-triangle leaves, or
    SAH with 32), compared over the whole frame: every pixel beyond 1e-3
    lies on the edge-tie diagonals, and its primary ray meets its
    surface on a triangle's edge (a barycentric within 1e-6 of 0), where
    two walls give the same t and the winner, and the side a bounce or
    shadow ray leaves from, is decided by rounding and test order (XLA's
    fused programs round differently from one program to the next).
    Off the diagonals the frames agree to PSNR > 45; JAX's own SAH frame
    departs from the golden on the diagonals only."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from scripts.make_goldens import golden_cases

    from hrt_tpu_torch.ops import traversal

    js, jcam, jcfg = golden_cases()["cornell_gi"]
    data = js.build()
    leaf = 8 if build == "lbvh" else 32
    ja = (jlbvh.build_bvh(data, leaf_size=8) if build == "lbvh"
          else jlbvh.build_bvh_sah(data, leaf_size=32))
    jimg = np.asarray(jrender(js, jcam, jcfg, accel=ja))
    sc = cornell_box()
    acc = accel_from_numpy(jax_accel_dict(ja), leaf, "cpu")
    cam = Camera(position=(0, 0, -3.2), fov_y=0.7)
    cfg = RenderConfig(width=64, height=48, max_depth=3, indirect=True)
    img = renderer.render(sc, cam, cfg, acc)
    tie = _on_tie_diagonals(48, 64)
    assert np.isfinite(img).all()
    assert _psnr4(img[~tie], jimg[~tie]) > 45.0
    off = np.abs(img - jimg).max(axis=-1) > 1e-3
    assert not (off & ~tie).any(), np.argwhere(off & ~tie)
    o, d = renderer.primary_rays(renderer.camera_arrays(cam, cfg, "cpu"), 48,
                                 0, cfg)
    _, tri, u, v = traversal.closest_hit_bvh_p(sc.build("cpu"), acc, o, d,
                                               cfg.t_min, 1e30)
    edge = torch.stack([u.abs(), v.abs(), (1 - u - v).abs()]).amin(0)
    on_edge = ((tri >= 0) & (edge <= 1e-6)).numpy().reshape(48, 64)
    assert not (off & ~on_edge).any(), np.argwhere(off & ~on_edge)
    golden = np.load(os.path.join(GOLDEN_DIR, "cornell_gi.npz"))["image"]
    jax_off = np.abs(jimg - golden).max(axis=-1) > 1e-3
    assert not (jax_off & ~tie).any()
    if build == "sah":
        assert jax_off.any()


def test_sorted_matches_unsorted():
    """The path_tracing config (depth 5, jitter, Russian roulette) at
    48x32 with and without sort_bounces: rtol 1e-4, atol 1e-5, the
    tolerance of tests/test_render.py's test of the JAX package."""
    acc = lbvh.build_bvh_sah(bench_scene().build("cpu"), leaf_size=32)
    base = dataclasses.replace(CONFIGS["path_tracing"], width=48, height=32)
    for frame in (0, 3):
        plain = renderer.render(bench_scene(), Camera(**BENCH_CAM), base, acc,
                                frame=frame)
        srt = renderer.render(bench_scene(), Camera(**BENCH_CAM),
                              dataclasses.replace(base, sort_bounces=True),
                              acc, frame=frame)
        np.testing.assert_allclose(srt, plain, rtol=1e-4, atol=1e-5)
        assert np.isfinite(srt).all()


def test_sorted_wavefront_carries_state():
    """The sorted path reorders the rays between depths: its depth-1 and
    depth-2 batches are a permutation of the unsorted ones', retired
    rays (t_max = -1) last."""
    acc = lbvh.build_bvh_sah(bench_scene().build("cpu"), leaf_size=32)
    cfg = dataclasses.replace(CONFIGS["path_tracing"], width=48, height=32)
    scene = bench_scene().build("cpu")
    cams = renderer.camera_arrays(Camera(**BENCH_CAM), cfg, "cpu")
    got = {}
    for srt in (False, True):
        batches = []
        renderer.render_rows(scene, acc, cams, 0, 32,
                             dataclasses.replace(cfg, sort_bounces=srt),
                             frame=2, _batches=batches)
        got[srt] = batches
    assert [b["depth"] for b in got[True]] == list(range(5))
    for depth in (1, 2):
        a, b = got[False][depth], got[True][depth]
        key = lambda q: np.sort(np.stack([x.numpy() for x in q["o"]])
                                .view(np.int32).astype(np.int64)
                                .sum(0))
        np.testing.assert_array_equal(key(a), key(b))
        dead = b["t_max"].numpy() < 0
        assert dead.any() and not dead[:np.argmax(dead)].any()
        assert dead[np.argmax(dead):].all()
        assert int((a["t_max"] < 0).sum()) == int(dead.sum())


def _enclosed():
    """test_render.py's test_indirect_adds_energy scene: a lit floor and
    a ceiling that reflects light back down."""
    sc = Scene()
    sc.add_mesh(plane(2.0))
    sc.create_material((0.8, 0.8, 0.8), 0.0, 1.0)
    sc.create_instance(0, 0, position=(0, 1, 0))
    sc.create_instance(0, 0, position=(0, -1, 0), rotation=(np.pi, 0, 0))
    sc.create_light((0.5, 0, 0.0), (1, 1, 1), 4.0)
    return sc


def test_indirect_adds_energy():
    """Mirror of tests/test_render.py::test_indirect_adds_energy."""
    cam = Camera(position=(0, 0, -3.5))
    small = dict(width=32, height=24)
    acc = lbvh.build_bvh_sah(_enclosed().build("cpu"), leaf_size=32)
    direct = renderer.render(_enclosed(), cam,
                             RenderConfig(max_depth=1, **small), acc)
    gi = renderer.render(_enclosed(), cam,
                         RenderConfig(max_depth=3, indirect=True, spp=2,
                                      jitter=True, **small), acc)
    assert np.isfinite(gi).all()
    assert gi.sum() > direct.sum()


def test_render_frames_matches_frame_by_frame():
    """render_frames(frame0=5, k=2) equals frames 5 and 6 rendered one by
    one (jitter on: the seeds and the jitter move with the frame), and
    the two frames differ."""
    cfg = dataclasses.replace(CONFIGS["path_tracing"], width=32, height=24,
                              max_depth=3)
    scene = bench_scene().build("cpu")
    acc = lbvh.build_bvh_sah(scene, leaf_size=32)
    cams = renderer.camera_arrays(Camera(**BENCH_CAM), cfg, "cpu")
    frames = renderer.render_frames(scene, acc, cams, 5, 2, cfg).numpy()
    for i, f in enumerate((5, 6)):
        one = renderer.render(scene, Camera(**BENCH_CAM), cfg, acc, frame=f)
        np.testing.assert_array_equal(frames[i], one)
    assert not np.array_equal(frames[0], frames[1])


def test_path_tracer_runs_with_jax_blocked():
    """The path tracer's modules need neither jax, flax nor hrt_tpu: a
    16x12 path_tracing FrameLoop step (sorted) and a whitted Cornell
    box frame with the three made unimportable."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'hrt_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import dataclasses\n"
        "import numpy as np\n"
        "from hrt_tpu_torch import renderer\n"
        "from hrt_tpu_torch.config import CONFIGS\n"
        "from hrt_tpu_torch.frameloop import FrameLoop\n"
        "from hrt_tpu_torch.models.camera import Camera\n"
        "from hrt_tpu_torch.models.scene import bench_scene\n"
        "from hrt_tpu_torch.models.scenefile import cornell_box\n"
        "from hrt_tpu_torch.ops import lbvh\n"
        "cfg = dataclasses.replace(CONFIGS['path_tracing'], width=16,\n"
        "                          height=12, sort_bounces=True)\n"
        "loop = FrameLoop(bench_scene(), cfg, device='cpu')\n"
        "img = loop.step(Camera(position=(0, -1, -6)))\n"
        "assert img.shape == (12, 16, 3) and bool(img.isfinite().all())\n"
        "box = cornell_box()\n"
        "acc = lbvh.build_bvh_sah(box.build('cpu'), 32)\n"
        "cfg = dataclasses.replace(CONFIGS['whitted'], width=16, height=12)\n"
        "img = renderer.render(box, Camera(position=(0, 0, -3.2)), cfg, acc)\n"
        "assert np.isfinite(img).all() and img.max() > 0\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
