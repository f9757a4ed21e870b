"""`python -m hrt_tpu_torch.render` (hrt_tpu_torch.cli) on the CPU against
the JAX package's command, and the brute-force traversal it offers
(`--traversal bruteforce`, renderer.render with no accel) against the
JAX package's brute-force frame and the port's own BVH frame.  The JAX
command runs once, in a module fixture."""
import json
import os
import shutil

import numpy as np
from PIL import Image
import pytest
import torch

import bench
from hrt_tpu import cli as jcli
from hrt_tpu.config import RenderConfig as JRenderConfig
from hrt_tpu.models.camera import Camera as JCamera
from hrt_tpu.models.scene import reference_demo_scene as jdemo
from hrt_tpu.renderer import render as jrender
from hrt_tpu.utils import oracle
from hrt_tpu.utils.image import psnr
from hrt_tpu_torch import cli, renderer
from hrt_tpu_torch.config import RenderConfig
from hrt_tpu_torch.frameloop import FrameLoop
from hrt_tpu_torch.models.camera import Camera
from hrt_tpu_torch.models.scene import bench_scene, reference_demo_scene
from hrt_tpu_torch.ops import lbvh, traversal
from hrt_tpu_torch.utils import checkpoint
from hrt_tpu_torch.utils.image import tonemap

from test_torch_materials import OBJ_TEXT
from test_torch_native import jax_native_lib


@pytest.fixture(scope="module", autouse=True)
def _jax_native_sah():
    """JAX's build_bvh_sah through its native builder, never the LBVH
    fallback (test_torch_native.jax_native_lib)."""
    jax_native_lib()


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_CAM = dict(position=(0.0, -1.0, -6.0), rotation=(-0.15, 0.0, 0.0))
# The JAX package's CLI smoke arguments (tests/test_utils.py).
SMOKE = ["--scene", "demo", "--width", "32", "--height", "24",
         "--max-depth", "1", "--sky", "--traversal", "bvh", "--stats"]


def _read_png(path):
    return np.asarray(Image.open(path).convert("RGB"))


def _psnr4(a, b):
    return psnr(np.clip(a, 0, 4), np.clip(b, 0, 4), peak=4.0)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's command with SMOKE and a checkpoint: its PNG and state."""
    d = tmp_path_factory.mktemp("jax_cli")
    out, ckpt = str(d / "f.png"), str(d / "state.npz")
    jcli.main(SMOKE + ["--out", out, "--checkpoint", ckpt])
    return out, ckpt


def _stats_line(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_renders_and_resumes(tmp_path, capsys):
    """The port's command on the CPU writes the PNG and the stats line,
    and a second call resumes from the state it saved."""
    out, ckpt = str(tmp_path / "f.png"), str(tmp_path / "state.npz")
    args = SMOKE + ["--out", out, "--checkpoint", ckpt, "--device", "cpu"]
    loop = cli.main(args)
    assert os.path.exists(out) and os.path.exists(ckpt)
    stats = _stats_line(capsys)
    assert set(stats) == {"frames", "ms_per_frame", "mrays_per_sec"}
    assert stats["frames"] == 1 and stats["ms_per_frame"] > 0
    assert _read_png(out).shape == (24, 32, 3)
    assert loop.frame == 1 and loop.accel is not None
    cli.main(args)
    with np.load(ckpt) as state:
        assert int(state["frame"]) == 2


def _edge_grazes(scene, cam, width, height, eps=1e-5):
    """(H, W) mask of the pixels whose camera ray passes within `eps`
    (barycentric, float64) of a triangle's boundary in front of the
    camera: there hit or miss depends on the last bit of the
    Moller-Trumbore terms, which XLA and torch round differently
    (ROADMAP, Queue C: exact edge grazes)."""
    cfg = RenderConfig(width=width, height=height)
    o, d = renderer.primary_rays(renderer.camera_arrays(cam, cfg, "cpu"),
                                 height, 0, cfg)
    o, d = o.to_array().double().numpy(), d.to_array().double().numpy()
    graze = np.zeros(o.shape[0], bool)
    for v0, e1, e2 in zip(*(getattr(scene, k).double().numpy()
                            for k in ("tri_v0", "tri_e1", "tri_e2"))):
        p = np.cross(d, e2)
        det = p @ e1
        ok = np.abs(det) > 1e-12
        inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
        tv = o - v0
        u = np.sum(tv * p, -1) * inv
        q = np.cross(tv, e1)
        v = np.sum(d * q, -1) * inv
        t = (q @ e2) * inv
        edge = np.minimum(np.minimum(u, v), 1.0 - u - v)
        graze |= ok & (t > 1e-3) & (np.abs(edge) < eps)
    return graze.reshape(height, width)


def test_cli_png_matches_jax(tmp_path, jax_run):
    """The same arguments: the decoded 8-bit images reach PSNR > 45 off
    the pixels that differ where the port's camera ray passes within
    1e-5 of a triangle edge (there the last bit of the Moller-Trumbore
    terms, which XLA and torch round differently, decides what the ray
    hits).  At every pixel where the images differ, the port's closest
    hit (triangle, or miss) on its own ray is the float64 oracle's, and
    the grazing pixels stay under 2% of the frame."""
    out = str(tmp_path / "f.png")
    loop = cli.main(SMOKE + ["--out", out, "--device", "cpu"])
    a, b = _read_png(out), _read_png(jax_run[0])
    differ = np.abs(a.astype(np.int32) - b).max(-1) > 2
    cam = Camera(position=(0.0, 0.0, -2.0))
    cfg = loop.config
    o, d = renderer.primary_rays(renderer.camera_arrays(cam, cfg, "cpu"),
                                 cfg.height, 0, cfg)
    tri = traversal.closest_hit_bvh_p(loop.scene, loop.accel, o, d,
                                      cfg.t_min, renderer.INF)[1]
    sd = loop.scene
    want = oracle.closest_hit(o.to_array().numpy(), d.to_array().numpy(),
                              sd.tri_v0.numpy(), sd.tri_e1.numpy(),
                              sd.tri_e2.numpy(), t_min=cfg.t_min)[1]
    tri, want = (x.reshape(cfg.height, cfg.width)
                 for x in (tri.numpy(), want))
    np.testing.assert_array_equal(tri[differ], want[differ])
    graze = _edge_grazes(sd, cam, cfg.width, cfg.height)
    assert graze.mean() < 0.02
    keep = ~(differ & graze)
    assert psnr(a[keep] / 255.0, b[keep] / 255.0) > 45.0


def test_cli_resumes_from_jax_state(tmp_path, jax_run):
    """A state file that JAX's command wrote resumes the port's loop."""
    ckpt = str(tmp_path / "state.npz")
    shutil.copy(jax_run[1], ckpt)
    loop = cli.main(SMOKE + ["--out", str(tmp_path / "f.png"),
                             "--checkpoint", ckpt, "--device", "cpu"])
    assert loop.frame == 2
    with np.load(ckpt) as state:
        assert int(state["frame"]) == 2


@pytest.mark.parametrize("spec", ["demo", "bench", "cornell",
                                  "scenes/colonnade.yaml", "shape.obj"])
def test_load_scene_matches_jax(tmp_path, spec):
    """Each scene source builds the JAX command's scene (bench from the
    port's own models/scene.bench_scene)."""
    if spec.endswith(".obj"):
        path = tmp_path / spec
        path.write_text(OBJ_TEXT)
        spec = str(path)
    elif spec.endswith(".yaml"):
        spec = os.path.join(ROOT, spec)
    port = cli.load_scene(spec).build("cpu")
    ref = jcli.load_scene(spec).build()
    for field in ("tri_v0", "tri_e1", "tri_e2", "nrm0", "uv1", "tri_mat",
                  "tri_inst", "materials", "lights", "sky"):
        np.testing.assert_allclose(getattr(port, field).numpy(),
                                   np.asarray(getattr(ref, field)),
                                   rtol=1e-6, atol=1e-6, err_msg=field)


def test_cli_flags_match_jax(monkeypatch):
    """Every flag of the JAX command (its parser caught as its main
    parses), with the same defaults, types and choices, plus --device."""
    import argparse

    def flags(parser):
        return {a.dest: (a.default, a.type, getattr(a, "choices", None))
                for a in parser._actions
                if not isinstance(a, argparse._HelpAction)}

    class Capture(Exception):
        pass

    captured = {}

    def grab(self, argv=None, namespace=None):
        captured["parser"] = self
        raise Capture

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(Capture):
        jcli.main([])
    monkeypatch.undo()
    port, ref = flags(cli.build_parser()), flags(captured["parser"])
    assert set(port) == set(ref) | {"device"}
    for k, v in ref.items():
        assert port[k] == v, k
    assert port["device"][0] == "cuda"


def test_cli_refusals(tmp_path, monkeypatch):
    """--devices > 1 without torchrun's environment (or with another
    world size) and with --preview raises ValueError; --device cuda
    without a card raises; --debug-nans raises on a non-finite frame."""
    args = SMOKE + ["--out", str(tmp_path / "f.png"), "--device", "cpu"]
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        cli.main(args + ["--devices", "2"])
    monkeypatch.setenv("WORLD_SIZE", "3")
    with pytest.raises(ValueError, match="WORLD_SIZE is 3"):
        cli.main(args + ["--devices", "2"])
    with pytest.raises(ValueError, match="--preview"):
        cli.main(args + ["--devices", "2", "--preview"])
    monkeypatch.delenv("WORLD_SIZE")
    assert not os.path.exists(tmp_path / "f.png")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(SMOKE + ["--out", str(tmp_path / "g.png")])
        assert not os.path.exists(tmp_path / "g.png")
    orig = FrameLoop.step
    monkeypatch.setattr(FrameLoop, "step",
                        lambda self, cam: orig(self, cam) * float("nan"))
    cli.main(args)
    with pytest.raises(FloatingPointError):
        cli.main(args + ["--debug-nans"])


def test_cli_upscaler_checkpoint(tmp_path):
    """--upscaler-ckpt with an .npz of the committed temporal weights
    renders the frame the committed weights render."""
    from hrt_tpu_torch.models import upscaler

    with np.load(os.path.join(upscaler.WEIGHTS_DIR,
                              "upscaler_temporal.npz")) as d:
        ckpt = str(tmp_path / "up.npz")
        checkpoint.save_params(ckpt, dict(d))
    args = SMOKE + ["--device", "cpu", "--denoise", "--upscale", "2",
                    "--upscale-mode", "temporal", "--frames", "2"]
    cli.main(args + ["--out", str(tmp_path / "a.png")])
    cli.main(args + ["--out", str(tmp_path / "b.png"), "--upscaler-ckpt",
                     ckpt])
    for f in (0, 1):
        a = _read_png(str(tmp_path / f"a_{f:04d}.png"))
        assert a.shape == (48, 64, 3)
        np.testing.assert_array_equal(
            a, _read_png(str(tmp_path / f"b_{f:04d}.png")))


def test_cli_bruteforce_is_the_frameloop_frame(tmp_path):
    """--traversal bruteforce with --frames 2 --orbit: no accel, no
    culling rebuild, and each PNG is the tonemapped step of a FrameLoop
    with the same config."""
    out = str(tmp_path / "o.png")
    argv = ["--scene", "bench", "--width", "32", "--height", "24",
            "--max-depth", "1", "--sky", "--traversal", "bruteforce",
            "--frames", "2", "--orbit", "--device", "cpu", "--out", out]
    loop = cli.main(argv)
    assert loop.accel is None and loop.rebuilds == 0
    ref = FrameLoop(bench_scene(), cli.render_config(
        cli.build_parser().parse_args(argv)), device="cpu")
    from hrt_tpu_torch.models.camera import orbit_camera

    for f in range(2):
        img = ref.step(orbit_camera(f * 0.15, radius=4.0, height=-1.0))
        np.testing.assert_array_equal(
            _read_png(cli.frame_path(out, f, 2)), tonemap(img.numpy()))


@pytest.mark.parametrize("which", ["demo", "bench"])
def test_bruteforce_frame_matches_jax_and_bvh(which):
    """traversal='bruteforce' at 64x48: the demo scene (three lights,
    mirror and rough metal) and the bench scene against JAX's
    brute-force frame and against the port's BVH frame, PSNR > 45."""
    cfg = dict(width=64, height=48, max_depth=1, sky=True)
    if which == "demo":
        sc, jsc, cam, jcam = (reference_demo_scene(), jdemo(), Camera(),
                              JCamera())
    else:
        sc, jsc = bench_scene(), bench.build_bench_scene()
        cam, jcam = Camera(**BENCH_CAM), JCamera(**BENCH_CAM)
    jimg = np.asarray(jrender(jsc, jcam, JRenderConfig(
        shade_pallas=False, traversal="bruteforce", **cfg)))
    img = renderer.render(sc, cam, RenderConfig(traversal="bruteforce",
                                                **cfg), device="cpu")
    assert img.shape == jimg.shape == (48, 64, 3)
    assert _psnr4(img, jimg) > 45.0
    acc = lbvh.build_bvh_sah(sc.build("cpu"), leaf_size=32)
    bvh = renderer.render(sc, cam, RenderConfig(**cfg), acc)
    assert _psnr4(img, bvh) > 45.0
    # An accel given with traversal='bruteforce' is not walked.
    forced = renderer.render(sc, cam, RenderConfig(traversal="bruteforce",
                                                   **cfg), acc)
    np.testing.assert_array_equal(forced, img)


def test_bruteforce_textured_sampled_frame_matches_bvh():
    """Brute force at every depth of a path-traced studio frame (its
    checkerboard texture, one sampled light a ray, bounces) against the
    BVH walk's frame of the same config: PSNR > 45."""
    import dataclasses

    from hrt_tpu_torch.models.scenefile import load_scene_yaml

    cfg = RenderConfig(width=32, height=24, max_depth=3, sky=True,
                       indirect=True, light_samples=1,
                       traversal="bruteforce")
    sc = load_scene_yaml(os.path.join(ROOT, "scenes", "studio.yaml"))
    cam = Camera(position=(0.0, -1.5, -6.0), rotation=(-0.15, 0.0, 0.0))
    img = renderer.render(sc, cam, cfg, device="cpu")
    acc = lbvh.build_bvh_sah(sc.build("cpu"), leaf_size=32)
    bvh = renderer.render(sc, cam, dataclasses.replace(cfg,
                                                       traversal="auto"), acc)
    assert np.isfinite(img).all() and img.mean() > 0.0
    assert _psnr4(img, bvh) > 45.0
