"""The post frame loop of hrt_tpu_torch against the JAX FrameLoop, on the
CPU: the bench frame at 64x48 with SVGF and the 2x upscaler (temporal
mode over three steps of a moving camera, one spatial-mode step, one
denoise-only step), a state file the JAX package saved loaded by the
port, and the single-level G-buffer that feeds the post stages.  Both
packages get the same trained upscaler weights.  The JAX loops run once
per module (each compiles its frame program, ~10 s here).
"""
import os
import tempfile

import numpy as np
import jax
import pytest

import bench
from hrt_tpu.config import RenderConfig as JRenderConfig
from hrt_tpu.frameloop import FrameLoop as JFrameLoop
from hrt_tpu.models.camera import Camera as JCamera
from hrt_tpu.renderer import camera_arrays as jcamera_arrays
from hrt_tpu.renderer import render_rows as jrender_rows
from hrt_tpu_torch import renderer
from hrt_tpu_torch.config import RenderConfig
from hrt_tpu_torch.frameloop import FrameLoop
from hrt_tpu_torch.models.scene import bench_scene
from hrt_tpu_torch.utils.image import psnr
from hrt_tpu_torch.utils.interop import accel_from_numpy

from test_torch_build import jax_accel_dict
from test_torch_native import jax_native_lib
from test_torch_post import cam_at, committed_npz, flax_params


@pytest.fixture(scope="module", autouse=True)
def _jax_native_sah():
    """JAX's build_bvh_sah through its native builder, never the LBVH
    fallback (test_torch_native.jax_native_lib)."""
    jax_native_lib()


# The post path at 64x48 -> 128x96.  JAX walks its plain BVH loop
# (traversal="bvh") and plain BRDF, the port its plain versions; the
# port ignores both knobs.
POST = dict(width=64, height=48, max_depth=1, sky=True, traversal="bvh",
            shade_pallas=False)
MODES = {"temporal": dict(denoise=True, upscale=2, upscale_mode="temporal"),
         "spatial": dict(denoise=True, upscale=2, upscale_mode="spatial"),
         "denoise": dict(denoise=True)}
STEPS = 3


def _psnr4(a, b) -> float:
    return psnr(np.clip(a, 0, 4), np.clip(b, 0, 4), peak=4.0)


def _steps(mode: str) -> int:
    return STEPS if mode == "temporal" else 1


@pytest.fixture(scope="module")
def jax_loops():
    """The JAX post loops, run once: temporal mode for STEPS steps along
    the moving camera (saving its state before the last step), and one
    step each of the spatial and the denoise-only loop, each upscaling
    loop with the trained weights of its mode.  Returns per mode the
    frames, the denoise states after each step, the loop and the saved
    state's path."""
    out = {}
    for mode, kw in MODES.items():
        params = (flax_params(kw["upscale_mode"]) if kw.get("upscale")
                  else None)
        loop = JFrameLoop(bench.build_bench_scene(),
                          JRenderConfig(**POST, **kw),
                          upscaler_params=params)
        frames, states, saved = [], [], None
        for f in range(_steps(mode)):
            if mode == "temporal" and f == STEPS - 1:
                saved = os.path.join(tempfile.mkdtemp(), "state.npz")
                loop.save_state(saved)
            frames.append(np.asarray(loop.step(cam_at(f, JCamera))))
            states.append({k: np.asarray(v)
                           for k, v in loop.dn_state._asdict().items()})
        out[mode] = dict(frames=frames, states=states, loop=loop,
                         saved=saved)
    return out


def _port_loop(mode: str) -> FrameLoop:
    kw = MODES[mode]
    return FrameLoop(bench_scene(), RenderConfig(**POST, **kw),
                     upscaler_params=(committed_npz(kw["upscale_mode"])
                                      if kw.get("upscale") else None),
                     device="cpu")


@pytest.fixture(scope="module")
def port_loops():
    out = {}
    for mode in MODES:
        loop = _port_loop(mode)
        frames, states = [], []
        for f in range(_steps(mode)):
            frames.append(loop.step(cam_at(f)).numpy())
            states.append({k: v.numpy()
                           for k, v in loop.dn_state._asdict().items()})
        out[mode] = dict(frames=frames, states=states)
    return out


def _close_states(got: dict, want: dict) -> None:
    """The denoise state to rtol 1e-4 on all but a few entries: the two
    renders differ at one or two specular pixels (FMA contraction in
    XLA's shading), and a projected coordinate's last ulp moves a
    history fetch across a highlight's steep edge.  No entry is off by
    more than 1%."""
    for k, a in want.items():
        b = got[k]
        close = np.isclose(b, a, rtol=1e-4, atol=1e-6)
        assert close.mean() >= 0.995, (k, close.mean())
        np.testing.assert_allclose(b, a, rtol=1e-2, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("case", [f"temporal-{f}" for f in range(STEPS)]
                         + ["spatial-0", "denoise-0"])
def test_post_frameloop_matches_jax(jax_loops, port_loops, case):
    """JAX's default bf16 upscaler trunk against the port's: PSNR > 45
    (peak 4) per step; the denoise state as `_close_states` says."""
    mode, f = case.split("-")
    f = int(f)
    want, got = jax_loops[mode], port_loops[mode]
    shape = (48, 64, 3) if mode == "denoise" else (96, 128, 3)
    assert got["frames"][f].shape == want["frames"][f].shape == shape
    assert np.isfinite(got["frames"][f]).all()
    assert _psnr4(got["frames"][f], want["frames"][f]) > 45.0
    _close_states(got["states"][f], want["states"][f])


def test_port_loads_a_state_the_jax_package_saved(jax_loops):
    """A port loop that has seen the camera of step STEPS - 2 loads the
    state the JAX loop saved after that step; its next frame is the JAX
    loop's."""
    loop = _port_loop("temporal")
    loop.step(cam_at(STEPS - 2))        # sets prev_cams, as JAX's loop had
    loop.load_state(jax_loops["temporal"]["saved"])
    assert loop.frame == STEPS - 1 and loop.up_history.shape == (96, 128, 3)
    img = loop.step(cam_at(STEPS - 1)).numpy()
    assert _psnr4(img, jax_loops["temporal"]["frames"][-1]) > 45.0


def check_gbuffer(gb: dict, jgb: dict) -> None:
    """G-buffer fields (H, W, ·) agree with JAX's: `hit` on >= 99.9% of
    pixels; where both hit, the other fields to rtol 1e-5 / atol 5e-5
    (XLA contracts Möller-Trumbore's and the normal interpolation's
    products into FMAs, so t and the unit normals differ in their last
    ulps); on misses the fill values."""
    jgb = {k: np.asarray(v) for k, v in jgb.items()}
    assert sorted(gb) == sorted(jgb)
    for k in gb:
        assert gb[k].shape == jgb[k].shape, k
    hit, jhit = gb["hit"].numpy() > 0.5, jgb["hit"] > 0.5
    assert (hit == jhit).mean() >= 0.999 and 0.2 < hit.mean() < 1.0
    both = hit & jhit
    for k in ("depth", "normal", "albedo", "world_pos"):
        np.testing.assert_allclose(gb[k].numpy()[both], jgb[k][both],
                                   rtol=1e-5, atol=5e-5, err_msg=k)
    miss = ~hit
    assert (gb["depth"].numpy()[miss] == 0).all()
    assert (gb["albedo"].numpy()[miss] == 1).all()
    assert (gb["normal"].numpy()[miss] == 0).all()
    assert (gb["world_pos"].numpy()[miss] == 0).all()


def test_gbuffer_matches_jax(jax_loops):
    """The single-level G-buffer on the JAX loop's scene and accel.  (The
    two-level one is in test_torch_tlas.py, beside its JAX two-level
    build.)"""
    jl = jax_loops["denoise"]["loop"]
    cfg = JRenderConfig(**POST)
    fn = jax.jit(lambda s, a, c: jrender_rows(s, a, c, 0, 0, 48, cfg,
                                              want_gbuffer=True))
    _, jgb = fn(jl.scene, jl.accel, jcamera_arrays(cam_at(0, JCamera), cfg))
    acc = accel_from_numpy(jax_accel_dict(jl.accel), 32, "cpu")
    tcfg = RenderConfig(**POST)
    cams = renderer.camera_arrays(cam_at(0), tcfg, "cpu")
    _, gb = renderer.render_rows(bench_scene().build("cpu"), acc, cams, 0,
                                 48, tcfg, want_gbuffer=True)
    check_gbuffer(gb, jgb)
