"""The post pipeline's parts in hrt_tpu_torch against the JAX package, on
the CPU: K6's plain version (ops/warp_kernel.py) against the JAX gather
path (`denoise._bilinear`) and the JAX Pallas warp in interpret mode;
one `temporal_accumulate` and one `svgf` step; both upscaler nets with
the committed trained weights against the flax modules and the JAX fast
forward; the committed weights against the orbax checkpoints.  Every
input is made with numpy from a seed and fed to both packages.  The
post frame loop is held against JAX's in test_torch_post_loop.py, the
kernel against its plain version on a card in test_torch_cuda.py.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hrt_tpu.config import RenderConfig as JRenderConfig
from hrt_tpu.models import upscaler as jupscaler
from hrt_tpu.models.camera import Camera as JCamera
from hrt_tpu.ops import denoise as jdenoise
from hrt_tpu.ops.warp_pallas import warp_bilinear as jwarp_pallas
from hrt_tpu.renderer import camera_arrays as jcamera_arrays
from hrt_tpu.utils.checkpoint import load_params
from hrt_tpu_torch import renderer
from hrt_tpu_torch.config import RenderConfig
from hrt_tpu_torch.models import upscaler
from hrt_tpu_torch.models.camera import Camera
from hrt_tpu_torch.ops import denoise, warp_kernel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cam_at(f: int, cls=Camera):
    """The bench camera, moving a little each step (x and yaw)."""
    return cls(position=(0.03 * f, -1.0, -6.0),
               rotation=(-0.15, 0.004 * f, 0.0))


def _t(a):
    return torch.as_tensor(np.array(a))


# ---- K6: the plain warp ------------------------------------------------

def _warp_inputs(seed, hs, ws, c, ho, wo, far: bool):
    rs = np.random.RandomState(seed)
    img = rs.uniform(-1, 1, (hs, ws, c)).astype(np.float32)
    jy, jx = np.mgrid[0:ho, 0:wo].astype(np.float32)
    px = (jx * (ws - 1) / max(wo - 1, 1)
          + rs.uniform(-3, 3, (ho, wo))).astype(np.float32)
    py = (jy * (hs - 1) / max(ho - 1, 1)
          + rs.uniform(-3, 3, (ho, wo))).astype(np.float32)
    if far:
        # What the projection gives where it clamps depth to 1e-6.
        far_mask = rs.rand(ho, wo) < 0.1
        px[far_mask] = rs.choice([-1e10, 1e10], far_mask.sum())
        py[rs.rand(ho, wo) < 0.1] = 1e10
    return img, px, py


def test_warp_plain_matches_jax_bilinear():
    """40x56x10 history, coordinates in and out of bounds, some at
    +-1e10: the same value (clamped taps) and validity at every pixel.
    atol 1e-6: XLA contracts the weighted sum into FMAs here."""
    img, px, py = _warp_inputs(0, 40, 56, 10, 30, 44, far=True)
    jval, jinb = jdenoise._bilinear(jnp.asarray(img), jnp.asarray(px),
                                    jnp.asarray(py))
    val, inb = warp_kernel.warp_bilinear_plain(_t(img), _t(px), _t(py))
    np.testing.assert_array_equal(inb.numpy(), np.asarray(jinb))
    assert 0.3 < inb.float().mean() < 0.9
    np.testing.assert_allclose(val.numpy(), np.asarray(jval), rtol=0,
                               atol=1e-6)


def test_warp_plain_matches_jax_pallas_interpret():
    """JAX's Pallas warp (interpret mode, margin 2, one 128x128 tile, as
    test_warp_pallas runs it) on smooth motion: where it calls a pixel
    valid, the port calls it valid with the same value to 1e-6."""
    rs = np.random.RandomState(1)
    img = rs.uniform(0, 1, (128, 128, 10)).astype(np.float32)
    jy, jx = np.mgrid[0:128, 0:128].astype(np.float32)
    px = (jx + 1.25 + 0.3 * np.sin(jy * 0.05)).astype(np.float32)
    py = (jy - 0.75 + 0.3 * np.cos(jx * 0.05)).astype(np.float32)
    jval, jvalid = jwarp_pallas(jnp.asarray(img), jnp.asarray(px),
                                jnp.asarray(py), margin=2)
    jvalid = np.asarray(jvalid)
    val, valid = warp_kernel.warp_bilinear_plain(_t(img), _t(px), _t(py))
    assert jvalid.mean() > 0.95 and not (jvalid & ~valid.numpy()).any()
    np.testing.assert_allclose(val.numpy()[jvalid], np.asarray(jval)[jvalid],
                               rtol=0, atol=1e-6)


def test_warp_cpu_tensors_take_the_plain_version():
    img, px, py = _warp_inputs(2, 16, 24, 3, 16, 24, far=False)
    before = dict(warp_kernel.LAUNCHES)
    got = warp_kernel.warp_bilinear(_t(img), _t(px), _t(py))
    want = warp_kernel.warp_bilinear_plain(_t(img), _t(px), _t(py))
    assert warp_kernel.LAUNCHES == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        warp_kernel.warp_bilinear(*(_t(a).to("meta") for a in (img, px, py)))
    with pytest.raises(ValueError):
        warp_kernel.warp_bilinear(_t(img)[..., 0], _t(px), _t(py))


# ---- SVGF -----------------------------------------------------------------

SV_H, SV_W = 24, 32


def _svgf_inputs(seed: int = 3):
    """A smooth surface seen by the current camera (10% of pixels miss),
    a smooth history, a noisy frame, and the previous camera a little
    to the side.  Returns numpy dicts (state, gbuffer) and the color."""
    rs = np.random.RandomState(seed)
    h, w = SV_H, SV_W
    cam = cam_at(1)
    basis = cam.basis()
    jy, jx = np.mgrid[0:h, 0:w].astype(np.float32)
    tan_half = np.tan(cam.fov_y / 2.0)
    cx = (jx / w * 2 - 1) * (w / h) * tan_half
    cy = (jy / h * 2 - 1) * tan_half
    dirs = (cx[..., None] * basis[0] + cy[..., None] * basis[1]
            + basis[2])
    depth = 5.0 + 0.5 * np.sin(jx * 0.2) + 0.3 * np.cos(jy * 0.15)
    world = np.asarray(cam.position) + dirs * depth[..., None]
    nrm = np.stack([0.2 * np.sin(jx * 0.1), 0.2 * np.cos(jy * 0.1),
                    -np.ones_like(jx)], -1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    hit = (rs.rand(h, w) > 0.1).astype(np.float32)
    f32 = lambda a: np.asarray(a, np.float32)
    gb = {"normal": f32(nrm * hit[..., None]),
          "depth": f32(depth * hit),
          "albedo": f32(np.where(hit[..., None] > 0, 0.7, 1.0)
                        * np.ones((h, w, 3))),
          "world_pos": f32(world * hit[..., None]),
          "hit": hit}
    ramp = lambda a, b: f32(a + b * np.sin(jx * 0.07 + jy * 0.05)[..., None])
    state = {"color": ramp(0.6, 0.3) * np.ones(3, np.float32),
             "moments": ramp(0.4, 0.1) * np.array([1.0, 0.5], np.float32),
             "history": ramp(3.0, 2.0),
             "depth": f32(depth[..., None] + 0.01),
             "normal": gb["normal"]}
    color = rs.uniform(0, 2, (h, w, 3)).astype(np.float32)
    return state, gb, color


def _both_cams(f: int):
    cfg = JRenderConfig(width=SV_W, height=SV_H)
    return (jcamera_arrays(cam_at(f, JCamera), cfg),
            renderer.camera_arrays(cam_at(f), RenderConfig(width=SV_W,
                                                           height=SV_H),
                                   "cpu"))


@pytest.mark.parametrize("stage", ["temporal_accumulate", "svgf"])
def test_svgf_step_matches_jax(stage):
    """rtol 1e-5 / atol 1e-6: XLA contracts FMAs and takes pow(., 128) and
    exp its own way; the history is smooth, so the warped values do not
    amplify last-ulp differences in the projected coordinates."""
    state, gb, color = _svgf_inputs()
    jcam, tcam = _both_cams(0)
    jst = jdenoise.DenoiseState(**{k: jnp.asarray(v)
                                   for k, v in state.items()})
    tst = denoise.DenoiseState(**{k: _t(v) for k, v in state.items()})
    jgb = {k: jnp.asarray(v) for k, v in gb.items()}
    tgb = {k: _t(v) for k, v in gb.items()}
    if stage == "svgf":
        jout, jnew = jax.jit(lambda *a: jdenoise.svgf(
            *a, SV_W, SV_H, pallas_warp=False))(jst, jnp.asarray(color), jgb,
                                                jcam)
        out, new = denoise.svgf(tst, _t(color), tgb, tcam, SV_W, SV_H)
        pairs = [("out", jout, out)]
    else:
        jill, jvar, jnew = jax.jit(lambda *a: jdenoise.temporal_accumulate(
            *a, SV_W, SV_H, pallas_warp=False))(jst, jnp.asarray(color),
                                                jgb, jcam)
        ill, var, new = denoise.temporal_accumulate(tst, _t(color), tgb,
                                                    tcam, SV_W, SV_H)
        pairs = [("illum", jill, ill), ("variance", jvar, var)]
    pairs += [(k, getattr(jnew, k), getattr(new, k))
              for k in denoise.DenoiseState._fields]
    valid_share = float((new.history > 1.5).float().mean())
    assert 0.5 < valid_share < 1.0       # some history reprojects, not all
    for name, a, b in pairs:
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


# ---- the upscaler nets -----------------------------------------------------

def flax_params(mode: str):
    """The trained flax parameters of `mode`, restored from the orbax
    checkpoint with the template of a fresh net."""
    create = (jupscaler.create_temporal if mode == "temporal"
              else jupscaler.create)
    return load_params(os.path.join(ROOT, "checkpoints",
                                    "upscaler_temporal" if mode == "temporal"
                                    else "upscaler"),
                       create()[1].params)


@pytest.fixture(scope="module")
def checkpoints():
    return {mode: flax_params(mode) for mode in ("spatial", "temporal")}


def committed_npz(mode: str) -> dict:
    name = "upscaler_temporal.npz" if mode == "temporal" else "upscaler.npz"
    with np.load(os.path.join(ROOT, "hrt_tpu_torch", "weights", name)) as d:
        return dict(d)


@pytest.mark.parametrize("mode", ["spatial", "temporal"])
def test_committed_weights_equal_the_checkpoint(checkpoints, mode):
    params = checkpoints[mode]["params"]
    d = committed_npz(mode)
    assert sorted(d) == sorted(f"{k}/{f}" for k in params
                               for f in ("kernel", "bias"))
    for key, arr in d.items():
        conv, field = key.split("/")
        want = np.asarray(params[conv][field])
        assert arr.dtype == np.float32 and arr.shape == want.shape
        np.testing.assert_array_equal(arr.view(np.int32),
                                      want.view(np.int32), err_msg=key)


@pytest.mark.parametrize("mode", ["spatial", "temporal"])
def test_upscaler_module_matches_jax(checkpoints, mode):
    """The committed trained weights, a 24x32 frame, float32: the module
    against flax's net.apply and against the JAX fast forward called
    directly.  atol 1e-5: conv sums run in another order.  This pins the
    pixel-shuffle channel order and the bilinear 2x upsample."""
    rs = np.random.RandomState(5)
    lr = rs.uniform(0, 2, (24, 32, 3)).astype(np.float32)
    hist = np.concatenate([rs.uniform(0, 2, (48, 64, 3)),
                           rs.rand(48, 64, 1) > 0.3], -1).astype(np.float32)
    params = jax.tree_util.tree_map(jnp.asarray, checkpoints[mode])
    net = upscaler.load_weights(mode, "cpu")
    if mode == "temporal":
        jnet = jupscaler.TemporalUpscalerNet()
        ref = jnet.apply(params, lr[None], hist[None])[0]
        fast = jupscaler._forward_temporal(params, jnp.asarray(lr),
                                           jnp.asarray(hist), 3,
                                           jnp.float32)
        out = net(_t(lr), _t(hist))
    else:
        jnet = jupscaler.UpscalerNet()
        ref = jnet.apply(params, lr[None])[0]
        fast = jupscaler._forward_spatial(params, jnp.asarray(lr), 3,
                                          jnp.float32)
        out = net(_t(lr))
    assert out.shape == (48, 64, 3)
    for want in (ref, fast):
        np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)
