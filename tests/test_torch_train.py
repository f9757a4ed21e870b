"""The upscaler's training half in hrt_tpu_torch against the JAX package,
on the CPU: `downsample2`; the warp's gradient with respect to the
image against `jax.grad` of `_bilinear`; one spatial and one temporal
train step (loss, gradients, the parameters after one Adam step) on the
same parameters and batch; the nets' initialisation against flax's; a
batch against single frames; the parameters' round trip through
`.npz`; the trainer's history corruption and crops; and the port's
twins of tests/test_upscaler.py's loss-reduction tests.  Inputs are
made with numpy from a seed and fed to both packages; JAX's parameters
come over through utils/interop, since `jax.random` cannot be
reproduced.  The recurrent step and the trainer's end-to-end run are in
test_torch_train_loop.py.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hrt_tpu.models import upscaler as jupscaler
from hrt_tpu.ops import denoise as jdenoise
from hrt_tpu_torch import train_upscaler
from hrt_tpu_torch.models import upscaler
from hrt_tpu_torch.ops import warp_kernel
from hrt_tpu_torch.utils.checkpoint import load_params, save_params
from hrt_tpu_torch.utils.interop import (upscaler_from_numpy,
                                         upscaler_to_numpy)


def _t(a):
    return torch.as_tensor(np.array(a))


def flax_numpy(params) -> dict:
    """JAX parameters as the flax-keyed numpy dict interop reads."""
    return {f"{k}/{f}": np.asarray(v[f])
            for k, v in params["params"].items() for f in ("kernel", "bias")}


def grads_numpy(net) -> dict:
    """The port's parameter gradients in the flax-keyed layout."""
    return {**{f"{n}/kernel": c.weight.grad.permute(2, 3, 1, 0).numpy()
               for n, c in net.named_children()},
            **{f"{n}/bias": c.bias.grad.numpy()
               for n, c in net.named_children()}}


@pytest.fixture(scope="module")
def jax_nets():
    """JAX's spatial and temporal nets at lr 2e-3 (the trainer's)."""
    return (jupscaler.create(lr=2e-3),
            jupscaler.create_temporal(lr=2e-3))


def test_downsample2_equals_jax():
    x = np.random.RandomState(0).uniform(-2, 5, (3, 16, 24, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(
        upscaler.downsample2(_t(x)).numpy(),
        np.asarray(jupscaler.downsample2(jnp.asarray(x))))
    # One frame, as the JAX test's (4, 4, 3) ramp.
    ramp = np.arange(48, dtype=np.float32).reshape(4, 4, 3)
    np.testing.assert_array_equal(
        upscaler.downsample2(_t(ramp)).numpy(),
        np.asarray(jupscaler.downsample2(jnp.asarray(ramp))))


def _edge_coords(seed, hs, ws, ho, wo):
    """Coordinates over the image and past it: exact edges (0, W-1,
    H-1, and integers on them), a band a few pixels outside, and
    +-1e10 as the projection gives where it clamps depth."""
    rs = np.random.RandomState(seed)
    jy, jx = np.mgrid[0:ho, 0:wo].astype(np.float32)
    px = (jx * (ws + 5) / (wo - 1) - 3 + rs.uniform(-0.5, 0.5, (ho, wo)))
    py = (jy * (hs + 5) / (ho - 1) - 3 + rs.uniform(-0.5, 0.5, (ho, wo)))
    px, py = px.astype(np.float32), py.astype(np.float32)
    px[0, :], py[:, 0] = 0.0, 0.0
    px[1, :], py[:, 1] = ws - 1.0, hs - 1.0
    px[2, ::3] = np.float32(ws - 1) - 0.25
    far = rs.rand(ho, wo) < 0.05
    px[far] = rs.choice([-1e10, 1e10], far.sum())
    py[rs.rand(ho, wo) < 0.05] = 1e10
    return px, py


@pytest.mark.parametrize("c", [1, 3, 10])
def test_warp_image_gradient_matches_jax(c):
    """The gradient of <grad_val, warp(img)> with respect to img through
    the port's warp (on the CPU: autograd of the plain version) against
    jax.grad of `_bilinear`, with coordinates on the edges, outside the
    image and at +-1e10: clamped taps that coincide take every add.
    atol 1e-6 (measured 0 to 1.2e-7: the four weighted adds of a tap
    are summed in another order)."""
    rs = np.random.RandomState(c)
    img = rs.uniform(-1, 1, (13, 17, c)).astype(np.float32)
    px, py = _edge_coords(c, 13, 17, 24, 31)
    gv = rs.normal(0, 1, (24, 31, c)).astype(np.float32)
    jgrad = jax.grad(lambda im: jnp.sum(
        jdenoise._bilinear(im, jnp.asarray(px), jnp.asarray(py))[0]
        * jnp.asarray(gv)))(jnp.asarray(img))
    ti = _t(img).requires_grad_(True)
    val, valid = warp_kernel.warp_bilinear(ti, _t(px), _t(py))
    assert not valid.requires_grad
    (g,) = torch.autograd.grad(val, ti, _t(gv))
    np.testing.assert_allclose(g.numpy(), np.asarray(jgrad), rtol=0,
                               atol=1e-6)
    # Every edge tap took its adds: the corners' gradients are not 0.
    assert np.abs(np.asarray(jgrad)[[0, 0, -1, -1], [0, -1, 0, -1]]).min() \
        > 0


def test_warp_image_gradient_special_values_match_jax():
    """The adjoint K6's backward is held to, on special gradients: an
    all-zero gradient gives +0 everywhere, bit for bit, in both packages
    (K6's backward drops exact-zero products and relies on it), and NaN,
    +Inf and -Inf at clamped, coincident and inner pixels land on the
    same elements of both (NaN x a zero weight is NaN, Inf + -Inf is
    NaN); the finite rest within atol 1e-6."""
    rs = np.random.RandomState(5)
    img = rs.uniform(-1, 1, (13, 17, 3)).astype(np.float32)
    px, py = _edge_coords(3, 13, 17, 24, 31)
    far = np.argwhere(np.abs(px) > 1e9)
    gv = rs.normal(0, 1, (24, 31, 3)).astype(np.float32)
    gv[tuple(far[0])][0] = np.nan
    gv[tuple(far[1])][1] = np.inf
    gv[0, 0, 2] = -np.inf
    gv[11, 12] = [np.inf, -np.inf, np.nan]
    for grad in (np.zeros_like(gv), gv):
        jgrad = np.asarray(jax.grad(lambda im: jnp.sum(
            jdenoise._bilinear(im, jnp.asarray(px), jnp.asarray(py))[0]
            * jnp.asarray(grad)))(jnp.asarray(img)))
        ti = _t(img).requires_grad_(True)
        val = warp_kernel.warp_bilinear(ti, _t(px), _t(py))[0]
        (g,) = torch.autograd.grad(val, ti, _t(grad))
        g = g.numpy()
        if not grad.any():
            assert (g.view(np.int32) == 0).all()
            assert (jgrad.view(np.int32) == 0).all()
            continue
        for where in (np.isnan, np.isposinf, np.isneginf):
            np.testing.assert_array_equal(where(g), where(jgrad))
        fin = np.isfinite(jgrad)
        assert 0 < (~fin).sum() < fin.sum()
        np.testing.assert_allclose(g[fin], jgrad[fin], rtol=0, atol=1e-6)


def test_k6_backward_probe_helpers():
    """scripts/torch_k6_backward_probe.py, whose helpers chip_smoke.py's
    phase 39 runs: every design it builds by substitution finds its text
    in csrc/warp_bilinear.cu once, and on the CPU `with_special_values`
    puts NaN and +Inf at a sky and an off-image pixel, which `compare`
    finds where the plain adjoint has them."""
    import importlib.util
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "torch_k6_backward_probe",
        os.path.join(root, "scripts", "torch_k6_backward_probe.py"))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    with open(os.path.join(root, "hrt_tpu_torch", "csrc",
                           "warp_bilinear.cu")) as f:
        src = f.read()
    for subs in (*probe.VARIANTS.values(), *probe.ABLATIONS.values()):
        for old, _ in subs:
            assert src.count(old) == 1, old
    rs = np.random.RandomState(9)
    hs, ws = 20, 24
    px = _t(rs.uniform(-3, ws + 2, (hs, ws)).astype(np.float32))
    py = _t(rs.uniform(0, hs - 1, (hs, ws)).astype(np.float32))
    hit = _t((rs.rand(hs, ws) < 0.7).astype(np.float32))
    gv = _t(rs.normal(0, 1, (hs, ws, 3)).astype(np.float32))
    sg, spx, spy, (sky, off) = probe.with_special_values(gv, px, py, hit,
                                                         hs, ws)
    assert hit.view(-1)[sky] < 0.5 and not 0 <= spx.view(-1)[off] <= ws - 1
    row = sg.view(-1, 3)
    assert torch.isnan(row[[sky, off], 0]).all()
    assert torch.isposinf(row[[sky, off], 1]).all()
    cmp = probe.compare(probe.plain_adjoint(sg, spx, spy, hs, ws), sg, spx,
                        spy, hs, ws)
    assert cmp["nonfinite_match"] and cmp["rel"] == 0.0
    assert cmp["nonfinite"] > 0


def test_warp_coordinates_get_no_gradient():
    img = torch.rand(8, 9, 3)
    px = torch.rand(4, 5).requires_grad_(True)
    with pytest.raises(ValueError, match="no gradient"):
        warp_kernel.warp_bilinear(img, px, torch.rand(4, 5))
    with pytest.raises(ValueError, match="no gradient"):
        warp_kernel.warp_bilinear(img, torch.rand(4, 5), px)


def _check_step(jnet, jstate, tx, jstep, jloss_fn, temporal, batch):
    """One train step of both packages on the same parameters and batch:
    the loss (rtol 1e-5), each gradient (within 1e-4 of its tensor's
    largest entry) and the parameters after one Adam step (atol 1e-5).
    Returns the measured (loss rel, grad rel, param abs) errors."""
    jb = [jnp.asarray(b) for b in batch]
    jl, jg = jax.value_and_grad(jloss_fn)(jstate.params, jnet, *jb)
    jnew, jl2 = jstep(jstate, jnet, tx, *jb)
    assert float(jl2) == float(jl)
    params = flax_numpy(jstate.params)
    net = upscaler_from_numpy(params, temporal, "cpu")
    net.requires_grad_(True).train()
    tb = [_t(b) for b in batch]
    loss_fn = upscaler._loss_fn_temporal if temporal else upscaler._loss_fn
    loss = loss_fn(net, *tb)
    loss.backward()
    loss_rel = abs(float(loss.detach()) - float(jl)) / abs(float(jl))
    assert loss_rel <= 1e-5, (float(loss.detach()), float(jl))
    grad_rel = 0.0
    for k, g in grads_numpy(net).items():
        ref = flax_numpy({"params": jg["params"]})[k]
        err = float(np.abs(g - ref).max() / np.abs(ref).max())
        grad_rel = max(grad_rel, err)
        assert err <= 1e-4, (k, err)
    net = upscaler_from_numpy(params, temporal, "cpu")
    net.requires_grad_(True).train()
    step = upscaler.train_step_temporal if temporal else upscaler.train_step
    loss2 = step(net, upscaler.adam(net, 2e-3), *tb)
    assert float(loss2) == float(loss.detach())
    after = upscaler_to_numpy(net)
    ref = flax_numpy(jnew.params)
    param_abs = max(float(np.abs(after[k] - ref[k]).max()) for k in ref)
    assert param_abs <= 1e-5
    # The step moved every tensor by ~lr.
    assert all(np.abs(after[k] - params[k]).max() > 1e-3 for k in ref)
    return loss_rel, grad_rel, param_abs


def test_train_step_matches_jax(jax_nets):
    """Spatial: 4 random 16x16 -> 32x32 pairs.  Measured: loss rel err
    6.8e-7, gradients 7.5e-7 of their largest entry, parameters after
    the step 3.0e-7 (float32 convolutions summed in other orders)."""
    net, state, tx = jax_nets[0]
    rs = np.random.RandomState(5)
    hr = rs.uniform(0, 2, (4, 32, 32, 3)).astype(np.float32)
    lr = hr.reshape(4, 16, 2, 16, 2, 3).mean((2, 4)) + rs.normal(
        0, 0.05, (4, 16, 16, 3)).astype(np.float32)
    errs = _check_step(net, state, tx, jupscaler.train_step,
                       jupscaler._loss_fn, False, (lr, hr))
    print("spatial step errors (loss rel, grad rel, param abs):", errs)


def test_temporal_train_step_matches_jax(jax_nets):
    """Temporal: 4 random triples with a partly valid history.
    Measured: loss rel err 9.4e-7, gradients 8.3e-7 of their largest
    entry, parameters after the step 1.0e-6."""
    net, state, tx = jax_nets[1]
    rs = np.random.RandomState(6)
    hr = rs.uniform(0, 2, (4, 32, 32, 3)).astype(np.float32)
    lr = hr.reshape(4, 16, 2, 16, 2, 3).mean((2, 4)).astype(np.float32)
    hist = np.concatenate(
        [hr * rs.uniform(0.8, 1.2, hr.shape),
         (rs.rand(4, 32, 32, 1) < 0.7)], -1).astype(np.float32)
    hist[..., :3] *= hist[..., 3:]
    errs = _check_step(net, state, tx, jupscaler.train_step_temporal,
                       jupscaler._loss_fn_temporal, True, (lr, hist, hr))
    print("temporal step errors (loss rel, grad rel, param abs):", errs)


@pytest.mark.parametrize("temporal", [False, True])
def test_init_matches_flax(jax_nets, temporal):
    """create / create_temporal: the names and shapes of JAX's parameter
    tree, zero biases, and kernels drawn as flax's lecun_normal: within
    +-2 std of the untruncated normal, and an std of sqrt(1 / fan_in)
    within 6% (the 12-output head has 3,456 draws; JAX's own init is
    held to the same)."""
    jstate = jax_nets[1 if temporal else 0][1]
    ref = flax_numpy(jstate.params)
    make = upscaler.create_temporal if temporal else upscaler.create
    net, opt = make(seed=3, device="cpu")
    got = upscaler_to_numpy(net)
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in ref.items()}
    assert isinstance(opt, upscaler.Adam)
    assert opt.betas == (0.9, 0.999) and opt.eps == 1e-8 and opt.lr == 1e-3
    assert int(opt.count) == 0 and not any(m.any() for m in opt.mu + opt.nu)
    assert all(p.grad is g for p, g in zip(net.parameters(), opt.grads))
    for k in ref:
        if k.endswith("bias"):
            assert not got[k].any()
            continue
        fan_in = np.prod(got[k].shape[:3])
        std = np.sqrt(1.0 / fan_in)
        for w in (got[k], ref[k]):
            assert np.abs(w).max() <= 2 * std / 0.87962566103423978 + 1e-7
            assert abs(w.std() / std - 1) < 0.06, (k, w.std() / std)
    # A seed gives one net; another seed another.
    again = upscaler_to_numpy(make(seed=3, device="cpu")[0])
    other = upscaler_to_numpy(make(seed=4, device="cpu")[0])
    assert all(np.array_equal(got[k], again[k]) for k in got)
    assert not np.array_equal(got["Conv_0/kernel"], other["Conv_0/kernel"])


@pytest.mark.parametrize("temporal", [False, True])
def test_batch_equals_single_frames(temporal):
    """The nets on a (3, h, w, c) batch equal three single-frame calls
    (the frame loop's form) in float32, and with the bf16 trunk."""
    net = upscaler.load_weights("temporal" if temporal else "spatial",
                                "cpu")
    rs = np.random.RandomState(9)
    lr = _t(rs.uniform(0, 2, (3, 12, 20, 3)).astype(np.float32))
    hist = _t(rs.uniform(0, 1, (3, 24, 40, 4)).astype(np.float32))
    args = (lambda i: (lr[i], hist[i])) if temporal else (lambda i: (lr[i],))
    for dtype in (torch.float32, torch.bfloat16):
        whole = net(*args(slice(None)), dtype=dtype)
        one = torch.stack([net(*args(i), dtype=dtype) for i in range(3)])
        assert whole.shape == (3, 24, 40, 3)
        np.testing.assert_allclose(whole.numpy(), one.numpy(), rtol=0,
                                   atol=1e-6)


def test_interop_round_trip_bit_exact(jax_nets, tmp_path):
    """JAX's parameters -> port net -> numpy are the same bits; a trained
    port net -> save_params -> load_params -> upscaler_from_numpy gives
    the same parameters and output bit for bit; the net comes frozen (no
    gradients) and `.requires_grad_(True).train()` makes it trainable."""
    ref = flax_numpy(jax_nets[1][1].params)
    net = upscaler_from_numpy(ref, True, "cpu")
    net.requires_grad_(True).train()
    assert all(p.requires_grad for p in net.parameters()) and net.training
    back = upscaler_to_numpy(net)
    assert all(np.array_equal(back[k], ref[k]) for k in ref)
    frozen = upscaler_from_numpy(ref, True, "cpu")
    assert not any(p.requires_grad for p in frozen.parameters())
    net, opt = upscaler.create(seed=1, device="cpu")
    rs = np.random.RandomState(2)
    hr = _t(rs.uniform(0, 1, (2, 16, 16, 3)).astype(np.float32))
    upscaler.train_step(net, opt, upscaler.downsample2(hr), hr)
    path = str(tmp_path / "up.npz")
    save_params(path, upscaler_to_numpy(net))
    loaded = upscaler_from_numpy(
        load_params(path, upscaler_to_numpy(upscaler.UpscalerNet())), False,
        "cpu")
    for (k, a), b in zip(net.state_dict().items(),
                         loaded.state_dict().values()):
        assert torch.equal(a, b), k
    x = _t(rs.uniform(0, 2, (10, 14, 3)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(net(x), loaded(x))


def test_corrupt_history_structure():
    """_corrupt_history on 32 valid histories: some samples all zero;
    elsewhere the dropped pixels form whole 16x16 blocks in which rgb
    and validity are both 0, and kept pixels carry validity 1 and rgb
    within 6 std of the 5% noise."""
    rs = np.random.RandomState(3)
    b, h, w = 32, 64, 48
    rgb = rs.uniform(0.5, 1.5, (b, h, w, 3)).astype(np.float32)
    hist = _t(np.concatenate([rgb, np.ones((b, h, w, 1), np.float32)], -1))
    out = train_upscaler._corrupt_history(
        hist, torch.Generator().manual_seed(0)).numpy()
    zeroed = [i for i in range(b) if not out[i].any()]
    assert 0 < len(zeroed) < b
    dropped_blocks = 0
    for i in set(range(b)) - set(zeroed):
        valid = out[i, ..., 3]
        assert set(np.unique(valid)) <= {0.0, 1.0}
        blocks = valid.reshape(h // 16, 16, w // 16, 16)
        per_block = blocks.min((1, 3))
        assert np.array_equal(per_block, blocks.max((1, 3)))
        dropped_blocks += int((per_block == 0).sum())
        assert not out[i, valid == 0, :3].any()
        ratio = out[i, valid == 1, :3] / rgb[i, valid == 1]
        assert np.abs(ratio - 1).max() < 0.3
        # One noise value per pixel, shared by its three channels.
        np.testing.assert_allclose(ratio[:, 0], ratio[:, 2], rtol=1e-6)
    assert dropped_blocks > 0


def test_crops_structure():
    """crops: LR crops of `crop` px at (f, y, x); the history and target
    crops of 2 * crop px at (f, 2y, 2x) of the same frame."""
    f, h, w = 5, 20, 24
    fy, yy, xx = np.meshgrid(np.arange(f), np.arange(2 * h),
                             np.arange(2 * w), indexing="ij")
    hr = np.stack([fy, yy, xx], -1).astype(np.float32)
    lr = hr[:, ::2, ::2] * np.float32([1, 0.5, 0.5])
    hist = np.concatenate([hr + 1.0, np.ones_like(hr[..., :1])], -1)
    gen = torch.Generator().manual_seed(7)
    lc, hc, rc = train_upscaler.crops(gen, _t(lr), _t(hist), _t(hr),
                                      crop=8, batch=8)
    assert lc.shape == (8, 8, 8, 3) and hc.shape == (8, 16, 16, 4) \
        and rc.shape == (8, 16, 16, 3)
    for b in range(8):
        fi, y0, x0 = (int(v) for v in lc[b, 0, 0])
        assert torch.equal(lc[b], _t(lr[fi, y0:y0 + 8, x0:x0 + 8]))
        assert torch.equal(rc[b], _t(hr[fi, 2 * y0:2 * y0 + 16,
                                        2 * x0:2 * x0 + 16]))
        kept = hc[b, ..., 3] > 0
        if kept.any():
            ratio = hc[b, ..., :3][kept] / (rc[b][kept] + 1.0)
            assert float((ratio - 1).abs().max()) < 0.3


def _frames():
    """tests/test_upscaler.py's learnable frames: smooth gradients and a
    checkerboard, with a little noise."""
    rs = np.random.RandomState(1)
    frames = np.zeros((2, 64, 64, 3), np.float32)
    ys, xs = np.meshgrid(np.arange(64), np.arange(64), indexing="ij")
    frames[0, ..., 0] = xs / 64.0
    frames[0, ..., 1] = ys / 64.0
    frames[1, ..., 2] = ((xs // 8 + ys // 8) % 2).astype(np.float32)
    return _t(frames + rs.normal(0, 0.01, frames.shape).astype(np.float32))


def test_train_step_reduces_loss():
    """The port's twin of tests/test_upscaler.py's: 30 steps at lr 3e-3
    on 32-px crops, batch 4, cut the loss by 20%."""
    net, opt = upscaler.create(lr=3e-3, device="cpu")
    frames = _frames()
    gen = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(30):
        lr_b, hr_b = upscaler.self_supervised_batch(frames, gen, crop=32,
                                                    batch=4)
        losses.append(float(upscaler.train_step(net, opt, lr_b, hr_b)))
    assert losses[-1] < losses[0] * 0.8, losses[:3] + losses[-3:]


def test_temporal_train_step_reduces_loss():
    """The port's twin: with history == ground truth, 30 steps at lr
    3e-3 halve the loss (alpha -> 1)."""
    net, opt = upscaler.create_temporal(lr=3e-3, device="cpu")
    rs = np.random.RandomState(3)
    hr = _t(rs.uniform(0, 1, (4, 64, 64, 3)).astype(np.float32))
    hist = torch.cat([hr, torch.ones(hr.shape[:-1] + (1,))], -1)
    lr_b = upscaler.downsample2(hr)
    noisy_lr = lr_b + 0.1 * _t(rs.normal(0, 1, lr_b.shape)
                                .astype(np.float32))
    losses = [float(upscaler.train_step_temporal(net, opt, noisy_lr, hist,
                                                 hr)) for _ in range(30)]
    assert losses[-1] < losses[0] * 0.5, losses[:3] + losses[-3:]
