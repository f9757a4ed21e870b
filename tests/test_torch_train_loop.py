"""The port's upscaler trainer (hrt_tpu_torch/train_upscaler.py) on the
CPU: one recurrent fine-tune step against scripts/train_upscaler.py's
own `recurrent_finetune` on the same parameters and sequence (a moving
camera over a wall of hits, as tests/test_upscaler.py's static-camera
test builds it); the history path's share of the gradient; and a tiny
end-to-end run of the trainer's functions and its spatial `main`,
writing `.npz` checkpoints that `load_params` accepts.  Inputs are made
with numpy from a seed and fed to both packages.
"""
import importlib.util
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hrt_tpu.config import RenderConfig as JRenderConfig
from hrt_tpu.models import upscaler as jupscaler
from hrt_tpu.models.camera import Camera as JCamera, primary_rays_p
from hrt_tpu.renderer import camera_arrays as jcamera_arrays
from hrt_tpu_torch import train_upscaler
from hrt_tpu_torch.models import upscaler
from hrt_tpu_torch.models.camera import CameraArrays
from hrt_tpu_torch.utils.checkpoint import load_params
from hrt_tpu_torch.utils.interop import (upscaler_from_numpy,
                                         upscaler_to_numpy)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.as_tensor(np.array(a))


def flax_numpy(params) -> dict:
    return {f"{k}/{f}": np.asarray(v[f])
            for k, v in params["params"].items() for f in ("kernel", "bias")}


def _jax_script():
    """scripts/train_upscaler.py as a module (it is a script, not a
    package member)."""
    spec = importlib.util.spec_from_file_location(
        "jax_train_upscaler", os.path.join(ROOT, "scripts",
                                           "train_upscaler.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _wall_sequence(n=3, h=16, w=16):
    """n frames of a camera moving right and turning, each frame's
    G-buffer a wall of hits at t = 3 along its own rays (a corner of
    misses), random noisy LR frames and clean HR targets.  Returns the
    JAX sequence and the port's (the same numbers)."""
    rs = np.random.RandomState(11)
    cfg = JRenderConfig(width=w, height=h)
    wps, cams = [], []
    for f in range(n):
        cam = jcamera_arrays(JCamera(position=(0.08 * f, -1.0, -5.0),
                                     rotation=(0.0, 0.01 * f, 0.0)), cfg)
        o, d = primary_rays_p(cam.origin, cam.basis, cam.tan_half_fovy,
                              cam.aspect, w, h)
        wps.append(np.stack([np.asarray(o.x + d.x * 3.0).reshape(h, w),
                             np.asarray(o.y + d.y * 3.0).reshape(h, w),
                             np.asarray(o.z + d.z * 3.0).reshape(h, w)],
                            -1))
        cams.append(cam)
    wps = np.stack(wps).astype(np.float32)
    hits = np.ones((n, h, w), np.float32)
    hits[:, :4, :5] = 0.0
    lrs = rs.uniform(0, 1.5, (n, h, w, 3)).astype(np.float32)
    cleans = rs.uniform(0, 1.5, (n, 2 * h, 2 * w, 3)).astype(np.float32)
    jseq = (jnp.asarray(lrs), jnp.asarray(wps), jnp.asarray(hits), cams,
            jnp.asarray(cleans))
    tcams = [CameraArrays(*(_t(np.asarray(a)) for a in c)) for c in cams]
    tseq = (_t(lrs), _t(wps), _t(hits), tcams, _t(cleans))
    return jseq, tseq


def _jax_recurrent_loss(net, params, lrs, wps, hits, cams, cleans):
    """The loss scripts/train_upscaler.py's `seq_step` differentiates,
    evaluated eagerly."""
    h2, w2 = cleans.shape[1], cleans.shape[2]
    tm = lambda x: x / (1.0 + jnp.abs(x))
    hist = jnp.zeros((h2, w2, 3), jnp.float32)
    total = 0.0
    for t in range(lrs.shape[0]):
        warped = (jnp.zeros((h2, w2, 4), jnp.float32) if t == 0 else
                  jupscaler.reproject_history(hist, wps[t], hits[t],
                                              cams[t - 1], w2 // 2, h2 // 2))
        pred = net.apply(params, lrs[t][None], warped[None])[0]
        diff = tm(pred) - tm(cleans[t])
        total = total + jnp.mean(jnp.sqrt(diff * diff + 1e-6))
        hist = pred
    return total / lrs.shape[0]


def test_recurrent_step_matches_jax_script(capsys):
    """recurrent_finetune(..., steps=1) of both on a 3-frame 16x16 ->
    32x32 sequence from JAX's initial temporal net: the loss within rtol
    1e-5 (and the JAX script's printed loss to its 5 decimals), each
    gradient (the port's against the script's first Adam moment / 0.1)
    within 1e-4 of its tensor's largest entry, the parameters after the
    step within atol 1e-5.  Measured: loss rel err 2.9e-7, gradients
    7.5e-7 of their largest entry, parameters 1.1e-6."""
    jseq, tseq = _wall_sequence()
    jnet, jstate, tx = jupscaler.create_temporal(lr=2e-3)
    jloss = float(_jax_recurrent_loss(jnet, jstate.params, *jseq))
    jnew = _jax_script().recurrent_finetune(jnet, jstate, tx, [jseq], 1)
    printed = float(capsys.readouterr().out.split("loss ")[1].split()[0])
    assert abs(printed - jloss) <= 5e-6

    params = flax_numpy(jstate.params)
    net = upscaler_from_numpy(params, True, "cpu")
    net.requires_grad_(True).train()
    loss = train_upscaler.recurrent_loss(net, *tseq)
    loss.backward()
    assert abs(float(loss.detach()) - jloss) <= 1e-5 * abs(jloss)
    mu = flax_numpy({"params": jnew.opt_state[0].mu["params"]})
    grad_err = 0.0
    for name, conv in net.named_children():
        for key, g in ((f"{name}/kernel", conv.weight.grad.permute(2, 3, 1,
                                                                    0)),
                       (f"{name}/bias", conv.bias.grad)):
            ref = mu[key] / np.float32(1 - 0.9)
            err = float(np.abs(g.numpy() - ref).max() / np.abs(ref).max())
            grad_err = max(grad_err, err)
            assert err <= 1e-4, (key, err)

    net = upscaler_from_numpy(params, True, "cpu")
    net.requires_grad_(True).train()
    losses = train_upscaler.recurrent_finetune(
        net, upscaler.adam(net, 2e-3), [tseq], 1)
    assert len(losses) == 1
    assert abs(losses[0] - jloss) <= 1e-5 * abs(jloss)
    after, ref = upscaler_to_numpy(net), flax_numpy(jnew.params)
    param_err = max(float(np.abs(after[k] - ref[k]).max()) for k in ref)
    assert param_err <= 1e-5
    print("recurrent step errors (loss rel, grad rel, param abs):",
          abs(losses[0] - jloss) / jloss, grad_err, param_err)


def test_recurrent_gradient_flows_through_the_warp(monkeypatch):
    """The history path carries gradient: with the warped history
    detached, the recurrent loss is the same but its gradient differs."""
    _, tseq = _wall_sequence()
    net, _ = upscaler.create_temporal(seed=2, device="cpu")

    def grads():
        net.zero_grad(set_to_none=True)
        loss = train_upscaler.recurrent_loss(net, *tseq)
        loss.backward()
        return float(loss.detach()), [p.grad.clone()
                                      for p in net.parameters()]

    loss, full = grads()
    orig = upscaler.reproject_history
    monkeypatch.setattr(upscaler, "reproject_history",
                        lambda hist, *a, **k: orig(hist.detach(), *a, **k))
    loss_d, cut = grads()
    assert loss_d == loss
    rel = max(float((a - b).abs().max() / a.abs().max())
              for a, b in zip(full, cut))
    assert rel > 1e-3, rel


def test_trainer_functions_end_to_end(tmp_path):
    """A tiny run of the trainer's functions on the CPU (the plain
    versions): training frames and a 3-frame bench sequence rendered at
    32x32, temporal triples, crops, one spatial and one temporal step,
    one recurrent step, the held-out PSNR, and `.npz` checkpoints that
    load_params accepts and that give the trained nets back bit for
    bit."""
    frames = train_upscaler.render_training_frames(2, size=(32, 32),
                                                   device="cpu")
    assert frames.shape == (2, 32, 32, 3)
    assert bool(frames.isfinite().all()) and float(frames.max()) > 0
    net_s, opt_s = upscaler.create(lr=2e-3, device="cpu")
    gen = torch.Generator().manual_seed(0)
    lr_b, hr_b = upscaler.self_supervised_batch(frames, gen, crop=16,
                                                batch=2)
    assert lr_b.shape == (2, 8, 8, 3) and hr_b.shape == (2, 16, 16, 3)
    assert np.isfinite(float(upscaler.train_step(net_s, opt_s, lr_b, hr_b)))

    seq = train_upscaler.render_sequence(3, size=(32, 32), clean_spp=1,
                                         device="cpu")
    lrs, wps, hits, cams, cleans = seq
    assert lrs.shape == (3, 16, 16, 3) and wps.shape == (3, 16, 16, 3)
    assert hits.shape == (3, 16, 16) and cleans.shape == (3, 32, 32, 3)
    assert len(cams) == 3 and 0 < float(hits.mean()) < 1
    lr, hist, hr = train_upscaler.temporal_triples(*seq)
    assert lr.shape == (2, 16, 16, 3) and hist.shape == (2, 32, 32, 4) \
        and hr.shape == (2, 32, 32, 3)
    assert float(hist[..., 3].mean()) > 0.3
    net, opt = upscaler.create_temporal(lr=2e-3, device="cpu")
    gen = torch.Generator().manual_seed(1)
    lr_b, hist_b, hr_b = train_upscaler.crops(gen, lr, hist, hr, crop=8,
                                              batch=2)
    assert np.isfinite(float(upscaler.train_step_temporal(
        net, opt, lr_b, hist_b, hr_b)))
    losses = train_upscaler.recurrent_finetune(net, opt, [seq], 1)
    assert len(losses) == 1 and np.isfinite(losses[0])
    psnrs = train_upscaler.eval_temporal(net, net_s, *seq)
    assert all(np.isfinite(p) and p > 0 for p in psnrs)

    for trained, temporal in ((net_s, False), (net, True)):
        path = train_upscaler.save_checkpoint(
            trained, str(tmp_path / "ck" / f"{temporal}.npz"))
        template = upscaler_to_numpy(
            upscaler.TemporalUpscalerNet() if temporal
            else upscaler.UpscalerNet())
        back = upscaler_from_numpy(load_params(path, template), temporal,
                                   "cpu")
        args = (lrs[1], hist[0]) if temporal else (lrs[1],)
        with torch.no_grad():
            assert torch.equal(back(*args), trained(*args))


def test_trainer_main_spatial(tmp_path, monkeypatch):
    """`main` in spatial mode on the CPU (its frames rendered at 64x64
    here): it trains, writes the `.npz` it names, and returns the
    losses."""
    orig = train_upscaler.render_training_frames
    monkeypatch.setattr(train_upscaler, "render_training_frames",
                        lambda n, **kw: orig(n, size=(64, 64), **kw))
    out = str(tmp_path / "up.npz")
    res = train_upscaler.main(["--steps", "3", "--frames", "2", "--out",
                               out, "--device", "cpu"])
    assert res["out"] == out and len(res["losses"]) == 3
    params = load_params(out, upscaler_to_numpy(upscaler.UpscalerNet()))
    assert all(np.array_equal(params[k], v)
               for k, v in upscaler_to_numpy(res["net"]).items())


def test_checkpoints_never_touch_committed_or_jax_names(tmp_path,
                                                       monkeypatch):
    """The default names differ from the JAX package's orbax directories;
    the committed weights' directory is refused; the held-out spatial
    net is SPATIAL_CKPT when it exists, the committed weights when it
    does not, and a malformed file raises."""
    for name in (train_upscaler.SPATIAL_CKPT, train_upscaler.TEMPORAL_CKPT):
        assert name.endswith(".npz") and os.path.splitext(name)[0] not in (
            os.path.join("checkpoints", "upscaler"),
            os.path.join("checkpoints", "upscaler_temporal"))
    net, _ = upscaler.create(device="cpu")
    with pytest.raises(ValueError, match="committed"):
        train_upscaler.save_checkpoint(
            net, os.path.join(upscaler.WEIGHTS_DIR, "upscaler.npz"))
    monkeypatch.chdir(tmp_path)
    committed = upscaler.load_weights("spatial", "cpu")
    got = train_upscaler.load_spatial("cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(got.state_dict().values(),
                   committed.state_dict().values()))
    train_upscaler.save_checkpoint(net, train_upscaler.SPATIAL_CKPT)
    got = train_upscaler.load_spatial("cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(got.state_dict().values(), net.state_dict().values()))
    temporal, _ = upscaler.create_temporal(device="cpu")
    train_upscaler.save_checkpoint(temporal, train_upscaler.SPATIAL_CKPT)
    with pytest.raises(ValueError):
        train_upscaler.load_spatial("cpu")
