"""Train the learned 2x upscalers on self-supervised rendered frames
(scripts/train_upscaler.py, ported).

    python -m hrt_tpu_torch.train_upscaler [--steps 300] [--frames 4]
    python -m hrt_tpu_torch.train_upscaler --temporal [--steps 600]
    python -m hrt_tpu_torch.train_upscaler ... --device cpu  # plain versions

Spatial mode (default): renders a few path-traced 256x256 frames of the
bench scene and the Cornell box through FrameLoop, and trains the
residual CNN (models/upscaler.py) to reconstruct 64-px HR crops from
their 2x downsamples (batch 8, Adam at lr 2e-3).

Temporal mode (--temporal): renders 16-frame orbit sequences of both
scenes (noisy 1-spp 128x128 frames with their G-buffers and cameras,
clean 8-spp 256x256 targets), builds (current LR, reprojected previous
clean HR, target HR) triples with history-corruption augmentation, then
fine-tunes on the full sequences run recurrently (the net's own
previous output warped by the real G-buffer motion, through K6 and, for
the gradient, its adjoint), and reports the held-out PSNR of temporal
vs spatial vs bilinear on another orbit phase.

Every frame is rendered here from the scenes in the repository; nothing
is downloaded.  Checkpoints are `.npz` files of the flax-keyed
parameters (utils/checkpoint.save_params of utils/interop.
upscaler_to_numpy), by default `checkpoints/upscaler_torch.npz` and
`checkpoints/upscaler_temporal_torch.npz` under the working directory,
beside the JAX package's orbax directories; the render command reads
them with `--upscaler-ckpt`.  The committed `hrt_tpu_torch/weights/` are
never written.  The temporal mode's held-out comparison takes the
spatial net from `checkpoints/upscaler_torch.npz` when it exists and
from the committed spatial weights otherwise (a malformed file raises).

The JAX script's `jax.random` keys become `torch.Generator`s on the CPU,
so a seed draws the same crops and corruption on every device.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .config import RenderConfig, resolve_device
from .frameloop import FrameLoop
from .models import upscaler
from .models.camera import orbit_camera
from .models.scene import bench_scene
from .models.scenefile import cornell_box
from .ops import lbvh
from .renderer import camera_arrays, render_rows
from .utils.checkpoint import load_params, save_params
from .utils.interop import upscaler_from_numpy, upscaler_to_numpy

SPATIAL_CKPT = os.path.join("checkpoints", "upscaler_torch.npz")
TEMPORAL_CKPT = os.path.join("checkpoints", "upscaler_temporal_torch.npz")


def _scene(kind: str):
    """(scene, orbit radius, orbit height) of the bench scene or the
    Cornell box."""
    if kind == "bench":
        return bench_scene(), 6.0, -1.5
    return cornell_box(), 2.8, 0.0


def render_training_frames(n_frames: int, size=(256, 256), device=None):
    """(n_frames, H, W, 3): n_frames // 2 path-traced orbit frames of
    each scene, through FrameLoop (no culling)."""
    dev = resolve_device(device)
    frames = []
    for kind in ("bench", "cornell"):
        scene_obj, radius, height = _scene(kind)
        cfg = RenderConfig(width=size[0], height=size[1], max_depth=3,
                           indirect=True, jitter=True, sky=True,
                           traversal="pallas")
        loop = FrameLoop(scene_obj, cfg, cull_threshold_px=0.0, device=dev)
        for f in range(n_frames // 2):
            cam = orbit_camera(0.4 * f, radius=radius, height=height)
            frames.append(loop.step(cam))
    return torch.stack(frames)


def render_sequence(n_frames: int, size=(256, 256), scene_kind="bench",
                    phase=0.0, step=0.06, clean_spp: int = 8, device=None):
    """Orbit sequence mirroring the inference condition of the temporal
    mode: NOISY 1-spp frames rendered at the LOW resolution (with their
    G-buffers and cameras) paired with CLEAN `clean_spp` targets at the
    2x output resolution.  Returns (lrs (F, h, w, 3), world positions
    (F, h, w, 3), hits (F, h, w), the F LR cameras, cleans (F, H, W,
    3))."""
    dev = resolve_device(device)
    scene_obj, radius, height = _scene(scene_kind)
    cfg_lr = RenderConfig(width=size[0] // 2, height=size[1] // 2,
                          max_depth=3, indirect=True, jitter=True,
                          sky=True, traversal="pallas")
    cfg_hr = RenderConfig(width=size[0], height=size[1], max_depth=3,
                          indirect=True, jitter=True, sky=True,
                          spp=clean_spp, traversal="pallas")
    scene = scene_obj.build(dev)
    accel = lbvh.build_bvh_sah(scene, 32)
    lrs, wps, hits, cams_list, cleans = [], [], [], [], []
    for f in range(n_frames):
        cam = orbit_camera(phase + step * f, radius=radius, height=height)
        cams = camera_arrays(cam, cfg_lr, dev)
        img, gb = render_rows(scene, accel, cams, 0, cfg_lr.height, cfg_lr,
                              want_gbuffer=True, frame=f)
        lrs.append(img)
        wps.append(gb["world_pos"])
        hits.append(gb["hit"])
        cams_list.append(cams)
        cleans.append(render_rows(scene, accel,
                                  camera_arrays(cam, cfg_hr, dev), 0,
                                  cfg_hr.height, cfg_hr, frame=1000 + f))
    return (torch.stack(lrs), torch.stack(wps), torch.stack(hits),
            cams_list, torch.stack(cleans))


def temporal_triples(lrs, wps, hits, cams_list, cleans):
    """(noisy lr_t, warped clean_{t-1}, clean_t) triples, t >= 1."""
    lr, hist, hr = [], [], []
    for t in range(1, lrs.shape[0]):
        lr.append(lrs[t])
        hist.append(upscaler.reproject_history(
            cleans[t - 1], wps[t], hits[t], cams_list[t - 1],
            lrs.shape[2], lrs.shape[1]))
        hr.append(cleans[t])
    return torch.stack(lr), torch.stack(hist), torch.stack(hr)


def _corrupt_history(hist, generator: torch.Generator):
    """Augmentation: invalid-history simulation (zeroed samples, coarse
    16x16 dropout blocks, value noise) so alpha learns rejection.  The
    draws come from `generator` (a CPU generator)."""
    b, h, w, _ = hist.shape
    to = lambda t: t.to(hist.device)
    # Per-sample full zero (the frame-0 / disocclusion-everywhere case).
    zero = to(torch.rand((b, 1, 1, 1), generator=generator) < 0.15)
    # Coarse 16x16 dropout blocks (jax.image.resize "nearest" by 16).
    blocks = (torch.rand((b, h // 16, w // 16, 1), generator=generator)
              < 0.1).to(torch.float32)
    blocks = to(blocks.repeat_interleave(16, 1).repeat_interleave(16, 2))
    # Mild multiplicative noise on the rgb (accumulated-error
    # simulation); dropout zeroes rgb AND the validity channel.
    noise = to(1.0 + 0.05 * torch.randn((b, h, w, 1), generator=generator))
    rgb = hist[..., :3] * noise * (1.0 - blocks)
    valid = hist[..., 3:] * (1.0 - blocks)
    out = torch.cat([rgb, valid], dim=-1)
    return torch.where(zero, 0.0, out)


def crops(generator: torch.Generator, lr, hist, hr, crop=64, batch=8):
    """`batch` random crops of the triples: LR crops of `crop` px, the
    history and target crops of 2 * crop px at twice the LR origin, the
    history corrupted (_corrupt_history)."""
    f, h, w, _ = lr.shape
    draw = lambda hi: torch.randint(0, hi, (batch,),
                                    generator=generator).tolist()
    fi, ys, xs = draw(f), draw(h - crop + 1), draw(w - crop + 1)
    y2, x2 = [2 * y for y in ys], [2 * x for x in xs]
    return (upscaler.crop_at(lr, fi, ys, xs, crop),
            _corrupt_history(upscaler.crop_at(hist, fi, y2, x2, 2 * crop),
                             generator),
            upscaler.crop_at(hr, fi, y2, x2, 2 * crop))


def psnr(a, b) -> float:
    """PSNR of two frames clipped to [0, 1] (float32, peak 1)."""
    tm = lambda x: np.clip(np.asarray(x, np.float32), 0.0, 1.0)
    mse = np.mean((tm(a) - tm(b)) ** 2)
    return float(-10.0 * np.log10(max(mse, 1e-12)))


def eval_temporal(net_t, net_s, lrs, wps, hits, cams_list, cleans):
    """Held-out PSNR vs the CLEAN targets: (temporal, spatial,
    bilinear), frame 0 (no history) skipped.  The temporal net runs
    RECURRENTLY on its own previous output (the true inference
    condition), both nets with the serving path's bf16 trunk."""
    h2, w2 = cleans.shape[1], cleans.shape[2]
    p_t, p_s, p_b = [], [], []
    with torch.no_grad():
        hist = torch.zeros((h2, w2, 3), device=lrs.device)
        for t in range(lrs.shape[0]):
            lr = lrs[t]
            if t > 0:
                warped = upscaler.reproject_history(
                    hist, wps[t], hits[t], cams_list[t - 1], w2 // 2,
                    h2 // 2)
            else:
                warped = torch.zeros((h2, w2, 4), device=lrs.device)
            out_t = upscaler.upscale_temporal(net_t, lr, warped)
            hist = out_t
            if t > 0:  # skip the no-history first frame
                clean = cleans[t].cpu()
                p_t.append(psnr(out_t.cpu(), clean))
                p_s.append(psnr(upscaler.upscale(net_s, lr).cpu(), clean))
                p_b.append(psnr(upscaler._upsample_bilinear2(lr).cpu(),
                                clean))
    return float(np.mean(p_t)), float(np.mean(p_s)), float(np.mean(p_b))


def recurrent_loss(net, lrs, wps, hits, cams_list, cleans,
                   plain: bool = False) -> torch.Tensor:
    """The mean over a sequence's frames of the Charbonnier loss of the
    temporal net run RECURRENTLY: each frame's history is the net's own
    previous prediction warped by the real G-buffer motion, so the loss
    differentiates through the warp (K6 and its adjoint on the card;
    `plain=True` takes the plain warp there, as a reference)."""
    h2, w2 = cleans.shape[1], cleans.shape[2]
    hist = torch.zeros((h2, w2, 3), device=lrs.device)
    total = 0.0
    for t in range(lrs.shape[0]):
        if t == 0:
            warped = torch.zeros((h2, w2, 4), device=lrs.device)
        else:
            warped = upscaler.reproject_history(
                hist, wps[t], hits[t], cams_list[t - 1], w2 // 2, h2 // 2,
                plain=plain)
        pred = net(lrs[t][None], warped[None])[0]
        total = total + upscaler.charbonnier(pred, cleans[t])
        hist = pred
    return total / lrs.shape[0]


def recurrent_finetune(net, opt, seqs, steps: int,
                       log_every: int = 20) -> list:
    """Fine-tune on full sequences run RECURRENTLY (recurrent_loss), one
    update per sequence per step — the exact inference condition of
    FrameLoop's temporal mode.  Returns every update's loss."""
    t0 = time.time()
    losses = []
    for step in range(steps):
        for seq in seqs:
            losses.append(upscaler.update(
                opt, lambda: recurrent_loss(net, *seq)))
        if step % log_every == 0 or step == steps - 1:
            print(f"recurrent step {step}: loss {float(losses[-1]):.5f} "
                  f"({time.time() - t0:.0f}s)", flush=True)
    return [float(x) for x in losses]


def save_checkpoint(net, path: str) -> str:
    """Write `net`'s parameters to the `.npz` file `path` (its directory
    made); refuses the committed weights' directory.  Returns the
    absolute path."""
    path = os.path.abspath(path)
    weights = os.path.abspath(upscaler.WEIGHTS_DIR)
    if os.path.dirname(path) == weights:
        raise ValueError(f"{path}: the committed weights are not "
                         "overwritten; pass another --out")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    save_params(path, upscaler_to_numpy(net))
    return path


def load_spatial(device):
    """The spatial net for the held-out comparison: SPATIAL_CKPT when it
    exists (its names and shapes checked: a malformed file raises), else
    the committed spatial weights."""
    if not os.path.exists(SPATIAL_CKPT):
        return upscaler.load_weights("spatial", device)
    template = upscaler_to_numpy(upscaler.UpscalerNet())
    return upscaler_from_numpy(load_params(SPATIAL_CKPT, template), False,
                               device)


def _train(step_fn, steps: int, t0: float) -> list:
    """Run `step_fn(step)` (it returns the loss) `steps` times, printing
    every 50th loss; returns the losses as floats."""
    losses = []
    for step in range(steps):
        losses.append(step_fn(step))
        if step % 50 == 0 or step == steps - 1:
            print(f"step {step}: loss {float(losses[-1]):.5f} "
                  f"({time.time() - t0:.0f}s)", flush=True)
    return [float(x) for x in losses]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m hrt_tpu_torch.train_upscaler",
        description="Train the learned 2x upscaler (spatial, or temporal "
                    "with --temporal) on rendered frames.")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--temporal", action="store_true")
    ap.add_argument("--recurrent-steps", type=int, default=60)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda, raising without a "
                         "card; cpu runs the plain versions)")
    return ap


def main(argv=None) -> dict:
    """Run the trainer; returns what it made: the trained `net`, its
    `losses` (and `recurrent_losses`), the checkpoint path `out`, and in
    temporal mode the training `seqs`, the `held_out` sequence and its
    `psnr` (temporal, spatial, bilinear)."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)

    if not args.temporal:
        print("rendering training frames...", flush=True)
        frames = render_training_frames(args.frames, device=dev)
        print("frames:", tuple(frames.shape), flush=True)
        net, opt = upscaler.create(lr=2e-3, device=dev)
        gen = torch.Generator().manual_seed(0)

        def spatial_step(_):
            lr_b, hr_b = upscaler.self_supervised_batch(frames, gen,
                                                        crop=64, batch=8)
            return upscaler.train_step(net, opt, lr_b, hr_b)

        losses = _train(spatial_step, args.steps, time.time())
        out = save_checkpoint(net, args.out or SPATIAL_CKPT)
        print("saved to", out, flush=True)
        return {"net": net, "losses": losses, "out": out}

    n = max(args.frames, 16)
    print("rendering training sequences...", flush=True)
    seqs = [render_sequence(n, scene_kind="bench", device=dev),
            render_sequence(n, scene_kind="cornell", device=dev)]
    trip = [temporal_triples(*s) for s in seqs]
    lr, hist, hr = (torch.cat([t[i] for t in trip]) for i in range(3))
    print("triples:", tuple(lr.shape), tuple(hist.shape), tuple(hr.shape),
          flush=True)

    net, opt = upscaler.create_temporal(lr=2e-3, device=dev)
    gen = torch.Generator().manual_seed(1)

    def temporal_step(_):
        lr_b, hist_b, hr_b = crops(gen, lr, hist, hr)
        return upscaler.train_step_temporal(net, opt, lr_b, hist_b, hr_b)

    losses = _train(temporal_step, args.steps, time.time())
    rec = []
    if args.recurrent_steps:
        print("recurrent fine-tune (inference-condition unroll)...",
              flush=True)
        rec = recurrent_finetune(net, opt, seqs, args.recurrent_steps)
    out = save_checkpoint(net, args.out or TEMPORAL_CKPT)
    print("saved to", out, flush=True)

    # Held-out eval: a different orbit phase, recurrent inference.
    print("evaluating on held-out orbit...", flush=True)
    ev = render_sequence(8, scene_kind="bench", phase=2.5, device=dev)
    pt, ps, pb = eval_temporal(net, load_spatial(dev), *ev)
    print(f"PSNR held-out: temporal {pt:.2f} dB | spatial {ps:.2f} dB "
          f"| bilinear {pb:.2f} dB", flush=True)
    return {"net": net, "losses": losses, "recurrent_losses": rec,
            "out": out, "seqs": seqs, "held_out": ev,
            "psnr": (pt, ps, pb)}


if __name__ == "__main__":
    main()
