"""The learned 2x upscalers (hrt_tpu/models/upscaler.py), serving path.

Two small residual conv nets over a bilinear upsample: `UpscalerNet`
(spatial: the LR frame alone) and `TemporalUpscalerNet` (the LR frame
plus the previous HR output warped onto the current frame, with a
validity channel; its head adds a per-HR-pixel blend weight toward that
history).  Both are `nn.Module`s whose convolutions are named `Conv_0`
to `Conv_3`, as flax names them, so the trained flax parameters map
one to one (utils/interop.upscaler_from_numpy); the trained weights are
committed as numpy in `hrt_tpu_torch/weights/` (`load_weights`).

The nets run in the module form of the JAX package's flax definitions:
concatenate the LR frame with `space_to_depth2(history)`, three 3x3
convs with ReLU, the head conv, and the 2x2 pixel shuffle in JAX's
channel order (HR pixel (2i+r, 2j+s) takes head channels
(r*2+s)*c + ch).  The JAX package's fused-head and folded-conv forms are
XLA layout workarounds for the TPU and are not carried over.  The convs
are `torch.nn.functional.conv2d`, as the JAX package leaves them to
XLA.  Frames are (H, W, C) at every public function.

`upscale` and `upscale_temporal` run the trunk in bf16 with float32
accumulation and a float32 residual, as the JAX package's inference
path does by default; the modules themselves default to float32 (JAX's
`net.apply`).  The nets take leading batch dims, (..., h, w, c), as
flax's `net.apply` does.

The training half (`create`, `train_step`, `self_supervised_batch`,
`create_temporal`, `train_step_temporal`; hrt_tpu/models/upscaler.py
:56-110, :175-204) trains in float32 with `torch.optim.Adam` at optax
`adam`'s defaults, the convolutions in full float32 (`fp32_convs`: on
the card cuDNN would otherwise run float32 convolutions in TF32, about
three decimal digits).  Fresh nets are initialised as flax's `nn.Conv`
is (lecun_normal kernels, zero biases), from a `torch.Generator` on the
CPU, so a seed gives the same net on every device; `jax.random` cannot
be reproduced, so parity tests pass JAX's parameters through
utils/interop.
"""
from __future__ import annotations

import contextlib
import math
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import resolve_device
from ..ops.denoise import _project
from ..ops.warp_kernel import warp_bilinear, warp_bilinear_plain

# The trunk's type in the frame loop (the JAX package's HRT_UP_BF16=1).
INFER_DTYPE = torch.bfloat16
WEIGHTS_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "weights")


def _conv(x: torch.Tensor, conv: nn.Conv2d, dtype) -> torch.Tensor:
    """3x3 'SAME' conv of an NCHW batch in `dtype`; float32 out, bias
    added in float32."""
    y = F.conv2d(x.to(dtype), conv.weight.to(dtype), padding=1)
    return y.to(torch.float32) + conv.bias[:, None, None]


def _shuffle(t: torch.Tensor, c: int) -> torch.Tensor:
    """(..., h, w, 4c) -> (..., 2h, 2w, c): HR pixel (2i+r, 2j+s)
    channel ch is t[..., i, j, (r*2+s)*c + ch]."""
    lead, (h, w) = t.shape[:-3], t.shape[-3:-1]
    t = t.reshape(*lead, h, w, 2, 2, c).transpose(-4, -3)
    return t.reshape(*lead, 2 * h, 2 * w, c)


def _upsample_bilinear2(img: torch.Tensor) -> torch.Tensor:
    """Half-pixel-center 2x bilinear upsample of (..., H, W, C), edges
    clamped (jax.image.resize's 'bilinear' when enlarging)."""
    lead, (h, w, c) = img.shape[:-3], img.shape[-3:]
    x = img.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    up = F.interpolate(x, scale_factor=2, mode="bilinear",
                       align_corners=False)
    return up.permute(0, 2, 3, 1).reshape(*lead, 2 * h, 2 * w, c)


def space_to_depth2(img: torch.Tensor) -> torch.Tensor:
    """(..., 2h, 2w, c) -> (..., h, w, 4c)."""
    lead, (h2, w2, c) = img.shape[:-3], img.shape[-3:]
    x = img.reshape(*lead, h2 // 2, 2, w2 // 2, 2, c).transpose(-4, -3)
    return x.reshape(*lead, h2 // 2, w2 // 2, 4 * c)


class _ShuffleNet(nn.Module):
    """Conv trunk (`depth` 3x3 convs of `features` channels, ReLU) and a
    3x3 head of `head` channels, over (..., h, w, in_ch) frames."""

    def __init__(self, in_ch: int, head: int, features: int, depth: int):
        super().__init__()
        self.depth = depth
        chans = [in_ch] + [features] * depth
        for i in range(depth):
            self.add_module(f"Conv_{i}",
                            nn.Conv2d(chans[i], features, 3, padding=1))
        self.add_module(f"Conv_{depth}", nn.Conv2d(features, head, 3,
                                                   padding=1))

    def _trunk_head(self, x: torch.Tensor, dtype) -> torch.Tensor:
        lead, (h, w, c) = x.shape[:-3], x.shape[-3:]
        x = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)
        for i in range(self.depth):
            x = F.relu(_conv(x, getattr(self, f"Conv_{i}"), dtype))
        head = _conv(x, getattr(self, f"Conv_{self.depth}"), dtype)
        return head.permute(0, 2, 3, 1).reshape(*lead, h, w, -1)


class UpscalerNet(_ShuffleNet):
    """Residual conv net predicting the bilinear-upsample residual."""

    def __init__(self, features: int = 32, depth: int = 3):
        super().__init__(3, 12, features, depth)

    def forward(self, lr: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """lr: (..., h, w, 3) linear radiance -> (..., 2h, 2w, 3)."""
        residual = _shuffle(self._trunk_head(lr, dtype), 3)
        return _upsample_bilinear2(lr) + residual


class TemporalUpscalerNet(_ShuffleNet):
    """2x reconstruction from (current LR, reprojected HR history with a
    validity channel): a pixel-shuffled residual over the bilinear
    upsample plus a sigmoid blend weight toward the history."""

    def __init__(self, features: int = 32, depth: int = 3):
        super().__init__(3 + 16, 16, features, depth)

    def forward(self, lr: torch.Tensor, hist: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """lr: (..., h, w, 3); hist: (..., 2h, 2w, 4) rgb + validity ->
        (..., 2h, 2w, 3)."""
        x = torch.cat([lr, space_to_depth2(hist)], dim=-1)
        head = self._trunk_head(x, dtype)
        residual = _shuffle(head[..., :12], 3)
        alpha = torch.sigmoid(_shuffle(head[..., 12:16], 1))
        spatial = _upsample_bilinear2(lr) + residual
        hist_rgb = hist[..., :3]
        valid = hist[..., 3:4]
        return spatial + alpha * valid * (hist_rgb - spatial)


def load_weights(mode: str, device) -> nn.Module:
    """The trained net of `mode` ('spatial' or 'temporal') on `device`,
    from the committed copy of the JAX package's checkpoint."""
    if mode not in ("spatial", "temporal"):
        raise ValueError(f"mode must be 'spatial' or 'temporal', not "
                         f"{mode!r}")
    from ..utils.interop import upscaler_from_numpy

    name = "upscaler_temporal.npz" if mode == "temporal" else "upscaler.npz"
    with np.load(os.path.join(WEIGHTS_DIR, name)) as d:
        return upscaler_from_numpy(dict(d), mode == "temporal", device)


def upscale(net: UpscalerNet, img: torch.Tensor) -> torch.Tensor:
    """The spatial upscaler on one (H, W, 3) frame, bf16 trunk."""
    return net(img, dtype=INFER_DTYPE)


def upscale_temporal(net: TemporalUpscalerNet, img: torch.Tensor,
                     hist: torch.Tensor) -> torch.Tensor:
    """The temporal upscaler on one (H, W, 3) frame with its reprojected
    (2H, 2W, 4) rgb + validity history, bf16 trunk."""
    return net(img, hist, dtype=INFER_DTYPE)


def _upsample2_corner(img: torch.Tensor) -> torch.Tensor:
    """Exact corner-convention 2x bilinear upsample of (H, W, C):
    out[2i, 2j] = img[i, j]; odd coordinates average their (edge-clamped)
    neighbours."""
    h, w, c = img.shape
    right = torch.cat([img[:, 1:], img[:, -1:]], dim=1)
    wide = torch.stack([img, (img + right) * 0.5], dim=2).reshape(h, 2 * w,
                                                                   c)
    down = torch.cat([wide[1:], wide[-1:]], dim=0)
    out = torch.stack([wide, (wide + down) * 0.5], dim=1)
    return out.reshape(2 * h, 2 * w, c)


def reproject_history(hist: torch.Tensor, world_pos, hit_mask, prev_cam,
                      width: int, height: int,
                      plain: bool = False) -> torch.Tensor:
    """Warp the previous HR output onto the current frame through K6.

    world_pos / hit_mask: the current frame's G-buffer at render size
    (H, W, ·), brought to the HR grid by the corner-convention upsample
    (world_pos) and repetition (hit).  Returns (2H, 2W, 4): warped rgb
    and a validity channel (0 out of bounds or on a miss)."""
    h2, w2 = hist.shape[0], hist.shape[1]
    wp = _upsample2_corner(world_pos)
    hm = hit_mask.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)
    px, py, _ = _project(wp, prev_cam.origin, prev_cam.basis,
                         prev_cam.tan_half_fovy, prev_cam.aspect, w2, h2)
    warp = warp_bilinear_plain if plain else warp_bilinear
    val, inb = warp(hist, px, py)
    ok = (inb & (hm > 0.5))[..., None]
    return torch.cat([torch.where(ok, val, 0.0), ok.to(torch.float32)],
                     dim=-1)


# ---------------------------------------------------------------------------
# Training (hrt_tpu/models/upscaler.py `create` ... `train_step_temporal`).
# ---------------------------------------------------------------------------

# flax's lecun_normal: a normal truncated at +-2 standard deviations,
# its scale divided by the truncated normal's own standard deviation.
_TRUNC_STD = 0.87962566103423978


@contextlib.contextmanager
def fp32_convs():
    """cuDNN float32 convolutions in full float32 inside the block (the
    card's default is TF32); the previous setting is restored after."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def init_flax(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise `net`'s convolutions in place as flax's `nn.Conv`
    does: lecun_normal kernels (std sqrt(1 / fan_in), fan_in = 3 * 3 *
    in_ch, truncated at +-2 std) and zero biases.  The draws come from
    `generator` (a CPU generator) in the order Conv_0, Conv_1, ...,
    each into the kernel's HWIO layout."""
    with torch.no_grad():
        for conv in net.children():
            o, i, kh, kw = conv.weight.shape
            std = math.sqrt(1.0 / (i * kh * kw)) / _TRUNC_STD
            k = torch.empty((kh, kw, i, o), dtype=torch.float32)
            nn.init.trunc_normal_(k, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            conv.weight.copy_(k.permute(3, 2, 0, 1))
            conv.bias.zero_()
    return net


def adam(net: nn.Module, lr: float) -> torch.optim.Adam:
    """Adam over `net`'s parameters at optax `adam`'s defaults."""
    return torch.optim.Adam(net.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def _fresh(cls, seed: int, features: int, depth: int, lr: float, device):
    net = init_flax(cls(features, depth), torch.Generator().manual_seed(seed))
    net = net.to(resolve_device(device))
    return net, adam(net, lr)


def create(seed: int = 0, features: int = 32, depth: int = 3,
           lr: float = 1e-3, device=None):
    """A fresh spatial net on `device` (default: the card) and its
    optimizer: (net, opt)."""
    return _fresh(UpscalerNet, seed, features, depth, lr, device)


def create_temporal(seed: int = 0, features: int = 32, depth: int = 3,
                    lr: float = 1e-3, device=None):
    """A fresh temporal net on `device` (default: the card) and its
    optimizer: (net, opt)."""
    return _fresh(TemporalUpscalerNet, seed, features, depth, lr, device)


def charbonnier(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Charbonnier on tonemapped values: mean sqrt(d^2 + 1e-6), d the
    difference of x / (1 + |x|)."""
    tm = lambda x: x / (1.0 + torch.abs(x))
    diff = tm(pred) - tm(target)
    return torch.mean(torch.sqrt(diff * diff + 1e-6))


def _loss_fn(net: UpscalerNet, lr_batch, hr_batch) -> torch.Tensor:
    return charbonnier(net(lr_batch), hr_batch)


def _loss_fn_temporal(net: TemporalUpscalerNet, lr_batch, hist_batch,
                      hr_batch) -> torch.Tensor:
    return charbonnier(net(lr_batch, hist_batch), hr_batch)


def update(opt: torch.optim.Optimizer, loss_of) -> torch.Tensor:
    """One optimizer update on the loss `loss_of()` computes, in full
    float32; returns the loss, detached."""
    with fp32_convs():
        opt.zero_grad(set_to_none=True)
        loss = loss_of()
        loss.backward()
    opt.step()
    return loss.detach()


def train_step(net: UpscalerNet, opt, lr_batch, hr_batch) -> torch.Tensor:
    """One optimizer update of the spatial net, in place.  Batches:
    (B, h, w, 3) and (B, 2h, 2w, 3).  Returns the loss."""
    return update(opt, lambda: _loss_fn(net, lr_batch, hr_batch))


def train_step_temporal(net: TemporalUpscalerNet, opt, lr_batch,
                        hist_batch, hr_batch) -> torch.Tensor:
    """One optimizer update of the temporal net, in place.  Batches:
    (B, h, w, 3), (B, 2h, 2w, 4) and (B, 2h, 2w, 3).  Returns the
    loss."""
    return update(opt, lambda: _loss_fn_temporal(net, lr_batch,
                                                  hist_batch, hr_batch))


def downsample2(img: torch.Tensor) -> torch.Tensor:
    """2x box downsample of (..., h, w, 3) (the self-supervision
    pairing).  The four values are summed in the JAX package's order,
    ((x00 + x01) + x10) + x11, so the result is its bits."""
    lead, (h, w) = img.shape[:-3], img.shape[-3:-1]
    x = img.reshape(*lead, h // 2, 2, w // 2, 2, 3)
    top, bottom = x[..., 0, :, :, :], x[..., 1, :, :, :]
    total = top[..., 0, :] + top[..., 1, :] + bottom[..., 0, :] \
        + bottom[..., 1, :]
    return total / 4.0


def crop_at(stack: torch.Tensor, fi, ys, xs, size: int) -> torch.Tensor:
    """(B, size, size, C) crops of the (F, H, W, C) `stack`: crop b is
    stack[fi[b], ys[b]:ys[b] + size, xs[b]:xs[b] + size] (lists of
    ints)."""
    return torch.stack([stack[f, y:y + size, x:x + size]
                        for f, y, x in zip(fi, ys, xs)])


def self_supervised_batch(frames: torch.Tensor, generator: torch.Generator,
                          crop: int = 64, batch: int = 8):
    """Random HR crops + their downsamples from a stack of rendered
    frames (F, H, W, 3): (lr (B, crop/2, crop/2, 3), hr (B, crop, crop,
    3)).  The crop origins are drawn from `generator` (a CPU
    generator)."""
    f, h, w, _ = frames.shape
    draw = lambda hi: torch.randint(0, hi, (batch,),
                                    generator=generator).tolist()
    fi, ys, xs = draw(f), draw(h - crop + 1), draw(w - crop + 1)
    hr = crop_at(frames, fi, ys, xs, crop)
    return downsample2(hr), hr
