"""K6: the bilinear reprojection warp — CUDA kernel wrapper and its plain
PyTorch version.

Replaces the Pallas kernel of hrt_tpu/ops/warp_pallas.py
(`warp_bilinear`, body `_make_kernel`, planner `_plan`).  The kernel is
csrc/warp_bilinear.cu; its source note says what bounds it on the card
(bytes) and why it drops the TPU kernel's +-margin window: both
versions compute the JAX package's unbounded gather path,
hrt_tpu/ops/denoise.py `_bilinear`, at every pixel.  The kernel lays
the work out for coalesced access: a block per tile of 128 output
pixels computes their taps and weights once into shared memory, then
its threads run over the tile's contiguous (pixel, channel) output
floats, four each, with 16-byte stores; it reads the image through its
strides, so a channels-first history is not copied first.  Its tap sum
and its adjoint's products round each operation as the plain version
does (no FMA contraction), so its forward equals `warp_bilinear_plain`
bit for bit on the card.

Contract: warp an (Hs, Ws, C) float32 image to the (Ho, Wo) grid of
float source coordinates (px, py), corner convention (pixel (i, j)'s
sample sits at (j, i)).  Returns (val (Ho, Wo, C) float32, valid
(Ho, Wo) bool), valid = 0 <= px <= Ws-1 and 0 <= py <= Hs-1.  Invalid
pixels carry the edge-clamped taps' value; callers mask them.
`warp_bilinear` takes the plain version only for CPU tensors; CUDA
tensors always launch the kernel, through `WarpBilinear`, whose backward
launches the kernel's adjoint (`hrt_warp_bilinear_backward`): the
gradient with respect to the image, as autodiff of the JAX `_bilinear`
gives it, so the upscaler's recurrent fine-tune
(hrt_tpu_torch/train_upscaler.py) trains through the warp on the card
as on the CPU.  The adjoint scatters with float atomics into a zeroed
image gradient, and takes apart the adds that would serialise on one
address (every sky pixel projects onto the same taps, every pixel off
the image onto an edge tap): it drops products that are exactly +-0
(exact, since the sum starts at +0; a NaN or Inf still adds), sums a
pixel's coincident clamped taps in the thread, merges equal taps
across a warp (`__match_any_sync`, a shuffle tree) and, in a block with
a large cluster, across the block in a shared-memory window flushed
once (the source note has the steps and the bound).  Its results match
the plain adjoint to float rounding in a run-dependent order; NaN and
Inf land where the plain adjoint puts them.  The coordinates get no
gradient: they come from the G-buffer and the previous camera, and
`warp_bilinear` raises if they require one.  `valid` is not
differentiable.
"""
from __future__ import annotations

import torch

# Launches of the CUDA kernels; the plain version never counts.
LAUNCHES = {"warp_bilinear": 0, "warp_bilinear_backward": 0}


def _check_inputs(img, px, py) -> None:
    if (img.dim() != 3 or px.dim() != 2 or px.shape != py.shape
            or min(img.shape) < 1
            or any(t.dtype != torch.float32 for t in (img, px, py))
            or not img.device == px.device == py.device):
        raise ValueError("warp_bilinear: img must be (Hs, Ws, C) and px, py "
                         "(Ho, Wo), float32 on one device")


def warp_bilinear_kernel(img, px, py):
    """Launch csrc/warp_bilinear.cu on CUDA tensors.  The kernel reads
    `img` through its strides (no copy for a channels-first view)."""
    from ..kernels import build

    _check_inputs(img, px, py)
    hs, ws, c = img.shape
    sy, sx, sc = img.stride()
    if (hs - 1) * sy + (ws - 1) * sx + (c - 1) * sc >= 2**31:
        raise ValueError("warp_bilinear: the kernel takes images whose "
                         "offsets stay under 2^31 floats")
    px, py = px.contiguous(), py.contiguous()
    ho, wo = px.shape
    dev = img.device
    val = torch.empty((ho, wo, c), dtype=torch.float32, device=dev)
    valid = torch.empty((ho, wo), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = build.stream(dev)
        rc = build.load().hrt_warp_bilinear(
            img.data_ptr(), hs, ws, c, sy, sx, sc, px.data_ptr(),
            py.data_ptr(), ho * wo, val.data_ptr(), valid.data_ptr(),
            stream)
    build.check(rc, "warp_bilinear")
    LAUNCHES["warp_bilinear"] += 1
    return val, valid


def warp_bilinear_backward_kernel(grad_val, px, py, hs: int, ws: int):
    """Launch the adjoint of csrc/warp_bilinear.cu on CUDA tensors:
    the gradient of the fetch's (Ho, Wo, C) value with respect to an
    (hs, ws, C) image, given grad_val (Ho, Wo, C).  Returns a new
    contiguous (hs, ws, C) float32 tensor; the kernel refuses an image
    of 2^31 floats or more (RuntimeError)."""
    from ..kernels import build

    if (grad_val.dim() != 3 or px.dim() != 2 or px.shape != py.shape
            or grad_val.shape[:2] != px.shape or hs < 1 or ws < 1
            or any(t.dtype != torch.float32 for t in (grad_val, px, py))
            or not grad_val.device == px.device == py.device):
        raise ValueError("warp_bilinear backward: grad_val must be (Ho, Wo, "
                         "C) and px, py (Ho, Wo), float32 on one device")
    c = grad_val.shape[2]
    grad_val = grad_val.contiguous()
    px, py = px.contiguous(), py.contiguous()
    dev = grad_val.device
    grad_img = torch.zeros((hs, ws, c), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = build.stream(dev)
        rc = build.load().hrt_warp_bilinear_backward(
            grad_val.data_ptr(), hs, ws, c, px.data_ptr(), py.data_ptr(),
            *px.shape, grad_img.data_ptr(), stream)
    build.check(rc, "warp_bilinear backward")
    LAUNCHES["warp_bilinear_backward"] += 1
    return grad_img


class WarpBilinear(torch.autograd.Function):
    """The warp on CUDA tensors, differentiable in the image: forward
    K6, backward its adjoint."""

    @staticmethod
    def forward(ctx, img, px, py):
        val, valid = warp_bilinear_kernel(img, px, py)
        ctx.mark_non_differentiable(valid)
        ctx.save_for_backward(px, py)
        ctx.image_hw = (img.shape[0], img.shape[1])
        return val, valid

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_val, _grad_valid):
        px, py = ctx.saved_tensors
        return (warp_bilinear_backward_kernel(grad_val, px, py,
                                              *ctx.image_hw), None, None)


def warp_bilinear_plain(img, px, py):
    """The same fetch as gathers of the four clamped taps, in the JAX
    `_bilinear`'s order of operations."""
    _check_inputs(img, px, py)
    hs, ws, c = img.shape
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    fx = px - x0
    fy = py - y0
    # Clamp as floats, then convert (px can be ~1e10; XLA saturates).
    xi = x0.clamp(0, ws - 1).long()
    yi = y0.clamp(0, hs - 1).long()
    xr = (xi + 1).clamp(max=ws - 1)
    yd = (yi + 1).clamp(max=hs - 1)
    flat = img.reshape(hs * ws, c)
    tap = lambda yy, xx: flat[yy * ws + xx]
    wgt = lambda g: g[..., None]
    val = (tap(yi, xi) * wgt((1 - fx) * (1 - fy))
           + tap(yi, xr) * wgt(fx * (1 - fy))
           + tap(yd, xi) * wgt((1 - fx) * fy)
           + tap(yd, xr) * wgt(fx * fy))
    valid = (px >= 0.0) & (px <= ws - 1.0) & (py >= 0.0) & (py <= hs - 1.0)
    return val, valid


def warp_bilinear(img, px, py):
    """The reprojection warp: the CUDA kernels for CUDA tensors (the
    forward, and its adjoint when a gradient flows back to `img`), the
    plain version, differentiated by autograd, for CPU tensors."""
    if px.requires_grad or py.requires_grad:
        raise ValueError("warp_bilinear: px and py get no gradient (they "
                         "come from the G-buffer and the camera)")
    if px.is_cuda:
        return WarpBilinear.apply(img, px, py)
    if px.device.type != "cpu":
        raise ValueError(f"no warp kernel for device {px.device}")
    return warp_bilinear_plain(img, px, py)
