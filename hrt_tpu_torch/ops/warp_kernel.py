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
strides, so a channels-first history is not copied first.

Contract: warp an (Hs, Ws, C) float32 image to the (Ho, Wo) grid of
float source coordinates (px, py), corner convention (pixel (i, j)'s
sample sits at (j, i)).  Returns (val (Ho, Wo, C) float32, valid
(Ho, Wo) bool), valid = 0 <= px <= Ws-1 and 0 <= py <= Hs-1.  Invalid
pixels carry the edge-clamped taps' value; callers mask them.
`warp_bilinear` takes the plain version only for CPU tensors; CUDA
tensors always launch the kernel.
"""
from __future__ import annotations

import torch

# Launches of the CUDA kernel; the plain version never counts.
LAUNCHES = {"warp_bilinear": 0}


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
    """The reprojection warp: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if px.is_cuda:
        return warp_bilinear_kernel(img, px, py)
    if px.device.type != "cpu":
        raise ValueError(f"no warp kernel for device {px.device}")
    return warp_bilinear_plain(img, px, py)
