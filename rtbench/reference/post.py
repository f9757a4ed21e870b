"""The reference post stages on whole (H, W, C) frames: accumulation,
SVGF (reprojection with one bilinear fetch of the packed history,
validation by depth and normal, a clamp to the frame's 3x3 color box,
temporal accumulation of color and luminance moments, the spatial
variance bootstrap, five a-trous levels) and the learned 2x temporal
upscaler (its HR history warped onto the frame, then the residual conv
net with a sigmoid blend toward that history), written from the JAX
package's published formulas.  The upscaler's trunk runs in `dtype`
(bfloat16 with float32 bias, as the configuration states; float8 is
the control's step below it) from the weight file both sides read.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

_LUMA = (0.2126, 0.7152, 0.0722)


class SvgfState(NamedTuple):
    color: torch.Tensor     # (H, W, 3)
    moments: torch.Tensor   # (H, W, 2)
    history: torch.Tensor   # (H, W, 1)
    depth: torch.Tensor     # (H, W, 1)
    normal: torch.Tensor    # (H, W, 3)


def accumulate(accum, img, frame: int):
    n = torch.tensor(float(min(frame, 10000)), device=img.device)
    return (accum * n + img) / (n + 1.0)


def luminance(rgb):
    w = torch.tensor(_LUMA, dtype=torch.float32, device=rgb.device)
    return torch.sum(rgb * w, dim=-1)


def _shift(x, dy: int, dx: int):
    h, w = x.shape[0], x.shape[1]
    ys = torch.clamp(torch.arange(h, device=x.device) + dy, 0, h - 1)
    xs = torch.clamp(torch.arange(w, device=x.device) + dx, 0, w - 1)
    return x.index_select(0, ys).index_select(1, xs)


def project(world_pos, cam, width: int, height: int):
    """World points to a camera's pixel coordinates (px, py)."""
    rel = world_pos - cam.origin
    x = torch.sum(rel * cam.basis[0], -1)
    y = torch.sum(rel * cam.basis[1], -1)
    z = torch.clamp(torch.sum(rel * cam.basis[2], -1), min=1e-6)
    cx = x / (z * cam.aspect * cam.tan_half_fovy)
    cy = y / (z * cam.tan_half_fovy)
    return (cx + 1.0) * 0.5 * width, (cy + 1.0) * 0.5 * height


def warp(img, px, py):
    """Bilinear fetch of (Hs, Ws, C) at (px, py), taps clamped to the
    image, and the in-bounds mask."""
    hs, ws, c = img.shape
    x0, y0 = torch.floor(px), torch.floor(py)
    fx, fy = px - x0, py - y0
    xi = x0.clamp(0, ws - 1).long()
    yi = y0.clamp(0, hs - 1).long()
    xr = (xi + 1).clamp(max=ws - 1)
    yd = (yi + 1).clamp(max=hs - 1)
    flat = img.reshape(hs * ws, c)
    tap = lambda yy, xx: flat[yy * ws + xx]
    g = lambda a: a[..., None]
    val = (tap(yi, xi) * g((1 - fx) * (1 - fy)) + tap(yi, xr) * g(fx * (1 - fy))
           + tap(yd, xi) * g((1 - fx) * fy) + tap(yd, xr) * g(fx * fy))
    ok = (px >= 0.0) & (px <= ws - 1.0) & (py >= 0.0) & (py <= hs - 1.0)
    return val, ok


def _box(x, fn, init):
    acc = init
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            acc = fn(acc, _shift(x, dy, dx))
    return acc


def _temporal(state: SvgfState, color, gb, prev_cam, w: int, h: int):
    normal, world_pos = gb["normal"], gb["world_pos"]
    depth, hit = gb["depth"][..., None], gb["hit"][..., None]
    px, py = project(world_pos, prev_cam, w, h)
    packed = torch.cat([state.color, state.moments, state.history,
                        state.depth, state.normal], dim=-1)
    hist, inb = warp(packed, px, py)
    h_color, h_mom, h_len = hist[..., 0:3], hist[..., 3:5], hist[..., 5:6]
    h_depth, h_normal = hist[..., 6:7], hist[..., 7:10]
    ndot = torch.sum(normal * h_normal, -1, keepdim=True)
    zdiff = torch.abs(h_depth - depth) / torch.clamp(depth, min=1e-3)
    valid = (inb[..., None] & (hit > 0.5) & (ndot > 0.7)
             & (zdiff < 0.1)).to(torch.float32)
    cmin = _box(color, torch.minimum, color)
    cmax = _box(color, torch.maximum, color)
    h_color = torch.minimum(torch.maximum(h_color, cmin), cmax)
    h_len = (h_len + 1.0) * valid + (1.0 - valid)
    a_c = torch.clamp(1.0 / h_len, min=0.2)
    a_m = torch.clamp(1.0 / h_len, min=0.2)
    illum = h_color + (color - h_color) * a_c
    lum = luminance(color)[..., None]
    moments = h_mom + (torch.cat([lum, lum * lum], dim=-1) - h_mom) * a_m
    var = torch.clamp(moments[..., 1:2] - moments[..., 0:1] ** 2, min=0.0)
    s1 = _box(lum, lambda a, s: a + s, torch.zeros_like(lum))
    s2 = _box(lum, lambda a, s: a + s * s, torch.zeros_like(lum))
    mean = s1 / 9.0
    spatial = torch.clamp(s2 / 9.0 - mean * mean, min=0.0)
    var = torch.where(h_len < 4.0, torch.maximum(var, spatial), var)
    return illum, var, SvgfState(illum, moments, h_len, depth, normal)


def _atrous(illum, var, gb, levels: int):
    normal = gb["normal"]
    depth, hit = gb["depth"][..., None], gb["hit"][..., None]
    kernel = [1.0, 2.0 / 3.0, 1.0 / 6.0]
    for level in range(levels):
        stride = 1 << level
        lum_p = luminance(illum)[..., None]
        vsum = _box(var, lambda a, s: a + s, torch.zeros_like(var))
        sigma_lum = 4.0 * torch.sqrt(torch.clamp(vsum / 9.0, min=1e-10))
        acc_c = illum * kernel[0] ** 2
        acc_v = var * (kernel[0] ** 2) ** 2
        acc_w = torch.full_like(lum_p, kernel[0] ** 2)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy == 0 and dx == 0:
                    continue
                hk = kernel[abs(dy)] * kernel[abs(dx)]
                sy, sx = dy * stride, dx * stride
                q = lambda a: _shift(a, sy, sx)
                w_l = torch.exp(-torch.abs(q(lum_p) - lum_p)
                                / torch.clamp(sigma_lum, min=1e-10))
                w_z = torch.exp(-torch.abs(q(depth) - depth)
                                / (1.0 * stride * torch.clamp(depth, min=1e-3)))
                w_n = torch.clamp(torch.sum(q(normal) * normal, -1,
                                            keepdim=True), min=0.0) ** 128.0
                wgt = hk * w_l * w_z * w_n * q(hit)
                acc_c = acc_c + q(illum) * wgt
                acc_v = acc_v + q(var) * wgt * wgt
                acc_w = acc_w + wgt
        illum = acc_c / torch.clamp(acc_w, min=1e-10)
        var = acc_v / torch.clamp(acc_w, min=1e-10) ** 2
    return illum, var


def svgf(state: SvgfState, color, gb, prev_cam, w: int, h: int):
    """One SVGF step -> (denoised frame, new state); the state's color
    is the first a-trous level's output."""
    illum, var, st = _temporal(state, color, gb, prev_cam, w, h)
    fb, fb_var = _atrous(illum, var, gb, 1)
    out, _ = _atrous(fb, fb_var, gb, 4)
    hit = gb["hit"][..., None]
    return out * hit + color * (1.0 - hit), st._replace(color=fb)


# ---------------------------------------------------------------------------
# The temporal upscaler.
# ---------------------------------------------------------------------------

def load_upscaler(path: str, device) -> list:
    """[(OIHW weight, bias)] of Conv_0..Conv_3 from the flax-keyed npz
    (HWIO kernels)."""
    with np.load(path) as d:
        return [(torch.as_tensor(np.array(d[f"Conv_{i}/kernel"], np.float32))
                 .permute(3, 2, 0, 1).contiguous().to(device),
                 torch.as_tensor(np.array(d[f"Conv_{i}/bias"], np.float32))
                 .to(device)) for i in range(4)]


def _conv(x, wb, dtype):
    w, b = wb
    if dtype in (torch.bfloat16, torch.float32):
        y = F.conv2d(x.to(dtype), w.to(dtype), padding=1)
    else:
        # A float8 trunk: operands rounded to float8 (e4m3), products
        # accumulated in bfloat16's convolution, as a float8 kernel
        # with a wide accumulator would.
        y = F.conv2d(x.to(dtype).to(torch.bfloat16),
                     w.to(dtype).to(torch.bfloat16), padding=1)
    return y.to(torch.float32) + b[:, None, None]


def _shuffle(t, c: int):
    h, w = t.shape[-3:-1]
    t = t.reshape(h, w, 2, 2, c).transpose(-4, -3)
    return t.reshape(2 * h, 2 * w, c)


def _space_to_depth2(img):
    h2, w2, c = img.shape
    x = img.reshape(h2 // 2, 2, w2 // 2, 2, c).transpose(-4, -3)
    return x.reshape(h2 // 2, w2 // 2, 4 * c)


def _up_bilinear2(img):
    h, w, c = img.shape
    x = img.permute(2, 0, 1)[None]
    up = F.interpolate(x, scale_factor=2, mode="bilinear",
                       align_corners=False)
    return up[0].permute(1, 2, 0)


def _up_corner2(img):
    h, w, c = img.shape
    right = torch.cat([img[:, 1:], img[:, -1:]], dim=1)
    wide = torch.stack([img, (img + right) * 0.5], dim=2).reshape(h, 2 * w, c)
    down = torch.cat([wide[1:], wide[-1:]], dim=0)
    return torch.stack([wide, (wide + down) * 0.5], dim=1) \
        .reshape(2 * h, 2 * w, c)


def reproject(hist, world_pos, hit, prev_cam):
    """The previous HR output warped onto this frame -> (2H, 2W, 4) rgb
    and validity (0 out of bounds or on a miss)."""
    h2, w2 = hist.shape[0], hist.shape[1]
    wp = _up_corner2(world_pos)
    hm = hit.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)
    px, py = project(wp, prev_cam, w2, h2)
    val, inb = warp(hist, px, py)
    ok = (inb & (hm > 0.5))[..., None]
    return torch.cat([torch.where(ok, val, 0.0), ok.to(torch.float32)], -1)


def upscale_temporal(convs, lr, hist, dtype=torch.bfloat16):
    """lr (H, W, 3), hist (2H, 2W, 4) -> (2H, 2W, 3)."""
    x = torch.cat([lr, _space_to_depth2(hist)], dim=-1)
    x = x.permute(2, 0, 1)[None]
    for wb in convs[:3]:
        x = F.relu(_conv(x, wb, dtype))
    head = _conv(x, convs[3], dtype)[0].permute(1, 2, 0)
    residual = _shuffle(head[..., :12], 3)
    alpha = torch.sigmoid(_shuffle(head[..., 12:16], 1))
    spatial = _up_bilinear2(lr) + residual
    return spatial + alpha * hist[..., 3:4] * (hist[..., :3] - spatial)


def post_frame(img, gb, frame: int, prev_cam, state: dict, flags: dict,
               convs=None, up_dtype=torch.bfloat16):
    """The post stages of one frame from the state before it (`accum`,
    `svgf` an SvgfState, `up_history`) -> (output, new state dict)."""
    h, w = img.shape[0], img.shape[1]
    new = dict(state)
    if flags.get("accumulate"):
        img = accumulate(state["accum"], img, frame)
        new["accum"] = img
    if flags.get("denoise"):
        img, new["svgf"] = svgf(state["svgf"], img, gb, prev_cam, w, h)
    if flags.get("upscale") == 2:
        if flags.get("upscale_mode") != "temporal":
            raise ValueError("the reference has the temporal upscaler only")
        hist = reproject(state["up_history"], gb["world_pos"], gb["hit"],
                         prev_cam)
        if frame <= 0:
            hist = torch.cat([hist[..., :3], torch.zeros_like(hist[..., 3:4])],
                             dim=-1)
        img = upscale_temporal(convs, img, hist, up_dtype)
        new["up_history"] = img
    return img, new
