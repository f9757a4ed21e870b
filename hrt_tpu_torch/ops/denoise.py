"""SVGF-style temporal denoiser (hrt_tpu/ops/denoise.py).

Reprojection of each pixel's world position into the previous camera
and one bilinear fetch of all history channels packed (H, W, 10) through
K6 (ops/warp_kernel.py); validation by depth and normal; history clamp
to the current frame's 3x3 color box; temporal accumulation of color
and luminance moments; a spatial variance bootstrap for short
histories; a 5-level edge-aware a-trous wavelet filter.  Arrays are
(H, W, C), as in the JAX package, and every expression keeps its order
of operations.  Stencils are edge-clamped shifts (`_shift`).

Every entry point takes `plain=False`; `plain=True` routes the history
fetch to K6's plain version on whatever device the tensors are on.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .math3d import luminance
from .warp_kernel import warp_bilinear, warp_bilinear_plain


class DenoiseState(NamedTuple):
    """Temporal history carried between frames."""

    color: torch.Tensor     # (H, W, 3) accumulated illumination
    moments: torch.Tensor   # (H, W, 2) first/second luminance moments
    history: torch.Tensor   # (H, W, 1) frames accumulated per pixel
    depth: torch.Tensor     # (H, W, 1)
    normal: torch.Tensor    # (H, W, 3)


def init_state(h: int, w: int, device) -> DenoiseState:
    z = lambda c: torch.zeros((h, w, c), dtype=torch.float32, device=device)
    return DenoiseState(color=z(3), moments=z(2), history=z(1), depth=z(1),
                        normal=z(3))


def _shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Edge-clamped spatial shift (the stencil primitive)."""
    h, w = x.shape[0], x.shape[1]
    ys = torch.clamp(torch.arange(h, device=x.device) + dy, 0, h - 1)
    xs = torch.clamp(torch.arange(w, device=x.device) + dx, 0, w - 1)
    return x.index_select(0, ys).index_select(1, xs)


def _project(world_pos, cam_origin, cam_basis, tan_half_fovy, aspect,
             width, height):
    """World -> previous-frame pixel coordinates (the inverse of the
    primary-ray algebra).  Returns (px, py, z)."""
    rel = world_pos - cam_origin
    # camera space = basis @ rel (basis rows u, v, w)
    x = torch.sum(rel * cam_basis[0], -1)
    y = torch.sum(rel * cam_basis[1], -1)
    z = torch.sum(rel * cam_basis[2], -1)
    z = torch.clamp(z, min=1e-6)
    cx = x / (z * aspect * tan_half_fovy)
    cy = y / (z * tan_half_fovy)
    px = (cx + 1.0) * 0.5 * width
    py = (cy + 1.0) * 0.5 * height
    return px, py, z


def temporal_accumulate(state: DenoiseState, color, gbuffer, prev_cam,
                        width: int, height: int, alpha: float = 0.2,
                        alpha_moments: float = 0.2, plain: bool = False):
    """Reproject + clamp + accumulate.  Returns (illum, variance,
    new state without the spatial filter's color)."""
    normal = gbuffer["normal"]
    depth = gbuffer["depth"][..., None]
    world_pos = gbuffer["world_pos"]
    hit = gbuffer["hit"][..., None]

    px, py, _ = _project(world_pos, prev_cam.origin, prev_cam.basis,
                         prev_cam.tan_half_fovy, prev_cam.aspect,
                         width, height)
    packed = torch.cat([state.color, state.moments, state.history,
                        state.depth, state.normal], dim=-1)
    warp = warp_bilinear_plain if plain else warp_bilinear
    hist_all, inb = warp(packed, px, py)
    hist_color = hist_all[..., 0:3]
    hist_moments = hist_all[..., 3:5]
    hist_len = hist_all[..., 5:6]
    hist_depth = hist_all[..., 6:7]
    hist_normal = hist_all[..., 7:10]

    # Validity: reprojection in bounds, surface hit, consistent geometry.
    ndot = torch.sum(normal * hist_normal, -1, keepdim=True)
    zdiff = torch.abs(hist_depth - depth) / torch.clamp(depth, min=1e-3)
    valid = (inb[..., None] & (hit > 0.5) & (ndot > 0.7)
             & (zdiff < 0.1)).to(torch.float32)

    # History clamp: neighborhood color AABB of the current frame.
    cmin = color
    cmax = color
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            s = _shift(color, dy, dx)
            cmin = torch.minimum(cmin, s)
            cmax = torch.maximum(cmax, s)
    hist_color = torch.minimum(torch.maximum(hist_color, cmin), cmax)

    hist_len = (hist_len + 1.0) * valid + (1.0 - valid)
    a_c = torch.clamp(1.0 / hist_len, min=alpha)
    a_m = torch.clamp(1.0 / hist_len, min=alpha_moments)

    illum = hist_color + (color - hist_color) * a_c
    lum = luminance(color)[..., None]
    cur_moments = torch.cat([lum, lum * lum], dim=-1)
    moments = hist_moments + (cur_moments - hist_moments) * a_m
    variance = torch.clamp(moments[..., 1:2] - moments[..., 0:1] ** 2,
                           min=0.0)

    # Spatial variance bootstrap while history is short (< 4 frames).
    lum_sum = torch.zeros_like(lum)
    lum2_sum = torch.zeros_like(lum)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            s = _shift(lum, dy, dx)
            lum_sum = lum_sum + s
            lum2_sum = lum2_sum + s * s
    mean = lum_sum / 9.0
    spatial_var = torch.clamp(lum2_sum / 9.0 - mean * mean, min=0.0)
    variance = torch.where(hist_len < 4.0,
                           torch.maximum(variance, spatial_var), variance)

    new_state = DenoiseState(color=illum, moments=moments,
                             history=hist_len, depth=depth, normal=normal)
    return illum, variance, new_state


def atrous_filter(illum, variance, gbuffer, levels: int = 5,
                  sigma_l: float = 4.0, sigma_z: float = 1.0,
                  sigma_n: float = 128.0):
    """Edge-aware a-trous wavelet filter (3x3 B1 kernel with a stride
    doubling per level).  Filters variance alongside color."""
    normal = gbuffer["normal"]
    depth = gbuffer["depth"][..., None]
    hit = gbuffer["hit"][..., None]
    kernel = [1.0, 2.0 / 3.0, 1.0 / 6.0]  # distance-indexed weight

    for level in range(levels):
        stride = 1 << level
        lum_p = luminance(illum)[..., None]
        var_p = variance
        # Variance prefilter (3x3) steadies the luminance sigma.
        vsum = torch.zeros_like(var_p)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                vsum = vsum + _shift(var_p, dy, dx)
        sigma_lum = sigma_l * torch.sqrt(torch.clamp(vsum / 9.0, min=1e-10))

        acc_c = illum * kernel[0] ** 2
        acc_v = variance * (kernel[0] ** 2) ** 2
        acc_w = torch.full_like(lum_p, kernel[0] ** 2)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy == 0 and dx == 0:
                    continue
                h = kernel[abs(dy)] * kernel[abs(dx)]
                sy, sx = dy * stride, dx * stride
                q_c = _shift(illum, sy, sx)
                q_v = _shift(variance, sy, sx)
                q_l = _shift(lum_p, sy, sx)
                q_z = _shift(depth, sy, sx)
                q_n = _shift(normal, sy, sx)
                q_hit = _shift(hit, sy, sx)

                w_l = torch.exp(-torch.abs(q_l - lum_p)
                                / torch.clamp(sigma_lum, min=1e-10))
                w_z = torch.exp(-torch.abs(q_z - depth)
                                / (sigma_z * stride
                                   * torch.clamp(depth, min=1e-3)))
                w_n = torch.clamp(
                    torch.sum(q_n * normal, -1, keepdim=True), min=0.0
                ) ** sigma_n
                w = h * w_l * w_z * w_n * q_hit
                acc_c = acc_c + q_c * w
                acc_v = acc_v + q_v * w * w
                acc_w = acc_w + w
        illum = acc_c / torch.clamp(acc_w, min=1e-10)
        variance = acc_v / torch.clamp(acc_w, min=1e-10) ** 2
    return illum, variance


def svgf(state: DenoiseState, color, gbuffer, prev_cam, width: int,
         height: int, levels: int = 5, plain: bool = False):
    """Full SVGF step.  Returns (denoised (H, W, 3), new state).

    The new state's color history is the level-1 filtered illumination
    (the standard SVGF feedback choice)."""
    illum, variance, st = temporal_accumulate(state, color, gbuffer,
                                              prev_cam, width, height,
                                              plain=plain)
    if levels == 0:
        return illum, st
    fb, fb_var = atrous_filter(illum, variance, gbuffer, levels=1)
    out, _ = atrous_filter(fb, fb_var, gbuffer, levels=levels - 1)
    st = st._replace(color=fb)
    hit = gbuffer["hit"][..., None]
    out = out * hit + color * (1.0 - hit)  # keep sky/background crisp
    return out, st
