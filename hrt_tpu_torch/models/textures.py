"""Base-color image textures (hrt_tpu/models/textures.py): one packed
(K, R, R, 3) float32 table, every image resized on the host to a common
R, sampled bilinearly with wrap addressing at the hit's interpolated
UV.  A material's texture id rides in its record's last column
(materials.BASE_COLOR_TEX; -1 means none).
"""
from __future__ import annotations

import numpy as np
import torch

TEX_RES = 256


def _resize_host(img: np.ndarray, res: int) -> np.ndarray:
    """Bilinear resize to (res, res, 3).  Integer images are scaled by
    their dtype's maximum into [0, 1]; float images are taken as linear
    values (HDR ones above 1 stay so)."""
    in_dtype = np.asarray(img).dtype
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[:, :, None]
    if img.shape[2] == 1:
        img = np.repeat(img, 3, axis=2)
    img = img[:, :, :3]
    if np.issubdtype(in_dtype, np.integer):
        img = img / np.float32(np.iinfo(in_dtype).max)
    h, w = img.shape[:2]
    if (h, w) == (res, res):
        return img
    ys = np.linspace(0, h - 1, res)
    xs = np.linspace(0, w - 1, res)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    fy = (ys - y0)[:, None, None]
    fx = (xs - x0)[None, :, None]
    a = img[y0][:, x0] * (1 - fy) * (1 - fx)
    b = img[y0][:, x1] * (1 - fy) * fx
    c = img[y1][:, x0] * fy * (1 - fx)
    d = img[y1][:, x1] * fy * fx
    return (a + b + c + d).astype(np.float32)


def pack_textures(images: list, res: int = TEX_RES) -> np.ndarray:
    """The scene's (K, res, res, 3) texture table; (0, res, res, 3)
    without images."""
    if not images:
        return np.zeros((0, res, res, 3), np.float32)
    return np.stack([_resize_host(im, res) for im in images])


def sample_texture_p(textures: torch.Tensor, tex_id: torch.Tensor,
                     u: torch.Tensor, v: torch.Tensor):
    """Bilinear sample with wrap addressing.  textures (K, R, R, 3);
    tex_id (N,) int, < 0 untextured; u, v (N,) hit UVs, any value (the
    fractional part addresses the image; v runs bottom-up, image rows
    top-down).  Returns (x, y, z) (N,) planes, 1.0 where untextured."""
    k, r = textures.shape[0], textures.shape[1]
    flat = textures.reshape(-1, 3)
    uu = (u - torch.floor(u)) * r
    vv = (1.0 - (v - torch.floor(v))) * r
    x0 = torch.floor(uu)
    y0 = torch.floor(vv)
    fx = uu - x0
    fy = vv - y0
    x0 = x0.to(torch.int64) % r
    y0 = y0.to(torch.int64) % r
    x1 = (x0 + 1) % r
    y1 = (y0 + 1) % r
    safe = torch.clamp(tex_id.to(torch.int64), 0, k - 1) * (r * r)

    def tap(yy, xx):
        return flat[safe + yy * r + xx]                 # (N, 3)

    val = (tap(y0, x0) * ((1 - fx) * (1 - fy))[:, None]
           + tap(y0, x1) * (fx * (1 - fy))[:, None]
           + tap(y1, x0) * ((1 - fx) * fy)[:, None]
           + tap(y1, x1) * (fx * fy)[:, None])
    val = torch.where((tex_id >= 0)[:, None], val, 1.0)
    return val[:, 0], val[:, 1], val[:, 2]


def checkerboard(n: int = 8, res: int = 64,
                 a=(1.0, 1.0, 1.0), b=(0.1, 0.1, 0.1)) -> np.ndarray:
    """An n x n checkerboard of colors a and b, (res, res, 3)."""
    ys, xs = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
    cell = ((ys * n // res + xs * n // res) % 2).astype(np.float32)
    return (np.asarray(a, np.float32)[None, None] * (1 - cell[..., None])
            + np.asarray(b, np.float32)[None, None] * cell[..., None])
