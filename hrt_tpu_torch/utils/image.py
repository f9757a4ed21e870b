"""Frame output: tonemap, PNG writer and PSNR (hrt_tpu/utils/image.py)."""
from __future__ import annotations

import numpy as np


def tonemap(hdr: np.ndarray, exposure: float = 1.0,
            gamma: float = 2.2) -> np.ndarray:
    """Exposure + gamma to 8-bit; gamma=1.0 keeps linear values."""
    x = np.clip(np.asarray(hdr, np.float32) * exposure, 0.0, 1.0)
    if gamma != 1.0:
        x = x ** (1.0 / gamma)
    return (x * 255.0 + 0.5).astype(np.uint8)


def save_png(path: str, img: np.ndarray) -> None:
    """Write an (H, W, 3) image; float input is tonemapped first."""
    from PIL import Image

    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = tonemap(arr)
    Image.fromarray(arr, mode="RGB").save(path)


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(peak * peak / mse)
