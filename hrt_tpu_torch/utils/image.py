"""Frame output: tonemap, the PNG writer, the HDR npz writer and the
image metrics (hrt_tpu/utils/image.py).

PNG files are written with the standard library alone (zlib + struct):
8-bit RGB, one IDAT of filter-0 rows.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def tonemap(hdr: np.ndarray, exposure: float = 1.0,
            gamma: float = 2.2) -> np.ndarray:
    """Exposure + gamma to 8-bit; gamma=1.0 keeps linear values."""
    x = np.clip(np.asarray(hdr, np.float32) * exposure, 0.0, 1.0)
    if gamma != 1.0:
        x = x ** (1.0 / gamma)
    return (x * 255.0 + 0.5).astype(np.uint8)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(rgb8: np.ndarray, level: int = 6) -> bytes:
    """The PNG file of an (H, W, 3) uint8 image, its rows unfiltered
    (filter 0) in one IDAT deflated at zlib `level`."""
    arr = np.asarray(rgb8)
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) uint8 image, got "
                         f"{arr.dtype} {arr.shape}")
    h, w = arr.shape[:2]
    raw = np.zeros((h, 1 + 3 * w), np.uint8)
    raw[:, 1:] = arr.reshape(h, 3 * w)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (_PNG_SIG + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_png(path: str, rgb8: np.ndarray) -> None:
    """Write an (H, W, 3) image; float input is tonemapped first."""
    arr = np.asarray(rgb8)
    if arr.dtype != np.uint8:
        arr = tonemap(arr)
    with open(path, "wb") as f:
        f.write(encode_png(arr))


def write_hdr_npz(path: str, **arrays) -> None:
    np.savez_compressed(path, **{k: np.asarray(v) for k, v in arrays.items()})


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(peak * peak / mse)


def ssim(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    """Global SSIM over one window (the whole image)."""
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    c1 = (0.01 * peak) ** 2
    c2 = (0.03 * peak) ** 2
    mu_a, mu_b = a.mean(), b.mean()
    va, vb = a.var(), b.var()
    cov = ((a - mu_a) * (b - mu_b)).mean()
    return float(
        ((2 * mu_a * mu_b + c1) * (2 * cov + c2))
        / ((mu_a**2 + mu_b**2 + c1) * (va + vb + c2))
    )
