"""30-bit Morton (Z-order) codes, bit for bit as hrt_tpu/ops/morton.py,
in two forms: host numpy uint32 (`morton_codes`), which orders the wide
TLAS's instances (ops/wide8.build_wide8_tlas), and torch on any device
(`morton_codes_torch`), which orders the triangle LBVH (ops/lbvh.py
`lbvh_tree`) and the binary TLAS (ops/tlas.py).

torch.uint32 lacks add, shifts and comparisons, so the torch codes are
int64 holding uint32 values.  The interleave's products cannot overflow
int64 (each stays below 2^35), and masking them gives the low 32 bits
that wrapping uint32 products give."""
from __future__ import annotations

import numpy as np
import torch

_U = np.uint32


def expand_bits_10(v: np.ndarray) -> np.ndarray:
    """Spread the low 10 bits of v so there are 2 zero bits between
    each (the magic-number interleave; uint32 products wrap)."""
    v = np.asarray(v).astype(_U) & _U(0x3FF)
    v = (v * _U(0x00010001)) & _U(0xFF0000FF)
    v = (v * _U(0x00000101)) & _U(0x0F00F00F)
    v = (v * _U(0x00000011)) & _U(0xC30C30C3)
    v = (v * _U(0x00000005)) & _U(0x49249249)
    return v


def morton3d(x: np.ndarray, y: np.ndarray, z: np.ndarray) -> np.ndarray:
    """Interleave three 10-bit integers into a 30-bit Morton code."""
    return (expand_bits_10(x) << _U(2)) | (expand_bits_10(y) << _U(1)) \
        | expand_bits_10(z)


def quantize_centroids(centroids: np.ndarray, bounds_min: np.ndarray,
                       bounds_max: np.ndarray) -> np.ndarray:
    """Quantize float32 points (N, 3) into the 10-bit lattice of
    [bmin, bmax]."""
    f32 = np.float32
    centroids = np.asarray(centroids, f32)
    bounds_min = np.asarray(bounds_min, f32)
    extent = np.maximum(np.asarray(bounds_max, f32) - bounds_min, f32(1e-9))
    q = (centroids - bounds_min) / extent
    return np.clip(q * f32(1024.0), f32(0.0), f32(1023.0)).astype(_U)


def morton_codes(centroids: np.ndarray, bounds_min: np.ndarray,
                 bounds_max: np.ndarray) -> np.ndarray:
    q = quantize_centroids(centroids, bounds_min, bounds_max)
    return morton3d(q[:, 0], q[:, 1], q[:, 2])


def _expand_bits_10_torch(v: torch.Tensor) -> torch.Tensor:
    v = v & 0x3FF
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton_codes_torch(centroids: torch.Tensor, bounds_min: torch.Tensor,
                       bounds_max: torch.Tensor) -> torch.Tensor:
    """(N,) int64 codes of float32 points (N, 3) on their device, with
    the JAX package's quantisation in its operation order."""
    extent = torch.clamp(bounds_max - bounds_min, min=1e-9)
    q = (centroids - bounds_min) / extent
    q = torch.clamp(q * 1024.0, 0.0, 1023.0).to(torch.int64)
    return (_expand_bits_10_torch(q[:, 0]) << 2) \
        | (_expand_bits_10_torch(q[:, 1]) << 1) \
        | _expand_bits_10_torch(q[:, 2])
