"""30-bit Morton (Z-order) codes on the host, numpy uint32, bit for bit
as hrt_tpu/ops/morton.py.  The port orders TLAS instances by them
(ops/wide8.build_wide8_tlas); the triangle LBVH that also uses them in
the JAX package is not ported yet."""
from __future__ import annotations

import numpy as np

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
