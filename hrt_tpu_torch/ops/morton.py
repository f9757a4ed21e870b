"""30-bit Morton (Z-order) codes, bit for bit as hrt_tpu/ops/morton.py,
in torch on any device: they order the triangle LBVH (ops/lbvh.py
`lbvh_tree`) and both TLAS forms (ops/tlas.py, ops/wide8.py).

torch.uint32 lacks add, shifts and comparisons, so the codes are int64
holding uint32 values.  The interleave's products cannot overflow int64
(each stays below 2^35), and masking them gives the low 32 bits that
wrapping uint32 products give."""
from __future__ import annotations

import torch


def _expand_bits_10(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v so there are 2 zero bits between
    each (the magic-number interleave)."""
    v = v & 0x3FF
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton_codes(centroids: torch.Tensor, bounds_min: torch.Tensor,
                 bounds_max: torch.Tensor) -> torch.Tensor:
    """(N,) int64 codes of float32 points (N, 3) on their device, with
    the JAX package's quantisation into the 10-bit lattice of [bmin,
    bmax] in its operation order."""
    extent = torch.clamp(bounds_max - bounds_min, min=1e-9)
    q = (centroids - bounds_min) / extent
    q = torch.clamp(q * 1024.0, 0.0, 1023.0).to(torch.int64)
    return (_expand_bits_10(q[:, 0]) << 2) \
        | (_expand_bits_10(q[:, 1]) << 1) \
        | _expand_bits_10(q[:, 2])
