"""The sorted bounce wavefront's key (hrt_tpu/ops/wavefront.py
`bounce_sort_key_p`), bit for bit.  The JAX module's block layouts
(`to_blocks`, `walk_block_*`) arrange rays for the TPU's packet tiles
and have no counterpart here: the port sorts the wavefront by this key
with one torch.sort and index gathers (renderer.trace_paths).
"""
from __future__ import annotations

import torch

from .v3 import V3

# Position and direction bits per axis of the key.
_PB, _DB = 8, 2


def bounce_sort_key_p(o: V3, d: V3) -> torch.Tensor:
    """6-D Morton code over (origin, direction), int64 holding the
    JAX package's 30-bit uint32 key: 8 position bits per axis over the
    origins' bounding box (taken over every ray, dead ones included)
    and 2 direction bits per axis, interleaved bit plane by bit plane,
    most significant first, x y z then dx dy dz within a plane."""
    lo = [torch.amin(c) for c in o]
    extent = [torch.clamp(torch.amax(c) - l, min=1e-9)
              for c, l in zip(o, lo)]

    def qp(c, i):
        q = torch.clamp((c - lo[i]) / extent[i], 0.0, 1.0 - 1e-7)
        return torch.clamp((q * (1 << _PB)).to(torch.int64),
                           max=(1 << _PB) - 1)

    def qd(c):
        q = torch.clamp((c + 1.0) * 0.5, 0.0, 1.0 - 1e-7)
        return torch.clamp((q * (1 << _DB)).to(torch.int64),
                           max=(1 << _DB) - 1)

    chans = [(qp(o.x, 0), _PB), (qp(o.y, 1), _PB), (qp(o.z, 2), _PB),
             (qd(d.x), _DB), (qd(d.y), _DB), (qd(d.z), _DB)]
    out = torch.zeros(o.x.shape, dtype=torch.int64, device=o.x.device)
    for level in range(_PB - 1, -1, -1):
        for v, b in chans:
            if level < b:
                out = (out << 1) | ((v >> level) & 1)
    return out
