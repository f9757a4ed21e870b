"""Small math helpers (hrt_tpu/ops/math3d.py, the part the post stages
call)."""
from __future__ import annotations

import torch

# Rec.709 luminance weights.
_LUMA = (0.2126, 0.7152, 0.0722)


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    """Rec.709 luminance of (..., 3) linear RGB -> (...,)."""
    w = torch.tensor(_LUMA, dtype=torch.float32, device=rgb.device)
    return torch.sum(rgb * w, dim=-1)
