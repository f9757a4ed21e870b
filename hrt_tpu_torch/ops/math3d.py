"""Vector math over (..., 3) arrays (hrt_tpu/ops/math3d.py, the part
the post stages and the pbr BSDF call)."""
from __future__ import annotations

import torch

EPS = 1e-8
# Rec.709 luminance weights.
_LUMA = (0.2126, 0.7152, 0.0722)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the last axis -> (...,)."""
    return torch.sum(a * b, dim=-1)


def normalize(a: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """a / |a|, with |a|^2 floored at eps."""
    return a * torch.reciprocal(torch.sqrt(torch.clamp(
        torch.sum(a * a, dim=-1, keepdim=True), min=eps)))


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    """Rec.709 luminance of (..., 3) linear RGB -> (...,)."""
    w = torch.tensor(_LUMA, dtype=torch.float32, device=rgb.device)
    return torch.sum(rgb * w, dim=-1)
