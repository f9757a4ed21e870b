"""Vector math over (..., 3) arrays, as hrt_tpu/ops/math3d.py: the
functions broadcast over leading batch dimensions, and the last axis is
the vector axis.  The planar (`V3`) forms that the frame's hot path
uses are in ops/v3.py."""
from __future__ import annotations

import torch

from .. import graphs
from . import v3
from .v3 import V3

EPS = 1e-8
# Rec.709 luminance weights.
_LUMA = (0.2126, 0.7152, 0.0722)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the last axis -> (...,)."""
    return torch.sum(a * b, dim=-1)


def dotk(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the last axis, kept as a size-1 axis -> (..., 1)."""
    return torch.sum(a * b, dim=-1, keepdim=True)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return v3.cross(V3.from_array(a), V3.from_array(b)).to_array()


def length(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp(dot(a, a), min=0.0))


def normalize(a: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """a / |a|, with |a|^2 floored at eps."""
    return a * torch.reciprocal(torch.sqrt(torch.clamp(dotk(a, a), min=eps)))


def square(x: torch.Tensor) -> torch.Tensor:
    return x * x


def reflect(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """HLSL/Slang reflect: v - 2 dot(v, n) n (v toward the surface)."""
    return v - 2.0 * dotk(v, n) * n


def orthonormal_basis(normal: torch.Tensor):
    """v3.orthonormal_basis (Frisvad, the z < -1 guard a select) around
    (..., 3) normals.  Returns (tangent, bitangent), each shaped like
    `normal`."""
    t, b = v3.orthonormal_basis(V3.from_array(normal))
    return t.to_array(), b.to_array()


def to_local(vec: torch.Tensor, normal: torch.Tensor,
             frame=None) -> torch.Tensor:
    """World -> tangent frame, +z == normal.  `frame`: a precomputed
    (tangent, bitangent)."""
    fr = None if frame is None else tuple(map(V3.from_array, frame))
    return v3.to_local(V3.from_array(vec), V3.from_array(normal),
                       fr).to_array()


def to_world(vec: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """Tangent frame -> world."""
    return v3.to_world(V3.from_array(vec), V3.from_array(normal)).to_array()


def transform_point(mat3x4: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A row-major 3x4 affine transform (..., 3, 4) applied to points
    (..., 3)."""
    return transform_dir(mat3x4, p) + mat3x4[..., :, 3]


def transform_dir(mat3x4: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """The linear part of a 3x4 transform applied to directions."""
    return torch.sum(mat3x4[..., :, :3] * d[..., None, :], dim=-1)


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    """Rec.709 luminance of (..., 3) linear RGB -> (...,)."""
    w = graphs.constant(_LUMA, rgb.device)
    return torch.sum(rgb * w, dim=-1)
