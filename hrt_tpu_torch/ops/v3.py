"""Planar 3-vectors: x/y/z as separate (N,) tensors.

The JAX package keeps per-ray vectors as three planes (hrt_tpu/ops/v3.py)
and its public functions take and return them.  The port keeps the same
layout so both packages can be fed the same numpy planes in the tests.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

EPS = 1e-8


class V3(NamedTuple):
    """Three same-shaped float32 planes. Supports +, -, *, /, unary -;
    `a * b` with two V3s is the componentwise product (colors too)."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return V3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, V3):
            return V3(self.x / o.x, self.y / o.y, self.z / o.z)
        return V3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    @staticmethod
    def from_array(a: torch.Tensor) -> "V3":
        """(..., 3) -> V3 of (...,) planes (views of `a`)."""
        return V3(a[..., 0], a[..., 1], a[..., 2])

    def to_array(self) -> torch.Tensor:
        """V3 -> (..., 3)."""
        return torch.stack(torch.broadcast_tensors(self.x, self.y, self.z),
                           dim=-1)

    def map(self, f) -> "V3":
        return V3(f(self.x), f(self.y), f(self.z))


def dot(a: V3, b: V3) -> torch.Tensor:
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: V3, b: V3) -> V3:
    return V3(a.y * b.z - a.z * b.y,
              a.z * b.x - a.x * b.z,
              a.x * b.y - a.y * b.x)


def length(a: V3) -> torch.Tensor:
    return torch.sqrt(torch.clamp(dot(a, a), min=0.0))


def normalize(a: V3, eps: float = EPS) -> V3:
    inv = torch.reciprocal(torch.sqrt(torch.clamp(dot(a, a), min=eps)))
    return a * inv


def where(mask, a: V3, b) -> V3:
    """Componentwise select; `b` may be a V3 or a scalar."""
    bx, by, bz = (b.x, b.y, b.z) if isinstance(b, V3) else (b, b, b)
    return V3(torch.where(mask, a.x, bx), torch.where(mask, a.y, by),
              torch.where(mask, a.z, bz))


def reflect(v: V3, n: V3) -> V3:
    """HLSL/Slang reflect: v - 2 dot(v, n) n (v toward the surface)."""
    return v - n * (2.0 * dot(v, n))


def max_component(a: V3) -> torch.Tensor:
    return torch.maximum(a.x, torch.maximum(a.y, a.z))


def orthonormal_basis(n: V3):
    """Branch-free Frisvad basis with the z < -1 guard, as the JAX
    package's v3.orthonormal_basis.  Returns (tangent, bitangent)."""
    degenerate = n.z < -0.99998796
    safe_nz = torch.where(degenerate, 0.0, n.z)
    a = 1.0 / (1.0 + safe_nz)
    b = -n.x * n.y * a
    tangent = V3(1.0 - n.x * n.x * a, b, -n.x)
    bitangent = V3(b, 1.0 - n.y * n.y * a, -n.y)
    t = V3(torch.where(degenerate, 0.0, tangent.x),
           torch.where(degenerate, -1.0, tangent.y),
           torch.where(degenerate, 0.0, tangent.z))
    bt = V3(torch.where(degenerate, -1.0, bitangent.x),
            torch.where(degenerate, 0.0, bitangent.y),
            torch.where(degenerate, 0.0, bitangent.z))
    return t, bt


def to_local(vec: V3, normal: V3, frame=None) -> V3:
    """World -> tangent frame, +z == normal."""
    tangent, bitangent = frame if frame is not None \
        else orthonormal_basis(normal)
    return V3(dot(vec, tangent), dot(vec, bitangent), dot(vec, normal))


def to_world(vec: V3, normal: V3, frame=None) -> V3:
    """Tangent frame -> world."""
    tangent, bitangent = frame if frame is not None \
        else orthonormal_basis(normal)
    return tangent * vec.x + bitangent * vec.y + normal * vec.z
