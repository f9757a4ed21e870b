"""Closest-hit and occlusion queries over an Accel, with the JAX
package's planar signatures (hrt_tpu/ops/traversal.py).

The walk follows the accel's tables, as the JAX package routes them: an
Accel with a BVH8 table goes to K1 (ops/traversal_wide8.py), one without
(an LBVH, or a SAH tree past MAX_WIDE_NODES) to K3
(ops/traversal_skip.py).  A CUDA tensor launches the walk's kernel, a CPU
tensor runs its plain version.  `plain=True` runs the plain version on
any device: the smoke run uses it to render a reference frame on the
card.
"""
from __future__ import annotations

import torch

from . import traversal_skip, traversal_wide8
from .v3 import V3


def _planes(o: V3, d: V3, t_max):
    n = o.x.shape[0]
    tmax = torch.broadcast_to(torch.as_tensor(
        t_max, dtype=torch.float32, device=o.x.device), (n,))
    return (o.x, o.y, o.z, d.x, d.y, d.z, tmax)


def _walk(accel, plain: bool):
    walk = traversal_skip if accel.w8 is None else traversal_wide8
    return walk.trace_plain if plain else walk.trace


def closest_hit_bvh_p(scene, accel, o: V3, d: V3, t_min, t_max,
                      sorted_ids: bool = False, plain: bool = False):
    """(t, tri, u, v) of the closest hit; tri is -1 on a miss.
    sorted_ids=True returns leaf-pool ids (for Accel.attr shading),
    otherwise original triangle ids."""
    t, tri, u, v = _walk(accel, plain)(accel, *_planes(o, d, t_max),
                                       float(t_min), True)
    if sorted_ids:
        return t, tri, u, v
    orig = torch.where(tri >= 0, accel.tri_perm[tri.clamp(min=0).long()], -1)
    return t, orig, u, v


def any_hit_bvh_p(scene, accel, o: V3, d: V3, t_min, t_max,
                  plain: bool = False) -> torch.Tensor:
    """Occlusion of the segments (t_min, t_max): bool (N,)."""
    return _walk(accel, plain)(accel, *_planes(o, d, t_max),
                               float(t_min), False)
