"""Closest-hit and occlusion queries over an Accel, with the JAX
package's signatures (hrt_tpu/ops/traversal.py): the planar `_p` forms
(rays as V3s of (N,) planes) and the array forms (rays (N, 3)), which
wrap them.  The JAX package's `use_pallas` switch has no counterpart:
every form walks the accel's tables.

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

from . import intersect, traversal_skip, traversal_wide8
from .v3 import V3


def _walk(accel, plain: bool):
    walk = traversal_skip if accel.w8 is None else traversal_wide8
    return walk.trace_plain if plain else walk.trace


def closest_hit_bvh_p(scene, accel, o: V3, d: V3, t_min, t_max,
                      sorted_ids: bool = False, plain: bool = False):
    """(t, tri, u, v) of the closest hit; tri is -1 on a miss.
    sorted_ids=True returns leaf-pool ids (for Accel.attr shading),
    otherwise original triangle ids."""
    t, tri, u, v = _walk(accel, plain)(accel, *intersect.ray_planes(o, d, t_max),
                                       float(t_min), True)
    if sorted_ids:
        return t, tri, u, v
    orig = torch.where(tri >= 0, accel.tri_perm[tri.clamp(min=0).long()], -1)
    return t, orig, u, v


def any_hit_bvh_p(scene, accel, o: V3, d: V3, t_min, t_max,
                  plain: bool = False) -> torch.Tensor:
    """Occlusion of the segments (t_min, t_max): bool (N,)."""
    return _walk(accel, plain)(accel, *intersect.ray_planes(o, d, t_max),
                               float(t_min), False)


def closest_hit_bvh(scene, accel, o, d, t_min, t_max,
                    sorted_ids: bool = False, plain: bool = False):
    """closest_hit_bvh_p on (N, 3) rays."""
    return closest_hit_bvh_p(scene, accel, V3.from_array(o),
                             V3.from_array(d), t_min, t_max,
                             sorted_ids=sorted_ids, plain=plain)


def any_hit_bvh(scene, accel, o, d, t_min, t_max,
                plain: bool = False) -> torch.Tensor:
    """any_hit_bvh_p on (N, 3) rays."""
    return any_hit_bvh_p(scene, accel, V3.from_array(o), V3.from_array(d),
                         t_min, t_max, plain=plain)
