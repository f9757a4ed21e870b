"""Light BVH: many-light importance sampling by stochastic descent
(hrt_tpu/ops/lightbvh.py, the paired-children form).

The tree is implicit and complete over the lights sorted by the Morton
code of their positions, padded to a power of two Lp with zero-energy
copies of the last light: node i of level k has children 2i and 2i + 1
of level k + 1, so a descent takes exactly log2(Lp) steps, each an
(N, 16) gather of the level's paired-children table and elementwise
math.  A ray picks a child with probability proportional to the
cluster's importance, energy / max(d(p, box)^2, 1e-2) + energy_dir
(directional lights carry their energy in the distance-free channel,
as they shade with no falloff), and reuses one uniform by rescaling it
into the chosen interval; the product of the branch probabilities is
the pick's exact pdf.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.lights import (_DEFAULT_DIR, COS_CONE, DIRECTIONAL, POINT,
                             SPOT, TYPE)
from . import v3
from .morton import morton_codes_torch
from .v3 import V3


class LightTree(NamedTuple):
    """Per-level cluster tensors, root (level 0, one node) to leaves
    (level D, Lp = 2^D nodes).  `perm` maps a leaf to its row of the
    light table (padding leaves repeat the last sorted light with zero
    energy).  pair[k] (2^k, 16) holds both children of each node of
    level k in one row: [bmin, bmax, energy, energy_dir] of the left
    child, then of the right."""

    bmin: tuple          # level k: (2^k, 3)
    bmax: tuple
    energy: tuple        # level k: (2^k,) positional (point, spot)
    energy_dir: tuple    # level k: (2^k,) directional (no falloff)
    perm: torch.Tensor   # (Lp,) int32
    pair: tuple = ()

    @property
    def depth(self) -> int:
        return len(self.energy) - 1


def _luminance(c: torch.Tensor) -> torch.Tensor:
    return 0.2126 * c[:, 0] + 0.7152 * c[:, 1] + 0.0722 * c[:, 2]


def build_light_tree(lights: torch.Tensor) -> LightTree:
    """The tree of an (L, LIGHT_W) light table, on its device.  The
    Morton order is a stable sort, as jnp.argsort's: lights that share a
    code keep their table order."""
    n = lights.shape[0]
    if n == 0:
        raise ValueError("no lights")
    lp = 1
    while lp < n:
        lp *= 2
    pos = lights[:, 0:3]
    energy = lights[:, 6] * (_luminance(lights[:, 3:6]) + 1e-6)
    ldir = lights[:, 8:11]
    is_dir = (lights[:, TYPE] == DIRECTIONAL) & (
        torch.sum(ldir * ldir, dim=1) > 1e-12)
    e_pos = torch.where(is_dir, 0.0, energy)
    e_dir = torch.where(is_dir, energy, 0.0)

    codes = morton_codes_torch(pos, pos.min(0).values, pos.max(0).values)
    order = torch.argsort(codes, stable=True).to(torch.int32)
    perm = torch.cat([order, order[-1:].expand(lp - n)])
    leaf_pos = pos[perm.long()]
    pad0 = torch.zeros((lp - n,), dtype=torch.float32, device=lights.device)
    leaf_e = torch.cat([e_pos[order.long()], pad0])
    leaf_ed = torch.cat([e_dir[order.long()], pad0])

    bmin, bmax, e, ed = [leaf_pos], [leaf_pos], [leaf_e], [leaf_ed]
    while bmin[0].shape[0] > 1:
        bmin.insert(0, torch.minimum(bmin[0][0::2], bmin[0][1::2]))
        bmax.insert(0, torch.maximum(bmax[0][0::2], bmax[0][1::2]))
        e.insert(0, e[0][0::2] + e[0][1::2])
        ed.insert(0, ed[0][0::2] + ed[0][1::2])
    pair = []
    for k in range(len(e) - 1):
        def half(s, k=k):
            return torch.cat([bmin[k + 1][s::2], bmax[k + 1][s::2],
                              e[k + 1][s::2, None], ed[k + 1][s::2, None]],
                             dim=1)
        pair.append(torch.cat([half(0), half(1)], dim=1).contiguous())
    return LightTree(bmin=tuple(bmin), bmax=tuple(bmax), energy=tuple(e),
                     energy_dir=tuple(ed), perm=perm, pair=tuple(pair))


def _importance_t(rt, base: int, p: V3) -> torch.Tensor:
    """Cluster importance from transposed paired rows (rt[i] an (N,)
    plane; base 0 is the left child, 8 the right)."""
    cx = torch.clamp(p.x, rt[base + 0], rt[base + 3]) - p.x
    cy = torch.clamp(p.y, rt[base + 1], rt[base + 4]) - p.y
    cz = torch.clamp(p.z, rt[base + 2], rt[base + 5]) - p.z
    d2 = cx * cx + cy * cy + cz * cz
    return rt[base + 6] / torch.clamp(d2, min=1e-2) + rt[base + 7]


def sample_light(tree: LightTree, p: V3, u: torch.Tensor):
    """One light per ray by stochastic descent.  p: shading positions,
    u: (N,) uniforms in [0, 1).  Returns (light row (N,) int32 into the
    light table, pdf (N,) float32: the pick's exact probability)."""
    n = u.shape[0]
    idx = torch.zeros((n,), dtype=torch.int64, device=u.device)
    pdf = torch.ones((n,), dtype=torch.float32, device=u.device)
    for k in range(tree.depth):
        rt = tree.pair[k][idx].T                           # (16, N)
        wl = _importance_t(rt, 0, p)
        wr = _importance_t(rt, 8, p)
        total = wl + wr
        pl = torch.where(total > 0, wl / torch.clamp(total, min=1e-30), 0.5)
        take_l = u < pl
        u = torch.clamp(torch.where(take_l, u / torch.clamp(pl, min=1e-12),
                                    (u - pl) / torch.clamp(1.0 - pl,
                                                           min=1e-12)),
                        0.0, 1.0 - 1e-7)
        pdf = pdf * torch.where(take_l, pl, 1.0 - pl)
        idx = torch.where(take_l, 2 * idx, 2 * idx + 1)
    return tree.perm[idx], pdf


def process_light_rows(rows: torch.Tensor, p: V3):
    """processLight where every ray carries its own light row (N,
    LIGHT_W): models/lights.process_light_one per ray.  Returns
    (to_light V3 unnormalized, color V3, intensity (N,), unbounded
    (N,) bool)."""
    rt = rows.T
    lint = rt[6]
    ltype = rt[TYPE]
    ldir = V3(rt[8], rt[9], rt[10])
    has_dir = v3.dot(ldir, ldir) > 1e-12

    to_light_pt = V3(rt[0] - p.x, rt[1] - p.y, rt[2] - p.z)
    d2 = v3.dot(to_light_pt, to_light_pt)
    falloff = lint / torch.clamp(d2, min=1e-12)

    is_point = ltype == POINT
    is_spot = ltype == SPOT
    is_dir = ltype == DIRECTIONAL

    axis = ldir * (1.0 / torch.clamp(torch.sqrt(v3.dot(ldir, ldir)),
                                     min=1e-12))
    cos_to = v3.dot(-to_light_pt, axis) / torch.clamp(torch.sqrt(d2),
                                                      min=1e-12)
    in_cone = cos_to >= rt[COS_CONE]
    spot_int = falloff * in_cone.to(torch.float32)

    fixed = V3(*(torch.full_like(p.x, c) for c in _DEFAULT_DIR))
    dir_to_light = v3.where(has_dir, -ldir, fixed)

    intensity = torch.where(is_point, falloff,
                            torch.where(is_spot & has_dir, spot_int, lint))
    direction = v3.where(is_point | is_spot, to_light_pt, dir_to_light)
    unbounded = is_dir & has_dir
    color = V3(rt[3], rt[4], rt[5])
    return direction, color, intensity, unbounded
