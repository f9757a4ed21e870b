"""Light records as a flat (L, LIGHT_W) float32 table.

Layout as in the JAX package (hrt_tpu/models/lights.py):
  0:3 position | 3:6 color | 6 intensity | 7 type (0 point, 1 spot,
  2 directional) | 8:11 direction (zero: the reference's fixed
  fallback) | 11 cos(cone half-angle)
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import v3
from ..ops.v3 import V3

LIGHT_W = 12
POSITION = slice(0, 3)
COLOR = slice(3, 6)
INTENSITY = 6
TYPE = 7
DIRECTION = slice(8, 11)
COS_CONE = 11

POINT = 0
SPOT = 1
DIRECTIONAL = 2

_DEFAULT_DIR = (0.9, -0.1, 0.0)


def make_light(position, color, intensity: float,
               light_type: int = POINT, direction=(0.0, 0.0, 0.0),
               cone_angle: float = 0.0) -> np.ndarray:
    rec = np.zeros(LIGHT_W, np.float32)
    rec[POSITION] = position
    rec[COLOR] = color
    rec[INTENSITY] = intensity
    rec[TYPE] = light_type
    rec[DIRECTION] = direction
    rec[COS_CONE] = np.cos(cone_angle) if cone_angle else -1.0
    return rec


def process_light_one(light: torch.Tensor, p: V3):
    """processLight for ONE light row (LIGHT_W,) against a V3 of world
    positions.  Returns (to_light V3 unnormalized, color V3 of 0-d
    tensors, intensity plane, unbounded 0-d bool)."""
    lint = light[INTENSITY]
    ltype = light[TYPE]
    ldir = V3(light[8], light[9], light[10])
    has_dir = v3.dot(ldir, ldir) > 1e-12

    to_light_pt = V3(light[0] - p.x, light[1] - p.y, light[2] - p.z)
    d2 = v3.dot(to_light_pt, to_light_pt)
    falloff = lint / torch.clamp(d2, min=1e-12)

    is_point = ltype == POINT
    is_spot = ltype == SPOT
    is_dir = ltype == DIRECTIONAL

    axis = ldir * (1.0 / torch.clamp(torch.sqrt(v3.dot(ldir, ldir)),
                                     min=1e-12))
    cos_to = v3.dot(-to_light_pt, axis) / torch.clamp(torch.sqrt(d2),
                                                      min=1e-12)
    in_cone = cos_to >= light[COS_CONE]
    spot_int = falloff * in_cone.to(torch.float32)

    fixed = V3(*(torch.tensor(c, dtype=torch.float32, device=light.device)
                 for c in _DEFAULT_DIR))
    dir_to_light = v3.where(has_dir, -ldir, fixed)

    intensity = torch.where(is_point, falloff,
                            torch.where(is_spot & has_dir, spot_int, lint))
    ones = torch.ones_like(p.x)
    direction = v3.where(is_point | is_spot, to_light_pt,
                         dir_to_light * ones)
    unbounded = is_dir & has_dir
    color = V3(light[3], light[4], light[5])
    return direction, color, intensity, unbounded


def process_light(lights: torch.Tensor, world_pos: torch.Tensor):
    """processLight over every light at once (the JAX package's
    `process_light`).  lights: (L, LIGHT_W); world_pos: (..., 3).
    Returns (to_light (..., L, 3) unnormalized, color (L, 3), intensity
    (..., L), unbounded shadow (L,) bool): a point light falls off with
    1/d^2, a spot light also cuts at its cone, a directional light with
    a direction shines along it unbounded and unattenuated, and a
    non-point light without one takes the reference's fixed direction."""
    lpos = lights[:, POSITION]
    lcol = lights[:, COLOR]
    lint = lights[:, INTENSITY]
    ltype = lights[:, TYPE]
    ldir = lights[:, DIRECTION]
    has_dir = torch.sum(ldir * ldir, -1) > 1e-12

    to_light_pt = lpos - world_pos[..., None, :]
    d2 = torch.sum(to_light_pt * to_light_pt, dim=-1)
    falloff = lint / torch.clamp(d2, min=1e-12)

    is_point = ltype == POINT
    is_spot = ltype == SPOT
    is_dir = ltype == DIRECTIONAL

    axis = ldir / torch.clamp(
        torch.sqrt(torch.sum(ldir * ldir, -1, keepdim=True)), min=1e-12)
    cos_to = torch.sum(-to_light_pt * axis, -1) / torch.clamp(
        torch.sqrt(d2), min=1e-12)
    in_cone = cos_to >= lights[:, COS_CONE]
    spot_int = falloff * in_cone.to(torch.float32)

    fixed = torch.tensor(_DEFAULT_DIR, dtype=torch.float32,
                         device=lights.device)
    dir_to_light = torch.where(has_dir[:, None], -ldir, fixed)

    intensity = torch.where(is_point, falloff,
                            torch.where(is_spot & has_dir, spot_int, lint))
    direction = torch.where((is_point | is_spot)[:, None], to_light_pt,
                            dir_to_light)
    unbounded = is_dir & has_dir
    return direction, lcol, intensity, unbounded
