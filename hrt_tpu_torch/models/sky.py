"""Procedural sky: gradient plus sun disc and glow.

Same (SKY_W_FULL,) table layout and math as the JAX package
(hrt_tpu/models/sky.py); `enabled=False` gives the reference's black
miss.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.math3d import normalize
from ..ops.v3 import V3

# The JAX package's table width constant (its 20 leading columns; the
# table itself is SKY_W_FULL wide, glow size and light radiance last).
SKY_W = 20
SKY_COLOR = slice(0, 3)
HORIZON_COLOR = slice(3, 6)
GROUND_COLOR = slice(6, 9)
SUN_DIRECTION = slice(9, 12)
UP_DIRECTION = slice(12, 15)
BRIGHTNESS = 15
HORIZON_SIZE = 16
ANGULAR_SIZE = 17
GLOW_INTENSITY = 18
GLOW_SHARPNESS = 19
SKY_W_FULL = 22
GLOW_SIZE = 20
LIGHT_RADIANCE = 21


def default_sky() -> np.ndarray:
    """Defaults as Scene::createSky in the reference."""
    s = np.zeros(SKY_W_FULL, np.float32)
    s[SKY_COLOR] = (0.17, 0.24, 0.31)
    s[HORIZON_COLOR] = (1.0, 0.5, 0.31)
    s[GROUND_COLOR] = (0.1, 0.06, 0.04)
    s[SUN_DIRECTION] = (0.9, -0.1, 0.0)
    s[UP_DIRECTION] = (0.0, -1.0, 0.0)  # y-down world
    s[BRIGHTNESS] = 0.8
    s[HORIZON_SIZE] = 0.5
    s[ANGULAR_SIZE] = 0.08
    s[GLOW_INTENSITY] = 2.5
    s[GLOW_SHARPNESS] = 0.2
    s[GLOW_SIZE] = 0.2
    s[LIGHT_RADIANCE] = 0.7
    return s


def eval_sky_p(sky: torch.Tensor, d: V3, enabled: bool = True) -> V3:
    """Sky radiance for a V3 of unit directions."""
    if not enabled:
        z = torch.zeros_like(d.x)
        return V3(z, z, z)
    up = normalize(sky[UP_DIRECTION])
    sun = normalize(sky[SUN_DIRECTION])
    elev = d.x * up[0] + d.y * up[1] + d.z * up[2]
    horizon_size = torch.clamp(sky[HORIZON_SIZE], min=1e-3)
    t_sky = torch.clamp(elev / horizon_size, 0.0, 1.0)
    t_gnd = torch.clamp(-elev / horizon_size, 0.0, 1.0)
    hor = V3(sky[3], sky[4], sky[5])
    skc = V3(sky[0], sky[1], sky[2])
    gnd = V3(sky[6], sky[7], sky[8])
    base = hor * ((1.0 - t_sky) * (1.0 - t_gnd)) + skc * t_sky \
        + gnd * t_gnd
    cos_sun = d.x * sun[0] + d.y * sun[1] + d.z * sun[2]
    cos_disc = torch.cos(sky[ANGULAR_SIZE])
    disc = (cos_sun >= cos_disc).to(torch.float32) * sky[LIGHT_RADIANCE]
    ang = torch.arccos(torch.clamp(cos_sun, -1.0, 1.0))
    glow = sky[GLOW_INTENSITY] * torch.exp(
        -(ang - sky[ANGULAR_SIZE])
        / torch.clamp(sky[GLOW_SIZE], min=1e-3)
        * torch.clamp(sky[GLOW_SHARPNESS], min=1e-3) * 10.0
    ) * (cos_sun > 0).to(torch.float32)
    above = (elev > -horizon_size).to(torch.float32)
    sun_term = (disc + glow) * above
    return base * sky[BRIGHTNESS] + sun_term


def eval_sky(sky: torch.Tensor, directions: torch.Tensor,
             enabled: bool = True) -> torch.Tensor:
    """Sky radiance for unit directions (..., 3) -> (..., 3); zeros of
    the directions' shape when not enabled.  The array form of
    eval_sky_p."""
    if not enabled:
        return torch.zeros(directions.shape, dtype=torch.float32,
                           device=directions.device)
    return eval_sky_p(sky, V3.from_array(directions)).to_array()
