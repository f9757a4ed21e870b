"""Disney material records as a flat (M, MAT_W) float32 table.

Same column layout as the JAX package (hrt_tpu/models/materials.py):
  0:3 color | 3 subsurface | 4 metallic | 5 roughness | 6 specular |
  7 specularTint | 8 anisotropic | 9 sheen | 10 sheenTint |
  11 clearCoat | 12 clearCoatGloss | 13:16 emissiveColor |
  16 emissionStrength | 17 ior | 18 transmission | 19 texture id
Column 9 (sheen) is stored but never read by shading: the reference
BRDF omits the sheen scale, and MatP carries only sheen_tint.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

MAT_W = 20

COLOR = slice(0, 3)
SUBSURFACE = 3
METALLIC = 4
ROUGHNESS = 5
SPECULAR = 6
SPECULAR_TINT = 7
ANISOTROPIC = 8
SHEEN = 9
SHEEN_TINT = 10
CLEARCOAT = 11
CLEARCOAT_GLOSS = 12
EMISSIVE = slice(13, 16)
EMISSION_STRENGTH = 16
IOR = 17
TRANSMISSION = 18
BASE_COLOR_TEX = 19
# Floor of the roughness the bounce samplers use (the JAX package's
# materials.ROUGHNESS_MIN).
ROUGHNESS_MIN = 1e-4


class MatP(NamedTuple):
    """Material fields as per-ray planes; colors are V3s."""

    color: "object"
    subsurface: object
    metallic: object
    roughness: object
    specular: object
    specular_tint: object
    anisotropic: object
    sheen_tint: object
    clearcoat: object
    clearcoat_gloss: object
    emissive: "object"
    emission_strength: object
    ior: object
    transmission: object

    @staticmethod
    def from_rows_t(rt, base: int = 0) -> "MatP":
        """From transposed rows (W, N): every field is a row of `rt`.
        `base` is the row of the material block inside a wider table
        (lbvh.ATTR_MAT for Accel.attr)."""
        from ..ops.v3 import V3

        f = lambda i: rt[base + i]
        return MatP(
            color=V3(f(0), f(1), f(2)), subsurface=f(SUBSURFACE),
            metallic=f(METALLIC), roughness=f(ROUGHNESS),
            specular=f(SPECULAR), specular_tint=f(SPECULAR_TINT),
            anisotropic=f(ANISOTROPIC), sheen_tint=f(SHEEN_TINT),
            clearcoat=f(CLEARCOAT), clearcoat_gloss=f(CLEARCOAT_GLOSS),
            emissive=V3(f(13), f(14), f(15)),
            emission_strength=f(EMISSION_STRENGTH), ior=f(IOR),
            transmission=f(TRANSMISSION))


def make_material(
    color=(1.0, 1.0, 1.0),
    metallic: float = 0.0,
    roughness: float = 1.0,
    emissive_color=(0.0, 0.0, 0.0),
    emission_strength: float = 0.0,
    *,
    subsurface: float = 0.0,
    specular: float = 0.5,
    specular_tint: float = 0.0,
    anisotropic: float = 0.0,
    sheen: float = 0.0,
    sheen_tint: float = 0.0,
    clearcoat: float = 0.0,
    clearcoat_gloss: float = 0.0,
    ior: float = 1.5,
    transmission: float = 0.0,
    texture: int = -1,
) -> np.ndarray:
    """One material record; positional args match the JAX package."""
    m = np.zeros(MAT_W, np.float32)
    m[COLOR] = color
    m[SUBSURFACE] = subsurface
    m[METALLIC] = metallic
    m[ROUGHNESS] = roughness
    m[SPECULAR] = specular
    m[SPECULAR_TINT] = specular_tint
    m[ANISOTROPIC] = anisotropic
    m[SHEEN] = sheen
    m[SHEEN_TINT] = sheen_tint
    m[CLEARCOAT] = clearcoat
    m[CLEARCOAT_GLOSS] = clearcoat_gloss
    m[EMISSIVE] = emissive_color
    m[EMISSION_STRENGTH] = emission_strength
    m[IOR] = ior
    m[TRANSMISSION] = transmission
    m[BASE_COLOR_TEX] = float(texture)
    return m
