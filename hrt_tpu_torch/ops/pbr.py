"""The glTF metallic-roughness BSDF (hrt_tpu/ops/pbr.py, the reference's
second material model): a GGX + Smith glossy lobe over a Lambertian
base, read from whole material rows.  `brdf='pbr'` shades with it in
plain PyTorch; the Disney BRDF's kernel (K2) is not used for it.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models import materials as M
from .math3d import dot, normalize

PI = float(np.float32(3.1415926535897))


def fresnel_schlick(f0, vdoth):
    return f0 + (1.0 - f0) * torch.pow(
        torch.clamp(1.0 - vdoth, 0.0, 1.0), 5.0)[..., None]


def distribution_ggx(ndoth, alpha):
    a2 = alpha * alpha
    denom = ndoth * ndoth * (a2 - 1.0) + 1.0
    return a2 / torch.clamp(PI * denom * denom, min=1e-8)


def geometry_smith(ndotv, ndotl, alpha):
    k = alpha * alpha / 2.0
    gv = ndotv / torch.clamp(ndotv * (1.0 - k) + k, min=1e-8)
    gl = ndotl / torch.clamp(ndotl * (1.0 - k) + k, min=1e-8)
    return gv * gl


def bsdf_evaluate_simple(mat, n, v, l):
    """Diffuse + glossy BSDF value (no cosine), (..., 3).  mat: material
    rows (..., MAT_W); n, v, l: unit (..., 3) vectors, v toward the
    viewer, l toward the light.  Zero unless both v and l lie above the
    surface."""
    ndotl = dot(n, l)
    ndotv = dot(n, v)
    h = normalize(v + l)
    ndoth = torch.clamp(dot(n, h), min=0.0)
    vdoth = torch.clamp(dot(v, h), min=0.0)

    base = mat[..., M.COLOR]
    metallic = mat[..., M.METALLIC, None]
    rough = torch.clamp(mat[..., M.ROUGHNESS], 0.04, 1.0)

    f0 = 0.04 + (base - 0.04) * metallic
    f = fresnel_schlick(f0, vdoth)
    d = distribution_ggx(ndoth, rough)[..., None]
    g = geometry_smith(torch.clamp(ndotv, min=1e-4),
                       torch.clamp(ndotl, min=1e-4), rough)[..., None]
    specular = f * d * g / torch.clamp(4.0 * ndotv * ndotl,
                                       min=1e-6)[..., None]
    diffuse = (1.0 - f) * (1.0 - metallic) * base / PI
    out = diffuse + specular
    visible = ((ndotl > 0.0) & (ndotv > 0.0))[..., None]
    return torch.where(visible, out, 0.0)
