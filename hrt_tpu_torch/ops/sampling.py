"""Importance samplers for bounce directions (hrt_tpu/ops/sampling.py):
the cosine-weighted hemisphere and the Dupuy-Benyoub
spherical-cap GGX-VNDF sampler with anisotropic roughness and its G2/G1
weight (ref: shaders/sampler.slang:23-93).  Plain torch: the planar
cores (`_p`, on V3 planes), which the bounce loop of
renderer.trace_paths runs on the card as they are, and the JAX
package's (..., 3)-array signatures, which wrap them.
"""
from __future__ import annotations

import torch

from ..models.materials import ROUGHNESS_MIN, MatP
from . import v3
from .v3 import V3

TWO_PI = 6.2831853071795
ONE_OVER_PI = 0.3183098861837


def cosine_hemisphere_p(u0, u1):
    """Cosine-weighted direction in the local frame (+z the normal) and
    its pdf cos(theta) / pi."""
    phi = TWO_PI * u1
    cos_theta = torch.sqrt(u0)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta,
                                       min=0.0))
    d = V3(sin_theta * torch.cos(phi), sin_theta * torch.sin(phi),
           cos_theta)
    return d, cos_theta * ONE_OVER_PI


def _aniso_p(mat: MatP):
    """(ax, ay) of the material (ref: sampler.slang:35-42)."""
    aspect = torch.sqrt(1.0 - mat.anisotropic * 0.9)
    r = torch.clamp(mat.roughness, min=ROUGHNESS_MIN)
    r2 = r * r
    ax = torch.clamp(r2 / aspect, min=1e-3)
    ay = torch.clamp(r2 * aspect, min=1e-3)
    return ax, ay


def _vndf_ratio_p(mat: MatP, wo: V3, wi: V3):
    """G2/G1, the VNDF sample's weight (ref: sampler.slang:23-33)."""
    r = torch.clamp(mat.roughness, min=ROUGHNESS_MIN)
    r2 = r * r
    a2 = r2 * r2
    ndotl = wi.z
    ndotv = wo.z
    f1 = torch.sqrt(a2 + (1.0 - a2) * ndotl * ndotl)
    f2 = torch.sqrt(a2 + (1.0 - a2) * ndotv * ndotv)
    g1 = 2.0 * ndotv / torch.clamp(f2 + ndotv, min=1e-8)
    g2 = 2.0 * ndotl * ndotv / torch.clamp(f1 * ndotv + f2 * ndotl,
                                           min=1e-8)
    return g2 / torch.clamp(g1, min=1e-8)


def ggx_vndf_spherical_cap_p(mat: MatP, v_world: V3, n_world: V3, u0, u1,
                             frame=None):
    """A GGX-VNDF reflection direction in world space and its weight
    G2/G1, zero where the direction falls below the surface (ref:
    sampler.slang:67-93, sampled about +wo and reflected, as the JAX
    package does).  `frame` reuses v3.orthonormal_basis(n_world)."""
    if frame is None:
        frame = v3.orthonormal_basis(n_world)
    wo = v3.to_local(v_world, n_world, frame)
    ax, ay = _aniso_p(mat)

    v = v3.normalize(V3(ax * wo.x, ay * wo.y, wo.z))
    lensq = v.x * v.x + v.y * v.y
    ok = lensq > 1e-12
    rsqrt = torch.where(ok, 1.0 / torch.sqrt(torch.clamp(lensq, min=1e-12)),
                        0.0)
    zero = torch.zeros_like(rsqrt)
    t1 = V3(torch.where(ok, -v.y * rsqrt, 1.0),
            torch.where(ok, v.x * rsqrt, 0.0), zero)
    t2 = v3.cross(v, t1)

    r = torch.sqrt(u0)
    phi = TWO_PI * u1
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + v.z)
    p2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=0.0)) \
        + s * p2

    nh = (t1 * p1 + t2 * p2
          + v * torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0)))
    wm = v3.normalize(V3(ax * nh.x, ay * nh.y, torch.clamp(nh.z, min=0.0)))

    # Reflect wo about wm: wi = 2 (wo . wm) wm - wo.
    wi = wm * (2.0 * v3.dot(wo, wm)) - wo
    weight = torch.where(wi.z > 0.0, _vndf_ratio_p(mat, wo, wi), 0.0)
    return v3.to_world(wi, n_world, frame), weight


# ---------------------------------------------------------------------------
# Array forms: (..., 3) vectors and (..., MAT_W) material rows, the JAX
# package's signatures over the planar cores above.
# ---------------------------------------------------------------------------

def _mat_rows(mat) -> MatP:
    return MatP.from_rows_t(torch.movedim(mat, -1, 0))


def cosine_hemisphere(u0, u1):
    """cosine_hemisphere_p with the direction as (..., 3)."""
    d, pdf = cosine_hemisphere_p(u0, u1)
    return d.to_array(), pdf


def anisotropic_from_material(mat):
    """(ax, ay) of material rows (..., MAT_W)."""
    return _aniso_p(_mat_rows(mat))


def ggx_vndf_pdf_ratio(mat, wo, wi):
    """G2/G1 of material rows and local-frame wo / wi (..., 3)."""
    return _vndf_ratio_p(_mat_rows(mat), V3.from_array(wo), V3.from_array(wi))


def ggx_vndf_spherical_cap(mat, v_world, n_world, u0, u1):
    """ggx_vndf_spherical_cap_p on material rows and (..., 3) vectors:
    the world direction (..., 3) and its weight."""
    wi, weight = ggx_vndf_spherical_cap_p(
        _mat_rows(mat), V3.from_array(v_world), V3.from_array(n_world), u0, u1)
    return wi.to_array(), weight
