"""Disney BRDF on planar tensors (hrt_tpu/ops/disney.py, with its
reference quirks kept: log2 in GTR1, no sheen scale, schlick_weight(L.H)
in the specular Fresnel).  This is the plain version of the K2 kernel;
csrc/disney.cuh holds the same terms as device functions."""
from __future__ import annotations

import torch

from ..models.materials import MatP
from . import v3
from .v3 import V3

PI = 3.1415926535897
ONE_OVER_PI = 0.3183098861837


def schlick_fresnel(f0, vdoth):
    m = 1.0 - vdoth
    return f0 + (1.0 - f0) * (m * m * m * m * m)


def schlick_weight(f):
    m = torch.clamp(1.0 - f, 0.0, 1.0)
    return m * m * m * m * m


def gtr1(ndoth, a):
    a2 = a * a
    val = (a2 - 1.0) / (
        PI * torch.log2(torch.clamp(a2, min=1e-8))
        * (1.0 + (a2 - 1.0) * ndoth * ndoth))
    return torch.where(a >= 1.0, ONE_OVER_PI, val)


def gtr2(ndoth, a):
    """Normalized isotropic GTR2 / GGX (the JAX package's correct form;
    the reference's unused GTR2 lacks the square on the denominator)."""
    a2 = a * a
    d = 1.0 + (a2 - 1.0) * ndoth * ndoth
    return a2 / (PI * d * d)


def gtr2_anisotropic(ndoth, hdotx, hdoty, ax, ay):
    s = (hdotx / ax) ** 2 + (hdoty / ay) ** 2 + ndoth * ndoth
    return 1.0 / (PI * ax * ay * s * s)


def smith_ggx(ndotv, a):
    a2 = a * a
    return 2.0 / (1.0 + torch.sqrt(a2 + (1.0 - a2) * ndotv * ndotv))


def smith_ggx_anisotropic(ndotv, vdotx, vdoty, ax, ay):
    return 1.0 / (
        ndotv
        + torch.sqrt((vdotx * ax) ** 2 + (vdoty * ay) ** 2 * ndotv * ndotv))


def calculate_tint(color: V3) -> V3:
    lum = 0.3 * color.x + 0.6 * color.y + 1.0 * color.z
    ok = lum > 0.0
    inv = 1.0 / torch.clamp(lum, min=1e-12)
    return v3.where(ok, color * inv, 1.0)


def anisotropic_params(anisotropic, roughness):
    aspect = torch.sqrt(1.0 - anisotropic * 0.9)
    r2 = roughness * roughness
    ax = torch.clamp(r2 / aspect, min=1e-3)
    ay = torch.clamp(r2 * aspect, min=1e-3)
    return ax, ay


def eval_sheen(mat: MatP, hdotl) -> V3:
    tint = calculate_tint(mat.color)
    return ((tint - 1.0) * mat.sheen_tint + 1.0) * schlick_weight(hdotl)


def eval_clearcoat(mat: MatP, ndoth, ndotl, ndotv, ldoth):
    d = gtr1(ndoth, 0.1 + (0.001 - 0.1) * mat.clearcoat_gloss)
    f = schlick_fresnel(0.04, ldoth)
    g = smith_ggx(ndotl, 0.25) * smith_ggx(ndotv, 0.25)
    return 0.25 * mat.clearcoat * d * f * g


def eval_diffuse(mat: MatP, local_l: V3, local_v: V3, local_h: V3):
    rough = mat.roughness
    fl = schlick_weight(local_l.z)
    fv = schlick_weight(local_v.z)
    hdotl = v3.dot(local_h, local_l)
    fd90 = 0.5 + 2.0 * rough * hdotl * hdotl
    fd = (1.0 + (fd90 - 1.0) * fl) * (1.0 + (fd90 - 1.0) * fv)
    fss90 = hdotl * hdotl * rough
    fss = (1.0 + (fss90 - 1.0) * fl) * (1.0 + (fss90 - 1.0) * fv)
    lz_vz = local_l.z + local_v.z
    ss = 1.25 * (fss * (1.0 / torch.clamp(lz_vz, min=1e-6) - 0.5) + 0.5)
    return fd + (ss - fd) * mat.subsurface


def eval_specular(mat: MatP, local_h: V3, local_v: V3, local_l: V3) -> V3:
    ax, ay = anisotropic_params(mat.anisotropic, mat.roughness)
    tint = calculate_tint(mat.color)
    base = ((tint - 1.0) * mat.specular_tint + 1.0) * (mat.specular * 0.08)
    color = base + (mat.color - base) * mat.metallic
    d = gtr2_anisotropic(local_h.z, local_h.x, local_h.y, ax, ay)
    fresnel = schlick_weight(v3.dot(local_l, local_h))
    f = color + (1.0 - color) * fresnel
    g = (smith_ggx_anisotropic(local_l.z, local_l.x, local_l.y, ax, ay)
         * smith_ggx_anisotropic(local_v.z, local_v.x, local_v.y, ax, ay))
    return f * (d * g)


def brdf_p(mat: MatP, n: V3, v: V3, l: V3, frame=None) -> V3:
    """Full Disney BRDF; v points toward the viewer.  Zero where n.l or
    n.v <= 0 (the reference's early-out)."""
    ndotl = v3.dot(n, l)
    ndotv = v3.dot(n, v)
    h = v3.normalize(v + l)
    ndoth = v3.dot(n, h)
    hdotl = v3.dot(h, l)
    if frame is None:
        frame = v3.orthonormal_basis(n)
    local_h = v3.to_local(h, n, frame)
    local_v = v3.to_local(v, n, frame)
    local_l = v3.to_local(l, n, frame)

    sheen = eval_sheen(mat, hdotl)
    clearcoat = eval_clearcoat(mat, ndoth, ndotl, ndotv, hdotl)
    specular = eval_specular(mat, local_h, local_v, local_l)
    diffuse = eval_diffuse(mat, local_l, local_v, local_h)

    out = ((mat.color * (ONE_OVER_PI * diffuse) + sheen)
           * (1.0 - mat.metallic) + specular + clearcoat)
    visible = (ndotl > 0.0) & (ndotv > 0.0)
    return v3.where(visible, out, 0.0)


def brdf(mat, n, v, l, frame=None):
    """brdf_p on arrays: `mat` (..., MAT_W) gathered material rows,
    n / v / l (..., 3), `frame` an optional (tangent, bitangent) pair of
    (..., 3) arrays.  Returns (..., 3)."""
    fr = None if frame is None else tuple(map(V3.from_array, frame))
    out = brdf_p(MatP.from_rows_t(torch.movedim(mat, -1, 0)), V3.from_array(n),
                 V3.from_array(v), V3.from_array(l), frame=fr)
    return out.to_array()
