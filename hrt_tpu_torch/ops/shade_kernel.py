"""K2: the light-major Disney BRDF — CUDA kernel wrapper and its plain
PyTorch version.

Replaces the Pallas kernel of hrt_tpu/ops/shade_pallas.py
(`_brdf_light_major`, body `_make_kernel`).  The kernel is
csrc/brdf_light_major.cu with the Disney terms in csrc/disney.cuh; its
source note says what bounds it on the card (arithmetic per byte) and
what the design does about that.

Contract: over an (L*N,) light-major batch, f = brdf(mat, n, view, l)
where `relevant`, 0 elsewhere.  The 18 per-ray planes (12 material
fields, normal, view) are shared by the L lights (element i reads ray
i % N).  `brdf_light_major` takes the plain version only for CPU
tensors; CUDA tensors always launch the kernel.
"""
from __future__ import annotations

import torch

from ..models.materials import MatP
from . import disney, v3
from .v3 import V3

# Launches of the CUDA kernel; the plain version never counts.
LAUNCHES = {"brdf_light_major": 0}


def _shared_planes(mat: MatP, n: V3, view: V3):
    """The 18 per-ray planes in the order of the JAX kernel's inputs."""
    return (mat.color.x, mat.color.y, mat.color.z, mat.subsurface,
            mat.metallic, mat.roughness, mat.specular, mat.specular_tint,
            mat.anisotropic, mat.sheen_tint, mat.clearcoat,
            mat.clearcoat_gloss, n.x, n.y, n.z, view.x, view.y, view.z)


def brdf_light_major_kernel(mat: MatP, n: V3, view: V3, l_lm: V3,
                            relevant_lm, num_lights: int) -> V3:
    """Launch csrc/brdf_light_major.cu on CUDA tensors."""
    from ..kernels import build

    nr = n.x.shape[0]
    total = num_lights * nr
    dev = n.x.device
    shared = torch.stack(_shared_planes(mat, n, view)).contiguous()
    light = torch.stack([l_lm.x, l_lm.y, l_lm.z]).contiguous()
    rel = relevant_lm.to(torch.bool).contiguous()
    if (shared.dtype != torch.float32 or light.shape != (3, total)
            or rel.shape != (total,) or light.device != dev
            or rel.device != dev):
        raise ValueError("brdf_light_major: planes must be float32 "
                         "(N,) / (L*N,) on one device")
    out = torch.empty((3, total), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = build.load().hrt_brdf_light_major(
            shared.data_ptr(), light.data_ptr(), rel.data_ptr(), nr, total,
            out.data_ptr(), stream)
    build.check(rc, "brdf_light_major")
    LAUNCHES["brdf_light_major"] += 1
    return V3(out[0], out[1], out[2])


def brdf_light_major_plain(mat: MatP, n: V3, view: V3, l_lm: V3,
                           relevant_lm, num_lights: int) -> V3:
    """disney.brdf_p over the light-major batch, zero where irrelevant."""
    rep = lambda a: a.repeat(num_lights)
    mat_l = MatP(*(f.map(rep) if isinstance(f, V3) else rep(f)
                   for f in mat))
    f = disney.brdf_p(mat_l, n.map(rep), view.map(rep), l_lm)
    return v3.where(relevant_lm, f, 0.0)


def brdf_light_major(mat: MatP, n: V3, view: V3, l_lm: V3, relevant_lm,
                     num_lights: int) -> V3:
    """Disney BRDF over (L*N,) light-major planes: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if n.x.is_cuda:
        return brdf_light_major_kernel(mat, n, view, l_lm, relevant_lm,
                                       num_lights)
    if n.x.device.type != "cpu":
        raise ValueError(f"no BRDF kernel for device {n.x.device}")
    return brdf_light_major_plain(mat, n, view, l_lm, relevant_lm,
                                  num_lights)
