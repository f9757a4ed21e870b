"""K2: the light-major Disney BRDF — CUDA kernel wrapper and its plain
PyTorch version.

Replaces the Pallas kernel of hrt_tpu/ops/shade_pallas.py
(`_brdf_light_major`, body `_make_kernel`).  The kernel is
csrc/brdf_light_major.cu with the Disney terms in csrc/disney.cuh, one
thread per ray and its L lights in a loop; its source note says what
bounds it on the card and what the design does about that.

Contract: over an (L*N,) light-major batch, f = brdf(mat, n, view, l)
where `relevant`, 0 elsewhere.  The 18 per-ray planes (12 material
fields, normal, view) are shared by the L lights (element i reads ray
i % N).  The kernel reads every plane where it lies, as (pointer,
element stride) in one argument block (`pack_args`): the frame's
material planes are strided rows of its attribute gather, and nothing is
copied.  `brdf_light_major` takes the plain version only for CPU
tensors; CUDA tensors always launch the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from ..models.materials import MatP
from . import disney, v3
from .v3 import V3

# Launches of the CUDA kernel; the plain version never counts.
LAUNCHES = {"brdf_light_major": 0}
_PLANES = 21


class BrdfArgs(ctypes.Structure):
    """The kernel's argument block (csrc/brdf_light_major.cu `BrdfArgs`):
    the 18 per-ray planes and the 3 light planes as pointers and element
    strides, the relevance bytes and their stride, the (3, L*N) output,
    N and L."""

    _fields_ = [("plane", ctypes.c_void_p * _PLANES),
                ("stride", ctypes.c_longlong * _PLANES),
                ("relevant", ctypes.c_void_p),
                ("relevant_stride", ctypes.c_longlong),
                ("out", ctypes.c_void_p),
                ("n", ctypes.c_int),
                ("num_lights", ctypes.c_int)]


def _shared_planes(mat: MatP, n: V3, view: V3):
    """The 18 per-ray planes in the order of the JAX kernel's inputs."""
    return (mat.color.x, mat.color.y, mat.color.z, mat.subsurface,
            mat.metallic, mat.roughness, mat.specular, mat.specular_tint,
            mat.anisotropic, mat.sheen_tint, mat.clearcoat,
            mat.clearcoat_gloss, n.x, n.y, n.z, view.x, view.y, view.z)


def pack_args(mat: MatP, n: V3, view: V3, l_lm: V3, relevant_lm,
              num_lights: int, out: torch.Tensor) -> BrdfArgs:
    """The kernel's argument block over the planes as they lie (on any
    device; the kernel runs on CUDA ones).  Raises ValueError unless the
    18 per-ray planes are (N,) float32, the 3 light planes (L*N,)
    float32, `relevant_lm` (L*N,) bool and `out` a contiguous (3, L*N)
    float32 tensor, all on one device, every stride positive."""
    nr = n.x.shape[0]
    total = num_lights * nr
    dev = n.x.device
    args = BrdfArgs()
    ptrs, strides = [], []
    for k, p in enumerate(_shared_planes(mat, n, view)
                          + (l_lm.x, l_lm.y, l_lm.z, relevant_lm)):
        st = p.stride()
        if p.dtype is not (torch.float32 if k < _PLANES else torch.bool) \
                or p.numel() != (nr if k < 18 else total) or len(st) != 1 \
                or st[0] < 1 or p.device != dev:
            raise ValueError(
                f"brdf_light_major: plane {k} is {p.dtype} {tuple(p.shape)} "
                f"on {p.device} with stride {st}; needs "
                f"{'float32' if k < _PLANES else 'bool'} "
                f"({nr if k < 18 else total},) on {dev} with a positive "
                "stride")
        ptrs.append(p.data_ptr())
        strides.append(st[0])
    if out.shape != (3, total) or out.dtype is not torch.float32 \
            or out.device != dev or not out.is_contiguous():
        raise ValueError("brdf_light_major: out must be a contiguous "
                         f"(3, {total}) float32 tensor on {dev}")
    args.plane[:] = ptrs[:_PLANES]
    args.stride[:] = strides[:_PLANES]
    args.relevant, args.relevant_stride = ptrs[_PLANES], strides[_PLANES]
    args.out, args.n, args.num_lights = out.data_ptr(), nr, num_lights
    return args


def brdf_light_major_kernel(mat: MatP, n: V3, view: V3, l_lm: V3,
                            relevant_lm, num_lights: int) -> V3:
    """Launch csrc/brdf_light_major.cu on CUDA tensors."""
    from ..kernels import build

    dev = n.x.device
    out = torch.empty((3, num_lights * n.x.shape[0]), dtype=torch.float32,
                      device=dev)
    args = pack_args(mat, n, view, l_lm, relevant_lm, num_lights, out)
    with torch.cuda.device(dev):
        rc = build.load().hrt_brdf_light_major(args, build.stream(dev))
    build.check(rc, "brdf_light_major")
    LAUNCHES["brdf_light_major"] += 1
    return V3(*out.unbind(0))


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
