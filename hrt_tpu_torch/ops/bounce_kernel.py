"""K7: the path tracer's bounce stage — CUDA kernel wrapper and its plain
PyTorch version.

Replaces no Pallas kernel: the JAX package leaves the bounce
(hrt_tpu/renderer.py `_sample_bounce_p` and the roulette lines of
`trace_paths`) to XLA's fusion.  The kernel is csrc/sample_bounce.cu,
one thread per lane; its source note says what bounds it on the card
(bytes) and what the design does about that.

Contract: for every lane of renderer.trace_paths' wavefront, live or
not, the depth's bounce: lobe sampling (`_sample_bounce_p`: GGX-VNDF
cap, cosine hemisphere, Snell refraction with total internal reflection
and the Fresnel choice, five RNG draws), the new throughput, the origin
offset along the normal (into the surface where the ray was
transmitted), retirement, and with `roulette` Russian roulette with a
sixth draw.  Inputs are the hits' material planes (color, metallic,
roughness, anisotropic, ior, transmission), normal, view and world
position, the throughput, the int64 seed words and the bool planes
entering, hit (the ray hit a surface) and active; the kernel reads each
where it lies, as (pointer, element stride) in one argument block
(`pack_args`).
Outputs are fresh: (origin, direction, throughput, seed, active).  The
kernel equals `sample_bounce_plain` bit for bit on the card.
`sample_bounce` takes the plain version only for CPU tensors; CUDA
tensors always launch the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from ..models.materials import ROUGHNESS_MIN, MatP
from . import rng, sampling, v3
from .disney import schlick_weight
from .v3 import V3

# Launches of the CUDA kernel; the plain version never counts.
LAUNCHES = {"sample_bounce": 0}
_PLANES = 20
_FLAGS = 3


class BounceArgs(ctypes.Structure):
    """The kernel's argument block (csrc/sample_bounce.cu `BounceArgs`):
    the 20 float planes as pointers and element strides, the seed words
    and their stride, the 3 flag planes and their strides, the outputs
    ((9, N) floats, N int64 seeds, N bools), N, the roulette flag, the
    bounce offset and ROUGHNESS_MIN."""

    _fields_ = [("plane", ctypes.c_void_p * _PLANES),
                ("stride", ctypes.c_longlong * _PLANES),
                ("seed", ctypes.c_void_p),
                ("seed_stride", ctypes.c_longlong),
                ("flag", ctypes.c_void_p * _FLAGS),
                ("flag_stride", ctypes.c_longlong * _FLAGS),
                ("out", ctypes.c_void_p),
                ("seed_out", ctypes.c_void_p),
                ("active_out", ctypes.c_void_p),
                ("n", ctypes.c_int),
                ("roulette", ctypes.c_int),
                ("bounce_offset", ctypes.c_float),
                ("roughness_min", ctypes.c_float)]


def _float_planes(mat: MatP, n: V3, view: V3, world_pos: V3,
                  throughput: V3):
    """The 20 float planes in the kernel's order."""
    return (*mat.color, mat.metallic, mat.roughness, mat.anisotropic,
            mat.ior, mat.transmission, *n, *view, *world_pos, *throughput)


def pack_args(mat: MatP, n: V3, view: V3, world_pos: V3, throughput: V3,
              seed, entering, hit, active, bounce_offset: float,
              roulette: bool, out: torch.Tensor, seed_out: torch.Tensor,
              active_out: torch.Tensor) -> BounceArgs:
    """The kernel's argument block over the planes as they lie (on any
    device; the kernel runs on CUDA ones).  Raises ValueError unless the
    20 float planes are (N,) float32, `seed` (N,) int64, the 3 flags
    (N,) bool, all on one device with positive strides, and the outputs
    contiguous: `out` (9, N) float32, `seed_out` (N,) int64,
    `active_out` (N,) bool."""
    nr = n.x.shape[0]
    dev = n.x.device
    ins = (_float_planes(mat, n, view, world_pos, throughput)
           + (seed, entering, hit, active))
    ptrs, strides = [], []
    for k, p in enumerate(ins):
        want = (torch.float32 if k < _PLANES
                else torch.int64 if k == _PLANES else torch.bool)
        st = p.stride()
        if p.dtype is not want or p.numel() != nr or len(st) != 1 \
                or st[0] < 1 or p.device != dev:
            raise ValueError(
                f"sample_bounce: input {k} is {p.dtype} {tuple(p.shape)} on "
                f"{p.device} with stride {st}; needs {want} ({nr},) on "
                f"{dev} with a positive stride")
        ptrs.append(p.data_ptr())
        strides.append(st[0])
    for name, t, shape, dtype in (("out", out, (9, nr), torch.float32),
                                  ("seed_out", seed_out, (nr,), torch.int64),
                                  ("active_out", active_out, (nr,),
                                   torch.bool)):
        if tuple(t.shape) != shape or t.dtype is not dtype \
                or t.device != dev or not t.is_contiguous():
            raise ValueError(f"sample_bounce: {name} must be a contiguous "
                             f"{shape} {dtype} tensor on {dev}")
    args = BounceArgs()
    args.plane[:] = ptrs[:_PLANES]
    args.stride[:] = strides[:_PLANES]
    args.seed, args.seed_stride = ptrs[_PLANES], strides[_PLANES]
    args.flag[:] = ptrs[_PLANES + 1:]
    args.flag_stride[:] = strides[_PLANES + 1:]
    args.out, args.seed_out = out.data_ptr(), seed_out.data_ptr()
    args.active_out = active_out.data_ptr()
    args.n, args.roulette = nr, int(bool(roulette))
    args.bounce_offset, args.roughness_min = bounce_offset, ROUGHNESS_MIN
    return args


def sample_bounce_kernel(mat: MatP, n: V3, view: V3, world_pos: V3,
                         throughput: V3, seed, entering, hit, active,
                         bounce_offset: float, roulette: bool):
    """Launch csrc/sample_bounce.cu on CUDA tensors."""
    from ..kernels import build

    nr, dev = n.x.shape[0], n.x.device
    out = torch.empty((9, nr), dtype=torch.float32, device=dev)
    seed_out = torch.empty((nr,), dtype=torch.int64, device=dev)
    active_out = torch.empty((nr,), dtype=torch.bool, device=dev)
    args = pack_args(mat, n, view, world_pos, throughput, seed, entering,
                     hit, active, bounce_offset, roulette, out, seed_out,
                     active_out)
    with torch.cuda.device(dev):
        rc = build.load().hrt_sample_bounce(args, build.stream(dev))
    build.check(rc, "sample_bounce")
    LAUNCHES["sample_bounce"] += 1
    p = out.unbind(0)
    return V3(*p[0:3]), V3(*p[3:6]), V3(*p[6:9]), seed_out, active_out


def _refract_p(view: V3, n: V3, eta):
    """Snell refraction of the viewing direction about n (both unit, n
    facing the viewer) -> (direction, total internal reflection mask)."""
    cos_i = v3.dot(view, n)
    sin2_t = eta * eta * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    tir = sin2_t > 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    d = view * (-eta) + n * (eta * cos_i - cos_t)
    return v3.normalize(d), tir


def _zero3(like) -> V3:
    z = torch.zeros_like(like)
    return V3(z, z, z)


def _sample_bounce_p(mat: MatP, n: V3, view: V3, seed, entering, frame):
    """One-sample lobe selection, as the JAX package's: transmission
    (Snell + TIR, Fresnel-chosen mirror), specular (GGX-VNDF) or diffuse
    (cosine).  Draws, in order: u0 and u1 (rand2), the lobe, the
    Fresnel choice, the transmission choice.  `entering` (the front face
    was hit) sets eta; `frame` is the normal's orthonormal basis.
    Returns (direction, weight, seed, transmitted mask)."""
    u0, u1, seed = rng.rand2(seed)
    usel, seed = rng.rand(seed)
    metallic = mat.metallic
    rough = torch.clamp(mat.roughness, min=ROUGHNESS_MIN)
    transmission = mat.transmission
    ior = torch.clamp(mat.ior, min=1.0001)
    p_spec = torch.clamp(metallic + 0.25 * (1.0 - rough), 0.0, 0.95)

    d_spec, w_spec = sampling.ggx_vndf_spherical_cap_p(mat, view, n, u0, u1,
                                                       frame)
    local_diff, _ = sampling.cosine_hemisphere_p(u0, u1)
    d_diff = v3.to_world(local_diff, n, frame)

    color = mat.color
    # Metals reflect their color; dielectric specular is achromatic,
    # scaled by a Schlick weight.
    h = v3.normalize(view + d_spec)
    fres = schlick_weight(v3.dot(d_spec, h))
    spec_col = ((color + (1.0 - color) * fres) * metallic
                + (0.04 + 0.96 * fres) * (1.0 - metallic))
    diff_col = color * (1.0 - metallic)

    take_spec = usel < p_spec
    direction = v3.where(take_spec, d_spec, d_diff)
    p = torch.where(take_spec, torch.clamp(p_spec, min=1e-3),
                    torch.clamp(1.0 - p_spec, min=1e-3))
    weight = v3.where(take_spec, spec_col * w_spec, diff_col) * (1.0 / p)
    # Kill specular samples below the horizon.
    weight = v3.where(take_spec & (w_spec <= 0.0), _zero3(usel), weight)

    # Transmission lobe: a Fresnel-weighted choice between refraction
    # and mirror reflection; total internal reflection always reflects.
    eta = torch.where(entering, 1.0 / ior, ior)
    d_refr, tir = _refract_p(view, n, eta)
    cos_i = torch.abs(v3.dot(view, n))
    f0 = ((1.0 - ior) / (1.0 + ior)) ** 2
    fr = f0 + (1.0 - f0) * schlick_weight(cos_i)
    u_t, seed = rng.rand(seed)
    reflect_inst = tir | (u_t < fr)
    d_mirr = v3.normalize(n * (2.0 * v3.dot(view, n)) - view)
    d_trans = v3.where(reflect_inst, d_mirr, d_refr)
    u_tsel, seed = rng.rand(seed)
    take_trans = (transmission > 0.0) & (u_tsel < transmission)
    transmitted = take_trans & ~reflect_inst

    direction = v3.where(take_trans, d_trans, direction)
    weight = v3.where(take_trans, color, weight)
    return direction, weight, seed, transmitted


def sample_bounce_plain(mat: MatP, n: V3, view: V3, world_pos: V3,
                        throughput: V3, seed, entering, hit, active,
                        bounce_offset: float, roulette: bool):
    """The bounce stage in plain torch: `_sample_bounce_p` about the
    normal's basis, the throughput, the offset origin, retirement
    (`active` & `hit` & a throughput above 1e-5) and, with `roulette`,
    Russian roulette; retired lanes keep throughput 0.  `hit`: the lanes
    whose ray hit a surface.  Returns (origin, direction, throughput,
    seed, active)."""
    basis = v3.orthonormal_basis(n)
    new_d, weight, seed, transmitted = _sample_bounce_p(
        mat, n, view, seed, entering, basis)
    throughput = throughput * weight
    side = torch.where(transmitted, -1.0, 1.0)
    o = world_pos + n * (side * bounce_offset)
    alive = v3.max_component(throughput) > 1e-5
    active = active & hit & alive
    if roulette:
        p_cont = torch.clamp(v3.max_component(throughput), 0.05, 0.95)
        u_rr, seed = rng.rand(seed)
        throughput = throughput * (1.0 / p_cont)
        active = active & (u_rr < p_cont)
    # Retired rays keep their lanes with throughput 0.
    throughput = v3.where(active, throughput, 0.0)
    return o, new_d, throughput, seed, active


def sample_bounce(mat: MatP, n: V3, view: V3, world_pos: V3,
                  throughput: V3, seed, entering, hit, active,
                  bounce_offset: float, roulette: bool):
    """The bounce stage: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if n.x.is_cuda:
        return sample_bounce_kernel(mat, n, view, world_pos, throughput,
                                    seed, entering, hit, active,
                                    bounce_offset, roulette)
    if n.x.device.type != "cpu":
        raise ValueError(f"no bounce kernel for device {n.x.device}")
    return sample_bounce_plain(mat, n, view, world_pos, throughput, seed,
                               entering, hit, active, bounce_offset,
                               roulette)
