"""K5: the binary two-level skip-link walk (TLAS -> BLAS) — CUDA kernel
wrapper and its plain PyTorch version.

Replaces the Pallas kernel of hrt_tpu/ops/tlas.py (`_trace_tiles_tlas`,
body `_make_tlas_kernel`), which the JAX package runs for two-level
scenes whose unified BVH8 table would reach MAX_WIDE_NODES (or whose
BLAS overflows its own collapse).  The kernel is csrc/tlas_skip_trace.cu,
one thread per ray; its source note says what bounds it on the card.

Both versions read a TwoLevelFlat's binary table `nodes` (TLAS rows
first, `tlas_m` TLAS nodes, then the globalized BLAS rows), its (T, 12)
triangle table, and per instance its 3x4 obj_from_world rows and BLAS
node range [blas_base, blas_end).  Each ray walks as K3 does; a hit TLAS
leaf with code -(inst + 1) enters the instance: the ray goes into object
space (unnormalized, so t stays world), the walk resumes at the BLAS
base, and past the BLAS end it comes back to the world ray and to the
TLAS leaf's skip link.  Closest mode returns (t, tri, inst, u, v) with
global pool ids (-1 on a miss, t = t_max); any-hit mode returns a bool
occlusion mask, each ray retiring at its first hit.  A ray with
t_max < 0 is dead.

`trace` takes the plain version only for CPU tensors; CUDA tensors
always launch the kernel (and raise if it fails).
"""
from __future__ import annotations

import torch

from .intersect import leaf_hits, safe_inv_dir, slab_hit, to_object_space
from .traversal_skip import node_words

# Launches of the CUDA kernel, by mode; the plain version never counts.
LAUNCHES = {"closest": 0, "any_hit": 0}


def _check_inputs(tl, planes):
    n = planes[0].shape[0]
    dev = tl.nodes.device
    for p in planes:
        if p.dtype != torch.float32 or p.shape != (n,) or p.device != dev:
            raise ValueError("ray planes must be (N,) float32 on the "
                             "two-level table's device")


def trace_kernel(tl, ox, oy, oz, dx, dy, dz, tmax, t_min: float,
                 find_closest: bool):
    """Launch csrc/tlas_skip_trace.cu on CUDA tensors."""
    from ..kernels import build

    planes = [p.contiguous() for p in (ox, oy, oz, dx, dy, dz, tmax)]
    _check_inputs(tl, planes)
    n = planes[0].shape[0]
    dev = planes[0].device
    tf = tl.obj_from_world.reshape(-1, 12).contiguous()
    lib = build.load()
    if find_closest:
        t = torch.empty(n, dtype=torch.float32, device=dev)
        tri = torch.empty(n, dtype=torch.int32, device=dev)
        inst = torch.empty(n, dtype=torch.int32, device=dev)
        u = torch.empty(n, dtype=torch.float32, device=dev)
        v = torch.empty(n, dtype=torch.float32, device=dev)
        outs = [t.data_ptr(), tri.data_ptr(), inst.data_ptr(),
                u.data_ptr(), v.data_ptr(), None]
    else:
        occ = torch.empty(n, dtype=torch.bool, device=dev)
        outs = [None, None, None, None, None, occ.data_ptr()]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.hrt_tlas_skip_trace(
            *[p.data_ptr() for p in planes], n, tl.nodes.data_ptr(),
            tl.tris.data_ptr(), tf.data_ptr(), tl.blas_base.data_ptr(),
            tl.blas_end.data_ptr(), tl.tlas_m, tl.leaf_size, float(t_min),
            int(find_closest), *outs, stream)
    build.check(rc, "tlas_skip_trace")
    LAUNCHES["closest" if find_closest else "any_hit"] += 1
    return (t, tri, inst, u, v) if find_closest else occ


def trace_plain(tl, ox, oy, oz, dx, dy, dz, tmax, t_min: float,
                find_closest: bool):
    """The same walk, vectorised over rays: every live ray advances one
    node per iteration."""
    planes = [p.contiguous() for p in (ox, oy, oz, dx, dy, dz, tmax)]
    _check_inputs(tl, planes)
    ox, oy, oz, dx, dy, dz, tmax = planes
    n = ox.shape[0]
    dev = ox.device
    tf = tl.obj_from_world.reshape(-1, 12)
    base, end = tl.blas_base.long(), tl.blas_end.long()
    ow = torch.stack([ox, oy, oz], dim=1)
    dw = torch.stack([dx, dy, dz], dim=1)
    # The active-space ray: world, or the current instance's object space.
    o, d = ow.clone(), dw.clone()
    inv = safe_inv_dir(d)
    oi = o * inv

    t = tmax.clone()
    tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    hit_inst = torch.full((n,), -1, dtype=torch.int32, device=dev)
    u = torch.zeros(n, device=dev)
    v = torch.zeros(n, device=dev)
    zeros = lambda: torch.zeros(n, dtype=torch.int64, device=dev)
    cur, resume, bend, cinst = zeros(), zeros(), zeros(), zeros()
    in_blas = torch.zeros(n, dtype=torch.bool, device=dev)
    live = torch.nonzero(tmax >= 0).squeeze(1)
    while live.numel():
        w = node_words(tl.nodes, cur[live])
        code, nxt = w[:, 6].long(), w[:, 7].long()
        hit = slab_hit(w[:, :6].view(torch.float32), inv[live], oi[live],
                       t_min, t[live])
        nxt = torch.where(hit & (code == 0), cur[live] + 1, nxt)
        retired = torch.zeros_like(hit)

        leaf = hit & (code > 0)
        if bool(leaf.any()):
            rays = live[leaf]
            better, th, ids, uh, vh = leaf_hits(
                tl.tris, code[leaf] - 1, tl.leaf_size, o[rays], d[rays],
                t_min, t[rays])
            rb = rays[better]
            tri[rb] = ids[better]
            hit_inst[rb] = cinst[rb].to(torch.int32)
            if find_closest:
                t[rb], u[rb], v[rb] = th[better], uh[better], vh[better]
            else:
                # Any hit: the first hit retires the ray.
                retired[torch.nonzero(leaf).squeeze(1)[better]] = True

        enter = hit & (code < 0)
        if bool(enter.any()):
            r = live[enter]
            iid = -code[enter] - 1
            resume[r] = nxt[enter]
            nxt[enter] = base[iid]
            bend[r] = end[iid]
            cinst[r] = iid
            in_blas[r] = True
            o[r], d[r] = to_object_space(tf[iid], ow[r], dw[r])
            inv[r] = safe_inv_dir(d[r])
            oi[r] = o[r] * inv[r]

        # BLAS done: back to the world ray and the TLAS resume point.
        pop = in_blas[live] & (nxt >= bend[live])
        if bool(pop.any()):
            r = live[pop]
            o[r], d[r] = ow[r], dw[r]
            inv[r] = safe_inv_dir(dw[r])
            oi[r] = o[r] * inv[r]
            nxt[pop] = resume[r]
            in_blas[r] = False

        cur[live] = nxt
        live = live[(in_blas[live] | (nxt < tl.tlas_m)) & ~retired]
    if find_closest:
        return t, tri, hit_inst, u, v
    return tri >= 0


def trace(tl, ox, oy, oz, dx, dy, dz, tmax, t_min: float,
          find_closest: bool):
    """The binary two-level walk: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if ox.is_cuda:
        return trace_kernel(tl, ox, oy, oz, dx, dy, dz, tmax, t_min,
                            find_closest)
    if ox.device.type != "cpu":
        raise ValueError(f"no binary two-level walk for device {ox.device}")
    return trace_plain(tl, ox, oy, oz, dx, dy, dz, tmax, t_min,
                       find_closest)
