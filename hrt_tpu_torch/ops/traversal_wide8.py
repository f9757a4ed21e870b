"""K1: the BVH8 walk — CUDA kernel wrapper and its plain PyTorch version.

Replaces the Pallas kernel of hrt_tpu/ops/traversal_wide8.py
(`_trace_tiles_wide8`, body `_make_kernel`, exact node-test mode).  The
kernel is csrc/bvh8_trace.cu, one thread per ray; its source note says
what bounds it on the card (dependent global loads, divergence) and
what the design does about that.

Both versions read the same (R, 8, 128) int32 record table and the same
(T, 12) float32 triangle table (Accel.w8 / Accel.tris), and follow the
same walk: pop (base, mask), visit the lowest-rank child, test its 8
children against the ray's live t (exact per-ray slab tests), run
Möller-Trumbore over each hit leaf's K triangles in slot order and push
the hit internal children as one (base << 8 | mask) entry.  Closest mode
returns (t, tri, u, v) with leaf-pool ids (-1 on a miss, t = t_max);
any-hit mode returns a bool occlusion mask.  A ray with t_max < 0 is
dead.

`trace` takes the plain version only for CPU tensors; CUDA tensors
always launch the kernel (and raise if it fails).
"""
from __future__ import annotations

import torch

from .intersect import leaf_hits, safe_inv_dir, slab_hit

# Launches of the CUDA kernel, by mode; the plain version never counts.
LAUNCHES = {"closest": 0, "any_hit": 0}
# Stack entries the kernel can hold per ray (one per wide-tree level);
# lbvh.make_accel refuses deeper trees.
MAX_STACK = 32


def _check_inputs(accel, planes):
    n = planes[0].shape[0]
    dev = accel.w8.device
    for p in planes:
        if p.dtype != torch.float32 or p.shape != (n,) or p.device != dev:
            raise ValueError("ray planes must be (N,) float32 on the "
                             "accel's device")


def trace_kernel(accel, ox, oy, oz, dx, dy, dz, tmax, t_min: float,
                 find_closest: bool):
    """Launch csrc/bvh8_trace.cu on CUDA tensors."""
    from ..kernels import build

    planes = [p.contiguous() for p in (ox, oy, oz, dx, dy, dz, tmax)]
    _check_inputs(accel, planes)
    n = planes[0].shape[0]
    dev = planes[0].device
    lib = build.load()
    if find_closest:
        t = torch.empty(n, dtype=torch.float32, device=dev)
        tri = torch.empty(n, dtype=torch.int32, device=dev)
        u = torch.empty(n, dtype=torch.float32, device=dev)
        v = torch.empty(n, dtype=torch.float32, device=dev)
        outs = [t.data_ptr(), tri.data_ptr(), u.data_ptr(), v.data_ptr(),
                None]
    else:
        occ = torch.empty(n, dtype=torch.bool, device=dev)
        outs = [None, None, None, None, occ.data_ptr()]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.hrt_bvh8_trace(
            *[p.data_ptr() for p in planes], n, accel.w8.data_ptr(),
            accel.tris.data_ptr(), accel.leaf_size, float(t_min),
            accel.w8_depth + 1, int(find_closest), *outs, stream)
    build.check(rc, "bvh8_trace")
    LAUNCHES["closest" if find_closest else "any_hit"] += 1
    return (t, tri, u, v) if find_closest else occ


def trace_plain(accel, ox, oy, oz, dx, dy, dz, tmax, t_min: float,
                find_closest: bool):
    """The same walk as a vectorised PyTorch stack machine: every live
    ray advances one node visit per iteration."""
    planes = [p.contiguous() for p in (ox, oy, oz, dx, dy, dz, tmax)]
    _check_inputs(accel, planes)
    ox, oy, oz, dx, dy, dz, tmax = planes
    n = ox.shape[0]
    dev = ox.device
    rec = accel.w8.reshape(-1)
    tris = accel.tris
    k = accel.leaf_size
    o = torch.stack([ox, oy, oz], dim=1)
    d = torch.stack([dx, dy, dz], dim=1)
    inv = safe_inv_dir(d)
    oi = o * inv

    t = tmax.clone()
    tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    u = torch.zeros(n, device=dev)
    v = torch.zeros(n, device=dev)
    stack = torch.zeros((n, accel.w8_depth + 1), dtype=torch.int64,
                        device=dev)
    stack[:, 0] = 1
    sp = (tmax >= 0).to(torch.int64)
    words = torch.arange(8, device=dev)

    live = torch.nonzero(sp > 0).squeeze(1)
    while live.numel():
        s = sp[live] - 1
        e = stack[live, s]
        mask = e & 255
        b = e >> 8
        low = mask & -mask
        rem = mask ^ low
        r = ((low & 0xAA) != 0).long() + 2 * ((low & 0xCC) != 0).long() \
            + 4 * ((low & 0xF0) != 0).long()
        keep = rem != 0
        stack[live[keep], s[keep]] = (b[keep] << 8) | rem[keep]
        sp[live] = s + keep.long()
        cur = b + r
        node = (cur >> 4) * 1024 + (cur & 15) * 8
        first_child = rec[node + 7].long()
        int_mask = torch.zeros_like(cur)
        alive = torch.ones_like(cur, dtype=torch.bool)
        for j in range(8):
            w = rec[node[:, None] + j * 128 + words]          # (m, 8)
            meta = w[:, 6].long()
            hit = slab_hit(w[:, :6].view(torch.float32), inv[live],
                           oi[live], t_min, t[live]) & (meta != 0) & alive
            int_mask |= torch.where(hit & (meta < 0),
                                    1 << torch.clamp(-meta - 1, 0, 7), 0)
            leaf = hit & (meta > 0)
            if not bool(leaf.any()):
                continue
            rays = live[leaf]
            better, th, ids, uh, vh = leaf_hits(
                tris, meta[leaf] - 1, k, o[rays], d[rays], t_min, t[rays])
            rb = rays[better]
            tri[rb] = ids[better]
            if find_closest:
                t[rb], u[rb], v[rb] = th[better], uh[better], vh[better]
            else:
                dead = torch.zeros_like(alive)
                dead[torch.nonzero(leaf).squeeze(1)[better]] = True
                alive &= ~dead
        push = (int_mask != 0) & alive
        stack[live[push], sp[live[push]]] = (first_child[push] << 8) \
            | int_mask[push]
        sp[live] += push.long()
        sp[live[~alive]] = 0
        live = torch.nonzero(sp > 0).squeeze(1)
    if find_closest:
        return t, tri, u, v
    return tri >= 0


def trace(accel, ox, oy, oz, dx, dy, dz, tmax, t_min: float,
          find_closest: bool):
    """The BVH8 walk: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if ox.is_cuda:
        return trace_kernel(accel, ox, oy, oz, dx, dy, dz, tmax, t_min,
                            find_closest)
    if ox.device.type != "cpu":
        raise ValueError(f"no BVH8 walk for device {ox.device}")
    return trace_plain(accel, ox, oy, oz, dx, dy, dz, tmax, t_min,
                       find_closest)
