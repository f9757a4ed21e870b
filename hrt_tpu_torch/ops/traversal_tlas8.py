"""K4: the two-level wide walk (TLAS -> BLAS) — CUDA kernel wrapper and
its plain PyTorch version.

Replaces the Pallas kernel of hrt_tpu/ops/traversal_tlas8.py
(`_trace_tiles_tlas8`, body `_make_kernel`).  The kernel is
csrc/tlas8_trace.cu, one thread per ray; its source note says what
bounds it on the card.

Both versions read the unified (R, 8, 128) int32 record table of a
TwoLevelFlat (ops/tlas.py), its (T, 12) triangle table, the instances'
3x4 obj_from_world rows and BLAS root ids, and follow the same walk.
A per-ray stack holds node entries (base << 8 | rank-mask, as K1) and
instance entries -(inst + 1).  Visiting a node below `w8_tlas_nw` (a
TLAS node) pushes its hit internal children as one entry and then, in
slot order, one instance entry per hit leaf child (leaf meta = instance
id + 1).  Popping an instance entry enters it: the world ray goes into
object space (unnormalized direction, so t stays world), the stack
depth is remembered and the BLAS root is pushed.  Popping a node entry
below that depth leaves it: the world ray comes back.  BLAS leaves run
Möller-Trumbore over their K triangles in object space.  Closest mode
returns (t, tri, inst, u, v) with global pool ids (-1 on a miss, t =
t_max); any-hit mode returns a bool occlusion mask.  A ray with
t_max < 0 is dead.

`trace` takes the plain version only for CPU tensors; CUDA tensors
always launch the kernel (and raise if it fails).
"""
from __future__ import annotations

import torch

from .intersect import (leaf_hits, safe_inv_dir, slab_hit,
                        to_object_space)

# Launches of the CUDA kernel, by mode; the plain version never counts.
LAUNCHES = {"closest": 0, "any_hit": 0}
# Stack entries the kernel can hold per ray; tlas.check_depths refuses
# tables that need more (tlas.stack_bound).
MAX_STACK = 128


def _check_inputs(tl, planes):
    n = planes[0].shape[0]
    dev = tl.w8_nodes.device
    for p in planes:
        if p.dtype != torch.float32 or p.shape != (n,) or p.device != dev:
            raise ValueError("ray planes must be (N,) float32 on the "
                             "two-level table's device")


def trace_kernel(tl, ox, oy, oz, dx, dy, dz, tmax, t_min: float,
                 find_closest: bool):
    """Launch csrc/tlas8_trace.cu on CUDA tensors."""
    from ..kernels import build

    planes = [p.contiguous() for p in (ox, oy, oz, dx, dy, dz, tmax)]
    _check_inputs(tl, planes)
    n = planes[0].shape[0]
    dev = planes[0].device
    tf = tl.obj_from_world.reshape(-1, 12).contiguous()
    roots = tl.w8_root.reshape(-1).contiguous()
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
        rc = lib.hrt_tlas8_trace(
            *[p.data_ptr() for p in planes], n, tl.w8_nodes.data_ptr(),
            tl.tris.data_ptr(), tf.data_ptr(), roots.data_ptr(),
            tl.w8_tlas_nw, tl.leaf_size, float(t_min), tl.stack,
            int(find_closest), *outs, stream)
    build.check(rc, "tlas8_trace")
    LAUNCHES["closest" if find_closest else "any_hit"] += 1
    return (t, tri, inst, u, v) if find_closest else occ


def _rank(low):
    return ((low & 0xAA) != 0).long() + 2 * ((low & 0xCC) != 0).long() \
        + 4 * ((low & 0xF0) != 0).long()


def trace_plain(tl, ox, oy, oz, dx, dy, dz, tmax, t_min: float,
                find_closest: bool):
    """The same walk as a vectorised PyTorch stack machine: every live
    ray takes one stack entry per iteration."""
    planes = [p.contiguous() for p in (ox, oy, oz, dx, dy, dz, tmax)]
    _check_inputs(tl, planes)
    ox, oy, oz, dx, dy, dz, tmax = planes
    n = ox.shape[0]
    dev = ox.device
    rec = tl.w8_nodes.reshape(-1)
    tris = tl.tris
    k = tl.leaf_size
    tf = tl.obj_from_world.reshape(-1, 12)
    roots = tl.w8_root.reshape(-1).long()
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
    cur_inst = torch.full((n,), -1, dtype=torch.int64, device=dev)
    inst_base = torch.zeros(n, dtype=torch.int64, device=dev)
    stack = torch.zeros((n, tl.stack), dtype=torch.int64, device=dev)
    stack[:, 0] = 1
    sp = (tmax >= 0).to(torch.int64)
    words = torch.arange(8, device=dev)

    live = torch.nonzero(sp > 0).squeeze(1)
    while live.numel():
        s = sp[live] - 1
        e = stack[live, s]
        sp[live] = s

        # Leave: a node entry below the instance's entry depth.
        lv = (e >= 0) & (cur_inst[live] >= 0) & (s < inst_base[live])
        r = live[lv]
        o[r], d[r] = ow[r], dw[r]
        inv[r] = safe_inv_dir(dw[r])
        oi[r] = o[r] * inv[r]
        cur_inst[r] = -1

        # Enter: an instance entry -(inst + 1).
        en = e < 0
        r, se = live[en], s[en]
        iid = -e[en] - 1
        o[r], d[r] = to_object_space(tf[iid], ow[r], dw[r])
        inv[r] = safe_inv_dir(d[r])
        oi[r] = o[r] * inv[r]
        cur_inst[r] = iid
        inst_base[r] = se
        stack[r, se] = (roots[iid] << 8) | 1
        sp[r] = se + 1

        # Visit a node entry.
        vi = ~en
        rv, ev, sv = live[vi], e[vi], s[vi]
        mask = ev & 255
        b = ev >> 8
        low = mask & -mask
        rem = mask ^ low
        keep = rem != 0
        stack[rv[keep], sv[keep]] = (b[keep] << 8) | rem[keep]
        sp[rv] = sv + keep.long()
        cur = b + _rank(low)
        in_tlas = cur < tl.w8_tlas_nw
        node = (cur >> 4) * 1024 + (cur & 15) * 8
        first_child = rec[node + 7].long()
        int_mask = torch.zeros_like(cur)
        alive = torch.ones_like(cur, dtype=torch.bool)
        inst_hit = torch.zeros((rv.shape[0], 8), dtype=torch.bool,
                               device=dev)
        inst_meta = torch.zeros((rv.shape[0], 8), dtype=torch.int64,
                                device=dev)
        for j in range(8):
            w = rec[node[:, None] + j * 128 + words]          # (m, 8)
            meta = w[:, 6].long()
            hit = slab_hit(w[:, :6].view(torch.float32), inv[rv], oi[rv],
                           t_min, t[rv]) & (meta != 0) & alive
            int_mask |= torch.where(hit & (meta < 0),
                                    1 << torch.clamp(-meta - 1, 0, 7), 0)
            leaf = hit & (meta > 0)
            inst_hit[:, j] = leaf & in_tlas
            inst_meta[:, j] = meta
            leaf = leaf & ~in_tlas
            if not bool(leaf.any()):
                continue
            rays = rv[leaf]
            better, th, ids, uh, vh = leaf_hits(
                tris, meta[leaf] - 1, k, o[rays], d[rays], t_min, t[rays])
            rb = rays[better]
            tri[rb] = ids[better]
            if find_closest:
                t[rb], u[rb], v[rb] = th[better], uh[better], vh[better]
                hit_inst[rb] = cur_inst[rb].to(torch.int32)
            else:
                dead = torch.zeros_like(alive)
                dead[torch.nonzero(leaf).squeeze(1)[better]] = True
                alive &= ~dead
        # The internal-children entry first, then the instance entries
        # on top, in slot order: instances are walked before descending.
        push = (int_mask != 0) & alive
        stack[rv[push], sp[rv[push]]] = (first_child[push] << 8) \
            | int_mask[push]
        sp[rv] += push.long()
        for j in range(8):
            p = inst_hit[:, j]
            stack[rv[p], sp[rv[p]]] = -inst_meta[p, j]
            sp[rv] += p.long()
        sp[rv[~alive]] = 0
        live = torch.nonzero(sp > 0).squeeze(1)
    if find_closest:
        return t, tri, hit_inst, u, v
    return tri >= 0


def trace(tl, ox, oy, oz, dx, dy, dz, tmax, t_min: float,
          find_closest: bool):
    """The two-level wide walk: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if ox.is_cuda:
        return trace_kernel(tl, ox, oy, oz, dx, dy, dz, tmax, t_min,
                            find_closest)
    if ox.device.type != "cpu":
        raise ValueError(f"no two-level walk for device {ox.device}")
    return trace_plain(tl, ox, oy, oz, dx, dy, dz, tmax, t_min,
                       find_closest)
