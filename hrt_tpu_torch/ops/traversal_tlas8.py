"""K4: the two-level wide walk (TLAS -> BLAS) — CUDA kernel wrapper and
its plain PyTorch version.

Replaces the Pallas kernel of hrt_tpu/ops/traversal_tlas8.py
(`_trace_tiles_tlas8`, body `_make_kernel`).  The kernel is
csrc/tlas8_trace.cu: closest hits as a warp packet walked nearest child
first, any hits a thread per ray with the leaves of a warp tested
together; its source note says what bounds it on the card.

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

The kernel reads the table as 256-byte node records
(`wide8.node_records`, cached as `TwoLevelFlat.w8_rec`) and tests
triangles without a division until one passes
(traversal_skip.moller_scaled mirrors that test for the tests).
`visit_counts` counts a batch's visits per ray in the plain walk's
order and nearest first (the closest kernel's order); nothing on the
frame path calls it.

`trace` takes the plain version only for CPU tensors; CUDA tensors
always launch the kernel (and raise if it fails).
"""
from __future__ import annotations

import torch

from .intersect import (ActiveRays, RayStacks, leaf_hits, leaf_test_counts,
                        slab_hit, slab_near)

# Launches of the CUDA kernel, by mode; the plain version never counts.
LAUNCHES = {"closest": 0, "any_hit": 0}
# Stack entries the kernels can hold (per ray, or per warp in closest
# mode); tlas.check_depths refuses tables that need more
# (tlas.stack_bound).
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
        stream = build.stream(dev)
        rc = lib.hrt_tlas8_trace(
            *[p.data_ptr() for p in planes], n, tl.w8_rec.data_ptr(),
            tl.tris.data_ptr(), tf.data_ptr(), roots.data_ptr(),
            tl.w8_tlas_nw, tl.leaf_size, float(t_min), tl.stack,
            int(find_closest), *outs, stream)
    build.check(rc, "tlas8_trace")
    LAUNCHES["closest" if find_closest else "any_hit"] += 1
    return (t, tri, inst, u, v) if find_closest else occ


def _rank(low):
    return ((low & 0xAA) != 0).long() + 2 * ((low & 0xCC) != 0).long() \
        + 4 * ((low & 0xF0) != 0).long()


# Per-ray counters of visit_counts.
COUNTS = ("tlas_nodes", "tlas_boxes", "instances", "blas_nodes",
          "blas_boxes", "leaves", "tests")


def _count_nodes(counts, rays, cur, tlas_nw: int, boxes=None):
    """Count node visits (and child box tests) of `rays` at nodes
    `cur`, as TLAS or BLAS by `tlas_nw`."""
    in_tlas = cur < tlas_nw
    counts["tlas_nodes"][rays[in_tlas]] += 1
    counts["blas_nodes"][rays[~in_tlas]] += 1
    if boxes is not None:
        counts["tlas_boxes"][rays[in_tlas]] += boxes[in_tlas]
        counts["blas_boxes"][rays[~in_tlas]] += boxes[~in_tlas]


def trace_plain(tl, ox, oy, oz, dx, dy, dz, tmax, t_min: float,
                find_closest: bool):
    """The same walk as a vectorised PyTorch stack machine: every live
    ray takes one stack entry per iteration."""
    planes = [p.contiguous() for p in (ox, oy, oz, dx, dy, dz, tmax)]
    _check_inputs(tl, planes)
    return _walk(tl, planes, t_min, find_closest)


def _walk(tl, planes, t_min: float, find_closest: bool, counts=None):
    """trace_plain's walk, counting into `counts` (a dict of COUNTS
    tensors) when given."""
    tmax = planes[6]
    n = tmax.shape[0]
    dev = tmax.device
    rec = tl.w8_nodes.reshape(-1)
    tris = tl.tris
    k = tl.leaf_size
    tf = tl.obj_from_world.reshape(-1, 12)
    roots = tl.w8_root.reshape(-1).long()
    ry = ActiveRays(planes)

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
        ry.leave(r)
        cur_inst[r] = -1

        # Enter: an instance entry -(inst + 1).
        en = e < 0
        r, se = live[en], s[en]
        iid = -e[en] - 1
        ry.enter(r, tf[iid])
        cur_inst[r] = iid
        inst_base[r] = se
        stack[r, se] = (roots[iid] << 8) | 1
        sp[r] = se + 1
        if counts is not None:
            counts["instances"][r] += 1

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
        boxes = torch.zeros_like(cur)
        for j in range(8):
            w = rec[node[:, None] + j * 128 + words]          # (m, 8)
            meta = w[:, 6].long()
            boxes += ((meta != 0) & alive).long()
            hit = slab_hit(w[:, :6].view(torch.float32), ry.inv[rv],
                           ry.oi[rv], t_min, t[rv]) & (meta != 0) & alive
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
                tris, meta[leaf] - 1, k, ry.o[rays], ry.d[rays], t_min,
                t[rays])
            if counts is not None:
                counts["leaves"][rays] += 1
                counts["tests"][rays] += leaf_test_counts(
                    tris, k, rays, meta[leaf] - 1, better, ry.o, ry.d, t_min,
                    t, find_closest)
            rb = rays[better]
            tri[rb] = ids[better]
            if find_closest:
                t[rb], u[rb], v[rb] = th[better], uh[better], vh[better]
                hit_inst[rb] = cur_inst[rb].to(torch.int32)
            else:
                dead = torch.zeros_like(alive)
                dead[torch.nonzero(leaf).squeeze(1)[better]] = True
                alive &= ~dead
        if counts is not None:
            _count_nodes(counts, rv, cur, tl.w8_tlas_nw, boxes)
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


# Entry kinds of the nearest-first walk: entry = payload << 2 | kind.
_NODE, _LEAF, _INST, _MARK = 0, 1, 2, 3


def _walk_nearest(tl, planes, t_min: float, find_closest: bool, counts):
    """The same table walked nearest first with a per-ray stack: a node
    visit tests its children's boxes and pushes the hit ones (internal
    nodes; BLAS leaves; in the TLAS, instances) sorted by entry distance
    (ties in slot order), farthest first, so the nearest is walked
    first; entering an instance pushes a marker under its BLAS root, and
    popping the marker brings the world ray back.  In closest mode an
    entry whose entry distance is past the live t is dropped untested.
    Counts as _walk does."""
    n = planes[0].shape[0]
    dev = planes[0].device
    rec = tl.w8_nodes.reshape(-1)
    tf = tl.obj_from_world.reshape(-1, 12)
    roots = tl.w8_root.reshape(-1).long()
    ry = ActiveRays(planes)
    t = planes[6].clone()
    tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    hit_inst = torch.full((n,), -1, dtype=torch.int32, device=dev)
    u = torch.zeros(n, device=dev)
    v = torch.zeros(n, device=dev)
    cinst = torch.zeros(n, dtype=torch.int64, device=dev)
    words = torch.arange(8, device=dev)
    st = RayStacks(n, dev)
    live = torch.nonzero(planes[6] >= 0).squeeze(1)
    st.push(live, torch.full_like(live, _NODE), t_min)
    while True:
        live, e, tn = st.pop()
        if live.numel() == 0:
            break
        kind, val = e & 3, e >> 2
        ry.leave(live[kind == _MARK])
        go = kind != _MARK
        if find_closest:
            go &= tn <= t[live]

        en = go & (kind == _INST)
        r, iid = live[en], val[en]
        cinst[r] = iid
        ry.enter(r, tf[iid])
        counts["instances"][r] += 1
        st.push(r, torch.full_like(r, _MARK), tn[en])
        st.push(r, (roots[iid] << 2) | _NODE, tn[en])

        lf = go & (kind == _LEAF)
        if bool(lf.any()):
            rays, start = live[lf], val[lf]
            better, th, ids, uh, vh = leaf_hits(
                tl.tris, start, tl.leaf_size, ry.o[rays], ry.d[rays], t_min,
                t[rays])
            counts["leaves"][rays] += 1
            counts["tests"][rays] += leaf_test_counts(
                tl.tris, tl.leaf_size, rays, start, better, ry.o, ry.d,
                t_min, t, find_closest)
            rb = rays[better]
            tri[rb] = ids[better]
            hit_inst[rb] = cinst[rb].to(torch.int32)
            if find_closest:
                t[rb], u[rb], v[rb] = th[better], uh[better], vh[better]
            else:
                st.sp[rb] = 0          # any hit: the first hit retires

        nd = go & (kind == _NODE)
        if not bool(nd.any()):
            continue
        rv, cur = live[nd], val[nd]
        in_tlas = cur < tl.w8_tlas_nw
        node = (cur >> 4) * 1024 + (cur & 15) * 8
        first_child = rec[node + 7].long()
        w = rec[node[:, None, None] + words[:, None] * 128
                + words[None, None, :]]                     # (m, 8, 8)
        meta = w[..., 6].long()
        m = rv.shape[0]
        hit, tj = slab_near(w[..., :6].reshape(-1, 6).view(torch.float32),
                            ry.inv[rv].repeat_interleave(8, 0),
                            ry.oi[rv].repeat_interleave(8, 0), t_min,
                            t[rv].repeat_interleave(8))
        hit = hit.view(m, 8) & (meta != 0)
        _count_nodes(counts, rv, cur, tl.w8_tlas_nw, (meta != 0).sum(1))
        entry = torch.where(
            meta < 0, ((first_child[:, None] - meta - 1) << 2) | _NODE,
            torch.where(in_tlas[:, None], ((meta - 1) << 2) | _INST,
                        ((meta - 1) << 2) | _LEAF))
        key = torch.where(hit, tj.view(m, 8), float("inf"))
        # Nearest on top, ties in slot order (as the kernel ranks them).
        order = torch.argsort(key, dim=1, stable=True)
        for j in range(7, -1, -1):
            c = order[:, j]
            p = hit.gather(1, c[:, None])[:, 0]
            st.push(rv[p], entry.gather(1, c[:, None])[p, 0],
                    key.gather(1, c[:, None])[p, 0])
    if find_closest:
        return t, tri, hit_inst, u, v
    return tri >= 0


def visit_counts(tl, ox, oy, oz, dx, dy, dz, tmax, t_min: float,
                 find_closest: bool, nearest: bool = False) -> dict:
    """Per-ray work of a walk over this batch: COUNTS, each an (N,)
    int64 tensor on the batch's device (TLAS and BLAS node visits and
    the child boxes they test, instances entered, BLAS leaves entered,
    Möller-Trumbore tests: K per leaf, and in any-hit mode the retiring
    leaf's tests up to its first hit), and the walk's result under
    "hits" (trace_plain's tuple, or its occlusion mask).  nearest=False
    counts trace_plain's walk; nearest=True the same table walked
    nearest first (_walk_nearest), whose closest hits differ from
    trace_plain's only at equal-t ties.  For measurements and tests
    only: nothing on the frame path calls it."""
    planes = [p.contiguous() for p in (ox, oy, oz, dx, dy, dz, tmax)]
    _check_inputs(tl, planes)
    n, dev = planes[0].shape[0], planes[0].device
    counts = {k: torch.zeros(n, dtype=torch.int64, device=dev)
              for k in COUNTS}
    walk = _walk_nearest if nearest else _walk
    counts["hits"] = walk(tl, planes, t_min, find_closest, counts)
    return counts


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
