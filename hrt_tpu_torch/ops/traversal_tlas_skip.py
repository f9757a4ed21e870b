"""K5: the binary two-level skip-link walk (TLAS -> BLAS) — CUDA kernel
wrapper and its plain PyTorch version.

Replaces the Pallas kernel of hrt_tpu/ops/tlas.py (`_trace_tiles_tlas`,
body `_make_tlas_kernel`), which the JAX package runs for two-level
scenes whose unified BVH8 table would reach MAX_WIDE_NODES (or whose
BLAS overflows its own collapse).  The kernel is csrc/tlas_skip_trace.cu:
a thread per ray walking the tables nearest first with a short stack
(`tlas.skip_stack_bound`), the leaves of a warp tested together; its
source note says what bounds it on the card.

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

The kernel reads the table as 32-byte node records (`TwoLevelFlat.
skip_rec`) and tests triangles without a division until one passes
(traversal_skip.moller_scaled mirrors that test for the tests).
`visit_counts` counts a batch's visits per ray in the table's order and
nearest first (the kernel's order); nothing on the frame path calls it.

`trace` takes the plain version only for CPU tensors; CUDA tensors
always launch the kernel (and raise if it fails).
"""
from __future__ import annotations

import torch

from .intersect import (ActiveRays, RayStacks, leaf_hits, leaf_test_counts,
                        slab_hit, slab_near)
from .traversal_skip import node_words

# Launches of the CUDA kernel, by mode; the plain version never counts.
LAUNCHES = {"closest": 0, "any_hit": 0}
# Stack entries the kernel can hold per ray; tlas.binary_blas_depth
# refuses tables that need more (tlas.skip_stack_bound).
MAX_STACK = 128


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
        stream = build.stream(dev)
        rc = lib.hrt_tlas_skip_trace(
            *[p.data_ptr() for p in planes], n, tl.skip_rec.data_ptr(),
            tl.tris.data_ptr(), tf.data_ptr(), tl.blas_base.data_ptr(),
            tl.leaf_size, float(t_min), tl.skip_stack, int(find_closest),
            *outs, stream)
    build.check(rc, "tlas_skip_trace")
    LAUNCHES["closest" if find_closest else "any_hit"] += 1
    return (t, tri, inst, u, v) if find_closest else occ


# Per-ray counters of visit_counts.
COUNTS = ("tlas_nodes", "instances", "blas_nodes", "leaves", "tests")


def _walk(tl, planes, t_min: float, find_closest: bool, counts=None):
    """The preorder walk (trace_plain), counting into `counts` (a dict
    of COUNTS tensors) when given."""
    tmax = planes[6]
    n = tmax.shape[0]
    dev = tmax.device
    tf = tl.obj_from_world.reshape(-1, 12)
    base, end = tl.blas_base.long(), tl.blas_end.long()
    ry = ActiveRays(planes)

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
        hit = slab_hit(w[:, :6].view(torch.float32), ry.inv[live],
                       ry.oi[live], t_min, t[live])
        nxt = torch.where(hit & (code == 0), cur[live] + 1, nxt)
        retired = torch.zeros_like(hit)
        if counts is not None:
            b = in_blas[live]
            counts["tlas_nodes"][live[~b]] += 1
            counts["blas_nodes"][live[b]] += 1

        leaf = hit & (code > 0)
        if bool(leaf.any()):
            rays = live[leaf]
            better, th, ids, uh, vh = leaf_hits(
                tl.tris, code[leaf] - 1, tl.leaf_size, ry.o[rays],
                ry.d[rays], t_min, t[rays])
            if counts is not None:
                counts["leaves"][rays] += 1
                counts["tests"][rays] += leaf_test_counts(
                    tl.tris, tl.leaf_size, rays, code[leaf] - 1, better,
                    ry.o, ry.d, t_min, t, find_closest)
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
            ry.enter(r, tf[iid])
            if counts is not None:
                counts["instances"][r] += 1

        # BLAS done: back to the world ray and the TLAS resume point.
        pop = in_blas[live] & (nxt >= bend[live])
        if bool(pop.any()):
            r = live[pop]
            ry.leave(r)
            nxt[pop] = resume[r]
            in_blas[r] = False

        cur[live] = nxt
        live = live[(in_blas[live] | (nxt < tl.tlas_m)) & ~retired]
    if find_closest:
        return t, tri, hit_inst, u, v
    return tri >= 0


def _walk_nearest(tl, planes, t_min: float, find_closest: bool, counts):
    """The same tables walked nearest first with a per-ray stack: a hit
    internal node tests both children (left i + 1, right the left
    child's skip) and pushes the hit ones far first, so the nearer is
    walked first; entering an instance pushes a marker (-1) under its
    BLAS root, and popping the marker brings the world ray back.  In
    closest mode an entry whose entry distance is past the live t is
    dropped untested.  Counts as _walk does."""
    tmax = planes[6]
    n = tmax.shape[0]
    dev = tmax.device
    f32 = torch.float32
    tf = tl.obj_from_world.reshape(-1, 12)
    base = tl.blas_base.long()
    ry = ActiveRays(planes)
    t = tmax.clone()
    tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    hit_inst = torch.full((n,), -1, dtype=torch.int32, device=dev)
    u = torch.zeros(n, device=dev)
    v = torch.zeros(n, device=dev)
    cinst = torch.zeros(n, dtype=torch.int64, device=dev)
    st = RayStacks(n, dev)

    def test(rays, nodes, key):
        """Slab-test nodes (one per ray) and count the visits."""
        w = node_words(tl.nodes, nodes)
        hit, tn = slab_near(w[:, :6].view(f32), ry.inv[rays], ry.oi[rays],
                            t_min, t[rays])
        if isinstance(key, str):
            counts[key][rays] += 1
        else:
            counts["tlas_nodes"][rays[key]] += 1
            counts["blas_nodes"][rays[~key]] += 1
        return hit, tn

    live = torch.nonzero(tmax >= 0).squeeze(1)
    root = torch.zeros_like(live)
    hit, tn = test(live, root, "tlas_nodes")
    st.push(live[hit], root[hit], tn[hit])
    while True:
        live, e, tn = st.pop()
        if live.numel() == 0:
            break
        marker = e < 0
        ry.leave(live[marker])
        go = ~marker
        if find_closest:
            go &= tn <= t[live]
        rv, ev, tv = live[go], e[go], tn[go]
        code = node_words(tl.nodes, ev)[:, 6].long()

        inner = code == 0
        if bool(inner.any()):
            ri, ei = rv[inner], ev[inner]
            in_tlas = ei < tl.tlas_m
            left = ei + 1
            right = node_words(tl.nodes, left)[:, 7].long()
            hl, tl_ = test(ri, left, in_tlas)
            hr, tr_ = test(ri, right, in_tlas)
            near_l = tl_ <= tr_
            far, far_t = torch.where(near_l, right, left), \
                torch.where(near_l, tr_, tl_)
            far_h = torch.where(near_l, hr, hl)
            near, near_t = torch.where(near_l, left, right), \
                torch.where(near_l, tl_, tr_)
            near_h = torch.where(near_l, hl, hr)
            st.push(ri[far_h], far[far_h], far_t[far_h])
            st.push(ri[near_h], near[near_h], near_t[near_h])

        leaf = code > 0
        if bool(leaf.any()):
            rays = rv[leaf]
            start = code[leaf] - 1
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

        enter = code < 0
        if bool(enter.any()):
            r = rv[enter]
            iid = -code[enter] - 1
            cinst[r] = iid
            ry.enter(r, tf[iid])
            counts["instances"][r] += 1
            st.push(r, torch.full_like(r, -1), tv[enter])
            hit, tb = test(r, base[iid], "blas_nodes")
            st.push(r[hit], base[iid][hit], tb[hit])
    if find_closest:
        return t, tri, hit_inst, u, v
    return tri >= 0


def trace_plain(tl, ox, oy, oz, dx, dy, dz, tmax, t_min: float,
                find_closest: bool):
    """The same walk, vectorised over rays: every live ray advances one
    node per iteration."""
    planes = [p.contiguous() for p in (ox, oy, oz, dx, dy, dz, tmax)]
    _check_inputs(tl, planes)
    return _walk(tl, planes, t_min, find_closest)


def visit_counts(tl, ox, oy, oz, dx, dy, dz, tmax, t_min: float,
                 find_closest: bool, nearest: bool = False) -> dict:
    """Per-ray work of a walk over this batch: COUNTS, each an (N,)
    int64 tensor on the batch's device (TLAS node visits, instances
    entered, BLAS node visits, BLAS leaves entered, Möller-Trumbore
    tests: K per leaf, and in any-hit mode the retiring leaf's tests up
    to its first hit), and the walk's result under "hits" (trace_plain's
    tuple, or its occlusion mask).  nearest=False counts trace_plain's
    preorder walk; nearest=True the same tables walked nearest first
    (_walk_nearest), whose closest hits differ from trace_plain's only
    at equal-t ties.  For measurements and tests only: nothing on the
    frame path calls it."""
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
    """The binary two-level walk: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if ox.is_cuda:
        return trace_kernel(tl, ox, oy, oz, dx, dy, dz, tmax, t_min,
                            find_closest)
    if ox.device.type != "cpu":
        raise ValueError(f"no binary two-level walk for device {ox.device}")
    return trace_plain(tl, ox, oy, oz, dx, dy, dz, tmax, t_min,
                       find_closest)
