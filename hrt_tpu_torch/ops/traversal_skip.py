"""K3: the binary skip-link walk — CUDA kernel wrapper and its plain
PyTorch version.

Replaces the Pallas kernel of hrt_tpu/ops/traversal_pallas.py
(`_trace_tiles`, body `_make_kernel`), which the JAX package runs for
every accel without a BVH8 table: the LBVH of a culling rebuild
(lbvh.build_bvh) and SAH trees past MAX_WIDE_NODES.  The kernel is
csrc/skip_trace.cu: a thread per ray, each keeping its own walk's
cursor, the 32 rays of a warp stepping together through the union of
their nodes; its source note says what bounds it on the card.

Both versions read an Accel's skip-link table `nodes` (the JAX FlatBVH
layout, over `m_real` nodes) and its (T, 12) triangle table, and follow
the same walk per ray: from node 0, a hit internal node goes to the next
node, a hit leaf runs Möller-Trumbore over its K triangles in slot order
and goes to the node's skip link, a miss goes to the skip link; the walk
ends past the last node.  Closest mode returns (t, tri, u, v) with
leaf-pool ids (-1 on a miss, t = t_max); any-hit mode returns a bool
occlusion mask, each ray retiring at its first hit.  A ray with
t_max < 0 is dead.

The kernel reads each node from its 32-byte record (`skip_records`,
the table repacked as an array of structs, cached on the Accel as
`skip_rec`) and tests triangles without a division until one passes
(`moller_scaled` is the plain mirror of that test, for the tests).
`visit_counts` counts a batch's node visits, leaves and triangle tests
per ray; nothing on the frame path calls it.

`trace` takes the plain version only for CPU tensors; CUDA tensors
always launch the kernel (and raise if it fails).
"""
from __future__ import annotations

import torch

from .intersect import (_DET_EPS, _cross, _dot, first_hit_slot, leaf_hits,
                        safe_inv_dir, slab_hit)

# Launches of the CUDA kernel, by mode; the plain version never counts.
LAUNCHES = {"closest": 0, "any_hit": 0}


def _check_inputs(accel, planes):
    n = planes[0].shape[0]
    dev = accel.nodes.device
    for p in planes:
        if p.dtype != torch.float32 or p.shape != (n,) or p.device != dev:
            raise ValueError("ray planes must be (N,) float32 on the "
                             "accel's device")


def trace_kernel(accel, ox, oy, oz, dx, dy, dz, tmax, t_min: float,
                 find_closest: bool):
    """Launch csrc/skip_trace.cu on CUDA tensors."""
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
        stream = build.stream(dev)
        rc = lib.hrt_skip_trace(
            *[p.data_ptr() for p in planes], n, accel.skip_rec.data_ptr(),
            accel.tris.data_ptr(), accel.m_real, accel.leaf_size,
            float(t_min), int(find_closest), *outs, stream)
    build.check(rc, "skip_trace")
    LAUNCHES["closest" if find_closest else "any_hit"] += 1
    return (t, tri, u, v) if find_closest else occ


def node_words(nodes: torch.Tensor, cur: torch.Tensor) -> torch.Tensor:
    """The 8 int32 words of skip-link nodes `cur` (m,): (m, 8), from the
    (Mp / 128, 8, 128) table (word c of node i at (i // 128) * 1024 +
    c * 128 + i % 128)."""
    flat = nodes.view(torch.int32).reshape(-1)
    base = (cur >> 7) * 1024 + (cur & 127)
    return flat[base[:, None]
                + 128 * torch.arange(8, device=cur.device)[None]]


def skip_records(nodes: torch.Tensor, m_real: int) -> torch.Tensor:
    """The kernel's node records: the (Mp / 128, 8, 128) skip-link table
    repacked on its device as an (m_real, 8) int32 array of structs, row
    i holding node i's words (six box floats as bits, leaf code, skip),
    so that a node is 32 contiguous bytes."""
    return (nodes.view(torch.int32).reshape(-1, 8, 128).permute(0, 2, 1)
            .reshape(-1, 8)[:m_real].contiguous())


def moller_scaled(ray_o, ray_d, v0, e1, e2, t_min, t_max):
    """Plain mirror of the kernel's division-free Möller-Trumbore
    (csrc/skip_common.cuh `moller_scaled`), over broadcast (..., 3)
    arguments as `intersect.moller_trumbore`: det, T.P, D.Q and E2.Q
    compared scaled by |det| and sign(det); t, u, v as products with
    1 / det, held to `moller_trumbore`'s conditions.  Returns (hit, t,
    u, v).  Only the tests call it: the plain walk keeps
    `moller_trumbore`."""
    pvec = _cross(ray_d, e2)
    det = _dot(e1, pvec)
    tvec = ray_o - v0
    uu = _dot(tvec, pvec)
    qvec = _cross(tvec, e1)
    vv = _dot(ray_d, qvec)
    tt = _dot(e2, qvec)
    adet = torch.abs(det)
    s = torch.where(torch.signbit(det), -1.0, 1.0)
    su, sv, st = uu * s, vv * s, tt * s
    ok = (adet > _DET_EPS) & (su >= 0.0) & (su <= adet) & (sv >= 0.0) \
        & (su + sv <= adet) & (st > t_min * adet) & (st < t_max * adet)
    inv_det = 1.0 / torch.where(ok, det, 1.0)
    u, v, t = uu * inv_det, vv * inv_det, tt * inv_det
    hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min) \
        & (t < t_max)
    return hit, t, u, v


def trace_plain(accel, ox, oy, oz, dx, dy, dz, tmax, t_min: float,
                find_closest: bool):
    """The same walk, vectorised over rays: every live ray advances one
    node per iteration."""
    planes = [p.contiguous() for p in (ox, oy, oz, dx, dy, dz, tmax)]
    _check_inputs(accel, planes)
    ox, oy, oz, dx, dy, dz, tmax = planes
    n = ox.shape[0]
    dev = ox.device
    o = torch.stack([ox, oy, oz], dim=1)
    d = torch.stack([dx, dy, dz], dim=1)
    inv = safe_inv_dir(d)
    oi = o * inv

    t = tmax.clone()
    tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    u = torch.zeros(n, device=dev)
    v = torch.zeros(n, device=dev)
    cur = torch.zeros(n, dtype=torch.int64, device=dev)
    live = torch.nonzero(tmax >= 0).squeeze(1)
    while live.numel():
        w = node_words(accel.nodes, cur[live])
        code, nxt = w[:, 6].long(), w[:, 7].long()
        hit = slab_hit(w[:, :6].view(torch.float32), inv[live], oi[live],
                       t_min, t[live])
        nxt = torch.where(hit & (code == 0), cur[live] + 1, nxt)
        leaf = hit & (code > 0)
        if bool(leaf.any()):
            rays = live[leaf]
            better, th, ids, uh, vh = leaf_hits(
                accel.tris, code[leaf] - 1, accel.leaf_size, o[rays],
                d[rays], t_min, t[rays])
            rb = rays[better]
            tri[rb] = ids[better]
            if find_closest:
                t[rb], u[rb], v[rb] = th[better], uh[better], vh[better]
            else:
                # Any hit: the first hit retires the ray.
                nxt[torch.nonzero(leaf).squeeze(1)[better]] = accel.m_real
        cur[live] = nxt
        live = live[nxt < accel.m_real]
    if find_closest:
        return t, tri, u, v
    return tri >= 0


def visit_counts(accel, ox, oy, oz, dx, dy, dz, tmax, t_min: float,
                 find_closest: bool) -> dict:
    """Per-ray work of the walk on this batch: {"nodes", "leaves",
    "tests"}, each an (N,) int64 tensor on the batch's device (node
    visits, leaves entered, Möller-Trumbore tests: K per leaf, and in
    any-hit mode the retiring leaf's tests up to its first hit, as the
    kernel stops there).  trace_plain's loop with counters; for
    measurements only, nothing on the frame path calls it."""
    planes = [p.contiguous() for p in (ox, oy, oz, dx, dy, dz, tmax)]
    _check_inputs(accel, planes)
    ox, oy, oz, dx, dy, dz, tmax = planes
    n = ox.shape[0]
    dev = ox.device
    o = torch.stack([ox, oy, oz], dim=1)
    d = torch.stack([dx, dy, dz], dim=1)
    inv = safe_inv_dir(d)
    oi = o * inv
    counts = {k: torch.zeros(n, dtype=torch.int64, device=dev)
              for k in ("nodes", "leaves", "tests")}

    t = tmax.clone()
    cur = torch.zeros(n, dtype=torch.int64, device=dev)
    live = torch.nonzero(tmax >= 0).squeeze(1)
    while live.numel():
        w = node_words(accel.nodes, cur[live])
        code, nxt = w[:, 6].long(), w[:, 7].long()
        hit = slab_hit(w[:, :6].view(torch.float32), inv[live], oi[live],
                       t_min, t[live])
        nxt = torch.where(hit & (code == 0), cur[live] + 1, nxt)
        leaf = hit & (code > 0)
        counts["nodes"][live] += 1
        if bool(leaf.any()):
            rays = live[leaf]
            better, th, _, _, _ = leaf_hits(
                accel.tris, code[leaf] - 1, accel.leaf_size, o[rays],
                d[rays], t_min, t[rays])
            counts["leaves"][rays] += 1
            tests = torch.full_like(rays, accel.leaf_size)
            if find_closest:
                t[rays[better]] = th[better]
            elif bool(better.any()):
                tests[better] = 1 + first_hit_slot(
                    accel.tris, code[leaf][better] - 1, accel.leaf_size,
                    o[rays[better]], d[rays[better]], t_min, t[rays[better]])
                nxt[torch.nonzero(leaf).squeeze(1)[better]] = accel.m_real
            counts["tests"][rays] += tests
        cur[live] = nxt
        live = live[nxt < accel.m_real]
    return counts


def trace(accel, ox, oy, oz, dx, dy, dz, tmax, t_min: float,
          find_closest: bool):
    """The skip-link walk: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if ox.is_cuda:
        return trace_kernel(accel, ox, oy, oz, dx, dy, dz, tmax, t_min,
                            find_closest)
    if ox.device.type != "cpu":
        raise ValueError(f"no skip-link walk for device {ox.device}")
    return trace_plain(accel, ox, oy, oz, dx, dy, dz, tmax, t_min,
                       find_closest)
