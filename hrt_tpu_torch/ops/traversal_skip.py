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
per ray; nothing on the frame path calls it.  Under
intersect.DEBUG_COUNTERS (HRT_DEBUG_COUNTERS=1) the kernel's counting
build writes the same counts per ray, and per warp its steps (the union
of its rays' nodes) and the steps that ran a leaf; the plain walk
counts as visit_counts; either keeps them as `LAST_COUNTERS`.

`trace` takes the plain version only for CPU tensors; CUDA tensors
always launch the kernel (and raise if it fails).

`closest_hit`, `any_hit`, `closest_hit_p` and `any_hit_p` are the JAX
module's scene-level entry points: like it, they walk an accel with a
BVH8 table by K1 (ops/traversal_wide8.py) and any other by K3, as
ops/traversal.py routes them (they call it; `plain=True` replays the
walk through the plain versions).
"""
from __future__ import annotations

import torch

from . import intersect
from .intersect import (_DET_EPS, _dot, leaf_hits, leaf_test_counts,
                        safe_inv_dir, slab_hit)
from .math3d import cross

# Launches of the CUDA kernel by mode: of its normal build, and of its
# counting build; the plain version never counts.
LAUNCHES = {"closest": 0, "any_hit": 0}
DEBUG_LAUNCHES = {"closest": 0, "any_hit": 0}
# Per-ray counters of visit_counts and of the counting build; its
# per-warp counters (steps, and the steps that ran a leaf).
COUNTS = ("nodes", "leaves", "tests")
WARP_COUNTS = ("nodes", "leaves")
# The last walk's counts under intersect.DEBUG_COUNTERS (None before):
# COUNTS by name, (N,) int32 each, and from the kernel WARP_COUNTS as
# "warp_<name>", (ceil(N / 32),) each.
LAST_COUNTERS: dict | None = None


def _check_inputs(accel, planes):
    n = planes[0].shape[0]
    dev = accel.nodes.device
    for p in planes:
        if p.dtype != torch.float32 or p.shape != (n,) or p.device != dev:
            raise ValueError("ray planes must be (N,) float32 on the "
                             "accel's device")


def _keep_counts(counts: dict) -> None:
    global LAST_COUNTERS
    LAST_COUNTERS = counts


def trace_kernel(accel, ox, oy, oz, dx, dy, dz, tmax, t_min: float,
                 find_closest: bool):
    """Launch csrc/skip_trace.cu on CUDA tensors: its counting build when
    intersect.DEBUG_COUNTERS is set."""
    from ..kernels import build

    planes = [p.contiguous() for p in (ox, oy, oz, dx, dy, dz, tmax)]
    _check_inputs(accel, planes)
    n = planes[0].shape[0]
    dev = planes[0].device
    cnt = None
    if intersect.DEBUG_COUNTERS:
        cnt = torch.empty(intersect.count_words(n, COUNTS, WARP_COUNTS),
                          dtype=torch.int32, device=dev)
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
            float(t_min), int(find_closest), *outs,
            None if cnt is None else cnt.data_ptr(), stream)
    build.check(rc, "skip_trace")
    (LAUNCHES if cnt is None else DEBUG_LAUNCHES)[
        "closest" if find_closest else "any_hit"] += 1
    if cnt is not None:
        _keep_counts(intersect.unpack_counts(cnt, n, COUNTS, WARP_COUNTS))
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
    pvec = cross(ray_d, e2)
    det = _dot(e1, pvec)
    tvec = ray_o - v0
    uu = _dot(tvec, pvec)
    qvec = cross(tvec, e1)
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
    node per iteration.  With intersect.DEBUG_COUNTERS it counts as
    visit_counts and keeps the counts as LAST_COUNTERS."""
    planes = [p.contiguous() for p in (ox, oy, oz, dx, dy, dz, tmax)]
    _check_inputs(accel, planes)
    if not intersect.DEBUG_COUNTERS:
        return _walk(accel, planes, t_min, find_closest)
    counts = intersect.zero_counts(planes, COUNTS)
    out = _walk(accel, planes, t_min, find_closest, counts)
    _keep_counts({k: c.to(torch.int32) for k, c in counts.items()})
    return out


def _walk(accel, planes, t_min: float, find_closest: bool, counts=None):
    """trace_plain's walk, counting into `counts` (a dict of COUNTS
    tensors) when given."""
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
        if counts is not None:
            counts["nodes"][live] += 1
        if bool(leaf.any()):
            rays = live[leaf]
            better, th, ids, uh, vh = leaf_hits(
                accel.tris, code[leaf] - 1, accel.leaf_size, o[rays],
                d[rays], t_min, t[rays])
            if counts is not None:
                counts["leaves"][rays] += 1
                counts["tests"][rays] += leaf_test_counts(
                    accel.tris, accel.leaf_size, rays, code[leaf] - 1,
                    better, o, d, t_min, t, find_closest)
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
    """Per-ray work of the walk on this batch: COUNTS, each an (N,)
    int64 tensor on the batch's device (node visits, leaves entered,
    Möller-Trumbore tests: K per leaf, and in any-hit mode the retiring
    leaf's tests up to its first hit, as the kernel stops there).
    trace_plain's walk with counters; for measurements only, nothing on
    the frame path calls it."""
    planes = [p.contiguous() for p in (ox, oy, oz, dx, dy, dz, tmax)]
    _check_inputs(accel, planes)
    counts = intersect.zero_counts(planes, COUNTS)
    _walk(accel, planes, t_min, find_closest, counts)
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


def closest_hit_p(scene, accel, o, d, t_min, t_max,
                  sorted_ids: bool = False, plain: bool = False):
    """(t, tri, u, v) of the closest hits of V3 rays: K1 on an accel with
    a BVH8 table, else K3; original ids unless `sorted_ids`."""
    from . import traversal

    return traversal.closest_hit_bvh_p(scene, accel, o, d, t_min, t_max,
                                       sorted_ids=sorted_ids, plain=plain)


def any_hit_p(scene, accel, o, d, t_min, t_max, plain: bool = False):
    """Occlusion of V3 rays' segments: bool (N,)."""
    from . import traversal

    return traversal.any_hit_bvh_p(scene, accel, o, d, t_min, t_max,
                                   plain=plain)


def closest_hit(scene, accel, o, d, t_min, t_max, sorted_ids: bool = False,
                plain: bool = False):
    """closest_hit_p on (N, 3) rays."""
    from . import traversal

    return traversal.closest_hit_bvh(scene, accel, o, d, t_min, t_max,
                                     sorted_ids=sorted_ids, plain=plain)


def any_hit(scene, accel, o, d, t_min, t_max, plain: bool = False):
    """any_hit_p on (N, 3) rays."""
    from . import traversal

    return traversal.any_hit_bvh(scene, accel, o, d, t_min, t_max,
                                 plain=plain)
