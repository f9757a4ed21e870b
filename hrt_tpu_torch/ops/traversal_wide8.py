"""K1: the BVH8 walk — CUDA kernel wrapper and its plain PyTorch version.

Replaces the Pallas kernel of hrt_tpu/ops/traversal_wide8.py
(`_trace_tiles_wide8`, body `_make_kernel`, exact node-test mode).  The
kernel is csrc/bvh8_trace.cu: a warp walks its rays as one packet,
closest hits nearest child first, any hits in slot order; its source
note says what bounds it on the card.

Both versions read the same BVH8 nodes and the same (T, 12) float32
triangle table (Accel.tris).  The plain version walks the (R, 8, 128)
int32 record table (Accel.w8): pop (base, mask), visit the lowest-rank
child, test its 8 children against the ray's live t (exact per-ray slab
tests), run Möller-Trumbore over each hit leaf's K triangles in slot
order and push the hit internal children as one (base << 8 | mask)
entry.  The kernel reads the same nodes as 256-byte records
(`wide8.node_records`, cached as `Accel.w8_rec`) in its own order and
tests triangles without a division until one passes
(traversal_skip.moller_scaled mirrors that test for the tests), so its
hits differ from the plain walk's only at equal-t ties and within
rounding of an edge.  Closest mode returns (t, tri, u, v) with
leaf-pool ids (-1 on a miss, t = t_max); any-hit mode returns a bool
occlusion mask.  A ray with t_max < 0 is dead.  `visit_counts` counts a
batch's visits per ray in the plain walk's order and nearest first (the
closest kernel's order); nothing on the frame path calls it.

`trace` takes the plain version only for CPU tensors; CUDA tensors
always launch the kernel (and raise if it fails).
"""
from __future__ import annotations

import types

import torch

from .intersect import leaf_hits, safe_inv_dir, slab_hit

# Launches of the CUDA kernel, by mode; the plain version never counts.
LAUNCHES = {"closest": 0, "any_hit": 0}
# Per-ray counters of visit_counts.
COUNTS = ("nodes", "boxes", "leaves", "tests")


def stack_entries(depth: int) -> int:
    """Stack entries a walk of a wide tree of this depth (root = 0) can
    need: nearest first, a node visit keeps up to 7 of its 8 children
    for later, so 7 per level plus the entry being walked."""
    return 7 * (depth + 1) + 1


# Stack entries the kernel can hold: every tree of up to 32 wide levels
# (the first kernel's bound) is taken; lbvh.make_accel refuses deeper
# trees.
MAX_STACK = stack_entries(31)


def _check_inputs(accel, planes):
    n = planes[0].numel()
    dev = accel.w8.device
    for p in planes:
        if p.dtype is not torch.float32 or p.dim() != 1 or p.numel() != n \
                or p.device != dev:
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
    if find_closest:
        # t, tri (int32 bits), u, v: the rows of one allocation.
        out = torch.empty((4, n), dtype=torch.float32, device=dev)
        base = out.data_ptr()
        outs = [base, base + 4 * n, base + 8 * n, base + 12 * n, None]
    else:
        out = torch.empty(n, dtype=torch.bool, device=dev)
        outs = [None] * 4 + [out.data_ptr()]
    lib = build.load()
    with torch.cuda.device(dev):
        rc = lib.hrt_bvh8_trace(
            *[p.data_ptr() for p in planes], n, accel.w8_rec.data_ptr(),
            accel.tris.data_ptr(), accel.leaf_size, float(t_min),
            stack_entries(accel.w8_depth), int(find_closest), *outs,
            build.stream(dev))
    build.check(rc, "bvh8_trace")
    LAUNCHES["closest" if find_closest else "any_hit"] += 1
    if not find_closest:
        return out
    t, tri, u, v = out.unbind(0)
    return t, tri.view(torch.int32), u, v


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


def visit_counts(accel, ox, oy, oz, dx, dy, dz, tmax, t_min: float,
                 find_closest: bool, nearest: bool = False) -> dict:
    """Per-ray work of a walk over this batch: COUNTS, each an (N,)
    int64 tensor on the batch's device (wide nodes visited, the child
    boxes they test, leaves entered, Möller-Trumbore tests: K per leaf,
    and in any-hit mode the retiring leaf's tests up to its first hit),
    and the walk's result under "hits" (trace_plain's tuple, or its
    occlusion mask).  nearest=False counts trace_plain's walk;
    nearest=True the same table walked nearest first, whose closest hits
    differ from trace_plain's only at equal-t ties.  The single-level
    table is walked as the two-level walks' counters walk a TLAS-less
    table (traversal_tlas8.visit_counts).  For measurements and tests
    only: nothing on the frame path calls it."""
    from . import traversal_tlas8

    planes = [p.contiguous() for p in (ox, oy, oz, dx, dy, dz, tmax)]
    _check_inputs(accel, planes)
    w8 = accel.w8
    no_tlas = types.SimpleNamespace(
        w8_nodes=w8, w8_tlas_nw=0, tris=accel.tris,
        leaf_size=accel.leaf_size, stack=accel.w8_depth + 1,
        obj_from_world=w8.new_zeros((0, 12), dtype=torch.float32),
        w8_root=w8.new_zeros((0, 1)))
    c = traversal_tlas8.visit_counts(no_tlas, *planes, t_min, find_closest,
                                     nearest=nearest)
    hits = c["hits"]
    if find_closest:
        hits = (hits[0], hits[1], hits[3], hits[4])    # no instance id
    return {"nodes": c["blas_nodes"], "boxes": c["blas_boxes"],
            "leaves": c["leaves"], "tests": c["tests"], "hits": hits}


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
