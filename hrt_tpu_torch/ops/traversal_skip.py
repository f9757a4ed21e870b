"""K3: the binary skip-link walk — CUDA kernel wrapper and its plain
PyTorch version.

Replaces the Pallas kernel of hrt_tpu/ops/traversal_pallas.py
(`_trace_tiles`, body `_make_kernel`), which the JAX package runs for
every accel without a BVH8 table: the LBVH of a culling rebuild
(lbvh.build_bvh) and SAH trees past MAX_WIDE_NODES.  The kernel is
csrc/skip_trace.cu, one thread per ray; its source note says what bounds
it on the card.

Both versions read an Accel's skip-link table `nodes` (the JAX FlatBVH
layout, over `m_real` nodes) and its (T, 12) triangle table, and follow
the same walk per ray: from node 0, a hit internal node goes to the next
node, a hit leaf runs Möller-Trumbore over its K triangles in slot order
and goes to the node's skip link, a miss goes to the skip link; the walk
ends past the last node.  Closest mode returns (t, tri, u, v) with
leaf-pool ids (-1 on a miss, t = t_max); any-hit mode returns a bool
occlusion mask, each ray retiring at its first hit.  A ray with
t_max < 0 is dead.

`trace` takes the plain version only for CPU tensors; CUDA tensors
always launch the kernel (and raise if it fails).
"""
from __future__ import annotations

import torch

from .intersect import leaf_hits, safe_inv_dir, slab_hit

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
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.hrt_skip_trace(
            *[p.data_ptr() for p in planes], n, accel.nodes.data_ptr(),
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
