"""Binary -> BVH8 collapse, emitting the JAX package's (R, 8, 128) int32
record table bit for bit (hrt_tpu/ops/wide8.py `_flags_and_ids` +
`_assemble` + `build_wide8`, with the collapse primitive of
hrt_tpu/ops/wide.py `_cut`), and the two-level table's pieces: the
globalized BLAS regions and the wide TLAS over instance boxes.  The SAH
trees' collapse at load (`build_wide8`) runs on the host in numpy, as
the JAX package's is host-eager; the TLAS (`build_wide8_tlas`) is built
in torch on the table's device with fixed sweeps into a static node
count, so that a refit is a capturable program.

Record layout: wide node q lives in row q // 16; child slot j of it is
the 8 int32 words at records[q // 16, j, 8 * (q % 16) : 8 * (q % 16) + 8]
— flat word offset (q // 16) * 1024 + j * 128 + (q % 16) * 8:
  words 0..5  child AABB (bminx, bminy, bminz, bmaxx, bmaxy, bmaxz),
              float32 bit patterns
  word 6      meta: 0 empty, > 0 leaf (tri_start + 1),
              < 0 internal child of rank r, stored as -(r + 1)
  word 7      slot 0: id of the node's first internal child ("base"),
              so the child of rank r is base + r; slot 1: leaf_base << 8
Wide ids are BFS with the children of a node contiguous, ordered by
(depth, parent id, slot); slots are leaf-first, then internal, then
empty.  The leaf pool is reordered so a node's leaf children are
contiguous in slot order (`old_of_new`).

The walks on the card (K1, K4) read the same words node by node
(`node_records`).
"""
from __future__ import annotations

import numpy as np
import torch

from . import morton

ARITY = 8
NODES_PER_ROW = 16
MAX_WIDE_NODES = 1 << 15      # the JAX kernel packs base into 15 bits
_EMPTY = -(2 ** 30)
_BIG = np.float32(3e38)


def _cut(child_l: np.ndarray, child_r: np.ndarray) -> np.ndarray:
    """Depth-3 cut of every binary internal node: (Ni, 8) entries in
    binary-node encoding (>= 0 internal id, < 0 leaf -(leaf + 1),
    _EMPTY)."""
    ni = child_l.shape[0]
    cut = np.stack([child_l, child_r], axis=1)
    for _ in range(2):
        is_int = cut >= 0
        safe = np.clip(cut, 0, ni - 1)
        left = np.where(is_int, child_l[safe], cut)
        right = np.where(is_int, child_r[safe], _EMPTY)
        cut = np.stack([left, right], axis=-1).reshape(ni, -1)
    return cut


def build_wide8(child_l, child_r, bmin_l, bmax_l, bmin_r, bmax_r,
                leaf_min, leaf_max, leaf_size: int, reorder: bool = True,
                leaf_vals=None, nw_pad: int | None = None):
    """Collapse a binary tree (leaves encoded -(leaf + 1)) into BVH8
    records (JAX `_assemble`).  leaf_min/leaf_max are the (NL_pool, 3)
    leaf boxes of the pool (padding leaves inverted).

    reorder=True emits metas and leaf_base against the reordered pool;
    reorder=False keeps the pool order (meta = leaf * leaf_size + 1) and
    leaf_base 0.  leaf_vals (NL_pool,) replaces the meta payload (meta =
    leaf_vals[leaf] + 1; the TLAS passes instance ids).  nw_pad pads the
    table to a fixed node count (default: nw rounded up to a row).
    Returns (records (R, 8, 128) int32, old_of_new (NL_pool,) int64: the
    reorder's permutation, new pool block b holds old block
    old_of_new[b]; computed in either mode), or None when the tree has
    MAX_WIDE_NODES wide nodes or more (the JAX package then walks the
    binary skip-link table).  Raises ValueError past nw_pad."""
    ni = child_l.shape[0]
    nl_pool = leaf_min.shape[0]
    cuts = _cut(child_l, child_r)
    is_leaf0 = (cuts < 0) & (cuts != _EMPTY)
    cls = np.where(is_leaf0, 0, np.where(cuts >= 0, 8, 16))
    order = np.argsort(cls + np.arange(ARITY)[None], axis=1, kind="stable")
    cuts = np.take_along_axis(cuts, order, axis=1)

    # BFS over wide nodes; ids follow (depth, parent id, slot).
    levels = [np.zeros(1, np.int64)]
    while True:
        kids = cuts[levels[-1]].reshape(-1)
        kids = kids[kids >= 0]
        if kids.size == 0:
            break
        levels.append(kids.astype(np.int64))
    node_of_id = np.concatenate(levels)
    nw = node_of_id.shape[0]
    if nw >= MAX_WIDE_NODES:
        return None
    if reorder and nl_pool * leaf_size * 256 >= 2 ** 31:
        raise ValueError("leaf pool too large for leaf_base << 8")
    id_of = np.zeros(ni, np.int64)
    id_of[node_of_id] = np.arange(nw)

    c = cuts[node_of_id]                              # (nw, 8)
    is_int = c >= 0
    is_leaf = (c < 0) & (c != _EMPTY)
    safe_int = np.clip(c, 0, ni - 1)
    leaf_of = np.clip(-(c + 1), 0, nl_pool - 1)

    # Leaf-pool reorder: a node's leaf children become contiguous.
    entry_key = np.arange(nw)[:, None] * ARITY + np.arange(ARITY)[None]
    key = np.full(nl_pool, -1, np.int64)
    key[leaf_of[is_leaf]] = entry_key[is_leaf]
    key = np.where(key >= 0, key, (1 << 28) + np.arange(nl_pool))
    old_of_new = np.argsort(key, kind="stable")
    new_pos = np.empty(nl_pool, np.int64)
    new_pos[old_of_new] = np.arange(nl_pool)

    own_min = np.minimum(bmin_l, bmin_r)
    own_max = np.maximum(bmax_l, bmax_r)
    ent_min = np.where(is_int[..., None], own_min[safe_int],
                       np.where(is_leaf[..., None], leaf_min[leaf_of],
                                _BIG)).astype(np.float32)
    ent_max = np.where(is_int[..., None], own_max[safe_int],
                       np.where(is_leaf[..., None], leaf_max[leaf_of],
                                _BIG)).astype(np.float32)
    inv = ent_min[..., 0:1] > ent_max[..., 0:1]       # padding leaves
    ent_min = np.where(inv, _BIG, ent_min)
    ent_max = np.where(inv, _BIG, ent_max)

    rank = np.cumsum(is_int, axis=1) - is_int
    if leaf_vals is not None:
        tri_start = np.asarray(leaf_vals)[leaf_of]
    else:
        tri_start = (new_pos[leaf_of] if reorder else leaf_of) * leaf_size
    meta = np.where(is_int, -(rank + 1),
                    np.where(is_leaf, tri_start + 1, 0))
    child_ids = np.where(is_int, id_of[safe_int], 2 ** 30)
    base = child_ids.min(axis=1)
    base = np.where(base == 2 ** 30, 0, base)
    lbase = np.where(is_leaf[:, 0], tri_start[:, 0], 0) * 256
    if not reorder:
        lbase = np.zeros_like(lbase)

    if nw_pad is None:
        nw_pad = -(-nw // NODES_PER_ROW) * NODES_PER_ROW
    elif nw > nw_pad:
        raise ValueError(f"{nw} wide nodes exceed the table's {nw_pad}")
    v = np.zeros((nw_pad, ARITY, ARITY), np.int32)
    v[:, :, 0:6] = _BIG.view(np.int32)
    v[:nw, :, 0:3] = ent_min.view(np.int32)
    v[:nw, :, 3:6] = ent_max.view(np.int32)
    v[:nw, :, 6] = meta
    v[:nw, 0, 7] = base
    v[:nw, 1, 7] = lbase
    r = nw_pad // NODES_PER_ROW
    records = v.reshape(r, NODES_PER_ROW, ARITY, ARITY) \
        .transpose(0, 2, 1, 3).reshape(r, ARITY, 128)
    return np.ascontiguousarray(records), old_of_new


def node_records(records: torch.Tensor) -> torch.Tensor:
    """The kernels' node records: an (R, 8, 128) record table repacked
    on its device as an (R * 16, 64) int32 array, row q holding wide node
    q's 8 child records of 8 words in slot order, so that a node is 256
    contiguous bytes (in the table, child j of node q lies at
    (q // 16) * 1024 + j * 128 + (q % 16) * 8, 512 bytes from child
    j + 1)."""
    r = records.shape[0]
    return (records.reshape(r, ARITY, NODES_PER_ROW, ARITY)
            .permute(0, 2, 1, 3).reshape(r * NODES_PER_ROW, 64).contiguous())


def node_depths(records: np.ndarray) -> np.ndarray:
    """Depth of every wide node of a record table below the root of its
    region (a node no internal child slot points to has depth 0), read
    back from the records themselves so imported tables are sized the
    same way as built ones.  A unified two-level table thus gives TLAS
    depths in its TLAS region and BLAS depths in each BLAS region."""
    r = records.shape[0]
    v = records.reshape(r, ARITY, NODES_PER_ROW, ARITY) \
        .transpose(0, 2, 1, 3).reshape(r * NODES_PER_ROW, ARITY, ARITY)
    n_int = (v[:, :, 6] < 0).sum(axis=1)
    has = np.nonzero(n_int)[0]
    counts = n_int[has]
    parent = np.full(v.shape[0], -1, np.int64)
    first = np.cumsum(counts) - counts
    kids = (np.repeat(v[has, 0, 7].astype(np.int64), counts)
            + np.arange(counts.sum()) - np.repeat(first, counts))
    parent[kids] = np.repeat(has, counts)
    depth = np.zeros(v.shape[0], np.int64)
    # One level per sweep, until nothing moves.
    while True:
        new = np.where(parent >= 0, depth[np.maximum(parent, 0)] + 1, 0)
        if np.array_equal(new, depth):
            return depth
        depth = new


def record_depth(records: np.ndarray) -> int:
    """Depth of the wide tree stored in a record table (root = 0)."""
    return int(node_depths(records).max())


# ---------------------------------------------------------------------------
# Two-level support (ops/tlas.py): region globalization and the wide TLAS
# over instance boxes (hrt_tpu/ops/wide8.py `globalize`, `tlas_nw_pad`,
# `build_wide8_tlas`).  ops/traversal_tlas8.py walks the unified table.
# ---------------------------------------------------------------------------

def globalize(records: np.ndarray, tri_base: int, id_base: int) -> np.ndarray:
    """Shift a region's leaf metas by `tri_base`, its first-internal-
    child bases by `id_base` and its leaf_base words by tri_base << 8.
    As the JAX package, every node's base shifts, childless and padding
    nodes too (no walk reads them)."""
    lane = np.arange(128) % ARITY
    sub = np.arange(ARITY)[None, :, None]
    meta_lane = (lane == 6)[None, None, :]
    base_lane = (lane == 7)[None, None, :] & (sub == 0)
    lb_lane = (lane == 7)[None, None, :] & (sub == 1)
    out = np.where(meta_lane & (records > 0), records + np.int32(tri_base),
                   records)
    out = np.where(base_lane, out + np.int32(id_base), out)
    return np.where(lb_lane, out + np.int32(tri_base * 256), out) \
        .astype(np.int32)


def tlas_nw_pad(num_instances: int) -> int:
    """Static wide-node capacity for a TLAS over `num_instances` boxes
    (the binary internal count bounds the wide node count), so that a
    refit never moves a BLAS region."""
    n = max(num_instances, 2)
    return max(NODES_PER_ROW,
               (n - 1 + NODES_PER_ROW - 1) // NODES_PER_ROW
               * NODES_PER_ROW)


def _cut_torch(child_l: torch.Tensor, child_r: torch.Tensor):
    """`_cut` in torch: (Ni, 8) int64 entries."""
    ni = child_l.shape[0]
    cl, cr = child_l.long(), child_r.long()
    cut = torch.stack([cl, cr], dim=1)
    for _ in range(2):
        is_int = cut >= 0
        safe = cut.clamp(0, ni - 1)
        left = torch.where(is_int, cl[safe], cut)
        right = torch.where(is_int, cr[safe], _EMPTY)
        cut = torch.stack([left, right], dim=-1).reshape(ni, -1)
    return cut


# A wide depth no sweep reached (JAX's big_d): deeper than the sweeps.
_BIG_D = 1 << 20


def wide_sweeps(n_leaves: int) -> int:
    """Sweeps of the wide depths and BFS ids over the radix tree of
    `n_leaves` keys: a wide level is three binary levels (a cut's
    internal entries lie three levels down), so its wide depth is below
    lbvh.sweep_bound(n) / 3, and one top-down sweep finalises one wide
    level.  At most 22 for any leaf count below 2^32, within JAX's 24."""
    from .lbvh import sweep_bound

    return sweep_bound(n_leaves) // 3 + 1


def _flags_and_ids(child_l: torch.Tensor, child_r: torch.Tensor,
                   sweeps: int):
    """JAX `_flags_and_ids` with `sweeps` sweeps: which binary nodes
    become wide nodes (those the top-down depth sweeps reach, as JAX's
    flag sweeps reach the same set), their wide depths (root 0) and BFS
    ids, the leaf-first cuts, and the wide tree's depth as a 0-d tensor:
    _BIG_D when a wide node's internal child lies deeper than the
    sweeps, so that it reads as too deep, never as shallow.  Every
    scatter drops its masked entries into a spare last slot (index ni,
    sliced off: JAX's mode="drop"); no Python number is stored through
    indexing (a host copy)."""
    ni = child_l.shape[0]
    dev = child_l.device
    cuts = _cut_torch(child_l, child_r)
    is_leaf0 = (cuts < 0) & (cuts != _EMPTY)
    cls = torch.where(is_leaf0, 0, torch.where(cuts >= 0, 8, 16))
    slot_iota = torch.arange(ARITY, device=dev).expand(ni, ARITY)
    cuts = torch.take_along_dim(cuts, torch.argsort(cls + slot_iota, dim=1),
                                dim=1)
    is_int = cuts >= 0
    safe_int = cuts.clamp(0, ni - 1)

    # Wide depths top-down: min(depth, parent + 1) over every internal cut
    # entry; an unreached node's _BIG_D + 1 never lowers a minimum.
    into = torch.where(is_int, cuts, ni).reshape(-1)
    depth = torch.where(torch.arange(ni + 1, device=dev) == 0, 0, _BIG_D)
    for _ in range(sweeps):
        depth.scatter_reduce_(0, into, (depth[:ni, None] + 1).expand(
            ni, ARITY).reshape(-1), "amin")
    depth = depth[:ni]
    flags = depth < _BIG_D
    kids = flags[:, None] & is_int
    deepest = torch.maximum(torch.where(flags, depth, 0).max(),
                            torch.where(kids, depth[safe_int], 0).max())

    # Parent binary id and slot of every wide node (root: 0, 0).
    dst = torch.where(kids, cuts, ni).reshape(-1)
    parent = torch.zeros(ni + 1, dtype=torch.int64, device=dev)
    parent[dst] = torch.arange(ni, device=dev)[:, None].expand(
        ni, ARITY).reshape(-1)
    slot = torch.zeros(ni + 1, dtype=torch.int64, device=dev)
    slot[dst] = slot_iota.reshape(-1)
    parent, slot = parent[:ni], slot[:ni]

    # BFS ids: rank by (depth, parent id, slot), one wide level per sweep
    # (the other nodes rank after every wide node).
    key0 = torch.where(flags, depth * (ARITY * ni) + slot, 1 << 62)
    ids = torch.zeros(ni, dtype=torch.int64, device=dev)
    iota = torch.arange(ni, device=dev)
    for _ in range(sweeps):
        key = key0 + ids[parent] * ARITY
        ids = torch.empty_like(ids)
        ids[torch.argsort(key, stable=True)] = iota
    return flags, ids, cuts, deepest


def build_wide8_tlas(inst_bmin: torch.Tensor, inst_bmax: torch.Tensor,
                     nw_pad: int):
    """BVH8 records for a TLAS over instance world AABBs (I, 3) float32,
    on their device: Morton order, Karras tree, refit, collapse with
    leaf metas = original instance id + 1, into `nw_pad` nodes
    (tlas_nw_pad(I), which bounds the wide node count).  A single
    instance duplicates its box (the radix tree needs two leaves).
    Every step is a fixed count of torch ops (JAX's jitted
    `build_wide8_tlas`), so it makes no host sync and can be captured.
    Returns (records (nw_pad / 16, 8, 128) int32, the wide tree's depth
    (root = 0) as a 0-d int64 tensor, _BIG_D if a node lay deeper than
    the sweeps: deeper than any stack)."""
    from .lbvh import karras_hierarchy, refit

    i_real = inst_bmin.shape[0]
    if i_real == 1:
        inst_bmin = torch.cat([inst_bmin, inst_bmin])
        inst_bmax = torch.cat([inst_bmax, inst_bmax])
    dev = inst_bmin.device
    centroid = (inst_bmin + inst_bmax) * 0.5
    codes = morton.morton_codes(centroid, inst_bmin.min(dim=0).values,
                                inst_bmax.max(dim=0).values)
    order = torch.argsort(codes, stable=True)
    child_l, child_r = karras_hierarchy(codes[order])
    lmin, lmax = inst_bmin[order], inst_bmax[order]
    bmin_l, bmax_l, bmin_r, bmax_r = refit(child_l, child_r, lmin, lmax)

    # JAX `_assemble` with leaf_vals = original instance ids, no reorder.
    ni = child_l.shape[0]
    flags, ids, c, deepest = _flags_and_ids(child_l, child_r,
                                            wide_sweeps(ni + 1))
    is_int = c >= 0
    is_leaf = (c < 0) & (c != _EMPTY)
    safe_int = c.clamp(0, ni - 1)
    leaf_of = (-(c + 1)).clamp(0, ni)
    big = float(_BIG)
    own_min = torch.minimum(bmin_l, bmin_r)
    own_max = torch.maximum(bmax_l, bmax_r)
    ent = []
    for own, leaf in ((own_min, lmin), (own_max, lmax)):
        ent.append(torch.where(is_int[..., None], own[safe_int],
                               torch.where(is_leaf[..., None],
                                           leaf[leaf_of], big)))
    inv = ent[0][..., 0:1] > ent[1][..., 0:1]        # padding leaves
    ent = [torch.where(inv, big, e) for e in ent]
    rank = torch.cumsum(is_int, dim=1) - is_int.long()
    leaf_vals = order.clamp(max=i_real - 1)
    meta = torch.where(is_int, -(rank + 1),
                       torch.where(is_leaf, leaf_vals[leaf_of] + 1, 0))
    child_ids = torch.where(is_int, ids[safe_int], 1 << 30)
    base = child_ids.min(dim=1).values
    base = torch.where(base == 1 << 30, 0, base)

    # Flagged nodes scattered into wide-id order (padding: empty boxes,
    # zero words), then (nw_pad, slot, word) -> (R, 8, 128).
    dst = torch.where(flags, ids, nw_pad)
    v = torch.zeros((nw_pad + 1, ARITY, ARITY), dtype=torch.int32,
                    device=dev)
    v[:, :, 0:6].fill_(int(_BIG.view(np.int32)))
    v[dst, :, 0:3] = ent[0].view(torch.int32)
    v[dst, :, 3:6] = ent[1].view(torch.int32)
    v[dst, :, 6] = meta.to(torch.int32)
    v[dst, 0, 7] = base.to(torch.int32)
    r = nw_pad // NODES_PER_ROW
    records = (v[:nw_pad].reshape(r, NODES_PER_ROW, ARITY, ARITY)
               .permute(0, 2, 1, 3).reshape(r, ARITY, 128).contiguous())
    return records, deepest
