"""Binary -> BVH8 collapse on the host (numpy), emitting the JAX
package's (R, 8, 128) int32 record table bit for bit
(hrt_tpu/ops/wide8.py `_flags_and_ids` + `_assemble` + `build_wide8`,
with the collapse primitive of hrt_tpu/ops/wide.py `_cut`).

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
"""
from __future__ import annotations

import numpy as np

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
                leaf_min, leaf_max, leaf_size: int):
    """Collapse a binary tree (leaves encoded -(leaf + 1)) into BVH8
    records.  leaf_min/leaf_max are the (NL_pool, 3) leaf boxes of the
    pool (padding leaves inverted).  Returns (records (R, 8, 128) int32,
    old_of_new (NL_pool,) int64: new pool block b holds old block
    old_of_new[b]).  Raises ValueError past MAX_WIDE_NODES."""
    ni = child_l.shape[0]
    nl_pool = leaf_min.shape[0]
    if nl_pool * leaf_size * 256 >= 2 ** 31:
        raise ValueError("leaf pool too large for leaf_base << 8")
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
        raise ValueError(f"{nw} wide nodes exceed MAX_WIDE_NODES "
                         f"({MAX_WIDE_NODES}); the BVH8 table cannot "
                         "index them")
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
    tri_start = new_pos[leaf_of] * leaf_size
    meta = np.where(is_int, -(rank + 1),
                    np.where(is_leaf, tri_start + 1, 0))
    child_ids = np.where(is_int, id_of[safe_int], 2 ** 30)
    base = child_ids.min(axis=1)
    base = np.where(base == 2 ** 30, 0, base)
    lbase = np.where(is_leaf[:, 0], tri_start[:, 0], 0) * 256

    nw_pad = -(-nw // NODES_PER_ROW) * NODES_PER_ROW
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


def record_depth(records: np.ndarray) -> int:
    """Depth of the wide tree stored in a record table (root = 0), read
    back from the records themselves so imported tables are sized the
    same way as built ones."""
    r = records.shape[0]
    v = records.reshape(r, ARITY, NODES_PER_ROW, ARITY) \
        .transpose(0, 2, 1, 3).reshape(r * NODES_PER_ROW, ARITY, ARITY)
    n_int = (v[:, :, 6] < 0).sum(axis=1)
    base = v[:, 0, 7]
    depth = np.zeros(v.shape[0], np.int64)
    # BFS ids: a parent's id is always below its children's.
    for q in range(v.shape[0]):
        if n_int[q]:
            depth[base[q]:base[q] + n_int[q]] = depth[q] + 1
    return int(depth.max())
