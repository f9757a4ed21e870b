"""Acceleration structures: the binned-SAH build with its BVH8 record
table, the on-device LBVH, and the binary skip-link table every accel
carries (hrt_tpu/ops/lbvh.py).

The SAH tree comes from the shared native builder; it is collapsed on
the host into the BVH8 records (ops/wide8.py) and the leaf-ordered
triangle pool is reordered to match.  Past MAX_WIDE_NODES the collapse
gives up, as in the JAX package, and the accel keeps the un-reordered
tree's skip-link table only.

The LBVH (`build_bvh`: Morton order, Karras radix tree, refit) runs in
torch on the scene's device and attaches no BVH8 table.  Its tensors
come out bit-equal to the JAX package's wherever they are built: the
build is integer work, min/max and a few separate float32 operations
(eager torch runs one kernel per op, so nothing contracts into an FMA).

`flatten_bvh` turns any binary tree into the JAX FlatBVH `nodes` table
(DFS preorder with skip links), which the skip-link walk K3
(ops/traversal_skip.py) reads and the two-level build (ops/tlas.py)
concatenates for K5.  `karras_hierarchy`, `refit` and `flatten_bvh` are
the JAX functions' algorithms; where JAX runs 64 fixed sweeps, these
stop at the fixed point (checked every few sweeps, so the host syncs
rarely), which gives the same result.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import native
from ..models.scene import SceneData
from . import morton, traversal_skip, traversal_wide8, wide8

# Column where the material row starts inside Accel.attr.
ATTR_MAT = 16
# Sweep bound, as the JAX package: the radix tree's depth bound (30
# Morton bits + the index tiebreak).
_REFIT_DEPTH = 64
# Sweeps between fixed-point checks (each check syncs with the device).
_CHECK_EVERY = 8
_BIG = 3e38


@dataclasses.dataclass(frozen=True)
class Accel:
    """A single-level accel: the leaf-ordered triangle pool and the
    tables that index it.

    tri_v0/e1/e2 (T, 3) and tri_perm (T,) (pool slot -> original
    triangle id) are the JAX Accel's tree fields; `attr` (T, 16 + MAT_W)
    is the pre-sorted hit-attribute table (nrm0|nrm1|nrm2|uv0|uv1|uv2|
    mat_id|material row); `tris` (T, 12) float32 the pool as v0|e1|e2|pad
    rows for the walks.  `nodes` (Mp/128, 8, 128) float32 is the JAX
    FlatBVH skip-link table (rows 6-7 hold int32 bits: leaf code, skip)
    over `m_real` nodes, and `skip_rec` (m_real, 8) int32 the same nodes
    as 32-byte records, the layout K3 reads (traversal_skip.skip_records).
    `w8` is the (R, 8, 128) int32 BVH8 record table
    (None for an LBVH or a tree past MAX_WIDE_NODES), `w8_rec` (R * 16,
    64) int32 the same nodes as 256-byte records, the layout K1 reads
    (wide8.node_records), and `w8_depth` the tree's depth (root = 0),
    which sizes the BVH8 walk's stacks."""

    tri_v0: torch.Tensor
    tri_e1: torch.Tensor
    tri_e2: torch.Tensor
    tri_perm: torch.Tensor
    attr: torch.Tensor
    tris: torch.Tensor
    nodes: torch.Tensor
    m_real: int
    skip_rec: torch.Tensor
    leaf_size: int
    w8: torch.Tensor | None = None
    w8_rec: torch.Tensor | None = None
    w8_depth: int = 0


def hit_attr_table(scene: SceneData, tri_perm: torch.Tensor) -> torch.Tensor:
    """The sorted hit-attribute table: one row per pool slot."""
    base = torch.cat(
        [scene.nrm0, scene.nrm1, scene.nrm2,
         scene.uv0, scene.uv1, scene.uv2,
         scene.tri_mat[:, None].to(torch.float32)], dim=1)  # (T, 16)
    perm = tri_perm.long()
    rows = base[perm]
    mat = scene.materials[scene.tri_mat[perm].long()]
    return torch.cat([rows, mat], dim=1)


def tri_table(tri_v0, tri_e1, tri_e2) -> torch.Tensor:
    """The walks' (T, 12) float32 v0|e1|e2|pad triangle rows."""
    pad = torch.zeros_like(tri_v0)
    return torch.cat([tri_v0, tri_e1, tri_e2, pad], dim=1).contiguous()


def make_accel(tri_v0, tri_e1, tri_e2, tri_perm, attr, nodes, m_real: int,
               leaf_size: int, w8=None) -> Accel:
    """Assemble an Accel from the pool tensors and the tables (all on
    one device), deriving the walks' triangle table, K3's and K1's node
    records and the BVH8 stack depth.  Raises ValueError if the wide
    tree is too deep for the BVH8 walk's stack."""
    depth, w8_rec = 0, None
    if w8 is not None:
        depth = wide8.record_depth(w8.cpu().numpy())
        need = traversal_wide8.stack_entries(depth)
        if need > traversal_wide8.MAX_STACK:
            raise ValueError(f"wide tree depth {depth} needs {need} stack "
                             f"entries, past the BVH8 walk's stack "
                             f"({traversal_wide8.MAX_STACK})")
        w8 = w8.contiguous()
        w8_rec = wide8.node_records(w8)
    nodes = nodes.contiguous()
    return Accel(tri_v0=tri_v0, tri_e1=tri_e1, tri_e2=tri_e2,
                 tri_perm=tri_perm, attr=attr,
                 tris=tri_table(tri_v0, tri_e1, tri_e2),
                 nodes=nodes, m_real=int(m_real),
                 skip_rec=traversal_skip.skip_records(nodes, int(m_real)),
                 leaf_size=leaf_size, w8=w8, w8_rec=w8_rec, w8_depth=depth)


# ---------------------------------------------------------------------------
# Binned-SAH build + BVH8 collapse (host), and its skip-link table.
# ---------------------------------------------------------------------------

def _apply_leaf_reorder(pool: dict, old_of_new: np.ndarray,
                        leaf_size: int) -> dict:
    """Permute the pool's K-blocks: new block b holds old block
    old_of_new[b]."""
    def blk(a):
        nl = a.shape[0] // leaf_size
        return a.reshape(nl, leaf_size, *a.shape[1:])[old_of_new] \
            .reshape(a.shape)

    return {k: blk(v) for k, v in pool.items()}


def attach_wide8(tree: dict, pool: dict, leaf_size: int):
    """Collapse the binary SAH tree (with its `leaf_min`/`leaf_max`
    boxes) into BVH8 records and reorder the pool, the tree's leaf
    children and its leaf boxes to match.  Past MAX_WIDE_NODES returns
    (None, pool, tree) unchanged, as the JAX package does."""
    out = wide8.build_wide8(
        tree["child_l"], tree["child_r"], tree["bmin_l"], tree["bmax_l"],
        tree["bmin_r"], tree["bmax_r"], tree["leaf_min"], tree["leaf_max"],
        leaf_size)
    if out is None:
        return None, pool, tree
    records, old_of_new = out
    new_pos = np.empty_like(old_of_new)
    new_pos[old_of_new] = np.arange(old_of_new.shape[0])

    def remap(c):
        leaf = np.clip(-(c + 1), 0, new_pos.shape[0] - 1)
        return np.where(c < 0, -(new_pos[leaf] + 1), c).astype(c.dtype)

    tree2 = dict(tree, child_l=remap(tree["child_l"]),
                 child_r=remap(tree["child_r"]),
                 leaf_min=tree["leaf_min"][old_of_new],
                 leaf_max=tree["leaf_max"][old_of_new])
    return records, _apply_leaf_reorder(pool, old_of_new, leaf_size), tree2


def sah_wide8_host(v0, e1, e2, valid, leaf_size: int):
    """Binned-SAH build (native/sah_bvh.cpp) + BVH8 collapse of one
    triangle soup on the host.  Returns (records or None past
    MAX_WIDE_NODES, pool, tree): the pool (tri_v0, tri_e1, tri_e2,
    tri_perm; padded to a multiple of 128 slots, as the JAX build does)
    in the records' leaf order, and the binary tree (child_l/r, child
    boxes, and the builder's leaf boxes `leaf_min`/`leaf_max`, padding
    leaves inverted) with its leaf ids renumbered to that order."""
    res = native.sah_build(v0, e1, e2, valid.astype(np.int32), leaf_size)
    nl = res["leaf_tri"].shape[0]
    # Padding slots belong to no leaf.
    per_row = 128 // leaf_size if leaf_size <= 128 else 1
    nl_pad = -(-nl // per_row) * per_row
    slots = np.full((nl_pad * leaf_size,), -1, np.int64)
    slots[: nl * leaf_size] = res["leaf_tri"].reshape(-1)
    empty = slots < 0
    safe = np.where(empty, 0, slots)
    pool = {
        "tri_v0": v0[safe],
        "tri_e1": np.where(empty[:, None], 0.0, e1[safe]).astype(np.float32),
        "tri_e2": np.where(empty[:, None], 0.0, e2[safe]).astype(np.float32),
        "tri_perm": safe.astype(np.int32),
    }
    lmin = np.full((nl_pad, 3), np.float32(3e38), np.float32)
    lmax = np.full((nl_pad, 3), np.float32(-3e38), np.float32)
    lmin[:nl] = res["leaf_min"]
    lmax[:nl] = res["leaf_max"]
    return attach_wide8(dict(res, leaf_min=lmin, leaf_max=lmax), pool,
                        leaf_size)


def build_bvh_sah(scene: SceneData, leaf_size: int = 16, device=None,
                  tri_mask=None) -> Accel:
    """Binned-SAH build + BVH8 collapse on the host, uploaded to
    `device` (default: the scene's device).  tri_mask (T,) bool
    restricts the build to a subset, as build_bvh's does.  Past
    MAX_WIDE_NODES the accel has no BVH8 table and its walks take K3."""
    device = scene.tri_v0.device if device is None else device
    valid = scene.tri_valid.cpu().numpy() > 0.5
    if tri_mask is not None:
        valid = valid & tri_mask.cpu().numpy()
    records, pool, tree = sah_wide8_host(
        scene.tri_v0.cpu().numpy(), scene.tri_e1.cpu().numpy(),
        scene.tri_e2.cpu().numpy(), valid, leaf_size)
    nodes, m_real = flatten_tree(tree, leaf_size)
    dev = {k: torch.as_tensor(v, device=device) for k, v in pool.items()}
    attr = hit_attr_table(scene, dev["tri_perm"].to(scene.tri_v0.device))
    return make_accel(dev["tri_v0"], dev["tri_e1"], dev["tri_e2"],
                      dev["tri_perm"], attr.to(device), nodes.to(device),
                      m_real, leaf_size,
                      w8=(None if records is None
                          else torch.as_tensor(records, device=device)))


# ---------------------------------------------------------------------------
# Karras radix tree, refit and skip-link flatten (torch, any device).
# ---------------------------------------------------------------------------

def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of uint32 values held in int64 (32 for 0): float64
    holds them exactly, and frexp's exponent is their bit length."""
    _, e = torch.frexp(x.to(torch.float64))
    return 32 - e.to(torch.int64)


def _delta_fn(keys: torch.Tensor):
    """delta(i, j): common-prefix length of augmented keys, -1 out of
    range (Karras 2012 sec. 3; index-XOR tiebreak for duplicates)."""
    n = keys.shape[0]

    def delta(i, j):
        valid = (j >= 0) & (j <= n - 1)
        j_safe = j.clamp(0, n - 1)
        x = keys[i] ^ keys[j_safe]
        d = torch.where(x == 0, 32 + _clz32(i ^ j_safe), _clz32(x))
        return torch.where(valid, d, -1)

    return delta


def karras_hierarchy(keys: torch.Tensor):
    """The radix tree over sorted uint32 keys (held in int64): (child_l,
    child_r), each (n-1,) int32 with leaves encoded as -(leaf + 1), on
    the keys' device."""
    keys = keys.to(torch.int64)
    n = keys.shape[0]
    delta = _delta_fn(keys)
    i = torch.arange(n - 1, dtype=torch.int64, device=keys.device)

    d = torch.sign(delta(i, i + 1) - delta(i, i - 1))
    d = torch.where(d == 0, 1, d)
    delta_min = delta(i, i - d)

    # Range length l: largest l with delta(i, i + l*d) > delta_min.  The
    # JAX search starts at 1 << 30; every step with p >= n lands out of
    # range and changes nothing, so the search starts below n.
    top = 1 << max(n - 1, 1).bit_length() - 1
    l = torch.zeros_like(i)
    p = top
    while p >= 1:
        cand = l + p
        l = torch.where(delta(i, i + cand * d) > delta_min, cand, l)
        p >>= 1
    j = i + l * d
    delta_node = delta(i, j)

    # Split position s: largest s with delta(i, i + s*d) > delta_node.
    s = torch.zeros_like(i)
    p = top
    while p >= 1:
        cand = s + p
        ok = (cand < l) & (delta(i, i + cand * d) > delta_node)
        s = torch.where(ok, cand, s)
        p >>= 1
    gamma = i + s * d + torch.clamp(d, max=0)

    lo = torch.minimum(i, j)
    hi = torch.maximum(i, j)
    left = torch.where(lo == gamma, -(gamma + 1), gamma)
    right = torch.where(hi == gamma + 1, -(gamma + 2), gamma + 1)
    return left.to(torch.int32), right.to(torch.int32)


def _sweep_to_fixed_point(step, state):
    """Apply `step` until the state stops changing (at most _REFIT_DEPTH
    times, JAX's fixed sweep count), comparing every _CHECK_EVERY
    sweeps.  A sweep that changes nothing is a fixed point, so stopping
    there gives what all _REFIT_DEPTH sweeps give."""
    for k in range(_REFIT_DEPTH):
        new = step(state)
        if (k + 1) % _CHECK_EVERY == 0 and all(
                torch.equal(a, b) for a, b in zip(new, state)):
            return new
        state = new
    return state


def refit(child_l, child_r, leaf_min, leaf_max):
    """Bottom-up AABB propagation.  Returns per-node child boxes
    (bmin_l, bmax_l, bmin_r, bmax_r), float32, on the inputs' device."""
    ni = child_l.shape[0]
    nl_pool = leaf_min.shape[0]
    dev = child_l.device

    def child_box(c):
        c = c.long()
        is_leaf = (c < 0)[:, None]
        lidx = (-(c + 1)).clamp(0, nl_pool - 1)
        nidx = c.clamp(0, ni - 1)
        lmin, lmax = leaf_min[lidx], leaf_max[lidx]
        return lambda agg_min, agg_max: (
            torch.where(is_leaf, lmin, agg_min[nidx]),
            torch.where(is_leaf, lmax, agg_max[nidx]))

    box_l, box_r = child_box(child_l), child_box(child_r)

    def sweep(agg):
        lmin, lmax = box_l(*agg)
        rmin, rmax = box_r(*agg)
        return torch.minimum(lmin, rmin), torch.maximum(lmax, rmax)

    agg = _sweep_to_fixed_point(sweep, (
        torch.full((ni, 3), float("inf"), dtype=torch.float32, device=dev),
        torch.full((ni, 3), float("-inf"), dtype=torch.float32, device=dev)))
    bmin_l, bmax_l = box_l(*agg)
    bmin_r, bmax_r = box_r(*agg)
    return bmin_l, bmax_l, bmin_r, bmax_r


def flatten_bvh(child_l, child_r, bmin_l, bmax_l, bmin_r, bmax_r,
                leaf_min, leaf_max, leaf_size: int) -> torch.Tensor:
    """The JAX FlatBVH `nodes` table of a binary tree, bit for bit: DFS
    preorder (left first) with skip links, (Mp/128, 8, 128) float32 on
    the inputs' device.  Node i lives at [i // 128, :, i % 128]: rows
    0-5 its box, row 6 its leaf code as int32 bits (0 internal, else
    leaf * leaf_size + 1), row 7 its skip index as int32 bits.  Only the
    first Ni + 1 leaf boxes are read (SAH leaf arrays are padded)."""
    dev = child_l.device
    cl, cr = child_l.long(), child_r.long()
    ni = cl.shape[0]
    nl = ni + 1

    def subtree(sz, c):
        return torch.where(c < 0, 1, sz[c.clamp(0, ni - 1)])

    (sz,) = _sweep_to_fixed_point(
        lambda st: (1 + subtree(st[0], cl) + subtree(st[0], cr),),
        (torch.ones(ni, dtype=torch.int64, device=dev),))

    # Top-down preorder positions of internal nodes and leaves.
    fsize = subtree(sz, cl)
    l_int, r_int = cl >= 0, cr >= 0
    l_node, r_node = cl[l_int], cr[r_int]
    l_leaf, r_leaf = -(cl[~l_int] + 1), -(cr[~r_int] + 1)

    def pre_sweep(st):
        pre_i, pre_l = st
        fpos = pre_i + 1
        spos = pre_i + 1 + fsize
        new_i, new_l = pre_i.clone(), pre_l.clone()
        new_i[l_node] = fpos[l_int]
        new_i[r_node] = spos[r_int]
        new_l[l_leaf] = fpos[~l_int]
        new_l[r_leaf] = spos[~r_int]
        return new_i, new_l

    pre_i, pre_l = _sweep_to_fixed_point(pre_sweep, (
        torch.zeros(ni, dtype=torch.int64, device=dev),
        torch.zeros(nl, dtype=torch.int64, device=dev)))

    m = ni + nl
    mp = -(-m // 128) * 128
    own_min = torch.minimum(bmin_l, bmin_r)
    own_max = torch.maximum(bmax_l, bmax_r)
    rows = []
    for own, leaf, fill in ((own_min, leaf_min, _BIG),
                            (own_max, leaf_max, -_BIG)):
        for axis in range(3):
            arr = torch.full((mp,), fill, dtype=torch.float32, device=dev)
            arr[pre_i] = own[:, axis]
            arr[pre_l] = leaf[:nl, axis]
            rows.append(arr.view(torch.int32))
    leaf_code = torch.zeros(mp, dtype=torch.int64, device=dev)
    leaf_code[pre_l] = torch.arange(nl, device=dev) * leaf_size + 1
    skip = torch.full((mp,), m, dtype=torch.int64, device=dev)
    skip[pre_i] = pre_i + sz
    skip[pre_l] = pre_l + 1
    rows += [leaf_code.to(torch.int32), skip.to(torch.int32)]
    # (8, mp) -> (mp // 128, 8, 128), moved as int32 so no bit changes.
    nodes = torch.stack(rows).reshape(8, mp // 128, 128).permute(1, 0, 2)
    return nodes.contiguous().view(torch.float32)


def lbvh_tree(scene: SceneData, leaf_size: int,
              tri_mask: torch.Tensor | None = None) -> dict:
    """The LBVH's binary tree on the scene's device, bit for bit as the
    JAX package's `build_bvh` tree: Morton order of the triangle
    centroids (a stable sort), K consecutive triangles per leaf, the
    Karras tree over each leaf's first code, refit.  Returns the JAX
    BVH fields (child_l/r, bmin/bmax_l/r, the leaf-ordered pool tri_v0/
    e1/e2 and tri_perm) plus the leaf boxes `leaf_min`/`leaf_max` and
    the sorted codes `codes`.

    tri_mask (T,) bool restricts the build to a subset (the culling
    rebuild, ops/culling.py): masked-out triangles get empty boxes,
    zero edges and the past-the-end key 0xFFFFFFFF, so they are never
    reported."""
    v0, e1, e2 = scene.tri_v0, scene.tri_e1, scene.tri_e2
    valid = scene.tri_valid > 0.5
    if tri_mask is not None:
        valid = valid & tri_mask
    t = v0.shape[0]
    if t % leaf_size or t // leaf_size < 2:
        raise ValueError(f"{t} pool triangles do not make >= 2 leaves of "
                         f"{leaf_size}")

    v1 = v0 + e1
    v2 = v0 + e2
    tmin = torch.minimum(v0, torch.minimum(v1, v2))
    tmax = torch.maximum(v0, torch.maximum(v1, v2))
    centroid = (tmin + tmax) * 0.5
    vmask = valid[:, None]
    scene_min = torch.where(vmask, tmin, _BIG).min(dim=0).values
    scene_max = torch.where(vmask, tmax, -_BIG).max(dim=0).values

    codes = morton.morton_codes_torch(centroid, scene_min, scene_max)
    # Padding and culled triangles sort to the end, in pool order.
    codes = torch.where(valid, codes, 0xFFFFFFFF)
    order = torch.argsort(codes, stable=True)
    codes_sorted = codes[order]

    valid_s = valid[order][:, None]
    v0s = v0[order]
    # Invalid and culled triangles become degenerate (e = 0, no hit).
    e1s = torch.where(valid_s, e1[order], 0.0)
    e2s = torch.where(valid_s, e2[order], 0.0)
    n_leaf = t // leaf_size
    lmin = torch.where(valid_s, tmin[order], _BIG) \
        .reshape(n_leaf, leaf_size, 3).min(dim=1).values
    lmax = torch.where(valid_s, tmax[order], -_BIG) \
        .reshape(n_leaf, leaf_size, 3).max(dim=1).values

    # Cluster key: the first code of each block.
    child_l, child_r = karras_hierarchy(codes_sorted[::leaf_size])
    bmin_l, bmax_l, bmin_r, bmax_r = refit(child_l, child_r, lmin, lmax)
    return dict(child_l=child_l, child_r=child_r, bmin_l=bmin_l,
                bmax_l=bmax_l, bmin_r=bmin_r, bmax_r=bmax_r, tri_v0=v0s,
                tri_e1=e1s, tri_e2=e2s, tri_perm=order.to(torch.int32),
                leaf_min=lmin, leaf_max=lmax, codes=codes_sorted)


def flatten_tree(tree: dict, leaf_size: int):
    """The skip-link table of a tree dict (`lbvh_tree`'s, or a host one
    from `sah_wide8_host`, flattened on the CPU): (nodes, m_real)."""
    t = {k: torch.as_tensor(tree[k]) for k in (
        "child_l", "child_r", "bmin_l", "bmax_l", "bmin_r", "bmax_r",
        "leaf_min", "leaf_max")}
    nodes = flatten_bvh(t["child_l"], t["child_r"], t["bmin_l"],
                        t["bmax_l"], t["bmin_r"], t["bmax_r"],
                        t["leaf_min"], t["leaf_max"], leaf_size)
    return nodes, 2 * t["child_l"].shape[0] + 1


def build_bvh(scene: SceneData, leaf_size: int = 8,
              tri_mask: torch.Tensor | None = None) -> Accel:
    """The LBVH accel (`lbvh_tree` + its skip-link table) on the scene's
    device.  No BVH8 table: its walks take K3."""
    tree = lbvh_tree(scene, leaf_size, tri_mask)
    nodes, m_real = flatten_tree(tree, leaf_size)
    return make_accel(tree["tri_v0"], tree["tri_e1"], tree["tri_e2"],
                      tree["tri_perm"],
                      hit_attr_table(scene, tree["tri_perm"]), nodes,
                      m_real, leaf_size)


# ---------------------------------------------------------------------------
# Host numpy Karras radix tree + refit, for the wide TLAS over instances
# (ops/wide8.build_wide8_tlas): the torch functions above, bit for bit,
# without torch's per-op cost at a few hundred instances.
# ---------------------------------------------------------------------------

def _clz32_host(x: np.ndarray) -> np.ndarray:
    """Leading zeros of uint32 values (32 for 0)."""
    _, e = np.frexp(np.asarray(x, np.uint32).astype(np.float64))
    return (32 - e).astype(np.int64)


def _delta_fn_host(keys: np.ndarray):
    """delta(i, j): common-prefix length of augmented keys, -1 out of
    range (Karras 2012 sec. 3; index-XOR tiebreak for duplicates)."""
    n = keys.shape[0]

    def delta(i, j):
        valid = (j >= 0) & (j <= n - 1)
        j_safe = np.clip(j, 0, n - 1)
        x = keys[i] ^ keys[j_safe]
        d = np.where(x == 0, 32 + _clz32_host((i ^ j_safe).astype(np.uint32)),
                     _clz32_host(x))
        return np.where(valid, d, -1)

    return delta


def karras_hierarchy_host(keys: np.ndarray):
    """The radix tree over sorted uint32 keys: (child_l, child_r), each
    (n-1,) int32 with leaves encoded as -(leaf + 1)."""
    keys = np.asarray(keys, np.uint32)
    n = keys.shape[0]
    delta = _delta_fn_host(keys)
    i = np.arange(n - 1, dtype=np.int64)

    d = np.sign(delta(i, i + 1) - delta(i, i - 1))
    d = np.where(d == 0, 1, d)
    delta_min = delta(i, i - d)

    # Range length l: largest l with delta(i, i + l*d) > delta_min.  The
    # JAX search starts at 1 << 30; every step with p >= n lands out of
    # range and changes nothing, so the search starts below n.
    top = 1 << max(n - 1, 1).bit_length() - 1
    l = np.zeros_like(i)
    p = top
    while p >= 1:
        cand = l + p
        l = np.where(delta(i, i + cand * d) > delta_min, cand, l)
        p >>= 1
    j = i + l * d
    delta_node = delta(i, j)

    # Split position s: largest s with delta(i, i + s*d) > delta_node.
    s = np.zeros_like(i)
    p = top
    while p >= 1:
        cand = s + p
        ok = (cand < l) & (delta(i, i + cand * d) > delta_node)
        s = np.where(ok, cand, s)
        p >>= 1
    gamma = i + s * d + np.minimum(d, 0)

    lo = np.minimum(i, j)
    hi = np.maximum(i, j)
    left = np.where(lo == gamma, -(gamma + 1), gamma)
    right = np.where(hi == gamma + 1, -(gamma + 2), gamma + 1)
    return left.astype(np.int32), right.astype(np.int32)


def refit_host(child_l, child_r, leaf_min, leaf_max):
    """Bottom-up AABB propagation by the JAX package's fixed
    _REFIT_DEPTH sweeps.  Returns per-node child boxes (bmin_l, bmax_l,
    bmin_r, bmax_r), float32."""
    ni = child_l.shape[0]
    leaf_min = np.asarray(leaf_min, np.float32)
    leaf_max = np.asarray(leaf_max, np.float32)

    def child_box(c, agg_min, agg_max):
        is_leaf = (c < 0)[:, None]
        lidx = np.clip(-(c + 1), 0, leaf_min.shape[0] - 1)
        nidx = np.clip(c, 0, ni - 1)
        return (np.where(is_leaf, leaf_min[lidx], agg_min[nidx]),
                np.where(is_leaf, leaf_max[lidx], agg_max[nidx]))

    agg_min = np.full((ni, 3), np.inf, np.float32)
    agg_max = np.full((ni, 3), -np.inf, np.float32)
    for _ in range(_REFIT_DEPTH):
        lmin, lmax = child_box(child_l, agg_min, agg_max)
        rmin, rmax = child_box(child_r, agg_min, agg_max)
        new_min, new_max = np.minimum(lmin, rmin), np.maximum(lmax, rmax)
        # A converged sweep is a fixed point: stopping there gives the
        # boxes all _REFIT_DEPTH sweeps give.
        done = (np.array_equal(new_min, agg_min)
                and np.array_equal(new_max, agg_max))
        agg_min, agg_max = new_min, new_max
        if done:
            break
    bmin_l, bmax_l = child_box(child_l, agg_min, agg_max)
    bmin_r, bmax_r = child_box(child_r, agg_min, agg_max)
    return bmin_l, bmax_l, bmin_r, bmax_r
