"""Acceleration structure: the SAH build and its BVH8 record table, plus
the Karras radix tree the TLAS is built from (the subset of
hrt_tpu/ops/lbvh.py that the direct-lighting and instanced frames use).

The binary tree comes from the shared native SAH builder; it is
collapsed on the host into the BVH8 records (ops/wide8.py) and the
leaf-ordered triangle pool is reordered to match.  The single-level
Accel keeps only the records and the pool: the BVH8 walk
(ops/traversal_wide8.py) reads nothing else.  The two-level build
(ops/tlas.py) also takes the binary tree, renumbered to the reordered
pool, from `sah_wide8_host`.

`karras_hierarchy` and `refit` are host numpy, bit for bit as the JAX
functions, for the TLAS over instance boxes; the triangle LBVH
(`build_bvh`) is not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import native
from ..models.scene import SceneData
from . import traversal_wide8, wide8

# Column where the material row starts inside Accel.attr.
ATTR_MAT = 16
# Refit sweeps, as the JAX package: the radix tree's depth bound (30
# Morton bits + the index tiebreak).
_REFIT_DEPTH = 64


@dataclasses.dataclass(frozen=True)
class Accel:
    """BVH8 records + the leaf-ordered triangle pool they index.

    tri_v0/e1/e2 (T, 3) and tri_perm (T,) (pool slot -> original
    triangle id) are the JAX Accel's tree fields after the wide8 leaf
    reorder; `attr` (T, 16 + MAT_W) is the pre-sorted hit-attribute
    table (nrm0|nrm1|nrm2|uv0|uv1|uv2|mat_id|material row); `w8` the
    (R, 8, 128) int32 record table.  `tris` (T, 12) float32 is the pool
    as v0|e1|e2|pad rows for the BVH8 walk, `w8_depth` the wide tree's
    depth (root = 0), which sizes the walk's per-ray stack."""

    tri_v0: torch.Tensor
    tri_e1: torch.Tensor
    tri_e2: torch.Tensor
    tri_perm: torch.Tensor
    attr: torch.Tensor
    w8: torch.Tensor
    tris: torch.Tensor
    leaf_size: int
    w8_depth: int


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


def make_accel(tri_v0, tri_e1, tri_e2, tri_perm, attr, w8,
               leaf_size: int) -> Accel:
    """Assemble an Accel from the pool tensors and the record table
    (all on one device), deriving the walk's triangle table and stack
    depth.  Raises ValueError if the wide tree is too deep for the
    walk's per-ray stack."""
    depth = wide8.record_depth(w8.cpu().numpy())
    if depth + 1 > traversal_wide8.MAX_STACK:
        raise ValueError(f"wide tree depth {depth} exceeds the BVH8 "
                         f"walk's stack ({traversal_wide8.MAX_STACK} "
                         "levels)")
    return Accel(tri_v0=tri_v0, tri_e1=tri_e1, tri_e2=tri_e2,
                 tri_perm=tri_perm, attr=attr, w8=w8.contiguous(),
                 tris=tri_table(tri_v0, tri_e1, tri_e2),
                 leaf_size=leaf_size, w8_depth=depth)


def _apply_leaf_reorder(pool: dict, old_of_new: np.ndarray,
                        leaf_size: int) -> dict:
    """Permute the pool's K-blocks: new block b holds old block
    old_of_new[b]."""
    def blk(a):
        nl = a.shape[0] // leaf_size
        return a.reshape(nl, leaf_size, *a.shape[1:])[old_of_new] \
            .reshape(a.shape)

    return {k: blk(v) for k, v in pool.items()}


def attach_wide8(tree: dict, pool: dict, leaf_min: np.ndarray,
                 leaf_max: np.ndarray, leaf_size: int):
    """Collapse the binary SAH tree into BVH8 records and reorder the
    pool to match.  Returns (records, reordered pool, tree with its leaf
    children renumbered to the reordered pool)."""
    records, old_of_new = wide8.build_wide8(
        tree["child_l"], tree["child_r"], tree["bmin_l"], tree["bmax_l"],
        tree["bmin_r"], tree["bmax_r"], leaf_min, leaf_max, leaf_size)
    new_pos = np.empty_like(old_of_new)
    new_pos[old_of_new] = np.arange(old_of_new.shape[0])

    def remap(c):
        leaf = np.clip(-(c + 1), 0, new_pos.shape[0] - 1)
        return np.where(c < 0, -(new_pos[leaf] + 1), c).astype(c.dtype)

    tree2 = dict(tree, child_l=remap(tree["child_l"]),
                 child_r=remap(tree["child_r"]))
    return records, _apply_leaf_reorder(pool, old_of_new, leaf_size), tree2


def sah_wide8_host(v0, e1, e2, valid, leaf_size: int):
    """Binned-SAH build (native/sah_bvh.cpp) + BVH8 collapse of one
    triangle soup on the host.  Returns (records, pool, tree): the pool
    (tri_v0, tri_e1, tri_e2, tri_perm; padded to a multiple of 128
    slots, as the JAX build does) in the records' leaf order, and the
    binary tree with its leaf ids renumbered to that order."""
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
    return attach_wide8(res, pool, lmin, lmax, leaf_size)


def build_bvh_sah(scene: SceneData, leaf_size: int = 16,
                  device=None) -> Accel:
    """Binned-SAH build + BVH8 collapse on the host, uploaded to
    `device` (default: the scene's device)."""
    device = scene.tri_v0.device if device is None else device
    valid = scene.tri_valid.cpu().numpy() > 0.5
    records, pool, _ = sah_wide8_host(
        scene.tri_v0.cpu().numpy(), scene.tri_e1.cpu().numpy(),
        scene.tri_e2.cpu().numpy(), valid, leaf_size)
    dev = {k: torch.as_tensor(v, device=device) for k, v in pool.items()}
    attr = hit_attr_table(scene, dev["tri_perm"].to(scene.tri_v0.device))
    return make_accel(dev["tri_v0"], dev["tri_e1"], dev["tri_e2"],
                      dev["tri_perm"], attr.to(device),
                      torch.as_tensor(records, device=device), leaf_size)


# ---------------------------------------------------------------------------
# Karras radix tree + refit (host numpy), for the TLAS over instances.
# ---------------------------------------------------------------------------

def _clz32(x: np.ndarray) -> np.ndarray:
    """Leading zeros of uint32 values (32 for 0)."""
    _, e = np.frexp(np.asarray(x, np.uint32).astype(np.float64))
    return (32 - e).astype(np.int64)


def _delta_fn(keys: np.ndarray):
    """delta(i, j): common-prefix length of augmented keys, -1 out of
    range (Karras 2012 sec. 3; index-XOR tiebreak for duplicates)."""
    n = keys.shape[0]

    def delta(i, j):
        valid = (j >= 0) & (j <= n - 1)
        j_safe = np.clip(j, 0, n - 1)
        x = keys[i] ^ keys[j_safe]
        d = np.where(x == 0, 32 + _clz32((i ^ j_safe).astype(np.uint32)),
                     _clz32(x))
        return np.where(valid, d, -1)

    return delta


def karras_hierarchy(keys: np.ndarray):
    """The radix tree over sorted uint32 keys: (child_l, child_r), each
    (n-1,) int32 with leaves encoded as -(leaf + 1)."""
    keys = np.asarray(keys, np.uint32)
    n = keys.shape[0]
    delta = _delta_fn(keys)
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


def refit(child_l, child_r, leaf_min, leaf_max):
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
