"""Acceleration structure: the SAH build and its BVH8 record table
(the subset of hrt_tpu/ops/lbvh.py that the direct-lighting frame uses).

The binary tree comes from the shared native SAH builder; it is
collapsed on the host into the BVH8 records (ops/wide8.py) and the
leaf-ordered triangle pool is reordered to match.  The binary tree is
not kept: the BVH8 walk (ops/traversal_wide8.py) reads only the records
and the pool.
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
    pad = torch.zeros_like(tri_v0)
    tris = torch.cat([tri_v0, tri_e1, tri_e2, pad], dim=1).contiguous()
    return Accel(tri_v0=tri_v0, tri_e1=tri_e1, tri_e2=tri_e2,
                 tri_perm=tri_perm, attr=attr, w8=w8.contiguous(),
                 tris=tris, leaf_size=leaf_size, w8_depth=depth)


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
    pool to match.  Returns (records, reordered pool)."""
    records, old_of_new = wide8.build_wide8(
        tree["child_l"], tree["child_r"], tree["bmin_l"], tree["bmax_l"],
        tree["bmin_r"], tree["bmax_r"], leaf_min, leaf_max, leaf_size)
    return records, _apply_leaf_reorder(pool, old_of_new, leaf_size)


def build_bvh_sah(scene: SceneData, leaf_size: int = 16,
                  device=None) -> Accel:
    """Binned-SAH build (native/sah_bvh.cpp) + BVH8 collapse on the
    host, uploaded to `device` (default: the scene's device)."""
    device = scene.tri_v0.device if device is None else device
    v0 = scene.tri_v0.cpu().numpy()
    e1 = scene.tri_e1.cpu().numpy()
    e2 = scene.tri_e2.cpu().numpy()
    valid = scene.tri_valid.cpu().numpy() > 0.5
    res = native.sah_build(v0, e1, e2, valid.astype(np.int32), leaf_size)

    nl = res["leaf_tri"].shape[0]
    # Pad the pool to a multiple of 128 slots, as the JAX build does;
    # padding slots belong to no leaf.
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

    records, pool = attach_wide8(res, pool, lmin, lmax, leaf_size)
    dev = {k: torch.as_tensor(v, device=device) for k, v in pool.items()}
    attr = hit_attr_table(scene, dev["tri_perm"].to(scene.tri_v0.device))
    return make_accel(dev["tri_v0"], dev["tri_e1"], dev["tri_e2"],
                      dev["tri_perm"], attr.to(device),
                      torch.as_tensor(records, device=device), leaf_size)
