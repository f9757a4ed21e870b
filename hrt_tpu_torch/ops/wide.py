"""Leaf boxes of a leaf-ordered triangle pool (hrt_tpu/ops/wide.py
`_leaf_boxes`), host numpy: the boxes the two-level build's second BVH8
collapse reads, recomputed from the pool as the JAX package does."""
from __future__ import annotations

import numpy as np


def leaf_boxes(tri_v0: np.ndarray, tri_e1: np.ndarray, tri_e2: np.ndarray,
               leaf_size: int):
    """Per-leaf AABBs (NL, 3) over K-blocks of the pool; degenerate
    (padding) triangles give empty boxes (3e38 / -3e38)."""
    v0 = np.asarray(tri_v0, np.float32)
    e1 = np.asarray(tri_e1, np.float32)
    e2 = np.asarray(tri_e2, np.float32)
    v1 = v0 + e1
    v2 = v0 + e2
    degen = ((e1 ** 2).sum(-1) + (e2 ** 2).sum(-1)) <= 0.0
    big = np.float32(3e38)
    tmin = np.where(degen[:, None], big, np.minimum(v0, np.minimum(v1, v2)))
    tmax = np.where(degen[:, None], -big,
                    np.maximum(v0, np.maximum(v1, v2)))
    nl = v0.shape[0] // leaf_size
    return (tmin.reshape(nl, leaf_size, 3).min(axis=1),
            tmax.reshape(nl, leaf_size, 3).max(axis=1))
