"""Carry scene tables and acceleration structures over from numpy.

For a renderer the "weights" are the scene tables and the acceleration
structure.  These take dicts of numpy arrays — as a caller gets them
with `{k: np.asarray(v) for k, v in obj._asdict().items()}` from the JAX
package's SceneData, or from its Accel's tree fields plus `attr` and
`w8` — so one structure can be fed to both packages.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.scene import SceneData
from ..ops.lbvh import Accel, make_accel


def scene_from_numpy(d: dict, device) -> SceneData:
    """SceneData on `device` from numpy arrays keyed by field name.
    Textures and light trees belong to later slices: a non-empty
    texture table raises NotImplementedError, a light tree is
    dropped."""
    tex = d.get("textures")
    if tex is not None and np.asarray(tex).shape[0] > 0:
        raise NotImplementedError("textured scenes are not ported yet")
    fields = [f for f in SceneData._fields
              if f not in ("textures", "light_tree")]
    return SceneData(**{f: torch.as_tensor(np.array(d[f]), device=device)
                        for f in fields})


def accel_from_numpy(d: dict, leaf_size: int, device) -> Accel:
    """Accel on `device` from the pool arrays (tri_v0, tri_e1, tri_e2,
    tri_perm), the attribute table `attr` and the BVH8 records `w8`."""
    t = {k: torch.as_tensor(np.array(d[k]), device=device)
         for k in ("tri_v0", "tri_e1", "tri_e2", "tri_perm", "attr", "w8")}
    return make_accel(t["tri_v0"], t["tri_e1"], t["tri_e2"], t["tri_perm"],
                      t["attr"], t["w8"], leaf_size)
