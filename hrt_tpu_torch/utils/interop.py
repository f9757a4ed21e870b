"""Carry scene tables and acceleration structures over from numpy.

For a renderer the "weights" are the scene tables and the acceleration
structure.  These take dicts of numpy arrays — as a caller gets them
with `{k: np.asarray(v) for k, v in obj._asdict().items()}` from the JAX
package's SceneData, from its Accel's tree fields plus `attr` and `w8`,
or from the fields of its TwoLevelFlat — so one structure can be fed to
both packages.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.scene import SceneData
from ..ops import tlas, wide8
from ..ops.lbvh import Accel, make_accel, tri_table


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


def two_level_from_numpy(d: dict, device) -> tlas.TwoLevelFlat:
    """TwoLevelFlat on `device` from the JAX TwoLevelFlat's arrays:
    w8_nodes, w8_root, w8_tlas_nw, tris ((TR, 16, 128) sublane rows,
    converted to the port's (T, 12) table), attr, inst_mat, inst_mesh,
    normal_mat, world_from_obj, obj_from_world, root_bmin, root_bmax and
    leaf_size.  The walk's depths and stack bound are read back from the
    records; a table K4 cannot walk raises ValueError."""
    rec = np.asarray(d["w8_nodes"], np.int32)
    tlas_nw = int(d["w8_tlas_nw"])
    jt = np.asarray(d["tris"], np.float32)                  # (TR, 16, 128)
    rows = jt.transpose(0, 2, 1).reshape(-1, 16)            # (T, 16)
    dev = lambda a: torch.as_tensor(np.array(a), device=device)
    depth = wide8.node_depths(rec)
    tlas_depth = int(depth[:tlas_nw].max())
    blas_depth = int(depth[tlas_nw:].max())
    tlas.check_depths(tlas_depth, blas_depth)
    root_bmin = np.asarray(d["root_bmin"], np.float32)
    root_bmax = np.asarray(d["root_bmax"], np.float32)
    return tlas.TwoLevelFlat(
        w8_nodes=dev(rec), w8_root=dev(np.asarray(d["w8_root"], np.int32)),
        w8_tlas_nw=tlas_nw,
        tris=tri_table(dev(rows[:, 0:3]), dev(rows[:, 3:6]),
                       dev(rows[:, 6:9])),
        **{k: dev(d[k]) for k in ("attr", "inst_mat", "inst_mesh",
                                  "normal_mat", "world_from_obj",
                                  "obj_from_world")},
        root_bmin=dev(root_bmin), root_bmax=dev(root_bmax),
        leaf_size=int(d["leaf_size"]), tlas_depth=tlas_depth,
        blas_depth=blas_depth, root_box_host=(root_bmin, root_bmax))
