"""Carry scene tables and acceleration structures over from numpy.

For a renderer the "weights" are the scene tables and the acceleration
structure.  These take dicts of numpy arrays — as a caller gets them
with `{k: np.asarray(v) for k, v in obj._asdict().items()}` from the JAX
package's SceneData (its light tree's fields likewise, each level a
list), from its Accel's tree fields plus `attr`, `flat.nodes` and `w8`,
or from the fields of its TwoLevelFlat — so one structure can be fed to
both packages.  The learned upscalers' weights
come over the same way (`upscaler_from_numpy`).
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.scene import SceneData
from ..models.upscaler import TemporalUpscalerNet, UpscalerNet
from ..ops import tlas, traversal_skip, wide8
from ..ops.lightbvh import LightTree
from ..ops.lbvh import Accel, make_accel, tri_table


def scene_from_numpy(d: dict, device) -> SceneData:
    """SceneData on `device` from numpy arrays keyed by field name: the
    texture table `textures` (None or missing: none) and the light tree
    `light_tree` (None or missing: none; a dict of its fields, see
    light_tree_from_numpy, or a LightTree) with the rest."""
    dev = lambda a: torch.as_tensor(np.array(a), device=device)
    tex = d.get("textures")
    tree = d.get("light_tree")
    if isinstance(tree, dict):
        tree = light_tree_from_numpy(tree, device)
    fields = [f for f in SceneData._fields
              if f not in ("textures", "light_tree")]
    return SceneData(**{f: dev(d[f]) for f in fields},
                     textures=None if tex is None else dev(tex),
                     light_tree=tree)


def light_tree_from_numpy(d: dict, device) -> LightTree:
    """The light tree on `device` from its fields as numpy: bmin, bmax,
    energy, energy_dir and pair as lists of per-level arrays, and
    perm."""
    dev = lambda a: torch.as_tensor(np.array(a), device=device)
    return LightTree(**{k: tuple(dev(a) for a in d[k])
                        for k in ("bmin", "bmax", "energy", "energy_dir",
                                  "pair")},
                     perm=dev(np.asarray(d["perm"], np.int32)))


def accel_from_numpy(d: dict, leaf_size: int, device) -> Accel:
    """Accel on `device` from the pool arrays (tri_v0, tri_e1, tri_e2,
    tri_perm), the attribute table `attr`, the skip-link table `nodes`
    (the JAX accel's `flat.nodes`) with the tree's `child_l` (which
    gives its node count), and the BVH8 records `w8` (missing or None
    for an accel whose walks take K3)."""
    t = {k: torch.as_tensor(np.array(d[k]), device=device)
         for k in ("tri_v0", "tri_e1", "tri_e2", "tri_perm", "attr",
                   "nodes")}
    w8 = d.get("w8")
    return make_accel(t["tri_v0"], t["tri_e1"], t["tri_e2"], t["tri_perm"],
                      t["attr"], t["nodes"],
                      2 * np.asarray(d["child_l"]).shape[0] + 1, leaf_size,
                      w8=(None if w8 is None
                          else torch.as_tensor(np.array(w8), device=device)))


def two_level_from_numpy(d: dict, device) -> tlas.TwoLevelFlat:
    """TwoLevelFlat on `device` from the JAX TwoLevelFlat's arrays: tris
    ((TR, 16, 128) sublane rows, converted to the port's (T, 12) table),
    attr, inst_mat, inst_mesh, normal_mat, world_from_obj,
    obj_from_world, root_bmin, root_bmax and leaf_size, and the tables of
    one route: w8_nodes, w8_root and w8_tlas_nw when w8_nodes is not
    None (the walk's depths and stack bound are read back from the
    records; a table K4 cannot walk raises ValueError), else nodes,
    blas_base, blas_end and tlas_m (JAX's packed `inst` rows are a TPU
    layout of obj_from_world and the BLAS ranges, and are not read).
    The kernels' record tables and stack bounds are derived here."""
    jt = np.asarray(d["tris"], np.float32)                  # (TR, 16, 128)
    rows = jt.transpose(0, 2, 1).reshape(-1, 16)            # (T, 16)
    dev = lambda a: torch.as_tensor(np.array(a), device=device)
    root_bmin = np.asarray(d["root_bmin"], np.float32)
    root_bmax = np.asarray(d["root_bmax"], np.float32)
    if d.get("w8_nodes") is not None:
        rec = np.asarray(d["w8_nodes"], np.int32)
        tlas_nw = int(d["w8_tlas_nw"])
        depth = wide8.node_depths(rec)
        tlas_depth = int(depth[:tlas_nw].max())
        blas_depth = int(depth[tlas_nw:].max())
        tlas.check_depths(tlas_depth, blas_depth)
        route = dict(w8_nodes=dev(rec),
                     w8_rec=wide8.node_records(dev(rec)),
                     w8_root=dev(np.asarray(d["w8_root"], np.int32)),
                     w8_tlas_nw=tlas_nw, tlas_depth=tlas_depth,
                     blas_depth=blas_depth)
    else:
        nodes = dev(np.asarray(d["nodes"], np.float32))
        skip_rec = traversal_skip.skip_records(nodes, nodes.shape[0] * 128)
        base = np.asarray(d["blas_base"], np.int32)
        end = np.asarray(d["blas_end"], np.int32)
        route = dict(nodes=nodes, skip_rec=skip_rec, blas_base=dev(base),
                     blas_end=dev(end), tlas_m=int(d["tlas_m"]),
                     blas_depth=tlas.binary_blas_depth(skip_rec, base, end))
    return tlas.TwoLevelFlat(
        tris=tri_table(dev(rows[:, 0:3]), dev(rows[:, 3:6]),
                       dev(rows[:, 6:9])),
        **{k: dev(d[k]) for k in ("attr", "inst_mat", "inst_mesh",
                                  "normal_mat", "world_from_obj",
                                  "obj_from_world")},
        root_bmin=dev(root_bmin), root_bmax=dev(root_bmax),
        leaf_size=int(d["leaf_size"]), root_box_host=(root_bmin, root_bmax),
        **route)


def upscaler_from_numpy(d: dict, temporal: bool, device):
    """The spatial (or temporal) upscaler net on `device` from flax
    parameters as numpy, keyed `Conv_i/kernel` (HWIO) and `Conv_i/bias`
    — as `{f"{k}/{f}": np.asarray(v[f]) for k, v in params["params"]
    .items() for f in ("kernel", "bias")}` gives them.  HWIO kernels
    become OIHW weights.  The net holds no gradients."""
    net = TemporalUpscalerNet() if temporal else UpscalerNet()
    with torch.no_grad():
        for name, conv in net.named_children():
            k = torch.as_tensor(np.array(d[f"{name}/kernel"], np.float32))
            b = torch.as_tensor(np.array(d[f"{name}/bias"], np.float32))
            w = k.permute(3, 2, 0, 1)
            if w.shape != conv.weight.shape or b.shape != conv.bias.shape:
                raise ValueError(f"{name}: kernel {tuple(k.shape)} / bias "
                                 f"{tuple(b.shape)} do not fit "
                                 f"{type(net).__name__}")
            conv.weight.copy_(w)
            conv.bias.copy_(b)
    return net.requires_grad_(False).eval().to(device)
