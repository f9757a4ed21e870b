"""The stacked two-level accel: one object-space BLAS per mesh and the
instances' world boxes, traced instance by instance
(hrt_tpu/ops/twolevel.py `TwoLevelAccel`, `build_two_level`,
`trace_two_level`, `shade_attrs_two_level`).

Each BLAS is the mesh's LBVH (lbvh.build_bvh) over its triangles padded
to a common count, so its walk is the binary skip-link walk K3
(ops/traversal_skip.py): the CUDA kernel for CUDA tensors, the plain
version for CPU tensors or with `plain=True`.  A ray visits the
instances in order: it tests the instance's world box against its best
t so far, goes into object space by the instance's inverse transform
(the direction left unnormalised, so t stays the world parameter) and
walks the instance's BLAS below its best t; a hit inside the box that
is nearer replaces the best.  Moving an instance means replacing its
rows (box and transforms); no BLAS is rebuilt.  No frame path uses this
accel: the frame loop's instanced scenes take ops/tlas.py's unified
tables.

JAX's `trace_two_level` is a jit of a scan over the instances; here the
trace replays a CUDA graph on the card (TRACE_PROGRAMS, graphs.py) in
which the instance loop is unrolled: one K3 launch per instance.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import graphs
from ..config import resolve_device
from ..models.scene import PAD, Scene, SceneData
from . import lbvh, traversal_skip
from .intersect import (INF, ray_aabb, ray_t_max, safe_inv_dir,
                        to_object_space)
from .math3d import normalize

_ATTRS = ("nrm0", "nrm1", "nrm2", "uv0", "uv1", "uv2")
# trace_two_level's captured programs.
TRACE_PROGRAMS = graphs.Programs(4)


class TwoLevelAccel(NamedTuple):
    """The instances' rows and the per-mesh BLAS.

    inst_bmin/inst_bmax (I, 3) world boxes, inst_mesh/inst_mat (I,)
    int32, world_from_obj/obj_from_world (I, 3, 4), normal_mat (I, 3, 3);
    `blas` one LBVH Accel per mesh over its t_pad object-space
    triangles; nrm0..uv2 (M, t_pad, 3 or 2) each mesh's shading
    attributes in its BLAS's leaf order (the walk's pool ids index
    them); `inst_mesh_host` inst_mesh as a host tuple of ints, which the
    trace unrolls its instance loop over without reading the card."""

    inst_bmin: torch.Tensor
    inst_bmax: torch.Tensor
    inst_mesh: torch.Tensor
    inst_mat: torch.Tensor
    world_from_obj: torch.Tensor
    obj_from_world: torch.Tensor
    normal_mat: torch.Tensor
    blas: tuple
    nrm0: torch.Tensor
    nrm1: torch.Tensor
    nrm2: torch.Tensor
    uv0: torch.Tensor
    uv1: torch.Tensor
    uv2: torch.Tensor
    inst_mesh_host: tuple


def mesh_scene_arrays(mesh, t_pad: int) -> dict:
    """Object-space SoA arrays (float32) for one mesh, padded to t_pad
    triangles with zeros (degenerate, never hit)."""
    v = mesh.vertices
    i0, i1, i2 = mesh.indices[:, 0], mesh.indices[:, 1], mesh.indices[:, 2]
    pos = v[:, 0:3]
    nrm = v[:, 3:6]
    uv = v[:, 6:8]
    t = mesh.num_triangles

    def padded(x):
        out = np.zeros((t_pad,) + x.shape[1:], np.float32)
        out[:t] = x
        return out

    return {
        "tri_v0": padded(pos[i0]),
        "tri_e1": padded(pos[i1] - pos[i0]),
        "tri_e2": padded(pos[i2] - pos[i0]),
        "nrm0": padded(nrm[i0]), "nrm1": padded(nrm[i1]),
        "nrm2": padded(nrm[i2]),
        "uv0": padded(uv[i0]), "uv1": padded(uv[i1]), "uv2": padded(uv[i2]),
        "tri_valid": padded(np.ones((t,), np.float32)),
    }


def _mesh_scene(arrs: dict, device) -> SceneData:
    """A one-mesh SceneData holding what lbvh.build_bvh reads."""
    dev = lambda a: torch.as_tensor(a, device=device)
    t = arrs["tri_v0"].shape[0]
    zeros = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    return SceneData(
        **{k: dev(v) for k, v in arrs.items()},
        tri_mat=torch.zeros((t,), dtype=torch.int32, device=device),
        tri_inst=torch.zeros((t,), dtype=torch.int32, device=device),
        materials=zeros(1, 1), lights=zeros(0, 8), sky=zeros(22),
        inst_bmin=zeros(1, 3), inst_bmax=zeros(1, 3))


def build_two_level(scene: Scene, leaf_size: int = 8,
                    device=None) -> TwoLevelAccel:
    """One LBVH per mesh in object space (padded to the largest mesh's
    PAD-rounded triangle count) and the instances' rows, on `device`
    (default the first CUDA device; config.resolve_device)."""
    if not scene.meshes or not scene.instances:
        raise ValueError("scene needs meshes and instances")
    device = resolve_device(device)
    t_pad = max(PAD, max(((m.num_triangles + PAD - 1) // PAD) * PAD
                         for m in scene.meshes))
    blas, attrs = [], []
    for mesh in scene.meshes:
        arrs = mesh_scene_arrays(mesh, t_pad)
        accel = lbvh.build_bvh(_mesh_scene(arrs, device), leaf_size)
        blas.append(accel)
        perm = accel.tri_perm.long()
        attrs.append([torch.as_tensor(arrs[k], device=device)[perm]
                      for k in _ATTRS])
    stacked = {k: torch.stack([a[i] for a in attrs])
               for i, k in enumerate(_ATTRS)}
    _, (bmin, bmax) = scene.build_host()
    inst = scene.instances
    mesh_of = tuple(int(i.mesh_id) for i in inst)
    dev = lambda a, dt=torch.float32: torch.as_tensor(
        np.asarray(a), dtype=dt, device=device)
    return TwoLevelAccel(
        inst_bmin=dev(bmin), inst_bmax=dev(bmax),
        inst_mesh=dev(mesh_of, torch.int32),
        inst_mat=dev([i.material_id for i in inst], torch.int32),
        world_from_obj=dev(np.stack([i.transform for i in inst])),
        obj_from_world=dev(np.stack([i.inverse_transform for i in inst])),
        normal_mat=dev(np.stack([i.normal_matrix for i in inst])),
        blas=tuple(blas), **stacked, inst_mesh_host=mesh_of)


def trace_two_level(accel: TwoLevelAccel, o: torch.Tensor, d: torch.Tensor,
                    t_max=INF, t_min: float = 1e-3, find_closest: bool = True,
                    plain: bool = False):
    """Trace world rays o, d (N, 3) through the instances and their BLAS.

    Returns (t, inst, tri, u, v): tri is the hit triangle's pool id in
    its mesh's BLAS (leaf order; shade_attrs_two_level takes it), inst
    and tri are -1 on a miss and t is t_max there.  With find_closest
    False only `inst >= 0` means anything: the first instance, in
    order, whose BLAS blocks (t_min, t_max); t, tri, u and v then keep
    their miss values.  Rays that miss an instance's box, or that are
    already occluded, are passed to its walk as retired (t_max = -1).
    `t_max` is a number or a tensor that broadcasts to (N,).

    On the card the trace replays the graph of t_min, find_closest, the
    accel (its BLAS carry their leaf size, a static argument of JAX's
    jit) and the ray shapes (TRACE_PROGRAMS), the rays and a tensor
    t_max copied in; its body reads nothing back from the card.
    `plain=True` walks each BLAS with K3's plain version on any device,
    op by op."""
    tm = t_max if isinstance(t_max, torch.Tensor) else None

    def body(o, d, tm):
        return _trace(accel, o, d, t_max if tm is None else tm, t_min,
                      find_closest, plain)

    key = ("trace_two_level", float(t_min), bool(find_closest),
           None if tm is not None else float(t_max),
           graphs.signature(accel))
    return TRACE_PROGRAMS(key, body, (o, d, tm), o.device, eager=plain)


def _trace(accel: TwoLevelAccel, o, d, t_max, t_min: float,
           find_closest: bool, plain: bool):
    """trace_two_level's body: the instance loop, unrolled over the
    accel's host list of meshes."""
    n = o.shape[0]
    dev = o.device
    best_t = ray_t_max(t_max, n, dev).clone()
    best_inst = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((n,), dtype=torch.float32, device=dev)
    best_v = torch.zeros((n,), dtype=torch.float32, device=dev)
    inv_d = safe_inv_dir(d)
    walk = traversal_skip.trace_plain if plain else traversal_skip.trace
    for idx, mesh_id in enumerate(accel.inst_mesh_host):
        hit_box = ray_aabb(o, inv_d, accel.inst_bmin[idx],
                           accel.inst_bmax[idx], t_min, best_t)[0]
        if not find_closest:
            hit_box = hit_box & (best_inst < 0)
        oo, od = to_object_space(accel.obj_from_world[idx].reshape(1, 12),
                                 o, d)
        live_t = torch.where(hit_box, best_t, -1.0)
        res = walk(accel.blas[mesh_id], oo[:, 0], oo[:, 1], oo[:, 2],
                   od[:, 0], od[:, 1], od[:, 2], live_t, float(t_min),
                   find_closest)
        if not find_closest:
            best_inst = torch.where(res & hit_box, idx, best_inst)
            continue
        t, tri, u, v = res
        better = (tri >= 0) & (t < best_t) & hit_box
        best_t = torch.where(better, t, best_t)
        best_inst = torch.where(better, idx, best_inst)
        best_tri = torch.where(better, tri, best_tri)
        best_u = torch.where(better, u, best_u)
        best_v = torch.where(better, v, best_v)
    return best_t, best_inst, best_tri, best_u, best_v


def shade_attrs_two_level(accel: TwoLevelAccel, inst_id, tri_id, u, v):
    """The hits' shading attributes: the unit world normal (N, 3) (the
    object-space interpolated normal through the instance's normal
    matrix), the interpolated UV (N, 2) and the instance's material
    (N,).  Misses read instance 0's triangle 0."""
    safe_i = inst_id.clamp(min=0).long()
    mesh = accel.inst_mesh[safe_i].long()
    safe_t = tri_id.clamp(min=0).long()
    w = (1.0 - u - v)[:, None]
    u, v = u[:, None], v[:, None]
    nrm_obj = (w * accel.nrm0[mesh, safe_t] + u * accel.nrm1[mesh, safe_t]
               + v * accel.nrm2[mesh, safe_t])
    nrm = torch.einsum("nij,nj->ni", accel.normal_mat[safe_i], nrm_obj)
    uv = (w * accel.uv0[mesh, safe_t] + u * accel.uv1[mesh, safe_t]
          + v * accel.uv2[mesh, safe_t])
    return normalize(nrm), uv, accel.inst_mat[safe_i]
