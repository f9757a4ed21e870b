"""Two-level acceleration (TLAS over instances -> per-mesh BLAS) for the
instanced frame: the subset of hrt_tpu/ops/tlas.py that its wide walk
(K4, ops/traversal_tlas8.py) and its shading use.

One unified (R, 8, 128) int32 BVH8 record table, built on the host:
the TLAS region first (`w8_tlas_nw` wide nodes, padded to a size fixed
by the instance count so that a refit never moves a BLAS), whose leaf
metas are instance id + 1; then every mesh's BLAS region, globalized
(leaf metas are global pool starts + 1, child bases global wide ids).
Each BLAS is built once per mesh in object space with the native SAH
builder; instance transforms never touch it.  Ray directions stay
unnormalized in object space, so t is the world-space parameter
everywhere.

The JAX package also builds binary skip-link tables (`nodes`, `inst`,
`tlas_m`) for its binary two-level kernel (K5), which it takes past
MAX_WIDE_NODES and on the CPU.  K5 is not ported: a table past the
bound raises here, naming it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.materials import MatP
from ..models.scene import PAD, Scene
from . import lbvh, traversal_tlas8, v3, wide, wide8
from .twolevel import mesh_scene_arrays
from .v3 import V3


@dataclasses.dataclass(frozen=True)
class TwoLevelFlat:
    """The unified two-level table and per-instance data, on one device.

    w8_nodes (R, 8, 128) int32: TLAS region, then the BLAS regions.
    w8_root (I, 1) int32: each instance's BLAS root wide id.
    tris (T, 12) float32: the meshes' leaf-ordered pools, concatenated,
      as v0|e1|e2|pad rows in object space (the JAX (TR, 16, 128) tris,
      transposed to one row per triangle).
    attr (T, 15) float32: object-space nrm0|nrm1|nrm2|uv0|uv1|uv2 rows in
      pool order.
    inst_mat / inst_mesh (I,) int32; normal_mat (I, 3, 3);
    world_from_obj / obj_from_world (I, 3, 4); root_bmin / root_bmax
      (I, 3) object-space BLAS root boxes.
    tlas_depth / blas_depth: the deepest wide node of the TLAS region and
      of any BLAS region (root = 0), which size the walk's per-ray stack
      (`stack`).
    root_box_host: root_bmin / root_bmax as numpy, so a refit needs no
      device read."""

    w8_nodes: torch.Tensor
    w8_root: torch.Tensor
    w8_tlas_nw: int
    tris: torch.Tensor
    attr: torch.Tensor
    inst_mat: torch.Tensor
    inst_mesh: torch.Tensor
    normal_mat: torch.Tensor
    world_from_obj: torch.Tensor
    obj_from_world: torch.Tensor
    root_bmin: torch.Tensor
    root_bmax: torch.Tensor
    leaf_size: int
    tlas_depth: int
    blas_depth: int
    root_box_host: tuple = dataclasses.field(repr=False, compare=False,
                                             default=None)

    @property
    def device(self) -> torch.device:
        return self.w8_nodes.device

    @property
    def stack(self) -> int:
        """Per-ray stack entries the walk needs (`stack_bound`)."""
        return stack_bound(self.tlas_depth, self.blas_depth)


def stack_bound(tlas_depth: int, blas_depth: int) -> int:
    """Per-ray stack entries of the two-level walk.  A TLAS node visit
    leaves at most 9 entries on its level (its node entry's remaining
    mask, and up to 8 pushes: the internal-children entry and instance
    entries), over tlas_depth + 1 levels; inside an instance the BLAS
    walk holds at most one entry per BLAS level, blas_depth + 1."""
    return 9 * (tlas_depth + 1) + blas_depth + 1


def world_aabbs(root_bmin, root_bmax, world_from_obj):
    """World AABBs (I, 3) of per-instance object boxes through their
    3x4 transforms (all 8 corners), float32 numpy as the JAX package."""
    f32 = np.float32
    root_bmin = np.asarray(root_bmin, f32)
    root_bmax = np.asarray(root_bmax, f32)
    m = np.asarray(world_from_obj, f32)
    sel = np.asarray([[x & 1, (x >> 1) & 1, (x >> 2) & 1]
                      for x in range(8)], f32)                  # (8, 3)
    corners = (root_bmin[:, None, :] * (f32(1.0) - sel)
               + root_bmax[:, None, :] * sel)                    # (I, 8, 3)
    wc = (m[:, None, :, 0] * corners[:, :, 0:1]
          + m[:, None, :, 1] * corners[:, :, 1:2]
          + m[:, None, :, 2] * corners[:, :, 2:3]) + m[:, None, :, 3]
    return wc.min(axis=1), wc.max(axis=1)


def _instance_arrays(scene: Scene):
    inst = scene.instances
    return (np.asarray([x.mesh_id for x in inst], np.int32),
            np.asarray([x.material_id for x in inst], np.int32),
            np.stack([x.transform for x in inst]).astype(np.float32),
            np.stack([x.inverse_transform for x in inst]).astype(np.float32),
            np.stack([x.normal_matrix for x in inst]).astype(np.float32))


def _depths(w8_nodes: np.ndarray, tlas_nw: int):
    depth = wide8.node_depths(w8_nodes)
    return int(depth[:tlas_nw].max()), int(depth[tlas_nw:].max())


def check_depths(tlas_depth: int, blas_depth: int) -> None:
    """Raise ValueError if K4's per-ray stack cannot hold the walk of a
    table with these depths."""
    s = stack_bound(tlas_depth, blas_depth)
    if s > traversal_tlas8.MAX_STACK:
        raise ValueError(
            f"two-level walk needs {s} stack entries (TLAS depth "
            f"{tlas_depth}, BLAS depth {blas_depth}); K4 holds "
            f"{traversal_tlas8.MAX_STACK}")


def build_two_level_flat(scene: Scene, leaf_size: int = 16,
                         sah: bool = True, device=None,
                         max_wide_nodes: int = wide8.MAX_WIDE_NODES
                         ) -> TwoLevelFlat:
    """Per-mesh SAH BLAS + wide TLAS, concatenated for the unified walk,
    on `device` (default: the CPU).

    Raises NotImplementedError for sah=False (the JAX package then
    builds each BLAS with its on-device LBVH, not ported yet) and
    ValueError when the unified table reaches `max_wide_nodes` (the
    JAX package then walks the binary tables with K5, not ported
    yet) or needs a deeper stack than K4 holds."""
    if not sah:
        raise NotImplementedError(
            "two-level builds with sah=False need the on-device LBVH "
            "(lbvh.build_bvh), which is not ported yet")
    if not scene.meshes or not scene.instances:
        raise ValueError("scene needs meshes and instances")
    device = torch.device("cpu") if device is None else torch.device(device)

    w8_tables, pools, attrs, mesh_root = [], [], [], []
    tri_base = 0
    for mesh in scene.meshes:
        t_pad = max(PAD, -(-mesh.num_triangles // PAD) * PAD)
        arrs = mesh_scene_arrays(mesh, t_pad)
        _, pool, tree = lbvh.sah_wide8_host(
            arrs["tri_v0"], arrs["tri_e1"], arrs["tri_e2"],
            arrs["tri_valid"] > 0.5, leaf_size)
        # The JAX package collapses each BLAS a second time, from the
        # renumbered tree and leaf boxes recomputed from the pool,
        # without reordering.  That collapse keeps the first one's leaf
        # order (its reorder would be the identity) and writes
        # leaf_base 0; the port repeats it for bit-equal tables.
        lmin, lmax = wide.leaf_boxes(pool["tri_v0"], pool["tri_e1"],
                                     pool["tri_e2"], leaf_size)
        rec, old_of_new = wide8.build_wide8(
            tree["child_l"], tree["child_r"], tree["bmin_l"],
            tree["bmax_l"], tree["bmin_r"], tree["bmax_r"], lmin, lmax,
            leaf_size, reorder=False)
        if not np.array_equal(old_of_new, np.arange(old_of_new.shape[0])):
            raise RuntimeError("BLAS second collapse moved the leaf pool")
        base = np.concatenate([arrs[k] for k in ("nrm0", "nrm1", "nrm2",
                                                  "uv0", "uv1", "uv2")],
                              axis=1)                            # (t, 15)
        attrs.append(base[np.clip(pool["tri_perm"], 0, t_pad - 1)])
        pools.append(pool)
        w8_tables.append((rec, tri_base))
        mesh_root.append((np.minimum(tree["bmin_l"][0], tree["bmin_r"][0]),
                          np.maximum(tree["bmax_l"][0], tree["bmax_r"][0])))
        tri_base += pool["tri_v0"].shape[0]

    inst_mesh, inst_mat, w_from_o, o_from_w, normal_mat = \
        _instance_arrays(scene)
    root_bmin = np.stack([mesh_root[m][0] for m in inst_mesh])
    root_bmax = np.stack([mesh_root[m][1] for m in inst_mesh])
    bmin, bmax = world_aabbs(root_bmin, root_bmax, w_from_o)

    tlas_pad = wide8.tlas_nw_pad(len(scene.instances))
    mesh_w8_base, total = [], tlas_pad
    for rec, _ in w8_tables:
        mesh_w8_base.append(total)
        total += rec.shape[0] * wide8.NODES_PER_ROW
    if total >= max_wide_nodes:
        raise ValueError(
            f"the two-level table needs {total} wide nodes, past "
            f"MAX_WIDE_NODES ({max_wide_nodes}); the JAX package walks such "
            "scenes with its binary two-level kernel (K5, "
            "hrt_tpu/ops/tlas.py _trace_tiles_tlas), not ported yet")
    w8_nodes = np.concatenate(
        [wide8.build_wide8_tlas(bmin, bmax, tlas_pad)]
        + [wide8.globalize(rec, tb, b)
           for (rec, tb), b in zip(w8_tables, mesh_w8_base)])
    tlas_depth, blas_depth = _depths(w8_nodes, tlas_pad)
    check_depths(tlas_depth, blas_depth)

    dev = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    cat = lambda k: np.concatenate([p[k] for p in pools])
    tris = lbvh.tri_table(dev(cat("tri_v0")), dev(cat("tri_e1")),
                          dev(cat("tri_e2")))
    return TwoLevelFlat(
        w8_nodes=dev(w8_nodes),
        w8_root=dev(np.asarray(mesh_w8_base, np.int32)[inst_mesh][:, None]),
        w8_tlas_nw=int(tlas_pad), tris=tris,
        attr=dev(np.concatenate(attrs).astype(np.float32)),
        inst_mat=dev(inst_mat), inst_mesh=dev(inst_mesh),
        normal_mat=dev(normal_mat), world_from_obj=dev(w_from_o),
        obj_from_world=dev(o_from_w), root_bmin=dev(root_bmin),
        root_bmax=dev(root_bmax), leaf_size=leaf_size,
        tlas_depth=tlas_depth, blas_depth=blas_depth,
        root_box_host=(root_bmin, root_bmax))


def refit_two_level(tl: TwoLevelFlat, world_from_obj, obj_from_world,
                    normal_mat) -> TwoLevelFlat:
    """New instance transforms (numpy (I, 3, 4), (I, 3, 4), (I, 3, 3))
    -> new instance boxes -> a rebuilt TLAS region (host numpy, copied
    up) in a new table; no BLAS is touched and `tl` is left as it was."""
    world_from_obj = np.asarray(world_from_obj, np.float32)
    bmin, bmax = world_aabbs(*tl.root_box_host, world_from_obj)
    tlas = wide8.build_wide8_tlas(bmin, bmax, tl.w8_tlas_nw)
    tlas_depth = int(wide8.node_depths(tlas).max())
    check_depths(tlas_depth, tl.blas_depth)
    rows = tl.w8_tlas_nw // wide8.NODES_PER_ROW
    dev = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                    device=tl.device)
    return dataclasses.replace(
        tl, w8_nodes=torch.cat([torch.as_tensor(tlas, device=tl.device),
                                tl.w8_nodes[rows:]]),
        world_from_obj=dev(world_from_obj),
        obj_from_world=dev(obj_from_world), normal_mat=dev(normal_mat),
        tlas_depth=tlas_depth)


def _planes(o: V3, d: V3, t_max):
    n = o.x.shape[0]
    tmax = torch.broadcast_to(torch.as_tensor(
        t_max, dtype=torch.float32, device=o.x.device), (n,))
    return (o.x, o.y, o.z, d.x, d.y, d.z, tmax)


def _walk(plain: bool):
    return traversal_tlas8.trace_plain if plain else traversal_tlas8.trace


def closest_hit_tlas(tl: TwoLevelFlat, o: V3, d: V3, t_min, t_max,
                     plain: bool = False):
    """(t, tri, inst, u, v) over planar rays: tri is the global pool id
    and inst the instance id (-1 on a miss, t = t_max).  A CUDA tensor
    goes to K4, a CPU tensor to its plain version; plain=True takes the
    plain version on any device."""
    return _walk(plain)(tl, *_planes(o, d, t_max), float(t_min), True)


def any_hit_tlas(tl: TwoLevelFlat, o: V3, d: V3, t_min, t_max,
                 plain: bool = False) -> torch.Tensor:
    """Occlusion of the segments (t_min, t_max): bool (N,)."""
    return _walk(plain)(tl, *_planes(o, d, t_max), float(t_min), False)


def shade_attrs_tlas(tl: TwoLevelFlat, materials: torch.Tensor, tri_id,
                     inst_id, u, v):
    """Hit attributes of two-level hits: one gather of the pool-order
    attribute table, the normal transformed by the hit instance's
    normal matrix, the material row from the instance's material id.
    Returns (unit normal V3, MatP)."""
    rt = tl.attr[tri_id.clamp(min=0).long()].T                 # (15, N)
    w = 1.0 - u - v
    n_obj = V3(w * rt[0] + u * rt[3] + v * rt[6],
               w * rt[1] + u * rt[4] + v * rt[7],
               w * rt[2] + u * rt[5] + v * rt[8])
    si = inst_id.clamp(min=0).long()
    nm = tl.normal_mat.reshape(-1, 9)[si].T                     # (9, N)
    normal = v3.normalize(V3(
        nm[0] * n_obj.x + nm[1] * n_obj.y + nm[2] * n_obj.z,
        nm[3] * n_obj.x + nm[4] * n_obj.y + nm[5] * n_obj.z,
        nm[6] * n_obj.x + nm[7] * n_obj.y + nm[8] * n_obj.z))
    mt = materials[tl.inst_mat[si].long()].T                    # (MAT_W, N)
    return normal, MatP.from_rows_t(mt)
