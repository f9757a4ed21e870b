"""Two-level acceleration (TLAS over instances -> per-mesh BLAS) for the
instanced frame: the subset of hrt_tpu/ops/tlas.py that its walks (K4,
ops/traversal_tlas8.py; K5, ops/traversal_tlas_skip.py) and its shading
use.

Each BLAS is built once per mesh in object space, with the native SAH
builder (`sah=True`) or the LBVH (`sah=False`, ops/lbvh.lbvh_tree);
instance transforms never touch it.  Ray directions stay unnormalized in
object space, so t is the world-space parameter everywhere.  The build
then takes one of two routes, as the JAX package does:

- the unified BVH8 table, walked by K4: one (R, 8, 128) int32 record
  table, the TLAS region first (`w8_tlas_nw` wide nodes, padded to a
  size fixed by the instance count so that a refit never moves a BLAS),
  whose leaf metas are instance id + 1; then every mesh's BLAS region,
  globalized (leaf metas are global pool starts + 1, child bases global
  wide ids);
- the binary skip-link tables, walked by K5, when the unified table
  would reach `max_wide_nodes` or a BLAS overflows its own collapse:
  `nodes`, the TLAS's skip-link rows (leaf codes -(instance + 1),
  `tlas_m` nodes) and then every mesh's BLAS rows (leaf codes shifted by
  the mesh's pool base, skip links by its node base), and per instance
  its BLAS node range [blas_base, blas_end).

Only the tables of the route taken are built: a walk reads one or the
other.
"""
from __future__ import annotations

import dataclasses
import types
from typing import NamedTuple

import numpy as np
import torch

from .. import graphs
from ..config import resolve_device
from ..models.materials import MatP
from ..models.scene import PAD, Scene
from ..utils import tracing
from . import (intersect, lbvh, morton, traversal_skip, traversal_tlas8,
               traversal_tlas_skip, v3, wide, wide8)
from .twolevel import mesh_scene_arrays
from .v3 import V3


@dataclasses.dataclass(frozen=True)
class TwoLevelFlat:
    """The two-level tables and per-instance data, on one device.

    tris (T, 12) float32: the meshes' leaf-ordered pools, concatenated,
      as v0|e1|e2|pad rows in object space (the JAX (TR, 16, 128) tris,
      transposed to one row per triangle).
    attr (T, 15) float32: object-space nrm0|nrm1|nrm2|uv0|uv1|uv2 rows in
      pool order.
    inst_mat / inst_mesh (I,) int32; normal_mat (I, 3, 3);
    world_from_obj / obj_from_world (I, 3, 4); root_bmin / root_bmax
      (I, 3) object-space BLAS root boxes.
    The BVH8 route (K4): w8_nodes (R, 8, 128) int32, the TLAS region then
      the BLAS regions; w8_rec (R * 16, 64) int32, the same nodes as
      256-byte records, the layout K4 reads (wide8.node_records);
      w8_root (I, 1) int32, each instance's BLAS root wide id; tlas_depth /
      blas_depth, the deepest wide node of the TLAS region and of any BLAS
      region (root = 0), which size the walks' stacks (`stack`).  None / 0
      on the binary route, except blas_depth.
    The binary route (K5): nodes (R, 8, 128) float32 skip-link rows (rows
      6-7 int32 bits), the TLAS's `tlas_m` nodes first; skip_rec (R * 128,
      8) int32, every row's nodes as 32-byte records, the layout K5 reads
      (traversal_skip.skip_records); blas_base / blas_end (I,) int32;
      blas_depth, the deepest binary BLAS node (root = 0), which with the
      instance count sizes K5's stack (`skip_stack`).  None / 0 on the
      BVH8 route.
    `set_instance` writes the TLAS part of the route's tables and the
    instance matrices in place; `refit_two_level` returns new ones."""

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
    w8_nodes: torch.Tensor | None = None
    w8_rec: torch.Tensor | None = None
    w8_root: torch.Tensor | None = None
    w8_tlas_nw: int = 0
    tlas_depth: int = 0
    blas_depth: int = 0
    nodes: torch.Tensor | None = None
    skip_rec: torch.Tensor | None = None
    blas_base: torch.Tensor | None = None
    blas_end: torch.Tensor | None = None
    tlas_m: int = 0

    @property
    def device(self) -> torch.device:
        return self.tris.device

    @property
    def stack(self) -> int:
        """Stack entries the BVH8 walks need (`stack_bound`)."""
        return stack_bound(self.tlas_depth, self.blas_depth)

    @property
    def skip_stack(self) -> int:
        """Stack entries K5's walk needs (`skip_stack_bound`)."""
        return skip_stack_bound(self.inst_mesh.shape[0], self.blas_depth)


def stack_bound(tlas_depth: int, blas_depth: int) -> int:
    """Stack entries of the two-level BVH8 walks, the larger of two.
    The per-ray stacks (trace_plain; K4's any-hit kernel): a TLAS node
    visit leaves at most 9 entries on its level (its node entry's
    remaining mask, and up to 8 pushes: the internal-children entry and
    instance entries), over tlas_depth + 1 levels; inside an instance
    the walk holds at most one entry per BLAS level, blas_depth + 1, and
    K4's any-hit kernel up to 8 leaf entries on top.  K4's closest
    kernel's warp stack: a node visit pushes at most 7 children (the
    nearest is walked next), over tlas_depth + 1 and blas_depth + 1
    levels, plus the instance's marker."""
    return max(9 * (tlas_depth + 1) + blas_depth + 9,
               7 * (tlas_depth + blas_depth + 2) + 1)


def skip_stack_bound(num_instances: int, blas_depth: int) -> int:
    """Per-ray stack entries of K5's nearest-first walk, which pushes at
    most one entry per internal node on its path: over the TLAS, a radix
    tree of 30-bit Morton codes with an index tiebreak, whose common
    prefix grows at every level, so a path meets at most 30 +
    ceil(log2(leaves)) internal nodes whatever the instance boxes (a
    refit needs no new bound); the instance's marker; over the BLAS,
    blas_depth internal nodes."""
    leaves = max(num_instances, 2)
    return 30 + (leaves - 1).bit_length() + 1 + blas_depth


def skip_depth(words: np.ndarray, base: int) -> int:
    """Depth (root = 0) of the binary tree in skip-link node records
    (m, 8) int32 whose node ids start at `base`: the children of an
    internal node i (leaf code 0) are i + 1 and that child's skip."""
    m = words.shape[0]
    inner = np.nonzero(words[:, 6] == 0)[0]
    parent = np.full(m, -1, np.int64)
    parent[inner + 1] = inner
    parent[words[inner + 1, 7] - base] = inner
    depth = np.zeros(m, np.int64)
    # One level per sweep, until nothing moves.
    while True:
        new = np.where(parent >= 0, depth[np.maximum(parent, 0)] + 1, 0)
        if np.array_equal(new, depth):
            return int(depth.max())
        depth = new


def binary_blas_depth(skip_rec: torch.Tensor, blas_base: np.ndarray,
                      blas_end: np.ndarray) -> int:
    """The deepest binary BLAS node of a binary two-level table, read
    from each BLAS's node records; raises ValueError when K5's stack
    cannot hold the walk (`skip_stack_bound`)."""
    depth = max(skip_depth(skip_rec[b:e].cpu().numpy(), b)
                for b, e in set(zip(blas_base.tolist(), blas_end.tolist())))
    s = skip_stack_bound(blas_base.shape[0], depth)
    if s > traversal_tlas_skip.MAX_STACK:
        raise ValueError(
            f"binary two-level walk needs {s} stack entries "
            f"({blas_base.shape[0]} instances, BLAS depth {depth}); K5 holds "
            f"{traversal_tlas_skip.MAX_STACK}")
    return depth


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c rounded once (a fused multiply-add), exact on
    any device through float64: a * b is exact there, TwoSum gives s + e
    == a * b + c exactly, and s rounds to the float32 that the exact sum
    rounds to, unless s sits on a float32 tie with e != 0: then it moves
    one float64 step toward e first."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    z = s - p
    e = (p - (s - z)) + (c - z)
    r = s.float()
    away = torch.nextafter(r, torch.where(s > r.double(), float("inf"),
                                          float("-inf")))
    tie = (r.double() + away.double()) * 0.5 == s
    step = torch.nextafter(s, torch.where(e > 0, float("inf"),
                                          float("-inf")).double())
    return torch.where(tie & (e != 0), step, s).float()


def world_aabbs(root_bmin: torch.Tensor, root_bmax: torch.Tensor,
                world_from_obj: torch.Tensor):
    """World AABBs (I, 3) of per-instance object boxes through their
    3x4 transforms (all 8 corners), float32 on the inputs' device, bit
    for bit as the JAX package's `_world_aabbs`, whose einsum XLA's CPU
    dot sums as fma(m2, c2, fma(m1, c1, m0 * c0)) before adding the
    translation."""
    x = torch.arange(8, device=root_bmin.device)
    sel = torch.stack([x & 1, (x >> 1) & 1, (x >> 2) & 1], dim=1) \
        .to(torch.float32)                                       # (8, 3)
    corners = (root_bmin[:, None, :] * (1.0 - sel)
               + root_bmax[:, None, :] * sel)[:, :, None, :]     # (I, 8, 1, 3)
    m = world_from_obj[:, None]                                  # (I, 1, 3, 4)
    wc = m[..., 0] * corners[..., 0]
    for b in (1, 2):
        wc = _fma(m[..., b], corners[..., b], wc)
    wc = wc + m[..., 3]                                          # (I, 8, 3)
    return wc.min(dim=1).values, wc.max(dim=1).values


def _instance_arrays(scene: Scene):
    inst = scene.instances
    return (np.asarray([x.mesh_id for x in inst], np.int32),
            np.asarray([x.material_id for x in inst], np.int32),
            np.stack([x.transform for x in inst]).astype(np.float32),
            np.stack([x.inverse_transform for x in inst]).astype(np.float32),
            np.stack([x.normal_matrix for x in inst]).astype(np.float32))


def check_depths(tlas_depth: int, blas_depth: int) -> None:
    """Raise ValueError if K4's per-ray stack cannot hold the walk of a
    table with these depths."""
    s = stack_bound(tlas_depth, blas_depth)
    if s > traversal_tlas8.MAX_STACK:
        raise ValueError(
            f"two-level walk needs {s} stack entries (TLAS depth "
            f"{tlas_depth}, BLAS depth {blas_depth}); K4 holds "
            f"{traversal_tlas8.MAX_STACK}")


class _Blas(NamedTuple):
    """One mesh's BLAS in object space: the records of its BVH8 collapse
    (None past MAX_WIDE_NODES), its leaf-ordered pool and tree (numpy
    dicts), its skip-link nodes (torch, CPU) over m_real nodes, and its
    (t, 15) attribute rows in pool order."""

    records: np.ndarray | None
    pool: dict
    tree: dict
    nodes: torch.Tensor
    m_real: int
    attr: np.ndarray


def _blas(mesh, leaf_size: int, sah: bool) -> _Blas:
    """Build one mesh's BLAS on the host."""
    t_pad = max(PAD, -(-mesh.num_triangles // PAD) * PAD)
    arrs = mesh_scene_arrays(mesh, t_pad)
    if sah:
        _, pool, tree = lbvh.sah_wide8_host(
            arrs["tri_v0"], arrs["tri_e1"], arrs["tri_e2"],
            arrs["tri_valid"] > 0.5, leaf_size)
    else:
        fake = types.SimpleNamespace(**{k: torch.as_tensor(arrs[k]) for k in (
            "tri_v0", "tri_e1", "tri_e2", "tri_valid")})
        tree = {k: a.numpy() for k, a in
                lbvh.lbvh_tree(fake, leaf_size).items()}
        pool = {k: tree[k] for k in ("tri_v0", "tri_e1", "tri_e2",
                                     "tri_perm")}
    nodes, m_real = lbvh.flatten_tree(tree, leaf_size)
    # The JAX package collapses each BLAS (again, for a SAH one) from
    # its tree and leaf boxes recomputed from the pool, without
    # reordering: metas in pool order, leaf_base 0.
    lmin, lmax = wide.leaf_boxes(pool["tri_v0"], pool["tri_e1"],
                                 pool["tri_e2"], leaf_size)
    out = wide8.build_wide8(
        tree["child_l"], tree["child_r"], tree["bmin_l"], tree["bmax_l"],
        tree["bmin_r"], tree["bmax_r"], lmin, lmax, leaf_size, reorder=False)
    base = np.concatenate([arrs[k] for k in ("nrm0", "nrm1", "nrm2",
                                             "uv0", "uv1", "uv2")], axis=1)
    attr = base[np.clip(pool["tri_perm"], 0, t_pad - 1)]
    return _Blas(None if out is None else out[0], pool, tree, nodes, m_real,
                 attr)


def _tlas_nodes(inst_bmin: torch.Tensor, inst_bmax: torch.Tensor):
    """The binary TLAS over instance world boxes (I, 3), on their device,
    bit for bit as the JAX `_tlas_nodes`: Morton order, Karras tree,
    refit, skip-link table with one instance per leaf, leaf codes
    -(instance + 1).  A single instance is padded with a duplicate box.
    Returns (nodes (rows, 8, 128) float32, tlas_m = 2 * leaves - 1)."""
    i_real = inst_bmin.shape[0]
    if i_real == 1:
        inst_bmin = torch.cat([inst_bmin, inst_bmin])
        inst_bmax = torch.cat([inst_bmax, inst_bmax])
    i = inst_bmin.shape[0]
    centroid = (inst_bmin + inst_bmax) * 0.5
    codes = morton.morton_codes(centroid, inst_bmin.min(dim=0).values,
                                      inst_bmax.max(dim=0).values)
    order = torch.argsort(codes, stable=True)
    child_l, child_r = lbvh.karras_hierarchy(codes[order])
    lmin, lmax = inst_bmin[order], inst_bmax[order]
    boxes = lbvh.refit(child_l, child_r, lmin, lmax)
    nodes = lbvh.flatten_bvh(child_l, child_r, *boxes, lmin, lmax, 1,
                             lbvh.sweep_bound(i))
    bits = nodes.view(torch.int32)
    lc = bits[:, 6, :]
    inst_id = order.clamp(max=i_real - 1)[(lc.long() - 1).clamp(0, i - 1)]
    bits[:, 6, :] = torch.where(lc > 0, -(inst_id + 1), 0).to(torch.int32)
    return nodes, 2 * i - 1


def _skip_rec(nodes: torch.Tensor) -> torch.Tensor:
    """K5's node records of every row of a binary table: the BLAS
    indices run past the TLAS's padded rows, so no row is cut."""
    return traversal_skip.skip_records(nodes, nodes.shape[0] * 128)


def build_two_level_flat(scene: Scene, leaf_size: int = 16,
                         sah: bool = True, device=None,
                         max_wide_nodes: int | None = None) -> TwoLevelFlat:
    """Per-mesh BLAS + TLAS on `device` (default: the first CUDA device;
    raises without one), on the BVH8
    route when every BLAS collapses and the unified table stays below
    `max_wide_nodes` wide nodes (default: wide8.MAX_WIDE_NODES, read at
    call time), else on the binary route.  Raises ValueError when a BVH8
    table needs a deeper stack than K4 holds."""
    if max_wide_nodes is None:
        max_wide_nodes = wide8.MAX_WIDE_NODES
    if not scene.meshes or not scene.instances:
        raise ValueError("scene needs meshes and instances")
    device = resolve_device(device)
    blases = [_blas(mesh, leaf_size, sah) for mesh in scene.meshes]
    inst_mesh, inst_mat, w_from_o, o_from_w, normal_mat = \
        _instance_arrays(scene)
    mesh_root = [(np.minimum(b.tree["bmin_l"][0], b.tree["bmin_r"][0]),
                  np.maximum(b.tree["bmax_l"][0], b.tree["bmax_r"][0]))
                 for b in blases]
    dev = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    root_bmin = dev(np.stack([mesh_root[m][0] for m in inst_mesh]))
    root_bmax = dev(np.stack([mesh_root[m][1] for m in inst_mesh]))
    world_from_obj = dev(w_from_o)
    bmin, bmax = world_aabbs(root_bmin, root_bmax, world_from_obj)

    cat = lambda k: np.concatenate([b.pool[k] for b in blases])
    tri_base = np.cumsum([0] + [b.pool["tri_v0"].shape[0] for b in blases])
    common = dict(
        tris=lbvh.tri_table(dev(cat("tri_v0")), dev(cat("tri_e1")),
                            dev(cat("tri_e2"))),
        attr=dev(np.concatenate([b.attr for b in blases])
                 .astype(np.float32)),
        inst_mat=dev(inst_mat), inst_mesh=dev(inst_mesh),
        normal_mat=dev(normal_mat), world_from_obj=world_from_obj,
        obj_from_world=dev(o_from_w), root_bmin=root_bmin,
        root_bmax=root_bmax, leaf_size=leaf_size)

    tlas_pad = wide8.tlas_nw_pad(len(scene.instances))
    mesh_w8_base = np.cumsum(
        [tlas_pad] + [0 if b.records is None else b.records.shape[0]
                      * wide8.NODES_PER_ROW for b in blases])
    if all(b.records is not None for b in blases) \
            and mesh_w8_base[-1] < max_wide_nodes:
        tlas8, tlas_depth = wide8.build_wide8_tlas(bmin, bmax, tlas_pad)
        tlas_depth = int(tlas_depth)
        blas_depth = max(wide8.record_depth(b.records) for b in blases)
        check_depths(tlas_depth, blas_depth)
        w8_nodes = torch.cat([tlas8, dev(np.concatenate(
            [wide8.globalize(b.records, int(tb), int(wb))
             for b, tb, wb in zip(blases, tri_base, mesh_w8_base)]))])
        return TwoLevelFlat(
            **common, w8_nodes=w8_nodes,
            w8_rec=wide8.node_records(w8_nodes),
            w8_root=dev(mesh_w8_base[:-1].astype(np.int32)[inst_mesh]
                        [:, None]),
            w8_tlas_nw=int(tlas_pad), tlas_depth=tlas_depth,
            blas_depth=blas_depth)

    # The binary route: TLAS rows, then each mesh's globalized BLAS rows.
    tlas, tlas_m = _tlas_nodes(bmin, bmax)
    tlas_words = tlas.shape[0] * 128
    node_base = np.cumsum([0] + [b.nodes.shape[0] * 128 for b in blases])
    parts = [tlas]
    for b, tb, nb in zip(blases, tri_base, node_base):
        bits = b.nodes.view(torch.int32).clone()
        lc = bits[:, 6, :]
        bits[:, 6, :] = torch.where(lc > 0, lc + int(tb), lc)
        bits[:, 7, :] += tlas_words + int(nb)
        parts.append(bits.view(torch.float32).to(device))
    m_real = np.asarray([b.m_real for b in blases])
    blas_base = (tlas_words + node_base[:-1])[inst_mesh]
    blas_end = blas_base + m_real[inst_mesh]
    nodes = torch.cat(parts)
    skip_rec = _skip_rec(nodes)
    return TwoLevelFlat(
        **common, nodes=nodes, skip_rec=skip_rec,
        blas_base=dev(blas_base.astype(np.int32)),
        blas_end=dev(blas_end.astype(np.int32)), tlas_m=int(tlas_m),
        blas_depth=binary_blas_depth(skip_rec, blas_base, blas_end))


_MATS = ("world_from_obj", "obj_from_world", "normal_mat")


def refit_body(tl: TwoLevelFlat):
    """The refit as a capturable body over `tl`'s own tensors: the world
    boxes of its instance matrices (`world_aabbs`), then the route's
    TLAS over them (binary: `_tlas_nodes` and K5's records of its rows;
    BVH8: `wide8.build_wide8_tlas` and K4's records of its region),
    written over the TLAS part of `tl`'s tables.  No BLAS is touched.
    Returns () on the binary route, (the wide TLAS depth,) on the BVH8
    route."""
    def body():
        bmin, bmax = world_aabbs(tl.root_bmin, tl.root_bmax,
                                 tl.world_from_obj)
        if tl.w8_nodes is None:
            tlas, _ = _tlas_nodes(bmin, bmax)
            tl.nodes[:tlas.shape[0]].copy_(tlas)
            tl.skip_rec[:tlas.shape[0] * 128].copy_(_skip_rec(tlas))
            return ()
        tlas, depth = wide8.build_wide8_tlas(bmin, bmax, tl.w8_tlas_nw)
        tl.w8_nodes[:tlas.shape[0]].copy_(tlas)
        tl.w8_rec[:tl.w8_tlas_nw].copy_(wide8.node_records(tlas))
        return (depth,)
    return body


def refit_two_level(tl: TwoLevelFlat, world_from_obj, obj_from_world,
                    normal_mat) -> TwoLevelFlat:
    """New instance transforms ((I, 3, 4), (I, 3, 4), (I, 3, 3); numpy
    or tensors) -> new instance boxes -> a rebuilt TLAS on the table's
    device (`refit_body`, op by op), joined to the BLAS records as they
    were, in new tensors, as the JAX package's `refit_two_level`; `tl`
    is left as it was.  Raises ValueError when K4 cannot walk the
    refitted table.  A frame loop refits in place instead
    (`set_instance`)."""
    tables = ("nodes", "skip_rec") if tl.w8_nodes is None \
        else ("w8_nodes", "w8_rec")
    tl = dataclasses.replace(tl, **{
        k: getattr(tl, k).clone() for k in tables}, **{
        k: torch.as_tensor(m, dtype=torch.float32).to(tl.device, copy=True)
        for k, m in zip(_MATS, (world_from_obj, obj_from_world,
                                normal_mat))})
    out = refit_body(tl)()
    if tl.w8_nodes is None:
        return tl
    depth = int(out[0])
    check_depths(depth, tl.blas_depth)
    return dataclasses.replace(tl, tlas_depth=depth)


def set_instance(tl: TwoLevelFlat, idx: int, world_from_obj,
                 obj_from_world, normal_mat, programs: graphs.Programs,
                 plain: bool = False) -> TwoLevelFlat:
    """Move instance `idx` and refit the TLAS in place: the instance's
    three matrices (numpy (3, 4), (3, 4), (3, 3)) go to `tl`'s own
    tensors in one copy, outside any graph, then `refit_body(tl)`
    replays from `programs` (one capture per table and route), or runs
    op by op where graphs.Programs says so or with `plain`.  The tensors
    keep their addresses, so a frame program captured over `tl` reads
    the refit.  On the BVH8 route the depth is read back, the refit's
    one host sync (4 bytes).  When K4's stack cannot hold the new TLAS,
    the old matrices go back, the refit runs again (the old TLAS, bit
    for bit) and ValueError is raised, so no walk meets the deeper
    table.  Returns `tl`, or a copy with the new tlas_depth where the
    stack K4 needs changed (a frame program over it captures again).
    With tracing on (utils/tracing.py) the row copy is the host span
    `tlas.copy_in` (a copy from pageable memory, which waits for the
    stream), the replay, the depth read and any put-back the span
    `tlas.refit`, and each replay of the refit program the clock
    `refit`."""
    rows = [getattr(tl, k)[idx] for k in _MATS]
    old = torch.cat([r.reshape(-1) for r in rows])

    def put(flat):
        at = 0
        for r in rows:
            r.copy_(flat[at:at + r.numel()].view(r.shape))
            at += r.numel()

    key = ("tlas_refit", tl.w8_nodes is not None, graphs.signature(tl))

    def run():
        with tracing.clock("refit", tl.device):
            return programs(key, refit_body(tl), (), tl.device, eager=plain)

    with tracing.span("tlas.copy_in"):
        put(torch.from_numpy(np.concatenate(
            [np.asarray(m, np.float32).reshape(-1)
             for m in (world_from_obj, obj_from_world, normal_mat)]))
            .to(tl.device))
    with tracing.span("tlas.refit"):
        out = run()
        if tl.w8_nodes is None:
            return tl
        depth = int(out[0])
        try:
            check_depths(depth, tl.blas_depth)
        except ValueError:
            put(old)
            run()
            raise
    if stack_bound(depth, tl.blas_depth) == tl.stack:
        return tl
    return dataclasses.replace(tl, tlas_depth=depth)


def _walk(tl: TwoLevelFlat, plain: bool):
    walk = (traversal_tlas_skip if tl.w8_nodes is None
            else traversal_tlas8)
    return walk.trace_plain if plain else walk.trace


def closest_hit_tlas(tl: TwoLevelFlat, o: V3, d: V3, t_min, t_max,
                     plain: bool = False):
    """(t, tri, inst, u, v) over planar rays: tri is the global pool id
    and inst the instance id (-1 on a miss, t = t_max).  The table's
    walk (K4 for a BVH8 table, K5 for a binary one) runs its kernel on a
    CUDA tensor and its plain version on a CPU tensor; plain=True takes
    the plain version on any device."""
    return _walk(tl, plain)(tl, *intersect.ray_planes(o, d, t_max), float(t_min), True)


def any_hit_tlas(tl: TwoLevelFlat, o: V3, d: V3, t_min, t_max,
                 plain: bool = False) -> torch.Tensor:
    """Occlusion of the segments (t_min, t_max): bool (N,)."""
    return _walk(tl, plain)(tl, *intersect.ray_planes(o, d, t_max), float(t_min), False)


def shade_attrs_tlas(tl: TwoLevelFlat, materials: torch.Tensor, tri_id,
                     inst_id, u, v):
    """Hit attributes of two-level hits: one gather of the pool-order
    attribute table, the normal transformed by the hit instance's
    normal matrix, the material row from the instance's material id.
    Returns (unit normal V3, MatP, the material rows (N, MAT_W), the
    interpolated hit UVs (tu, tv))."""
    rt = tl.attr[tri_id.clamp(min=0).long()].T                 # (15, N)
    w = 1.0 - u - v
    tu = w * rt[9] + u * rt[11] + v * rt[13]
    tv = w * rt[10] + u * rt[12] + v * rt[14]
    n_obj = V3(w * rt[0] + u * rt[3] + v * rt[6],
               w * rt[1] + u * rt[4] + v * rt[7],
               w * rt[2] + u * rt[5] + v * rt[8])
    si = inst_id.clamp(min=0).long()
    nm = tl.normal_mat.reshape(-1, 9)[si].T                     # (9, N)
    normal = v3.normalize(V3(
        nm[0] * n_obj.x + nm[1] * n_obj.y + nm[2] * n_obj.z,
        nm[3] * n_obj.x + nm[4] * n_obj.y + nm[5] * n_obj.z,
        nm[6] * n_obj.x + nm[7] * n_obj.y + nm[8] * n_obj.z))
    mrows = materials[tl.inst_mat[si].long()]                   # (N, MAT_W)
    return normal, MatP.from_rows_t(mrows.T), mrows, (tu, tv)
