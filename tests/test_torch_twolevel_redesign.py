"""The pieces of K4's and K5's card designs, on the CPU: the kernels'
record tables (K5's 32-byte skip-link records `TwoLevelFlat.skip_rec`,
K4's 256-byte wide-node records `TwoLevelFlat.w8_rec`) against the words
of the JAX-layout tables they repack, after a build, after a refit and
through interop; and the counting walks `visit_counts` of both
two-level walks against walks written ray by ray, in both modes and
both orders (the table's, and nearest first), with the nearest-first
walks' closest hits against trace_plain up to equal-t ties.  Small
scenes: the test_tlas scene (four instances of two meshes), past a
lowered wide bound for K5.  The kernels themselves are held to the plain
walks on a card in test_torch_cuda.py."""
import numpy as np
import pytest
import torch

from hrt_tpu_torch.models.instance import MeshInstance
from hrt_tpu_torch.ops import (intersect, tlas, traversal_skip,
                               traversal_tlas8, traversal_tlas_skip)
from hrt_tpu_torch.utils.interop import two_level_from_numpy

from test_torch_cuda import _instanced_scene

T_MIN = 1e-3
WALKS = {"k4": traversal_tlas8, "k5": traversal_tlas_skip}


def _moved(sc):
    """test_tlas's refit: the unit sphere at the origin moves to
    (0, -8, 0)."""
    insts = list(sc.instances)
    cur = insts[1]
    insts[1] = MeshInstance(cur.mesh_id, cur.material_id, (0.0, -8.0, 0.0),
                            cur.rotation, cur.scale)
    return [np.stack([getattr(i, k) for i in insts]).astype(np.float32)
            for k in ("transform", "inverse_transform", "normal_matrix")]


def _as_jax_dict(tl) -> dict:
    """The arrays of a port table in the JAX TwoLevelFlat's layout, as
    two_level_from_numpy takes them."""
    t = tl.tris.shape[0]
    rows = np.zeros((-(-t // 128) * 128, 16), np.float32)
    rows[:t, :12] = tl.tris.numpy()
    d = {"tris": rows.reshape(-1, 128, 16).transpose(0, 2, 1),
         "leaf_size": tl.leaf_size}
    for k in ("attr", "inst_mat", "inst_mesh", "normal_mat",
              "world_from_obj", "obj_from_world", "root_bmin", "root_bmax"):
        d[k] = getattr(tl, k).numpy()
    if tl.w8_nodes is not None:
        d.update(w8_nodes=tl.w8_nodes.numpy(), w8_root=tl.w8_root.numpy(),
                 w8_tlas_nw=tl.w8_tlas_nw)
    else:
        d.update(nodes=tl.nodes.numpy(), blas_base=tl.blas_base.numpy(),
                 blas_end=tl.blas_end.numpy(), tlas_m=tl.tlas_m)
    return d


@pytest.fixture(scope="module")
def tables():
    """Both routes of the test_tlas scene with 8-triangle leaves, as
    built, refit and carried through interop."""
    sc = _instanced_scene()
    out = {}
    for route, bound in (("k4", None), ("k5", 32)):
        tl = tlas.build_two_level_flat(sc, 8, device="cpu",
                                       max_wide_nodes=bound)
        out[route, "built"] = tl
        out[route, "refit"] = tlas.refit_two_level(tl, *_moved(sc))
        out[route, "interop"] = two_level_from_numpy(_as_jax_dict(tl), "cpu")
    return out


@pytest.mark.parametrize("step", ["built", "refit", "interop"])
@pytest.mark.parametrize("route", ["k4", "k5"])
def test_records_repack_the_tables(tables, route, step):
    """K5's row i is node i's 8 words of the (R, 8, 128) skip-link table
    for every row's node (the BLAS rows past the TLAS's padding too);
    K4's row q is wide node q's 8 child records of the (R, 8, 128) BVH8
    table, child j at words 8j..8j+7.  Bit for bit, contiguous, int32."""
    tl = tables[route, step]
    if route == "k5":
        assert tl.w8_rec is None
        n = tl.nodes.shape[0] * 128
        rec = tl.skip_rec
        assert rec.shape == (n, 8) and n > tl.tlas_m
        want = traversal_skip.node_words(tl.nodes, torch.arange(n))
        # Each instance's BLAS range lies in the records.
        assert int(tl.blas_end.max()) <= n
    else:
        assert tl.skip_rec is None
        r = tl.w8_nodes.shape[0]
        rec = tl.w8_rec
        assert rec.shape == (r * 16, 64)
        flat = tl.w8_nodes.reshape(-1)
        q = torch.arange(r * 16)[:, None, None]
        j = torch.arange(8)[None, :, None]
        w = torch.arange(8)[None, None, :]
        want = flat[(q // 16) * 1024 + j * 128 + (q % 16) * 8 + w] \
            .reshape(r * 16, 64)
    assert rec.dtype == torch.int32 and rec.is_contiguous()
    assert torch.equal(rec, want)
    if step == "refit":
        # The refit moved the TLAS's records and left the BLAS's.
        built = tables[route, "built"]
        old = built.skip_rec if route == "k5" else built.w8_rec
        tl_rows = (int(built.blas_base.min()) if route == "k5"
                   else built.w8_tlas_nw)
        assert not torch.equal(rec[:tl_rows], old[:tl_rows])
        assert torch.equal(rec[tl_rows:], old[tl_rows:])


def _slab(box, o, d, t):
    """The plain slab test of one ray: (hit, t_near)."""
    inv = intersect.safe_inv_dir(d[None])
    hit, tn = intersect.slab_near(box[None].view(torch.float32), inv,
                                  o[None] * inv, T_MIN, t[None])
    return bool(hit[0]), float(tn[0])


class _Ray:
    """One ray's walk state: its world ray, active ray, live t, hit and
    counts."""

    def __init__(self, o, d, t_max, closest):
        self.ow, self.dw = o, d
        self.o, self.d = o, d
        self.t = torch.tensor(t_max, dtype=torch.float32)
        self.closest = closest
        self.hit = (-1, -1)
        self.inst = -1
        self.c = {k: 0 for k in ("tlas_nodes", "tlas_boxes", "instances",
                                 "blas_nodes", "blas_boxes", "leaves",
                                 "tests")}

    def enter(self, tl, inst):
        m = tl.obj_from_world.reshape(-1, 12)[inst:inst + 1]
        o, d = intersect.to_object_space(m, self.ow[None], self.dw[None])
        self.o, self.d, self.inst = o[0], d[0], inst
        self.c["instances"] += 1

    def leave(self):
        self.o, self.d = self.ow, self.dw

    def leaf(self, tl, start) -> bool:
        """K tests in slot order; True when an any-hit ray is blocked."""
        self.c["leaves"] += 1
        for k in range(tl.leaf_size):
            self.c["tests"] += 1
            tri = tl.tris[start + k]
            h, th, _, _ = intersect.moller_trumbore(
                self.o, self.d, tri[0:3], tri[3:6], tri[6:9], T_MIN, self.t)
            if bool(h):
                self.hit = (start + k, self.inst)
                if not self.closest:
                    return True
                self.t = th
        return False


def _k5_table_order(tl, ray):
    """K5's walk of one ray in the table's order (skip links)."""
    cur, in_blas, resume, bend = 0, False, 0, 0
    while in_blas or cur < tl.tlas_m:
        w = tl.skip_rec[cur]
        ray.c["blas_nodes" if in_blas else "tlas_nodes"] += 1
        hit, _ = _slab(w[:6], ray.o, ray.d, ray.t)
        code, nxt = int(w[6]), int(w[7])
        if hit and code == 0:
            nxt = cur + 1
        elif hit and code > 0:
            if ray.leaf(tl, code - 1):
                return
        elif hit:
            ray.enter(tl, -code - 1)
            resume, nxt = nxt, int(tl.blas_base[-code - 1])
            bend, in_blas = int(tl.blas_end[-code - 1]), True
        if in_blas and nxt >= bend:
            ray.leave()
            nxt, in_blas = resume, False
        cur = nxt


def _k5_nearest(tl, ray):
    """K5's tables walked nearest first, one ray: a hit internal node's
    children (i + 1 and that child's skip) by entry distance."""
    def test(node, key):
        ray.c[key] += 1
        return _slab(tl.skip_rec[node, :6], ray.o, ray.d, ray.t)

    def visit(node, key) -> bool:
        code = int(tl.skip_rec[node, 6])
        if code > 0:
            return ray.leaf(tl, code - 1)
        if code < 0:
            ray.enter(tl, -code - 1)
            root = int(tl.blas_base[-code - 1])
            hit, tn = test(root, "blas_nodes")
            blocked = hit and visit(root, "blas_nodes")
            ray.leave()
            return blocked
        kids = [node + 1, int(tl.skip_rec[node + 1, 7])]
        hits = [(test(k, key), k) for k in kids]
        order = sorted((tn, i) for i, ((h, tn), _) in enumerate(hits) if h)
        for tn, i in order:
            if (not ray.closest or tn <= float(ray.t)) \
                    and visit(hits[i][1], key):
                return True
        return False

    hit, _ = test(0, "tlas_nodes")
    if hit:
        visit(0, "tlas_nodes")


def _k4_children(tl, node):
    """(box words (8, 6), metas (8,), first child) of wide node `node`."""
    rec = tl.w8_rec[node].reshape(8, 8)
    return rec[:, :6], rec[:, 6].tolist(), int(rec[0, 7])


def _k4_table_order(tl, ray):
    """K4's walk of one ray in the plain walk's order: a node's children
    in slot order (every box tested, also after an any-hit ray's
    retiring leaf), leaves tested as met, then its instances (closest:
    from the last slot, the top of the JAX kernel's stack; any hit: from
    the first, as the any-hit kernel), then its internal children in rank
    order, depth first."""
    def visit(node) -> bool:
        in_tlas = node < tl.w8_tlas_nw
        key = "tlas" if in_tlas else "blas"
        ray.c[key + "_nodes"] += 1
        boxes, metas, first = _k4_children(tl, node)
        inner, insts = [], []
        ray.c[key + "_boxes"] += (metas + [0]).index(0)
        for j, meta in enumerate(metas):
            if meta == 0:
                break
            hit, _ = _slab(boxes[j], ray.o, ray.d, ray.t)
            if not hit:
                continue
            if meta < 0:
                inner.append(first - meta - 1)
            elif in_tlas:
                insts.append(meta - 1)
            elif ray.leaf(tl, meta - 1):
                return True
        for inst in (reversed(insts) if ray.closest else insts):
            ray.enter(tl, inst)
            blocked = visit(int(tl.w8_root[inst, 0]))
            ray.leave()
            if blocked:
                return True
        return any(visit(c) for c in sorted(inner))

    visit(0)


def _k4_nearest(tl, ray):
    """K4's table walked nearest first, one ray: a node's hit children
    (internal nodes, BLAS leaves, TLAS instances) by entry distance, ties
    in slot order; an entry past the live t is dropped untested."""
    def visit(node) -> bool:
        in_tlas = node < tl.w8_tlas_nw
        key = "tlas" if in_tlas else "blas"
        ray.c[key + "_nodes"] += 1
        boxes, metas, first = _k4_children(tl, node)
        hits = []
        for j, meta in enumerate(metas):
            if meta == 0:
                break
            ray.c[key + "_boxes"] += 1
            hit, tn = _slab(boxes[j], ray.o, ray.d, ray.t)
            if hit:
                hits.append((tn, j, meta))
        for tn, j, meta in sorted(hits):
            if ray.closest and tn > float(ray.t):
                continue
            if meta < 0:
                blocked = visit(first - meta - 1)
            elif in_tlas:
                ray.enter(tl, meta - 1)
                blocked = visit(int(tl.w8_root[meta - 1, 0]))
                ray.leave()
            else:
                blocked = ray.leaf(tl, meta - 1)
            if blocked:
                return True
        return False

    visit(0)


WALK_ONE = {("k5", False): _k5_table_order, ("k5", True): _k5_nearest,
            ("k4", False): _k4_table_order, ("k4", True): _k4_nearest}


def _batch(closest, n=48):
    rs = np.random.RandomState(21 if closest else 22)
    o = rs.uniform(-6, 6, (n, 3)).astype(np.float32)
    d = rs.uniform(-2, 2, (n, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.full(n, 1e32 if closest else 4.0, np.float32)
    tmax[::7] = -1.0                                    # dead rays
    return [torch.as_tensor(np.ascontiguousarray(a))
            for a in (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
                      tmax)]


@pytest.mark.parametrize("nearest", [False, True], ids=["table", "nearest"])
@pytest.mark.parametrize("closest", [True, False], ids=["closest", "any"])
@pytest.mark.parametrize("route", ["k4", "k5"])
def test_visit_counts_match_a_walk_ray_by_ray(tables, route, closest,
                                              nearest):
    """Every count of every ray, and the hits, as one ray's walk in the
    same order gives them; the nearest-first walk's closest hits and
    occlusion equal trace_plain's up to equal-t ties."""
    tl = tables[route, "built"]
    walk = WALKS[route]
    planes = _batch(closest)
    got = walk.visit_counts(tl, *planes, T_MIN, closest, nearest=nearest)
    hits = got.pop("hits")
    assert set(got) == set(walk.COUNTS)
    rays = []
    for i in range(planes[0].shape[0]):
        ray = _Ray(torch.stack([p[i] for p in planes[:3]]),
                   torch.stack([p[i] for p in planes[3:6]]),
                   float(planes[6][i]), closest)
        if planes[6][i] >= 0:
            WALK_ONE[route, nearest](tl, ray)
        rays.append(ray)
    for key in walk.COUNTS:
        assert got[key].dtype == torch.int64
        np.testing.assert_array_equal(got[key].numpy(),
                                      [r.c[key] for r in rays], key)
    assert (got["tests"][::7] == 0).all()
    assert got["leaves"].sum() > (20 if closest else 5)
    ref = walk.trace_plain(tl, *planes, T_MIN, closest)
    if closest:
        t, tri, inst = hits[0], hits[1], hits[2]
        assert tri.tolist() == [r.hit[0] for r in rays]
        assert inst.tolist() == [r.hit[1] for r in rays]
        torch.testing.assert_close(t, torch.stack([r.t for r in rays]),
                                   rtol=0, atol=0)
        same = (tri == ref[1]) & (inst == ref[2])
        tie = torch.isclose(t, ref[0], rtol=1e-6, atol=0)
        assert bool((same | tie).all()) and bool((t == ref[0]).all())
        assert (tri >= 0).float().mean() > 0.2
    else:
        assert hits.tolist() == [r.hit[0] >= 0 for r in rays]
        assert torch.equal(hits, ref)
        assert 0.1 < hits.float().mean() < 0.9
        # Some rays stop inside their last leaf.
        assert (got["tests"] < tl.leaf_size * got["leaves"]).any()
