"""The port's device-side builds on the CPU: the TLAS refit (both routes)
and the culling LBVH rebuild as capturable bodies, against the JAX
package's jitted `refit_two_level`, `_world_aabbs` and `build_bvh`.

- `tlas.world_aabbs` in torch bit for bit as JAX's `_world_aabbs`;
- the radix tree's fixed sweep count (`lbvh.sweep_bound`) against JAX's
  64 sweeps on trees as deep as the bound allows, and one sweep short of
  the depth missing the fixed point; a wide tree deeper than its sweeps
  reading as too deep;
- the refit program through a loop's build `Programs` with
  test_torch_frame_graph's `StandIn` capture, after three moves, against
  JAX's refit bit for bit on the BVH8 (K4) and binary (K5) routes, one
  capture in all; a refit that K4 cannot walk raises with the tables as
  they were;
- the culled loop's in-place rebuild against a fresh `build_bvh` and
  JAX's `build_bvh` over the same mask on each of three orbit rebuilds,
  one frame capture and one build capture, its frames bit for bit the
  op-by-op loop's;
- the refit and rebuild bodies under a guard that raises on every host
  sync and host copy they could make.

The JAX wide TLAS itself is held in test_torch_tlas.py
(test_build_wide8_tlas_bit_equal); the card's programs against their
bodies op by op are in test_torch_cuda.py and chip_smoke.py phase 48.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrt_tpu.ops import lbvh as jlbvh, tlas as jtlas
from hrt_tpu_torch import graphs
from hrt_tpu_torch.config import RenderConfig
from hrt_tpu_torch.frameloop import FrameLoop
from hrt_tpu_torch.models.camera import Camera, orbit_camera
from hrt_tpu_torch.models.instance import MeshInstance
from hrt_tpu_torch.ops import culling, lbvh, tlas, traversal_tlas8, wide8

from test_tlas import _instanced_scene
from test_torch_culling import FRAME, orbit, small_instances_scene
from test_torch_frame_graph import StandIn
from test_torch_native import jax_native_lib
from test_torch_tlas import CAM, port_scene


@pytest.fixture(scope="module", autouse=True)
def _jax_native_sah():
    """JAX's build_bvh_sah through its native builder, never the LBVH
    fallback (test_torch_native.jax_native_lib)."""
    jax_native_lib()


@pytest.fixture
def one_thread():
    """Torch on one thread for a frame loop's test: its many mid-sized
    CPU ops spin in OpenMP when the suite's workers share the cores (the
    culled loop's test took ~380 s of a six-worker run on eight cores,
    ~15 s on one thread beside seven busy cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _eq(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit (the tables hold int32 words in float32 lanes, some of
    them NaN patterns)."""
    bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t
    return torch.equal(bits(a), bits(b))


def _same(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, what
    np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=what)


def test_world_aabbs_bit_equal_to_jax():
    """37 seeded object boxes through rotated, scaled, translated 3x4
    transforms (the port's MeshInstance matrices)."""
    rs = np.random.RandomState(21)
    n = 37
    lo = rs.uniform(-2, 0, (n, 3)).astype(np.float32)
    hi = lo + rs.uniform(0.01, 3, (n, 3)).astype(np.float32)
    m = np.stack([MeshInstance(0, 0, tuple(rs.uniform(-9, 9, 3)),
                               tuple(rs.uniform(-3, 3, 3)),
                               tuple(rs.uniform(0.1, 4, 3))).transform
                  for _ in range(n)]).astype(np.float32)
    want = jtlas._world_aabbs(*map(jnp.asarray, (lo, hi, m)))
    got = tlas.world_aabbs(*map(torch.as_tensor, (lo, hi, m)))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _same(g.numpy(), w)


def _keys(kind: str) -> np.ndarray:
    """Sorted uint32 leaf keys.  "chain": 0, 1, 2, 4, ... 2^31 and the
    culled key 0xFFFFFFFF, each four times: every distinct-key split
    peels one key, then the index tiebreak adds two levels, 34 internal
    levels of a bound of 40.  "random": 300 seeded codes with a run of
    duplicates."""
    if kind == "chain":
        k = np.asarray([0] + [1 << j for j in range(32)] + [0xFFFFFFFF],
                       np.uint64)
        return np.repeat(k, 4).astype(np.uint32)
    k = np.sort(np.random.RandomState(8).randint(0, 1 << 30, 300)
                .astype(np.uint32))
    k[40:60] = k[40]
    return k


def _depth(cl: np.ndarray, cr: np.ndarray) -> int:
    """Internal nodes on the longest root-to-leaf path."""
    depth, best, todo = {0: 1}, 1, [0]
    while todo:
        i = todo.pop()
        for c in (cl[i], cr[i]):
            if c >= 0:
                depth[c] = depth[i] + 1
                best = max(best, depth[c])
                todo.append(c)
    return best


@pytest.mark.parametrize("kind", ["chain", "random"])
def test_fixed_sweeps_reach_jax_fixed_point(kind):
    """`refit` and `flatten_bvh` at lbvh.sweep_bound sweeps against
    JAX's at 64 (a fixed point) and flatten_bvh's early exit at the
    fixed point (sweeps=None), bit for bit; the tree is within the
    bound, and flatten_bvh one sweep short of its depth differs."""
    keys = _keys(kind)
    n = keys.shape[0]
    rs = np.random.RandomState(n)
    lo = rs.uniform(-5, 5, (n, 3)).astype(np.float32)
    hi = lo + rs.uniform(0.1, 1, (n, 3)).astype(np.float32)
    jcl, jcr = jlbvh.karras_hierarchy(jnp.asarray(keys))
    cl, cr = lbvh.karras_hierarchy(torch.as_tensor(keys.astype(np.int64)))
    _same(cl.numpy(), jcl)
    _same(cr.numpy(), jcr)
    depth = _depth(cl.numpy(), cr.numpy())
    assert depth <= lbvh.sweep_bound(n)
    if kind == "chain":
        assert depth == 34 and lbvh.sweep_bound(n) == 40
    jboxes = jlbvh.refit(jcl, jcr, jnp.asarray(lo), jnp.asarray(hi))
    boxes = lbvh.refit(cl, cr, torch.as_tensor(lo), torch.as_tensor(hi))
    for a, b in zip(boxes, jboxes):
        _same(a.numpy(), b)
    jtree = jlbvh.BVH(child_l=jcl, child_r=jcr, bmin_l=jboxes[0],
                      bmax_l=jboxes[1], bmin_r=jboxes[2], bmax_r=jboxes[3],
                      tri_v0=jnp.zeros((128, 3)), tri_e1=jnp.zeros((128, 3)),
                      tri_e2=jnp.zeros((128, 3)),
                      tri_perm=jnp.zeros((128,), jnp.int32))
    want = jlbvh.flatten_bvh(jtree, jnp.asarray(lo), jnp.asarray(hi),
                             1).nodes
    flat = lambda s: lbvh.flatten_bvh(cl, cr, *boxes, torch.as_tensor(lo),
                                      torch.as_tensor(hi), 1, s)
    _same(flat(lbvh.sweep_bound(n)).numpy(), want)
    _same(flat(None).numpy(), want)
    assert not _eq(flat(depth - 1), flat(depth))


def test_wide_depth_past_the_sweeps_reads_too_deep():
    """A binary chain of 60 internal nodes (wide depth 19, deeper than
    any radix tree of 61 keys): with the radix tree's wide sweeps the
    depth reads _BIG_D, which K4's stack check refuses; with JAX's 24 it
    reads 19, the records' depth."""
    ni = 60
    cl = torch.arange(ni) * -1 - 1                     # leaf k
    cr = torch.where(torch.arange(ni) < ni - 1, torch.arange(1, ni + 1),
                     -(ni + 1))
    sweeps = wide8.wide_sweeps(ni + 1)
    assert sweeps < 19
    deep = wide8._flags_and_ids(cl, cr, sweeps)[3]
    assert int(deep) == wide8._BIG_D
    with pytest.raises(ValueError, match="K4 holds"):
        tlas.check_depths(int(deep), 0)
    flags, _, _, deep = wide8._flags_and_ids(cl, cr, 24)
    assert int(deep) == 19 and int(flags.sum()) == 20


def _mats(instances) -> list:
    return [np.stack([getattr(i, k) for i in instances]).astype(np.float32)
            for k in ("transform", "inverse_transform", "normal_matrix")]


# Three moves of one instance each: (index, position, rotation, scale).
MOVES = [(1, (0.0, -8.0, 0.0), (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)),
         (2, (0.5, 2.0, -3.0), (0.4, -0.2, 1.3), (0.6, 1.5, 0.6)),
         (1, (2.0, 0.1, 2.5), (1.0, 0.5, 0.0), (0.3, 0.3, 0.3))]


@pytest.fixture(scope="module")
def jax_refits():
    """JAX's two-level table of test_tlas's four instances after each of
    MOVES: its refit_two_level with jit disabled (the compiles of it and
    the TLAS builds inside cost ~30 s of one core here, op by op ~18).
    Both routes' TLAS are rebuilt by every JAX refit.  The table it
    starts from is
    the port's build of both routes as a JAX TwoLevelFlat (JAX's own
    build costs ~45 s of one core here, and test_torch_tlas holds the
    port's build bit-equal to it); the refit recomputes the TLAS rows
    and the instance records and carries the rest."""
    sc = port_scene(_instanced_scene())
    w8 = tlas.build_two_level_flat(sc, 32, device="cpu")
    bi = tlas.build_two_level_flat(sc, 32, device="cpu", max_wide_nodes=32)
    j = lambda t: jnp.asarray(t.numpy())
    jt = jtlas.TwoLevelFlat(
        nodes=j(bi.nodes), tris=jnp.zeros((1, 16, 128), jnp.float32),
        inst=jnp.zeros((1, 16, 128), jnp.float32), attr=j(w8.attr),
        **{k: j(getattr(w8, k)) for k in (
            "inst_mat", "inst_mesh", "normal_mat", "world_from_obj",
            "obj_from_world", "root_bmin", "root_bmax")},
        blas_base=j(bi.blas_base), blas_end=j(bi.blas_end),
        tlas_m=bi.tlas_m, leaf_size=32, w8_nodes=j(w8.w8_nodes),
        w8_root=j(w8.w8_root), w8_tlas_nw=w8.w8_tlas_nw)
    insts = list(sc.instances)
    out = []
    for idx, pos, rot, scale in MOVES:
        cur = insts[idx]
        insts[idx] = MeshInstance(cur.mesh_id, cur.material_id, pos, rot,
                                  scale)
        with jax.disable_jit():
            jt = jtlas.refit_two_level(jt, *map(jnp.asarray, _mats(insts)))
        out.append(jt)
    return out


@pytest.mark.parametrize("route", ["bvh8", "binary"])
def test_refit_program_matches_jax(jax_refits, route, one_thread):
    """An animated two-level loop at 32x24 on both routes: each
    set_instance_transform replays the loop's refit program (StandIn
    capture), the tables and matrices after it bit for bit JAX's, the
    wide depth the records' depth; one build capture and one frame
    capture in all, the frames the op-by-op loop's bit for bit."""
    max_wide = None if route == "bvh8" else 32
    loops = {}
    for side in ("graph", "eager"):
        lp = FrameLoop(port_scene(_instanced_scene()),
                       RenderConfig(width=32, height=24, max_depth=1,
                                    sky=True), two_level=True, device="cpu")
        if max_wide is not None:
            lp.accel = tlas.build_two_level_flat(lp.scene_obj, 32,
                                                 device="cpu",
                                                 max_wide_nodes=max_wide)
        lp.program = graphs.Programs(1, capture=StandIn)
        lp.builds = graphs.Programs(1, capture=StandIn)
        loops[side] = lp
    replays = StandIn.replays
    for (idx, pos, rot, scale), jt in zip(MOVES, jax_refits):
        for side, lp in loops.items():
            with (graphs.disable() if side == "eager"
                  else contextlib.nullcontext()):
                lp.set_instance_transform(idx, position=pos, rotation=rot,
                                          scale=scale)
        tl = loops["graph"].accel
        for k in ("world_from_obj", "obj_from_world", "normal_mat"):
            _same(getattr(tl, k).numpy(), getattr(jt, k), k)
        if route == "bvh8":
            _same(tl.w8_nodes.numpy(), jt.w8_nodes)
            _same(tl.w8_rec.numpy(),
                  wide8.node_records(torch.as_tensor(
                      np.asarray(jt.w8_nodes))).numpy())
            depth = wide8.node_depths(np.asarray(jt.w8_nodes))
            assert tl.tlas_depth == int(depth[:tl.w8_tlas_nw].max())
        else:
            _same(tl.nodes.numpy(), jt.nodes)
            _same(tl.skip_rec.numpy(), tlas._skip_rec(
                torch.tensor(np.asarray(jt.nodes))).numpy())
        with graphs.disable():
            want = loops["eager"].step(Camera(**CAM))
        assert torch.equal(loops["graph"].step(Camera(**CAM)), want)
    g = loops["graph"]
    assert g.builds.captures == 1 and g.captures == 1
    assert StandIn.replays > replays
    assert loops["eager"].builds.captures == 0


def test_refit_k4_cannot_walk_raises_with_tables_as_they_were(monkeypatch):
    """A refit whose TLAS needs a deeper stack than K4 holds raises
    ValueError before any walk, and leaves the instance, its matrices
    and the tables as they were: the loop's set_instance_transform,
    tlas.set_instance through a program of its own (StandIn capture),
    and refit_two_level (new tables)."""
    loop = FrameLoop(port_scene(_instanced_scene()),
                     RenderConfig(width=32, height=24, max_depth=1,
                                  sky=True), two_level=True, device="cpu")
    tl = loop.accel
    before = {k: getattr(tl, k).clone() for k in (
        "w8_nodes", "w8_rec", "world_from_obj", "obj_from_world",
        "normal_mat")}
    pos = loop.scene_obj.instances[1].position
    monkeypatch.setattr(traversal_tlas8, "MAX_STACK", tl.stack - 1)
    with pytest.raises(ValueError, match="K4 holds"):
        loop.set_instance_transform(1, position=(0.0, -8.0, 0.0))
    moved = list(loop.scene_obj.instances)
    moved[2] = MeshInstance(0, 0, (1.0, 2.0, 3.0))
    progs = graphs.Programs(1, capture=StandIn)
    with pytest.raises(ValueError, match="K4 holds"):
        tlas.set_instance(tl, 2, *[m[2] for m in _mats(moved)],
                          programs=progs)
    assert progs.captures == 1
    with pytest.raises(ValueError, match="K4 holds"):
        tlas.refit_two_level(tl, *_mats(moved))
    assert loop.accel is tl and loop.scene_obj.instances[1].position == pos
    for k, v in before.items():
        assert _eq(getattr(tl, k), v), k


def test_culled_rebuild_in_place_matches_fresh_build_and_jax(one_thread):
    """The culled loop of test_torch_culling over three orbit frames at
    64x48, each rebuilding: frame 0 replaces the SAH accel, frames 1 and
    2 rebuild it in place from the loop's build program (StandIn
    capture).  After each: the accel's tensors keep their addresses and
    equal a fresh build_bvh over the same mask bit for bit; after the
    last, JAX's build_bvh too (run with jit disabled: its compile alone
    costs ~18 s of one core, and test_torch_lbvh holds build_bvh to
    JAX's jitted one with a mask); the frames equal an op-by-op loop's;
    one frame capture and one build capture in all."""
    js = small_instances_scene().build()
    loops = {}
    for side in ("graph", "eager"):
        lp = FrameLoop(port_scene(small_instances_scene()),
                       RenderConfig(**FRAME), device="cpu")
        lp.program = graphs.Programs(1, capture=StandIn)
        lp.builds = graphs.Programs(1, capture=StandIn)
        loops[side] = lp
    g = loops["graph"]
    ptrs = None
    for f in range(3):
        cam = orbit_camera(**orbit(f))
        with graphs.disable():
            want = loops["eager"].step(cam)
        assert torch.equal(g.step(cam), want)
        assert g.rebuilds == f + 1 and g.accel.w8 is None
        addr = [getattr(g.accel, k).data_ptr() for k in lbvh._REBUILT]
        ptrs = ptrs or addr
        assert addr == ptrs
        mask = culling.triangle_mask(g.visible, g.scene.tri_inst,
                                     g.scene.tri_valid)
        fresh = lbvh.build_bvh(g.scene, g.leaf_size, mask)
        for k in lbvh._REBUILT:
            assert _eq(getattr(g.accel, k), getattr(fresh, k)), k
    with jax.disable_jit():
        ja = jlbvh.build_bvh(js, leaf_size=g.leaf_size,
                             tri_mask=jnp.asarray(mask.numpy()))
    for k in ("tri_v0", "tri_e1", "tri_e2", "tri_perm"):
        _same(getattr(g.accel, k).numpy(), getattr(ja.tree, k), k)
    _same(g.accel.attr.numpy(), ja.attr)
    _same(g.accel.nodes.numpy(), ja.flat.nodes)
    assert g.captures == 1 and g.builds.captures == 1
    assert not g.visible.all() and g.visible.any()


def _tables_and_lbvh():
    """A two-level table of each route and an LBVH accel with a mask."""
    sc = port_scene(_instanced_scene())
    tables = [tlas.build_two_level_flat(sc, 32, device="cpu"),
              tlas.build_two_level_flat(sc, 32, device="cpu",
                                        max_wide_nodes=32)]
    scene = port_scene(small_instances_scene()).build("cpu")
    mask = torch.as_tensor(np.random.RandomState(2).rand(
        scene.tri_v0.shape[0]) < 0.5)
    return tables, scene, lbvh.build_bvh(scene, 32), mask


def _refuse(name):
    def refuse(*a, **k):
        raise AssertionError(f"host sync or host copy: {name}")
    return refuse


def test_bodies_make_no_host_sync(monkeypatch):
    """The refit bodies (both routes) and the rebuild body under a guard
    that raises on torch.equal, .item(), .cpu(), .numpy(), .tolist(),
    a tensor's bool / int / float, torch.as_tensor / torch.tensor /
    torch.from_numpy of host data, a Python number stored through
    indexing, nonzero and boolean-mask indexing (each reads the device
    or copies from the host, which a capture refuses).  The bodies' writes
    are checked against the same bodies run without the guard."""
    tables, scene, accel, mask = _tables_and_lbvh()
    refs = [dataclasses.replace(t, **{k: getattr(t, k).clone() for k in (
        "nodes", "skip_rec", "w8_nodes", "w8_rec") if getattr(t, k)
        is not None}) for t in tables]
    for t in refs:
        tlas.refit_body(t)()
    ref_accel = dataclasses.replace(accel, **{
        k: getattr(accel, k).clone() for k in lbvh._REBUILT})
    lbvh.rebuild_body(ref_accel, scene)(mask)

    as_tensor, getitem, setitem = (torch.as_tensor, torch.Tensor.__getitem__,
                                   torch.Tensor.__setitem__)

    def no_host(x, *a, **k):
        if not isinstance(x, torch.Tensor):
            raise AssertionError("host sync or host copy: torch.as_tensor")
        return as_tensor(x, *a, **k)

    def no_mask(index):
        idx = index if isinstance(index, tuple) else (index,)
        if any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
               for i in idx):
            raise AssertionError("host sync: boolean-mask indexing")

    def get(self, index):
        no_mask(index)
        return getitem(self, index)

    def put(self, index, value):
        no_mask(index)
        if not isinstance(value, torch.Tensor):
            raise AssertionError("host copy: a Python number stored "
                                 "through indexing")
        return setitem(self, index, value)

    for name in ("equal", "nonzero", "tensor", "from_numpy",
                 "masked_select"):
        monkeypatch.setattr(torch, name, _refuse(f"torch.{name}"))
    for name in ("item", "cpu", "numpy", "tolist", "nonzero", "__bool__",
                 "__int__", "__float__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, _refuse(f"Tensor.{name}"))
    monkeypatch.setattr(torch, "as_tensor", no_host)
    monkeypatch.setattr(torch.Tensor, "__getitem__", get)
    monkeypatch.setattr(torch.Tensor, "__setitem__", put)
    with pytest.raises(AssertionError, match="Tensor.item"):
        torch.ones(()).item()
    outs = [tlas.refit_body(t)() for t in tables]
    lbvh.rebuild_body(accel, scene)(mask)
    monkeypatch.undo()

    assert outs[0][0].dim() == 0 and outs[1] == ()
    for t, r in zip(tables, refs):
        for k in ("nodes", "skip_rec", "w8_nodes", "w8_rec"):
            if getattr(t, k) is not None:
                assert _eq(getattr(t, k), getattr(r, k)), k
    for k in lbvh._REBUILT:
        assert _eq(getattr(accel, k), getattr(ref_accel, k)), k
