"""The port's programs over a process group (hrt_tpu_torch/graphs.py with
parallel/tiles.py, parallel/scene_shard.py and models/upscaler.py) and
the stacked two-level trace (ops/twolevel.py) on the CPU, in a one-rank
gloo group on a file store.

Gloo cannot be captured on the card, so the programs run here through a
stand-in capture that declares gloo among its backends (`GlooStandIn`,
test_torch_frame_graph's StandIn: the body runs at capture and at every
replay).  That checks the runner's keys and bookkeeping over a group and
holds each replayed program against JAX's:
- FrameLoop(mesh) with the post stages: one capture over 3 steps, bit
  for bit the same loop op by op, and JAX's FrameLoop(mesh=jtiles.
  make_mesh(1)) at the post-loop tests' PSNR > 45 (peak 4).
- render_frame_tiled: one capture per key; a new config, and another
  group, capture again.
- closest_hit_sharded: ids equal to JAX's, t within rtol 1e-6.
- trace_two_level: JAX's at test_torch_twolevel's tolerances, its body
  reading nothing back from the device while it is captured.
- the data-parallel spatial and temporal steps: the same steps op by op.
- The plain StandIn (no backends): a gloo group runs op by op.
- A capture that meets no communicator raises; a group made anew
  captures anew; the signatures of a mesh and of a group.

The card's graphs over a one-rank NCCL group are in test_torch_cuda.py.
"""
import contextlib

import numpy as np
import jax
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

import bench
from hrt_tpu.config import RenderConfig as JRenderConfig
from hrt_tpu.frameloop import FrameLoop as JFrameLoop
from hrt_tpu.models.camera import Camera as JCamera
from hrt_tpu.ops import twolevel as jtwolevel
from hrt_tpu.parallel import scene_shard as jscene_shard, tiles as jtiles
from hrt_tpu_torch import graphs, renderer
from hrt_tpu_torch.config import RenderConfig
from hrt_tpu_torch.frameloop import FrameLoop
from hrt_tpu_torch.models import upscaler
from hrt_tpu_torch.models.camera import Camera
from hrt_tpu_torch.models.scene import bench_scene
from hrt_tpu_torch.ops import lbvh, traversal_skip, twolevel
from hrt_tpu_torch.parallel import scene_shard, tiles
from hrt_tpu_torch.utils.interop import scene_from_numpy

from test_scene_shard import build_scene, rays
from test_torch_build import jax_scene_dict
from test_torch_frame_graph import StandIn
from test_torch_native import jax_native_lib
from test_torch_path import _psnr4
from test_torch_post import cam_at, committed_npz, flax_params
from test_torch_tlas import port_scene
from test_twolevel import make_scene, rays as tl_rays

# The post loop's frames against JAX's: the gate of the port's post-loop
# parity tests (tests/test_torch_post_loop.py, test_torch_frame_graph.py),
# bf16 upscaler trunks on both sides.
POST_PSNR = 45.0
SMALL = dict(width=64, height=48, sky=True, traversal="bvh",
             shade_pallas=False)
POST = dict(max_depth=1, jitter=True, accumulate=True, denoise=True,
            upscale=2, upscale_mode="temporal")
BENCH_CAM = dict(position=(0.0, -1.0, -6.0), rotation=(-0.15, 0.0, 0.0))
STEPS = 3


class GlooStandIn(StandIn):
    """The frame-graph stand-in, declaring that it holds gloo groups."""

    backends = frozenset({"gloo"})


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Torch on one thread: these small frames and steps spin in OpenMP
    when the suite's workers share the cores (the file took ~377 s of
    one worker in a six-worker run on eight cores, ~50 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _jax_native_sah():
    """JAX's build_bvh_sah through its native builder, as the port's
    frame loop builds (test_torch_native.jax_native_lib)."""
    jax_native_lib()


@pytest.fixture
def mesh(tmp_path, monkeypatch):
    """A one-rank gloo group on a file store and its "tiles" mesh, the
    module-level program caches swapped for stand-in ones; the group
    destroyed after the test."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    for mod, name in ((tiles, "TILED_PROGRAMS"),
                      (scene_shard, "SHARD_PROGRAMS"),
                      (twolevel, "TRACE_PROGRAMS"),
                      (upscaler, "TRAIN_PROGRAMS")):
        monkeypatch.setattr(mod, name, graphs.Programs(4,
                                                       capture=GlooStandIn))
    mesh = tiles.make_mesh(1, device="cpu")
    yield mesh
    dist.destroy_process_group()


# ---- (a) FrameLoop(mesh) -----------------------------------------------

@pytest.fixture(scope="module")
def jax_mesh_frames():
    """JAX's FrameLoop over its one-device "tiles" mesh: STEPS post
    frames of a moving camera."""
    loop = JFrameLoop(bench.build_bench_scene(),
                      JRenderConfig(**SMALL, **POST),
                      upscaler_params=flax_params("temporal"),
                      mesh=jtiles.make_mesh(1))
    return [np.asarray(loop.step(cam_at(f, JCamera))) for f in range(STEPS)]


def _mesh_loop(mesh, capture):
    loop = FrameLoop(bench_scene(), RenderConfig(**SMALL, **POST),
                     upscaler_params=committed_npz("temporal"), mesh=mesh)
    loop.program = graphs.Programs(1, capture=capture)
    return loop


def _state(loop) -> list:
    return [*loop.dn_state, loop.accum, loop.up_history]


def test_mesh_loop_captures_once_and_matches_op_by_op_and_jax(
        mesh, jax_mesh_frames):
    """One capture over 3 post steps; each frame and the loop's state bit
    for bit the same mesh loop op by op (graphs.disable()); each frame
    at PSNR > POST_PSNR against JAX's FrameLoop(mesh)."""
    graphed, eager = (_mesh_loop(mesh, GlooStandIn) for _ in range(2))
    replays = StandIn.replays
    for f in range(STEPS):
        got = graphed.step(cam_at(f))
        with graphs.disable():
            want = eager.step(cam_at(f))
        assert got.shape == (96, 128, 3) and torch.isfinite(got).all()
        assert torch.equal(got, want)
        assert all(torch.equal(a, b) for a, b in zip(_state(graphed),
                                                     _state(eager)))
        assert _psnr4(got.numpy(), jax_mesh_frames[f]) > POST_PSNR
    assert graphed.captures == 1 and eager.captures == 0
    assert StandIn.replays == replays + STEPS - 1
    key = next(iter(graphed.program._cache))
    assert graphs.signature(mesh) in key[0]


# ---- (b) render_frame_tiled ---------------------------------------------

def test_tiled_frame_captures_once_per_key(mesh):
    """Captured once per config, want_gbuffer and group; each call the
    frame op by op, bit for bit, and the whole frame's rows."""
    progs = tiles.TILED_PROGRAMS
    scene = bench_scene().build("cpu")
    accel = lbvh.build_bvh_sah(scene, leaf_size=32)
    cfg = RenderConfig(width=64, height=48, max_depth=1, sky=True,
                       jitter=True)
    cams = renderer.camera_arrays(Camera(**BENCH_CAM), cfg, "cpu")

    def frame(f, config=cfg, m=mesh, gb=False):
        got = tiles.render_frame_tiled(scene, accel, cams, f, config, m,
                                       want_gbuffer=gb)
        with graphs.disable():
            want = tiles.render_frame_tiled(scene, accel, cams, f, config, m,
                                            want_gbuffer=gb)
        img = got[0] if gb else got
        assert torch.equal(img, want[0] if gb else want)
        if gb:
            assert all(torch.equal(got[1][k], want[1][k]) for k in want[1])
        return img

    for f in range(3):
        img = frame(f)
        assert torch.equal(img, renderer.render_rows(scene, accel, cams, 0,
                                                     48, cfg, frame=f))
    assert progs.captures == 1
    frame(0, gb=True)
    assert progs.captures == 2
    frame(1, config=RenderConfig(width=64, height=48, max_depth=2, sky=True))
    assert progs.captures == 3
    other = DeviceMesh.from_group(dist.new_group([0]), "cpu",
                                  mesh_dim_names=("tiles",))
    assert graphs.signature(other) != graphs.signature(mesh)
    frame(2, m=other)
    frame(1, m=other)
    assert progs.captures == 4
    frame(1)
    assert progs.captures == 4


# ---- (c) closest_hit_sharded ---------------------------------------------

def test_sharded_hits_replayed_match_jax(mesh):
    """One shard per rank: the replayed program's ids equal JAX's
    closest_hit_sharded over its one-device mesh, t within rtol 1e-6;
    one capture, the second call a replay."""
    js = build_scene()
    jsharded, jacc = jscene_shard.build_sharded_accel(js, 1, leaf_size=8)
    smesh = jax.sharding.Mesh(jtiles.make_mesh(1).devices, ("shards",))
    o, d = rays()
    jt, jtri, ju, jv = (np.asarray(a) for a in jscene_shard
                        .closest_hit_sharded(jsharded, jacc, o, d, smesh,
                                             leaf_size=8))
    ts = scene_from_numpy(jax_scene_dict(js), "cpu")
    sharded, accs = scene_shard.build_sharded_accel(ts, 1, leaf_size=8)
    to, td = torch.tensor(np.asarray(o)), torch.tensor(np.asarray(d))
    for _ in range(2):
        t, tri, u, v = (x.numpy() for x in scene_shard.closest_hit_sharded(
            sharded, accs, to, td, mesh, leaf_size=8))
        np.testing.assert_array_equal(tri, jtri)
        assert (tri >= 0).mean() > 0.3
        np.testing.assert_allclose(t, jt, rtol=1e-6)
        hit = tri >= 0
        np.testing.assert_allclose(u[hit], ju[hit], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(v[hit], jv[hit], rtol=1e-5, atol=1e-5)
    assert scene_shard.SHARD_PROGRAMS.captures == 1


# ---- (d) trace_two_level -------------------------------------------------

@contextlib.contextmanager
def _no_host_reads():
    """Tensor.tolist / item / cpu / numpy, and torch.tensor /
    torch.as_tensor of host data, raise inside the block."""
    saved = {n: getattr(torch.Tensor, n) for n in ("tolist", "item", "cpu",
                                                   "numpy")}
    tensor, as_tensor = torch.tensor, torch.as_tensor

    def refuse(name):
        def f(*a, **k):
            raise AssertionError(f"host read or host copy: {name}")
        return f

    def no_host(x, *a, **k):
        if not isinstance(x, torch.Tensor):
            raise AssertionError("host copy: torch.as_tensor")
        return as_tensor(x, *a, **k)

    try:
        for n in saved:
            setattr(torch.Tensor, n, refuse(f"Tensor.{n}"))
        torch.tensor = refuse("torch.tensor")
        torch.as_tensor = no_host
        yield
    finally:
        for n, f in saved.items():
            setattr(torch.Tensor, n, f)
        torch.tensor, torch.as_tensor = tensor, as_tensor


class NoHostReads(StandIn):
    """A stand-in whose capture and replays refuse host reads."""

    def __init__(self, body, args, device):
        with _no_host_reads():
            super().__init__(body, args, device)

    def replay(self):
        with _no_host_reads():
            super().replay()


def test_two_level_trace_replayed_matches_jax(monkeypatch):
    """The replayed trace (its body under NoHostReads: the instance loop
    unrolled over the accel's host tuple, t_max filled on the device)
    against JAX's trace_two_level at test_torch_twolevel's tolerances:
    ids equal on >= 0.999 of rays, t, u and v within 2e-4 where they
    agree; bit for bit the trace op by op and through plain=True; one
    capture per key (a tensor t_max and any-hit mode capture again)."""
    progs = graphs.Programs(4, capture=NoHostReads)
    monkeypatch.setattr(twolevel, "TRACE_PROGRAMS", progs)
    sc = make_scene()
    jacc = jtwolevel.build_two_level(sc, leaf_size=8)
    acc = twolevel.build_two_level(port_scene(sc), 8, device="cpu")
    assert acc.inst_mesh_host == tuple(acc.inst_mesh.tolist())
    o, d = tl_rays(2048, 0)
    jt, ji, jtri, ju, jv = (np.asarray(a) for a in jtwolevel.trace_two_level(
        jacc, o, d, 1e32, leaf_size=8))
    to, td = torch.tensor(np.asarray(o)), torch.tensor(np.asarray(d))
    launches = traversal_skip.LAUNCHES["closest"]
    for _ in range(2):
        got = twolevel.trace_two_level(acc, to, td)
        t, inst, tri, u, v = (x.numpy() for x in got)
        same = (inst == ji) & (tri == jtri)
        assert same.mean() >= 0.999
        hit = same & (ji >= 0)
        assert 0.1 < hit.mean() < 0.9
        np.testing.assert_allclose(t[hit], jt[hit], rtol=0, atol=2e-4)
        np.testing.assert_allclose(u[hit], ju[hit], rtol=0, atol=2e-4)
        np.testing.assert_allclose(v[hit], jv[hit], rtol=0, atol=2e-4)
        assert (t[ji < 0] == 1e32).all() and (tri[ji < 0] == -1).all()
    assert progs.captures == 1
    with graphs.disable():
        want = twolevel.trace_two_level(acc, to, td)
    plain = twolevel.trace_two_level(acc, to, td, plain=True)
    assert all(torch.equal(a, b) and torch.equal(a, c)
               for a, b, c in zip(got, want, plain))
    assert progs.captures == 1
    # The plain walk counts no K3 launch on the CPU.
    assert traversal_skip.LAUNCHES["closest"] == launches
    short = torch.where(got[1] >= 0, got[0] * 0.99, 1e32)
    for _ in range(2):
        occ = twolevel.trace_two_level(acc, to, td, short,
                                       find_closest=False)[1]
        assert (occ < 0).all()
        occ = twolevel.trace_two_level(acc, to, td, find_closest=False)[1]
        assert torch.equal(occ >= 0, got[1] >= 0)
    assert progs.captures == 3


# ---- (e) the data-parallel steps -----------------------------------------

@pytest.mark.parametrize("temporal", [False, True])
def test_group_steps_replayed_equal_op_by_op(mesh, monkeypatch, temporal):
    """Three data-parallel steps over the one-rank group replayed from
    one capture (the stand-in puts the optimizer's state back after its
    capture, which a CUDA graph's capture leaves alone): loss and every
    tensor of the state equal to the same steps op by op."""
    from test_torch_train_graph import stand_in, state

    make = upscaler.create_temporal if temporal else upscaler.create
    (net, opt), (ref, ref_opt) = make(seed=3, device="cpu"), make(
        seed=3, device="cpu")

    class Capture(stand_in(opt)):
        backends = frozenset({"gloo"})

    progs = graphs.Programs(4, capture=Capture)
    monkeypatch.setattr(upscaler, "TRAIN_PROGRAMS", progs)
    g = torch.Generator().manual_seed(5)
    group = mesh.get_group()
    for _ in range(3):
        lr = torch.rand((4, 8, 8, 3), generator=g)
        hr = torch.rand((4, 16, 16, 3), generator=g)
        hist = torch.rand((4, 16, 16, 4), generator=g)
        args = (lr, hist, hr) if temporal else (lr, hr)
        step = (upscaler.train_step_temporal if temporal
                else upscaler.train_step)
        loss = step(net, opt, *args, group=group)
        with graphs.disable():
            want = step(ref, ref_opt, *args, group=group)
        assert torch.equal(loss, want)
    assert progs.captures == 1 and int(opt.count) == 3
    assert all(torch.equal(a, b) for a, b in zip(state(opt), state(ref_opt)))
    key = next(iter(progs._cache))
    assert graphs.signature(group) in key


# ---- (f) no capture over a group the capture cannot hold ------------------

def test_plain_stand_in_runs_gloo_op_by_op(mesh, monkeypatch):
    """A capture class without `backends` (the frame-graph StandIn) takes
    no body over a gloo group: the mesh loop, the tiled frame, the
    sharded hits and a data-parallel step run op by op; a body without a
    group still captures."""
    for mod, name in ((tiles, "TILED_PROGRAMS"),
                      (scene_shard, "SHARD_PROGRAMS"),
                      (upscaler, "TRAIN_PROGRAMS")):
        monkeypatch.setattr(mod, name, graphs.Programs(4, capture=StandIn))
    group = mesh.get_group()
    progs = graphs.Programs(1, capture=StandIn)
    assert not progs.enabled("cpu", group) and progs.enabled("cpu")
    assert not graphs.Programs(1).enabled("cpu", group)
    assert GlooStandIn.backends == {"gloo"}
    loop = _mesh_loop(mesh, StandIn)
    for f in range(2):
        loop.step(cam_at(f))
    scene = bench_scene().build("cpu")
    cfg = RenderConfig(width=64, height=48, max_depth=1, sky=True)
    cams = renderer.camera_arrays(Camera(**BENCH_CAM), cfg, "cpu")
    tiles.render_frame_tiled(scene, None, cams, 0, cfg, mesh)
    soup = bench_scene().build("cpu", pad=128)
    sharded, accs = scene_shard.build_sharded_accel(soup, 1, leaf_size=8)
    o, d = renderer.primary_rays(cams, 48, 0, cfg)
    scene_shard.closest_hit_sharded(sharded, accs, o.to_array(),
                                    d.to_array(), mesh, leaf_size=8)
    net, opt = upscaler.create(device="cpu")
    upscaler.train_step(net, opt, torch.rand((2, 8, 8, 3)),
                        torch.rand((2, 16, 16, 3)), group=group)
    assert loop.captures == 0
    assert all(p.captures == 0 for p in (
        tiles.TILED_PROGRAMS, scene_shard.SHARD_PROGRAMS,
        upscaler.TRAIN_PROGRAMS))
    progs("k", lambda x: x + 1, (torch.ones(2),), "cpu")
    assert progs.captures == 1


# ---- the communicator rule, groups made anew, signatures ----------------

def test_capture_without_a_communicator_raises(mesh):
    """A capture whose collective meets no recorded communicator raises
    RuntimeError (the warm-up's record taken away here), and nothing is
    retried op by op; with the warm-up's record it captures."""
    group = mesh.get_group()

    class Forgets(GlooStandIn):
        def __init__(self, body, args, device):
            graphs._communicators.clear()
            super().__init__(body, args, device)

    body = lambda x: tiles.gather_rows(x * 2.0, group)
    progs = graphs.Programs(1, capture=Forgets)
    with pytest.raises(RuntimeError, match="no communicator"):
        progs("k", body, (torch.ones(3, 2),), "cpu", group=group)
    assert progs.captures == 0 and not progs._cache
    progs = graphs.Programs(1, capture=GlooStandIn)
    out = progs("k", body, (torch.ones(3, 2),), "cpu", group=group)
    assert progs.captures == 1 and torch.equal(out, torch.full((3, 2), 2.0))


def test_a_group_made_anew_captures_anew(mesh, tmp_path):
    """A group destroyed and made again under the same name has a new
    communicator: its signature differs, so a body over it captures
    again rather than replay the old group's program."""
    group = mesh.get_group()
    progs = graphs.Programs(4, capture=GlooStandIn)
    x = torch.ones(4, 1)
    body = lambda x: tiles.gather_rows(x, dist.group.WORLD)
    for _ in range(2):
        progs("a", body, (x,), "cpu", group=group)
    old = graphs.signature(group)
    dist.destroy_process_group()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/again",
                            rank=0, world_size=1)
    new = dist.group.WORLD
    assert new.group_name == group.group_name
    assert graphs.signature(new) != old
    assert torch.equal(progs("a", body, (x,), "cpu", group=new), x)
    assert progs.captures == 2


def test_signatures_of_a_mesh_and_a_group(mesh):
    """A group: its backend, world size, rank, name and a serial of the
    group object; a mesh: its device type, names, ranks, this rank's
    coordinate and its group's signature.  The same group gives the same
    signature; another group another."""
    group = mesh.get_group()
    sig = graphs.signature(group)
    assert sig[:5] == ("ProcessGroup", "gloo", 1, 0, group.group_name)
    assert graphs.signature(dist.group.WORLD) == sig
    assert graphs.signature(mesh) == ("DeviceMesh", "cpu", ("tiles",), (0,),
                                      0, sig)
    other = dist.new_group([0])
    assert graphs.signature(other)[:4] == sig[:4]
    assert graphs.signature(other) != sig
    hash(graphs.signature(mesh))
