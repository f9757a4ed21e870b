"""The port's tracing (hrt_tpu_torch/utils/tracing.py) on the CPU: spans
off are no-ops, spans on nest with totals, self times and parents; the
live-ray counters equal the rays trace_paths holds active at each
depth; a traced frame equals an untraced one bit for bit; and switching
tracing captures the loop's frame program once more, the key with
tracing off as it was; an instance move is the span `frameloop.move`
over `tlas.copy_in` and `tlas.refit`, its refit clocked, on either
TLAS route, and a traced move writes what an untraced one does.  The
device stage clocks (the `hrt_timestamp` kernel) and the refit's CUDA
event clock run on the card only: tests/test_torch_cuda.py holds the
stage clocks there."""
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils import _pytree as pytree

from hrt_tpu_torch import cli, graphs, renderer
from hrt_tpu_torch.config import CONFIGS, RenderConfig
from hrt_tpu_torch.frameloop import FrameLoop
from hrt_tpu_torch.models.camera import Camera
from hrt_tpu_torch.models.scene import bench_scene, instance_grid_scene
from hrt_tpu_torch.ops import lbvh, wide8
from hrt_tpu_torch.utils import tracing

CAM = Camera(position=(0.0, -1.0, -6.0), rotation=(-0.15, 0.0, 0.0))
PATH = dataclasses.replace(CONFIGS["path_tracing"], width=16, height=12,
                           accumulate=True)
POST = RenderConfig(width=16, height=12, max_depth=2, sky=True,
                    indirect=True, jitter=True, denoise=True, upscale=2,
                    upscale_mode="temporal")
GRID = RenderConfig(width=16, height=12, max_depth=1, sky=True)
GRID_CAM = Camera(position=(0.0, -3.0, -5.0), rotation=(-0.5, 0.0, 0.0))
# Poses of three grid instances of instance_grid_scene(3):
# (position, rotation, scale).
MOVES = {2: ((-1.0, 0.2, -1.6), (0.3, 1.1, -0.4), (0.3, 0.3, 0.3)),
         5: ((0.1, 0.1, -0.2), (1.2, 0.0, 2.0), (0.35, 0.35, 0.35)),
         9: ((1.4, 0.6, 0.9), (0.0, 2.5, 0.7), (0.2, 0.2, 0.2))}


@pytest.fixture(autouse=True)
def _off():
    """Every test starts and ends with tracing off and nothing
    recorded."""
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def test_spans_off_are_noops_and_record_nothing():
    a, b = tracing.span("x"), tracing.span("y")
    assert a is b
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("outer"), tracing.span("inner"):
            torch.ones(4).sum()
    assert not [e for e in prof.events() if e.name.startswith("hrt.")]
    with tracing.frame("cpu") as rec:
        tracing.mark("raygen")
        tracing.count("live.d0", torch.ones(3, dtype=torch.bool))
    tracing.collect(rec)
    snap = tracing.snapshot()
    assert rec is None and tracing.spans() == []
    assert snap["spans"] == {} and snap["frames"] == 0
    assert snap["counts"] == {} and snap["live_lane_share"] is None


def test_spans_on_nest_with_totals_self_and_parents():
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with tracing.span("outer"):
                with tracing.span("inner"):
                    torch.ones(64).sum()
                with tracing.span("inner"):
                    pass
    names = [e.name for e in prof.events() if e.name.startswith("hrt.")]
    assert names.count("hrt.outer") == 2 and names.count("hrt.inner") == 4
    rows = tracing.spans()
    assert [(n, p) for n, _, _, p in rows] == [
        ("inner", "outer"), ("inner", "outer"), ("outer", None)] * 2
    assert all(e >= s for _, s, e, _ in rows)
    snap = tracing.snapshot()["spans"]
    assert snap["outer"]["count"] == 2 and snap["inner"]["count"] == 4
    inner = sum(e - s for n, s, e, _ in rows if n == "inner") / 1e6
    outer = sum(e - s for n, s, e, _ in rows if n == "outer") / 1e6
    assert snap["inner"]["total_ms"] == pytest.approx(inner)
    assert snap["inner"]["self_ms"] == pytest.approx(inner)
    assert snap["outer"]["total_ms"] == pytest.approx(outer)
    assert snap["outer"]["self_ms"] == pytest.approx(outer - inner)


@pytest.mark.parametrize("sort", [False, True])
def test_live_counts_equal_the_active_rays_per_depth(sort):
    """`live.d<k>` of a traced frame is the count of the rays that
    trace_paths holds active on entry to depth k, and the live-lane
    share is their sum over depths times lanes."""
    cfg = dataclasses.replace(PATH, sort_bounces=sort)
    scene = bench_scene().build("cpu")
    accel = lbvh.build_bvh_sah(scene, leaf_size=32, device="cpu")
    cams = renderer.camera_arrays(CAM, cfg, "cpu")
    tracing.enable()
    batches = []
    with tracing.frame("cpu") as rec:
        renderer.render_rows(scene, accel, cams, 0, cfg.height, cfg,
                             frame=3, _batches=batches)
    tracing.collect(rec)
    snap = tracing.snapshot()
    want = {f"live.d{b['depth']}": int(b["active"].sum()) for b in batches}
    assert len(want) == cfg.max_depth
    assert snap["counts"] == want
    assert want["live.d0"] == cfg.width * cfg.height
    assert want[f"live.d{cfg.max_depth - 1}"] < want["live.d0"]
    assert snap["live_lane_share"] == pytest.approx(
        sum(want.values()) / (cfg.max_depth * want["live.d0"]))
    names = [n for k, n in rec.slots if k == "mark"]
    assert names[0] == "raygen" and names[-1] == "end"
    assert names[1:4] == ["hit.d0", "nee.d0", "bounce.d0"]


@pytest.mark.parametrize("cfg", [PATH, POST], ids=["path", "post"])
def test_traced_frame_equals_the_untraced_frame(cfg):
    """The same loop steps, traced and not: equal bit for bit, output
    and state; on the CPU the stage clocks are host clocks, never
    reported as device times."""
    plain, traced = (FrameLoop(bench_scene(), cfg, cull_threshold_px=0.0,
                               device="cpu") for _ in range(2))
    for f in range(2):
        tracing.disable()
        want = plain.step(CAM)
        tracing.enable()
        got = traced.step(CAM)
        assert torch.equal(got, want)
        for a, b in zip(pytree.tree_flatten((traced.accum, traced.dn_state,
                                             traced.up_history))[0],
                        pytree.tree_flatten((plain.accum, plain.dn_state,
                                             plain.up_history))[0]):
            assert (a is None and b is None) or torch.equal(a, b)
    snap = tracing.snapshot()
    assert snap["frames"] == 2 and "stage_ms" not in snap
    stages = set(snap["host_stage_ms"])
    post = {"svgf", "upscale"} if cfg.denoise else {"accumulate"}
    assert {"raygen", "hit.d0", "nee.d0", "bounce.d0"} | post <= stages
    assert snap["host_frame_ms"] == pytest.approx(
        sum(snap["host_stage_ms"].values()))
    assert snap["spans"]["frameloop.step"]["count"] == 2
    for child in ("frameloop.camera", "frameloop.cull", "frameloop.key"):
        assert snap["spans"][child]["count"] == 2


class StandIn:
    """A capture on the CPU: the body runs at capture and at every
    replay, writing into the outputs it made at capture."""

    device_type = "cpu"

    def __init__(self, body, args, device):
        self.body, self.args = body, args
        self.outputs = body(*args)
        self.nodes, self.capture_ms = 0, 0.0

    def replay(self):
        for s, o in zip(pytree.tree_flatten(self.outputs)[0],
                        pytree.tree_flatten(self.body(*self.args))[0]):
            if s is not None:
                s.copy_(o)


def test_switching_tracing_captures_once_more_and_keeps_the_off_key():
    cfg = dataclasses.replace(PATH, max_depth=2)
    loop = FrameLoop(bench_scene(), cfg, cull_threshold_px=0.0,
                     device="cpu")
    loop.program = graphs.Programs(1, capture=StandIn)
    loop.step(CAM)
    loop.step(CAM)
    off_key = next(iter(loop.program._cache))
    assert loop.captures == 1
    tracing.enable()
    loop.step(CAM)
    loop.step(CAM)
    assert loop.captures == 2
    on_key = next(iter(loop.program._cache))
    assert on_key != off_key
    snap = tracing.snapshot()
    assert snap["frames"] == 2
    assert {"graphs.copy_in", "graphs.replay",
            "graphs.copy_out"} <= set(snap["spans"])
    assert snap["spans"]["graphs.replay"]["count"] == 1
    assert snap["spans"]["graphs.capture"]["count"] == 1
    tracing.disable()
    loop.step(CAM)
    loop.step(CAM)
    assert loop.captures == 3
    assert next(iter(loop.program._cache)) == off_key


@pytest.fixture(params=["bvh8", "binary"])
def grid_loop(request, monkeypatch):
    """A maker of two-level loops over instance_grid_scene(3) on the
    CPU, on the unified BVH8 table (K4's route) or, with the wide bound
    lowered, the binary tables (K5's route, the forest's)."""
    if request.param == "binary":
        monkeypatch.setattr(wide8, "MAX_WIDE_NODES", 4)

    def make():
        loop = FrameLoop(instance_grid_scene(3), GRID, cull_threshold_px=0.0,
                         two_level=True, device="cpu")
        assert (loop.accel.w8_nodes is None) == (request.param == "binary")
        return loop
    return make


def _move_all(loop):
    for idx, (pos, rot, scale) in MOVES.items():
        loop.set_instance_transform(idx, position=pos, rotation=rot,
                                    scale=scale)


def test_a_move_is_a_span_over_the_copy_and_the_clocked_refit(grid_loop):
    loop = grid_loop()
    tracing.enable()
    _move_all(loop)
    k = len(MOVES)
    assert [(n, p) for n, _, _, p in tracing.spans()] == [
        ("tlas.copy_in", "frameloop.move"), ("tlas.refit", "frameloop.move"),
        ("frameloop.move", None)] * k
    snap = tracing.snapshot()
    for name in ("frameloop.move", "tlas.copy_in", "tlas.refit"):
        assert snap["spans"][name]["count"] == k
    # On the CPU the refit clock is a host clock, under its host key.
    assert "clock_ms" not in snap
    assert snap["host_clock_ms"]["refit"]["count"] == k
    assert snap["host_clock_ms"]["refit"]["total_ms"] > 0
    loop.step(GRID_CAM)
    snap = tracing.snapshot()
    assert "stage_ms" not in snap and "refit" not in snap["host_stage_ms"]
    assert snap["frames"] == 1
    assert snap["host_clock_ms"]["refit"]["count"] == k
    stats = cli.trace_stats(snap)
    assert stats["host_clock_ms"]["refit"]["count"] == k
    assert "clock_ms" not in stats
    assert stats["span_ms"]["frameloop.move"] > 0


def test_a_move_with_tracing_off_records_nothing(grid_loop):
    loop = grid_loop()
    assert tracing.clock("refit", "cpu") is tracing.span("refit")
    _move_all(loop)
    loop.step(GRID_CAM)
    snap = tracing.snapshot()
    assert tracing.spans() == [] and snap["spans"] == {}
    assert "clock_ms" not in snap and "host_clock_ms" not in snap
    assert "host_clock_ms" not in cli.trace_stats(snap)


def _accel_tensors(tl):
    return {f.name: getattr(tl, f.name) for f in dataclasses.fields(tl)
            if isinstance(getattr(tl, f.name), torch.Tensor)}


def test_a_traced_move_writes_what_an_untraced_one_does(grid_loop):
    """The same moves and frames, traced and not: the TLAS tables, the
    instance records and the frames equal bit for bit."""
    plain, traced = grid_loop(), grid_loop()
    before = {k: v.clone() for k, v in _accel_tensors(plain.accel).items()}
    for frame in range(2):
        tracing.disable()
        _move_all(plain)
        want = plain.step(GRID_CAM)
        tracing.enable()
        _move_all(traced)
        got = traced.step(GRID_CAM)
        assert torch.equal(got, want)
        a, b = _accel_tensors(traced.accel), _accel_tensors(plain.accel)
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k].view(torch.int32),
                               b[k].view(torch.int32)), k
    # The moves did write the instance records and the TLAS.
    moved = _accel_tensors(plain.accel)
    assert not torch.equal(moved["world_from_obj"], before["world_from_obj"])
    table = "nodes" if plain.accel.w8_nodes is None else "w8_nodes"
    assert not torch.equal(moved[table], before[table])
    idx = list(MOVES)
    assert np.array_equal(
        plain.accel.world_from_obj[idx].numpy(),
        np.stack([plain.scene_obj.instances[i].transform
                  for i in idx]).astype(np.float32))
    assert tracing.snapshot()["host_clock_ms"]["refit"]["count"] == \
        2 * len(MOVES)
