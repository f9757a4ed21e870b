"""The port's tracing (hrt_tpu_torch/utils/tracing.py) on the CPU: spans
off are no-ops, spans on nest with totals, self times and parents; the
live-ray counters equal the rays trace_paths holds active at each
depth; a traced frame equals an untraced one bit for bit; and switching
tracing captures the loop's frame program once more, the key with
tracing off as it was.  The device stage clocks (the `hrt_timestamp`
kernel) run on the card only: tests/test_torch_cuda.py holds them
there."""
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils import _pytree as pytree

from hrt_tpu_torch import graphs, renderer
from hrt_tpu_torch.config import CONFIGS, RenderConfig
from hrt_tpu_torch.frameloop import FrameLoop
from hrt_tpu_torch.models.camera import Camera
from hrt_tpu_torch.models.scene import bench_scene
from hrt_tpu_torch.ops import lbvh
from hrt_tpu_torch.utils import tracing

CAM = Camera(position=(0.0, -1.0, -6.0), rotation=(-0.15, 0.0, 0.0))
PATH = dataclasses.replace(CONFIGS["path_tracing"], width=16, height=12,
                           accumulate=True)
POST = RenderConfig(width=16, height=12, max_depth=2, sky=True,
                    indirect=True, jitter=True, denoise=True, upscale=2,
                    upscale_mode="temporal")


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
