"""The program-trace probe (rtbench/progtrace.py) on the CPU: the new
readers report nothing there (a host clock is never written under a
device metric's name), and the probe, run on a loop after its window,
leaves the checked records as they were and the program's tracing off."""
import pytest
import torch
from torch.utils import _pytree as pytree

from hrt_tpu_torch.utils import tracing
from rtbench import harness, manifest, progtrace
from rtbench.tests.test_rtbench_check import CELLS, small

NEW = ("step_camera_ms", "step_issue_ms", "hit_stage_ms", "nee_stage_ms",
       "bounce_stage_ms", "svgf_stage_ms", "upscale_stage_ms",
       "live_lane_share")


def _window(cell):
    prep = harness.prepare(cell, torch.device("cpu"), small(cell))
    return prep, harness.window(prep, 3000000041, 0.2)


def _tensors(records):
    return [t for t in pytree.tree_flatten(
        [{k: v for k, v in r.items() if k not in ("view", "prev_view")}
         for r in records])[0] if isinstance(t, torch.Tensor)]


def test_the_new_readers_report_nothing_on_the_cpu():
    prep, win = _window(CELLS[0])
    ctx = {"window": win, "prep": prep, "stretch": win.stretch}
    names = {m["name"] for m in manifest.load()["per_layer"]}
    assert set(NEW) <= names
    for name in NEW:
        assert manifest.reader(name)(ctx) is None
    assert not hasattr(prep.loop, "_rtbench_progtrace")


@pytest.mark.parametrize("cell", CELLS)
def test_the_probe_leaves_the_checked_records_untouched(cell):
    prep, win = _window(cell)
    before = _tensors(win.records)
    kept = [t.clone() for t in before]
    out = progtrace.probe(prep, win)
    after = _tensors(win.records)
    assert len(after) == len(before) and all(
        a is b and torch.equal(a, k)
        for a, b, k in zip(after, before, kept))
    assert not tracing.enabled() and prep.loop.program.last is None
    snap = out["snapshot"]
    # On the CPU the stage clocks are host clocks.
    assert "stage_ms" not in snap and snap["frames"] == progtrace.FRAMES
    assert snap["spans"]["frameloop.step"]["count"] == progtrace.FRAMES
    assert snap["counts"]["live.d0"] == (
        prep.traffic["render"]["width"] * prep.traffic["render"]["height"])
