"""The motion-trace probe (rtbench/motiontrace.py) and its readers on
the CPU: the readers report nothing there (a host clock is never written
under a device metric's name) nor where the program has no refit clock,
their arithmetic on a stubbed snapshot, and the probe, run on the
animated cell's loop after its window, leaves the checked records as
they were and the program's tracing switch as it found it."""
import pytest
import torch
from torch.utils import _pytree as pytree

from hrt_tpu_torch.utils import tracing
from rtbench import harness, manifest, motiontrace
from rtbench.tests.test_rtbench_check import small

CELL = "instance_grid.animated_1080"
NEW = ("refit_ms", "refits_per_frame")


@pytest.fixture(scope="module")
def window():
    prep = harness.prepare(CELL, torch.device("cpu"), small(CELL))
    return prep, harness.window(prep, 3000000043, 0.2)


def _tensors(records):
    return [t for t in pytree.tree_flatten(
        [{k: v for k, v in r.items() if k not in ("view", "prev_view")}
         for r in records])[0] if isinstance(t, torch.Tensor)]


def _ctx(prep, win):
    return {"window": win, "prep": prep, "stretch": win.stretch}


def test_the_readers_report_nothing_on_the_cpu(window):
    prep, win = window
    names = {m["name"]: m for m in manifest.load()["per_layer"]}
    for name in NEW:
        assert names[name]["workloads"] == [CELL]
        assert manifest.reader(name)(_ctx(prep, win)) is None
    assert not hasattr(prep.loop, motiontrace._ATTR)


def test_the_probe_is_none_without_a_refit_clock(window, monkeypatch):
    """An older program's tracing, with spans and stage clocks but no
    `clock`: the probe steps nothing and reports nothing."""
    prep, win = window
    frame = prep.loop.frame
    monkeypatch.delattr(tracing, "clock")
    assert motiontrace.probe(prep) is None
    assert prep.loop.frame == frame and not tracing.enabled()


def _stub(monkeypatch, snap):
    monkeypatch.setattr(motiontrace, "result", lambda ctx: {"snapshot": snap})


def test_the_readers_arithmetic_on_a_stubbed_snapshot(monkeypatch):
    spans = {"frameloop.step": {"total_ms": 1400.0, "self_ms": 80.0,
                                "count": 24},
             "frameloop.move": {"total_ms": 1300.0, "self_ms": 10.0,
                                "count": 384},
             "tlas.refit": {"total_ms": 900.0, "self_ms": 40.0,
                            "count": 384}}
    _stub(monkeypatch, {"spans": spans,
                        "clock_ms": {"refit": {"total_ms": 1236.0,
                                               "count": 384}}})
    assert manifest.reader("refit_ms")({}) == pytest.approx(51.5)
    assert manifest.reader("refits_per_frame")({}) == 16.0
    # A host clock (the CPU's) is never read as device ms.
    _stub(monkeypatch, {"spans": spans,
                        "host_clock_ms": {"refit": {"total_ms": 1236.0,
                                                    "count": 384}}})
    assert manifest.reader("refit_ms")({}) is None
    assert manifest.reader("refits_per_frame")({}) == 16.0
    # A program that records no refit spans, or no steps.
    _stub(monkeypatch, {"spans": {"frameloop.step": spans["frameloop.step"]}})
    assert manifest.reader("refits_per_frame")({}) is None
    assert manifest.reader("refit_ms")({}) is None
    _stub(monkeypatch, {"spans": {}, "clock_ms": {"refit": {
        "total_ms": 1.0, "count": 1}}})
    assert manifest.reader("refit_ms")({}) is None
    assert manifest.reader("refits_per_frame")({}) is None


@pytest.mark.parametrize("was_on", [False, True])
def test_the_probe_leaves_records_and_the_switch_as_it_found_them(window,
                                                                  was_on):
    prep, win = window
    before = _tensors(win.records)
    kept = [t.clone() for t in before]
    tracing.reset()
    (tracing.enable if was_on else tracing.disable)()
    try:
        out = motiontrace.probe(prep)
        assert tracing.enabled() is was_on
    finally:
        tracing.disable()
        tracing.reset()
    after = _tensors(win.records)
    assert len(after) == len(before) and all(
        a is b and torch.equal(a, k)
        for a, b, k in zip(after, before, kept))
    assert prep.loop.program.last is None
    snap = out["snapshot"]
    movers = prep.traffic["animate"]["instances"]
    steps = snap["spans"]["frameloop.step"]["count"]
    assert steps == motiontrace.FRAMES
    for name in ("frameloop.move", "tlas.copy_in", "tlas.refit"):
        assert snap["spans"][name]["count"] == movers * steps
    # On the CPU the refit clock is a host clock.
    assert "clock_ms" not in snap
    assert snap["host_clock_ms"]["refit"]["count"] == movers * steps
