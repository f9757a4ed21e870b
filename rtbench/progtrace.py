"""The program's own tracing (hrt_tpu_torch/utils/tracing.py), read once
per traced run for the per-layer metrics that come from inside the
frame: the host spans of FrameLoop.step, the frame's device stage
clocks and its live-ray counters.

The probe runs after the window, once the checked frames are kept
(fresh tensors, which the loop never writes again) and the peak memory
is read.  It turns the program's tracing on and steps the loop along
the traffic's own camera path with the harness's frames in flight:
WARMUP_FRAMES frames (the first captures the traced frame program),
then FRAMES frames with no profiler, whose spans, stage clocks and
counts it reads (`tracing.snapshot`).  Then it profiles
PROFILED_FRAMES more and names each idle gap of the device by the
innermost program span (`hrt.*`) open at the gap's midpoint; that goes
to standard error, with the probe's cost, and is not a metric.  Last it
turns tracing off and drops the loop's programs, so that the reference
finds the memory as it would without the probe.

On a CPU device, and where the program has no tracing module (an older
checkout), the readers get None: a host clock is never written under a
device metric's name.  The result is kept on the loop, so the readers
share one probe.
"""
from __future__ import annotations

import re
import statistics
import sys
import time

import torch

from . import harness, stats, workload

FRAMES = 24
PROFILED_FRAMES = 6
TOP_GAPS = 10
_ATTR = "_rtbench_progtrace"
_LIVE = re.compile(r"live\.d(\d+)")
# The step's host work once nothing waits: the key, the copies in, the
# graph launch and the copies out.
ISSUE_SPANS = ("frameloop.key", "graphs.copy_in", "graphs.replay",
               "graphs.copy_out")


def result(ctx) -> dict | None:
    """The probe's result for the run of `ctx`: None on a CPU device or
    where the program has no tracing."""
    prep = ctx["prep"]
    if prep.device.type != "cuda":
        return None
    if not hasattr(prep.loop, _ATTR):
        setattr(prep.loop, _ATTR, probe(prep, ctx["window"]))
    return getattr(prep.loop, _ATTR)


def named_gaps(prof) -> tuple[list, float, float]:
    """([(span name, seconds)] for each idle gap between the profile's
    first and last device op, named by the innermost program span open
    at its midpoint, or "other"), the device's busy seconds, and the
    seconds from its first op to its last."""
    cuda = torch.autograd.DeviceType.CUDA
    ops, spans = [], []
    for e in prof.events():
        a, b = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.device_type == cuda:
            if not e.name.startswith(("hrt.", "rtbench.")):
                ops.append((a, b))
        elif e.name.startswith("hrt."):
            spans.append((e.name[len("hrt."):], a, b))
    if not ops:
        return [], 0.0, 0.0
    lo, hi = min(a for a, _ in ops), max(b for _, b in ops)
    named = []
    for a, b in stats.gaps(ops, lo, hi):
        mid = 0.5 * (a + b)
        open_ = [(s, n) for n, s, e in spans if s <= mid <= e]
        named.append((max(open_)[1] if open_ else "other", b - a))
    return named, stats.interval_union(ops), hi - lo


def probe(prep, win=None) -> dict | None:
    """Run the probe on the prepared loop (see the module's docstring);
    None where the program has no tracing module."""
    try:
        from hrt_tpu_torch.utils import tracing
    except ImportError:
        return None
    from torch.profiler import ProfilerActivity, profile

    loop, dev = prep.loop, prep.device
    plan = workload.Plan(prep.traffic, prep.config, 0)
    clock = harness._Clock(dev)
    marks = []

    def run(frames: int) -> None:
        for _ in range(frames):
            i = len(marks)
            if i >= harness.IN_FLIGHT:
                clock.wait(marks[i - harness.IN_FLIGHT])
            loop.step(harness._camera(plan.view(i)))
            marks.append(clock.mark())

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    t_start = time.perf_counter()
    nodes_off = getattr(getattr(loop.program.last, "graph", None), "nodes",
                        None)
    tracing.enable()
    try:
        harness._start_loop(loop, plan)
        run(harness.WARMUP_FRAMES)
        harness._sync(dev)
        nodes = getattr(getattr(loop.program.last, "graph", None), "nodes",
                        None)
        tracing.reset()
        t0 = time.perf_counter()
        run(FRAMES)
        harness._sync(dev)
        cadence_ms = (time.perf_counter() - t0) * 1e3 / FRAMES
        snap = tracing.snapshot()
        with profile(activities=acts) as prof:
            run(PROFILED_FRAMES)
            harness._sync(dev)
        gaps, busy_s, span_s = named_gaps(prof)
        del prof
    finally:
        tracing.disable()
        loop.program.clear()
    out = {"snapshot": snap, "cadence_ms": cadence_ms,
           "nodes": (nodes_off, nodes),
           "busy_ms": busy_s * 1e3 / PROFILED_FRAMES,
           "profiled_ms": span_s * 1e3 / PROFILED_FRAMES, "gaps": gaps,
           "seconds": time.perf_counter() - t_start}
    _report(out, win)
    return out


def _report(out: dict, win) -> None:
    snap = out["snapshot"]
    say = lambda s: print(f"rtbench: program trace: {s}", file=sys.stderr)
    window_ms = None
    if win is not None:
        steady = [m for i, m in enumerate(win.frame_ms[2:], 2)
                  if i not in win.stretch_at]
        window_ms = statistics.median(steady) if steady else None
    say(f"{FRAMES} frames traced at {out['cadence_ms']:.4f} ms a frame "
        f"(the window's median {window_ms} ms untraced); the frame "
        f"program's nodes untraced, traced {out['nodes']}; the probe took "
        f"{out['seconds']:.2f} s")
    stages = snap.get("stage_ms") or snap.get("host_stage_ms") or {}
    say("stage ms a frame " + ", ".join(f"{k} {v:.4f}"
                                        for k, v in stages.items())
        + f"; first to last mark {snap.get('frame_ms')}")
    steps = snap["spans"].get("frameloop.step", {}).get("count") or 1
    say("span ms a step (self) " + ", ".join(
        f"{k} {v['total_ms'] / steps:.4f} ({v['self_ms'] / steps:.4f})"
        for k, v in sorted(snap["spans"].items())))
    say(f"live rays a frame {snap.get('counts')}")
    total = {}
    for name, s in out["gaps"]:
        n, t = total.get(name, (0, 0.0))
        total[name] = (n + 1, t + s)
    say(f"{PROFILED_FRAMES} profiled frames: device busy "
        f"{out['busy_ms']:.4f} ms of {out['profiled_ms']:.4f} ms a frame; "
        "idle by span (gaps, ms a frame) " + ", ".join(
            f"{k} {n} {t * 1e3 / PROFILED_FRAMES:.4f}"
            for k, (n, t) in sorted(total.items(), key=lambda kv: -kv[1][1])))
    top = sorted(out["gaps"], key=lambda g: -g[1])[:TOP_GAPS]
    say("longest idle gaps " + ", ".join(f"{n} {s * 1e3:.4f} ms"
                                         for n, s in top))


def span_ms(ctx, names) -> float | None:
    """Host ms a step in the program's spans `names` together, over the
    probe's untraced-by-profiler frames; None without them."""
    r = result(ctx)
    if r is None:
        return None
    sp = r["snapshot"]["spans"]
    steps = sp.get("frameloop.step", {}).get("count")
    if not steps or not all(n in sp for n in names):
        return None
    return sum(sp[n]["total_ms"] for n in names) / steps


def stage_ms(ctx, pick) -> float | None:
    """Device ms a frame over the program's stage clocks whose names
    `pick` accepts; None on a host clock or without such a stage."""
    r = result(ctx)
    if r is None:
        return None
    picked = [v for k, v in (r["snapshot"].get("stage_ms") or {}).items()
              if pick(k)]
    return sum(picked) if picked else None


def live_lane_share(ctx) -> float | None:
    """Σ_k live.d<k> / (depths traced × lanes): the share of the lanes
    that every depth's work runs over that hold a live ray; lanes are
    the rays live at depth 0 (every ray)."""
    r = result(ctx)
    if r is None:
        return None
    live = {int(m.group(1)): v for k, v in r["snapshot"]["counts"].items()
            if (m := _LIVE.fullmatch(k))}
    if not live.get(0):
        return None
    return sum(live.values()) / (len(live) * live[0])
