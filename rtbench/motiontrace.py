"""The program's tracing on the instance-motion path (hrt_tpu_torch/
utils/tracing.py), read once per traced run for the per-layer metrics
of the refits: the host spans `frameloop.move`, `tlas.copy_in` and
`tlas.refit` that `FrameLoop.set_instance_transform` opens, and the
device clock `refit` around each replay of the loop's refit program.

The window's own frames cannot give a refit's device time: the first
row copy of a frame's moves is a copy from pageable memory, which waits
for the stream, so the frame before runs inside any host span around
the moves.  The clock comes from the program, around the replay alone.

The probe runs after the window, once the checked frames are kept
(fresh tensors, which the loop never writes again) and the peak memory
is read, and before the reference.  It turns the program's tracing on
and steps the loop along the traffic's own camera path with the
harness's frames in flight, moving the traffic's instances before each
step as the window does (`harness._animate`): WARMUP_FRAMES frames (the
first captures the traced frame program), then FRAMES frames whose
spans and clocks it reads (`tracing.snapshot`).  Then it turns tracing
off and drops the loop's frame programs, so that the reference finds
the memory as it would without the probe.

The readers get None on a CPU device, where the traffic moves nothing,
and where the program has no such clock (an older checkout): a host
clock is never written under a device metric's name.  The result is
kept on the loop, so the readers share one probe.
"""
from __future__ import annotations

import sys
import time

from . import harness, workload

FRAMES = 24
_ATTR = "_rtbench_motiontrace"


def result(ctx) -> dict | None:
    """The probe's result for the run of `ctx`: None on a CPU device,
    without motion, or where the program has no refit clock."""
    prep = ctx["prep"]
    if prep.device.type != "cuda":
        return None
    if not hasattr(prep.loop, _ATTR):
        setattr(prep.loop, _ATTR, probe(prep))
    return getattr(prep.loop, _ATTR)


def probe(prep) -> dict | None:
    """Run the probe on the prepared loop (see the module's docstring);
    None where the traffic moves nothing or the program's tracing has
    no `clock`."""
    try:
        from hrt_tpu_torch.utils import tracing
    except ImportError:
        return None
    plan = workload.Plan(prep.traffic, prep.config, 0)
    if not hasattr(tracing, "clock") or not plan.moving:
        return None
    loop, dev = prep.loop, prep.device
    clock = harness._Clock(dev)
    marks = []

    def run(frames: int) -> None:
        for _ in range(frames):
            i = len(marks)
            if i >= harness.IN_FLIGHT:
                clock.wait(marks[i - harness.IN_FLIGHT])
            harness._animate(loop, plan, i)
            loop.step(harness._camera(plan.view(i)))
            marks.append(clock.mark())

    t_start = time.perf_counter()
    was_on = tracing.enabled()
    tracing.enable()
    try:
        harness._start_loop(loop, plan)
        run(harness.WARMUP_FRAMES)
        harness._sync(dev)
        tracing.reset()
        t0 = time.perf_counter()
        run(FRAMES)
        harness._sync(dev)
        cadence_ms = (time.perf_counter() - t0) * 1e3 / FRAMES
        snap = tracing.snapshot()
    finally:
        if not was_on:
            tracing.disable()
        loop.program.clear()
    refit = getattr(loop.builds.last, "graph", None)
    out = {"snapshot": snap, "cadence_ms": cadence_ms,
           "refit_nodes": getattr(refit, "nodes", None),
           "seconds": time.perf_counter() - t_start}
    _report(out)
    return out


def _report(out: dict) -> None:
    snap = out["snapshot"]
    steps = snap["spans"].get("frameloop.step", {}).get("count") or 1
    clocks = snap.get("clock_ms") or snap.get("host_clock_ms") or {}
    say = lambda s: print(f"rtbench: motion trace: {s}", file=sys.stderr)
    say(f"{FRAMES} moving frames traced at {out['cadence_ms']:.4f} ms a "
        f"frame; the refit program's nodes {out['refit_nodes']}; the probe "
        f"took {out['seconds']:.2f} s")
    say("clocks, ms a frame (count a frame) " + ", ".join(
        f"{k} {v['total_ms'] / steps:.4f} ({v['count'] / steps:.2f})"
        for k, v in clocks.items()))
    say("span ms a frame (count a frame) " + ", ".join(
        f"{k} {v['total_ms'] / steps:.4f} ({v['count'] / steps:.2f})"
        for k, v in sorted(snap["spans"].items())))


def refit_ms(ctx) -> float | None:
    """Device ms a frame in the refit program's replays: the `refit`
    clock's total over the probe's frames; None without it."""
    r = result(ctx)
    if r is None:
        return None
    snap = r["snapshot"]
    steps = snap["spans"].get("frameloop.step", {}).get("count")
    refit = (snap.get("clock_ms") or {}).get("refit")
    if not steps or refit is None:
        return None
    return refit["total_ms"] / steps


def refits_per_frame(ctx) -> float | None:
    """`tlas.refit` spans over `frameloop.step` spans in the probe's
    frames; None without them."""
    r = result(ctx)
    if r is None:
        return None
    sp = r["snapshot"]["spans"]
    steps = sp.get("frameloop.step", {}).get("count")
    if not steps or "tlas.refit" not in sp:
        return None
    return sp["tlas.refit"]["count"] / steps
