"""Device time by op of the port's frames (the JAX package's
scripts/profile_frame.py).

    python -m hrt_tpu_torch.profile_frame [--cfg bench|path1080|4k] [--frames 4] [--top 25]

Targets: `bench` renders the bench frame at 512x384 (bench.py's scene,
accel and config) one `render_frames` call a frame; `path1080` and `4k`
step a FrameLoop at bench_full's path_tracing_1080p and
animated_4k_upscaled configurations.  `--cfg` defaults to
HRT_PROFILE_CFG, then `bench`; `--sort 0|1` (or HRT_PROFILE_SORT)
overrides the configuration's `sort_bounces`, `--resolution WxH` its
size (small CPU runs).

After one warm-up frame (on the card it captures the frame's CUDA
graph, and a line gives the capture's ms and node count), `--frames`
frames, replays of that graph, run under
utils/profiling.trace, which writes the Chrome trace to
`--dir`/trace.json.  The table gives the top `--top` device ops: ms per
frame, launches per frame and share of device time, each port kernel
named by its C entry and CUDA symbol ("hrt_bvh8_trace:bvh8_packet_kernel",
utils/profiling.op_label).  The last line is one JSON object: `cfg`,
`frames`, `device_ms_per_frame`, `wall_ms_per_frame` (host clock under
the profiler, synchronised), `busy` (the union of the device activity
over that window), `launches_per_frame`, the stages' ms
(`stages`: set-up, warm-up, frames, the spans `profile_frame.<stage>`),
`top` (the table's rows), the card (`device`) and `program`, the
program's own tracing (utils/tracing.snapshot: its host spans and, for
a FrameLoop target, its frames' stage ms and live rays a depth).  The
run turns tracing on, so a FrameLoop target's frame holds its stage
clocks, and the profile holds the program's spans as `hrt.*`.  With
`--device cpu` there is no device activity: the table and `top` hold
host ops by self CPU time instead, under `cpu_ms_per_frame`, and the
device keys are null.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys

import torch

from .bench import BENCH_CAMERA, LEAF_SIZE, bench_config
from .bench_full import configs, parse_resolution
from .config import resolve_device
from .frameloop import FrameLoop
from .models.scene import bench_scene
from .ops import lbvh
from .graphs import capture_line
from .renderer import FRAME_PROGRAMS, camera_arrays, render_frames
from .utils import tracing
from .utils.profiling import (busy_share, device_name, device_op_totals,
                              op_label, trace)

TARGETS = {"path1080": "path_tracing_1080p", "4k": "animated_4k_upscaled"}


def make_target(which: str, dev, sort=None, resolution=None):
    """The frame function of a target, fn(i) rendering frame i and
    returning its image, and the graphs.Programs that captures it on the
    card.  `sort` overrides sort_bounces, `resolution` (W, H) the
    size."""
    change = {}
    if sort is not None:
        change["sort_bounces"] = sort
    if resolution is not None:
        change.update(width=resolution[0], height=resolution[1])
    if which == "bench":
        cfg = dataclasses.replace(bench_config(), **change)
        scene = bench_scene().build(dev)
        accel = lbvh.build_bvh_sah(scene, leaf_size=LEAF_SIZE)
        cams = camera_arrays(BENCH_CAMERA, cfg, dev)
        return (lambda i: render_frames(scene, accel, cams, i, 1, cfg),
                FRAME_PROGRAMS)
    if which not in TARGETS:
        raise ValueError(f"--cfg must be bench, path1080 or 4k, not "
                         f"{which!r}")
    bc = next(c for c in configs() if c.name == TARGETS[which])
    cfg = dataclasses.replace(bc.config, **change)
    loop = FrameLoop(bc.scene(), cfg, cull_threshold_px=0.0, device=dev)
    return lambda i: loop.step(bc.camera), loop.program


def _host_op_totals(prof) -> tuple[float, dict]:
    """(total ms, {op: (ms, count)}) of the profile's host ops by self
    CPU time."""
    cpu = torch.autograd.DeviceType.CPU
    ops = {e.key: (e.self_cpu_time_total / 1e3, e.count)
           for e in prof.key_averages() if e.device_type == cpu}
    return sum(ms for ms, _ in ops.values()), ops


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="python -m hrt_tpu_torch.profile_frame")
    ap.add_argument("--cfg", default=os.environ.get("HRT_PROFILE_CFG",
                                                    "bench"))
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--dir", default="hrt_tpu_torch_trace")
    ap.add_argument("--sort", type=int, choices=(0, 1),
                    default=(int(os.environ["HRT_PROFILE_SORT"])
                             if os.environ.get("HRT_PROFILE_SORT") else None))
    ap.add_argument("--resolution", default=None,
                    help="WxH instead of the target's size (small CPU runs)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


STAGES = ("set-up", "warm-up", "frames")


@contextlib.contextmanager
def _stage(name: str, dev):
    """The span `profile_frame.<name>`, the device synchronised at its
    end."""
    with tracing.span(f"profile_frame.{name}"):
        yield
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    """Profile the target, print the table and the JSON line; returns
    the line's object."""
    args = parse_args(sys.argv[1:] if argv is None else argv)
    was_on = tracing.enabled()
    tracing.enable()
    tracing.reset()
    try:
        return _profile(args)
    finally:
        if not was_on:
            tracing.disable()


def _profile(args) -> dict:
    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    with _stage("set-up", dev):
        frame, programs = make_target(
            args.cfg, dev, None if args.sort is None else bool(args.sort),
            parse_resolution(args.resolution))
    with _stage("warm-up", dev):
        frame(0)
    line = capture_line(args.cfg, programs)
    if line:
        print(line, flush=True)
    n = args.frames
    with trace(args.dir) as prof:
        with _stage("frames", dev):
            for i in range(1, n + 1):
                frame(i)
    snap = tracing.snapshot()
    stages = {k: round(snap["spans"][f"profile_frame.{k}"]["total_ms"], 3)
              for k in STAGES}
    wall_ms = stages["frames"]
    if cuda:
        total, ops = device_op_totals(prof)
        busy = busy_share(prof, wall_ms)
    else:
        total, ops = _host_op_totals(prof)
        busy = None
    launches = sum(c for _, c in ops.values())
    rows = sorted(ops.items(), key=lambda kv: -kv[1][0])[:args.top]
    top = [{"op": op_label(k), "ms_per_frame": ms / n,
            "launches_per_frame": c / n, "share": ms / total}
           for k, (ms, c) in rows]
    kind, unit = ("device", "launches") if cuda else ("host", "host ops")
    print(f"== {args.cfg} | {kind} {total:.3f} ms over {n} frames "
          f"({total / n:.3f} ms/frame), wall {wall_ms / n:.3f} ms/frame, "
          f"busy {'n/a' if busy is None else f'{busy:.4f}'}, "
          f"{launches / n:.1f} {unit}/frame", flush=True)
    print(f"{'op':70s} {'ms/frame':>9s} {'%':>6s} {'n/frame':>8s}")
    for r in top:
        print(f"{r['op'][:70]:70s} {r['ms_per_frame']:9.4f} "
              f"{100 * r['share']:6.1f} {r['launches_per_frame']:8.1f}")
    out = {
        "cfg": args.cfg,
        "frames": n,
        "device_ms_per_frame": total / n if cuda else None,
        "cpu_ms_per_frame": None if cuda else total / n,
        "wall_ms_per_frame": wall_ms / n,
        "busy": busy,
        "launches_per_frame": launches / n if cuda else None,
        "stages": stages,
        "program": snap,
        "top": top,
        "device": device_name(dev),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
