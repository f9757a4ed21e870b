"""One run of a cell: set-up, the measured window, the traced stretch,
and the comparison with the reference.

Set-up builds the program's frame loop (`hrt_tpu_torch.frameloop.
FrameLoop`, culling off) over the scene the benchmark made, on the
acceleration structure the configuration names (`accel`: "flat", one
SAH BVH over the world's triangles, or "two_level", a TLAS over the
instances and a BLAS a mesh), and warms it up with the traffic's own
frames (the first step captures the frame's CUDA graph).  The window
then runs `FrameLoop.step` back to back for `seconds`, with at most
IN_FLIGHT (2) frames in flight as a viewer's swap chain has: before
issuing frame n it waits for frame n - 2 to complete.  The frames in
flight, the warm-up frames and culling off are constants of the
harness, the same in every cell: they are part of what `frame_ms`
means.  Every frame records a CUDA
event after its step; the frame's time is the interval between its
event and the one before, which is the cadence a viewer sees.  Where
the traffic moves instances (`animate`), each frame first moves them
through the program's public `FrameLoop.set_instance_transform`, one
call an instance, in warm-up and in the window: the refit belongs to
the frame the viewer waits for.

A traced run profiles a steady stretch of the window (torch.profiler,
CPU and CUDA activities) and brackets the benchmark's own calls with
host spans ('rtbench.wait', 'rtbench.camera', 'rtbench.animate',
'rtbench.step') in the profile's time base.

Frames the comparison takes (the first of the window, frames drawn
from the seed, and the last) keep references to the state the loop
held before them and to the state it holds after them; the loop
returns fresh tensors, so nothing is copied inside the window.  On
the CPU (the tests) the loop runs the program's plain versions op by
op, and host clocks stand in for the events.
"""
from __future__ import annotations

import contextlib
import copy
import gc
import os
import sys
import time
from typing import Any, NamedTuple

import numpy as np
import torch

from . import devtrace, geometry, manifest, stats, workload
from .check import Judge, verdict

FORBIDDEN = ("jax", "jaxlib", "flax", "hrt_tpu")
STRETCH = "rtbench.stretch"
STRETCH_FRAMES = 12
# The frames in flight (a viewer's swap chain), the frames that warm
# the loop up (the first captures the frame's graph), and culling off.
IN_FLIGHT = 2
WARMUP_FRAMES = 3
CULL_THRESHOLD_PX = 0.0


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose whole top-level name is JAX's, jaxlib's,
    flax's or the JAX package's (`hrt_tpu`; `hrt_tpu_torch` is the
    program and is not one of them)."""
    mods = sys.modules if modules is None else modules
    return sorted({name.split(".")[0] for name in mods} & set(FORBIDDEN))


def process_age_s() -> float:
    """Seconds since this process started, from /proc (clock ticks)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start


def _merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in (over or {}).items():
        out[k] = (_merge(out[k], v) if isinstance(v, dict)
                  and isinstance(out.get(k), dict) else v)
    return out


class Prepared(NamedTuple):
    name: str
    config: dict
    traffic: dict
    limits: dict
    scene: Any          # geometry.SceneArrays
    loop: Any           # hrt_tpu_torch FrameLoop
    device: torch.device
    accel_build_s: float
    warm_ms: float


def program_scene(arrays: geometry.SceneArrays):
    """The program's Scene, authored through its public calls."""
    from hrt_tpu_torch.models.mesh import Mesh
    from hrt_tpu_torch.models.scene import Scene

    sc = Scene()
    mesh_ids = {}
    for name, m in arrays.meshes.items():
        verts = np.concatenate([m.positions, m.normals, m.uvs], axis=1)
        mesh_ids[name] = sc.add_mesh(Mesh(vertices=verts, indices=m.indices))
    mat_ids = {name: sc.create_material(tuple(m["color"]),
                                        m.get("metallic", 0.0),
                                        m.get("roughness", 1.0))
               for name, m in arrays.materials.items()}
    for lt in arrays.lights:
        sc.create_light(tuple(lt["position"]), tuple(lt["color"]),
                        float(lt["intensity"]))
    for inst in arrays.instances:
        sc.create_instance(mesh_ids[inst["mesh"]], mat_ids[inst["material"]],
                           tuple(inst.get("position", (0.0, 0.0, 0.0))),
                           rotation=tuple(inst.get("rotation",
                                                   (0.0, 0.0, 0.0))),
                           scale=tuple(inst.get("scale", (1.0, 1.0, 1.0))))
    return sc


def render_config(traffic: dict, config: dict):
    from hrt_tpu_torch.config import RenderConfig

    return RenderConfig(leaf_size=int(config.get("leaf_size", 0)),
                        **traffic["render"])


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _camera(view: dict):
    from hrt_tpu_torch.models.camera import Camera

    return Camera(position=tuple(view["position"]),
                  rotation=tuple(view["rotation"]), fov_y=view["fov_y"])


def _start_loop(loop, plan) -> None:
    loop.reset_history()
    loop.prev_cams = None
    loop.frame = plan.frame0


def _animate(loop, plan, i: int) -> dict:
    """Move the plan's instances to their poses of frame i; returns the
    poses.  Every frame of every run moves the same instances, so a
    frame's poses replace whatever a frame before it left."""
    poses = plan.poses(i)
    for idx, (pos, rot, scale) in poses.items():
        loop.set_instance_transform(idx, position=pos, rotation=rot,
                                    scale=scale)
    return poses


def prepare(cell_name: str, device, overrides: dict | None = None,
            bench: dict | None = None) -> Prepared:
    """Build the cell's frame loop and warm it up with its traffic's
    frames.  `overrides` ({"config": {...}, "traffic": {...}}) resize a
    cell for the CPU tests."""
    from hrt_tpu_torch.frameloop import FrameLoop
    from hrt_tpu_torch.ops import lbvh, tlas

    bench = manifest.load() if bench is None else bench
    cell = manifest.cell(bench, cell_name)
    overrides = overrides or {}
    config = _merge(manifest.config(cell["config"]), overrides.get("config"))
    traffic = _merge(manifest.traffic(cell["traffic"]),
                     overrides.get("traffic"))
    limits = _merge(manifest.limits(cell_name), overrides.get("limits"))
    accel = config.get("accel", "flat")
    if accel not in ("flat", "two_level"):
        raise ValueError(f"accel {accel!r}: flat or two_level")
    arrays = geometry.scene_arrays(config)
    device = torch.device(device)
    build = {}
    owner, name = ((tlas, "build_two_level_flat") if accel == "two_level"
                   else (lbvh, "build_bvh_sah"))
    make_accel = getattr(owner, name)

    def timed_build(*args, **kwargs):
        t0 = time.perf_counter()
        out = make_accel(*args, **kwargs)
        _sync(device)
        build["s"] = time.perf_counter() - t0
        return out

    setattr(owner, name, timed_build)
    try:
        loop = FrameLoop(program_scene(arrays), render_config(traffic, config),
                         cull_threshold_px=CULL_THRESHOLD_PX,
                         two_level=accel == "two_level", device=device)
    finally:
        setattr(owner, name, make_accel)
    plan = workload.Plan(traffic, config, 0)
    _start_loop(loop, plan)
    t0 = time.perf_counter()
    for i in range(WARMUP_FRAMES):
        if i == WARMUP_FRAMES - 1:
            _sync(device)
            t0 = time.perf_counter()
        _animate(loop, plan, i)
        loop.step(_camera(plan.view(i)))
    _sync(device)
    warm_ms = (time.perf_counter() - t0) * 1e3
    return Prepared(cell_name, config, traffic, limits, arrays, loop, device,
                    build.get("s", float("nan")), warm_ms)


class Window(NamedTuple):
    frames: int
    seconds: float
    frame_ms: list       # every frame's interval, ms
    step_ms: list        # host ms of every FrameLoop.step call
    records: list        # the checked frames
    stretch: Any         # devtrace.Stretch or None
    stretch_at: range    # the window positions the stretch traced
    first_frame_age_s: float


class _Clock:
    """CUDA events on the card; the host clock after each (synchronous)
    step on the CPU."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def wait(self, mark) -> None:
        if self.cuda:
            mark.synchronize()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


def _positions(traffic: dict, seed: int, est: int) -> set:
    """Window positions checked besides the first and the last."""
    k = max(0, int(traffic["check"]["frames"]) - 2)
    if est <= 2 or k == 0:
        return set()
    g = workload.rng(seed, 2)
    return set(int(x) for x in g.choice(np.arange(1, est - 1),
                                        size=min(k, est - 2), replace=False))


def window(prep: Prepared, seed: int, seconds: float,
           trace: bool = False) -> Window:
    """Run the measured window for `seconds` from the seed's first
    frame."""
    from torch.profiler import ProfilerActivity, profile, record_function

    loop, dev, traffic = prep.loop, prep.device, prep.traffic
    plan = workload.Plan(traffic, prep.config, seed)
    _start_loop(loop, plan)
    est = max(1, int(0.8 * seconds * 1e3 / max(prep.warm_ms, 1e-3)))
    s0 = max(IN_FLIGHT + 1, est // 3) if trace else -1
    # A traced run's checked frames come before its stretch, which the
    # profiler's start and end make long.
    check_at = _positions(traffic, seed, s0 if trace else est) | {0}
    s1 = s0 + STRETCH_FRAMES
    clock = _Clock(dev)
    marks, step_ms, records = [], [], []
    prof = stretch_span = None
    profiling = False

    def span(name):
        return (record_function(f"rtbench.{name}") if profiling
                else contextlib.nullcontext())

    _sync(dev)
    # No collector pauses inside the window: the frames' garbage is
    # collected once it has closed.
    gc.collect()
    gc.disable()
    start = clock.mark()
    age = process_age_s()
    t0 = time.perf_counter()
    i, prev_view, last = 0, None, None
    stretch_s = 0.0
    try:
        # A traced run finishes its stretch past `seconds`: the profiler
        # slows the host, and the traced run reports no window metric.
        while time.perf_counter() - t0 < seconds or i == 0 or profiling:
            if i == s0:
                # Drained first, so that the stretch holds its frames'
                # work and nothing of the frames before.
                _sync(dev)
                ts0 = time.perf_counter()
                prof = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])
                prof.__enter__()
                profiling = True
                stretch_span = record_function(STRETCH)
                stretch_span.__enter__()
            with span("wait"):
                if i >= IN_FLIGHT:
                    clock.wait(marks[i - IN_FLIGHT])
            with span("camera"):
                view = plan.view(i)
                cam = _camera(view)
            poses = {}
            if plan.moving:
                with span("animate"):
                    poses = _animate(loop, plan, i)
            rec = {"i": i, "frame": loop.frame, "view": view,
                   "prev_view": prev_view or view, "poses": poses,
                   "accum": loop.accum, "dn": tuple(loop.dn_state),
                   "up_history": loop.up_history}
            ts = time.perf_counter()
            with span("step"):
                out = loop.step(cam)
            step_ms.append((time.perf_counter() - ts) * 1e3)
            marks.append(clock.mark())
            rec["out"] = out
            rec["accum_new"] = loop.accum
            rec["dn_new"] = tuple(loop.dn_state)
            rec["up_new"] = loop.up_history
            if i in check_at:
                records.append(rec)
            last = rec
            prev_view = view
            i += 1
            if i == s1 and profiling:
                _sync(dev)
                stretch_span.__exit__(None, None, None)
                profiling = False
                prof.__exit__(None, None, None)
                stretch_s = time.perf_counter() - ts0
    finally:
        if profiling:
            stretch_span.__exit__(None, None, None)
            prof.__exit__(None, None, None)
        gc.enable()
    _sync(dev)
    secs = time.perf_counter() - t0
    if last is not records[-1]:
        records.append(last)
    frame_ms = [clock.ms(a, b) for a, b in zip([start] + marks[:-1], marks)]
    stretch = None
    if prof is not None:
        stretch = devtrace.read_profile(prof, STRETCH_FRAMES, STRETCH)
        print(f"rtbench: traced stretch of {STRETCH_FRAMES} frames took "
              f"{stretch_s:.2f} s on the host, {len(stretch.ops)} device ops",
              file=sys.stderr)
        del prof
    return Window(i, secs, frame_ms, step_ms, records, stretch,
                  range(s0, s1) if stretch is not None else range(0),
                  age)


def run(cell_name: str, seed: int, seconds: float, trace: bool,
        device=None, overrides: dict | None = None) -> dict:
    """A whole run: the result line's object, with its `check` table
    last.  On a CUDA device the metrics are the cell's end-to-end ones
    (trace off) or per-layer ones (trace on)."""
    bench = manifest.load()
    dev = torch.device(device or "cuda")
    prep = prepare(cell_name, dev, overrides, bench)
    win = window(prep, seed, seconds, trace)
    cuda = dev.type == "cuda"
    device_rec = {"platform": "gpu" if cuda else "cpu",
                  "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                  "count": 1,
                  "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                        if cuda else 0)}
    ctx = {"window": win, "prep": prep, "stretch": win.stretch}
    metrics = {}
    if trace:
        for m in manifest.metrics_for(bench, cell_name, "per_layer"):
            v = manifest.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if win.stretch is not None:
            device_rec["busy_s"] = win.stretch.busy_s()
            device_rec["window_s"] = win.stretch.seconds
    else:
        e2e = {"frame_ms": stats.window_ms(win.seconds, win.frames),
               "frame_ms_p95": stats.percentile(win.frame_ms, 95),
               "setup_s": win.first_frame_age_s}
        for m in manifest.metrics_for(bench, cell_name, "end_to_end"):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    # The reference runs once the peak is read and the program is gone.
    records, stretch, frames = win.records, win.stretch, win.frames
    scene, traffic, limits = prep.scene, prep.traffic, prep.limits
    del win, ctx, prep
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    judge = Judge(scene, traffic, limits, dev)
    numbers = judge.numbers(records, seed)
    ok, table = verdict(numbers, limits)
    out = {"correct": ok, "attempted": frames, "failed": 0,
           "metrics": metrics, "device": device_rec}
    if stretch is not None:
        out["breakdown"] = devtrace.breakdown(stretch)
    out["check"] = table
    return out
