"""Profiling (hrt_tpu/utils/profiling.py and hrt_tpu/utils/xprof.py): a
torch.profiler trace around frames, a per-frame stats dict, the device
memory snapshot, and the device time of a call read from a profile
(xprof's `device_ms_per_call`): the CUDA activities' time by op, the
card's busy share over a window, and the card's name and power limit.
Per-stage timers are the spans of utils/tracing.py.

The device-time readers raise where a profile holds no device activity
(a CPU device, a capture that saw no kernel): they never stand in a 0 or
a nan for a time that was not measured.  They count device work only:
the device-side annotations of the program's spans (`hrt.*`,
utils/tracing.span under a profiler) are left out."""
from __future__ import annotations

import contextlib
import math
import os
import re
import subprocess
import time
from typing import Callable, Iterator

import torch

from ..config import resolve_device
from .logging import logger, rays_per_frame


@contextlib.contextmanager
def trace(log_dir: str = "hrt_tpu_torch_trace") -> Iterator[object]:
    """Profile the block (the CPU, and CUDA where there is a card) and
    write its Chrome trace to `log_dir`/trace.json.  Yields the
    torch.profiler.profile object (`key_averages()` for sums by name)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)


def timed_call(fn: Callable[[], object], device):
    """(fn()'s result, its host-clock seconds up to a synchronise of
    `device`, the CUDA-event ms around it or None on the CPU)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0, None
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0, a.elapsed_time(b)


def frame_stats(config, num_lights: int, seconds: float) -> dict:
    """One frame's counters: rays credited, ms, Mray/s and the config's
    size."""
    rays = rays_per_frame(config, num_lights)
    return {
        "rays": rays,
        "ms": round(seconds * 1e3, 3),
        "mrays_per_sec": round(rays / max(seconds, 1e-9) / 1e6, 2),
        "resolution": [config.width, config.height],
        "spp": config.spp,
        "max_depth": config.max_depth,
    }


def device_memory_stats(device=None) -> dict:
    """The caching allocator's bytes in use and their peak, and the
    card's memory, under the JAX package's keys; {} for a CPU device.
    `device` defaults to the first CUDA device (config.resolve_device)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(dev)
    return {"bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(dev).total_memory}


# The port's kernels by their CUDA symbols (csrc/*.cu), named by the C
# entry points that launch them (kernels/build.py): a profile shows the
# symbol, the `hrt_*` entry is the name the port's records use.
KERNEL_ENTRIES = {
    "bvh8_packet_kernel": "hrt_bvh8_trace",
    "skip_trace_kernel": "hrt_skip_trace",
    "tlas8_closest_kernel": "hrt_tlas8_trace",
    "tlas8_any_hit_kernel": "hrt_tlas8_trace",
    "tlas_skip_trace_kernel": "hrt_tlas_skip_trace",
    "brdf_light_major_kernel": "hrt_brdf_light_major",
    "warp_bilinear_kernel": "hrt_warp_bilinear",
    "warp_bilinear_backward_kernel": "hrt_warp_bilinear_backward",
    "timestamp_kernel": "hrt_timestamp",
}


def _unqualified(name: str) -> str:
    s = name.replace("(anonymous namespace)::", "")
    return re.sub(r"^void\s+", "", s.strip())


def kernel_symbol(name: str) -> str:
    """The unqualified function name of a demangled kernel name
    ("void (anonymous namespace)::bvh8_packet_kernel<24, true>(...)" ->
    "bvh8_packet_kernel")."""
    m = re.match(r"[\w:]+", _unqualified(name))
    return m.group(0).split("::")[-1] if m else name


def op_label(name: str) -> str:
    """A device op's name for a breakdown: a port kernel's C entry, its
    symbol and template arguments, which tell its instantiations apart
    ("hrt_bvh8_trace:bvh8_packet_kernel<24, true, false>"); any other
    op's own name."""
    sym = kernel_symbol(name)
    entry = KERNEL_ENTRIES.get(sym)
    if entry is None:
        return name
    args = re.match(r"<[^<>]*>", _unqualified(name).split(sym, 1)[1])
    return f"{entry}:{sym}{args.group(0) if args else ''}"


def _cuda_device(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"device time needs a CUDA device, not {dev}")
    return dev


def profile_calls(fn: Callable[[], object], calls: int = 1,
                  device=None):
    """One warm-up fn() call, then `calls` calls under torch.profiler
    (CPU and CUDA activities), the card synchronised before the window
    closes.  Returns (the profile, the calls' host-clock ms).  `device`
    defaults to the first CUDA device; a CPU device raises."""
    from torch.profiler import ProfilerActivity, profile

    dev = _cuda_device(device)
    fn()
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    return prof, wall_ms


def _annotation(name: str) -> bool:
    """A program span's mark on the device timeline, not device work."""
    return name.startswith("hrt.")


_NO_DEVICE = ("the profile holds no device activity (no CUDA device "
              "traced, or no kernel ran)")


def device_op_totals(prof) -> tuple[float, dict]:
    """(total device ms, {op name: (ms, count)}) of a profile's CUDA
    activities (kernels, copies, fills), by their self device time.
    Raises RuntimeError when the profile holds none."""
    cuda = torch.autograd.DeviceType.CUDA
    ops = {e.key: (e.self_device_time_total / 1e3, e.count)
           for e in prof.key_averages()
           if e.device_type == cuda and not _annotation(e.key)}
    total = sum(ms for ms, _ in ops.values())
    if total <= 0.0:
        raise RuntimeError(_NO_DEVICE)
    return total, ops


def interval_union(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        total += max(0.0, b - max(a, end))
        end = max(end, b)
    return total


def busy_share(prof, wall_ms: float) -> float:
    """The card's busy share of a window of `wall_ms` host-clock ms: the
    union of the profile's CUDA activity intervals (overlapping streams
    counted once) over the window.  Raises RuntimeError when the profile
    holds no device activity."""
    cuda = torch.autograd.DeviceType.CUDA
    iv = [(e.time_range.start, e.time_range.end) for e in prof.events()
          if e.device_type == cuda and not _annotation(e.name)]
    if not iv:
        raise RuntimeError(_NO_DEVICE)
    return interval_union(iv) / 1e3 / wall_ms


# Profiler windows that came back with no device activity in this
# process (device_ms_per_call profiles each such window once more).
EMPTY_WINDOWS = 0


def device_ms_per_call(fn: Callable[[], object], calls: int = 8,
                       device=None) -> float:
    """The mean device ms of one fn() call: one warm-up call, then
    `calls` calls under the profiler, their CUDA activities summed
    (profile_calls, device_op_totals).  Raises on a CPU device, and when
    two profiles in a row hold no device activity.  A profile of a short
    window has once held none on the card, the cause not found: such a
    window is logged, counted in EMPTY_WINDOWS and profiled once more
    before that raises."""
    global EMPTY_WINDOWS
    for retry in (False, True):
        prof, _ = profile_calls(fn, calls, device)
        try:
            return device_op_totals(prof)[0] / calls
        except RuntimeError:
            EMPTY_WINDOWS += 1
            logger.warning("profiler window of %d call(s) held no device "
                           "activity (%d in this process)%s", calls,
                           EMPTY_WINDOWS, "" if retry else "; profiling "
                           "it once more")
            if retry:
                raise


def device_name(device=None) -> str:
    """The card as `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader` gives it ("NVIDIA H100 80GB HBM3, 700.00 W"),
    or "cpu" for a CPU device."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return "cpu"
    idx = torch.cuda.current_device() if dev.index is None else dev.index
    out = subprocess.run(
        ["nvidia-smi", f"--id={idx}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]
