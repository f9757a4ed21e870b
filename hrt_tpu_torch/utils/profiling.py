"""Profiling (hrt_tpu/utils/profiling.py): a torch.profiler trace around
frames, per-stage timers fenced on the device, a per-frame stats dict and
the device memory snapshot."""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

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


class StageTimer:
    """Host-clock per-stage timers; a stage given a `fence` tensor waits
    for its device before the clock is read."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, fence=None) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        if fence is not None and fence.is_cuda:
            torch.cuda.synchronize(fence.device)
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> dict[str, float]:
        """Mean ms per stage."""
        return {k: round(v * 1e3 / max(self.counts[k], 1), 3)
                for k, v in self.totals.items()}


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
