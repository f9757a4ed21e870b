"""Build and frame logging (hrt_tpu/utils/logging.py): step-progress
lines, timed blocks, per-frame counters, and the ray count a frame is
credited with (bench.py `rays_per_frame`, copied so that the package
imports nothing of the JAX benchmark)."""
from __future__ import annotations

import logging
import time
from contextlib import contextmanager

logger = logging.getLogger("hrt_tpu_torch")
if not logger.handlers:
    handler = logging.StreamHandler()
    handler.setFormatter(
        logging.Formatter("[%(name)s] %(levelname)s %(message)s"))
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)


def build_step(name: str, step: int, count: int, msg: str) -> None:
    """One progress line: `[name step/count] msg`."""
    logger.info("[%s %d/%d] %s", name, step, count, msg)


@contextmanager
def timed(label: str):
    """Log the block's host-clock time in ms."""
    t0 = time.perf_counter()
    yield
    logger.info("%s: %.2f ms", label, (time.perf_counter() - t0) * 1e3)


def rays_per_frame(cfg, num_lights: int) -> int:
    """Trace queries a frame is credited with: a closest hit and a
    shadow ray per light for each of pixels x spp, times max_depth when
    the config bounces (the JAX benchmark's count)."""
    n = cfg.width * cfg.height * cfg.spp
    per_bounce = 1 + num_lights
    bounces = cfg.max_depth if cfg.indirect else 1
    return n * per_bounce * bounces


class FrameStats:
    """Frames, rays and seconds summed over a run."""

    def __init__(self):
        self.frames = 0
        self.rays = 0
        self.seconds = 0.0

    def add(self, rays: int, seconds: float) -> None:
        self.frames += 1
        self.rays += rays
        self.seconds += seconds

    @property
    def mrays_per_sec(self) -> float:
        return self.rays / max(self.seconds, 1e-9) / 1e6

    @property
    def ms_per_frame(self) -> float:
        return self.seconds / max(self.frames, 1) * 1e3
