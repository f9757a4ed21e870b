"""The port's full benchmark suite (the JAX package's
scripts/bench_full.py): BASELINE's seven configurations through
FrameLoop, one JSON line each.

    python -m hrt_tpu_torch.bench_full [--only NAME] [--out FILE] [--device cuda]

Each configuration is the JAX script's: the same scene, camera,
RenderConfig and `two_level`, through `FrameLoop(scene, cfg,
cull_threshold_px=0.0, two_level=...)`.  `time_loop` warms the loop up
with one step (on the card it also captures the loop's frame program;
its capture ms and node count are printed on a line before the
configuration's JSON line), then takes the best of 3 batches of 4 steps
(replays) by the host clock after a synchronise, and the device ms of one step from a
profile of 4 steps (utils/profiling.
device_ms_per_call, which raises rather than leave the number out).  On
the CPU (`--device cpu`, the plain versions) no device time exists and
`device_ms_per_frame` is null.

A line holds bench_full's keys (`config`, `resolution`, `output` (the
image's HxW, as JAX writes it),
`ms_per_frame`, `device_ms_per_frame`, `mrays_per_sec`,
`device_mrays_per_sec`, `max_depth`, `notes`), the card (`device`) and
the peak bytes the caching allocator held during the configuration
(`peak_bytes`, null on the CPU).  Rays are bench.py's count
(utils/logging.rays_per_frame).  `--only NAME` (or HRT_BENCH_ONLY) runs
the configurations whose name holds NAME and merges their lines into
the `--out` file; without it the file is rewritten.  `--resolution WxH`
renders every configuration at WxH instead of its own size, so that a
CPU run stays small.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Callable, NamedTuple

import torch

from .config import RenderConfig, resolve_device
from .frameloop import FrameLoop
from .graphs import capture_line
from .models.camera import Camera
from .models.scene import (Scene, bench_scene, instance_grid_scene,
                           many_lights_scene)
from .models.scenefile import cornell_box
from .utils.logging import timed
from .utils.profiling import (device_memory_stats, device_ms_per_call,
                              device_name, frame_stats, timed_call)

OUT = "bench_full_torch.json"
DEMO_CAM = Camera(position=(0, -1, -6), rotation=(-0.15, 0, 0))
CORNELL_CAM = Camera(position=(0, 0, -3.2), fov_y=0.7)


class BenchConfig(NamedTuple):
    name: str
    scene: Callable[[], Scene]
    camera: Camera
    config: RenderConfig
    notes: str = ""
    two_level: bool = False


def configs() -> list[BenchConfig]:
    """The seven configurations, in the JAX script's order."""
    return [
        # 1. Primary rays only.
        BenchConfig("primary_800x600", bench_scene, DEMO_CAM,
                    RenderConfig(width=800, height=600, max_depth=1,
                                 sky=True, traversal="pallas")),
        # 2. Whitted-style: reflections, refractions, hard shadows.
        BenchConfig("whitted_800x600", cornell_box, CORNELL_CAM,
                    RenderConfig(width=800, height=600, max_depth=4,
                                 indirect=True, russian_roulette=False,
                                 traversal="pallas")),
        # 3. A triangle-mesh scene (the Cornell box).
        BenchConfig("mesh_bvh_800x600", cornell_box, CORNELL_CAM,
                    RenderConfig(width=800, height=600, max_depth=2,
                                 sky=False, traversal="pallas")),
        # 4. Path tracing at 1080p, 1 spp.
        BenchConfig("path_tracing_1080p", bench_scene, DEMO_CAM,
                    RenderConfig(width=1920, height=1080, max_depth=5,
                                 sky=True, indirect=True, jitter=True,
                                 accumulate=True, sort_bounces=True,
                                 traversal="pallas")),
        # 5. 4K out: 1080p path traced, SVGF, the learned 2x upscaler.
        BenchConfig("animated_4k_upscaled", bench_scene, DEMO_CAM,
                    RenderConfig(width=1920, height=1080, max_depth=3,
                                 sky=True, indirect=True, jitter=True,
                                 denoise=True, sort_bounces=True, upscale=2,
                                 traversal="pallas"),
                    notes="3840x2160 output via denoise + learned 2x "
                          "upscale"),
        # 6. Many instances through the two-level walk (K4).
        BenchConfig("instanced_tlas_512x384", instance_grid_scene, DEMO_CAM,
                    RenderConfig(width=512, height=384, max_depth=1,
                                 sky=True),
                    notes="256 instances, two-level TLAS->BLAS kernel",
                    two_level=True),
        # 7. 256 lights sampled through the light tree.
        BenchConfig("many_lights_256_512x384",
                    lambda: many_lights_scene(256), DEMO_CAM,
                    RenderConfig(width=512, height=384, max_depth=1,
                                 sky=True, light_samples=2,
                                 light_sampler="bvh", traversal="pallas"),
                    notes="256 point lights, light-BVH NEE, 2 "
                          "samples/pixel"),
    ]


def time_loop(loop: FrameLoop, cam: Camera, frames: int = 4,
              batches: int = 3):
    """(best host-clock seconds per step over `batches` batches of
    `frames` steps after one warm-up step, the device ms of one step
    (None on the CPU), the last image's shape)."""
    dev = loop.device
    timed_call(lambda: loop.step(cam), dev)
    best = float("inf")
    for _ in range(batches):
        imgs, sec, _ = timed_call(
            lambda: [loop.step(cam) for _ in range(frames)], dev)
        best = min(best, sec / frames)
    dev_ms = (device_ms_per_call(lambda: loop.step(cam), calls=frames,
                                 device=dev)
              if dev.type == "cuda" else None)
    return best, dev_ms, tuple(imgs[-1].shape)


def run_config(bc: BenchConfig, dev, resolution=None,
               card: str = "cpu") -> dict:
    """One configuration's record."""
    cfg = bc.config
    if resolution is not None:
        cfg = dataclasses.replace(cfg, width=resolution[0],
                                  height=resolution[1])
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with timed(f"{bc.name}: FrameLoop set-up"):
        loop = FrameLoop(bc.scene(), cfg, cull_threshold_px=0.0,
                         two_level=bc.two_level, device=dev)
    dt, dev_ms, shape = time_loop(loop, bc.camera)
    line = capture_line(bc.name, loop.program)
    if line:
        print(line, flush=True)
    stats = frame_stats(cfg, loop.scene.lights.shape[0], dt)
    rays = stats["rays"]
    peak = device_memory_stats(dev).get("peak_bytes_in_use")
    return {
        "config": bc.name,
        "resolution": f"{cfg.width}x{cfg.height}",
        "output": "x".join(map(str, shape[:2])),      # HxW, as JAX
        "ms_per_frame": dt * 1e3,
        "device_ms_per_frame": dev_ms,
        "mrays_per_sec": rays / dt / 1e6,
        "device_mrays_per_sec": (None if dev_ms is None
                                 else rays / dev_ms / 1e3),
        "max_depth": cfg.max_depth,
        "notes": bc.notes,
        "device": card,
        "peak_bytes": peak,
    }


def parse_resolution(text):
    """"WxH" -> (W, H); None stays None."""
    if text is None:
        return None
    w, h = text.lower().split("x")
    return int(w), int(h)


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="python -m hrt_tpu_torch.bench_full")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--only", default=os.environ.get("HRT_BENCH_ONLY"),
                    help="run the configurations whose name holds this "
                         "(default: HRT_BENCH_ONLY)")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--resolution", default=None,
                    help="WxH for every configuration (small CPU runs)")
    return ap.parse_args(argv)


def main(argv=None) -> list[dict]:
    """Run the configurations, print a line each, write `--out`.
    Returns the records of this run."""
    args = parse_args(sys.argv[1:] if argv is None else argv)
    dev = resolve_device(args.device)
    res = parse_resolution(args.resolution)
    card = device_name(dev)
    results = []
    for bc in configs():
        if args.only and args.only not in bc.name:
            continue
        rec = run_config(bc, dev, res, card)
        results.append(rec)
        print(json.dumps(rec), flush=True)
    out = results
    if args.only and os.path.exists(args.out):
        # Merge the re-run configurations into the existing record.
        with open(args.out) as f:
            prev = {r["config"]: r for r in json.load(f)}
        prev.update({r["config"]: r for r in results})
        out = list(prev.values())
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    return results


if __name__ == "__main__":
    main()
