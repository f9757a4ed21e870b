"""The one-line Mray/s benchmark of the port (the JAX package's bench.py).

    python -m hrt_tpu_torch.bench [--device cuda] [--iters 32] [--batches 4]

The bench scene (models/scene.bench_scene) under a binned-SAH tree with
32-triangle leaves and its BVH8 records, at 512x384, max_depth=1, sky
on: `renderer.render_frames` renders `--iters` frames a call, once to
warm up (on the card this call also captures the k frames' CUDA graph,
and the capture's ms and node count are printed on a line of their
own), then `--batches` times, each batch a replay timed by the host
clock after a synchronise and by CUDA events around it.  The value is
bench.py's: the rays a frame is credited with (utils/logging.
rays_per_frame) over the best batch's seconds per frame.

Prints one JSON line: `metric`, `value`, `unit` as bench.py, with
`vs_baseline` null (the JAX benchmark's north star is a TPU target), the
median batch's Mray/s, each batch's host-clock and CUDA-event ms per
frame, and the card's name and power limit (`device`).  The device
defaults to the first CUDA device and raises without one; `--device
cpu` runs the kernels' plain versions (`--width`, `--height`, `--iters`
and `--batches` let a CPU run stay small).
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys

from .config import RenderConfig, resolve_device
from .models.camera import Camera
from .models.scene import bench_scene
from .ops import lbvh
from .graphs import capture_line
from .renderer import FRAME_PROGRAMS, camera_arrays, render_frames
from .utils.logging import rays_per_frame
from .utils.profiling import device_name, timed_call

BENCH_CAMERA = Camera(position=(0.0, -1.0, -6.0), rotation=(-0.15, 0.0, 0.0))
LEAF_SIZE = 32


def bench_config(width: int = 512, height: int = 384) -> RenderConfig:
    return RenderConfig(width=width, height=height, max_depth=1, sky=True,
                        traversal="auto")


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="python -m hrt_tpu_torch.bench")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=384)
    ap.add_argument("--iters", type=int, default=32,
                    help="frames per render_frames call")
    ap.add_argument("--batches", type=int, default=4)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the benchmark and print its line.  Returns the record
    (`record`), the last batch's frames (`frames`, (iters, H, W, 3)) and
    the first frame index of that batch (`frame0`), with the scene, the
    accel, the camera arrays and the config they were rendered from."""
    args = parse_args(sys.argv[1:] if argv is None else argv)
    dev = resolve_device(args.device)
    cfg = bench_config(args.width, args.height)
    scene = bench_scene().build(dev)
    accel = lbvh.build_bvh_sah(scene, leaf_size=LEAF_SIZE)
    cams = camera_arrays(BENCH_CAMERA, cfg, dev)
    k = args.iters

    timed_call(lambda: render_frames(scene, accel, cams, 0, k, cfg),
               dev)                              # warm-up and capture
    line = capture_line(f"render_frames x{k}", FRAME_PROGRAMS)
    if line:
        print(line, flush=True)
    host_ms, event_ms = [], []
    frame0 = 0
    for b in range(args.batches):
        frame0 = b * k
        imgs, sec, ev = timed_call(
            lambda: render_frames(scene, accel, cams, frame0, k, cfg), dev)
        host_ms.append(sec * 1e3 / k)
        if ev is not None:
            event_ms.append(ev / k)
    rays = rays_per_frame(cfg, scene.lights.shape[0])
    best = min(host_ms)
    rec = {
        "metric": "Mrays/sec/chip",
        "value": rays / best / 1e3,
        "unit": "Mray/s",
        "vs_baseline": None,
        "median": rays / statistics.median(host_ms) / 1e3,
        "batch_ms": host_ms,
        "batch_event_ms": event_ms or None,
        "frames_per_batch": k,
        "rays_per_frame": rays,
        "resolution": f"{cfg.width}x{cfg.height}",
        "device": device_name(dev),
    }
    print(json.dumps(rec), flush=True)
    return {"record": rec, "frames": imgs, "frame0": frame0,
            "scene": scene, "accel": accel, "cams": cams, "config": cfg}


if __name__ == "__main__":
    main()
