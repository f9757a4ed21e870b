"""The render command (hrt_tpu/cli.py): renders frames of a scene
through FrameLoop, a scripted camera, and writes PNGs.

Usage:
  python -m hrt_tpu_torch.render --scene demo --out frame.png --sky
  python -m hrt_tpu_torch.render --scene scenes/cornell.yaml --frames 8 --orbit
  python -m hrt_tpu_torch.render --scene demo --device cpu   # plain versions

Every flag of the JAX package's command, plus `--device` (default
`cuda`: the kernels, and an error without a card; `cpu` runs their plain
versions).  `--upscaler-ckpt` reads an `.npz` of the upscaler's
flax-keyed parameters (utils/checkpoint.py), `--checkpoint` resumes and
saves the frame loop's state (FrameLoop.load_state / save_state, the
JAX package's npz keys), `--debug-nans` raises on a non-finite frame.
With `HRT_KERNEL_GUARDS=1` the BVH8 walks run guarded and the command
raises after a frame whose walks recorded an index violation
(ops/traversal_wide8.check_pending_guards), as the JAX command does.

`--stats` prints a last line of JSON: frames, ms a frame, Mray/s, and
from the program's tracing, which it turns on (utils/tracing.py), each
frame stage's ms, each span's mean host ms and the live-lane share.

`--devices N` > 1 renders each frame in N row bands, one process per
GPU, launched by torchrun:

  torchrun --nproc-per-node N -m hrt_tpu_torch.render --devices N ...

Each rank renders its band (parallel/tiles.py); rank 0 alone logs and
writes the PNGs, the stats line and the checkpoint.  Without torchrun's
environment, or with a WORLD_SIZE other than N, it raises ValueError.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from .config import CONFIGS, RenderConfig, resolve_device
from .graphs import capture_line
from .models.camera import Camera, orbit_camera
from .ops import traversal_wide8
from .utils import tracing
from .utils.image import tonemap, write_png
from .utils.logging import FrameStats, build_step, logger, rays_per_frame


def load_scene(spec: str):
    """A built-in scene (demo, bench, cornell), a YAML scene file or an
    OBJ model (grey, one light, one instance)."""
    from .models.scene import Scene, bench_scene, reference_demo_scene
    from .models.scenefile import cornell_box, load_scene_yaml

    if spec == "demo":
        return reference_demo_scene()
    if spec == "bench":
        return bench_scene()
    if spec == "cornell":
        return cornell_box()
    if spec.endswith((".yaml", ".yml")):
        return load_scene_yaml(spec)
    if spec.endswith(".obj"):
        sc = Scene()
        sc.load_model(spec)
        sc.create_material((0.8, 0.8, 0.8), 0.0, 0.8)
        sc.create_light((0.0, -3.0, -3.0), (1.0, 1.0, 1.0), 20.0)
        sc.create_instance(0, 0)
        return sc
    raise SystemExit(f"unknown scene: {spec}")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="hrt_tpu_torch.render")
    ap.add_argument("--scene", default="demo")
    ap.add_argument("--out", default="frame.png")
    ap.add_argument("--config", default=None,
                    help=f"named config: {', '.join(CONFIGS)}")
    ap.add_argument("--width", type=int, default=800)
    ap.add_argument("--height", type=int, default=600)
    ap.add_argument("--spp", type=int, default=1)
    ap.add_argument("--max-depth", type=int, default=2)
    ap.add_argument("--sky", action="store_true")
    ap.add_argument("--indirect", action="store_true")
    ap.add_argument("--denoise", action="store_true")
    ap.add_argument("--traversal", default="auto",
                    help="auto | bvh | pallas (the accel's walk) | "
                         "bruteforce (every triangle, no accel)")
    ap.add_argument("--frames", type=int, default=1)
    ap.add_argument("--orbit", action="store_true",
                    help="animate camera on an orbit path")
    ap.add_argument("--camera", type=float, nargs=6,
                    metavar=("X", "Y", "Z", "RX", "RY", "RZ"),
                    default=(0.0, 0.0, -2.0, 0.0, 0.0, 0.0))
    ap.add_argument("--gamma", type=float, default=2.2)
    ap.add_argument("--stats", action="store_true",
                    help="print the stats line; turns the program's "
                         "tracing on (utils/tracing.py): per-stage ms, "
                         "per-span host ms and the live-lane share")
    ap.add_argument("--upscale", type=int, default=1, choices=(1, 2))
    ap.add_argument("--upscale-mode", default="spatial",
                    choices=("spatial", "temporal"),
                    help="temporal = ray-reconstruction mode "
                         "(reprojected history)")
    ap.add_argument("--upscaler-ckpt", default=None,
                    help=".npz of the upscaler's parameters "
                         "(utils/checkpoint.py)")
    ap.add_argument("--checkpoint", default=None,
                    help="npz frame-loop state to resume/save")
    ap.add_argument("--debug-nans", action="store_true",
                    help="raise on a frame with a NaN or an infinity")
    ap.add_argument("--two-level", action="store_true",
                    help="BLAS-per-mesh + TLAS traversal (instanced/"
                         "animated scenes)")
    ap.add_argument("--devices", type=int, default=1,
                    help="GPUs to render over in row bands (N > 1: one "
                         "process each, under torchrun)")
    ap.add_argument("--preview", action="store_true",
                    help="serve a live interactive viewer (WASD/arrow "
                         "camera) instead of writing files")
    ap.add_argument("--port", type=int, default=8000,
                    help="preview server port")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain "
                         "versions)")
    return ap


def render_config(args) -> RenderConfig:
    """The named config, or the one the flags describe."""
    if args.config:
        return CONFIGS[args.config]
    return RenderConfig(width=args.width, height=args.height,
                        spp=args.spp, max_depth=args.max_depth,
                        sky=args.sky, indirect=args.indirect,
                        jitter=args.indirect, denoise=args.denoise,
                        upscale=args.upscale,
                        upscale_mode=args.upscale_mode,
                        traversal=args.traversal)


def frame_path(out: str, f: int, frames: int) -> str:
    """Frame f's PNG: `out` itself for a single frame, else with the
    frame number before `.png`."""
    return out.replace(".png", f"_{f:04d}.png") if frames > 1 else out


def tiled_mesh(devices: int, device):
    """The "tiles" mesh of a --devices run, over the process group that
    torchrun's environment describes (started here unless one is
    running).  Returns (mesh, whether this call started the group)."""
    import torch.distributed as dist

    from .parallel import tiles

    world = os.environ.get("WORLD_SIZE")
    if world is None or int(world) != devices:
        raise ValueError(
            f"--devices {devices} runs one process per device: launch it "
            f"as torchrun --nproc-per-node {devices} -m hrt_tpu_torch.render "
            f"--devices {devices} ... (WORLD_SIZE is {world})")
    started = not dist.is_initialized()
    if started:
        # env:// reads RANK, MASTER_ADDR and MASTER_PORT (rank -1).
        tiles.init_group(device, devices, -1, "env://")
    return tiles.make_mesh(devices, device), started


def main(argv=None):
    """Run the command; returns the FrameLoop it drove."""
    args = build_parser().parse_args(argv)
    mesh, started = None, False
    if args.devices > 1:
        if args.preview:
            raise ValueError("--preview serves one process: drop --devices")
        mesh, started = tiled_mesh(args.devices, args.device)
    lead = mesh is None or mesh.get_local_rank() == 0
    # Rank 0 alone logs and writes.
    quiet = logger.disabled
    logger.disabled = quiet or not lead
    traced = tracing.enabled()
    if args.stats:
        tracing.enable()
        tracing.reset()
    try:
        return _run(args, mesh, lead)
    finally:
        logger.disabled = quiet
        if not traced:
            tracing.disable()
        if started:
            import torch.distributed as dist

            dist.destroy_process_group()


def _run(args, mesh, lead: bool):
    device = resolve_device(args.device) if mesh is None else None
    cfg = render_config(args)

    from .frameloop import FrameLoop

    build_step("SCENE", 0, 2, f"Loading scene '{args.scene}'...")
    scene_obj = load_scene(args.scene)
    build_step("SCENE", 1, 2, "Building scene + acceleration structure...")
    up_params = None
    if args.upscaler_ckpt:
        from .utils.checkpoint import load_params

        up_params = load_params(args.upscaler_ckpt)
    loop = FrameLoop(scene_obj, cfg, upscaler_params=up_params,
                     cull_threshold_px=1.0 if args.frames > 1 else 0.0,
                     two_level=args.two_level, mesh=mesh, device=device)
    device = loop.device
    if mesh is not None:
        logger.info("multi-GPU mode: %d ranks in row bands", mesh.size())
    if args.checkpoint and os.path.exists(args.checkpoint):
        loop.load_state(args.checkpoint)
        logger.info("resumed frame-loop state from %s (frame %d)",
                    args.checkpoint, loop.frame)
    build_step("SCENE", 2, 2, "Scene created!")

    cam = Camera(position=tuple(args.camera[:3]),
                 rotation=tuple(args.camera[3:]))
    if args.preview:
        from .preview import run_preview

        run_preview(loop, cam, port=args.port, gamma=args.gamma,
                    max_frames=(args.frames if args.frames > 1
                                else None))
        return loop
    stats = FrameStats()
    num_lights = loop.scene.lights.shape[0]
    for f in range(args.frames):
        if args.orbit:
            cam = orbit_camera(f * 0.15, radius=4.0, height=-1.0)
        t0 = time.perf_counter()
        img = loop.step(cam)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        if traversal_wide8.GUARDS:  # HRT_KERNEL_GUARDS=1
            traversal_wide8.check_pending_guards()
        if args.debug_nans and not bool(torch.isfinite(img).all()):
            raise FloatingPointError(f"frame {f}: non-finite values")
        stats.add(rays_per_frame(cfg, num_lights), dt)
        if lead:
            out = frame_path(args.out, f, args.frames)
            write_png(out, tonemap(img.cpu().numpy(), gamma=args.gamma))
            logger.info("frame %d -> %s (%.1f ms)", f, out, dt * 1e3)

    line = capture_line("FrameLoop.step", loop.program)
    if line and lead:
        print(line, flush=True)
    if args.checkpoint and lead:
        loop.save_state(args.checkpoint)
        logger.info("saved frame-loop state to %s", args.checkpoint)

    if args.stats and lead:
        print(json.dumps({
            "frames": stats.frames,
            "ms_per_frame": round(stats.ms_per_frame, 2),
            "mrays_per_sec": round(stats.mrays_per_sec, 2),
            **trace_stats(tracing.snapshot()),
        }))
    return loop


def trace_stats(snap: dict) -> dict:
    """The stats line's part from the program's tracing: the frames'
    stage ms (`stage_ms` on the card, `host_stage_ms` on the CPU), each
    span's mean host ms (`span_ms`), the live-lane share, and where the
    run moved instances each clock's total ms and count (`clock_ms` on
    the card, `host_clock_ms` on the CPU: the refits)."""
    out = {k: {name: round(v, 4) for name, v in snap[k].items()}
           for k in ("stage_ms", "host_stage_ms") if k in snap}
    out["span_ms"] = {k: round(v["total_ms"] / v["count"], 4)
                      for k, v in snap["spans"].items()}
    out["live_lane_share"] = snap["live_lane_share"]
    for k in ("clock_ms", "host_clock_ms"):
        if k in snap:
            out[k] = {name: {"total_ms": round(v["total_ms"], 4),
                             "count": v["count"]}
                      for name, v in snap[k].items()}
    return out
