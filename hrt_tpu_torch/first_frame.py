"""The first frames of a fresh process on the card, with the frame
program captured as a CUDA graph and op by op.

Each run is a process of its own that imports the port, makes the CUDA
context, loads the kernel library, builds bench_full's
primary_800x600 loop (the bench scene, its SAH accel and BVH8 records)
and steps it `--frames` times.  In `graph` mode the first step runs the
frame op by op as the warm-up and captures it, and the later steps
replay it; in `eager` mode every step runs inside graphs.disable().  It
reports the host ms (after a synchronise) of each stage: the imports,
the context, the library's load, the loop's set-up, and each step, with
the capture's ms and node count.  The runs go in turns (graph, eager,
eager, graph), so that both see the same warm file caches.

    python -m hrt_tpu_torch.first_frame [--frames 3] [--pairs 1]

It needs a CUDA device; the kernel library is built once before the
runs.  One JSON line a run, then the card's name and power limit, then
a JSON line of all runs.
"""
import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(mode: str, frames: int) -> dict:
    """One run in this process (imported lazily, so that the imports are
    timed)."""
    t0 = time.perf_counter()
    import torch

    from . import graphs
    from .bench_full import configs
    from .frameloop import FrameLoop
    from .kernels import build

    stages = {"import_ms": (time.perf_counter() - t0) * 1e3}

    def stage(name, fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = (time.perf_counter() - t) * 1e3
        return out

    stage("context_ms", lambda: torch.zeros(1, device="cuda"))
    stage("library_ms", build.load)
    bc = next(c for c in configs() if c.name == "primary_800x600")
    loop = stage("loop_setup_ms", lambda: FrameLoop(
        bc.scene(), bc.config, cull_threshold_px=0.0, device="cuda"))
    steps = []
    with graphs.disable() if mode == "eager" else contextlib.nullcontext():
        for _ in range(frames):
            t = time.perf_counter()
            loop.step(bc.camera)
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t) * 1e3)
    prog = loop.program.last
    return {"mode": mode, **stages, "step_ms": steps,
            "capture_ms": None if prog is None else prog.graph.capture_ms,
            "nodes": None if prog is None else prog.graph.nodes,
            "captures": loop.captures,
            "process_to_first_frame_ms":
                (time.perf_counter() - t0) * 1e3 - sum(steps[1:])}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(prog="python -m hrt_tpu_torch.first_frame")
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--pairs", type=int, default=1)
    ap.add_argument("--child", choices=("graph", "eager"), default=None)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(child(args.child, args.frames)), flush=True)
        return []
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("first_frame: needs a CUDA device")
    from .kernels import build
    from .utils.profiling import device_name

    build.build()
    runs = []
    for p in range(args.pairs):
        for mode in ("graph", "eager", "eager", "graph"):
            out = subprocess.run(
                [sys.executable, "-m", "hrt_tpu_torch.first_frame", "--child",
                 mode, "--frames", str(args.frames)], cwd=ROOT, check=True,
                capture_output=True, text=True, timeout=600).stdout
            rec = json.loads(out.strip().splitlines()[-1])
            print(json.dumps(rec), flush=True)
            runs.append(rec)
    print(device_name("cuda"), flush=True)
    print(json.dumps({"runs": runs}), flush=True)
    return runs


if __name__ == "__main__":
    main()
