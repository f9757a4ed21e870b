"""What the row-band gathers cost a post frame on the card
(hrt_tpu_torch.parallel, one-rank NCCL group).

    python3 scripts/torch_parallel_probe.py

Needs a CUDA device and nvcc.  At 1920x1080 -> 3840x2160 (SVGF and the
temporal 2x upscaler over the bench frame, chip_smoke.py phase 22's
config) it prints:
- ms/frame (CUDA events, median of 7) of the loop without a mesh, of
  FrameLoop(mesh) over a one-rank NCCL group, and of the same mesh loop
  with tiles.gather_rows replaced by the identity, in turns (plain,
  nccl, identity, identity, nccl, plain) three times;
- the all-gather of a 1080p frame and a device copy of it (10 per
  CUDA-event pair), and gather_rows' host cost per call;
- under torch.profiler, each loop's kernel launches and device ms per
  step, and its host ms of operator time per step.
"""
from __future__ import annotations

import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as c  # noqa: E402
from hrt_tpu_torch.config import RenderConfig  # noqa: E402
from hrt_tpu_torch.frameloop import FrameLoop  # noqa: E402
from hrt_tpu_torch.kernels import build  # noqa: E402
from hrt_tpu_torch.models.scene import bench_scene  # noqa: E402
from hrt_tpu_torch.parallel import tiles  # noqa: E402


def profiled(step, steps: int = 3):
    """(launches, device ms, host operator ms) per step."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    ka = prof.key_averages()
    launches = sum(e.count for e in ka if e.key == "cudaLaunchKernel")
    dev = sum(e.self_device_time_total for e in ka
              if e.device_type == torch.autograd.DeviceType.CUDA)
    host = sum(e.self_cpu_time_total for e in ka)
    return launches / steps, dev / 1e3 / steps, host / 1e3 / steps


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    build.build()
    build.load()
    dev = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(0), flush=True)
    post = RenderConfig(width=1920, height=1080, max_depth=1, sky=True,
                        denoise=True, upscale=2, upscale_mode="temporal")
    loop = FrameLoop(bench_scene(), post, device=dev)
    mesh = tiles.make_mesh(1)
    tloop = FrameLoop(bench_scene(), post, mesh=mesh)
    gather = tiles.gather_rows

    def mesh_step(fn):
        def step():
            tiles.gather_rows = fn
            try:
                return tloop.step(c.post_cam(3))
            finally:
                tiles.gather_rows = gather
        return step

    steps = {"plain": lambda: loop.step(c.post_cam(3)),
             "nccl": mesh_step(gather),
             "identity": mesh_step(lambda x, group: x.contiguous())}
    times = {k: [] for k in steps}
    for _ in range(3):
        for k in ("plain", "nccl", "identity", "identity", "nccl", "plain"):
            times[k].append(c.time_ms(steps[k]))
    for k, v in times.items():
        print(f"{k}: ms/frame {[round(x, 4) for x in v]}, median "
              f"{statistics.median(v):.4f}", flush=True)
    x = torch.randn(1080, 1920, 3, device=dev)
    group = mesh.get_group()
    gather_ms = c.time_ms(lambda: gather(x, group), calls=10)
    copy_ms = c.time_ms(lambda: x.clone(), calls=10)
    host_us = c.host_ms(lambda: [gather(x[:8], group)
                                 for _ in range(100)]) * 10
    print(f"all-gather of a 1080p frame {gather_ms:.4f} ms, a copy "
          f"{copy_ms:.4f} ms; gather_rows host cost {host_us:.2f} us a "
          "call", flush=True)
    for k in ("plain", "nccl"):
        launches, dev_ms, host_ms = profiled(steps[k])
        print(f"{k} under the profiler: {launches:.0f} launches, "
              f"{dev_ms:.3f} device ms, {host_ms:.3f} host operator ms a "
              "step", flush=True)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
