"""How often a torch.profiler window on the card comes back with no
device activity, before and after the frame loops' captured programs
have run in the process.

    python -m hrt_tpu_torch.profile_probe [--windows 300]

Each window is `utils/profiling.profile_calls(fn, 1)` (one warm-up call,
one call profiled) and counts as empty when `device_op_totals` finds no
CUDA activity in it.  `fn` is first the texture lookup that chip_smoke.py
phase 35 profiles (`sample_texture_p`, a 256x256 texture, 480,000 rays,
45% of them textured: a window of a fraction of a millisecond), then,
after a culled orbit (`FrameLoop` over `instance_grid_scene()` at
512x384, a rebuild each step) and an animated two-level loop (a refit
each step) have run 8 steps each, the same lookup again and a step of
each loop.  The probe uses only entry points that the port has had
since its frame programs, so a copy of it runs over an older checkout's
package too.  Prints one JSON line of counts, then the card's name and
power limit.  It needs a CUDA device: on the CPU the profile readers
raise.
"""
from __future__ import annotations

import argparse
import json

import torch

from .config import RenderConfig, resolve_device
from .frameloop import FrameLoop
from .models.camera import orbit_camera
from .models.scene import instance_grid_scene
from .models.textures import sample_texture_p
from .utils.profiling import device_name, device_op_totals, profile_calls


def empty_windows(fn, windows: int) -> int:
    """Windows of one fn() call whose profile holds no device activity."""
    empty = 0
    for _ in range(windows):
        prof, _ = profile_calls(fn, 1)
        try:
            device_op_totals(prof)
        except RuntimeError:
            empty += 1
    return empty


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--windows", type=int, default=300)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    g = torch.Generator().manual_seed(0)
    n = 480_000
    textures = torch.rand((1, 256, 256, 3), generator=g).to(dev)
    tex_id = torch.where(torch.rand(n, generator=g) < 0.45, 0, -1) \
        .to(torch.int32).to(dev)
    u, v = (torch.rand(n, generator=g).mul(4.0).to(dev) for _ in range(2))
    tex = lambda: sample_texture_p(textures, tex_id, u, v)

    out = {"windows": args.windows,
           "texture_before": empty_windows(tex, args.windows)}
    cfg = RenderConfig(width=512, height=384, max_depth=1, sky=True)
    culled = FrameLoop(instance_grid_scene(), cfg, device=dev)
    animated = FrameLoop(instance_grid_scene(), cfg, two_level=True,
                         device=dev)
    cams = [orbit_camera(0.15 * f, radius=4.0, height=-1.0)
            for f in range(8)]
    for f, cam in enumerate(cams):
        culled.step(cam)
        animated.set_instance_transform(1 + f, position=(0.2 * f, -1.0,
                                                         0.3))
        animated.step(cams[0])
    out["culled_rebuilds"] = culled.rebuilds
    out["texture_after"] = empty_windows(tex, args.windows)
    k = max(args.windows // 10, 1)
    out["culled_step"] = empty_windows(
        lambda: culled.step(cams[len(cams) - 1]), k)
    out["animated_step"] = empty_windows(lambda: animated.step(cams[0]), k)
    out["step_windows"] = k
    print(json.dumps(out))
    print(device_name(dev))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
