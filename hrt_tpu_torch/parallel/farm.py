"""Render farm: frame ranges split over processes
(hrt_tpu/parallel/farm.py).

Rendering an animation is parallel over frames.  Each process renders
its share of [0, num_frames) through a FrameLoop of its own: with
`chunked=True` (the default) a contiguous block, so that its temporal
state (accumulation, denoiser history) follows consecutive frames; with
`chunked=False` every process_count-th frame.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterator

import torch.distributed as dist

from . import tiles


@dataclasses.dataclass(frozen=True)
class FarmPlan:
    process_index: int
    process_count: int
    num_frames: int
    chunked: bool = True  # contiguous blocks (temporal-state friendly)

    def frames(self) -> Iterator[int]:
        if self.chunked:
            per = -(-self.num_frames // self.process_count)
            start = self.process_index * per
            yield from range(start, min(start + per, self.num_frames))
        else:
            yield from range(self.process_index, self.num_frames,
                             self.process_count)


def _rank_and_size() -> tuple[int, int]:
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, device=None) -> FarmPlan:
    """Start the default process group at `coordinator` ("host:port"):
    NCCL on the card (cuda:LOCAL_RANK), gloo with device="cpu".  Without
    a coordinator it starts nothing.  Returns this process's plan (rank
    and world size of the group, 0 and 1 without one; num_frames 0)."""
    if coordinator is not None:
        tiles.init_group(device, num_processes, process_id,
                         f"tcp://{coordinator}")
    return FarmPlan(*_rank_and_size(), num_frames=0)


def render_frames(loop, camera_path: Callable[[int], object],
                  num_frames: int, on_frame: Callable[[int, object], None],
                  plan: FarmPlan | None = None) -> int:
    """Render this process's share of [0, num_frames) through a
    FrameLoop.  camera_path(frame) -> Camera; on_frame(frame, image)
    consumes each result.  Returns the number of frames rendered."""
    if plan is None:
        plan = FarmPlan(*_rank_and_size(), num_frames)
    else:
        plan = dataclasses.replace(plan, num_frames=num_frames)
    count = 0
    for f in plan.frames():
        on_frame(f, loop.step(camera_path(f)))
        count += 1
    return count
