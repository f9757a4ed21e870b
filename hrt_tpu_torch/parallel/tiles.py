"""Multi-GPU rendering: row bands over a process group
(hrt_tpu/parallel/tiles.py).

JAX runs the bands as one program over a device mesh (`shard_map`).
Here each rank is a process of its own (torchrun, or farm.initialize):
`make_mesh` wraps the default process group in a one-dimensional
DeviceMesh named "tiles", rank r renders rows [r H / n, (r + 1) H / n)
of the frame through renderer.render_rows, and one all-gather along
rows assembles the (H, W, 3) frame on every rank.  The scene and the
accel are replicated: every rank builds them and takes rank 0's copy
(`replicate`).  A pixel's samples depend only on (px, py, frame), so a
band is bit for bit the same rows of the whole frame.

The post stages (accumulate, SVGF, the upscaler) run on the gathered
frame on every rank, so the loop's state is the same on all of them
(JAX partitions them with GSPMD instead).

`band` and `render_band` render any rank's band in one process: the
tests and the smoke run use them to stand in for n ranks on one device.
"""
from __future__ import annotations

import dataclasses
import os
import warnings

import torch
import torch.distributed as dist

from ..config import RenderConfig, resolve_device
from ..ops.math3d import luminance
from ..renderer import render_rows


def rank_device(device=None) -> torch.device:
    """This rank's device: the CPU for "cpu", else cuda:LOCAL_RANK (0
    without torchrun), made current.  Raises without a card."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    return dev


def init_group(device=None, world_size: int = 1, rank: int = 0,
               init_method: str | None = None) -> torch.device:
    """Start the default process group for this rank: NCCL on a card,
    gloo on the CPU.  Without `init_method` the group has one rank and
    an in-process store.  Returns the rank's device."""
    dev = rank_device(device)
    if init_method is None:
        if world_size != 1:
            raise ValueError("a group of several ranks needs an init_method")
        kw = {"store": dist.HashStore()}
    else:
        kw = {"init_method": init_method}
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            world_size=world_size, rank=rank, **kw)
    return dev


def make_mesh(n_devices: int | None = None, device=None):
    """A one-dimensional "tiles" DeviceMesh over the default process
    group, on `device`'s type (the card unless "cpu").  With no group
    and at most one device asked for, it starts a one-rank group; it
    raises ValueError when more devices are asked for than the group
    has, or when there is no group for them."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(
                f"{n_devices} devices need a process group of {n_devices} "
                f"ranks: launch with torchrun --nproc-per-node {n_devices} "
                "and start the group first (farm.initialize)")
        init_group(device)
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"{n_devices} devices asked for, but the process "
                         f"group has {world} ranks")
    dev = rank_device(device)
    return DeviceMesh.from_group(dist.group.WORLD, dev.type,
                                 mesh_dim_names=("tiles",))


def mesh_device(mesh) -> torch.device:
    """The device this rank works on in `mesh`."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """All-gather every rank's `x` along its first axis, in rank order.
    A bool tensor travels as bytes (NCCL and gloo both take uint8, and
    int32, int64 and float32 as they are)."""
    x = x.contiguous()
    wire = x.view(torch.uint8) if x.dtype == torch.bool else x
    out = wire.new_empty((dist.get_world_size(group) * x.shape[0],)
                         + tuple(x.shape[1:]))
    # torch 2.13 deprecates this name for all_gather_single, which
    # torch 2.11 lacks.
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, wire, group=group)
    return out.view(torch.bool) if x.dtype == torch.bool else out


def band(rank: int, n: int, config: RenderConfig) -> tuple[int, int]:
    """(y0, rows) of rank `rank`'s band of n.  ValueError when n does
    not divide the height."""
    if config.height % n:
        raise ValueError(f"height {config.height} not divisible by {n} "
                         "devices")
    rows = config.height // n
    return rank * rows, rows


def render_band(scene, accel, cam, frame: int, config: RenderConfig,
                rank: int, n: int, want_gbuffer: bool = False,
                plain: bool = False):
    """Rank `rank`'s band of n: render_rows over band(rank, n)."""
    y0, rows = band(rank, n, config)
    return render_rows(scene, accel, cam, y0, rows, config, plain=plain,
                       want_gbuffer=want_gbuffer, frame=frame)


def render_frame_tiled(scene, accel, cam, frame: int, config: RenderConfig,
                       mesh, want_gbuffer: bool = False,
                       plain: bool = False):
    """The (H, W, 3) frame on every rank, each rank tracing its band
    (+ the whole frame's G-buffer dict when want_gbuffer)."""
    group = mesh.get_group()
    out = render_band(scene, accel, cam, frame, config,
                      mesh.get_local_rank(), mesh.size(), want_gbuffer,
                      plain)
    if not want_gbuffer:
        return gather_rows(out, group)
    img, gbuffer = out
    return gather_rows(img, group), {k: gather_rows(v, group)
                                     for k, v in gbuffer.items()}


def frame_program_tiled(scene, accel, cams, prev_cams, dn_state, accum,
                        frame: int, config: RenderConfig, mesh, net=None,
                        up_history=None, plain: bool = False):
    """frameloop.frame_program with the trace and shade split into row
    bands: the gathered frame's post stages run on every rank.  Returns
    (output image, new denoise state, new accumulation buffer, new
    upscaler history)."""
    from ..frameloop import post_stages, wants_gbuffer

    want_gb = wants_gbuffer(config, up_history)
    out = render_frame_tiled(scene, accel, cams, frame, config, mesh,
                             want_gbuffer=want_gb, plain=plain)
    img, gbuffer = out if want_gb else (out, None)
    return post_stages(img, gbuffer, prev_cams, dn_state, accum, frame,
                       config, net, up_history, plain=plain)


def frame_stats_psum(img_shard: torch.Tensor, group=None):
    """Whole-image mean and peak luminance from every rank's shard:
    (mean, peak) as 0-d tensors, the same on every rank."""
    lum = luminance(img_shard)
    total = torch.stack([lum.sum(), lum.new_tensor(float(lum.numel()))])
    peak = lum.max()
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    dist.all_reduce(peak, op=dist.ReduceOp.MAX, group=group)
    return total[0] / total[1], peak


def replicate(tree, mesh):
    """`tree` (a SceneData, Accel or TwoLevelFlat, or any tuple, list or
    dataclass of them) with every tensor on this rank's device and equal
    to rank 0's."""
    dev, group = mesh_device(mesh), mesh.get_group()
    src = dist.get_global_rank(group, 0)

    def move(x):
        if isinstance(x, torch.Tensor):
            x = x.to(dev).contiguous()
            dist.broadcast(x.view(torch.uint8) if x.dtype == torch.bool
                           else x, src=src, group=group)
            return x
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return dataclasses.replace(x, **{
                f.name: move(getattr(x, f.name))
                for f in dataclasses.fields(x) if f.init})
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*map(move, x))
        if isinstance(x, (tuple, list)):
            return type(x)(map(move, x))
        return x

    return move(tree)
