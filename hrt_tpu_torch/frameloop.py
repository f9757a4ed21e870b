"""Frame loop: the host-side driver that holds cross-frame state
(hrt_tpu/frameloop.py `FrameLoop` and `_post_stages`).

One `step` renders frame `frame` (the index seeds the frame's samples
and jitter) through renderer.render_rows, then runs the
post stages (`post_stages`): with `config.accumulate` it folds the frame
into the running mean; with `config.denoise` it runs SVGF
(ops/denoise.py, its history fetch through K6); with `config.upscale
== 2` the learned 2x upscaler (models/upscaler.py), in temporal mode
with the previous HR output warped onto the frame through K6.  The
denoiser and the temporal upscaler read the frame's G-buffer, and the
previous step's camera (`prev_cams`).

With `two_level=True` the accel is the instanced TwoLevelFlat
(ops/tlas.py) and `set_instance_transform` animates an instance by
refitting the TLAS; otherwise it starts as the single-level SAH Accel,
and with `cull_threshold_px > 0` (the default, as in the JAX package)
each step first updates the instances' visibility (ops/culling.py) and,
when it changed, rebuilds the accel with the LBVH over the visible
triangles (its walks take K3).  With `traversal="bruteforce"` a
single-level loop builds no accel (`accel` is None), traces by brute
force and skips culling.  Two-level loops skip culling, as in the JAX
package.

With a `mesh` (parallel/tiles.make_mesh) the loop is one rank of a
multi-GPU render: its scene and accel are replicated from rank 0, each
step traces this rank's row band and gathers the frame
(parallel/tiles.frame_program_tiled), and the post stages run on the
whole frame on every rank.  Over NCCL that step replays the loop's
captured program as a one-device step does, the all-gathers inside the
graph and the mesh in its key; over gloo, which stages its collectives
through the host, it runs op by op.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from . import graphs
from .config import RenderConfig, require_slice, resolve_device
from .models import upscaler
from .models.camera import Camera
from .models.instance import MeshInstance
from .models.scene import Scene, SceneData
from .ops import culling, denoise, lbvh, rng, tlas
from .parallel import tiles
from .renderer import camera_arrays, render_rows
from .utils import tracing
from .utils.interop import upscaler_from_numpy


def _temporal_up(config: RenderConfig, up_history) -> bool:
    return (config.upscale == 2 and config.upscale_mode == "temporal"
            and up_history is not None)


def wants_gbuffer(config: RenderConfig, up_history) -> bool:
    """Whether the post stages read the frame's G-buffer."""
    return config.denoise or _temporal_up(config, up_history)


def post_stages(img, gbuffer, prev_cams, dn_state, accum, frame,
                config: RenderConfig, net, up_history, plain: bool = False):
    """accumulate -> denoise -> upscale on one (H, W, 3) frame of index
    `frame` (an int or a 0-d integer tensor, rng.as_frame: the frame
    count and the temporal gate are taken on the device, as the JAX
    package's `_post_stages`).  Returns (output image, new denoise
    state, new accumulation buffer, new upscaler history).  `plain=True`
    routes the K6 warps to their plain version on whatever device the
    tensors are on.  Each stage that runs starts with its stage clock
    (utils/tracing.mark: `accumulate`, `svgf`, `upscale`)."""
    w, h = config.width, config.height
    frame = rng.as_frame(frame, img.device)
    if config.accumulate:
        tracing.mark("accumulate")
        n = torch.clamp(frame, max=10000).to(torch.float32)
        accum = (accum * n + img) / (n + 1.0)
        img = accum

    if config.denoise:
        tracing.mark("svgf")
        img, dn_state = denoise.svgf(dn_state, img, gbuffer, prev_cams, w,
                                     h, plain=plain)

    if config.upscale == 2 and net is not None:
        tracing.mark("upscale")
        if _temporal_up(config, up_history):
            hist = upscaler.reproject_history(
                up_history, gbuffer["world_pos"], gbuffer["hit"], prev_cams,
                w, h, plain=plain)
            # Frame 0 (and right after reset_history): the history is all
            # zero and prev_cams == cams, so hit pixels would reproject
            # "valid" onto black.  Gate validity by frame > 0, as the JAX
            # package does.
            hist = torch.cat([hist[..., :3],
                              torch.where(frame > 0, hist[..., 3:4], 0.0)],
                             dim=-1)
            img = upscaler.upscale_temporal(net, img, hist)
            up_history = img
        else:
            img = upscaler.upscale(net, img)

    return img, dn_state, accum, up_history


def frame_program(scene: SceneData, accel, cams, prev_cams, dn_state, accum,
                  frame, config: RenderConfig, net=None,
                  up_history=None, plain: bool = False):
    """One frame: render_rows over the whole frame, then post_stages;
    `frame` an int or a 0-d integer tensor.  Returns (output image, new
    denoise state, new accumulation buffer, new upscaler history).
    FrameLoop.step runs it on the card as a captured CUDA graph."""
    want_gb = wants_gbuffer(config, up_history)
    out = render_rows(scene, accel, cams, 0, config.height, config,
                      plain=plain, want_gbuffer=want_gb, frame=frame)
    img, gbuffer = out if want_gb else (out, None)
    return post_stages(img, gbuffer, prev_cams, dn_state, accum, frame,
                       config, net, up_history, plain=plain)


@dataclasses.dataclass
class FrameLoop:
    """Host-side driver holding cross-frame state.

    Usage:
        loop = FrameLoop(scene, config)
        img = loop.step(camera)          # one frame, state advances

    `device` defaults to the first CUDA device and raises without one;
    pass `device="cpu"` for the plain versions.  On a CUDA device every
    trace, BRDF and warp call launches its kernel.

    `upscaler_params`: the upscaler's flax parameters as numpy, keyed
    `Conv_i/kernel` (HWIO) and `Conv_i/bias` (utils/interop.
    upscaler_from_numpy).  When None, an upscaling loop loads the trained
    weights of its mode committed with the package (models/upscaler.
    load_weights).  The JAX package's default is a PRNGKey(0) init,
    which torch cannot reproduce and which no one would serve.

    `mesh`: a parallel/tiles.make_mesh DeviceMesh; the loop then runs on
    this rank's device, and raises ValueError when the ranks do not
    divide the frame's height.

    `visible` holds the instances' culling state and `rebuilds` counts
    the LBVH rebuilds that culling made.  On the card the frame replays
    the loop's frame program (`program`, `captures`) and a refit or a
    culling rebuild its build program (`builds`), each captured once for
    as long as the shapes and the accel stay.  Both write `accel` in
    place: after `set_instance_transform`, and after every culling
    rebuild but the first, `accel` holds the same tensors with new
    contents, so a caller that needs the old tables copies them
    first."""

    scene_obj: Any
    config: RenderConfig
    upscaler_params: Optional[dict] = None
    cull_threshold_px: float = 1.0
    two_level: bool = False
    mesh: Optional[Any] = None
    device: Any = None

    def __post_init__(self):
        cfg = self.config
        require_slice(cfg)
        if self.mesh is None:
            self.device = resolve_device(self.device)
        else:
            tiles.band(0, self.mesh.size(), cfg)  # the ranks divide H
            self.device = tiles.mesh_device(self.mesh)
        self.scene: SceneData = (
            self.scene_obj.build(self.device)
            if isinstance(self.scene_obj, Scene) else self.scene_obj)
        # 32-triangle leaves, as the JAX package's frame loop.
        self.leaf_size = cfg.leaf_size or 32
        self.visible = torch.ones((self.scene.inst_bmin.shape[0],),
                                  dtype=torch.bool, device=self.device)
        self.rebuilds = 0
        if self.two_level:
            if not isinstance(self.scene_obj, Scene):
                raise ValueError("two_level needs the authoring Scene")
            self.accel = tlas.build_two_level_flat(
                self.scene_obj, self.leaf_size, device=self.device)
        elif cfg.traversal == "bruteforce":
            self.accel = None
        else:
            self.accel = lbvh.build_bvh_sah(self.scene, self.leaf_size,
                                            device=self.device)
        if self.mesh is not None:
            self.scene = tiles.replicate(self.scene, self.mesh)
            self.accel = tiles.replicate(self.accel, self.mesh)
        self.prev_cams = None
        self.net = None
        self.up_history = None
        if cfg.upscale == 2:
            temporal = cfg.upscale_mode == "temporal"
            self.net = (upscaler.load_weights(cfg.upscale_mode, self.device)
                        if self.upscaler_params is None else
                        upscaler_from_numpy(self.upscaler_params, temporal,
                                            self.device))
            if temporal:
                self.up_history = self._zeros(2 * cfg.height, 2 * cfg.width)
        # The loop's captured frame program: one graph at a time, keyed by
        # the config, the shapes, the scene, the accel and the net.  And
        # its build program: the TLAS refit of a two-level loop or the
        # culling rebuild, keyed by the scene and the accel.
        self.program = graphs.Programs(1)
        self.builds = graphs.Programs(1)
        # The stage clocks of the frame program's last run (tracing on).
        self._trace_frame = None
        self._culled = False
        self.reset_history()

    @property
    def captures(self) -> int:
        """Frame programs this loop has captured on the card."""
        return self.program.captures

    def _zeros(self, h: int, w: int, c: int = 3) -> torch.Tensor:
        return torch.zeros((h, w, c), dtype=torch.float32,
                           device=self.device)

    def reset_history(self):
        cfg = self.config
        self.dn_state = denoise.init_state(cfg.height, cfg.width,
                                           self.device)
        self.accum = self._zeros(cfg.height, cfg.width)
        self.frame = 0
        if self.up_history is not None:
            self.up_history = torch.zeros_like(self.up_history)

    def set_resolution(self, width: int, height: int) -> None:
        """Switch render resolution mid-session: scene and accel survive,
        the size-dependent state (denoise, accumulation and upscaler
        history) restarts."""
        if (width, height) == (self.config.width, self.config.height):
            return
        self.config = dataclasses.replace(self.config, width=width,
                                          height=height)
        self.program.clear()
        self.prev_cams = None
        if self.up_history is not None:
            self.up_history = self._zeros(2 * height, 2 * width)
        self.reset_history()

    def set_instance_transform(self, idx: int, position=None,
                               rotation=None, scale=None) -> None:
        """Animate one instance (two-level mode): update its TRS and
        refit the TLAS in place (tlas.set_instance: the instance's
        matrix rows go to the device, the loop's refit program writes
        the TLAS rows and their records into the accel's own tensors,
        so the captured frame program reads the refitted tables and is
        not captured again); no BLAS is rebuilt.  Raises ValueError,
        the instance left where it was, when K4 cannot walk the refitted
        table.  With tracing on (utils/tracing.py) the call is the host
        span `frameloop.move` over tlas.set_instance's spans."""
        if not self.two_level:
            raise ValueError("instance animation needs two_level=True")
        with tracing.span("frameloop.move"):
            cur = self.scene_obj.instances[idx]
            new = MeshInstance(
                cur.mesh_id, cur.material_id,
                tuple(position) if position is not None else cur.position,
                tuple(rotation) if rotation is not None else cur.rotation,
                tuple(scale) if scale is not None else cur.scale)
            self.accel = tlas.set_instance(
                self.accel, idx, new.transform, new.inverse_transform,
                new.normal_matrix, programs=self.builds)
            self.scene_obj.instances[idx] = new

    def _maybe_cull(self, cams, plain: bool) -> None:
        if (self.accel is None or self.cull_threshold_px <= 0
                or self.two_level):
            return
        new_vis = culling.cull_instances(
            self.visible, self.scene.inst_bmin, self.scene.inst_bmax, cams,
            self.config.width, self.config.height,
            threshold_px=self.cull_threshold_px)
        if bool((new_vis != self.visible).any()):
            self.visible = new_vis
            mask = culling.triangle_mask(new_vis, self.scene.tri_inst,
                                         self.scene.tri_valid)
            if self._culled:
                # In place, from the loop's build program: the frame
                # program reads the new tables and is not captured again.
                lbvh.rebuild_bvh(self.accel, self.scene, mask, self.builds,
                                 plain=plain)
            else:
                # The first rebuild replaces the SAH accel.
                self.accel = lbvh.build_bvh(self.scene, self.leaf_size,
                                            tri_mask=mask)
                self._culled = True
            self.rebuilds += 1

    def step(self, camera: Camera, plain: bool = False) -> torch.Tensor:
        """Render the next frame; returns the final (possibly upscaled)
        (H, W, 3) image on the loop's device, a tensor of its own.  On
        the card the frame is the loop's captured frame program
        (graphs.Programs): captured at the first step of a config, shape,
        scene, accel and net, replayed after, the camera arrays, the
        frame index and the cross-frame state copied in and out.  Culling
        runs before it; its rebuild writes the loop's LBVH accel in place
        from the loop's build program (the first one replaces the SAH
        accel, and the next step captures again).  `plain=True` renders
        and post-processes it op by op with the plain versions of the
        kernels, on the loop's device (a reference loop on the card).  A
        loop over a `mesh` replays frame_program_tiled the same way, its
        band's all-gathers inside the graph, over NCCL; over gloo it runs
        op by op (graphs.py).  With tracing on (utils/tracing.py) the
        step is the span `frameloop.step` over `frameloop.camera`,
        `frameloop.cull` and `frameloop.key` (the signatures and the
        key), the frame program's key says so (so switching tracing
        captures again once), and the frame's stage clocks go to the
        tracing ring after it."""
        with tracing.span("frameloop.step"):
            return self._step(camera, plain)

    def _step(self, camera: Camera, plain: bool) -> torch.Tensor:
        cfg = self.config
        with tracing.span("frameloop.camera"):
            cams = camera_arrays(camera, cfg, self.device)
        if self.prev_cams is None:
            self.prev_cams = cams
        with tracing.span("frameloop.cull"):
            self._maybe_cull(cams, plain)
        scene, accel, net, mesh = self.scene, self.accel, self.net, self.mesh

        def body(cams, prev_cams, dn_state, accum, up_history, frame):
            with tracing.frame(self.device) as rec:
                if mesh is None:
                    out = frame_program(scene, accel, cams, prev_cams,
                                        dn_state, accum, frame, cfg,
                                        net=net, up_history=up_history,
                                        plain=plain)
                else:
                    out = tiles.frame_program_tiled(
                        scene, accel, cams, prev_cams, dn_state, accum,
                        frame, cfg, mesh, net=net, up_history=up_history,
                        plain=plain)
            self._trace_frame = rec
            return out

        with tracing.span("frameloop.key"):
            key = ("frame_program", cfg, graphs.signature(scene),
                   graphs.signature(accel), graphs.signature(net),
                   graphs.signature(mesh), tracing.enabled())
        out = self.program(
            key, body, (cams, self.prev_cams, self.dn_state, self.accum,
                        self.up_history, self.frame),
            self.device, group=None if mesh is None else mesh.get_group(),
            eager=plain)
        tracing.collect(self._trace_frame)
        img, self.dn_state, self.accum, self.up_history = out
        self.prev_cams = cams
        self.frame += 1
        return img

    # ---- checkpoint / resume: the JAX package's npz keys --------------
    def save_state(self, path: str) -> None:
        extra = ({"up_history": self.up_history.cpu().numpy()}
                 if self.up_history is not None else {})
        np.savez_compressed(
            path, frame=self.frame, accum=self.accum.cpu().numpy(),
            visible=self.visible.cpu().numpy(),
            **{f"dn_{k}": v.cpu().numpy()
               for k, v in self.dn_state._asdict().items()},
            **extra)

    def load_state(self, path: str) -> None:
        dev = lambda a: torch.as_tensor(np.asarray(a), device=self.device)
        with np.load(path) as data:
            self.frame = int(data["frame"])
            self.accum = dev(data["accum"])
            self.visible = dev(data["visible"])
            self.dn_state = denoise.DenoiseState(
                **{k: dev(data[f"dn_{k}"])
                   for k in denoise.DenoiseState._fields})
            if "up_history" in data:
                self.up_history = dev(data["up_history"])
