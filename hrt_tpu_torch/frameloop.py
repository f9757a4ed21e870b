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
package.  A multi-device `mesh` is not ported yet and raises
NotImplementedError.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from .config import RenderConfig, require_slice, resolve_device
from .models import upscaler
from .models.camera import Camera
from .models.instance import MeshInstance
from .models.scene import Scene, SceneData
from .ops import culling, denoise, lbvh, tlas
from .renderer import camera_arrays, render_rows
from .utils.interop import upscaler_from_numpy


def _temporal_up(config: RenderConfig, up_history) -> bool:
    return (config.upscale == 2 and config.upscale_mode == "temporal"
            and up_history is not None)


def post_stages(img, gbuffer, prev_cams, dn_state, accum, frame: int,
                config: RenderConfig, net, up_history, plain: bool = False):
    """accumulate -> denoise -> upscale on one (H, W, 3) frame.  Returns
    (output image, new denoise state, new accumulation buffer, new
    upscaler history).  `plain=True` routes the K6 warps to their plain
    version on whatever device the tensors are on."""
    w, h = config.width, config.height
    if config.accumulate:
        n = float(min(frame, 10000))
        accum = (accum * n + img) / (n + 1.0)
        img = accum

    if config.denoise:
        img, dn_state = denoise.svgf(dn_state, img, gbuffer, prev_cams, w,
                                     h, plain=plain)

    if config.upscale == 2 and net is not None:
        if _temporal_up(config, up_history):
            hist = upscaler.reproject_history(
                up_history, gbuffer["world_pos"], gbuffer["hit"], prev_cams,
                w, h, plain=plain)
            # Frame 0 (and right after reset_history): the history is all
            # zero and prev_cams == cams, so hit pixels would reproject
            # "valid" onto black.  Gate validity by frame > 0, as the JAX
            # package does.
            if frame == 0:
                hist[..., 3] = 0.0
            img = upscaler.upscale_temporal(net, img, hist)
            up_history = img
        else:
            img = upscaler.upscale(net, img)

    return img, dn_state, accum, up_history


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

    `visible` holds the instances' culling state and `rebuilds` counts
    the LBVH rebuilds that culling made."""

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
        if self.mesh is not None:
            raise NotImplementedError(
                "multi-device rendering (mesh) is not ported yet")
        self.device = resolve_device(self.device)
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
            # Per-instance matrices, kept so that moving one instance
            # recomputes one row.
            self._mats = [np.stack([getattr(i, k)
                                    for i in self.scene_obj.instances])
                          for k in ("transform", "inverse_transform",
                                    "normal_matrix")]
        elif cfg.traversal == "bruteforce":
            self.accel = None
        else:
            self.accel = lbvh.build_bvh_sah(self.scene, self.leaf_size,
                                            device=self.device)
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
        self.reset_history()

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
        self.prev_cams = None
        if self.up_history is not None:
            self.up_history = self._zeros(2 * height, 2 * width)
        self.reset_history()

    def set_instance_transform(self, idx: int, position=None,
                               rotation=None, scale=None) -> None:
        """Animate one instance (two-level mode): update its TRS and
        refit the TLAS; no BLAS is rebuilt."""
        if not self.two_level:
            raise ValueError("instance animation needs two_level=True")
        cur = self.scene_obj.instances[idx]
        new = MeshInstance(
            cur.mesh_id, cur.material_id,
            tuple(position) if position is not None else cur.position,
            tuple(rotation) if rotation is not None else cur.rotation,
            tuple(scale) if scale is not None else cur.scale)
        self.scene_obj.instances[idx] = new
        for mats, m in zip(self._mats, (new.transform, new.inverse_transform,
                                        new.normal_matrix)):
            mats[idx] = m
        self.accel = tlas.refit_two_level(self.accel, *self._mats)

    def _maybe_cull(self, cams) -> None:
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
            self.accel = lbvh.build_bvh(self.scene, self.leaf_size,
                                        tri_mask=mask)
            self.rebuilds += 1

    def step(self, camera: Camera, plain: bool = False) -> torch.Tensor:
        """Render the next frame; returns the final (possibly upscaled)
        (H, W, 3) image on the loop's device.  `plain=True` renders and
        post-processes it with the plain versions of the kernels, on the
        loop's device (a reference loop on the card)."""
        cfg = self.config
        cams = camera_arrays(camera, cfg, self.device)
        if self.prev_cams is None:
            self.prev_cams = cams
        self._maybe_cull(cams)
        want_gb = cfg.denoise or _temporal_up(cfg, self.up_history)
        out = render_rows(self.scene, self.accel, cams, 0, cfg.height, cfg,
                          plain=plain, want_gbuffer=want_gb,
                          frame=self.frame)
        img, gbuffer = out if want_gb else (out, None)
        img, self.dn_state, self.accum, self.up_history = post_stages(
            img, gbuffer, self.prev_cams, self.dn_state, self.accum,
            self.frame, cfg, self.net, self.up_history, plain=plain)
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
