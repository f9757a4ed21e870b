"""Frame loop: the host-side driver that holds cross-frame state
(hrt_tpu/frameloop.py `FrameLoop`, the subset the ported frames use).

One `step` renders a frame through renderer.render_rows and, with
`config.accumulate`, folds it into the running mean, as the JAX
package's `_post_stages` does.  With `two_level=True` the accel is the
instanced TwoLevelFlat (ops/tlas.py) and `set_instance_transform`
animates an instance by refitting the TLAS; otherwise it starts as the
single-level SAH Accel, and with `cull_threshold_px > 0` (the default,
as in the JAX package) each step first updates the instances'
visibility (ops/culling.py) and, when it changed, rebuilds the accel
with the LBVH over the visible triangles (its walks take K3).
Two-level loops skip culling, as in the JAX package.

Not ported yet, and refused with NotImplementedError: denoise and
upscale (through config.require_slice) and a multi-device `mesh`.
`save_state` / `load_state` carry the denoiser's state and come with it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from .config import RenderConfig, require_slice
from .models.camera import Camera
from .models.instance import MeshInstance
from .models.scene import Scene, SceneData
from .ops import culling, lbvh, tlas
from .renderer import camera_arrays, render_rows


@dataclasses.dataclass
class FrameLoop:
    """Host-side driver holding cross-frame state.

    Usage:
        loop = FrameLoop(scene, config, two_level=True, device="cuda")
        img = loop.step(camera)          # one frame, state advances

    `device` defaults to the first CUDA device when there is one and to
    the CPU otherwise; on a CUDA device every trace and BRDF call
    launches its kernel, on the CPU it runs the plain versions.
    `visible` holds the instances' culling state and `rebuilds` counts
    the LBVH rebuilds that culling made."""

    scene_obj: Any
    config: RenderConfig
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
        if self.device is None:
            self.device = (torch.device("cuda") if torch.cuda.is_available()
                           else torch.device("cpu"))
        self.device = torch.device(self.device)
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
        else:
            self.accel = lbvh.build_bvh_sah(self.scene, self.leaf_size,
                                            device=self.device)
        self.reset_history()

    def reset_history(self):
        cfg = self.config
        self.accum = torch.zeros((cfg.height, cfg.width, 3),
                                 dtype=torch.float32, device=self.device)
        self.frame = 0

    def set_resolution(self, width: int, height: int) -> None:
        """Switch render resolution mid-session: scene and accel survive,
        the size-dependent state restarts."""
        if (width, height) == (self.config.width, self.config.height):
            return
        self.config = dataclasses.replace(self.config, width=width,
                                          height=height)
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
        if self.cull_threshold_px <= 0 or self.two_level:
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

    def step(self, camera: Camera) -> torch.Tensor:
        """Render the next frame; returns the (H, W, 3) image on the
        loop's device."""
        cfg = self.config
        cams = camera_arrays(camera, cfg, self.device)
        self._maybe_cull(cams)
        img = render_rows(self.scene, self.accel, cams, 0, cfg.height, cfg)
        if cfg.accumulate:
            n = float(min(self.frame, 10000))
            self.accum = (self.accum * n + img) / (n + 1.0)
            img = self.accum
        self.frame += 1
        return img
