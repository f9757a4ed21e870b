"""Camera: perspective projection + Euler-YXZ view, reference conventions
(y-down world), as hrt_tpu/models/camera.py."""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..ops.v3 import V3


class CameraArrays(NamedTuple):
    """Camera state on the device: origin (3,), basis (3, 3) with rows
    u, v, w, and the 0-d tan_half_fovy and aspect."""

    origin: torch.Tensor
    basis: torch.Tensor
    tan_half_fovy: torch.Tensor
    aspect: torch.Tensor


@dataclasses.dataclass(frozen=True)
class Camera:
    position: Tuple[float, float, float] = (0.0, 0.0, -2.0)
    rotation: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    fov_y: float = 1.0471975512
    z_near: float = 0.1
    z_far: float = 100.0

    def basis(self) -> np.ndarray:
        """Rows (u, v, w) of the view rotation, in float32."""
        rx, ry, rz = (np.float32(a) for a in self.rotation)
        c3, s3 = np.cos(rz), np.sin(rz)
        c2, s2 = np.cos(rx), np.sin(rx)
        c1, s1 = np.cos(ry), np.sin(ry)
        u = [c1 * c3 + s1 * s2 * s3, c2 * s3, c1 * s2 * s3 - c3 * s1]
        v = [c3 * s1 * s2 - c1 * s3, c2 * c3, c1 * c3 * s2 + s1 * s3]
        w = [c2 * s1, -s2, c1 * c2]
        return np.array([u, v, w], np.float32)

    def ray_params(self, width: int, height: int,
                   device) -> CameraArrays:
        """Camera arrays for ray generation on `device`."""
        tan_half = np.float32(math.tan(self.fov_y / 2.0))
        as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                         device=device)
        return CameraArrays(as_t(self.position), as_t(self.basis()),
                            as_t(tan_half), as_t(width / height))


def orbit_camera(t: float, radius: float = 3.0, height: float = -1.0,
                 target=(0.0, 0.0, 0.0),
                 fov_y: float = 1.0471975512) -> Camera:
    """The scripted orbit path of the JAX package's CLI `--orbit`: at
    parameter t the camera circles `target` at `radius`, `height` above
    it (y-down world), looking at it."""
    px = target[0] + radius * math.sin(t)
    pz = target[2] - radius * math.cos(t)
    py = height
    # Yaw so the camera looks at the target: forward w = (sin yaw, 0, cos yaw).
    yaw = math.atan2(target[0] - px, target[2] - pz)
    dy = target[1] - py
    d = math.sqrt((target[0] - px) ** 2 + (target[2] - pz) ** 2)
    # forward.y = -sin(pitch) must equal dy/dist (world is y-down).
    pitch = -math.atan2(dy, d)
    return Camera(position=(px, py, pz), rotation=(pitch, yaw, 0.0),
                  fov_y=fov_y)


def primary_rays_from_px_p(origin, basis, tan_half_fovy, aspect,
                           width: int, height: int,
                           px: torch.Tensor, py: torch.Tensor):
    """Primary rays through pixel-coordinate planes px/py of any shape
    (the raw launch id, as the reference's rgenMain).  Returns
    (origins V3, directions V3)."""
    cx = px / np.float32(width) * 2.0 - 1.0
    cy = py / np.float32(height) * 2.0 - 1.0
    dcx = aspect * tan_half_fovy * cx
    dcy = tan_half_fovy * cy
    inv_len = 1.0 / torch.sqrt(torch.clamp(dcx * dcx + dcy * dcy + 1.0,
                                           min=1e-16))
    dcx, dcy, dcz = dcx * inv_len, dcy * inv_len, inv_len
    dirs = V3(
        dcx * basis[0, 0] + dcy * basis[1, 0] + dcz * basis[2, 0],
        dcx * basis[0, 1] + dcy * basis[1, 1] + dcz * basis[2, 1],
        dcx * basis[0, 2] + dcy * basis[1, 2] + dcz * basis[2, 2],
    )
    ones = torch.ones_like(px)
    origins = V3(origin[0] * ones, origin[1] * ones, origin[2] * ones)
    return origins, dirs
