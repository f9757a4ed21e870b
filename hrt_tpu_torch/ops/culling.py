"""Screen-footprint instance culling (hrt_tpu/ops/culling.py), in torch on
the frame loop's device.

Instances whose projected screen footprint falls below a pixel threshold
are dropped from the frame, with enter/exit hysteresis so they do not
pop at the boundary; the per-triangle mask feeds the LBVH rebuild
(ops/lbvh.build_bvh(tri_mask=...)).  The arithmetic is the JAX
package's, operation for operation (the camera-space dot products are
written out left to right, as its three-term reductions sum them).
"""
from __future__ import annotations

import torch


def _corners(bmin: torch.Tensor, bmax: torch.Tensor) -> torch.Tensor:
    """(I, 8, 3) corner positions of instance AABBs."""
    picks = torch.tensor(
        [[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)],
        dtype=torch.float32, device=bmin.device)
    return (bmin[:, None, :] * (1.0 - picks[None])
            + bmax[:, None, :] * picks[None])


def footprint_px(inst_bmin, inst_bmax, cam, width: int, height: int):
    """Conservative projected footprint area (pixels^2) per instance.

    cam: models.camera.CameraArrays.  Instances straddling or behind the
    near plane get +inf footprint (never culled)."""
    rel = _corners(inst_bmin, inst_bmax) - cam.origin       # (I, 8, 3)

    def dot(b):
        return rel[..., 0] * b[0] + rel[..., 1] * b[1] + rel[..., 2] * b[2]

    x, y, z = dot(cam.basis[0]), dot(cam.basis[1]), dot(cam.basis[2])
    near = 1e-3
    any_near = (z <= near).any(dim=1)
    zs = torch.clamp(z, min=near)
    px = (x / (zs * cam.aspect * cam.tan_half_fovy) + 1.0) * 0.5 * width
    py = (y / (zs * cam.tan_half_fovy) + 1.0) * 0.5 * height
    w = torch.clamp(px.max(dim=1).values, 0, width) \
        - torch.clamp(px.min(dim=1).values, 0, width)
    h = torch.clamp(py.max(dim=1).values, 0, height) \
        - torch.clamp(py.min(dim=1).values, 0, height)
    return torch.where(any_near, float("inf"), w * h)


def cull_instances(visible_prev: torch.Tensor, inst_bmin, inst_bmax, cam,
                   width: int, height: int, threshold_px: float = 1.0,
                   hysteresis: float = 2.0) -> torch.Tensor:
    """Hysteresis update of per-instance visibility: show when the
    footprint exceeds threshold * hysteresis, hide when it is below the
    threshold, keep the previous state in between."""
    area = footprint_px(inst_bmin, inst_bmax, cam, width, height)
    show = area > threshold_px * hysteresis
    hide = area < threshold_px
    return torch.where(show, True, torch.where(hide, False, visible_prev))


def triangle_mask(visible: torch.Tensor, tri_inst: torch.Tensor,
                  tri_valid: torch.Tensor) -> torch.Tensor:
    """Per-triangle keep mask from instance visibility (padding rows have
    tri_inst == -1 and stay masked out)."""
    vis = visible[tri_inst.clamp(min=0).long()] & (tri_inst >= 0)
    return vis & (tri_valid > 0.5)
