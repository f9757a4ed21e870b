"""Per-mesh object-space arrays for the two-level build
(hrt_tpu/ops/twolevel.py `_mesh_scene_arrays`)."""
from __future__ import annotations

import numpy as np

from ..models.mesh import Mesh


def mesh_scene_arrays(mesh: Mesh, t_pad: int) -> dict:
    """Object-space SoA arrays (float32) for one mesh, padded to t_pad
    triangles with zeros (degenerate, never hit)."""
    v = mesh.vertices
    i0, i1, i2 = mesh.indices[:, 0], mesh.indices[:, 1], mesh.indices[:, 2]
    pos = v[:, 0:3]
    nrm = v[:, 3:6]
    uv = v[:, 6:8]
    t = mesh.num_triangles

    def padded(x):
        out = np.zeros((t_pad,) + x.shape[1:], np.float32)
        out[:t] = x
        return out

    return {
        "tri_v0": padded(pos[i0]),
        "tri_e1": padded(pos[i1] - pos[i0]),
        "tri_e2": padded(pos[i2] - pos[i0]),
        "nrm0": padded(nrm[i0]), "nrm1": padded(nrm[i1]),
        "nrm2": padded(nrm[i2]),
        "uv0": padded(uv[i0]), "uv1": padded(uv[i1]), "uv2": padded(uv[i2]),
        "tri_valid": padded(np.ones((t,), np.float32)),
    }
