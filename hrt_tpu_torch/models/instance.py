"""Mesh instances: mesh id + material id + TRS transform (numpy,
carried over from hrt_tpu/models/instance.py)."""
from __future__ import annotations

import dataclasses

import numpy as np


def rotation_yxz(rotation) -> np.ndarray:
    """3x3 Euler-YXZ rotation with columns (u, v, w)."""
    rx, ry, rz = rotation
    c3, s3 = np.cos(rz), np.sin(rz)
    c2, s2 = np.cos(rx), np.sin(rx)
    c1, s1 = np.cos(ry), np.sin(ry)
    u = np.array([c1 * c3 + s1 * s2 * s3, c2 * s3, c1 * s2 * s3 - c3 * s1])
    v = np.array([c3 * s1 * s2 - c1 * s3, c2 * c3, c1 * c3 * s2 + s1 * s3])
    w = np.array([c2 * s1, -s2, c1 * c2])
    return np.stack([u, v, w], axis=1).astype(np.float32)


def trs_matrix(position, rotation, scale) -> np.ndarray:
    """Row-major 3x4 object->world transform M = T @ R @ S."""
    a = rotation_yxz(rotation) * np.asarray(scale, np.float32)[None, :]
    m = np.zeros((3, 4), np.float32)
    m[:, :3] = a
    m[:, 3] = position
    return m


@dataclasses.dataclass
class MeshInstance:
    mesh_id: int
    material_id: int
    position: tuple = (0.0, 0.0, 0.0)
    rotation: tuple = (0.0, 0.0, 0.0)
    scale: tuple = (1.0, 1.0, 1.0)

    @property
    def transform(self) -> np.ndarray:
        return trs_matrix(self.position, self.rotation, self.scale)

    @property
    def inverse_transform(self) -> np.ndarray:
        """Row-major 3x4 world->object transform."""
        m = self.transform
        inv = np.zeros((3, 4), np.float32)
        inv_a = np.linalg.inv(m[:, :3])
        inv[:, :3] = inv_a
        inv[:, 3] = -inv_a @ m[:, 3]
        return inv

    @property
    def normal_matrix(self) -> np.ndarray:
        """Inverse-transpose of the linear part, for normals."""
        return np.linalg.inv(self.transform[:, :3]).T.astype(np.float32)
