"""Host-side triangle meshes and the procedural meshes of the bench,
demo and Cornell box scenes (numpy, carried over from
hrt_tpu/models/mesh.py).

Vertex layout: pos[3] + normal[3] + uv[2] = 8 float32.  OBJ files load
through the native library (`load_obj`).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Mesh:
    """vertices (V, 8) float32, indices (T, 3) int32."""

    vertices: np.ndarray
    indices: np.ndarray

    @property
    def num_triangles(self) -> int:
        return int(self.indices.shape[0])


def load_obj(path: str) -> Mesh:
    """An OBJ file as a Mesh (native/objloader.cpp: the JAX package's
    load_obj semantics, Y negated as in the reference)."""
    from .. import native

    verts, idx = native.load_obj(path)
    return Mesh(vertices=verts, indices=idx)


def make_mesh(positions: np.ndarray, indices: np.ndarray,
              normals: np.ndarray | None = None,
              uvs: np.ndarray | None = None) -> Mesh:
    """Build a Mesh from raw arrays (no Y-flip: caller's coordinates)."""
    positions = np.asarray(positions, np.float32).reshape(-1, 3)
    indices = np.asarray(indices, np.int32).reshape(-1, 3)
    verts = np.zeros((positions.shape[0], 8), np.float32)
    verts[:, 0:3] = positions
    if normals is None:
        normals = compute_vertex_normals(positions, indices)
    verts[:, 3:6] = np.asarray(normals, np.float32).reshape(-1, 3)
    if uvs is not None:
        verts[:, 6:8] = np.asarray(uvs, np.float32).reshape(-1, 2)
    return Mesh(vertices=verts, indices=indices)


def compute_vertex_normals(positions: np.ndarray,
                           indices: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals."""
    v0 = positions[indices[:, 0]]
    v1 = positions[indices[:, 1]]
    v2 = positions[indices[:, 2]]
    face_n = np.cross(v1 - v0, v2 - v0)
    normals = np.zeros_like(positions)
    for k in range(3):
        np.add.at(normals, indices[:, k], face_n)
    lens = np.linalg.norm(normals, axis=-1, keepdims=True)
    return normals / np.maximum(lens, 1e-12)


def plane(size: float = 1.0) -> Mesh:
    """XZ plane centered at the origin, normal -Y (up in a y-down world)."""
    s = size
    pos = np.array(
        [[-s, 0, -s], [s, 0, -s], [s, 0, s], [-s, 0, s]], np.float32)
    nrm = np.tile(np.array([[0, -1, 0]], np.float32), (4, 1))
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    idx = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    verts = np.concatenate([pos, nrm, uv], axis=1)
    return Mesh(vertices=verts, indices=idx)


def cube(size: float = 1.0) -> Mesh:
    """Axis-aligned cube with per-face normals, edge length 2 * size."""
    s = size
    faces = []
    for axis in range(3):
        for sign in (-1.0, 1.0):
            n = np.zeros(3, np.float32)
            n[axis] = sign
            a = (axis + 1) % 3
            b = (axis + 2) % 3
            corners = []
            for da, db in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
                p = np.zeros(3, np.float32)
                p[axis] = sign * s
                p[a] = da * s
                p[b] = db * s
                corners.append(p)
            faces.append((np.stack(corners), n))
    pos_list, nrm_list, idx_list = [], [], []
    base = 0
    for c, n in faces:
        pos_list.append(c)
        nrm_list.append(np.tile(n[None], (4, 1)))
        # Wind so that cross(e1, e2) points along n.
        if np.dot(np.cross(c[1] - c[0], c[2] - c[0]), n) > 0:
            tris = [[0, 1, 2], [0, 2, 3]]
        else:
            tris = [[0, 2, 1], [0, 3, 2]]
        idx_list.append(np.array(tris, np.int32) + base)
        base += 4
    pos = np.concatenate(pos_list)
    nrm = np.concatenate(nrm_list)
    uv = np.zeros((pos.shape[0], 2), np.float32)
    verts = np.concatenate([pos, nrm, uv], axis=1).astype(np.float32)
    return Mesh(vertices=verts, indices=np.concatenate(idx_list))


def icosphere(subdivisions: int = 2, radius: float = 1.0) -> Mesh:
    """Icosphere with smooth normals (20 * 4**subdivisions triangles)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    pos = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float64,
    )
    pos /= np.linalg.norm(pos, axis=1, keepdims=True)
    idx = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int64,
    )
    for _ in range(subdivisions):
        edge_mid: dict[tuple[int, int], int] = {}
        pos_list = list(pos)

        def midpoint(a: int, b: int) -> int:
            key = (min(a, b), max(a, b))
            m = edge_mid.get(key)
            if m is None:
                p = pos_list[a] + pos_list[b]
                p = p / np.linalg.norm(p)
                m = len(pos_list)
                pos_list.append(p)
                edge_mid[key] = m
            return m

        new_idx = []
        for a, b, c in idx:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_idx += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        pos = np.stack(pos_list)
        idx = np.asarray(new_idx, np.int64)
    normals = pos.copy()
    return make_mesh(pos * radius, idx.astype(np.int32),
                     normals=normals.astype(np.float32))
