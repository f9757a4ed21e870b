"""The benchmark's scenes as plain arrays, made once and handed to both
sides: the program gets them through its public authoring calls
(`Scene.add_mesh`, `create_material`, `create_light`,
`create_instance`), the reference flattens them itself.

A configuration places instances one by one (`instances`: mesh,
material, position, Euler-YXZ `rotation` in radians, scale) and in
grids (`instance_grids`), which expand after them, in order.  A grid
holds `mesh`, `materials` ([even, odd], chosen by (i + j) % 2), `n` (n
x n instances), `spacing`, `height`, `scale` ([lo, span]: a uniform
scale lo + span * u), `rotation_max` (each Euler angle uniform in [0,
rotation_max)) and `seed`: instance by instance, row i then column j,
`numpy.random.RandomState(seed)` draws u for the scale, then the three
angles, as `hrt_tpu_torch.models.scene.instance_grid_scene` draws them.

`icosphere` is vectorised: each subdivision finds the unique edges
with numpy and numbers their midpoints in order of first appearance,
which gives the topology, the vertex order and the float64 arithmetic
of the dict loop it replaces, in a fraction of its time (2.6M
triangles in about a second instead of 11-15 s).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

_ICO_TRIS = np.array(
    [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
     [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
     [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
     [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int64)


class MeshArrays(NamedTuple):
    """positions (V, 3), normals (V, 3), uvs (V, 2) float32; indices
    (T, 3) int32."""

    positions: np.ndarray
    normals: np.ndarray
    uvs: np.ndarray
    indices: np.ndarray


def icosphere_arrays(subdivisions: int) -> tuple[np.ndarray, np.ndarray]:
    """Unit icosphere as float64 positions (V, 3) and int64 indices
    (T, 3): 20 * 4**subdivisions triangles, each split into
    [a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    pos = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
                    [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
                    [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]],
                   np.float64)
    pos /= np.linalg.norm(pos, axis=1, keepdims=True)
    idx = _ICO_TRIS
    for _ in range(subdivisions):
        a, b, c = idx[:, 0], idx[:, 1], idx[:, 2]
        # Edges in the order the loop meets them: (a,b), (b,c), (c,a)
        # of each triangle in turn.
        ea = np.stack([a, b, c], axis=1).reshape(-1)
        eb = np.stack([b, c, a], axis=1).reshape(-1)
        lo, hi = np.minimum(ea, eb), np.maximum(ea, eb)
        key = lo * pos.shape[0] + hi
        uniq, first, inv = np.unique(key, return_index=True,
                                     return_inverse=True)
        order = np.argsort(first, kind="stable")
        rank = np.empty(uniq.shape[0], np.int64)
        rank[order] = np.arange(uniq.shape[0])
        mid = pos.shape[0] + rank[inv].reshape(-1, 3)
        ulo, uhi = uniq // pos.shape[0], uniq % pos.shape[0]
        p = pos[ulo[order]] + pos[uhi[order]]
        p = p / np.linalg.norm(p, axis=1, keepdims=True)
        pos = np.concatenate([pos, p])
        ab, bc, ca = mid[:, 0], mid[:, 1], mid[:, 2]
        idx = np.stack([np.stack([a, ab, ca], 1), np.stack([b, bc, ab], 1),
                        np.stack([c, ca, bc], 1), np.stack([ab, bc, ca], 1)],
                       axis=1).reshape(-1, 3)
    return pos, idx


def icosphere(subdivisions: int, radius: float = 1.0) -> MeshArrays:
    """The smooth-normal icosphere (normals are the unit positions)."""
    pos, idx = icosphere_arrays(subdivisions)
    return MeshArrays((pos * radius).astype(np.float32),
                      pos.astype(np.float32),
                      np.zeros((pos.shape[0], 2), np.float32),
                      idx.astype(np.int32))


def plane(size: float) -> MeshArrays:
    """XZ square of half-side `size` at the origin, normal -Y (up in
    the y-down world)."""
    s = size
    pos = np.array([[-s, 0, -s], [s, 0, -s], [s, 0, s], [-s, 0, s]],
                   np.float32)
    nrm = np.tile(np.array([[0, -1, 0]], np.float32), (4, 1))
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    return MeshArrays(pos, nrm, uv, np.array([[0, 1, 2], [0, 2, 3]],
                                             np.int32))


def make_mesh(spec: dict) -> MeshArrays:
    """A mesh of a configuration's `meshes` table."""
    if spec["kind"] == "icosphere":
        return icosphere(int(spec["subdivisions"]),
                         float(spec.get("radius", 1.0)))
    if spec["kind"] == "plane":
        return plane(float(spec["size"]))
    raise ValueError(f"unknown mesh kind {spec['kind']!r}")


def grid_instances(grid: dict) -> list:
    """The instances of one of a configuration's `instance_grids`, drawn
    in one call: RandomState.rand() and .uniform(0, hi, 3) both take the
    next doubles of the stream, so four doubles an instance, reshaped,
    are the per-instance draws."""
    n = int(grid["n"])
    u = np.random.RandomState(int(grid["seed"])).random_sample(
        4 * n * n).reshape(n * n, 4)
    lo, span = grid["scale"]
    scale = lo + span * u[:, 0]
    rotation = 0.0 + (grid["rotation_max"] - 0.0) * u[:, 1:4]
    i, j = np.divmod(np.arange(n * n), n)
    x = grid["spacing"] * (i - n / 2)
    z = grid["spacing"] * (j - n / 2)
    even, odd = grid["materials"]
    y = float(grid["height"])
    return [{"mesh": grid["mesh"], "material": odd if (a + b) % 2 else even,
             "position": (px, y, pz), "rotation": tuple(r),
             "scale": (s, s, s)}
            for a, b, px, pz, r, s in zip(i.tolist(), j.tolist(),
                                          x.tolist(), z.tolist(),
                                          rotation.tolist(), scale.tolist())]


def instance_list(config: dict) -> list:
    """Every instance of a configuration: `instances`, then each of
    `instance_grids` expanded."""
    out = list(config["instances"])
    for grid in config.get("instance_grids", []):
        out += grid_instances(grid)
    return out


class SceneArrays(NamedTuple):
    """A configuration's scene: meshes by name, materials (name ->
    dict), lights (list of dicts) and instances (list of dicts naming a
    mesh and a material, with a position, a rotation and a scale)."""

    meshes: dict
    materials: dict
    lights: list
    instances: list


def scene_arrays(config: dict) -> SceneArrays:
    meshes = {name: make_mesh(spec) for name, spec in config["meshes"].items()}
    return SceneArrays(meshes, dict(config["materials"]),
                       list(config["lights"]), instance_list(config))


def num_triangles(scene: SceneArrays) -> int:
    return sum(scene.meshes[i["mesh"]].indices.shape[0]
               for i in scene.instances)
