"""Scene authoring API + build(device) -> flat SoA tensors.

Same authoring surface and the same flattened world-space triangle pool
as hrt_tpu/models/scene.py: every instance's triangles pre-transformed
into one pool, padded to a multiple of PAD with degenerate (e1 = e2 = 0)
triangles that never hit.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import lights as lights_mod
from . import materials as mat_mod
from . import sky as sky_mod
from . import textures as tex_mod
from .instance import MeshInstance
from .mesh import Mesh, load_obj
from ..ops import lightbvh

PAD = 128


class SceneData(NamedTuple):
    """Flat scene tensors; field names and layouts as the JAX package's
    SceneData.  `textures` is the packed (K, R, R, 3) base-color table
    (models/textures.py; K = 0 without textures), `light_tree` the
    light BVH (ops/lightbvh.py; None without lights).  A SceneData made
    by hand may leave both None."""

    tri_v0: torch.Tensor   # (T, 3) f32
    tri_e1: torch.Tensor   # (T, 3) f32   v1 - v0
    tri_e2: torch.Tensor   # (T, 3) f32   v2 - v0
    nrm0: torch.Tensor     # (T, 3) f32   world-space vertex normals
    nrm1: torch.Tensor
    nrm2: torch.Tensor
    uv0: torch.Tensor      # (T, 2)
    uv1: torch.Tensor
    uv2: torch.Tensor
    tri_mat: torch.Tensor  # (T,) i32 material id (padding: 0)
    tri_inst: torch.Tensor  # (T,) i32 instance id (padding: -1)
    tri_valid: torch.Tensor  # (T,) f32 1.0 real, 0.0 padding
    materials: torch.Tensor  # (M, MAT_W) f32
    lights: torch.Tensor     # (L, LIGHT_W) f32
    sky: torch.Tensor        # (SKY_W_FULL,) f32
    inst_bmin: torch.Tensor  # (I, 3) f32
    inst_bmax: torch.Tensor  # (I, 3) f32
    textures: torch.Tensor | None = None
    light_tree: object = None

    @property
    def num_triangles(self) -> int:
        return self.tri_v0.shape[0]


class Scene:
    """Host-side scene builder."""

    def __init__(self):
        self.meshes: list[Mesh] = []
        self.materials: list[np.ndarray] = []
        self.textures: list[np.ndarray] = []
        self.lights: list[np.ndarray] = []
        self.instances: list[MeshInstance] = []
        self.sky: np.ndarray = sky_mod.default_sky()

    def load_model(self, path: str) -> int:
        """Add the mesh of an OBJ file (models/mesh.load_obj)."""
        self.meshes.append(load_obj(path))
        return len(self.meshes) - 1

    def add_mesh(self, mesh: Mesh) -> int:
        self.meshes.append(mesh)
        return len(self.meshes) - 1

    def create_material(self, color=(1.0, 1.0, 1.0), metallic: float = 0.0,
                        roughness: float = 1.0,
                        emissive_color=(0.0, 0.0, 0.0),
                        emission_strength: float = 0.0, **extras) -> int:
        self.materials.append(
            mat_mod.make_material(color, metallic, roughness,
                                  emissive_color, emission_strength,
                                  **extras))
        return len(self.materials) - 1

    def create_texture(self, image) -> int:
        """Register a base-color texture (an H x W x 3 array, 8-bit or
        float); returns its id for create_material(texture=...)."""
        self.textures.append(np.asarray(image))
        return len(self.textures) - 1

    def create_light(self, position, color, intensity: float,
                     light_type: int = lights_mod.POINT,
                     direction=(0.0, 0.0, 0.0),
                     cone_angle: float = 0.0) -> int:
        self.lights.append(
            lights_mod.make_light(position, color, intensity, light_type,
                                  direction, cone_angle))
        return len(self.lights) - 1

    def create_instance(self, mesh_id: int, material_id: int,
                        position=(0.0, 0.0, 0.0), rotation=(0.0, 0.0, 0.0),
                        scale=(1.0, 1.0, 1.0)) -> int:
        self.instances.append(
            MeshInstance(mesh_id, material_id, tuple(position),
                         tuple(rotation), tuple(scale)))
        return len(self.instances) - 1

    def set_sky(self, **kwargs) -> None:
        """Set sky parameters by name (sky_color, horizon_color,
        ground_color, sun_direction, up_direction, brightness,
        horizon_size, angular_size, glow_intensity, glow_sharpness,
        glow_size, light_radiance)."""
        name_to_idx = {
            "sky_color": sky_mod.SKY_COLOR,
            "horizon_color": sky_mod.HORIZON_COLOR,
            "ground_color": sky_mod.GROUND_COLOR,
            "sun_direction": sky_mod.SUN_DIRECTION,
            "up_direction": sky_mod.UP_DIRECTION,
            "brightness": sky_mod.BRIGHTNESS,
            "horizon_size": sky_mod.HORIZON_SIZE,
            "angular_size": sky_mod.ANGULAR_SIZE,
            "glow_intensity": sky_mod.GLOW_INTENSITY,
            "glow_sharpness": sky_mod.GLOW_SHARPNESS,
            "glow_size": sky_mod.GLOW_SIZE,
            "light_radiance": sky_mod.LIGHT_RADIANCE,
        }
        for k, v in kwargs.items():
            self.sky[name_to_idx[k]] = v

    def build_host(self):
        """Flatten to world-space numpy SoA (the host half of build())."""
        if not self.instances:
            raise ValueError("scene has no instances")
        if not self.materials:
            raise ValueError("scene has no materials")
        v0s, e1s, e2s = [], [], []
        n0s, n1s, n2s = [], [], []
        uv0s, uv1s, uv2s = [], [], []
        mats, insts = [], []
        inst_bmin, inst_bmax = [], []
        for inst_id, inst in enumerate(self.instances):
            mesh = self.meshes[inst.mesh_id]
            m = inst.transform
            nm = inst.normal_matrix
            pos = mesh.vertices[:, 0:3] @ m[:, :3].T + m[:, 3]
            nrm = mesh.vertices[:, 3:6] @ nm.T
            nlen = np.linalg.norm(nrm, axis=-1, keepdims=True)
            nrm = nrm / np.maximum(nlen, 1e-12)
            uv = mesh.vertices[:, 6:8]
            i0, i1, i2 = (mesh.indices[:, 0], mesh.indices[:, 1],
                          mesh.indices[:, 2])
            v0s.append(pos[i0])
            e1s.append(pos[i1] - pos[i0])
            e2s.append(pos[i2] - pos[i0])
            n0s.append(nrm[i0]); n1s.append(nrm[i1]); n2s.append(nrm[i2])
            uv0s.append(uv[i0]); uv1s.append(uv[i1]); uv2s.append(uv[i2])
            t = mesh.num_triangles
            mats.append(np.full(t, inst.material_id, np.int32))
            insts.append(np.full(t, inst_id, np.int32))
            inst_bmin.append(pos.min(axis=0))
            inst_bmax.append(pos.max(axis=0))

        def cat(xs):
            return np.concatenate(xs, axis=0).astype(np.float32)

        host = {
            "tri_v0": cat(v0s), "tri_e1": cat(e1s), "tri_e2": cat(e2s),
            "nrm0": cat(n0s), "nrm1": cat(n1s), "nrm2": cat(n2s),
            "uv0": cat(uv0s), "uv1": cat(uv1s), "uv2": cat(uv2s),
            "tri_mat": np.concatenate(mats),
            "tri_inst": np.concatenate(insts),
        }
        host["tri_valid"] = np.ones(host["tri_v0"].shape[0], np.float32)
        return host, (np.stack(inst_bmin).astype(np.float32),
                      np.stack(inst_bmax).astype(np.float32))

    def build(self, device, pad: int = PAD) -> SceneData:
        """Flatten, pad and upload to `device`; pack the textures and
        build the light tree there."""
        host, (inst_bmin, inst_bmax) = self.build_host()
        t = host["tri_v0"].shape[0]
        extra = ((t + pad - 1) // pad) * pad - t
        if extra:
            for k, v in host.items():
                pad_width = [(0, extra)] + [(0, 0)] * (v.ndim - 1)
                fill = -1 if k == "tri_inst" else 0
                host[k] = np.pad(v, pad_width, constant_values=fill)
        lights = (np.stack(self.lights) if self.lights
                  else np.zeros((0, lights_mod.LIGHT_W), np.float32))
        dev = lambda a: torch.as_tensor(a, device=device)
        lights = dev(lights)
        return SceneData(
            **{k: dev(v) for k, v in host.items()},
            materials=dev(np.stack(self.materials)),
            lights=lights,
            sky=dev(self.sky),
            inst_bmin=dev(inst_bmin),
            inst_bmax=dev(inst_bmax),
            textures=dev(tex_mod.pack_textures(self.textures)),
            light_tree=(lightbvh.build_light_tree(lights) if self.lights
                        else None),
        )


def reference_demo_scene() -> Scene:
    """The reference's hard-coded demo scene (two planes, two metallic
    materials, three point lights), as the JAX package builds it."""
    from .mesh import plane

    sc = Scene()
    sc.add_mesh(plane(1.0))
    sc.create_material((1.0, 1.0, 1.0), 1.0)
    sc.create_material((1.0, 1.0, 1.0), 1.0, 0.0)
    sc.create_light((1.0, 0.0, 0.0), (0.0, 0.0, 1.0), 2.0)
    sc.create_light((-1.0, 0.0, 0.0), (0.0, 1.0, 0.0), 2.0)
    sc.create_light((0.0, 0.0, -1.0), (1.0, 0.0, 0.0), 2.0)
    sc.create_instance(0, 1, (0.0, -1.0, 0.0), (0.0, 0.0, 0.0), (1.0, 1.0, 1.0))
    sc.create_instance(0, 0, (0.0, 1.0, 0.0), (0.0, 0.0, 0.0), (4.0, 1.0, 4.0))
    return sc


def bench_scene() -> Scene:
    """The scene `bench.py` times: three icospheres of 1280 triangles
    and a ground plane, lit by two point lights."""
    from .mesh import icosphere, plane

    sc = Scene()
    sphere = sc.add_mesh(icosphere(3))
    ground = sc.add_mesh(plane(8.0))
    white = sc.create_material((0.8, 0.8, 0.8), 0.0, 0.8)
    metal = sc.create_material((0.9, 0.7, 0.3), 1.0, 0.15)
    sc.create_light((0.0, -4.0, -2.0), (1.0, 1.0, 1.0), 30.0)
    sc.create_light((3.0, -2.0, 2.0), (1.0, 0.8, 0.6), 15.0)
    sc.create_instance(ground, white, (0.0, 1.0, 0.0))
    sc.create_instance(sphere, metal, (0.0, 0.0, 0.0))
    sc.create_instance(sphere, white, (-2.0, 0.5, 1.0), scale=(0.5,) * 3)
    sc.create_instance(sphere, metal, (2.0, 0.5, -1.0), scale=(0.5,) * 3)
    return sc


def instance_grid_scene(n: int = 16) -> Scene:
    """The instanced scene the JAX package benchmarks as
    `instanced_tlas_512x384` (scripts/bench_full.py `_instance_grid`):
    an n x n grid of randomly rotated and scaled icosphere instances
    (320 triangles, RandomState(7)) on a ground plane, one point light."""
    from .mesh import icosphere, plane

    sc = Scene()
    sph = sc.add_mesh(icosphere(2))
    gnd = sc.add_mesh(plane(30.0))
    white = sc.create_material((0.8, 0.8, 0.8), 0.0, 0.8)
    metal = sc.create_material((0.9, 0.7, 0.3), 1.0, 0.15)
    sc.create_light((0.0, -6.0, -2.0), (1.0, 1.0, 1.0), 60.0)
    sc.create_instance(gnd, white, (0.0, 1.0, 0.0))
    rs = np.random.RandomState(7)
    for i in range(n):
        for j in range(n):
            s = 0.25 + 0.15 * rs.rand()
            sc.create_instance(
                sph, metal if (i + j) % 2 else white,
                (1.2 * (i - n / 2), 0.5, 1.2 * (j - n / 2)),
                rotation=tuple(rs.uniform(0, 3.14, 3)),
                scale=(s, s, s))
    return sc


def many_lights_scene(n_lights: int = 256) -> Scene:
    """The scene the JAX package benchmarks as `many_lights_256_512x384`
    (scripts/bench_full.py `_many_lights_scene`): a 5 x 5 field of
    icospheres (320 triangles) on a ground plane under a grid of
    `n_lights` colored point lights (RandomState(11))."""
    from .mesh import icosphere, plane

    sc = Scene()
    sph = sc.add_mesh(icosphere(2))
    gnd = sc.add_mesh(plane(40.0))
    white = sc.create_material((0.8, 0.8, 0.8), 0.0, 0.8)
    metal = sc.create_material((0.9, 0.7, 0.3), 1.0, 0.15)
    sc.create_instance(gnd, white, (0.0, 1.0, 0.0))
    for i in range(5):
        for j in range(5):
            sc.create_instance(
                sph, metal if (i + j) % 2 else white,
                (2.0 * (i - 2), 0.3, 2.0 * (j - 2)),
                scale=(0.6, 0.6, 0.6))
    rs = np.random.RandomState(11)
    side = int(np.ceil(np.sqrt(n_lights)))
    for k in range(n_lights):
        i, j = divmod(k, side)
        col = rs.uniform(0.3, 1.0, 3)
        sc.create_light(
            (1.5 * (i - side / 2), -1.5 - rs.rand(), 1.5 * (j - side / 2)),
            tuple(col), 4.0 + 4.0 * rs.rand())
    return sc
