"""The reference path tracer: any set of pixels of one frame, in plain
PyTorch, every ray tested against every triangle.

What it follows, term for term, is the renderer's published frame (the
reference shaders and the JAX package's formulas, which the program
ports): the pixel hash and PCG stream seeded by (pixel, frame), the
jittered pinhole camera (frame 0 through the pixel centre), the closest
hit by Moller-Trumbore, the smooth-normal attribute gather facing the
viewer, the procedural sky on a miss, next-event estimation with one
shadow ray per light and the Disney BRDF, the one-sample bounce (GGX
VNDF, cosine or transmission) and Russian roulette.  Each pixel's path
depends on nothing but its own seed, so a sample of pixels gives the
same values as the whole frame.

The scene: `flatten` places every instance's mesh in the world by its
own T R S matrix (Euler-YXZ rotation, worked in float64 and rounded to
float32, as the upstream `MeshInstance` composes it), and places a
frame's instance poses over that on request.

Hits: `intersect` first keeps, for each ray, the instances whose
bounding sphere the ray's line passes, then, among their triangles,
those whose bounding sphere it passes (three float32 matrix products
give the cross product of each sphere centre with the ray), then runs
the exact test on those pairs alone.  That is brute force over every
placed triangle with the arithmetic bounded; the spheres, with room for
rounding, never drop a pair the exact test could take, and nothing is
shared with a BVH.

`shade_dtype=torch.bfloat16` is the comparison's control: the BRDF
evaluated, and the path's radiance and throughput kept, in bfloat16.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

INF = 1e32
DET_EPS = 1e-12
EPS = 1e-8
PI = 3.1415926535897
ONE_OVER_PI = 0.3183098861837
TWO_PI = 6.2831853071795
ROUGHNESS_MIN = 1e-4
# Elements of one (rays x spheres) block of the sphere test, and the
# triangles of one block.
BLOCK_ELEMS = 1 << 26
TRI_CHUNK = 1 << 16


# ---------------------------------------------------------------------------
# Planar 3-vectors.
# ---------------------------------------------------------------------------

class V3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return V3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    def map(self, f) -> "V3":
        return V3(f(self.x), f(self.y), f(self.z))

    def stack(self) -> torch.Tensor:
        return torch.stack(torch.broadcast_tensors(self.x, self.y, self.z),
                           dim=-1)


def dot(a: V3, b: V3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: V3, b: V3) -> V3:
    return V3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
              a.x * b.y - a.y * b.x)


def length(a: V3):
    return torch.sqrt(torch.clamp(dot(a, a), min=0.0))


def normalize(a: V3) -> V3:
    return a * torch.reciprocal(torch.sqrt(torch.clamp(dot(a, a), min=EPS)))


def where(mask, a: V3, b) -> V3:
    bx, by, bz = (b.x, b.y, b.z) if isinstance(b, V3) else (b, b, b)
    return V3(torch.where(mask, a.x, bx), torch.where(mask, a.y, by),
              torch.where(mask, a.z, bz))


def max_component(a: V3):
    return torch.maximum(a.x, torch.maximum(a.y, a.z))


def basis(n: V3):
    """Frisvad's branch-free basis with its z < -1 guard."""
    degenerate = n.z < -0.99998796
    nz = torch.where(degenerate, 0.0, n.z)
    a = 1.0 / (1.0 + nz)
    b = -n.x * n.y * a
    t = V3(torch.where(degenerate, 0.0, 1.0 - n.x * n.x * a),
           torch.where(degenerate, -1.0, b),
           torch.where(degenerate, 0.0, -n.x))
    bt = V3(torch.where(degenerate, -1.0, b),
            torch.where(degenerate, 0.0, 1.0 - n.y * n.y * a),
            torch.where(degenerate, 0.0, -n.y))
    return t, bt


def to_local(vec: V3, n: V3, frame) -> V3:
    return V3(dot(vec, frame[0]), dot(vec, frame[1]), dot(vec, n))


def to_world(vec: V3, n: V3, frame) -> V3:
    return frame[0] * vec.x + frame[1] * vec.y + n * vec.z


# ---------------------------------------------------------------------------
# RNG: xxHash32-style pixel hash and the PCG32 stream, 32-bit words held
# in int64 and masked after every step.
# ---------------------------------------------------------------------------

M32 = 0xFFFFFFFF
_P1, _P2, _P3, _P4 = 2246822519, 3266489917, 668265263, 374761393
_INV_U32 = torch.tensor(np.float32(1.0 / 4294967295.0))


def _mul32(x, c: int):
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def _rotl(x, r: int):
    return ((x << r) & M32) | (x >> (32 - r))


def pixel_seed(px, py, frame: int):
    x, y = px.to(torch.int64) & M32, py.to(torch.int64) & M32
    z = torch.full_like(x, int(frame) & M32)
    h = (z + _P4 + _mul32(x, _P2)) & M32
    h = _mul32(_rotl(h, 17), _P3)
    h = (h + _mul32(y, _P2)) & M32
    h = _mul32(_rotl(h, 17), _P3)
    h = _mul32(h ^ (h >> 15), _P1)
    h = _mul32(h ^ (h >> 13), _P2)
    return h ^ (h >> 16)


def rand(state):
    prev = (_mul32(state, 747796405) + 2891336453) & M32
    word = _mul32((prev >> ((prev >> 28) + 4)) ^ prev, 277803737)
    word = (word >> 22) ^ word
    return word.to(torch.float32) * _INV_U32, prev


# ---------------------------------------------------------------------------
# Scene: the benchmark's arrays flattened to world-space triangles, with
# one attribute row per triangle (three normals, three UVs, the material
# id, the material record).
# ---------------------------------------------------------------------------

MAT_W = 20
ATTR_MAT = 16


def material_record(m: dict) -> np.ndarray:
    """A Disney material row: color, subsurface, metallic, roughness,
    specular, specular tint, anisotropic, sheen, sheen tint, clearcoat,
    clearcoat gloss, emissive color, emission strength, ior,
    transmission, texture id."""
    r = np.zeros(MAT_W, np.float32)
    r[0:3] = m["color"]
    r[4] = m.get("metallic", 0.0)
    r[5] = m.get("roughness", 1.0)
    r[6] = 0.5
    r[13:16] = m.get("emissive_color", (0.0, 0.0, 0.0))
    r[16] = m.get("emission_strength", 0.0)
    r[17] = 1.5
    r[19] = -1.0
    return r


def light_record(lt: dict) -> np.ndarray:
    """A point light row: position, color, intensity, type 0, no
    direction, cos(cone) -1."""
    r = np.zeros(12, np.float32)
    r[0:3] = lt["position"]
    r[3:6] = lt["color"]
    r[6] = lt["intensity"]
    r[11] = -1.0
    return r


def default_sky() -> np.ndarray:
    s = np.zeros(22, np.float32)
    s[0:3] = (0.17, 0.24, 0.31)
    s[3:6] = (1.0, 0.5, 0.31)
    s[6:9] = (0.1, 0.06, 0.04)
    s[9:12] = (0.9, -0.1, 0.0)
    s[12:15] = (0.0, -1.0, 0.0)
    s[15] = 0.8
    s[16] = 0.5
    s[17] = 0.08
    s[18] = 2.5
    s[19] = 0.2
    s[20] = 0.2
    s[21] = 0.7
    return s


class RefScene(NamedTuple):
    v0: torch.Tensor        # (T, 3)
    e1: torch.Tensor
    e2: torch.Tensor
    attr: torch.Tensor      # (T, 16 + MAT_W)
    centre: torch.Tensor    # (T, 3) bounding-sphere centres
    reach2: torch.Tensor    # (T,) squared radius, with margin
    lights: torch.Tensor    # (L, 12)
    sky: torch.Tensor       # (22,)
    inst_centre: torch.Tensor   # (I, 3) each instance's bounding sphere
    inst_reach2: torch.Tensor   # (I,)
    inst_tri: torch.Tensor      # (I, 2) int64 first triangle, triangles


def rotation_yxz(rotation) -> np.ndarray:
    """(I, 3, 3) float32 Euler-YXZ rotations of (I, 3) angles (x, y, z),
    columns (u, v, w), worked in float64."""
    r = np.asarray(rotation, np.float64).reshape(-1, 3)
    c3, s3 = np.cos(r[:, 2]), np.sin(r[:, 2])
    c2, s2 = np.cos(r[:, 0]), np.sin(r[:, 0])
    c1, s1 = np.cos(r[:, 1]), np.sin(r[:, 1])
    u = np.stack([c1 * c3 + s1 * s2 * s3, c2 * s3, c1 * s2 * s3 - c3 * s1], 1)
    v = np.stack([c3 * s1 * s2 - c1 * s3, c2 * c3, c1 * c3 * s2 + s1 * s3], 1)
    w = np.stack([c2 * s1, -s2, c1 * c2], 1)
    return np.stack([u, v, w], axis=2).astype(np.float32)


def instance_matrices(instances, poses=None) -> np.ndarray:
    """(I, 3, 4) float32 object-to-world matrices T R S of the instances
    (position, Euler-YXZ rotation, scale), each instance in `poses`
    ({index: (position, rotation, scale)}) placed there instead."""
    trs = [(i.get("position", (0.0, 0.0, 0.0)), i.get("rotation",
                                                       (0.0, 0.0, 0.0)),
            i.get("scale", (1.0, 1.0, 1.0))) for i in instances]
    for k, pose in (poses or {}).items():
        trs[k] = pose
    pos, rot, scale = (np.asarray([t[k] for t in trs], np.float64)
                       for k in range(3))
    m = np.zeros((len(trs), 3, 4), np.float32)
    m[:, :, :3] = rotation_yxz(rot) * scale.astype(np.float32)[:, None, :]
    m[:, :, 3] = pos
    return m


def _place(scene, mtx: np.ndarray, sel: np.ndarray, first: np.ndarray):
    """Place the instances `sel` (ascending) by their matrices: for each
    mesh, (those instances, the rows of their triangles, the rows'
    world-space v0, e1, e2 and vertex normals n0, n1, n2, and each
    instance's bounding sphere, centre and radius)."""
    names = np.asarray([scene.instances[k]["mesh"] for k in sel])
    for name, mesh in scene.meshes.items():
        which = sel[names == name]
        if which.size == 0:
            continue
        m = mtx[which]
        nm = np.linalg.inv(m[:, :, :3]).transpose(0, 2, 1)
        pos = np.matmul(mesh.positions, m[:, :, :3].transpose(0, 2, 1)) \
            + m[:, None, :, 3]
        nrm = np.matmul(mesh.normals, nm.transpose(0, 2, 1))
        nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True),
                               1e-12)
        centre = 0.5 * (pos.min(axis=1) + pos.max(axis=1))
        radius = np.linalg.norm(pos - centre[:, None], axis=-1).max(axis=1)
        t = mesh.indices.shape[0]
        rows = (first[which][:, None] + np.arange(t)).reshape(-1)
        i0, i1, i2 = (mesh.indices[:, k] for k in range(3))
        tri = {"v0": pos[:, i0], "e1": pos[:, i1] - pos[:, i0],
               "e2": pos[:, i2] - pos[:, i0], "n0": nrm[:, i0],
               "n1": nrm[:, i1], "n2": nrm[:, i2]}
        yield which, rows, {k: v.reshape(-1, 3) for k, v in tri.items()}, \
            centre, radius


def _spheres(v0, e1, e2):
    """Each triangle's bounding sphere: centroid and squared reach."""
    centre = v0 + (e1 + e2) * (1.0 / 3.0)
    r = torch.stack([torch.linalg.vector_norm(p - centre, dim=1)
                     for p in (v0, v0 + e1, v0 + e2)]).amax(0)
    return centre, _reach2(r)


def flatten(scene, device, poses=None, base=None) -> RefScene:
    """World-space triangles of a geometry.SceneArrays, instance by
    instance in order, materials numbered in the order of the
    configuration's table; `poses` ({index: (position, rotation,
    scale)}) moves instances from where the configuration puts them.
    With `base`, this scene flattened without poses, only the posed
    instances are placed, over copies of its tensors."""
    insts = scene.instances
    mtx = instance_matrices(insts, poses)
    ntri = np.asarray([scene.meshes[i["mesh"]].indices.shape[0]
                       for i in insts], np.int64)
    first = np.concatenate([[0], np.cumsum(ntri)[:-1]]).astype(np.int64)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    if base is not None:
        return _repose(base, _place(scene, mtx, np.asarray(
            sorted(poses or {}), np.int64), first), f32)
    mat_ids = {name: i for i, name in enumerate(scene.materials)}
    mats = np.stack([material_record(m) for m in scene.materials.values()])
    total = int(ntri.sum())
    cat = {k: np.empty((total, 3), np.float32) for k in ("v0", "e1", "e2",
                                                          "n0", "n1", "n2")}
    cat.update({k: np.empty((total, 2), np.float32)
                for k in ("uv0", "uv1", "uv2")})
    cat["mat"] = np.empty(total, np.int64)
    inst_centre = np.empty((len(insts), 3), np.float32)
    inst_r = np.empty(len(insts), np.float32)
    for which, rows, tri, centre, radius in _place(
            scene, mtx, np.arange(len(insts)), first):
        for k, v in tri.items():
            cat[k][rows] = v
        inst_centre[which], inst_r[which] = centre, radius
        mesh = scene.meshes[insts[which[0]]["mesh"]]
        t = mesh.indices.shape[0]
        for k, ik in zip(("uv0", "uv1", "uv2"), mesh.indices.T):
            cat[k][rows] = np.broadcast_to(
                mesh.uvs[ik], (which.size, t, 2)).reshape(-1, 2)
        cat["mat"][rows] = np.repeat(
            [mat_ids[insts[k]["material"]] for k in which], t)
    v0, e1, e2 = f32(cat["v0"]), f32(cat["e1"]), f32(cat["e2"])
    attr = torch.cat([f32(cat[k]) for k in ("n0", "n1", "n2", "uv0", "uv1",
                                            "uv2")]
                     + [f32(cat["mat"][:, None]), f32(mats[cat["mat"]])],
                     dim=1)
    centre, reach2 = _spheres(v0, e1, e2)
    lights = f32(np.stack([light_record(lt) for lt in scene.lights]))
    return RefScene(v0, e1, e2, attr, centre, reach2, lights,
                    f32(default_sky()), f32(inst_centre),
                    _reach2(f32(inst_r)), torch.as_tensor(
                        np.stack([first, ntri], 1), device=device))


def _repose(base: RefScene, placed, f32) -> RefScene:
    """`base` with the rows of the instances `placed` gives written over
    copies of its tensors: positions, vertex normals, spheres."""
    sc = base._replace(**{k: getattr(base, k).clone() for k in (
        "v0", "e1", "e2", "attr", "centre", "reach2", "inst_centre",
        "inst_reach2")})
    for which, rows, tri, centre, radius in placed:
        at = torch.as_tensor(rows, device=sc.v0.device)
        v0, e1, e2 = f32(tri["v0"]), f32(tri["e1"]), f32(tri["e2"])
        for k, v in (("v0", v0), ("e1", e1), ("e2", e2)):
            getattr(sc, k)[at] = v
        sc.attr[at, 0:9] = torch.cat([f32(tri[k]) for k in ("n0", "n1",
                                                            "n2")], dim=1)
        sc.centre[at], sc.reach2[at] = _spheres(v0, e1, e2)
        ins = torch.as_tensor(which, device=sc.v0.device)
        sc.inst_centre[ins] = f32(centre)
        sc.inst_reach2[ins] = _reach2(f32(radius))
    return sc


def _reach2(r: torch.Tensor) -> torch.Tensor:
    """Squared test radius of spheres of radius r: room for the float32
    rounding of the sphere test (terms of about the scene's size, 1e-6
    each) on top of the exact radius."""
    return (r * (1.0 + 1e-5) + 1e-4) ** 2


# ---------------------------------------------------------------------------
# Hits.
# ---------------------------------------------------------------------------

def _near(rays_a, dd, centre, reach2, rays=None):
    """(ray, sphere) pairs, the ray's line passing the sphere:
    |(c - o) x d|^2 <= reach^2 |d|^2, the cross product c x d - o x d
    taken as three float32 matrix products of `rays_a` (3, N, 3) rows
    (`_ray_rows`) and the spheres' columns.  `rays` (int64) limits the
    test to those rays."""
    s = centre.shape[0]
    chunk = min(s, TRI_CHUNK)
    rays = (torch.arange(rays_a.shape[1], device=centre.device)
            if rays is None else rays)
    rb = max(1, BLOCK_ELEMS // chunk)
    one = torch.ones_like(centre[:, 0])
    cols = torch.stack([
        torch.stack([centre[:, 1], centre[:, 2], one]),
        torch.stack([centre[:, 2], centre[:, 0], one]),
        torch.stack([centre[:, 0], centre[:, 1], one])])    # (3, 3, S)
    out_r, out_s = [], []
    for r0 in range(0, rays.shape[0], rb):
        idx = rays[r0:r0 + rb]
        a = rays_a[:, idx]
        for s0 in range(0, s, chunk):
            xyz = torch.bmm(a, cols[:, :, s0:s0 + chunk])
            dist2 = (xyz * xyz).sum(0)
            near = dist2 <= reach2[None, s0:s0 + chunk] * dd[idx, None]
            ij = near.nonzero()
            out_r.append(idx[ij[:, 0]])
            out_s.append(ij[:, 1] + s0)
    empty = torch.zeros(0, dtype=torch.int64, device=centre.device)
    return torch.cat([empty] + out_r), torch.cat([empty] + out_s)


def _ray_rows(o: torch.Tensor, d: torch.Tensor):
    """The rays' rows of the sphere test (d_z, -d_y, -(o x d)_x), ...,
    and |d|^2."""
    od = torch.linalg.cross(o, d, dim=1)
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    rays_a = torch.stack([
        torch.stack([dz, -dy, -od[:, 0]], 1),
        torch.stack([dx, -dz, -od[:, 1]], 1),
        torch.stack([dy, -dx, -od[:, 2]], 1)])          # (3, N, 3)
    return rays_a, (d * d).sum(1)


def _pairs(sc: RefScene, o: torch.Tensor, d: torch.Tensor):
    """(ray, triangle) pairs whose triangle's bounding sphere the ray's
    line passes (`_near`), among the triangles of the instances whose
    bounding sphere it passes: each block of TRI_CHUNK triangles is
    tested against the rays that pass an instance holding one of them."""
    n = o.shape[0]
    dev = o.device
    rays_a, dd = _ray_rows(o, d)
    empty = torch.zeros(0, dtype=torch.int64, device=dev)
    rays, tris = [empty], [empty]
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ray_i, inst = _near(rays_a, dd, sc.inst_centre, sc.inst_reach2)
        # The instances' first and last blocks of triangles.
        first, count = sc.inst_tri[:, 0], sc.inst_tri[:, 1]
        b0 = first // TRI_CHUNK
        nb = (first + count - 1) // TRI_CHUNK - b0 + 1
        per = nb[inst]
        at = torch.arange(int(per.sum()), device=dev) - torch.repeat_interleave(
            torch.cumsum(per, 0) - per, per)
        block = torch.repeat_interleave(b0[inst], per) + at
        key = torch.unique(block * n + torch.repeat_interleave(ray_i, per))
        blocks, counts = torch.unique_consecutive(key // n,
                                                  return_counts=True)
        ray_of = key % n
        at = 0
        for b, c in zip(blocks.tolist(), counts.tolist()):
            t0 = b * TRI_CHUNK
            r, t = _near(rays_a, dd, sc.centre[t0:t0 + TRI_CHUNK],
                         sc.reach2[t0:t0 + TRI_CHUNK], ray_of[at:at + c])
            rays.append(r)
            tris.append(t + t0)
            at += c
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return torch.cat(rays), torch.cat(tris)


def _moller_trumbore(o: V3, d: V3, v0: V3, e1: V3, e2: V3, t_min, t_max):
    pvec = cross(d, e2)
    det = dot(e1, pvec)
    ok = torch.abs(det) > DET_EPS
    inv_det = torch.where(ok, 1.0 / det, 0.0)
    tvec = o - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(d, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) \
        & (t > t_min) & (t < t_max)
    return hit, t, u, v


def _as_v3(a: torch.Tensor) -> V3:
    return V3(a[:, 0], a[:, 1], a[:, 2])


def intersect(sc: RefScene, o: V3, d: V3, t_min: float, t_max,
              closest: bool):
    """Closest hits (t, triangle or -1, u, v) or the occlusion mask of
    rays over (t_min, t_max); a ray whose t_max <= t_min is not
    traced.  Among hits at one t the lowest triangle id wins."""
    n = o.x.shape[0]
    dev = o.x.device
    tmax = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                              device=dev), (n,))
    live = (tmax > t_min).nonzero()[:, 0]
    oa, da = o.stack()[live], d.stack()[live]
    ray, tri = _pairs(sc, oa, da)
    hit, t, u, v = _moller_trumbore(
        _as_v3(oa[ray]), _as_v3(da[ray]), _as_v3(sc.v0[tri]),
        _as_v3(sc.e1[tri]), _as_v3(sc.e2[tri]), t_min, tmax[live][ray])
    gray = live[ray]
    if not closest:
        occ = torch.zeros(n, dtype=torch.bool, device=dev)
        occ[gray[hit]] = True
        return occ
    t = torch.where(hit, t, INF)
    best_t = tmax.clone().scatter_reduce(0, gray, t, "amin")
    win = hit & (t == best_t[gray])
    big = torch.iinfo(torch.int64).max
    best_i = torch.full((n,), big, dtype=torch.int64, device=dev) \
        .scatter_reduce(0, gray, torch.where(win, tri, big), "amin")
    sel = win & (tri == best_i[gray])
    out_u = torch.zeros(n, device=dev)
    out_v = torch.zeros(n, device=dev)
    out_u[gray[sel]] = u[sel]
    out_v[gray[sel]] = v[sel]
    best_i = torch.where(best_i == big, -1, best_i)
    return best_t, best_i, out_u, out_v


# ---------------------------------------------------------------------------
# Camera.
# ---------------------------------------------------------------------------

def camera_basis(rotation) -> np.ndarray:
    """Rows (u, v, w) of the Euler-YXZ view rotation, float32."""
    rx, ry, rz = (np.float32(a) for a in rotation)
    c3, s3 = np.cos(rz), np.sin(rz)
    c2, s2 = np.cos(rx), np.sin(rx)
    c1, s1 = np.cos(ry), np.sin(ry)
    return np.array([[c1 * c3 + s1 * s2 * s3, c2 * s3, c1 * s2 * s3 - c3 * s1],
                     [c3 * s1 * s2 - c1 * s3, c2 * c3, c1 * c3 * s2 + s1 * s3],
                     [c2 * s1, -s2, c1 * c2]], np.float32)


class Cam(NamedTuple):
    origin: torch.Tensor
    basis: torch.Tensor
    tan_half_fovy: torch.Tensor
    aspect: torch.Tensor


def camera(view: dict, width: int, height: int, device) -> Cam:
    """`view`: position, rotation, fov_y."""
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return Cam(f32(view["position"]), f32(camera_basis(view["rotation"])),
               f32(np.float32(math.tan(view["fov_y"] / 2.0))),
               f32(width / height))


def primary_rays(cam: Cam, width: int, height: int, pxf, pyf):
    cx = pxf / np.float32(width) * 2.0 - 1.0
    cy = pyf / np.float32(height) * 2.0 - 1.0
    dcx = cam.aspect * cam.tan_half_fovy * cx
    dcy = cam.tan_half_fovy * cy
    inv_len = 1.0 / torch.sqrt(torch.clamp(dcx * dcx + dcy * dcy + 1.0,
                                           min=1e-16))
    dcx, dcy, dcz = dcx * inv_len, dcy * inv_len, inv_len
    b = cam.basis
    dirs = V3(dcx * b[0, 0] + dcy * b[1, 0] + dcz * b[2, 0],
              dcx * b[0, 1] + dcy * b[1, 1] + dcz * b[2, 1],
              dcx * b[0, 2] + dcy * b[1, 2] + dcz * b[2, 2])
    ones = torch.ones_like(pxf)
    o = cam.origin
    return V3(o[0] * ones, o[1] * ones, o[2] * ones), dirs


# ---------------------------------------------------------------------------
# Shading: sky, lights, Disney BRDF, bounce samplers.
# ---------------------------------------------------------------------------

def _unit3(a: torch.Tensor) -> torch.Tensor:
    return a * torch.reciprocal(torch.sqrt(torch.clamp(
        torch.sum(a * a, dim=-1, keepdim=True), min=EPS)))


def sky_radiance(sky: torch.Tensor, d: V3) -> V3:
    up = _unit3(sky[12:15])
    sun = _unit3(sky[9:12])
    elev = d.x * up[0] + d.y * up[1] + d.z * up[2]
    hs = torch.clamp(sky[16], min=1e-3)
    t_sky = torch.clamp(elev / hs, 0.0, 1.0)
    t_gnd = torch.clamp(-elev / hs, 0.0, 1.0)
    hor, skc, gnd = (V3(sky[i], sky[i + 1], sky[i + 2]) for i in (3, 0, 6))
    base = hor * ((1.0 - t_sky) * (1.0 - t_gnd)) + skc * t_sky + gnd * t_gnd
    cos_sun = d.x * sun[0] + d.y * sun[1] + d.z * sun[2]
    disc = (cos_sun >= torch.cos(sky[17])).to(torch.float32) * sky[21]
    ang = torch.arccos(torch.clamp(cos_sun, -1.0, 1.0))
    glow = sky[18] * torch.exp(
        -(ang - sky[17]) / torch.clamp(sky[20], min=1e-3)
        * torch.clamp(sky[19], min=1e-3) * 10.0) \
        * (cos_sun > 0).to(torch.float32)
    above = (elev > -hs).to(torch.float32)
    return base * sky[15] + (disc + glow) * above


class Mat(NamedTuple):
    color: V3
    subsurface: torch.Tensor
    metallic: torch.Tensor
    roughness: torch.Tensor
    specular: torch.Tensor
    specular_tint: torch.Tensor
    anisotropic: torch.Tensor
    sheen_tint: torch.Tensor
    clearcoat: torch.Tensor
    clearcoat_gloss: torch.Tensor
    emissive: V3
    emission_strength: torch.Tensor
    ior: torch.Tensor
    transmission: torch.Tensor

    @staticmethod
    def from_rows(rt) -> "Mat":
        f = lambda i: rt[ATTR_MAT + i]
        return Mat(V3(f(0), f(1), f(2)), f(3), f(4), f(5), f(6), f(7), f(8),
                   f(10), f(11), f(12), V3(f(13), f(14), f(15)), f(16),
                   f(17), f(18))

    def to(self, dtype) -> "Mat":
        return Mat(*(f.map(lambda a: a.to(dtype)) if isinstance(f, V3)
                     else f.to(dtype) for f in self))


def schlick_weight(f):
    m = torch.clamp(1.0 - f, 0.0, 1.0)
    return m * m * m * m * m


def _schlick_fresnel(f0, vdoth):
    m = 1.0 - vdoth
    return f0 + (1.0 - f0) * (m * m * m * m * m)


def _gtr1(ndoth, a):
    a2 = a * a
    val = (a2 - 1.0) / (PI * torch.log2(torch.clamp(a2, min=1e-8))
                        * (1.0 + (a2 - 1.0) * ndoth * ndoth))
    return torch.where(a >= 1.0, ONE_OVER_PI, val)


def _smith_ggx(ndotv, a):
    a2 = a * a
    return 2.0 / (1.0 + torch.sqrt(a2 + (1.0 - a2) * ndotv * ndotv))


def _tint(color: V3) -> V3:
    lum = 0.3 * color.x + 0.6 * color.y + 1.0 * color.z
    return where(lum > 0.0, color * (1.0 / torch.clamp(lum, min=1e-12)), 1.0)


def _aniso(anisotropic, roughness):
    aspect = torch.sqrt(1.0 - anisotropic * 0.9)
    r2 = roughness * roughness
    return (torch.clamp(r2 / aspect, min=1e-3),
            torch.clamp(r2 * aspect, min=1e-3))


def disney_brdf(mat: Mat, n: V3, v: V3, l: V3) -> V3:
    """The reference shaders' Disney BRDF (GTR1 with log2, no sheen
    scale, Schlick of L.H in the specular Fresnel), zero unless n.l > 0
    and n.v > 0."""
    ndotl, ndotv = dot(n, l), dot(n, v)
    h = normalize(v + l)
    ndoth, hdotl = dot(n, h), dot(h, l)
    frame = basis(n)
    lh, lv, ll = (to_local(a, n, frame) for a in (h, v, l))
    tint = _tint(mat.color)
    sheen = ((tint - 1.0) * mat.sheen_tint + 1.0) * schlick_weight(hdotl)
    cc = (0.25 * mat.clearcoat
          * _gtr1(ndoth, 0.1 + (0.001 - 0.1) * mat.clearcoat_gloss)
          * _schlick_fresnel(0.04, hdotl)
          * (_smith_ggx(ndotl, 0.25) * _smith_ggx(ndotv, 0.25)))
    ax, ay = _aniso(mat.anisotropic, mat.roughness)
    base = ((tint - 1.0) * mat.specular_tint + 1.0) * (mat.specular * 0.08)
    scol = base + (mat.color - base) * mat.metallic
    s = (lh.x / ax) ** 2 + (lh.y / ay) ** 2 + lh.z * lh.z
    dterm = 1.0 / (PI * ax * ay * s * s)
    fres = schlick_weight(dot(ll, lh))
    sg = lambda w: 1.0 / (w.z + torch.sqrt((w.x * ax) ** 2
                                           + (w.y * ay) ** 2 * w.z * w.z))
    spec = (scol + (1.0 - scol) * fres) * (dterm * (sg(ll) * sg(lv)))
    rough = mat.roughness
    fl, fv = schlick_weight(ll.z), schlick_weight(lv.z)
    hl = dot(lh, ll)
    fd90 = 0.5 + 2.0 * rough * hl * hl
    fd = (1.0 + (fd90 - 1.0) * fl) * (1.0 + (fd90 - 1.0) * fv)
    fss90 = hl * hl * rough
    fss = (1.0 + (fss90 - 1.0) * fl) * (1.0 + (fss90 - 1.0) * fv)
    ss = 1.25 * (fss * (1.0 / torch.clamp(ll.z + lv.z, min=1e-6) - 0.5) + 0.5)
    diffuse = fd + (ss - fd) * mat.subsurface
    out = ((mat.color * (ONE_OVER_PI * diffuse) + sheen)
           * (1.0 - mat.metallic) + spec + cc)
    return where((ndotl > 0.0) & (ndotv > 0.0), out, 0.0)


def _vndf_ratio(mat: Mat, wo: V3, wi: V3):
    r = torch.clamp(mat.roughness, min=ROUGHNESS_MIN)
    a2 = (r * r) * (r * r)
    f1 = torch.sqrt(a2 + (1.0 - a2) * wi.z * wi.z)
    f2 = torch.sqrt(a2 + (1.0 - a2) * wo.z * wo.z)
    g1 = 2.0 * wo.z / torch.clamp(f2 + wo.z, min=1e-8)
    g2 = 2.0 * wi.z * wo.z / torch.clamp(f1 * wo.z + f2 * wi.z, min=1e-8)
    return g2 / torch.clamp(g1, min=1e-8)


def _ggx_vndf(mat: Mat, view: V3, n: V3, u0, u1, frame):
    """Spherical-cap GGX-VNDF reflection (Dupuy-Benyoub) and its G2/G1
    weight, zero below the surface."""
    wo = to_local(view, n, frame)
    aspect = torch.sqrt(1.0 - mat.anisotropic * 0.9)
    r = torch.clamp(mat.roughness, min=ROUGHNESS_MIN)
    ax = torch.clamp(r * r / aspect, min=1e-3)
    ay = torch.clamp(r * r * aspect, min=1e-3)
    v = normalize(V3(ax * wo.x, ay * wo.y, wo.z))
    lensq = v.x * v.x + v.y * v.y
    ok = lensq > 1e-12
    rs = torch.where(ok, 1.0 / torch.sqrt(torch.clamp(lensq, min=1e-12)), 0.0)
    t1 = V3(torch.where(ok, -v.y * rs, 1.0), torch.where(ok, v.x * rs, 0.0),
            torch.zeros_like(rs))
    t2 = cross(v, t1)
    rr = torch.sqrt(u0)
    phi = TWO_PI * u1
    p1, p2 = rr * torch.cos(phi), rr * torch.sin(phi)
    s = 0.5 * (1.0 + v.z)
    p2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=0.0)) + s * p2
    nh = t1 * p1 + t2 * p2 + v * torch.sqrt(
        torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))
    wm = normalize(V3(ax * nh.x, ay * nh.y, torch.clamp(nh.z, min=0.0)))
    wi = wm * (2.0 * dot(wo, wm)) - wo
    weight = torch.where(wi.z > 0.0, _vndf_ratio(mat, wo, wi), 0.0)
    return to_world(wi, n, frame), weight


def _refract(view: V3, n: V3, eta):
    cos_i = dot(view, n)
    sin2_t = eta * eta * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    return normalize(view * (-eta) + n * (eta * cos_i - cos_t)), sin2_t > 1.0


def sample_bounce(mat: Mat, n: V3, view: V3, seed, entering, frame):
    """One-sample lobe choice (draws: u0, u1, the lobe, the Fresnel
    choice, the transmission choice) -> (direction, weight, seed,
    transmitted)."""
    u0, seed = rand(seed)
    u1, seed = rand(seed)
    usel, seed = rand(seed)
    metallic = mat.metallic
    rough = torch.clamp(mat.roughness, min=ROUGHNESS_MIN)
    ior = torch.clamp(mat.ior, min=1.0001)
    p_spec = torch.clamp(metallic + 0.25 * (1.0 - rough), 0.0, 0.95)
    d_spec, w_spec = _ggx_vndf(mat, view, n, u0, u1, frame)
    phi = TWO_PI * u1
    cos_t = torch.sqrt(u0)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    d_diff = to_world(V3(sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                         cos_t), n, frame)
    color = mat.color
    fres = schlick_weight(dot(d_spec, normalize(view + d_spec)))
    spec_col = ((color + (1.0 - color) * fres) * metallic
                + (0.04 + 0.96 * fres) * (1.0 - metallic))
    diff_col = color * (1.0 - metallic)
    take_spec = usel < p_spec
    direction = where(take_spec, d_spec, d_diff)
    p = torch.where(take_spec, torch.clamp(p_spec, min=1e-3),
                    torch.clamp(1.0 - p_spec, min=1e-3))
    weight = where(take_spec, spec_col * w_spec, diff_col) * (1.0 / p)
    weight = where(~(take_spec & (w_spec <= 0.0)), weight, 0.0)
    eta = torch.where(entering, 1.0 / ior, ior)
    d_refr, tir = _refract(view, n, eta)
    f0 = ((1.0 - ior) / (1.0 + ior)) ** 2
    fr = f0 + (1.0 - f0) * schlick_weight(torch.abs(dot(view, n)))
    u_t, seed = rand(seed)
    reflect = tir | (u_t < fr)
    d_mirr = normalize(n * (2.0 * dot(view, n)) - view)
    u_ts, seed = rand(seed)
    take_trans = (mat.transmission > 0.0) & (u_ts < mat.transmission)
    direction = where(take_trans, where(reflect, d_mirr, d_refr), direction)
    weight = where(take_trans, color, weight)
    return direction, weight, seed, take_trans & ~reflect


def _point_light(light: torch.Tensor, p: V3):
    """(unnormalised direction to the light, color, intensity) of a
    point light (1/d^2 falloff)."""
    to_l = V3(light[0] - p.x, light[1] - p.y, light[2] - p.z)
    d2 = dot(to_l, to_l)
    return to_l, V3(light[3], light[4], light[5]), \
        light[6] / torch.clamp(d2, min=1e-12)


# ---------------------------------------------------------------------------
# The path.
# ---------------------------------------------------------------------------

def _round(a: V3, dtype) -> V3:
    if dtype is None:
        return a
    return a.map(lambda x: x.to(dtype).to(torch.float32))


def trace_paths(sc: RefScene, o: V3, d: V3, seed, cfg: dict,
                shade_dtype=None, want_gbuffer: bool = False):
    """Radiance (V3) of rays over up to max_depth depths, and with
    `want_gbuffer` the first hit's G-buffer (normal, depth, albedo,
    world_pos, hit; misses 0, albedo 1)."""
    n = o.x.shape[0]
    dev = o.x.device
    zero = torch.zeros(n, device=dev)
    radiance = V3(zero, zero, zero)
    one = torch.ones(n, device=dev)
    throughput = V3(one, one, one)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    gbuffer = None
    t_min = cfg["t_min"]
    for depth in range(cfg["max_depth"]):
        t_max = INF if depth == 0 else torch.where(active, INF, -1.0)
        t, tri, u, v = intersect(sc, o, d, t_min, t_max, closest=True)
        hit_any = tri >= 0
        rows = sc.attr[tri.clamp(min=0)]
        rt = rows.T
        w = 1.0 - u - v
        nrm = normalize(V3(w * rt[0] + u * rt[3] + v * rt[6],
                           w * rt[1] + u * rt[4] + v * rt[7],
                           w * rt[2] + u * rt[5] + v * rt[8]))
        mat = Mat.from_rows(rt)
        view = -d
        entering = dot(nrm, view) >= 0.0
        nrm = where(entering, nrm, -nrm)
        wpos = o + d * t
        hit = hit_any & active
        sky = sky_radiance(sc.sky, d) if cfg["sky"] else V3(zero, zero, zero)
        radiance = radiance + where(active & ~hit_any, throughput * sky, 0.0)
        direct = V3(zero, zero, zero)
        shadow_o = wpos + nrm * cfg["normal_offset"]
        for i in range(sc.lights.shape[0]):
            ldir, lcol, lint = _point_light(sc.lights[i], wpos)
            l = normalize(ldir)
            rel = (dot(nrm, l) > 0.0) & (lint >= cfg["light_threshold"]) & hit
            occ = intersect(sc, shadow_o, l, t_min,
                            torch.where(rel, length(ldir), -1.0),
                            closest=False)
            if shade_dtype is None:
                f = disney_brdf(mat, nrm, view, l)
            else:
                cast = lambda a: a.map(lambda x: x.to(shade_dtype))
                f = disney_brdf(mat.to(shade_dtype), cast(nrm), cast(view),
                                cast(l)).map(lambda x: x.to(torch.float32))
            f = where(rel, f, 0.0) * lcol
            contrib = f * lint * (1.0 - occ.to(torch.float32))
            direct = direct + where(rel, contrib, 0.0)
        emissive = mat.emissive * mat.emission_strength
        radiance = _round(radiance + where(hit, throughput
                                           * (direct + emissive), 0.0),
                          shade_dtype)
        if want_gbuffer and depth == 0:
            gbuffer = {
                "normal": where(hit_any, nrm, 0.0).stack(),
                "depth": torch.where(hit_any, t, 0.0),
                "albedo": where(hit_any, mat.color, 1.0).stack(),
                "world_pos": where(hit_any, wpos, 0.0).stack(),
                "hit": hit_any.to(torch.float32)}
        if not cfg["indirect"] or depth + 1 == cfg["max_depth"]:
            break
        frame = basis(nrm)
        new_d, weight, seed, transmitted = sample_bounce(
            mat, nrm, view, seed, entering, frame)
        throughput = throughput * weight
        o = wpos + nrm * (torch.where(transmitted, -1.0, 1.0)
                          * cfg["bounce_offset"])
        d = new_d
        active = active & hit & (max_component(throughput) > 1e-5)
        if cfg["russian_roulette"] and depth + 1 >= cfg["rr_start_depth"]:
            p_cont = torch.clamp(max_component(throughput), 0.05, 0.95)
            u_rr, seed = rand(seed)
            throughput = throughput * (1.0 / p_cont)
            active = active & (u_rr < p_cont)
        throughput = _round(where(active, throughput, 0.0), shade_dtype)
    return (radiance, gbuffer) if want_gbuffer else radiance


RENDER_DEFAULTS = {"spp": 1, "max_depth": 2, "light_threshold": 1e-4,
                   "sky": False, "jitter": False, "indirect": False,
                   "russian_roulette": True, "rr_start_depth": 2,
                   "normal_offset": 1e-4, "bounce_offset": 1e-3,
                   "t_min": 1e-3}


def render_pixels(sc: RefScene, view: dict, cfg: dict, px, py, frame: int,
                  shade_dtype=None, want_gbuffer: bool = False):
    """Radiance (N, 3) of pixels (px, py) (int64) of frame `frame`, one
    sample each, and with `want_gbuffer` their G-buffer.  `cfg` holds
    the traffic's render settings over RENDER_DEFAULTS."""
    cfg = {**RENDER_DEFAULTS, **cfg}
    if cfg["spp"] != 1:
        raise ValueError("the reference renders one sample a pixel")
    width, height = cfg["width"], cfg["height"]
    cam = camera(view, width, height, px.device)
    seed = pixel_seed(px, py, frame)
    pxf, pyf = px.to(torch.float32), py.to(torch.float32)
    if cfg["jitter"]:
        jx, seed = rand(seed)
        jy, seed = rand(seed)
        pxf = pxf + (0.5 if frame == 0 else jx)
        pyf = pyf + (0.5 if frame == 0 else jy)
    o, d = primary_rays(cam, width, height, pxf, pyf)
    out = trace_paths(sc, o, d, seed, cfg, shade_dtype, want_gbuffer)
    if want_gbuffer:
        return out[0].stack(), out[1]
    return out.stack()
