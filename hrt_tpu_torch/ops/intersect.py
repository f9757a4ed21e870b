"""Ray-triangle intersection and the brute-force tracers (the oracle
the traversal tests check against), as hrt_tpu/ops/intersect.py.
Arrays keep the JAX package's (..., 3) layout."""
from __future__ import annotations

import torch

INF = 1e32      # ref: shaders/constants.slang (INFINITE)
TMIN = 1e-3
_DET_EPS = 1e-12


def _cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] \
        + a[..., 2] * b[..., 2]


def moller_trumbore(ray_o, ray_d, v0, e1, e2, t_min, t_max):
    """Batched Möller-Trumbore over broadcast (..., 3) arguments.
    Returns (hit, t, u, v).  Degenerate (zero-padded) triangles never
    hit.  No culling: the reference traces without backface flags."""
    pvec = _cross(ray_d, e2)
    det = _dot(e1, pvec)
    ok = torch.abs(det) > _DET_EPS
    inv_det = torch.where(ok, 1.0 / det, 0.0)
    tvec = ray_o - v0
    u = _dot(tvec, pvec) * inv_det
    qvec = _cross(tvec, e1)
    v = _dot(ray_d, qvec) * inv_det
    t = _dot(e2, qvec) * inv_det
    hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) \
        & (t > t_min) & (t < t_max)
    return hit, t, u, v


def safe_inv_dir(d: torch.Tensor) -> torch.Tensor:
    """1/d with components below 1e-20 in magnitude clamped to +-1e-20."""
    tiny = 1e-20
    safe = torch.where(torch.abs(d) < tiny,
                       torch.where(d < 0, -tiny, tiny), d)
    return 1.0 / safe


# ---------------------------------------------------------------------------
# Pieces of the walks' plain versions (ops/traversal_*.py), the same terms
# as the kernels' csrc/walk_common.cuh.
# ---------------------------------------------------------------------------

def slab_hit(box, inv, oi, t_min: float, t):
    """Whether rays (m, 3 inverse directions `inv`, `oi` = o * inv) meet
    boxes (m, 6: min xyz, max xyz) within (t_min, t)."""
    return slab_near(box, inv, oi, t_min, t)[0]


def slab_near(box, inv, oi, t_min: float, t):
    """slab_hit and the entry distance: (hit (m,), t_near (m,))."""
    ta = box[:, 0:3] * inv - oi
    tb = box[:, 3:6] * inv - oi
    lo = torch.minimum(ta, tb)
    hi = torch.maximum(ta, tb)
    t_near = torch.maximum(torch.maximum(lo[:, 0], lo[:, 1]),
                           torch.clamp(lo[:, 2], min=t_min))
    t_far = torch.minimum(torch.minimum(hi[:, 0], hi[:, 1]),
                          torch.minimum(hi[:, 2], t))
    return t_near <= t_far, t_near


def leaf_hits(tris, start, leaf_size: int, o, d, t_min: float, t):
    """Möller-Trumbore of rays (m, 3) against the K triangles of leaves
    starting at pool slots `start` (m,) of the (T, 12) table, below the
    rays' live t (m,).  Returns (hit (m,), t, pool id, u, v): the first
    nearest hit of each row, as a walk testing the K triangles in slot
    order finds it."""
    ids = start[:, None] + torch.arange(leaf_size, device=start.device)
    tr = tris[ids]
    h, th, uh, vh = moller_trumbore(o[:, None], d[:, None], tr[..., 0:3],
                                    tr[..., 3:6], tr[..., 6:9], t_min,
                                    t[:, None])
    tj, jj = torch.min(torch.where(h, th, INF), dim=1)
    pick = lambda a: torch.gather(a, 1, jj[:, None])[:, 0]
    return h.any(dim=1), tj, pick(ids).to(torch.int32), pick(uh), pick(vh)


def first_hit_slot(tris, start, leaf_size: int, o, d, t_min: float, t):
    """Slot (0..K-1) of the first triangle in slot order that each ray
    hits in the leaf at pool slot `start` (rays that hit it): where an
    any-hit walk stops testing."""
    ids = start[:, None] + torch.arange(leaf_size, device=start.device)
    tr = tris[ids]
    h = moller_trumbore(o[:, None], d[:, None], tr[..., 0:3], tr[..., 3:6],
                        tr[..., 6:9], t_min, t[:, None])[0]
    return torch.argmax(h.to(torch.int8), dim=1)


def leaf_test_counts(tris, leaf_size: int, rays, start, better, o, d,
                     t_min: float, t, find_closest: bool):
    """Triangle tests of rays `rays` entering the leaves at pool slots
    `start` (`better`: leaf_hits' hit flags): K each, or in any-hit mode
    up to the first hit of a retiring ray (where a walk stops)."""
    tests = torch.full_like(rays, leaf_size)
    if not find_closest and bool(better.any()):
        rb = rays[better]
        tests[better] = 1 + first_hit_slot(tris, start[better], leaf_size,
                                           o[rb], d[rb], t_min, t[rb])
    return tests


class ActiveRays:
    """The two-level plain walks' rays: the world rays (ow, dw) of a
    batch's seven planes and the active-space rays (world, or the current
    instance's object space) with their slab-test terms."""

    def __init__(self, planes):
        ox, oy, oz, dx, dy, dz, _ = planes
        self.ow = torch.stack([ox, oy, oz], dim=1)
        self.dw = torch.stack([dx, dy, dz], dim=1)
        self.o, self.d = self.ow.clone(), self.dw.clone()
        self.inv = safe_inv_dir(self.d)
        self.oi = self.o * self.inv

    def enter(self, r, tf_rows):
        """Rays `r` into object space by their instances' 3x4 rows."""
        self.o[r], self.d[r] = to_object_space(tf_rows, self.ow[r],
                                               self.dw[r])
        self.inv[r] = safe_inv_dir(self.d[r])
        self.oi[r] = self.o[r] * self.inv[r]

    def leave(self, r):
        """Rays `r` back to world space."""
        self.o[r], self.d[r] = self.ow[r], self.dw[r]
        self.inv[r] = safe_inv_dir(self.dw[r])
        self.oi[r] = self.o[r] * self.inv[r]


class RayStacks:
    """Per-ray stacks of (int64 entry, float32 entry distance) for the
    plain nearest-first walks, grown on demand."""

    def __init__(self, n: int, device):
        self.e = torch.zeros((n, 16), dtype=torch.int64, device=device)
        self.t = torch.zeros((n, 16), device=device)
        self.sp = torch.zeros(n, dtype=torch.int64, device=device)

    def push(self, rows, entries, t_near):
        """Push one entry on each of `rows` (distinct rays)."""
        if rows.numel() == 0:
            return
        if int(self.sp[rows].max()) >= self.e.shape[1]:
            self.e = torch.cat([self.e, torch.zeros_like(self.e)], dim=1)
            self.t = torch.cat([self.t, torch.zeros_like(self.t)], dim=1)
        s = self.sp[rows]
        self.e[rows, s] = entries
        self.t[rows, s] = t_near
        self.sp[rows] = s + 1

    def pop(self):
        """(rays, entries, entry distances) of every ray with an entry,
        each popping its top one."""
        live = torch.nonzero(self.sp > 0).squeeze(1)
        s = self.sp[live] - 1
        self.sp[live] = s
        return live, self.e[live, s], self.t[live, s]


def to_object_space(m, ow, dw):
    """World rays (m, 3) into object space by 3x4 rows m (m, 12): the
    affine map of the origin and the linear one of the direction, term
    for term as the JAX two-level kernels."""
    o = torch.stack([m[:, 4 * a] * ow[:, 0] + m[:, 4 * a + 1] * ow[:, 1]
                     + m[:, 4 * a + 2] * ow[:, 2] + m[:, 4 * a + 3]
                     for a in range(3)], dim=1)
    d = torch.stack([m[:, 4 * a] * dw[:, 0] + m[:, 4 * a + 1] * dw[:, 1]
                     + m[:, 4 * a + 2] * dw[:, 2] for a in range(3)], dim=1)
    return o, d


def closest_hit_bruteforce(ray_o, ray_d, tri_v0, tri_e1, tri_e2,
                           t_min=TMIN, t_max=INF, chunk: int = 512):
    """O(rays x tris) closest hit.  ray_o/ray_d (N, 3), tri_* (T, 3).
    Returns (t, tri (-1 = miss), u, v), each (N,)."""
    n = ray_o.shape[0]
    best_t = torch.broadcast_to(torch.as_tensor(
        t_max, dtype=torch.float32, device=ray_o.device), (n,)).clone()
    best_i = torch.full((n,), -1, dtype=torch.int32, device=ray_o.device)
    best_u = torch.zeros(n, device=ray_o.device)
    best_v = torch.zeros(n, device=ray_o.device)
    for base in range(0, tri_v0.shape[0], chunk):
        sl = slice(base, base + chunk)
        hit, t, u, v = moller_trumbore(
            ray_o[:, None], ray_d[:, None], tri_v0[None, sl],
            tri_e1[None, sl], tri_e2[None, sl], t_min, best_t[:, None])
        t = torch.where(hit, t, INF)
        tj, j = torch.min(t, dim=1)
        improved = tj < best_t
        take = lambda a: torch.gather(a, 1, j[:, None])[:, 0]
        best_i = torch.where(improved, (base + j).to(torch.int32), best_i)
        best_u = torch.where(improved, take(u), best_u)
        best_v = torch.where(improved, take(v), best_v)
        best_t = torch.where(improved, tj, best_t)
    return best_t, best_i, best_u, best_v


def any_hit_bruteforce(ray_o, ray_d, tri_v0, tri_e1, tri_e2,
                       t_min=TMIN, t_max=INF, chunk: int = 512):
    """Occlusion: True where any triangle blocks (t_min, t_max)."""
    n = ray_o.shape[0]
    t_max = torch.broadcast_to(torch.as_tensor(
        t_max, dtype=torch.float32, device=ray_o.device), (n,))
    occluded = torch.zeros(n, dtype=torch.bool, device=ray_o.device)
    for base in range(0, tri_v0.shape[0], chunk):
        sl = slice(base, base + chunk)
        hit, _, _, _ = moller_trumbore(
            ray_o[:, None], ray_d[:, None], tri_v0[None, sl],
            tri_e1[None, sl], tri_e2[None, sl], t_min, t_max[:, None])
        occluded |= hit.any(dim=1)
    return occluded
