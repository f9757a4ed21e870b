"""Scene-sharded tracing: the triangle pool split across ranks
(hrt_tpu/parallel/scene_shard.py).

The pool splits into D contiguous shards of T / D triangles.  Each shard
gets an LBVH of its own (ops/lbvh.build_bvh); rank r walks every ray
against shard r with the skip-link walk K3, and the per-ray closest hits
are combined by an all-gather and an argmin over the shards (closest
hit is a min-reduction, so any split of the pool gives the same hit).
Only (t, tri, u, v) leave a shard: shading reads the whole scene's
tables by the global ids.

`shard_closest_hit` and `combine_hits` are the two halves of a rank's
work; one process can run every shard's half and combine them, which is
how the tests and the smoke run stand in for D ranks on one device.

JAX's `closest_hit_sharded` is a jitted program; here it replays from
`SHARD_PROGRAMS`, a CUDA graph of the shard's K3 walk, the four
all-gathers and the combine over NCCL (graphs.py), and runs op by op
over gloo, which stages its collectives through the host.
`build_sharded_accel` is load-time work, as the accel's first LBVH build
is, and runs op by op.
"""
from __future__ import annotations

import torch

from .. import graphs
from ..models.scene import SceneData
from ..ops import lbvh, traversal
from ..ops.v3 import V3
from .tiles import gather_rows

# The triangle fields that shard; the tables stay whole.
TRI_FIELDS = ("tri_v0", "tri_e1", "tri_e2", "nrm0", "nrm1", "nrm2", "uv0",
              "uv1", "uv2", "tri_mat", "tri_inst", "tri_valid")
_MISS_T = 1e32
# closest_hit_sharded's captured programs.
SHARD_PROGRAMS = graphs.Programs(4)


def shard_scene_triangles(scene: SceneData, n_shards: int) -> SceneData:
    """The scene with each triangle field split into n contiguous shards,
    a leading shard axis (n, T / n, ...); the tables stay whole.
    ValueError unless the pool divides into n_shards * 128."""
    t = scene.num_triangles
    if t % (n_shards * 128):
        raise ValueError("triangle pool must divide into n_shards*128")
    return scene._replace(**{
        f: getattr(scene, f).reshape((n_shards, t // n_shards)
                                     + getattr(scene, f).shape[1:])
        for f in TRI_FIELDS})


def build_sharded_accel(scene: SceneData, n_shards: int,
                        leaf_size: int = 16):
    """(sharded scene, [one LBVH accel per shard]) on the scene's
    device.  Each accel is built from its shard's triangle fields, so
    its triangle ids are local to the shard."""
    sharded = shard_scene_triangles(scene, n_shards)
    return sharded, [
        lbvh.build_bvh(sharded._replace(**{f: getattr(sharded, f)[s]
                                           for f in TRI_FIELDS}), leaf_size)
        for s in range(n_shards)]


def shard_closest_hit(shard_accel, o: torch.Tensor, d: torch.Tensor,
                      shard_id: int, t_per: int, t_min: float = 1e-3):
    """Closest hits of rays o, d (N, 3) against one shard, by K3: (t,
    global tri, u, v), the global id being the shard's id + shard_id *
    t_per, -1 on a miss."""
    t, tri, u, v = traversal.closest_hit_bvh_p(
        None, shard_accel, V3(*o.unbind(-1)), V3(*d.unbind(-1)), t_min,
        _MISS_T)
    return t, torch.where(tri >= 0, tri + shard_id * t_per, -1), u, v


def combine_hits(t: torch.Tensor, tri: torch.Tensor, u: torch.Tensor,
                 v: torch.Tensor):
    """The closest of D shards' hits, from (D, N) stacks: the first shard
    whose t is least among those that hit (shard 0's values where none
    did)."""
    best = torch.argmin(torch.where(tri >= 0, t, _MISS_T), dim=0)[None]
    return tuple(torch.take_along_dim(a, best, 0)[0] for a in (t, tri, u, v))


def closest_hit_sharded(sharded_scene: SceneData, accels, o, d, mesh,
                        leaf_size: int = 16, t_min: float = 1e-3):
    """Closest hit across every shard: rank r walks accels[r], then the
    ranks all-gather the four arrays and combine them.  o, d: (N, 3),
    the same on every rank.  `leaf_size` is the JAX signature's; each
    accel carries its own.  Returns (t, global tri, u, v) on every
    rank.  Over NCCL it replays the graph of the mesh, t_min, the shard
    size, accels[r] and the ray shapes (SHARD_PROGRAMS), the rays copied
    in; over gloo it runs op by op."""
    del leaf_size
    rank, group = mesh.get_local_rank(), mesh.get_group()
    accel, t_per = accels[rank], sharded_scene.tri_v0.shape[1]

    def body(o, d):
        hits = shard_closest_hit(accel, o, d, rank, t_per, t_min)
        n = o.shape[0]
        return combine_hits(*(gather_rows(h, group).reshape(-1, n)
                              for h in hits))

    key = ("closest_hit_sharded", graphs.signature(mesh), t_min, t_per,
           graphs.signature(accel))
    return SHARD_PROGRAMS(key, body, (o, d), o.device, group=group)


def unshard_tri_attr(sharded_scene: SceneData, name: str) -> torch.Tensor:
    """A sharded triangle field flattened back to (T, ...), which global
    triangle ids index."""
    x = getattr(sharded_scene, name)
    return x.reshape((-1,) + tuple(x.shape[2:]))
