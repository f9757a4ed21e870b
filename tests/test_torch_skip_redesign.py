"""The pieces of K3's card design, on the CPU: the 32-byte node records
(`traversal_skip.skip_records`, cached on every Accel as `skip_rec`)
against the skip-link table they repack, for the port's LBVH, a SAH tree
past a lowered MAX_WIDE_NODES and the JAX package's own LBVH carried over
through interop; the counting walk `visit_counts` against a walk written
ray by ray; and the plain mirror of the kernel's division-free triangle
test against Möller-Trumbore, the port's and the JAX package's.  The
kernel itself is held to the plain walk on a card in test_torch_cuda.py.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hrt_tpu.ops import intersect as jintersect, lbvh as jlbvh
from hrt_tpu_torch.ops import intersect, lbvh, traversal_skip, wide8
from hrt_tpu_torch.utils.interop import accel_from_numpy

from test_fuzz import random_rays
from test_torch_build import jax_accel_dict, scene_pair


@pytest.fixture(scope="module")
def accels():
    """Accels without a BVH8 table over 1500 random triangles: the port's
    LBVH of a culling mask (leaf 8), the SAH tree past a lowered bound
    (leaf 8), and the JAX LBVH (leaf 32) through interop."""
    js, ts = scene_pair("rand0")
    mask = np.random.RandomState(4).rand(ts.tri_v0.shape[0]) < 0.6
    out = {"lbvh": lbvh.build_bvh(ts, 8, torch.as_tensor(mask))}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(wide8, "MAX_WIDE_NODES", 4)
        out["sah_past_bound"] = lbvh.build_bvh_sah(ts, leaf_size=8)
    ja = jlbvh.build_bvh(js, leaf_size=32)
    out["jax_lbvh"] = accel_from_numpy(jax_accel_dict(ja), 32, "cpu")
    return out


@pytest.mark.parametrize("which", ["lbvh", "sah_past_bound", "jax_lbvh"])
def test_skip_records_repack_the_table(accels, which):
    """Row i of the records is node i's 8 words of the (Mp/128, 8, 128)
    table, bit for bit, for every node and no padding node."""
    acc = accels[which]
    assert acc.w8 is None
    rec = acc.skip_rec
    assert rec.dtype == torch.int32 and rec.shape == (acc.m_real, 8)
    assert rec.is_contiguous() and rec.device == acc.nodes.device
    want = traversal_skip.node_words(acc.nodes, torch.arange(acc.m_real))
    assert torch.equal(rec, want)
    assert torch.equal(traversal_skip.skip_records(acc.nodes, acc.m_real),
                       rec)
    # The last node's skip leaves the table; the root's box is node 0's.
    assert int(rec[-1, 7]) == acc.m_real
    assert torch.equal(rec[0, :6].view(torch.float32),
                       acc.nodes[0, :6, 0])


def _walk_one(acc, o, d, t_max, t_min, closest):
    """One ray's skip-link walk in scalar steps: (nodes, leaves, tests)."""
    o, d = torch.as_tensor(o)[None], torch.as_tensor(d)[None]
    inv = intersect.safe_inv_dir(d)
    oi = o * inv
    t = torch.tensor([t_max], dtype=torch.float32)
    nodes = leaves = tests = 0
    if t_max < 0:
        return 0, 0, 0
    cur = 0
    while cur < acc.m_real:
        w = traversal_skip.node_words(acc.nodes, torch.tensor([cur]))[0]
        code, skip = int(w[6]), int(w[7])
        nodes += 1
        hit = bool(intersect.slab_hit(w[None, :6].view(torch.float32), inv,
                                      oi, t_min, t)[0])
        if hit and code == 0:
            cur += 1
            continue
        if hit:
            leaves += 1
            for k in range(acc.leaf_size):
                tri = acc.tris[code - 1 + k]
                tests += 1
                h, th, _, _ = intersect.moller_trumbore(
                    o[0], d[0], tri[0:3], tri[3:6], tri[6:9], t_min, t[0])
                if bool(h):
                    if not closest:
                        return nodes, leaves, tests
                    t = th[None]
        cur = skip
    return nodes, leaves, tests


@pytest.mark.parametrize("closest", [True, False], ids=["closest", "any"])
@pytest.mark.parametrize("which", ["lbvh", "sah_past_bound"])
def test_visit_counts_match_a_walk_ray_by_ray(accels, which, closest):
    acc = accels[which]
    o, d = random_rays(12, n=64)
    tmax = np.full(64, 1e32 if closest else 5.0, np.float32)
    tmax[::9] = -1.0                                   # dead rays
    planes = [torch.as_tensor(np.ascontiguousarray(a, np.float32))
              for a in (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1],
                        d[:, 2], tmax)]
    got = traversal_skip.visit_counts(acc, *planes, 1e-3, closest)
    assert set(got) == {"nodes", "leaves", "tests"}
    want = np.array([_walk_one(acc, o[i], d[i], float(tmax[i]), 1e-3,
                               closest) for i in range(64)])
    for j, key in enumerate(("nodes", "leaves", "tests")):
        assert got[key].dtype == torch.int64
        np.testing.assert_array_equal(got[key].numpy(), want[:, j], key)
    assert (want[::9] == 0).all() and want[:, 1].sum() > 64
    if closest:
        assert (want[:, 2] == acc.leaf_size * want[:, 1]).all()
    else:
        # Some rays stop inside their last leaf.
        assert (want[:, 2] < acc.leaf_size * want[:, 1]).any()


def _pairs(seed, n):
    """n ray/triangle pairs: rays aimed near the triangle (a third past
    its edges), both windings, some nearly edge-on, a few degenerate
    triangles, and a live t that cuts some hits off."""
    rs = np.random.RandomState(seed)
    v0 = rs.uniform(-2, 2, (n, 3))
    e1 = rs.uniform(-1, 1, (n, 3))
    e2 = rs.uniform(-1, 1, (n, 3))
    e2[: n // 20] = 2.0 * e1[: n // 20]                # degenerate
    b = rs.uniform(-0.3, 1.0, (n, 2))
    target = v0 + b[:, :1] * e1 + b[:, 1:] * e2
    o = target + rs.uniform(-4, 4, (n, 3))
    d = target - o
    d[n // 10: n // 5] = np.cross(e1, e2)[n // 10: n // 5] * 1e-3 \
        + np.cross(np.cross(e1, e2), e1)[n // 10: n // 5]   # edge-on
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_live = rs.uniform(1.0, 8.0, n)
    t_live[::4] = 1e32
    f = lambda a: a.astype(np.float32)
    return f(o), f(d), f(v0), f(e1), f(e2), f(t_live)


def test_division_free_test_matches_moller_trumbore():
    """On 20,000 seeded pairs: the accepted sets of the division-free
    test and of Möller-Trumbore (the port's and the JAX package's) are
    equal apart from pairs within 1e-6 of an edge, of t_min or of the
    live t; where both accept, t, u and v agree to rtol 1e-6 (with the
    JAX package's, to its K3 parity tolerance)."""
    o, d, v0, e1, e2, t_live = _pairs(7, 20000)
    args = [torch.as_tensor(a) for a in (o, d, v0, e1, e2)]
    t_min = 1e-3
    lim = torch.as_tensor(t_live)
    hit, t, u, v = traversal_skip.moller_scaled(*args, t_min, lim)
    mh, mt, mu, mv = intersect.moller_trumbore(*args, t_min, lim)
    jh, jt, ju, jv = [np.asarray(a) for a in jintersect.moller_trumbore(
        *[jnp.asarray(a) for a in (o, d, v0, e1, e2)], t_min,
        jnp.asarray(t_live))]
    # Distance to the boundary, from the products both tests compute.
    margin = torch.stack([mu, mv, 1 - mu - mv]).min(dim=0).values
    near = (margin.abs() <= 1e-6) | ((mt - t_min).abs() <= 1e-6 * t_min) \
        | ((mt - lim).abs() <= 1e-6 * lim)
    assert 0.1 < float(mh.float().mean()) < 0.8
    assert torch.equal(hit[~near], mh[~near])
    np.testing.assert_array_equal(jh[~near.numpy()], mh[~near].numpy())
    assert not (hit & ~mh).any()      # the scaled test never adds a hit
    both = hit & mh
    for a, b, c in ((t, mt, jt), (u, mu, ju), (v, mv, jv)):
        torch.testing.assert_close(a[both], b[both], rtol=1e-6, atol=0)
        # XLA contracts FMAs on the CPU: the K3 parity tolerance.
        np.testing.assert_allclose(a[both].numpy(), c[both.numpy()],
                                   rtol=1e-5, atol=1e-5)
    # Each comparison of the scaled test rejects some pair on its own.
    assert bool((mt[~mh] > lim[~mh]).any() & (mu[~mh] < 0).any())
