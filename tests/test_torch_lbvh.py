"""The LBVH, the skip-link table and the skip-link walk K3 of hrt_tpu_torch
against the JAX package, on the CPU: Morton codes, `build_bvh` (with and
without a culling mask) and `flatten_bvh` bit for bit, and K3's plain
version against JAX's K3 (`traversal_pallas._trace_tiles`, which the JAX
package runs here in interpret mode for every accel) on an LBVH and on a
SAH tree past a lowered MAX_WIDE_NODES.  The CUDA kernel is held against
the plain walk on a card in test_torch_cuda.py."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hrt_tpu.ops import lbvh as jlbvh, morton as jmorton
from hrt_tpu.ops import traversal_pallas as tp, wide8 as jwide8
from hrt_tpu_torch.ops import (lbvh, morton, traversal, traversal_skip,
                               traversal_wide8, wide8)
from hrt_tpu_torch.ops.v3 import V3

from test_fuzz import random_rays
from test_torch_build import scene_pair


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _planes(o, d, tmax):
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32))
    return (t(o[:, 0]), t(o[:, 1]), t(o[:, 2]), t(d[:, 0]), t(d[:, 1]),
            t(d[:, 2]), t(tmax))


@pytest.fixture(scope="module")
def scenes():
    """(JAX SceneData, port SceneData): 1500 random triangles."""
    return scene_pair("rand0")


def _mask(n, seed):
    return np.random.RandomState(seed).rand(n) < 0.6


def test_morton_codes_bit_equal():
    """The torch codes and the host numpy codes against JAX's, with
    points on the bounds, duplicates and points outside them (clamped)."""
    rs = np.random.RandomState(9)
    pts = rs.uniform(-3, 7, (500, 3)).astype(np.float32)
    pts[:3] = [[-3, -3, -3], [7, 7, 7], [2, 2, 2]]
    pts[3] = pts[2]
    lo = np.float32([-2.5, -3.0, -1.0])
    hi = np.float32([6.0, 7.0, 5.5])
    want = np.asarray(jmorton.morton_codes(
        jnp.asarray(pts), jnp.asarray(lo), jnp.asarray(hi)))
    got = morton.morton_codes_torch(torch.as_tensor(pts),
                                    torch.as_tensor(lo),
                                    torch.as_tensor(hi))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(morton.morton_codes(pts, lo, hi), want)


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("leaf", [8, 32])
def test_build_bvh_bit_equal(scenes, leaf, masked):
    js, ts = scenes
    n = ts.tri_v0.shape[0]
    mask = _mask(n, leaf) if masked else None
    ja = jlbvh.build_bvh(js, leaf_size=leaf,
                         tri_mask=None if mask is None else jnp.asarray(mask))
    tmask = None if mask is None else torch.as_tensor(mask)
    tree = lbvh.lbvh_tree(ts, leaf, tmask)
    ta = lbvh.build_bvh(ts, leaf, tmask)
    for f in ja.tree._fields:
        a, b = np.asarray(getattr(ja.tree, f)), tree[f].numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, f
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=f)
    for f in ("tri_v0", "tri_e1", "tri_e2", "tri_perm"):
        assert torch.equal(getattr(ta, f), tree[f]), f
    np.testing.assert_array_equal(_bits(ja.attr), _bits(ta.attr.numpy()))
    np.testing.assert_array_equal(_bits(ja.flat.nodes),
                                  _bits(ta.nodes.numpy()))
    assert ta.m_real == 2 * (n // leaf) - 1 and ta.w8 is None
    # Culled and padding triangles carry the past-the-end key and keep
    # their pool order behind the others (the stable sort).
    valid = np.asarray(js.tri_valid) > 0.5
    if mask is not None:
        valid &= mask
    codes = tree["codes"].numpy()
    assert (codes[valid.sum():] == 0xFFFFFFFF).all()
    np.testing.assert_array_equal(tree["tri_perm"].numpy()[valid.sum():],
                                  np.nonzero(~valid)[0])


@pytest.mark.parametrize("bound", ["within", "past"])
def test_flatten_bit_equal_for_sah(scenes, monkeypatch, bound):
    """The SAH accel's skip-link table: of the reordered tree (with the
    builder's leaf boxes, reordered) within MAX_WIDE_NODES, of the
    un-reordered tree past a lowered bound, where neither package
    attaches a BVH8 table."""
    if bound == "past":
        monkeypatch.setattr(wide8, "MAX_WIDE_NODES", 4)
        monkeypatch.setattr(jwide8, "MAX_WIDE_NODES", 4)
    js, ts = scenes
    ja = jlbvh.build_bvh_sah(js, leaf_size=8)
    ta = lbvh.build_bvh_sah(ts, leaf_size=8)
    assert (ja.w8 is None) == (ta.w8 is None) == (bound == "past")
    np.testing.assert_array_equal(_bits(ja.flat.nodes),
                                  _bits(ta.nodes.numpy()))
    assert ta.m_real == 2 * (ja.tree.child_l.shape[0] + 1) - 1
    for f in ("tri_v0", "tri_e1", "tri_e2", "tri_perm"):
        np.testing.assert_array_equal(_bits(getattr(ja.tree, f)),
                                      _bits(getattr(ta, f).numpy()), f)
    np.testing.assert_array_equal(_bits(ja.attr), _bits(ta.attr.numpy()))


@pytest.fixture(scope="module")
def k3_accels(scenes):
    """(JAX accel, port accel) pairs without a BVH8 table: the LBVH of a
    culling mask, and the SAH tree past a lowered MAX_WIDE_NODES."""
    js, ts = scenes
    mask = _mask(ts.tri_v0.shape[0], 4)
    pairs = {"lbvh": (
        jlbvh.build_bvh(js, leaf_size=8, tri_mask=jnp.asarray(mask)),
        lbvh.build_bvh(ts, 8, torch.as_tensor(mask)))}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(wide8, "MAX_WIDE_NODES", 4)
        mp.setattr(jwide8, "MAX_WIDE_NODES", 4)
        pairs["sah_past_bound"] = (jlbvh.build_bvh_sah(js, leaf_size=8),
                                   lbvh.build_bvh_sah(ts, leaf_size=8))
    return pairs


def _rays_and_tmax(seed, reach):
    o, d = random_rays(seed, n=256)
    tmax = np.full(256, reach, np.float32)
    tmax[::17] = -1.0                               # dead rays
    return o, d, tmax


@pytest.mark.parametrize("which", ["lbvh", "sah_past_bound"])
def test_k3_plain_closest_matches_jax(k3_accels, which):
    ja, ta = k3_accels[which]
    o, d, tmax = _rays_and_tmax(5, 1e32)
    jt, jtri, ju, jv = [np.asarray(a) for a in tp.closest_hit(
        None, ja, jnp.asarray(o), jnp.asarray(d), 1e-3, jnp.asarray(tmax),
        sorted_ids=True)]
    assert traversal._walk(ta, False) is traversal_skip.trace
    t, tri, u, v = [a.numpy() for a in traversal_skip.trace_plain(
        ta, *_planes(o, d, tmax), 1e-3, True)]
    same = tri == jtri
    # Ids may differ only where two triangles give the same t.
    tie = ~same & (tri >= 0) & (jtri >= 0) & np.isclose(t, jt, rtol=1e-6)
    assert (same | tie).all()
    assert same.mean() >= 0.99 and (tri >= 0).mean() > 0.3
    # rtol 1e-5, and atol 1e-5 for barycentrics near 0 (the tolerance of
    # the K1 parity test, test_torch_traversal.py).
    for a, b in ((t, jt), (u, ju), (v, jv)):
        np.testing.assert_allclose(a[same], b[same], rtol=1e-5, atol=1e-5)
    assert (tri[::17] == -1).all() and (t[::17] == -1.0).all()


@pytest.mark.parametrize("which", ["lbvh", "sah_past_bound"])
def test_k3_plain_any_hit_matches_jax(k3_accels, which):
    ja, ta = k3_accels[which]
    o, d, tmax = _rays_and_tmax(6, 5.0)
    want = np.asarray(tp.any_hit(None, ja, jnp.asarray(o), jnp.asarray(d),
                                 1e-3, jnp.asarray(tmax)))
    p = _planes(o, d, tmax)
    got = traversal.any_hit_bvh_p(None, ta, V3(*p[0:3]), V3(*p[3:6]), 1e-3,
                                  p[6]).numpy()
    assert 0.05 < want.mean() < 0.95
    np.testing.assert_array_equal(got, want)
    assert not got[::17].any()


def test_walk_routes_by_table_and_device(scenes, k3_accels):
    """An Accel with a BVH8 table takes K1, one without takes K3; a CPU
    tensor runs the plain version (no launch), another device raises."""
    _, ts = scenes
    assert traversal._walk(lbvh.build_bvh_sah(ts, leaf_size=8),
                           False) is traversal_wide8.trace
    _, ta = k3_accels["lbvh"]
    assert traversal._walk(ta, True) is traversal_skip.trace_plain
    o, d = random_rays(2, n=64)
    planes = _planes(o, d, np.full(64, 1e32))
    before = dict(traversal_skip.LAUNCHES)
    got = traversal_skip.trace(ta, *planes, 1e-3, True)
    want = traversal_skip.trace_plain(ta, *planes, 1e-3, True)
    assert traversal_skip.LAUNCHES == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        traversal_skip.trace(ta, *[p.to("meta") for p in planes], 1e-3,
                             True)
