"""K1 (the BVH8 walk): the plain PyTorch version against the JAX wide8
kernel in interpret mode on the same accel (carried over through
interop), against the float64 oracle and against brute force (the CUDA
kernel is held against it on a card in test_torch_cuda.py)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hrt_tpu.ops import lbvh as jlbvh, traversal_pallas as tp
from hrt_tpu.utils import oracle
from hrt_tpu_torch.ops import intersect, lbvh, traversal, traversal_wide8
from hrt_tpu_torch.ops.v3 import V3
from hrt_tpu_torch.utils.interop import accel_from_numpy

from test_fuzz import random_scene_data, random_rays
from test_torch_build import jax_accel_dict, scene_pair


def _jax_wide8_accel(seed):
    """test_wide8's accel: LBVH, leaf 8, BVH8 records attached."""
    data, v0, e1, e2 = random_scene_data(seed, n_tris=220)
    accel = jlbvh.attach_wide8(jlbvh.build_bvh(data, leaf_size=8))
    return accel, v0, e1, e2


def _planes(o, d, tmax):
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32))
    return (t(o[:, 0]), t(o[:, 1]), t(o[:, 2]), t(d[:, 0]), t(d[:, 1]),
            t(d[:, 2]), t(tmax))


def _jax_wide8(monkeypatch, accel, o, d, tmax, closest):
    """The JAX wide8 kernel in interpret mode, walking 8-row (1024-ray)
    tiles: its compile on the CPU grows with the tile's rows (~70 s per
    mode at the default 64, ~10 s at 8)."""
    monkeypatch.setenv("HRT_WIDE8_CPU", "1")
    monkeypatch.setattr(tp, "WIDE8", True)
    assert tp.use_wide8(accel)
    with tp.walk_rows(8):
        if closest:
            return [np.asarray(a) for a in tp.closest_hit(
                None, accel, jnp.asarray(o), jnp.asarray(d), 1e-3,
                jnp.asarray(tmax), sorted_ids=True)]
        return np.asarray(tp.any_hit(None, accel, jnp.asarray(o),
                                     jnp.asarray(d), 1e-3,
                                     jnp.asarray(tmax)))


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_closest_matches_jax_wide8(seed, monkeypatch):
    ja, *_ = _jax_wide8_accel(seed)
    o, d = random_rays(seed, n=256)
    tmax = np.full(256, 1e32, np.float32)
    jt, jtri, ju, jv = _jax_wide8(monkeypatch, ja, o, d, tmax, True)
    acc = accel_from_numpy(jax_accel_dict(ja), ja.leaf_size, "cpu")
    t, tri, u, v = [a.numpy() for a in traversal_wide8.trace_plain(
        acc, *_planes(o, d, tmax), 1e-3, True)]
    same = tri == jtri
    # Ids may differ only where two triangles give the same t.
    tie = ~same & (tri >= 0) & (jtri >= 0) & np.isclose(t, jt, rtol=1e-6)
    assert (same | tie).all()
    assert same.mean() >= 0.99
    for a, b in ((t, jt), (u, ju), (v, jv)):
        np.testing.assert_allclose(a[same], b[same], rtol=1e-5, atol=1e-5)


def test_plain_anyhit_matches_jax_wide8(monkeypatch):
    ja, *_ = _jax_wide8_accel(2)
    o, d = random_rays(2, n=256)
    tmax = np.full(256, 5.0, np.float32)
    tmax[::17] = -1.0                               # dead rays
    jocc = _jax_wide8(monkeypatch, ja, o, d, tmax, False)
    acc = accel_from_numpy(jax_accel_dict(ja), ja.leaf_size, "cpu")
    occ = traversal_wide8.trace_plain(acc, *_planes(o, d, tmax), 1e-3,
                                      False).numpy()
    assert (occ == jocc).mean() >= 0.99
    assert not occ[::17].any()


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_closest_vs_oracle(seed):
    ja, v0, e1, e2 = _jax_wide8_accel(seed)
    acc = accel_from_numpy(jax_accel_dict(ja), ja.leaf_size, "cpu")
    o, d = random_rays(seed, n=256)
    ot, oi, _, _ = oracle.closest_hit(o, d, v0, e1, e2)
    t, tri, _, _ = traversal.closest_hit_bvh_p(
        None, acc, V3(*_planes(o, d, np.zeros(256))[0:3]),
        V3(*_planes(o, d, np.zeros(256))[3:6]), 1e-3, 1e32)
    tri = tri.numpy()
    assert ((tri >= 0) == (oi >= 0)).mean() > 0.99
    both = (tri >= 0) & (oi >= 0)
    np.testing.assert_allclose(t.numpy()[both], ot[both], rtol=1e-3,
                               atol=1e-3)


def test_plain_anyhit_vs_oracle():
    ja, v0, e1, e2 = _jax_wide8_accel(2)
    acc = accel_from_numpy(jax_accel_dict(ja), ja.leaf_size, "cpu")
    o, d = random_rays(2, n=256)
    tmax = np.full(256, 5.0, np.float32)
    occ_o = oracle.any_hit(o, d, v0, e1, e2, t_max=tmax)
    planes = _planes(o, d, tmax)
    occ = traversal.any_hit_bvh_p(None, acc, V3(*planes[0:3]),
                                  V3(*planes[3:6]), 1e-3, planes[6])
    assert (occ.numpy() == occ_o).mean() > 0.99


def test_plain_matches_bruteforce_on_bench_scene():
    """The port's own SAH/BVH8 build, walked by the plain version,
    against the port's brute force on the bench scene."""
    _, ts = scene_pair("bench")
    acc = lbvh.build_bvh_sah(ts, leaf_size=32)
    rs = np.random.RandomState(7)
    o = np.tile(np.array([[0.0, -1.0, -6.0]], np.float32), (512, 1))
    d = rs.normal(size=(512, 3)).astype(np.float32) * [0.3, 0.3, 1.0]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:, 2] = np.abs(d[:, 2])
    d = d.astype(np.float32)
    planes = _planes(o, d, np.full(512, 1e32))
    t, tri, _, _ = traversal.closest_hit_bvh_p(
        ts, acc, V3(*planes[0:3]), V3(*planes[3:6]), 1e-3, 1e32)
    bt, bi, _, _ = intersect.closest_hit_bruteforce(
        torch.as_tensor(o), torch.as_tensor(d), ts.tri_v0, ts.tri_e1,
        ts.tri_e2)
    assert (tri >= 0).float().mean() > 0.3
    assert (tri == bi).float().mean() > 0.99
    both = (tri >= 0) & (bi >= 0)
    np.testing.assert_allclose(t[both].numpy(), bt[both].numpy(),
                               rtol=1e-5, atol=1e-5)


def test_cpu_tensors_take_the_plain_version():
    ja, *_ = _jax_wide8_accel(0)
    acc = accel_from_numpy(jax_accel_dict(ja), ja.leaf_size, "cpu")
    o, d = random_rays(0, n=64)
    before = dict(traversal_wide8.LAUNCHES)
    traversal_wide8.trace(acc, *_planes(o, d, np.full(64, 1e32)), 1e-3,
                          True)
    assert traversal_wide8.LAUNCHES == before
