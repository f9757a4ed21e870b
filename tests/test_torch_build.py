"""hrt_tpu_torch acceleration structure vs the JAX package: the SAH build
plus BVH8 collapse must give the same record table, reordered triangle
pool, tri_perm and attribute table, bit for bit."""
import numpy as np
import pytest
import torch

import bench
from hrt_tpu.ops import lbvh as jlbvh, wide8 as jwide8
from hrt_tpu_torch.models.scene import bench_scene
from hrt_tpu_torch.ops import (lbvh, traversal, traversal_skip,
                               traversal_wide8, wide8)
from hrt_tpu_torch.utils.interop import accel_from_numpy, scene_from_numpy

from test_fuzz import random_scene_data
from test_torch_native import jax_native_lib


@pytest.fixture(scope="module", autouse=True)
def _jax_native_sah():
    """JAX's build_bvh_sah through its native builder, never the LBVH
    fallback (test_torch_native.jax_native_lib)."""
    jax_native_lib()


def jax_scene_dict(scene):
    return {k: np.asarray(v) for k, v in scene._asdict().items()
            if v is not None and k != "light_tree"}


def jax_accel_dict(accel):
    d = {k: np.asarray(v) for k, v in accel.tree._asdict().items()}
    d["attr"] = np.asarray(accel.attr)
    d["nodes"] = np.asarray(accel.flat.nodes)
    d["w8"] = None if accel.w8 is None else np.asarray(accel.w8)
    return d


def scene_pair(name):
    """(JAX SceneData, port SceneData on the CPU) for a test scene."""
    if name == "bench":
        return bench.build_bench_scene().build(), bench_scene().build("cpu")
    seed, n_tris = {"rand0": (0, 1500), "rand1": (1, 1500),
                    "rand2": (2, 600)}[name]
    data = random_scene_data(seed, n_tris=n_tris)[0]
    return data, scene_from_numpy(jax_scene_dict(data), "cpu")


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("name,leaf", [("bench", 32), ("rand0", 32),
                                       ("rand1", 32), ("rand2", 8)])
def test_sah_bvh8_build_bit_equal(name, leaf):
    js, ts = scene_pair(name)
    ja = jlbvh.build_bvh_sah(js, leaf_size=leaf)
    ta = lbvh.build_bvh_sah(ts, leaf_size=leaf)
    assert ja.w8 is not None and ja.w8_lb
    pairs = {"w8": (ja.w8, ta.w8), "tri_v0": (ja.tree.tri_v0, ta.tri_v0),
             "tri_e1": (ja.tree.tri_e1, ta.tri_e1),
             "tri_e2": (ja.tree.tri_e2, ta.tri_e2),
             "tri_perm": (ja.tree.tri_perm, ta.tri_perm),
             "attr": (ja.attr, ta.attr)}
    for key, (a, b) in pairs.items():
        b = b.numpy()
        assert a.shape == b.shape and np.asarray(a).dtype == b.dtype, key
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=key)
    assert ta.tris.shape == (ta.tri_v0.shape[0], 12)
    assert ta.w8_depth >= 1


def test_record_layout_invariants():
    """Slots are leaf-first, internal ranks are a 0..k-1 prefix, leaf
    children of a node are contiguous from leaf_base, and every wide
    node's internal children sit at base + rank."""
    _, ts = scene_pair("rand0")
    ta = lbvh.build_bvh_sah(ts, leaf_size=8)
    rec = ta.w8.numpy()
    r = rec.shape[0]
    v = rec.reshape(r, 8, 16, 8).transpose(0, 2, 1, 3).reshape(r * 16, 8, 8)
    meta, base, lb = v[:, :, 6], v[:, 0, 7], v[:, 1, 7] // 256
    for q in range(r * 16):
        cls = [0 if m > 0 else (1 if m < 0 else 2) for m in meta[q]]
        assert cls == sorted(cls)
        ranks = [-m - 1 for m in meta[q] if m < 0]
        assert ranks == list(range(len(ranks)))
        if ranks:
            assert 0 < base[q] < r * 16
        for j in range(8):
            if meta[q, j] > 0:
                assert meta[q, j] - 1 == lb[q] + j * 8


def test_accel_from_numpy_matches_build():
    """A JAX-built accel carried over through interop equals the port's
    own build (tables, walk triangle table and stack depth)."""
    js, ts = scene_pair("bench")
    ja = jlbvh.build_bvh_sah(js, leaf_size=32)
    ia = accel_from_numpy(jax_accel_dict(ja), 32, "cpu")
    ta = lbvh.build_bvh_sah(ts, leaf_size=32)
    assert ia.w8_depth == ta.w8_depth and ia.leaf_size == 32
    for f in ("w8", "tris", "tri_perm", "attr"):
        assert torch.equal(getattr(ia, f), getattr(ta, f)), f
    np.testing.assert_array_equal(ta.tris[:, 0:3].numpy(),
                                  ta.tri_v0.numpy())
    np.testing.assert_array_equal(ta.tris[:, 9:12].numpy(), 0.0)


def test_wide_node_bound_routes_to_k3(monkeypatch):
    """Past MAX_WIDE_NODES the SAH build attaches no BVH8 table, as the
    JAX package's, and keeps the un-reordered pool and its skip-link
    table; its walks take K3.  (Until the skip-link walk was ported the
    port raised here.)"""
    monkeypatch.setattr(wide8, "MAX_WIDE_NODES", 4)
    monkeypatch.setattr(jwide8, "MAX_WIDE_NODES", 4)
    js, ts = scene_pair("rand0")
    ja = jlbvh.build_bvh_sah(js, leaf_size=8)
    ta = lbvh.build_bvh_sah(ts, leaf_size=8)
    assert ja.w8 is None and ta.w8 is None and not ja.w8_lb
    np.testing.assert_array_equal(_bits(ja.flat.nodes), _bits(ta.nodes))
    np.testing.assert_array_equal(ja.tree.tri_perm, ta.tri_perm.numpy())
    assert traversal._walk(ta, False) is traversal_skip.trace
    ia = accel_from_numpy(jax_accel_dict(ja), 8, "cpu")
    assert ia.w8 is None and torch.equal(ia.nodes, ta.nodes)
    assert ia.m_real == ta.m_real


def test_stack_depth_bound_raises_at_build(monkeypatch):
    """A wide tree deeper than the walk's per-ray stack is refused when
    the accel is built, not during a trace."""
    _, ts = scene_pair("rand0")
    depth = lbvh.build_bvh_sah(ts, leaf_size=8).w8_depth
    monkeypatch.setattr(traversal_wide8, "MAX_STACK", depth)
    with pytest.raises(ValueError, match="stack"):
        lbvh.build_bvh_sah(ts, leaf_size=8)
