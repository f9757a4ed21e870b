"""The pieces of K1's and K2's card designs, on the CPU: K1's 256-byte
wide-node records `Accel.w8_rec` against the words of the (R, 8, 128)
table they repack (the SAH build, an accel carried over from the JAX
package, `make_accel` on CPU tensors) and the stack bound they are
walked with; K1's counting walk `traversal_wide8.visit_counts` against
walks written ray by ray, in both modes and both orders, with its hits
against trace_plain; and K2's argument block (`shade_kernel.pack_args`),
which hands the kernel each plane where it lies, read back through its
pointers and element strides on the frame's own strided material
planes.  The kernels themselves are held to the plain versions on a
card in test_torch_cuda.py."""
import ctypes
import types

import numpy as np
import pytest
import torch

from hrt_tpu.ops import lbvh as jlbvh
from hrt_tpu_torch import renderer
from hrt_tpu_torch.config import RenderConfig
from hrt_tpu_torch.models.camera import Camera
from hrt_tpu_torch.models.scene import bench_scene
from hrt_tpu_torch.ops import lbvh, shade_kernel, traversal_wide8
from hrt_tpu_torch.utils.interop import accel_from_numpy

from test_torch_build import jax_accel_dict, scene_pair
from test_torch_twolevel_redesign import (T_MIN, _batch, _k4_nearest,
                                          _k4_table_order, _Ray)

BENCH_CAM = dict(position=(0.0, -1.0, -6.0), rotation=(-0.15, 0.0, 0.0))


@pytest.fixture(scope="module")
def accels():
    """The bench scene's SAH accel with 8-triangle leaves (a deeper tree
    than the frame's 32), the same accel assembled again by make_accel
    from its CPU tensors, and the JAX package's accel of the bench scene
    carried over through interop."""
    js, ts = scene_pair("bench")
    built = lbvh.build_bvh_sah(ts, leaf_size=8)
    again = lbvh.make_accel(built.tri_v0, built.tri_e1, built.tri_e2,
                            built.tri_perm, built.attr, built.nodes,
                            built.m_real, built.leaf_size, w8=built.w8)
    ja = jlbvh.build_bvh_sah(js, leaf_size=32)
    interop = accel_from_numpy(jax_accel_dict(ja), 32, "cpu")
    return {"sah": built, "make_accel": again, "interop": interop}


@pytest.mark.parametrize("source", ["sah", "make_accel", "interop"])
def test_records_repack_the_table(accels, source):
    """Row q of w8_rec is wide node q's 8 child records of the (R, 8,
    128) table, child j at words 8j..8j+7: bit for bit, contiguous,
    int32, for every row's node; the depth and stack bound follow the
    table."""
    a = accels[source]
    r = a.w8.shape[0]
    flat = a.w8.reshape(-1)
    q = torch.arange(r * 16)[:, None, None]
    j = torch.arange(8)[None, :, None]
    w = torch.arange(8)[None, None, :]
    want = flat[(q // 16) * 1024 + j * 128 + (q % 16) * 8 + w] \
        .reshape(r * 16, 64)
    assert a.w8_rec.dtype == torch.int32 and a.w8_rec.is_contiguous()
    assert torch.equal(a.w8_rec, want)
    assert a.w8_depth >= 1
    assert traversal_wide8.stack_entries(a.w8_depth) \
        <= traversal_wide8.MAX_STACK
    if source == "make_accel":
        assert torch.equal(a.w8_rec, accels["sah"].w8_rec)


def test_stack_bound_takes_every_tree_the_first_kernel_took():
    """The first kernel took trees of up to 32 wide levels (depth 31);
    the nearest-first walk's bound of 7 entries per level plus one
    still takes all of them and nothing deeper."""
    se = traversal_wide8.stack_entries
    assert se(31) <= traversal_wide8.MAX_STACK < se(32)
    assert [se(d) for d in range(3)] == [8, 15, 22]


def _no_tlas(a):
    """A single-level accel as the two-level walks written ray by ray
    read it: wide nodes all below no TLAS region."""
    return types.SimpleNamespace(w8_rec=a.w8_rec, w8_tlas_nw=0, tris=a.tris,
                                 leaf_size=a.leaf_size)


@pytest.mark.parametrize("nearest", [False, True], ids=["table", "nearest"])
@pytest.mark.parametrize("closest", [True, False], ids=["closest", "any"])
def test_visit_counts_match_a_walk_ray_by_ray(accels, closest, nearest):
    """Every count of every ray, and the hits, as one ray's walk in the
    same order gives them; the table order's hits equal trace_plain's
    and the nearest-first walk's closest hits equal them up to equal-t
    ties."""
    a = accels["sah"]
    planes = _batch(closest)
    got = traversal_wide8.visit_counts(a, *planes, T_MIN, closest,
                                       nearest=nearest)
    hits = got.pop("hits")
    assert set(got) == set(traversal_wide8.COUNTS)
    walk = _k4_nearest if nearest else _k4_table_order
    rays = []
    for i in range(planes[0].shape[0]):
        ray = _Ray(torch.stack([p[i] for p in planes[:3]]),
                   torch.stack([p[i] for p in planes[3:6]]),
                   float(planes[6][i]), closest)
        if planes[6][i] >= 0:
            walk(_no_tlas(a), ray)
        rays.append(ray)
    for key, theirs in (("nodes", "blas_nodes"), ("boxes", "blas_boxes"),
                        ("leaves", "leaves"), ("tests", "tests")):
        assert got[key].dtype == torch.int64
        np.testing.assert_array_equal(got[key].numpy(),
                                      [r.c[theirs] for r in rays], key)
    assert all(r.c["instances"] == r.c["tlas_nodes"] == 0 for r in rays)
    assert (got["nodes"][::7] == 0).all() and got["leaves"].sum() > 5
    ref = traversal_wide8.trace_plain(a, *planes, T_MIN, closest)
    if closest:
        t, tri = hits[0], hits[1]
        assert len(hits) == 4
        assert tri.tolist() == [r.hit[0] for r in rays]
        torch.testing.assert_close(t, torch.stack([r.t for r in rays]),
                                   rtol=0, atol=0)
        if nearest:
            tie = torch.isclose(t, ref[0], rtol=1e-6, atol=0)
            assert bool(((tri == ref[1]) | tie).all())
            assert bool((t == ref[0]).all())
        else:
            for x, y in zip(hits, ref):
                assert torch.equal(x, y)
        assert (tri >= 0).float().mean() > 0.2
    else:
        assert hits.tolist() == [r.hit[0] >= 0 for r in rays]
        assert torch.equal(hits, ref)
        assert 0.05 < hits.float().mean() < 0.95


@pytest.fixture(scope="module")
def frame_k2_args():
    """brdf_light_major's arguments as the bench frame at 64x48 makes
    them: the hits' material planes (strided rows of the attribute
    gather), normals and view directions, the light-major light
    directions and relevance, the light count."""
    cfg = RenderConfig(width=64, height=48, max_depth=1, sky=True)
    scene = bench_scene().build("cpu")
    accel = lbvh.build_bvh_sah(scene, leaf_size=32)
    cams = renderer.camera_arrays(Camera(**BENCH_CAM), cfg, "cpu")
    o, d = renderer.primary_rays(cams, cfg.height, 0, cfg)
    sh = renderer.surface_hits(scene, accel, o, d, cfg)
    lb = renderer.light_batch(scene, sh.normal, sh.world_pos, cfg,
                              ray_mask=sh.hit)
    return (sh.mat, sh.normal, sh.view, lb.l, lb.relevant,
            scene.lights.shape[0])


def _read(ptr: int, stride: int, i: int, ctype=ctypes.c_float):
    """Element i of a plane given as (address, element stride), read the
    way the kernel reads it."""
    return ctype.from_address(ptr + i * stride * ctypes.sizeof(ctype)).value


def test_brdf_args_hand_over_the_planes_in_place(frame_k2_args):
    """pack_args gives every plane's own storage and element stride (the
    material planes stay strided rows, nothing is copied), and reading
    through them gives back every plane and relevance byte."""
    mat, nrm, view, l_lm, rel, nl = frame_k2_args
    n = nrm.x.shape[0]
    out = torch.empty((3, nl * n))
    args = shade_kernel.pack_args(*frame_k2_args, out)
    planes = shade_kernel._shared_planes(mat, nrm, view) \
        + (l_lm.x, l_lm.y, l_lm.z)
    assert mat.color.x.stride(0) > 1 and args.stride[0] == \
        mat.color.x.stride(0)
    assert (args.n, args.num_lights, args.out) == (n, nl, out.data_ptr())
    idx = np.random.RandomState(5).randint(0, n, 64)
    for k, p in enumerate(planes):
        assert args.plane[k] == p.data_ptr() and args.stride[k] == \
            p.stride(0)
        rows = idx if k < 18 else idx + n * (k % 2)
        got = [_read(args.plane[k], args.stride[k], int(i)) for i in rows]
        np.testing.assert_array_equal(np.float32(got), p[rows].numpy())
    got = [_read(args.relevant, args.relevant_stride, int(i),
                 ctypes.c_bool) for i in range(nl * n)]
    assert got == rel.tolist() and 0.1 < np.mean(got) < 0.9


@pytest.mark.parametrize("fault", ["dtype", "length", "stride", "device",
                                   "relevant", "out"])
def test_brdf_args_refuse_what_the_kernel_cannot_read(frame_k2_args, fault):
    """A wrong dtype, length, stride or device raises ValueError; nothing
    is converted or copied in its place."""
    mat, nrm, view, l_lm, rel, nl = frame_k2_args
    n = nrm.x.shape[0]
    out = torch.empty((3, nl * n))
    if fault == "dtype":
        nrm = nrm.map(lambda a: a.double())
    elif fault == "length":
        view = view.map(lambda a: a[:-1])
    elif fault == "stride":
        mat = mat._replace(metallic=torch.zeros(1).expand(n))
    elif fault == "device":
        l_lm = l_lm.map(lambda a: torch.empty(a.shape, device="meta"))
    elif fault == "relevant":
        rel = rel.to(torch.uint8)
    else:
        out = torch.empty((nl * n, 3)).T
    with pytest.raises(ValueError, match="brdf_light_major"):
        shade_kernel.pack_args(mat, nrm, view, l_lm, rel, nl, out)
