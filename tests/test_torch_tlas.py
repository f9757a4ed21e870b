"""The instanced (two-level) path of hrt_tpu_torch against the JAX
package, on the CPU: the two-level build on both routes (the unified
BVH8 table, and the binary skip-link tables past the wide bound) and
their TLAS refits bit for bit, with SAH and with LBVH (sah=False)
BLAS; the K4 and K5 plain walks against JAX's two-level walk (K5 in
interpret mode, as the JAX package's own tests run it here) on the
port's tables and on JAX-built ones; the two-level shading gather, and
the 64x48 two-level FrameLoop frame.  The scene is test_tlas's four
transformed instances; the JAX structures are built once per module.
The CUDA kernels are held against the plain walks on a card in
test_torch_cuda.py.
"""
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hrt_tpu.config import RenderConfig as JRenderConfig
from hrt_tpu.frameloop import FrameLoop as JFrameLoop
from hrt_tpu.models.camera import Camera as JCamera
from hrt_tpu.models.instance import MeshInstance as JMeshInstance
from hrt_tpu.ops import culling as jculling, lbvh as jlbvh
from hrt_tpu.ops import morton as jmorton, tlas as jtlas, wide8 as jwide8
from hrt_tpu.renderer import camera_arrays as jcamera_arrays
from hrt_tpu.renderer import render_rows as jrender_rows
from hrt_tpu.ops.v3 import V3 as JV3
from hrt_tpu_torch import renderer
from hrt_tpu_torch.config import RenderConfig
from hrt_tpu_torch.frameloop import FrameLoop
from hrt_tpu_torch.models.camera import Camera
from hrt_tpu_torch.models.instance import MeshInstance
from hrt_tpu_torch.models.scene import Scene
from hrt_tpu_torch.ops import (lbvh, morton, tlas, traversal, traversal_skip,
                               traversal_tlas8, traversal_tlas_skip, wide8)
from hrt_tpu_torch.ops.intersect import closest_hit_bruteforce
from hrt_tpu_torch.ops.v3 import V3
from hrt_tpu_torch.utils.image import psnr
from hrt_tpu_torch.utils.interop import two_level_from_numpy

from test_tlas import _instanced_scene, _rays
from test_torch_native import jax_native_lib


@pytest.fixture(scope="module", autouse=True)
def _jax_native_sah():
    """JAX's build_bvh_sah through its native builder, never the LBVH
    fallback (test_torch_native.jax_native_lib)."""
    jax_native_lib()


CAM = dict(position=(0.0, -1.0, -6.0), rotation=(-0.15, 0.0, 0.0))
FRAME = dict(width=64, height=48, max_depth=1, sky=True, jitter=False)


def port_scene(js) -> Scene:
    """The port's Scene with the JAX Scene's meshes, materials, lights,
    sky and instances."""
    sc = Scene()
    sc.meshes = list(js.meshes)
    sc.materials = [np.asarray(m) for m in js.materials]
    sc.lights = [np.asarray(x) for x in js.lights]
    sc.sky = np.asarray(js.sky)
    sc.instances = [MeshInstance(i.mesh_id, i.material_id, i.position,
                                 i.rotation, i.scale) for i in js.instances]
    return sc


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _jv3(a):
    return JV3(*(jnp.asarray(a[:, i]) for i in range(3)))


def _tv3(a):
    return V3(*(torch.as_tensor(np.ascontiguousarray(a[:, i]))
                for i in range(3)))


def jax_two_level_dict(tl, route: str = "bvh8") -> dict:
    """The JAX TwoLevelFlat's arrays, with the tables of one route (JAX
    builds the binary tables always and the BVH8 ones when they fit)."""
    d = {k: np.asarray(getattr(tl, k)) for k in (
        "tris", "attr", "inst_mat", "inst_mesh", "normal_mat",
        "world_from_obj", "obj_from_world", "root_bmin", "root_bmax")}
    if route == "bvh8":
        d.update(w8_nodes=np.asarray(tl.w8_nodes),
                 w8_root=np.asarray(tl.w8_root), w8_tlas_nw=tl.w8_tlas_nw)
    else:
        d.update(nodes=np.asarray(tl.nodes),
                 blas_base=np.asarray(tl.blas_base),
                 blas_end=np.asarray(tl.blas_end), tlas_m=tl.tlas_m)
    d["leaf_size"] = tl.leaf_size
    return d


@pytest.fixture(scope="module")
def jax_loop():
    """JAX FrameLoop(two_level=True) on the 4-instance scene: its accel
    is build_two_level_flat(scene, 32, sah=True), the table every JAX
    comparison below reads."""
    return JFrameLoop(_instanced_scene(), JRenderConfig(
        shade_pallas=False, **FRAME), cull_threshold_px=0.0, two_level=True)


@pytest.fixture(scope="module")
def port_tl():
    return tlas.build_two_level_flat(port_scene(_instanced_scene()), 32,
                                     device="cpu")


@pytest.fixture(scope="module")
def port_tl_binary():
    """The port's build of the same scene past a lowered wide bound: the
    binary route (K5)."""
    return tlas.build_two_level_flat(port_scene(_instanced_scene()), 32,
                                     device="cpu", max_wide_nodes=32)


@pytest.fixture(scope="module")
def tables(jax_loop, port_tl, port_tl_binary):
    """The port walks four tables: its own builds on both routes (K4 and
    K5) and JAX's tables of both routes, carried over through
    two_level_from_numpy."""
    return {"port_build": port_tl,
            "jax_table": two_level_from_numpy(
                jax_two_level_dict(jax_loop.accel), "cpu"),
            "port_binary": port_tl_binary,
            "jax_binary": two_level_from_numpy(
                jax_two_level_dict(jax_loop.accel, "binary"), "cpu")}


@pytest.fixture(scope="module")
def jax_closest(jax_loop):
    o, d = _rays(777)
    return o, d, [np.asarray(a) for a in jtlas.closest_hit_tlas(
        jax_loop.accel, _jv3(o), _jv3(d), 1e-3, 1e32)]


def test_two_level_build_bit_equal(jax_loop, port_tl):
    jt = jax_loop.accel
    for key in ("w8_nodes", "w8_root", "attr", "inst_mat", "inst_mesh",
                "normal_mat", "world_from_obj", "obj_from_world",
                "root_bmin", "root_bmax"):
        a, b = np.asarray(getattr(jt, key)), getattr(port_tl, key).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, key
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=key)
    assert port_tl.w8_tlas_nw == jt.w8_tlas_nw
    assert port_tl.leaf_size == jt.leaf_size == 32
    # JAX's (TR, 16, 128) sublane tris vs the port's (T, 12) rows.
    rows = np.asarray(jt.tris).transpose(0, 2, 1).reshape(-1, 16)
    np.testing.assert_array_equal(_bits(rows[:, :9]),
                                  _bits(port_tl.tris.numpy()[:, :9]))
    assert (port_tl.tris.numpy()[:, 9:] == 0).all()
    assert port_tl.stack == tlas.stack_bound(port_tl.tlas_depth,
                                             port_tl.blas_depth)


@pytest.mark.parametrize("n_inst", [1, 2, 4])
def test_build_wide8_tlas_bit_equal(jax_loop, n_inst):
    """Seeded random instance boxes.  Four boxes reuse the jitted TLAS
    build that the JAX FrameLoop compiled; one and two run the same JAX
    function with jit disabled (a compile per instance count costs
    ~17 s on the CPU)."""
    rs = np.random.RandomState(n_inst)
    c = rs.uniform(-10, 10, (n_inst, 3)).astype(np.float32)
    ext = rs.uniform(0.1, 2.0, (n_inst, 3)).astype(np.float32)
    bmin, bmax = c - ext, c + ext
    pad = wide8.tlas_nw_pad(n_inst)
    assert pad == jwide8.tlas_nw_pad(n_inst)
    with jax.disable_jit(n_inst != len(jax_loop.scene_obj.instances)):
        want = np.asarray(jwide8.build_wide8_tlas(jnp.asarray(bmin),
                                                  jnp.asarray(bmax), pad))
    got = wide8.build_wide8_tlas(bmin, bmax, pad)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # Every instance is a leaf exactly once (a single one twice: its
    # box is duplicated so that the radix tree has two leaves).
    meta = got.reshape(-1, 8, 16, 8).transpose(0, 2, 1, 3)[..., 6]
    leaves = np.sort(meta[meta > 0]) - 1
    expect = [0, 0] if n_inst == 1 else list(range(n_inst))
    np.testing.assert_array_equal(leaves, expect)


def test_morton_and_karras_bit_equal():
    """Morton codes, the radix tree and its refit: the host numpy
    versions (the wide TLAS) and the torch ones (the LBVH and the binary
    TLAS) against JAX's."""
    rs = np.random.RandomState(5)
    pts = rs.uniform(-3, 7, (300, 3)).astype(np.float32)
    pts[:4] = [[-3, -3, -3], [7, 7, 7], [2, 2, 2], [2, 2, 2]]  # edges, dup
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    codes = morton.morton_codes(pts, lo, hi)
    want = np.asarray(jmorton.morton_codes(jnp.asarray(pts),
                                           jnp.asarray(lo), jnp.asarray(hi)))
    assert codes.dtype == np.uint32
    np.testing.assert_array_equal(codes, want)
    np.testing.assert_array_equal(morton.morton_codes_torch(
        *map(torch.as_tensor, (pts, lo, hi))).numpy(), want)
    # The radix tree over sorted codes with duplicate keys (index
    # tiebreak) and the refit over it.
    keys = np.sort(codes)
    keys[10:20] = keys[10]
    boxes = (pts - 0.5, pts + 0.5)
    jcl, jcr = jlbvh.karras_hierarchy(jnp.asarray(keys))
    jboxes = jlbvh.refit(jcl, jcr, *map(jnp.asarray, boxes))
    host = lbvh.karras_hierarchy_host(keys)
    dev = [a.numpy() for a in lbvh.karras_hierarchy(
        torch.as_tensor(keys.astype(np.int64)))]
    for cl, cr in (host, dev):
        np.testing.assert_array_equal(cl, np.asarray(jcl))
        np.testing.assert_array_equal(cr, np.asarray(jcr))
    for got in (lbvh.refit_host(*host, *boxes),
                lbvh.refit(*map(torch.as_tensor, (*dev, *boxes)))):
        for a, b in zip(got, jboxes):
            np.testing.assert_array_equal(_bits(a), _bits(b))


def _moved(instances):
    """test_tlas's refit: the unit sphere at the origin moves to
    (0, -8, 0)."""
    insts = list(instances)
    insts[1] = JMeshInstance(insts[1].mesh_id, insts[1].material_id,
                             (0.0, -8.0, 0.0), (0, 0, 0), (1.0, 1.0, 1.0))
    return [np.stack([getattr(i, k) for i in insts]).astype(np.float32)
            for k in ("transform", "inverse_transform", "normal_matrix")]


@pytest.fixture(scope="module")
def jax_refit(jax_loop):
    """The moved transforms and JAX's refit of its table (both routes'
    TLAS rebuilt).  JAX's refit_two_level body runs unjitted (its jit
    compile alone costs ~18 s on the CPU); the TLAS builds inside it
    stay jitted."""
    mats = _moved(jax_loop.scene_obj.instances)
    return mats, jtlas.refit_two_level.__wrapped__(jax_loop.accel,
                                                   *map(jnp.asarray, mats))


def _inst_of(tl, origin):
    o = np.asarray([origin], np.float32)
    d = np.asarray([[0.0, 0.0, 1.0]], np.float32)
    return int(tlas.closest_hit_tlas(tl, _tv3(o), _tv3(d), 1e-3, 1e32)[2][0])


def test_refit_bit_equal_and_moves_instance(jax_loop, jax_refit, port_tl):
    mats, jt2 = jax_refit
    tl2 = tlas.refit_two_level(port_tl, *mats)
    np.testing.assert_array_equal(tl2.w8_nodes.numpy(),
                                  np.asarray(jt2.w8_nodes))
    for key in ("world_from_obj", "obj_from_world", "normal_mat"):
        np.testing.assert_array_equal(_bits(getattr(tl2, key).numpy()),
                                      _bits(getattr(jt2, key)), err_msg=key)
    # The refit leaves the table it started from as it was.
    np.testing.assert_array_equal(port_tl.w8_nodes.numpy(),
                                  np.asarray(jax_loop.accel.w8_nodes))
    assert _inst_of(port_tl, (0.0, 0.0, -5.0)) == 1     # before the move
    assert _inst_of(tl2, (0.0, 0.0, -5.0)) != 1         # gone after it
    assert _inst_of(tl2, (0.0, -8.0, -5.0)) == 1        # found where it went


def test_binary_refit_bit_equal_and_moves_instance(jax_loop, jax_refit,
                                                   port_tl_binary):
    """The binary route's refit rebuilds the TLAS rows (torch, on the
    table's device) bit for bit as JAX's; the BLAS rows stay."""
    mats, jt2 = jax_refit
    tl = port_tl_binary
    tl2 = tlas.refit_two_level(tl, *mats)
    assert tl2.w8_nodes is None
    np.testing.assert_array_equal(_bits(tl2.nodes.numpy()),
                                  _bits(jt2.nodes))
    np.testing.assert_array_equal(_bits(tl.nodes.numpy()),
                                  _bits(jax_loop.accel.nodes))
    np.testing.assert_array_equal(_bits(tl2.obj_from_world.numpy()),
                                  _bits(jt2.obj_from_world))
    assert _inst_of(tl, (0.0, 0.0, -5.0)) == 1
    assert _inst_of(tl2, (0.0, 0.0, -5.0)) != 1
    assert _inst_of(tl2, (0.0, -8.0, -5.0)) == 1


def test_binary_tables_bit_equal(jax_loop, port_tl_binary):
    """Past the wide bound the port builds JAX's binary tables: the
    skip-link rows (TLAS, then the globalized BLAS), the BLAS ranges,
    tlas_m and the transforms K5 reads; no BVH8 table."""
    jt, tl = jax_loop.accel, port_tl_binary
    assert tl.w8_nodes is None and tl.w8_root is None
    np.testing.assert_array_equal(_bits(tl.nodes.numpy()), _bits(jt.nodes))
    for key in ("blas_base", "blas_end", "obj_from_world", "attr",
                "root_bmin", "root_bmax"):
        a, b = np.asarray(getattr(jt, key)), getattr(tl, key).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, key
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=key)
    assert tl.tlas_m == jt.tlas_m == 7
    assert tlas._walk(tl, False) is traversal_tlas_skip.trace


TABLES = ["port_build", "jax_table", "port_binary", "jax_binary"]


@pytest.mark.parametrize("table", TABLES)
def test_closest_matches_jax(tables, jax_closest, table):
    o, d, (jt, jtri, jinst, _, _) = jax_closest
    t, tri, inst, _, _ = [a.numpy() for a in tlas.closest_hit_tlas(
        tables[table], _tv3(o), _tv3(d), 1e-3, 1e32)]
    hit = tri >= 0
    np.testing.assert_array_equal(hit, jtri >= 0)
    np.testing.assert_allclose(t[hit], jt[hit], rtol=2e-4, atol=2e-5)
    assert (inst[hit] == jinst[hit]).mean() > 0.995
    # Both walk the same pool ids: triangles differ only at equal-t ties.
    tie = np.isclose(t, jt, rtol=1e-6, atol=0)
    assert ((tri == jtri) | tie).all()
    assert (tri == jtri).mean() >= 0.99


@pytest.mark.parametrize("table", TABLES)
def test_any_hit_matches_jax(tables, jax_loop, table):
    o, d = _rays(512, seed=8)
    reach = np.full(512, 4.0, np.float32)
    want = np.asarray(jtlas.any_hit_tlas(jax_loop.accel, _jv3(o), _jv3(d),
                                         1e-3, jnp.asarray(reach)))
    got = tlas.any_hit_tlas(tables[table], _tv3(o), _tv3(d), 1e-3,
                            torch.as_tensor(reach)).numpy()
    assert 0.05 < want.mean() < 0.95
    np.testing.assert_array_equal(got, want)


def test_shade_attrs_match_jax(jax_loop, jax_closest, port_tl):
    """On the rays where both walks hit the same triangle of the same
    instance (test_tlas's hit set)."""
    o, d, (jt, jtri, jinst, ju, jv) = jax_closest
    jn, jmat, jrows, juv = jtlas.shade_attrs_tlas(
        jax_loop.accel, jax_loop.scene.materials, jnp.asarray(jtri),
        jnp.asarray(jinst), jnp.asarray(ju), jnp.asarray(jv))
    t, tri, inst, u, v = tlas.closest_hit_tlas(port_tl, _tv3(o), _tv3(d),
                                               1e-3, 1e32)
    mats = torch.as_tensor(np.array(jax_loop.scene.materials))
    n, mat, rows, uv = tlas.shade_attrs_tlas(port_tl, mats, tri, inst, u, v)
    m = ((tri.numpy() >= 0) & (tri.numpy() == np.asarray(jtri))
         & (inst.numpy() == np.asarray(jinst)))
    assert m.mean() > 0.3
    for a, b in ((n.x, jn.x), (n.y, jn.y), (n.z, jn.z)):
        close = np.isclose(a.numpy()[m], np.asarray(b)[m], rtol=1e-3,
                           atol=2e-3)
        assert close.mean() >= 0.99, close.mean()
    for a, b in ((mat.color.x, jmat.color.x), (mat.metallic, jmat.metallic),
                 (mat.roughness, jmat.roughness)):
        np.testing.assert_array_equal(a.numpy()[m], np.asarray(b)[m])
    np.testing.assert_array_equal(rows.numpy()[m], np.asarray(jrows)[m])
    for a, b in zip(uv, juv):
        np.testing.assert_allclose(a.numpy()[m], np.asarray(b)[m],
                                   rtol=1e-3, atol=2e-3)


def test_frame_matches_jax_frameloop(jax_loop):
    """The 64x48 two-level frame: port FrameLoop (plain versions on the
    CPU) against the JAX FrameLoop (K5 in interpret mode)."""
    jimg = np.asarray(jax_loop.step(JCamera(**CAM)))
    loop = FrameLoop(port_scene(_instanced_scene()), RenderConfig(**FRAME),
                     two_level=True, device="cpu")
    img = loop.step(Camera(**CAM)).numpy()
    assert img.shape == jimg.shape == (48, 64, 3)
    assert psnr(np.clip(img, 0, 4), np.clip(jimg, 0, 4), peak=4.0) > 45.0
    assert np.isclose(img, jimg, rtol=1e-3, atol=1e-3).all(-1).mean() >= 0.995


def test_two_level_gbuffer_matches_jax(jax_loop, tables):
    """The G-buffer of the two-level frame (render_rows(want_gbuffer=True))
    on JAX's table, carried over, against JAX's render_rows on it."""
    from test_torch_post_loop import check_gbuffer

    cfg = JRenderConfig(shade_pallas=False, **FRAME)
    fn = jax.jit(lambda s, a, c: jrender_rows(s, a, c, 0, 0, 48, cfg,
                                              want_gbuffer=True))
    _, jgb = fn(jax_loop.scene, jax_loop.accel,
                jcamera_arrays(JCamera(**CAM), cfg))
    tcfg = RenderConfig(**FRAME)
    _, gb = renderer.render_rows(
        port_scene(_instanced_scene()).build("cpu"), tables["jax_table"],
        renderer.camera_arrays(Camera(**CAM), tcfg, "cpu"), 0, 48, tcfg,
        want_gbuffer=True)
    check_gbuffer(gb, jgb)


def test_two_level_frame_matches_soup_frame():
    cfg = RenderConfig(**FRAME)
    tl_img = FrameLoop(port_scene(_instanced_scene()), cfg, two_level=True,
                       device="cpu").step(Camera(**CAM)).numpy()
    soup_img = FrameLoop(port_scene(_instanced_scene()), cfg,
                         cull_threshold_px=0.0,
                         device="cpu").step(Camera(**CAM)).numpy()
    assert psnr(np.clip(tl_img, 0, 4), np.clip(soup_img, 0, 4),
                peak=4.0) > 45.0
    # Shared-edge t-ties may shade a handful of pixels differently.
    assert np.isclose(tl_img, soup_img, rtol=1e-3, atol=1e-3).mean() > 0.995


def _single_instance_walk(max_wide_nodes: int):
    """One instance: the TLAS duplicates its box; the walk still finds
    exactly the soup's hits.  Returns the table."""
    js = _instanced_scene()
    js.instances = js.instances[2:3]
    sc = port_scene(js)
    tl = tlas.build_two_level_flat(sc, 32, device="cpu",
                                   max_wide_nodes=max_wide_nodes)
    soup = sc.build("cpu")
    o, d = _rays(300, seed=4)
    t, tri, inst, _, _ = tlas.closest_hit_tlas(tl, _tv3(o), _tv3(d), 1e-3,
                                               1e32)
    bt, bi, _, _ = closest_hit_bruteforce(
        torch.as_tensor(o), torch.as_tensor(d), soup.tri_v0, soup.tri_e1,
        soup.tri_e2)
    assert ((tri >= 0) == (bi >= 0)).all() and (bi >= 0).any()
    assert (inst[tri >= 0] == 0).all()
    both = bi >= 0
    np.testing.assert_allclose(t[both].numpy(), bt[both].numpy(),
                               rtol=2e-4, atol=2e-5)
    return tl


def test_single_instance_scene_walks(port_tl):
    _single_instance_walk(wide8.MAX_WIDE_NODES)


def test_single_instance_scene_walks_binary():
    """The same on the binary route (K5): a TLAS of 3 nodes whose two
    leaves both enter instance 0."""
    tl = _single_instance_walk(32)
    assert tl.w8_nodes is None and tl.tlas_m == 3


# A two-level loop is walked whatever its traversal, as in the JAX
# package: traversal='bruteforce' (once refused, with sampled NEE and
# bounces) renders through the TLAS, the frame of traversal='auto'.
def test_two_level_loop_walks_its_tlas_under_bruteforce():
    cfg = dict(FRAME, indirect=True, max_depth=2, light_samples=2)
    brute = FrameLoop(port_scene(_instanced_scene()), RenderConfig(
        traversal="bruteforce", **cfg), two_level=True, device="cpu")
    walk = FrameLoop(port_scene(_instanced_scene()), RenderConfig(**cfg),
                     two_level=True, device="cpu")
    assert isinstance(brute.accel, tlas.TwoLevelFlat)
    np.testing.assert_array_equal(brute.step(Camera(**CAM)).numpy(),
                                  walk.step(Camera(**CAM)).numpy())


@pytest.fixture(scope="module")
def jax_lbvh_tl():
    """JAX's sah=False two-level table: every BLAS an LBVH, collapsed to
    BVH8 (both routes' tables)."""
    return jtlas.build_two_level_flat(_instanced_scene(), 32, sah=False)


# A camera far enough back that two of the four instances fall below a
# pixel at 64x48 (footprints 22.9, 2.32, 0.81, 0.97 px^2).
FAR_CAM = dict(position=(0.0, -19.0, -60.0), rotation=(-0.15, 0.0, 0.0))


@pytest.mark.parametrize("what", ["sah=False", "past the wide bound",
                                  "culling on a single-level accel"])
def test_former_refusals_route(what, jax_loop, jax_lbvh_tl):
    """Calls the port refused until the skip-link walks were ported now
    build what the JAX package builds and route as it does."""
    sc = port_scene(_instanced_scene())
    if what == "sah=False":
        # LBVH BLAS collapsed to BVH8: JAX's unified table, walked by K4;
        # past the bound, JAX's binary tables, walked by K5.
        jt = jax_lbvh_tl
        tl = tlas.build_two_level_flat(sc, 32, sah=False, device="cpu")
        for key in ("w8_nodes", "w8_root", "attr", "root_bmin",
                    "root_bmax"):
            np.testing.assert_array_equal(
                _bits(getattr(tl, key).numpy()),
                _bits(getattr(jt, key)), err_msg=key)
        rows = np.asarray(jt.tris).transpose(0, 2, 1).reshape(-1, 16)
        np.testing.assert_array_equal(_bits(rows[:, :9]),
                                      _bits(tl.tris.numpy()[:, :9]))
        assert tl.w8_tlas_nw == jt.w8_tlas_nw
        assert tlas._walk(tl, False) is traversal_tlas8.trace
        tl = tlas.build_two_level_flat(sc, 32, sah=False, device="cpu",
                                       max_wide_nodes=32)
        for key in ("nodes", "blas_base", "blas_end"):
            np.testing.assert_array_equal(
                _bits(getattr(tl, key).numpy()),
                _bits(getattr(jt, key)), err_msg=key)
        assert tl.tlas_m == jt.tlas_m
        assert tlas._walk(tl, False) is traversal_tlas_skip.trace
    elif what == "past the wide bound":
        tl = tlas.build_two_level_flat(sc, 32, device="cpu",
                                       max_wide_nodes=32)
        np.testing.assert_array_equal(_bits(tl.nodes.numpy()),
                                      _bits(jax_loop.accel.nodes))
        assert tl.w8_nodes is None
        assert tlas._walk(tl, False) is traversal_tlas_skip.trace
    else:
        # The default cull_threshold_px: the first step culls two
        # instances as JAX's culling does, and rebuilds with the LBVH.
        cfg = RenderConfig(**FRAME)
        loop = FrameLoop(sc, cfg, device="cpu")
        assert loop.cull_threshold_px == 1.0 and loop.accel.w8 is not None
        img = loop.step(Camera(**FAR_CAM))
        want = jculling.cull_instances(
            jnp.ones(4, bool), jax_loop.scene.inst_bmin,
            jax_loop.scene.inst_bmax,
            jcamera_arrays(JCamera(**FAR_CAM), JRenderConfig(**FRAME)),
            64, 48)
        np.testing.assert_array_equal(loop.visible.numpy(),
                                      [True, True, False, False])
        np.testing.assert_array_equal(loop.visible.numpy(),
                                      np.asarray(want))
        assert loop.rebuilds == 1 and loop.accel.w8 is None
        assert traversal._walk(loop.accel, False) is traversal_skip.trace
        assert img.shape == (48, 64, 3) and torch.isfinite(img).all()


@pytest.mark.parametrize("route", ["bvh8", "binary"])
def test_cpu_tensors_take_the_plain_version(port_tl, port_tl_binary, route):
    tl, walk = ((port_tl, traversal_tlas8) if route == "bvh8"
                else (port_tl_binary, traversal_tlas_skip))
    o, d = _rays(64, seed=2)
    planes = (*_tv3(o), *_tv3(d), torch.full((64,), 1e32))
    before = dict(walk.LAUNCHES)
    got = walk.trace(tl, *planes, 1e-3, True)
    want = walk.trace_plain(tl, *planes, 1e-3, True)
    assert walk.LAUNCHES == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    meta = [p.to("meta") for p in planes]
    with pytest.raises(ValueError):
        walk.trace(tl, *meta, 1e-3, True)


def test_package_imports_with_jax_flax_hrt_tpu_blocked():
    """hrt_tpu_torch imports, builds and walks both two-level routes
    (K4's and K5's plain walks), builds an LBVH and walks it (K3's plain
    walk), runs a culled FrameLoop step, and runs a 16x12 post step
    (SVGF and the temporal 2x upscaler with the committed weights, K6's
    plain warp), with jax, flax and hrt_tpu made unimportable."""
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'hrt_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import importlib, pkgutil, hrt_tpu_torch\n"
        "for m in pkgutil.walk_packages(hrt_tpu_torch.__path__, "
        "'hrt_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import torch\n"
        "from hrt_tpu_torch.config import RenderConfig\n"
        "from hrt_tpu_torch.frameloop import FrameLoop\n"
        "from hrt_tpu_torch.models.camera import orbit_camera\n"
        "from hrt_tpu_torch.models.scene import instance_grid_scene\n"
        "from hrt_tpu_torch.ops import lbvh, tlas, traversal\n"
        "from hrt_tpu_torch.ops.v3 import V3\n"
        "o = V3(*torch.tensor([[0.0, 0.5, -5.0], [0.0, -5.0, 0.0]]).T)\n"
        "d = V3(*torch.tensor([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0]]).T)\n"
        "for bound in (1 << 15, 32):\n"
        "    tl = tlas.build_two_level_flat(instance_grid_scene(2), 32,\n"
        "                                   device='cpu',\n"
        "                                   max_wide_nodes=bound)\n"
        "    inst = tlas.closest_hit_tlas(tl, o, d, 1e-3, 1e32)[2]\n"
        "    print(int(inst.min()))\n"
        "scene = instance_grid_scene(2).build('cpu')\n"
        "acc = lbvh.build_bvh(scene, 32)\n"
        "t, tri, u, v = traversal.closest_hit_bvh_p(scene, acc, o, d, 1e-3,\n"
        "                                           1e32)\n"
        "print(int(tri.min()))\n"
        "loop = FrameLoop(instance_grid_scene(2), RenderConfig(\n"
        "    width=16, height=12, max_depth=1), device='cpu')\n"
        "loop.step(orbit_camera(0.0, radius=40.0, height=-1.0))\n"
        "print(loop.rebuilds)\n"
        "from hrt_tpu_torch.models.scene import bench_scene\n"
        "post = FrameLoop(bench_scene(), RenderConfig(\n"
        "    width=16, height=12, max_depth=1, denoise=True, upscale=2,\n"
        "    upscale_mode='temporal'), device='cpu')\n"
        "for f in range(2):\n"
        "    img = post.step(orbit_camera(0.01 * f, radius=6.0))\n"
        "print(int(img.shape == (24, 32, 3) and bool(img.isfinite().all())))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = [int(x) for x in proc.stdout.split()]
    assert min(out[:3]) >= 0 and out[3] >= 1 and out[4] == 1


def test_instance_grid_scene_matches_bench_full():
    """instance_grid_scene is scripts/bench_full.py's `_instance_grid`."""
    import importlib.util

    from hrt_tpu_torch.models.scene import instance_grid_scene

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "bench_full", os.path.join(root, "scripts", "bench_full.py"))
    bench_full = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench_full)
    js, ps = bench_full._instance_grid(), instance_grid_scene()
    assert len(ps.instances) == len(js.instances) == 257
    for a, b in zip(ps.instances, js.instances):
        assert (a.mesh_id, a.material_id) == (b.mesh_id, b.material_id)
        np.testing.assert_array_equal(a.transform, b.transform)
    for a, b in zip(ps.meshes, js.meshes):
        np.testing.assert_array_equal(a.vertices, b.vertices)
        np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(np.stack(ps.materials),
                                  np.stack(js.materials))
    np.testing.assert_array_equal(np.stack(ps.lights), np.stack(js.lights))


@pytest.mark.parametrize("table", ["jax_table", "jax_binary"])
def test_path_traced_two_level_frame_matches_jax(jax_loop, tables, table):
    """A path-traced two-level frame (bounces, depth 2) on JAX's tables
    of both routes, carried over (K4's and K5's plain walks and
    shade_attrs_tlas at every depth), against JAX's render on its
    accel."""
    from hrt_tpu.renderer import render as jrender

    kw = dict(FRAME, max_depth=2, indirect=True)
    jimg = np.asarray(jrender(jax_loop.scene, JCamera(**CAM), JRenderConfig(
        shade_pallas=False, **kw), accel=jax_loop.accel))
    img = renderer.render(port_scene(_instanced_scene()), Camera(**CAM),
                          RenderConfig(**kw), tables[table])
    assert np.isfinite(img).all()
    assert psnr(np.clip(img, 0, 4), np.clip(jimg, 0, 4), peak=4.0) > 45.0
    assert (np.abs(img - jimg).max(-1) <= 1e-3).mean() >= 0.99
    direct = renderer.render(port_scene(_instanced_scene()), Camera(**CAM),
                             RenderConfig(**FRAME), tables[table])
    assert img.sum() > direct.sum()
