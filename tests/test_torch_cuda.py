"""The CUDA kernels of hrt_tpu_torch against their plain PyTorch versions,
on a card.  Every test here is marked `cuda` and skips without a CUDA
device: the kernels have no CPU mode.  The file imports neither jax nor
hrt_tpu, so it runs wherever the port runs:

    python -m pytest -m cuda tests/test_torch_cuda.py -q
"""
import contextlib

import numpy as np
import pytest
import torch

from hrt_tpu_torch import renderer
from hrt_tpu_torch.config import RenderConfig
from hrt_tpu_torch.models.camera import Camera
from hrt_tpu_torch.models.materials import MatP
from hrt_tpu_torch.models.scene import bench_scene, instance_grid_scene
from hrt_tpu_torch.ops import (bounce_kernel, lbvh, shade_kernel, tlas,
                               traversal_tlas8, traversal_wide8, wide8)
from hrt_tpu_torch.ops.intersect import (any_hit_bruteforce,
                                         closest_hit_bruteforce)
from hrt_tpu_torch.ops.v3 import V3
from hrt_tpu_torch.utils.image import psnr

pytestmark = pytest.mark.cuda

BENCH_CAM = dict(position=(0.0, -1.0, -6.0), rotation=(-0.15, 0.0, 0.0))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _rays(seed, n, device):
    """Rays from a box around the bench scene toward its middle."""
    rs = np.random.RandomState(seed)
    o = rs.uniform(-6, 6, (n, 3)).astype(np.float32)
    d = rs.uniform(-2, 2, (n, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = lambda a: torch.as_tensor(a, device=device)
    return t(o), t(d)


def _check_bvh8(cuda, leaf: int, n: int, closest: bool):
    """K1 on n rays over the bench scene's SAH tree with `leaf`-triangle
    leaves against its plain walk and brute force; every 17th ray is
    dead and stays so."""
    scene = bench_scene().build(cuda)
    accel = lbvh.build_bvh_sah(scene, leaf_size=leaf)
    o, d = _rays(3, n, cuda)
    tmax = torch.full((n,), 1e32 if closest else 5.0, device=cuda)
    tmax[::17] = -1.0                                   # dead rays
    planes = (*o.T.contiguous(), *d.T.contiguous(), tmax)
    before = traversal_wide8.LAUNCHES["closest" if closest else "any_hit"]
    k = traversal_wide8.trace_kernel(accel, *planes, 1e-3, closest)
    p = traversal_wide8.trace_plain(accel, *planes, 1e-3, closest)
    torch.cuda.synchronize()
    assert traversal_wide8.LAUNCHES["closest" if closest else "any_hit"] \
        == before + 1
    if closest:
        kt, ktri = k[0], k[1]
        assert (ktri == p[1]).float().mean().item() >= 0.999
        same = (ktri == p[1]) & (ktri >= 0)
        torch.testing.assert_close(kt[same], p[0][same], rtol=1e-4,
                                   atol=1e-5)
        assert (ktri[::17] == -1).all()
        bt, bi, _, _ = closest_hit_bruteforce(
            o, d, scene.tri_v0, scene.tri_e1, scene.tri_e2, 1e-3, tmax)
        orig = torch.where(ktri >= 0,
                           accel.tri_perm[ktri.clamp(min=0).long()], -1)
        # Ids agree up to equal-t ties (edges shared by two triangles).
        tie = (orig >= 0) & (bi >= 0) & ((kt - bt).abs() <= 1e-5 * bt.abs())
        assert ((orig == bi) | tie).float().mean().item() >= 0.999
    else:
        assert (k == p).float().mean().item() >= 0.999
        assert not k[::17].any()
        bocc = any_hit_bruteforce(o, d, scene.tri_v0, scene.tri_e1,
                                  scene.tri_e2, 1e-3, tmax)
        assert (k == bocc).float().mean().item() >= 0.999
    return accel


@pytest.mark.parametrize("closest", [True, False])
def test_bvh8_kernel_matches_plain_and_bruteforce(cuda, closest):
    _check_bvh8(cuda, 32, 4096, closest)


@pytest.mark.parametrize("closest", [True, False])
@pytest.mark.parametrize("leaf", [32, 8])
def test_bvh8_kernel_partial_warp_and_both_stacks(cuda, leaf, closest):
    """4093 rays (a partial last warp) over the frame's tree (depth 3:
    the closest walk's 32-entry stack) and over 8-triangle leaves (depth
    4: its 256-entry stack)."""
    accel = _check_bvh8(cuda, leaf, 4093, closest)
    entries = traversal_wide8.stack_entries(accel.w8_depth)
    assert (entries <= 32) == (leaf == 32)


def _brdf_args(device, n: int, num_lights: int, rel_share: float,
               seed: int):
    """brdf_light_major's arguments over n rays and num_lights lights,
    every plane strided as a frame's are: the material planes rows of a
    transposed (n, 20) table, normals, views and light directions
    columns of (m, 3) arrays, the relevance bytes every other byte of a
    mask twice as long."""
    rs = np.random.RandomState(seed)
    tab = torch.as_tensor(rs.rand(n, 20).astype(np.float32), device=device)
    rt = tab.T

    def unit(m):
        v = rs.normal(size=(m, 3)).astype(np.float32)
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        v = torch.as_tensor(v, device=device)
        return V3(v[:, 0], v[:, 1], v[:, 2])

    zero = torch.zeros(n, device=device)
    mat = MatP(color=V3(rt[0], rt[1], rt[2]), subsurface=rt[3],
               metallic=rt[4], roughness=rt[5], specular=rt[6],
               specular_tint=rt[7], anisotropic=rt[8], sheen_tint=rt[9],
               clearcoat=rt[10], clearcoat_gloss=rt[11],
               emissive=V3(zero, zero, zero), emission_strength=zero,
               ior=zero, transmission=zero)
    rel = torch.as_tensor(rs.rand(2 * n * num_lights) < rel_share,
                          device=device)[::2]
    return mat, unit(n), unit(n), unit(n * num_lights), rel, num_lights


@pytest.mark.parametrize("num_lights", [1, 2, 3])
def test_brdf_kernel_reads_strided_planes(cuda, num_lights):
    """K2 reads every plane in place through its element stride: within
    rtol 1e-4 / atol 1e-6 of the plain version, zero where irrelevant,
    finite everywhere."""
    args = _brdf_args(cuda, 4093, num_lights, 0.7, 10 + num_lights)
    assert args[0].metallic.stride(0) == 20 and args[1].x.stride(0) == 3 \
        and args[4].stride(0) == 2
    before = shade_kernel.LAUNCHES["brdf_light_major"]
    k = shade_kernel.brdf_light_major_kernel(*args)
    p = shade_kernel.brdf_light_major_plain(*args)
    assert shade_kernel.LAUNCHES["brdf_light_major"] == before + 1
    for a, b in zip(k, p):
        assert a.shape == (4093 * num_lights,)
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
        assert (a[~args[4]] == 0).all() and torch.isfinite(a).all()


def test_brdf_kernel_all_irrelevant_writes_zeros(cuda):
    """A batch with no relevant element comes out exact zeros."""
    args = _brdf_args(cuda, 4093, 3, 0.0, 9)
    assert not args[4].any()
    for a in shade_kernel.brdf_light_major_kernel(*args):
        assert torch.equal(a, torch.zeros_like(a))


def test_brdf_kernel_matches_plain(cuda):
    n, num_lights = 4096, 2
    rs = np.random.RandomState(4)
    plane = lambda: torch.as_tensor(rs.rand(n).astype(np.float32),
                                    device=cuda)

    def unit(m):
        v = rs.normal(size=(3, m)).astype(np.float32)
        v /= np.linalg.norm(v, axis=0)
        return V3(*(torch.as_tensor(c, device=cuda) for c in v))

    zero = torch.zeros(n, device=cuda)
    mat = MatP(color=V3(plane(), plane(), plane()), subsurface=plane(),
               metallic=plane(), roughness=plane(), specular=plane(),
               specular_tint=plane(), anisotropic=plane(),
               sheen_tint=plane(), clearcoat=plane(),
               clearcoat_gloss=plane(), emissive=V3(zero, zero, zero),
               emission_strength=zero, ior=zero, transmission=zero)
    nrm, view, light = unit(n), unit(n), unit(n * num_lights)
    rel = torch.as_tensor(rs.rand(n * num_lights) < 0.7, device=cuda)
    args = (mat, nrm, view, light, rel, num_lights)
    before = shade_kernel.LAUNCHES["brdf_light_major"]
    k = shade_kernel.brdf_light_major_kernel(*args)
    p = shade_kernel.brdf_light_major_plain(*args)
    assert shade_kernel.LAUNCHES["brdf_light_major"] == before + 1
    for a, b in zip(k, p):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
        assert (a[~rel] == 0).all()


def test_kernel_frame_matches_plain_frame(cuda):
    cfg = RenderConfig(width=256, height=192, max_depth=1, sky=True)
    scene = bench_scene().build(cuda)
    accel = lbvh.build_bvh_sah(scene, leaf_size=32)
    cams = renderer.camera_arrays(Camera(**BENCH_CAM), cfg, cuda)
    before = (dict(traversal_wide8.LAUNCHES), dict(shade_kernel.LAUNCHES))
    img = renderer.render_frames(scene, accel, cams, 0, 2, cfg)
    assert traversal_wide8.LAUNCHES == {
        m: c + 2 for m, c in before[0].items()}
    assert shade_kernel.LAUNCHES == {m: c + 2 for m, c in before[1].items()}
    ref = renderer.render_frames(scene, accel, cams, 0, 1, cfg, plain=True)
    assert img.shape == (2, 192, 256, 3) and torch.isfinite(img).all()
    assert psnr(img[0].clamp(0, 4).cpu().numpy(),
                ref[0].clamp(0, 4).cpu().numpy(), peak=4.0) > 45.0


def test_render_frame_is_render_frames_first_frame(cuda):
    """render_frame (the array-form entry point) on the card: K1 and K2
    once each, and the frame equal to render_frames(..., 1)[0] bit for
    bit."""
    cfg = RenderConfig(width=128, height=96, max_depth=1, sky=True)
    scene = bench_scene().build(cuda)
    accel = lbvh.build_bvh_sah(scene, leaf_size=32)
    cams = renderer.camera_arrays(Camera(**BENCH_CAM), cfg, cuda)
    before = (dict(traversal_wide8.LAUNCHES), dict(shade_kernel.LAUNCHES))
    img = renderer.render_frame(scene, accel, cams, 3, cfg)
    assert traversal_wide8.LAUNCHES == {
        m: c + 1 for m, c in before[0].items()}
    assert shade_kernel.LAUNCHES == {m: c + 1 for m, c in before[1].items()}
    ref = renderer.render_frames(scene, accel, cams, 3, 1, cfg)[0]
    assert img.shape == (96, 128, 3) and img.device.type == "cuda"
    assert torch.equal(img.view(torch.int32), ref.view(torch.int32))


def _instanced_scene():
    """Four transformed instances of two meshes (the JAX package's
    test_tlas scene)."""
    from hrt_tpu_torch.models.mesh import icosphere, plane
    from hrt_tpu_torch.models.scene import Scene

    sc = Scene()
    sph = sc.add_mesh(icosphere(2))
    gnd = sc.add_mesh(plane(6.0))
    m0 = sc.create_material((0.8, 0.8, 0.8), 0.0, 0.8)
    m1 = sc.create_material((0.9, 0.6, 0.2), 1.0, 0.2)
    sc.create_light((0.0, -4.0, -2.0), (1.0, 1.0, 1.0), 25.0)
    sc.create_instance(gnd, m0, (0.0, 1.0, 0.0))
    sc.create_instance(sph, m1, (0.0, 0.0, 0.0))
    sc.create_instance(sph, m0, (-1.8, 0.3, 1.0),
                       rotation=(0.3, 1.1, -0.4), scale=(0.6, 0.6, 0.6))
    sc.create_instance(sph, m1, (1.7, 0.4, -0.8),
                       rotation=(0.0, 0.7, 0.2), scale=(0.5, 0.9, 0.5))
    return sc


@pytest.mark.parametrize("closest", [True, False])
def test_tlas8_kernel_matches_plain_and_bruteforce(cuda, closest):
    sc = _instanced_scene()
    scene = sc.build(cuda)
    tl = tlas.build_two_level_flat(sc, 32, device=cuda)
    o, d = _rays(5, 4096, cuda)
    tmax = torch.full((4096,), 1e32 if closest else 4.0, device=cuda)
    tmax[::17] = -1.0                                   # dead rays
    planes = (*o.T.contiguous(), *d.T.contiguous(), tmax)
    mode = "closest" if closest else "any_hit"
    before = traversal_tlas8.LAUNCHES[mode]
    k = traversal_tlas8.trace_kernel(tl, *planes, 1e-3, closest)
    p = traversal_tlas8.trace_plain(tl, *planes, 1e-3, closest)
    torch.cuda.synchronize()
    assert traversal_tlas8.LAUNCHES[mode] == before + 1
    if closest:
        kt, ktri, kinst = k[0], k[1], k[2]
        assert (ktri == p[1]).float().mean().item() >= 0.999
        assert (kinst == p[2]).float().mean().item() >= 0.999
        same = (ktri == p[1]) & (ktri >= 0)
        torch.testing.assert_close(kt[same], p[0][same], rtol=1e-4,
                                   atol=1e-5)
        assert (ktri[::17] == -1).all() and (kinst[::17] == -1).all()
        bt, bi, _, _ = closest_hit_bruteforce(
            o, d, scene.tri_v0, scene.tri_e1, scene.tri_e2, 1e-3, tmax)
        assert ((ktri >= 0) == (bi >= 0)).float().mean().item() >= 0.999
        both = (ktri >= 0) & (bi >= 0)
        torch.testing.assert_close(kt[both], bt[both], rtol=2e-4,
                                   atol=2e-5)
        # Instance ids through the soup's per-triangle instance table,
        # up to coincident-surface ties.
        oracle = scene.tri_inst[bi.clamp(min=0).long()]
        assert (kinst[both] == oracle[both]).float().mean().item() > 0.995
    else:
        assert (k == p).float().mean().item() >= 0.999
        assert not k[::17].any()
        bocc = any_hit_bruteforce(o, d, scene.tri_v0, scene.tri_e1,
                                  scene.tri_e2, 1e-3, tmax)
        assert (k == bocc).float().mean().item() >= 0.999


def test_two_level_frame_matches_plain_and_soup(cuda):
    from hrt_tpu_torch.frameloop import FrameLoop

    cfg = RenderConfig(width=256, height=192, max_depth=1, sky=True)
    loop = FrameLoop(instance_grid_scene(), cfg, two_level=True,
                     device=cuda)
    cam = Camera(**BENCH_CAM)
    loop.set_instance_transform(5, position=(0.0, 0.0, -1.0))
    before = dict(traversal_tlas8.LAUNCHES)
    img = loop.step(cam)
    assert traversal_tlas8.LAUNCHES == {m: c + 1 for m, c in before.items()}
    cams = renderer.camera_arrays(cam, cfg, cuda)
    ref = renderer.render_frames(loop.scene, loop.accel, cams, 0, 1, cfg,
                                 plain=True)[0]
    soup = loop.scene_obj.build(cuda)
    soup_img = renderer.render_frames(
        soup, lbvh.build_bvh_sah(soup, leaf_size=32), cams, 0, 1, cfg)[0]
    assert img.shape == (192, 256, 3) and torch.isfinite(img).all()
    for other in (ref, soup_img):
        assert psnr(img.clamp(0, 4).cpu().numpy(),
                    other.clamp(0, 4).cpu().numpy(), peak=4.0) > 45.0


def _bits(t):
    t = t.detach().cpu()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def test_lbvh_on_the_card_is_bit_equal_to_the_cpu_build(cuda):
    """The culling rebuild's LBVH, built on the card and on the CPU from
    the same scene and mask: every tree field, the sorted codes and the
    skip-link table agree bit for bit."""
    from hrt_tpu_torch.ops import culling

    sc = instance_grid_scene(4)
    cpu, card = sc.build("cpu"), sc.build(cuda)
    vis = torch.as_tensor(np.random.RandomState(1).rand(17) < 0.7)
    mask = culling.triangle_mask(vis, cpu.tri_inst, cpu.tri_valid)
    a = lbvh.lbvh_tree(cpu, 32, mask)
    b = lbvh.lbvh_tree(card, 32, mask.to(cuda))
    for k in a:
        assert torch.equal(_bits(a[k]), _bits(b[k])), k
    na, ma = lbvh.flatten_tree(a, 32)
    nb, mb = lbvh.flatten_tree(b, 32)
    assert ma == mb and torch.equal(_bits(na), _bits(nb))
    assert nb.device.type == "cuda"


@pytest.mark.parametrize("closest", [True, False])
def test_skip_kernel_matches_plain_and_bruteforce(cuda, closest):
    """K3 on the LBVH of the bench scene."""
    from hrt_tpu_torch.ops import traversal_skip

    scene = bench_scene().build(cuda)
    accel = lbvh.build_bvh(scene, 32)
    assert accel.w8 is None
    o, d = _rays(7, 4096, cuda)
    tmax = torch.full((4096,), 1e32 if closest else 5.0, device=cuda)
    tmax[::17] = -1.0                                   # dead rays
    planes = (*o.T.contiguous(), *d.T.contiguous(), tmax)
    mode = "closest" if closest else "any_hit"
    before = traversal_skip.LAUNCHES[mode]
    k = traversal_skip.trace_kernel(accel, *planes, 1e-3, closest)
    p = traversal_skip.trace_plain(accel, *planes, 1e-3, closest)
    torch.cuda.synchronize()
    assert traversal_skip.LAUNCHES[mode] == before + 1
    if closest:
        kt, ktri = k[0], k[1]
        assert (ktri == p[1]).float().mean().item() >= 0.999
        same = (ktri == p[1]) & (ktri >= 0)
        torch.testing.assert_close(kt[same], p[0][same], rtol=1e-4,
                                   atol=1e-5)
        assert (ktri[::17] == -1).all()
        bt, bi, _, _ = closest_hit_bruteforce(
            o, d, scene.tri_v0, scene.tri_e1, scene.tri_e2, 1e-3, tmax)
        orig = torch.where(ktri >= 0,
                           accel.tri_perm[ktri.clamp(min=0).long()], -1)
        tie = (orig >= 0) & (bi >= 0) & ((kt - bt).abs() <= 1e-5 * bt.abs())
        assert ((orig == bi) | tie).float().mean().item() >= 0.999
    else:
        assert (k == p).float().mean().item() >= 0.999
        assert not k[::17].any()
        bocc = any_hit_bruteforce(o, d, scene.tri_v0, scene.tri_e1,
                                  scene.tri_e2, 1e-3, tmax)
        assert (k == bocc).float().mean().item() >= 0.999


@pytest.mark.parametrize("closest", [True, False])
@pytest.mark.parametrize("which,leaf", [("lbvh", 64),
                                        ("sah_past_bound", 8)])
def test_skip_kernel_records_match_plain_and_bruteforce(cuda, monkeypatch,
                                                        which, leaf, closest):
    """K3 through the 32-byte records on the bench scene's LBVH with
    64-triangle leaves (staged 32 at a time) and on its SAH tree past a
    lowered MAX_WIDE_NODES with 8-triangle leaves, for a ray count that
    leaves the last warp partial: ids (occlusion) agree with the plain
    walk and brute force on >= 99.9% of rays, t within rtol 1e-4."""
    from hrt_tpu_torch.ops import traversal_skip, wide8

    scene = bench_scene().build(cuda)
    if which == "lbvh":
        accel = lbvh.build_bvh(scene, leaf)
    else:
        monkeypatch.setattr(wide8, "MAX_WIDE_NODES", 4)
        accel = lbvh.build_bvh_sah(scene, leaf_size=leaf)
    assert accel.leaf_size == leaf
    assert accel.w8 is None and accel.skip_rec.is_cuda
    assert torch.equal(accel.skip_rec, traversal_skip.node_words(
        accel.nodes, torch.arange(accel.m_real, device=cuda)))
    n = 4093
    o, d = _rays(8, n, cuda)
    tmax = torch.full((n,), 1e32 if closest else 5.0, device=cuda)
    tmax[::13] = -1.0                                   # dead rays
    planes = (*o.T.contiguous(), *d.T.contiguous(), tmax)
    k = traversal_skip.trace_kernel(accel, *planes, 1e-3, closest)
    p = traversal_skip.trace_plain(accel, *planes, 1e-3, closest)
    torch.cuda.synchronize()
    if closest:
        kt, ktri = k[0], k[1]
        assert (ktri == p[1]).float().mean().item() >= 0.999
        same = (ktri == p[1]) & (ktri >= 0)
        torch.testing.assert_close(kt[same], p[0][same], rtol=1e-4,
                                   atol=1e-5)
        assert (ktri[::13] == -1).all() and (kt[::13] == -1.0).all()
        bt, bi, _, _ = closest_hit_bruteforce(
            o, d, scene.tri_v0, scene.tri_e1, scene.tri_e2, 1e-3, tmax)
        orig = torch.where(ktri >= 0,
                           accel.tri_perm[ktri.clamp(min=0).long()], -1)
        tie = (orig >= 0) & (bi >= 0) & ((kt - bt).abs() <= 1e-5 * bt.abs())
        assert ((orig == bi) | tie).float().mean().item() >= 0.999
        assert (ktri >= 0).float().mean().item() > 0.1
    else:
        assert (k == p).float().mean().item() >= 0.999
        assert not k[::13].any()
        bocc = any_hit_bruteforce(o, d, scene.tri_v0, scene.tri_e1,
                                  scene.tri_e2, 1e-3, tmax)
        assert (k == bocc).float().mean().item() >= 0.999
        assert 0.05 < k.float().mean().item() < 0.95


@pytest.mark.parametrize("closest", [True, False])
def test_tlas_skip_kernel_matches_plain_and_k4(cuda, closest):
    """K5 on the binary tables of the instanced scene (past a lowered
    wide bound), against its plain walk and against K4 on the same
    scene's unified BVH8 table."""
    from hrt_tpu_torch.ops import traversal_tlas_skip

    sc = _instanced_scene()
    tl5 = tlas.build_two_level_flat(sc, 32, device=cuda, max_wide_nodes=32)
    tl4 = tlas.build_two_level_flat(sc, 32, device=cuda)
    assert tl5.w8_nodes is None and tl4.w8_nodes is not None
    o, d = _rays(9, 4096, cuda)
    tmax = torch.full((4096,), 1e32 if closest else 4.0, device=cuda)
    tmax[::17] = -1.0                                   # dead rays
    planes = (*o.T.contiguous(), *d.T.contiguous(), tmax)
    mode = "closest" if closest else "any_hit"
    before = traversal_tlas_skip.LAUNCHES[mode]
    k = traversal_tlas_skip.trace_kernel(tl5, *planes, 1e-3, closest)
    p = traversal_tlas_skip.trace_plain(tl5, *planes, 1e-3, closest)
    k4 = traversal_tlas8.trace_kernel(tl4, *planes, 1e-3, closest)
    torch.cuda.synchronize()
    assert traversal_tlas_skip.LAUNCHES[mode] == before + 1
    if closest:
        for other in (p, k4):
            same = (k[1] == other[1]) & (k[2] == other[2])
            assert same.float().mean().item() >= 0.999
            hit = same & (k[1] >= 0)
            torch.testing.assert_close(k[0][hit], other[0][hit], rtol=1e-4,
                                       atol=1e-5)
        assert (k[1][::17] == -1).all() and (k[2][::17] == -1).all()
    else:
        for other in (p, k4):
            assert (k == other).float().mean().item() >= 0.999
        assert not k[::17].any()


def _moved_mats(sc, idx, position):
    """The scene's per-instance matrices with instance idx moved."""
    from hrt_tpu_torch.models.instance import MeshInstance

    insts = list(sc.instances)
    cur = insts[idx]
    insts[idx] = MeshInstance(cur.mesh_id, cur.material_id, position,
                              cur.rotation, cur.scale)
    return [np.stack([getattr(i, k) for i in insts]).astype(np.float32)
            for k in ("transform", "inverse_transform", "normal_matrix")]


def _check_walks(k, p, closest, dead):
    """A kernel's result against its plain walk: closest ids and instance
    ids agree on >= 99.9% of rays, t within rtol 1e-4 where they do;
    occlusion agrees on >= 99.9%; dead rays miss."""
    if closest:
        same = (k[1] == p[1]) & (k[2] == p[2])
        assert same.float().mean().item() >= 0.999
        hit = same & (k[1] >= 0)
        torch.testing.assert_close(k[0][hit], p[0][hit], rtol=1e-4,
                                   atol=1e-5)
        assert (k[1][dead] == -1).all() and (k[2][dead] == -1).all()
        assert (p[1] >= 0).float().mean().item() > 0.1
    else:
        assert (k == p).float().mean().item() >= 0.999
        assert not k[dead].any()
        assert 0.05 < p.float().mean().item() < 0.95


@pytest.mark.parametrize("closest", [True, False])
@pytest.mark.parametrize("leaf", [8, 64])
@pytest.mark.parametrize("route", ["k4", "k5"])
def test_two_level_kernels_match_plain_after_refit(cuda, route, leaf,
                                                   closest):
    """K4 (256-byte node records, nearest-first packet walk) and K5
    (32-byte records, the packet walk in key order) with 8- and
    64-triangle leaves (staged 32 at a time), for 4093 rays (a partial
    last warp) with dead rays: against their plain walks, on the built
    table and after a refit that moves an instance; K5 also against K4
    on the same scene."""
    from hrt_tpu_torch.ops import traversal_skip, traversal_tlas_skip

    sc = _instanced_scene()
    bound = dict(max_wide_nodes=32) if route == "k5" else {}
    tl = tlas.build_two_level_flat(sc, leaf, device=cuda, **bound)
    walk = traversal_tlas_skip if route == "k5" else traversal_tlas8
    n = 4093
    o, d = _rays(10 + leaf, n, cuda)
    tmax = torch.full((n,), 1e32 if closest else 4.0, device=cuda)
    dead = torch.zeros(n, dtype=torch.bool, device=cuda)
    dead[::13] = True
    tmax[dead] = -1.0
    planes = (*o.T.contiguous(), *d.T.contiguous(), tmax)
    mode = "closest" if closest else "any_hit"
    for step in ("built", "refit"):
        if step == "refit":
            tl = tlas.refit_two_level(tl, *_moved_mats(sc, 1,
                                                       (0.4, -0.6, 0.3)))
        if route == "k5":
            assert torch.equal(tl.skip_rec, traversal_skip.skip_records(
                tl.nodes, tl.nodes.shape[0] * 128))
        else:
            assert torch.equal(tl.w8_rec,
                               wide8.node_records(tl.w8_nodes))
        before = walk.LAUNCHES[mode]
        k = walk.trace_kernel(tl, *planes, 1e-3, closest)
        p = walk.trace_plain(tl, *planes, 1e-3, closest)
        torch.cuda.synchronize()
        assert walk.LAUNCHES[mode] == before + 1
        _check_walks(k, p, closest, dead)
    if route == "k5":
        tl4 = tlas.refit_two_level(
            tlas.build_two_level_flat(sc, leaf, device=cuda),
            *_moved_mats(sc, 1, (0.4, -0.6, 0.3)))
        _check_walks(k, traversal_tlas8.trace_kernel(tl4, *planes, 1e-3,
                                                     closest),
                     closest, dead)


def test_warp_kernel_matches_plain(cuda):
    """K6 at a shape that is no multiple of the block (a 37x53x10 source,
    a 41x67 grid), coordinates in and out of bounds and some at +-1e10:
    validity identical; values finite and equal to the plain version's
    bit for bit (so within rel 1e-5 of the taps' absolute weighted
    sum)."""
    from hrt_tpu_torch.ops import warp_kernel

    rs = np.random.RandomState(11)
    hs, ws, c, ho, wo = 37, 53, 10, 41, 67
    img = torch.as_tensor(rs.uniform(-2, 2, (hs, ws, c)).astype(np.float32),
                          device=cuda)
    px = rs.uniform(-5, ws + 4, (ho, wo)).astype(np.float32)
    py = rs.uniform(-5, hs + 4, (ho, wo)).astype(np.float32)
    px[::7, ::5] = 1e10
    py[::11, ::3] = -1e10
    px, py = (torch.as_tensor(a, device=cuda) for a in (px, py))
    before = warp_kernel.LAUNCHES["warp_bilinear"]
    kv, kvalid = warp_kernel.warp_bilinear(img, px, py)
    pv, pvalid = warp_kernel.warp_bilinear_plain(img, px, py)
    scale = warp_kernel.warp_bilinear_plain(img.abs(), px, py)[0]
    torch.cuda.synchronize()
    assert warp_kernel.LAUNCHES["warp_bilinear"] == before + 1
    assert kv.shape == (ho, wo, c) and kvalid.dtype == torch.bool
    assert torch.equal(kvalid, pvalid)
    assert 0.3 < kvalid.float().mean().item() < 0.95
    assert torch.isfinite(kv).all()
    assert ((kv - pv).abs() <= 1e-5 * scale).all()
    assert torch.equal(kv.view(torch.int32), pv.view(torch.int32))


@pytest.mark.parametrize("layout", ["hwc", "chw"])
@pytest.mark.parametrize("c", [1, 3, 10])
def test_warp_kernel_tiles_match_plain(cuda, c, layout):
    """K6's tiles at a ragged size (a 37x29 grid from a 31x23 source, so
    the last tile and its last 16-byte store are partial) for each
    channel count, from a contiguous image and from a channels-first
    view (read through its strides): validity identical, values within
    rel 1e-5 of the taps' absolute weighted sum, finite, and equal to
    the plain version's bit for bit."""
    from hrt_tpu_torch.ops import warp_kernel

    rs = np.random.RandomState(13 + c)
    hs, ws, ho, wo = 23, 31, 29, 37
    src = rs.uniform(-2, 2, (hs, ws, c)).astype(np.float32)
    if layout == "hwc":
        img = torch.as_tensor(src, device=cuda)
    else:
        img = torch.as_tensor(np.ascontiguousarray(src.transpose(2, 0, 1)),
                              device=cuda).permute(1, 2, 0)
        assert c == 1 or not img.is_contiguous()
    px = rs.uniform(-4, ws + 3, (ho, wo)).astype(np.float32)
    py = rs.uniform(-4, hs + 3, (ho, wo)).astype(np.float32)
    px[::5, ::3] = 1e10
    py[::7, ::2] = -1e10
    px[1::6, 1::4] = -1e10
    px, py = (torch.as_tensor(a, device=cuda) for a in (px, py))
    before = warp_kernel.LAUNCHES["warp_bilinear"]
    kv, kvalid = warp_kernel.warp_bilinear(img, px, py)
    pv, pvalid = warp_kernel.warp_bilinear_plain(img, px, py)
    scale = warp_kernel.warp_bilinear_plain(img.abs(), px, py)[0]
    torch.cuda.synchronize()
    assert warp_kernel.LAUNCHES["warp_bilinear"] == before + 1
    assert kv.shape == (ho, wo, c) and kv.is_contiguous()
    assert torch.equal(kvalid, pvalid)
    assert 0.3 < kvalid.float().mean().item() < 0.95
    assert torch.isfinite(kv).all()
    assert ((kv - pv).abs() <= 1e-5 * scale).all()
    assert torch.equal(kv.view(torch.int32), pv.view(torch.int32))


def _tap_boundary_coords(rs, n: int, shape):
    """Coordinates on K6's tap boundaries along an axis of n pixels: an
    integer from -1 to n, that integer 1 ulp up or 1 ulp down, or a
    random point above it, a quarter each."""
    k = rs.randint(-1, n + 1, shape).astype(np.float32)
    kind = rs.randint(0, 4, shape)
    up = np.nextafter(k, np.float32(np.inf))
    down = np.nextafter(k, np.float32(-np.inf))
    rand = (k + rs.uniform(0, 1, shape)).astype(np.float32)
    return np.select([kind == 0, kind == 1, kind == 2], [k, up, down],
                     rand).astype(np.float32)


@pytest.mark.parametrize("layout", ["hwc", "chw"])
@pytest.mark.parametrize("c", [1, 3, 10])
def test_warp_kernel_bit_equal_to_plain_at_tap_boundaries(cuda, c, layout):
    """K6's forward equals warp_bilinear_plain bit for bit where the
    coordinates sit exactly on a tap boundary (integers, the edges and
    one past them) or within 1 ulp of one: the kernel rounds each
    product and each add of the tap sum as the plain version does."""
    from hrt_tpu_torch.ops import warp_kernel

    rs = np.random.RandomState(50 + c)
    hs, ws, ho, wo = 45, 61, 70, 83
    src = rs.uniform(-2, 2, (c, hs, ws)).astype(np.float32)
    img = torch.as_tensor(src, device=cuda).permute(1, 2, 0)
    if layout == "hwc":
        img = img.contiguous()
    px = torch.as_tensor(_tap_boundary_coords(rs, ws, (ho, wo)), device=cuda)
    py = torch.as_tensor(_tap_boundary_coords(rs, hs, (ho, wo)), device=cuda)
    assert (px == torch.floor(px)).float().mean().item() > 0.2
    kv, kvalid = warp_kernel.warp_bilinear(img, px, py)
    pv, pvalid = warp_kernel.warp_bilinear_plain(img, px, py)
    torch.cuda.synchronize()
    assert torch.equal(kvalid, pvalid)
    assert torch.equal(kv.view(torch.int32), pv.view(torch.int32))


def _post_cam(f: int) -> Camera:
    return Camera(position=(0.03 * f, -1.0, -6.0),
                  rotation=(-0.15, 0.004 * f, 0.0))


def test_post_loop_steps_on_the_card(cuda):
    """Two post steps (SVGF + the temporal 2x upscaler, the committed
    weights) of a FrameLoop made without a device: each launches K6
    twice, K1 closest and any-hit and K2 once; the last frame against
    the same loop replayed with the plain versions."""
    from hrt_tpu_torch.frameloop import FrameLoop
    from hrt_tpu_torch.ops import warp_kernel

    cfg = RenderConfig(width=96, height=64, max_depth=1, sky=True,
                       denoise=True, upscale=2, upscale_mode="temporal")
    loop = FrameLoop(bench_scene(), cfg)
    ref_loop = FrameLoop(bench_scene(), cfg, device=cuda)
    assert loop.device.type == "cuda"
    counters = (warp_kernel.LAUNCHES, traversal_wide8.LAUNCHES,
                shade_kernel.LAUNCHES)
    for f in range(2):
        before = [dict(c) for c in counters]
        img = loop.step(_post_cam(f))
        assert warp_kernel.LAUNCHES["warp_bilinear"] \
            == before[0]["warp_bilinear"] + 2
        assert traversal_wide8.LAUNCHES == {m: c + 1
                                            for m, c in before[1].items()}
        assert shade_kernel.LAUNCHES == {m: c + 1
                                         for m, c in before[2].items()}
        ref = ref_loop.step(_post_cam(f), plain=True)
    assert img.shape == (128, 192, 3) and torch.isfinite(img).all()
    assert psnr(img.clamp(0, 4).cpu().numpy(), ref.clamp(0, 4).cpu().numpy(),
                peak=4.0) > 45.0


def test_two_level_build_defaults_to_the_card(cuda):
    tl = tlas.build_two_level_flat(_instanced_scene(), 32)
    assert tl.tris.device.type == "cuda" and tl.w8_nodes.is_cuda


def _path_cfg(w: int, h: int):
    import dataclasses

    from hrt_tpu_torch.config import CONFIGS

    return dataclasses.replace(CONFIGS["path_tracing"], width=w, height=h,
                               sort_bounces=True)


@pytest.mark.parametrize("closest", [True, False])
def test_k1_on_bounce_batches_with_dead_lanes(cuda, closest):
    """K1 on the depth-1 and depth-3 batches of a path-traced frame
    (sorted, Russian roulette: most depth-3 lanes retired with t_max =
    -1), closest rays or their light-major shadow rays, against the
    plain walk on every ray."""
    cfg = _path_cfg(128, 96)
    scene = bench_scene().build(cuda)
    accel = lbvh.build_bvh_sah(scene, leaf_size=32)
    cams = renderer.camera_arrays(Camera(**BENCH_CAM), cfg, cuda)
    batches = []
    renderer.render_rows(scene, accel, cams, 0, 96, cfg, frame=1,
                         _batches=batches)
    for depth in (1, 3):
        b = batches[depth]
        n = b["o"].x.numel()
        tmax = torch.broadcast_to(torch.as_tensor(b["t_max"], device=cuda),
                                  (n,)).contiguous()
        planes = (*b["o"], *b["d"], tmax)
        if not closest:
            sh = b["hits"]
            lb = renderer.light_batch(scene, sh.normal, sh.world_pos, cfg,
                                      ray_mask=sh.hit)
            planes = (*lb.origin, *lb.l, lb.t_max)
        dead = planes[6] < 0
        assert dead.any() and not dead.all()
        k = traversal_wide8.trace_kernel(accel, *planes, 1e-3, closest)
        p = traversal_wide8.trace_plain(accel, *planes, 1e-3, closest)
        torch.cuda.synchronize()
        if closest:
            assert (k[1] == p[1]).float().mean() >= 0.999
            assert (k[1][dead] < 0).all()
            same = (k[1] == p[1]) & (k[1] >= 0)
            torch.testing.assert_close(k[0][same], p[0][same], rtol=1e-4,
                                       atol=1e-5)
        else:
            assert (k == p).float().mean() >= 0.999
            assert not k[dead].any()


def test_path_traced_frame_matches_plain(cuda):
    """A 64x48 path_tracing frame (depth 5, jitter, sorted) through the
    kernels: five launches of K1 and K2 per frame, four of K7, and the
    plain frame's image (PSNR > 45)."""
    cfg = _path_cfg(64, 48)
    scene = bench_scene().build(cuda)
    accel = lbvh.build_bvh_sah(scene, leaf_size=32)
    cams = renderer.camera_arrays(Camera(**BENCH_CAM), cfg, cuda)
    before = (dict(traversal_wide8.LAUNCHES), dict(shade_kernel.LAUNCHES),
              bounce_kernel.LAUNCHES["sample_bounce"])
    img = renderer.render_frames(scene, accel, cams, 3, 1, cfg)
    assert traversal_wide8.LAUNCHES == {
        m: c + 5 for m, c in before[0].items()}
    assert shade_kernel.LAUNCHES == {m: c + 5 for m, c in before[1].items()}
    assert bounce_kernel.LAUNCHES["sample_bounce"] == before[2] + 4
    ref = renderer.render_frames(scene, accel, cams, 3, 1, cfg, plain=True)
    assert torch.isfinite(img).all()
    assert psnr(img[0].clamp(0, 4).cpu().numpy(),
                ref[0].clamp(0, 4).cpu().numpy(), peak=4.0) > 45.0


_STAGE_OUT = ("origin.x", "origin.y", "origin.z", "direction.x",
              "direction.y", "direction.z", "throughput.x", "throughput.y",
              "throughput.z", "seed", "active")


def _check_bounce(b: dict, roulette: bool):
    """K7 on one batch (sample_bounce's keyword arguments but the
    offset and the roulette flag): one launch, and every output equal to
    the plain version's bit for bit on every lane."""
    from test_torch_bounce import OFFSET, bits

    before = bounce_kernel.LAUNCHES["sample_bounce"]
    k = bounce_kernel.sample_bounce(**b, bounce_offset=OFFSET,
                                    roulette=roulette)
    assert bounce_kernel.LAUNCHES["sample_bounce"] == before + 1
    p = bounce_kernel.sample_bounce_plain(**b, bounce_offset=OFFSET,
                                          roulette=roulette)
    torch.cuda.synchronize()
    for name, kb, pb in zip(_STAGE_OUT, bits(k), bits(p)):
        assert torch.equal(kb, pb), \
            f"{name}: {int((kb != pb).sum())} of {kb.numel()} lanes differ"
    return k


def _stage_inputs(batch: dict) -> dict:
    """sample_bounce's inputs at one depth of trace_paths' _batches."""
    sh = batch["hits"]
    return dict(mat=sh.mat, n=sh.normal, view=sh.view,
                world_pos=sh.world_pos, throughput=batch["throughput"],
                seed=batch["seed"], entering=sh.entering, hit=sh.hit,
                active=batch["active"])


def test_bounce_kernel_matches_plain_on_frame_batches(cuda):
    """K7 on every bounce depth of a 64x48 path_tracing frame (sorted,
    depth 5: roulette off at depth 0, on from depth 1; most lanes of the
    late depths retired), its material planes strided rows of the
    attribute gather, bit for bit."""
    cfg = _path_cfg(64, 48)
    scene = bench_scene().build(cuda)
    accel = lbvh.build_bvh_sah(scene, leaf_size=32)
    cams = renderer.camera_arrays(Camera(**BENCH_CAM), cfg, cuda)
    batches = []
    renderer.render_rows(scene, accel, cams, 0, 48, cfg, frame=3,
                         _batches=batches)
    assert len(batches) == 5
    for depth, batch in enumerate(batches[:4]):
        b = _stage_inputs(batch)
        assert b["mat"].metallic.stride(0) > 1
        dead = ~batch["active"]
        assert (dead.any() or depth == 0) and batch["active"].any()
        _check_bounce(b, cfg.russian_roulette
                      and depth + 1 >= cfg.rr_start_depth)


@pytest.mark.parametrize("roulette", [False, True])
def test_bounce_kernel_matches_plain_through_glass(cuda, roulette):
    """K7 on the studio scene's depth-0 and depth-1 batches at 64x48
    (its glass: transmission 1, ior 1.5, so refraction, total internal
    reflection and the Fresnel choice all run; its textured floor: the
    color a fresh product), bit for bit; glass lanes both refract and
    reflect."""
    import chip_smoke
    from hrt_tpu_torch.models.scenefile import scene_from_dict

    cfg = RenderConfig(width=64, height=48, max_depth=3, sky=True,
                       indirect=True)
    scene = scene_from_dict(chip_smoke.STUDIO_SPEC).build(cuda)
    accel = lbvh.build_bvh_sah(scene, leaf_size=32)
    cams = renderer.camera_arrays(Camera(**chip_smoke.STUDIO_CAM), cfg,
                                  cuda)
    batches = []
    renderer.render_rows(scene, accel, cams, 0, 48, cfg, frame=2,
                         _batches=batches)
    into = out = 0
    for batch in batches[:2]:
        _, d, *_ = _check_bounce(_stage_inputs(batch), roulette)
        sh = batch["hits"]
        glass = sh.hit & (sh.mat.transmission > 0)
        cos = (d.x * sh.normal.x + d.y * sh.normal.y + d.z * sh.normal.z)
        into += int((cos[glass] < 0).sum())
        out += int((cos[glass] > 0).sum())
    assert into > 0 and out > 0


@pytest.mark.parametrize("strided", [True, False])
@pytest.mark.parametrize("roulette", [False, True])
def test_bounce_kernel_matches_plain_on_random_batches(cuda, strided,
                                                       roulette):
    """K7 on 65,573 seeded lanes (a ragged last block): metals, glass,
    anisotropic and near-zero roughness, grazing views, infinite world
    positions, throughputs below the retirement threshold, seed words 0
    and 0xFFFFFFFF; material planes strided or contiguous."""
    from test_torch_bounce import bounce_batch

    _check_bounce(bounce_batch(21, (1 << 16) + 37, cuda, strided=strided),
                  roulette)


def test_rng_bit_equal_on_card(cuda):
    """hash3, pcg, rand and pixel_seed on the card equal the CPU's, bit
    for bit, on words with 0 and 0xFFFFFFFF among them."""
    from hrt_tpu_torch.ops import rng

    w = torch.as_tensor(np.random.RandomState(8).randint(
        0, 2**32, size=1 << 16, dtype=np.uint64).astype(np.int64))
    w[:2] = torch.tensor([0, 0xFFFFFFFF])
    fns = (lambda a: rng.hash3(a, a.roll(1), a.flip(0)),
           lambda a: torch.stack(rng.pcg(a)),
           lambda a: rng.rand(a)[0].view(torch.int32),
           lambda a: rng.pixel_seed(a, a.roll(5), 0xFFFFFFFF))
    for fn in fns:
        assert torch.equal(fn(w.to(cuda)).cpu(), fn(w))


def _frame_vs_plain(cuda, sc, cfg, cam, want: dict):
    """A frame through the kernels, the launches it made (K1 closest, K1
    any hit, K2, K7) against `want`, and the same frame through the
    plain versions; returns (frame, plain frame)."""
    scene = sc.build(cuda)
    accel = lbvh.build_bvh_sah(scene, leaf_size=32)
    cams = renderer.camera_arrays(Camera(**cam), cfg, cuda)
    before = (traversal_wide8.LAUNCHES["closest"],
              traversal_wide8.LAUNCHES["any_hit"],
              shade_kernel.LAUNCHES["brdf_light_major"],
              bounce_kernel.LAUNCHES["sample_bounce"])
    img = renderer.render_frames(scene, accel, cams, 2, 1, cfg)[0]
    got = (traversal_wide8.LAUNCHES["closest"] - before[0],
           traversal_wide8.LAUNCHES["any_hit"] - before[1],
           shade_kernel.LAUNCHES["brdf_light_major"] - before[2],
           bounce_kernel.LAUNCHES["sample_bounce"] - before[3])
    assert got == want
    ref = renderer.render_frames(scene, accel, cams, 2, 1, cfg,
                                 plain=True)[0]
    assert torch.isfinite(img).all()
    assert psnr(img.clamp(0, 4).cpu().numpy(), ref.clamp(0, 4).cpu().numpy(),
                peak=4.0) > 45.0
    return img, ref


@pytest.mark.parametrize("sampler", ["cdf", "bvh"])
def test_sampled_nee_frame_matches_plain(cuda, sampler):
    """A 64x48 frame of many_lights_scene(40) with 2 light samples a ray
    by the flat CDF scan or the light tree: one K1 closest, one K1 any
    hit (over the 2-sample batch), one K2 (L = 2) and no K7 (depth 1),
    and the plain frame's image."""
    from hrt_tpu_torch.models.scene import many_lights_scene

    cfg = RenderConfig(width=64, height=48, max_depth=1, sky=True,
                       light_samples=2, light_sampler=sampler)
    _frame_vs_plain(cuda, many_lights_scene(40), cfg, BENCH_CAM,
                    (1, 1, 1, 0))


@pytest.mark.parametrize("brdf", ["disney", "pbr"])
def test_studio_frame_matches_plain(cuda, brdf):
    """scenes/studio.yaml (its textured floor) at 64x48, depth 3 with
    bounces, through the kernels against the plain frame: three depths
    of K1 and K2 and two bounces of K7; the pbr BSDF launches no K2."""
    import chip_smoke
    from hrt_tpu_torch.models.scenefile import scene_from_dict

    cfg = RenderConfig(width=64, height=48, max_depth=3, sky=True,
                       indirect=True, brdf=brdf)
    img, _ = _frame_vs_plain(cuda, scene_from_dict(chip_smoke.STUDIO_SPEC),
                             cfg, chip_smoke.STUDIO_CAM,
                             (3, 3, 0 if brdf == "pbr" else 3, 2))
    assert float(img.mean()) > 0.0


def test_cli_renders_on_the_card(cuda, tmp_path, capsys):
    """`python -m hrt_tpu_torch.render --scene demo --sky --stats`, in
    process and without --device: the card, one K1 closest, one K1 any
    hit and one K2 launch; the PNG is the file of the tonemapped
    FrameLoop step, byte for byte."""
    import json

    from hrt_tpu_torch import cli
    from hrt_tpu_torch.frameloop import FrameLoop
    from hrt_tpu_torch.models.scene import reference_demo_scene
    from hrt_tpu_torch.utils.image import encode_png, tonemap

    out = str(tmp_path / "f.png")
    before = (dict(traversal_wide8.LAUNCHES), dict(shade_kernel.LAUNCHES))
    loop = cli.main(["--scene", "demo", "--sky", "--stats", "--width",
                     "128", "--height", "96", "--out", out])
    assert loop.device.type == "cuda"
    assert traversal_wide8.LAUNCHES == {m: c + 1
                                        for m, c in before[0].items()}
    assert shade_kernel.LAUNCHES == {m: c + 1 for m, c in before[1].items()}
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["frames"] == 1 and stats["mrays_per_sec"] > 0
    ref = FrameLoop(reference_demo_scene(), loop.config,
                    cull_threshold_px=0.0, device=cuda)
    img = ref.step(Camera(position=(0.0, 0.0, -2.0)))
    with open(out, "rb") as f:
        assert f.read() == encode_png(tonemap(img.cpu().numpy()))


def test_bruteforce_frame_matches_k1_frame(cuda):
    """traversal='bruteforce' on the card (no walk launched) against the
    K1 frame of the same config, PSNR > 45."""
    from hrt_tpu_torch.models.scene import reference_demo_scene

    sc = reference_demo_scene()
    cfg = RenderConfig(width=160, height=120, max_depth=2, sky=True)
    acc = lbvh.build_bvh_sah(sc.build(cuda), leaf_size=32)
    before = dict(traversal_wide8.LAUNCHES)
    brute = renderer.render(sc, Camera(), RenderConfig(
        traversal="bruteforce", width=160, height=120, max_depth=2,
        sky=True), device=cuda)
    assert traversal_wide8.LAUNCHES == before
    k1 = renderer.render(sc, Camera(), cfg, acc)
    assert psnr(np.clip(brute, 0, 4), np.clip(k1, 0, 4), peak=4.0) > 45.0


def test_stacked_two_level_trace_matches_plain(cuda):
    """ops/twolevel.trace_two_level on the card walks each instance's
    BLAS with K3 (one launch per instance) and matches its plain walk on
    >= 0.99999 of rays."""
    from hrt_tpu_torch.ops import traversal_skip, twolevel

    sc = bench_scene()
    tl = twolevel.build_two_level(sc, 8)
    assert tl.nrm0.is_cuda
    o, d = _rays(11, 8192, cuda)
    before = dict(traversal_skip.LAUNCHES)
    kt, ki, ktri, _, _ = twolevel.trace_two_level(tl, o, d)
    torch.cuda.synchronize()
    assert traversal_skip.LAUNCHES["closest"] \
        == before["closest"] + len(sc.instances)
    pt, pi, ptri, _, _ = twolevel.trace_two_level(tl, o, d, plain=True)
    same = (ki == pi) & (ktri == ptri)
    assert float(same.float().mean()) >= 0.99999
    hit = same & (pi >= 0)
    assert float(hit.float().mean()) > 0.05
    assert float((kt - pt)[hit].abs().max()) <= 1e-4


@pytest.mark.parametrize("c,layout,grad", [
    *(pytest.param(c, layout, "randn", id=f"{c}-{layout}")
      for layout in ("hwc", "chw") for c in (1, 3, 10)),
    pytest.param(3, "chw", "masked", id="masked-3-chw"),
    pytest.param(3, "hwc", "nonfinite", id="nonfinite-3-hwc")])
def test_warp_backward_kernel_matches_plain(cuda, c, layout, grad):
    """K6's backward at a ragged size (a 37x29 grid, so the last tile is
    partial, from a 31x23 source) with coordinates on the edges, outside
    the image and at +-1e10 (clamped taps that coincide), from a
    contiguous image and a channels-first view: the kernel and the
    gradient through warp_bilinear (WarpBilinear) against autograd of the
    plain warp, each element within 1e-5 of its terms' absolute sum
    (float atomics add in an order that changes from run to run), one
    backward launch, a contiguous result.  `grad`: a normal gradient;
    "masked", zero over every clamped pixel and over a block of the grid
    (as the trainer masks sky and off-image pixels), so the kernel drops
    those adds; "nonfinite", NaN, +Inf and -Inf at clamped, coincident
    and inner pixels, which must land exactly where the plain adjoint
    puts them (NaN for NaN, Inf of the same sign for Inf)."""
    from hrt_tpu_torch.ops import warp_kernel

    rs = np.random.RandomState(17 + c)
    hs, ws, ho, wo = 23, 31, 29, 37
    src = rs.uniform(-2, 2, (hs, ws, c)).astype(np.float32)
    if layout == "hwc":
        img = torch.as_tensor(src, device=cuda)
    else:
        img = torch.as_tensor(np.ascontiguousarray(src.transpose(2, 0, 1)),
                              device=cuda).permute(1, 2, 0)
    px = rs.uniform(-4, ws + 3, (ho, wo)).astype(np.float32)
    py = rs.uniform(-4, hs + 3, (ho, wo)).astype(np.float32)
    px[0], py[:, 0] = 0.0, 0.0
    px[1], py[:, 1] = ws - 1.0, hs - 1.0
    px[::5, ::3] = 1e10
    py[::7, ::2] = -1e10
    gv = rs.normal(0, 1, (ho, wo, c)).astype(np.float32)
    if grad == "masked":
        gv[(px < 0) | (px > ws - 1) | (py < 0) | (py > hs - 1)] = 0.0
        gv[4:20, 6:30] = 0.0
    elif grad == "nonfinite":
        gv[0, 5, 0] = np.nan      # px 0: clamped onto the left edge
        gv[5, 3, 1] = np.inf      # px 1e10: coincident clamped taps
        gv[6, 4, 2] = -np.inf     # py -1e10
        gv[12, 17, 0] = np.inf
        gv[12, 17, 2] = np.nan
    px, py, gv = (torch.as_tensor(a, device=cuda) for a in (px, py, gv))
    leaf = img.detach().clone().requires_grad_(True)
    plain = warp_kernel.warp_bilinear_plain(leaf, px, py)[0]
    (pg,) = torch.autograd.grad(plain, leaf, gv, retain_graph=True)
    mag = torch.where(torch.isfinite(gv), gv.abs(), 0.0)
    (scale,) = torch.autograd.grad(plain, leaf, mag)
    before = warp_kernel.LAUNCHES["warp_bilinear_backward"]
    kg = warp_kernel.warp_bilinear_backward_kernel(gv, px, py, hs, ws)
    val, valid = warp_kernel.warp_bilinear(leaf, px, py)
    assert val.grad_fn is not None and not valid.requires_grad
    (fg,) = torch.autograd.grad(val, leaf, gv)
    torch.cuda.synchronize()
    assert warp_kernel.LAUNCHES["warp_bilinear_backward"] == before + 2
    assert kg.shape == (hs, ws, c) and kg.is_contiguous()
    fin = torch.isfinite(pg)
    assert bool(fin.all()) == (grad != "nonfinite")
    for got in (kg, fg):
        for where in (torch.isnan, torch.isposinf, torch.isneginf):
            assert torch.equal(where(got), where(pg))
        assert ((got - pg).abs()[fin] <= 1e-5 * scale[fin]).all()
    if grad == "masked":
        assert int((gv == 0).all(-1).sum()) > ho * wo // 3


def test_warp_without_image_grad_launches_no_backward(cuda):
    """A warp whose image needs no gradient (the frame loop's) records
    no graph and never launches the backward."""
    from hrt_tpu_torch.ops import warp_kernel

    img = torch.rand(16, 24, 3, device=cuda)
    px = torch.rand(8, 12, device=cuda) * 23
    py = torch.rand(8, 12, device=cuda) * 15
    before = dict(warp_kernel.LAUNCHES)
    val, _ = warp_kernel.warp_bilinear(img, px, py)
    assert val.grad_fn is None
    assert warp_kernel.LAUNCHES == {**before, "warp_bilinear":
                                    before["warp_bilinear"] + 1}


def test_recurrent_step_on_the_card_matches_plain(cuda):
    """One recurrent unroll of a 3-frame bench orbit (64x64 -> 128x128)
    on the card: through K6 and its backward against the plain warp
    (`plain=True`), loss within rtol 1e-5 and each gradient within 1e-4
    of its tensor's largest entry; two backward launches; detaching the
    warped history moves the gradient."""
    from hrt_tpu_torch import train_upscaler
    from hrt_tpu_torch.models import upscaler
    from hrt_tpu_torch.ops import warp_kernel

    seq = train_upscaler.render_sequence(3, size=(128, 128), clean_spp=2,
                                         device=cuda)
    net, _ = upscaler.create_temporal(seed=4, device=cuda)

    def grads(plain):
        net.zero_grad(set_to_none=True)
        with upscaler.fp32_convs():
            loss = train_upscaler.recurrent_loss(net, *seq, plain=plain)
            loss.backward()
        return float(loss.detach()), [p.grad.clone()
                                      for p in net.parameters()]

    before = warp_kernel.LAUNCHES["warp_bilinear_backward"]
    lk, gk = grads(False)
    assert warp_kernel.LAUNCHES["warp_bilinear_backward"] == before + 2
    lp, gp = grads(True)
    assert abs(lk - lp) <= 1e-5 * abs(lp)
    for a, b in zip(gk, gp):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    orig = upscaler.reproject_history
    upscaler.reproject_history = \
        lambda hist, *a, **k: orig(hist.detach(), *a, **k)
    try:
        _, gd = grads(False)
    finally:
        upscaler.reproject_history = orig
    assert max(float((a - b).abs().max() / a.abs().max())
               for a, b in zip(gk, gd)) > 1e-3


def test_train_step_on_the_card_matches_cpu(cuda):
    """The spatial and the temporal loss and gradients from the same
    seed and batch on the card (float32 convolutions: TF32 off inside
    `fp32_convs`, restored after) and on the CPU: loss within rtol 1e-5,
    each gradient within 1e-4 of its tensor's largest entry.  Control:
    the card's gradients with TF32 on leave that bound for at least one
    tensor, so the bound tells float32 from TF32.  Then one train step
    on the card moves every parameter and leaves the TF32 setting as it
    was."""
    from hrt_tpu_torch.models import upscaler

    rs = np.random.RandomState(21)
    hr = rs.uniform(0, 2, (4, 32, 32, 3)).astype(np.float32)
    hist = np.concatenate([hr, np.ones((4, 32, 32, 1), np.float32)], -1)
    prev = torch.backends.cudnn.allow_tf32

    def rel_errs(ga, gb):
        return [float((a - b).abs().max()) / float(a.abs().max())
                for a, b in zip(ga, gb)]

    for make, loss_fn, step, extra in (
            (upscaler.create, upscaler._loss_fn, upscaler.train_step, ()),
            (upscaler.create_temporal, upscaler._loss_fn_temporal,
             upscaler.train_step_temporal, (hist,))):
        def grads(dev, fp32=True):
            net, opt = make(seed=6, lr=2e-3, device=dev)
            t = lambda a: torch.as_tensor(a, device=dev)
            batch = (upscaler.downsample2(t(hr)), *map(t, extra), t(hr))
            with (upscaler.fp32_convs() if fp32 else contextlib.nullcontext()):
                loss = loss_fn(net, *batch)
                loss.backward()
            return (float(loss.detach()),
                    [p.grad.cpu() for p in net.parameters()], net, opt,
                    batch)

        lc, gc, *_ = grads("cpu")
        lg, gg, net, opt, batch = grads(cuda)
        assert abs(lc - lg) <= 1e-5 * abs(lc)
        assert max(rel_errs(gc, gg)) <= 1e-4
        torch.backends.cudnn.allow_tf32 = True
        try:
            _, gt, *_ = grads(cuda, fp32=False)
        finally:
            torch.backends.cudnn.allow_tf32 = prev
        assert max(rel_errs(gc, gt)) > 1e-4
        before = [p.detach().clone() for p in net.parameters()]
        assert np.isfinite(float(step(net, opt, *batch)))
        assert all(float((p.detach() - q).abs().max()) > 1e-4
                   for p, q in zip(net.parameters(), before))
    assert torch.backends.cudnn.allow_tf32 == prev


@pytest.fixture
def nccl_group(cuda, tmp_path):
    """A one-rank NCCL group on the card, destroyed after the test."""
    import torch.distributed as dist

    from hrt_tpu_torch.parallel import tiles

    tiles.init_group(cuda, 1, 0, f"file://{tmp_path}/store")
    yield tiles.make_mesh(1)
    dist.destroy_process_group()


def test_world_one_tiled_frame_is_the_frame(nccl_group):
    """render_frame_tiled over a one-rank NCCL group: the whole frame
    through the same kernels, bit for bit, with and without the
    G-buffer; FrameLoop(mesh) with the post stages equal to the loop
    without one."""
    from hrt_tpu_torch.frameloop import FrameLoop
    from hrt_tpu_torch.parallel import tiles

    dev = tiles.mesh_device(nccl_group)
    cfg = RenderConfig(width=128, height=96, max_depth=1, sky=True)
    scene = bench_scene().build(dev)
    accel = lbvh.build_bvh_sah(scene, leaf_size=32)
    cams = renderer.camera_arrays(Camera(**BENCH_CAM), cfg, dev)
    before = traversal_wide8.LAUNCHES["closest"]
    img = tiles.render_frame_tiled(scene, accel, cams, 0, cfg, nccl_group)
    assert traversal_wide8.LAUNCHES["closest"] == before + 1
    assert torch.equal(img, renderer.render_rows(scene, accel, cams, 0, 96,
                                                 cfg))
    img, gb = tiles.render_frame_tiled(scene, accel, cams, 0, cfg,
                                       nccl_group, want_gbuffer=True)
    _, want = renderer.render_rows(scene, accel, cams, 0, 96, cfg,
                                   want_gbuffer=True)
    assert all(torch.equal(gb[k], want[k]) for k in want)
    post = RenderConfig(width=128, height=96, max_depth=1, sky=True,
                        denoise=True, accumulate=True, upscale=2,
                        upscale_mode="temporal")
    a = FrameLoop(bench_scene(), post, mesh=nccl_group)
    b = FrameLoop(bench_scene(), post, device=dev)
    for f in range(2):
        cam = Camera(position=(0.03 * f, -1.0, -6.0),
                     rotation=(-0.15, 0.0, 0.0))
        assert torch.equal(a.step(cam), b.step(cam))


def test_sharded_combine_matches_whole_soup(cuda):
    """The bench soup in 4 shard LBVHs, each walked by K3 on the card,
    combined: the whole soup's LBVH walked by K3, ids on >= 0.999 of
    the rays and t within 1e-5 where they agree."""
    from hrt_tpu_torch.ops import traversal, traversal_skip
    from hrt_tpu_torch.parallel import scene_shard

    scene = bench_scene().build(cuda, pad=4 * 128)
    sharded, accs = scene_shard.build_sharded_accel(scene, 4, leaf_size=8)
    o, d = _rays(5, 4093, cuda)
    before = traversal_skip.LAUNCHES["closest"]
    hits = [scene_shard.shard_closest_hit(a, o, d, s,
                                          sharded.tri_v0.shape[1])
            for s, a in enumerate(accs)]
    assert traversal_skip.LAUNCHES["closest"] == before + 4
    t, tri, _, _ = scene_shard.combine_hits(
        *(torch.stack(h) for h in zip(*hits)))
    wt, wtri, _, _ = traversal.closest_hit_bvh_p(
        None, lbvh.build_bvh(scene, 8), V3(*o.unbind(-1)),
        V3(*d.unbind(-1)), 1e-3, 1e32)
    same = tri == wtri
    assert same.float().mean().item() >= 0.999
    hit = same & (tri >= 0)
    assert hit.float().mean().item() > 0.3
    torch.testing.assert_close(t[hit], wt[hit], rtol=1e-5, atol=0)


def corrupt_w8(rec: np.ndarray, how: str) -> np.ndarray:
    """The JAX package's guard-test corruptions (tests/test_wide8.py) of
    an (R, 8, 128) BVH8 record table, on a copy: the root's base far out
    of range ("base", bit 1), the first live leaf slot's meta past the
    pool ("leaf", bit 4), or the leaf_base word of that node that only
    JAX's pack mode reads ("pack": the port's walks never read it)."""
    rec = rec.copy()
    if how == "base":
        rec[0, 0, 7] = 1 << 14
        return rec
    metas = rec[:, :, 6::8]
    bminx = np.ascontiguousarray(rec[:, :, 0::8]).view(np.float32)
    live = (metas > 0) & (bminx < 1e30)
    r_, s_, q_ = [int(a[0]) for a in np.nonzero(live)]
    if how == "pack":
        rec[r_, 1, q_ * 8 + 7] = 1 << 24
    else:
        rec[r_, s_, q_ * 8 + 6] = 1 << 16
    return rec


@pytest.fixture
def debug_off(monkeypatch):
    """The debug builds off, no pending guard words before or after."""
    from hrt_tpu_torch.ops import intersect

    monkeypatch.setattr(traversal_wide8, "GUARDS", False)
    monkeypatch.setattr(intersect, "DEBUG_COUNTERS", False)
    traversal_wide8._pending_guards.clear()
    yield monkeypatch
    traversal_wide8._pending_guards.clear()


@pytest.mark.parametrize("how", ["base", "leaf", "depth"])
def test_k1_guards_raise_and_the_context_survives(cuda, debug_off, how):
    """The guarded K1 on a corrupt table (the root's base, a leaf's
    start, a w8_depth below the tree's) records the JAX kernel's bit for
    it in both modes and raises through check_pending_guards; the next
    normal launch in the process still runs and equals its plain walk
    (no sticky CUDA error, no other warp's stack overwritten)."""
    import dataclasses

    scene = bench_scene().build(cuda)
    accel = lbvh.build_bvh_sah(scene, leaf_size=8)
    if how == "depth":
        bad = dataclasses.replace(accel, w8_depth=0)
    else:
        w8 = torch.as_tensor(corrupt_w8(accel.w8.cpu().numpy(), how),
                             device=cuda)
        bad = dataclasses.replace(accel, w8=w8,
                                  w8_rec=wide8.node_records(w8))
    o, d = _rays(3, 4093, cuda)
    bit = {"base": traversal_wide8.NODE_ID, "leaf": traversal_wide8.LEAF_START,
           "depth": traversal_wide8.STACK_OVERFLOW}[how]
    debug_off.setattr(traversal_wide8, "GUARDS", True)
    for closest in (True, False):
        tmax = torch.full((4093,), 1e32 if closest else 5.0, device=cuda)
        planes = (*o.T.contiguous(), *d.T.contiguous(), tmax)
        mode = "closest" if closest else "any_hit"
        before = traversal_wide8.DEBUG_LAUNCHES[mode]
        traversal_wide8.trace_kernel(bad, *planes, 1e-3, closest)
        assert traversal_wide8.DEBUG_LAUNCHES[mode] == before + 1
        with pytest.raises(RuntimeError, match="guard violation") as err:
            traversal_wide8.check_pending_guards()
        mask = int(str(err.value).split("mask ")[1].split(":")[0], 16)
        assert mask & bit, str(err.value)
    torch.cuda.synchronize()
    debug_off.setattr(traversal_wide8, "GUARDS", False)
    planes = (*o.T.contiguous(), *d.T.contiguous(),
              torch.full((4093,), 1e32, device=cuda))
    k = traversal_wide8.trace_kernel(accel, *planes, 1e-3, True)
    p = traversal_wide8.trace_plain(accel, *planes, 1e-3, True)
    torch.cuda.synchronize()
    assert (k[1] == p[1]).float().mean().item() >= 0.999


def _debug_case(cuda, walk: str, closest: bool):
    """(module, table, planes) of a walk with a debug build: K1 on the
    bench scene's 8-triangle SAH tree, K3 on its LBVH, K4 on the test_tlas
    scene; 4093 rays (a partial last warp), every 13th dead."""
    from hrt_tpu_torch.ops import traversal_skip

    if walk == "k4":
        mod = traversal_tlas8
        table = tlas.build_two_level_flat(_instanced_scene(), 8, device=cuda)
    else:
        scene = bench_scene().build(cuda)
        mod = traversal_wide8 if walk == "k1" else traversal_skip
        table = (lbvh.build_bvh_sah(scene, leaf_size=8) if walk == "k1"
                 else lbvh.build_bvh(scene, 32))
    o, d = _rays(11, 4093, cuda)
    tmax = torch.full((4093,), 1e32 if closest else 4.0, device=cuda)
    tmax[::13] = -1.0
    return mod, table, (*o.T.contiguous(), *d.T.contiguous(), tmax)


@pytest.mark.parametrize("closest", [True, False])
@pytest.mark.parametrize("walk", ["k1", "k3", "k4"])
def test_debug_builds_equal_the_normal_builds(cuda, debug_off, walk,
                                              closest):
    """With counters on (and K1's guards), each walk launches its debug
    build once: its outputs equal the normal build's bit for bit, no
    guard fires, and LAST_COUNTERS holds this launch's counts.  K3 and
    K4's any hit walk a ray per lane in the plain walk's order: their
    per-ray counts equal visit_counts on the rays whose hits equal the
    plain walk's, all but at most 1 in 10,000 of them (a ray that met a
    triangle within rounding of an edge, which the kernel's
    division-free test and Möller-Trumbore decide apart, may reach the
    same hit by another path).  K1 and K4's closest packets: no lane
    counts more node and leaf visits than its warp's packet items, and
    the lanes test at least as many boxes and triangles as the plain
    walks of their rays in the kernel's order, in sum."""
    from hrt_tpu_torch.ops import intersect

    mod, table, planes = _debug_case(cuda, walk, closest)
    mode = "closest" if closest else "any_hit"
    want = mod.trace_kernel(table, *planes, 1e-3, closest)
    debug_off.setattr(intersect, "DEBUG_COUNTERS", True)
    if walk == "k1":
        debug_off.setattr(traversal_wide8, "GUARDS", True)
    before = (mod.LAUNCHES[mode], mod.DEBUG_LAUNCHES[mode])
    got = mod.trace_kernel(table, *planes, 1e-3, closest)
    torch.cuda.synchronize()
    assert (mod.LAUNCHES[mode], mod.DEBUG_LAUNCHES[mode]) \
        == (before[0], before[1] + 1)
    traversal_wide8.check_pending_guards()
    outs = zip(got, want) if closest else [(got, want)]
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in outs)
    cnt = mod.LAST_COUNTERS
    n, nw = planes[0].numel(), -(-planes[0].numel() // 32)
    warp_names = mod.WARP_COUNTS[closest] if walk == "k4" \
        else mod.WARP_COUNTS
    assert all(cnt[k].shape == (n,) and (cnt[k][::13] == 0).all()
               for k in mod.COUNTS)
    assert all(cnt["warp_" + k].shape == (nw,) for k in warp_names)
    plain = mod.visit_counts(table, *planes, 1e-3, closest,
                             **({} if walk == "k3" else {"nearest": closest}))
    plain.pop("hits", None)
    if walk == "k3" or (walk == "k4" and not closest):
        p = mod.trace_plain(table, *planes, 1e-3, closest)
        same = got[1] == p[1] if closest else got == p
        assert same.float().mean().item() >= 0.999
        diff = sum(cnt[k].long() != plain[k] for k in mod.COUNTS).bool()
        assert int((diff & same).sum()) <= -(-int(same.sum()) // 10000)
        return
    lane_max = lambda k: cnt[k][:n // 32 * 32].view(-1, 32).amax(1)
    for k in set(mod.COUNTS) & set(warp_names):
        assert (lane_max(k) <= cnt["warp_" + k][:n // 32]).all(), k
    work = lambda c: sum(int(c[k].sum()) for k in mod.COUNTS
                         if "boxes" in k or k == "tests")
    assert work(cnt) >= work(plain) > 0


def _profile_frame_setup(cuda):
    cfg = RenderConfig(width=256, height=192, max_depth=1, sky=True)
    scene = bench_scene().build(cuda)
    accel = lbvh.build_bvh_sah(scene, leaf_size=32)
    cams = renderer.camera_arrays(Camera(**BENCH_CAM), cfg, cuda)
    return scene, accel, cams, cfg


def test_device_ms_per_call_times_k1(cuda):
    """The profiler sees the ctypes launch of K1 (no CPU op parent) and
    gives its device time."""
    from hrt_tpu_torch.utils import profiling

    scene, accel, cams, cfg = _profile_frame_setup(cuda)
    o, d = renderer.primary_rays(cams, cfg.height, 0, cfg)
    planes = (*o, *d, torch.full_like(o.x, 1e32))
    ms = profiling.device_ms_per_call(
        lambda: traversal_wide8.trace_kernel(accel, *planes, 1e-3, True),
        calls=4, device=cuda)
    assert 0.0 < ms < 50.0


def test_device_op_totals_name_the_port_kernels(cuda):
    """A profiled bench frame: K1's and K2's symbols among the device
    ops, labelled by their C entries; the busy share is a union in
    (0, 1]."""
    from hrt_tpu_torch.utils import profiling

    scene, accel, cams, cfg = _profile_frame_setup(cuda)
    prof, wall = profiling.profile_calls(
        lambda: renderer.render_frames(scene, accel, cams, 0, 1, cfg), 2,
        cuda)
    total, ops = profiling.device_op_totals(prof)
    labels = [(profiling.op_label(k), c) for k, (_, c) in ops.items()]
    k1 = [(k, c) for k, c in labels if k.startswith("hrt_bvh8_trace:")]
    k2 = [c for k, c in labels if k.startswith("hrt_brdf_light_major:")]
    # Closest and any hit, one launch each a frame: two instantiations.
    assert len(k1) == 2 and [c for _, c in k1] == [2, 2]
    assert sum(k2) == 2
    assert 0.0 < total and 0.0 < profiling.busy_share(prof, wall) <= 1.0


# ---- the captured frame programs (hrt_tpu_torch/graphs.py) -----------

def _bits_equal(a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def _launches():
    from hrt_tpu_torch import graphs

    return [dict(c) for c in graphs.launch_counters()]


def test_render_frames_graph_is_bit_equal_to_eager(cuda):
    """render_frames(k=4) with jitter: the replayed graph bit for bit the
    same body op by op (graphs.disable()), with the same launches; one
    capture for the key; a returned batch unchanged after the next
    replay."""
    import dataclasses

    from hrt_tpu_torch import graphs

    cfg = dataclasses.replace(RenderConfig(width=128, height=96,
                                           max_depth=2, sky=True),
                              indirect=True, jitter=True)
    scene = bench_scene().build(cuda)
    accel = lbvh.build_bvh_sah(scene, leaf_size=32)
    cams = renderer.camera_arrays(Camera(**BENCH_CAM), cfg, cuda)
    caps = renderer.FRAME_PROGRAMS.captures
    renderer.render_frames(scene, accel, cams, 0, 4, cfg)   # captures
    assert renderer.FRAME_PROGRAMS.captures == caps + 1
    for frame0 in (0, 4):
        with graphs.disable():
            before = _launches()
            want = renderer.render_frames(scene, accel, cams, frame0, 4, cfg)
            eager = [{k: c[k] - b[k] for k in c}
                     for c, b in zip(_launches(), before)]
        before = _launches()
        got = renderer.render_frames(scene, accel, cams, frame0, 4, cfg)
        torch.cuda.synchronize()
        assert [{k: c[k] - b[k] for k in c}
                for c, b in zip(_launches(), before)] == eager
        assert _bits_equal(got, want)
        if frame0 == 0:
            first, kept = got, got.clone()
    assert _bits_equal(first, kept)
    assert renderer.FRAME_PROGRAMS.captures == caps + 1


def test_post_loop_graph_is_bit_equal_to_eager(cuda):
    """Four steps of a post loop (accumulate, jitter, SVGF, the temporal
    upscaler): each captured step and the loop's state bit for bit an
    op-by-op loop's; one capture; every returned frame unchanged after
    the later steps."""
    from hrt_tpu_torch import graphs
    from hrt_tpu_torch.frameloop import FrameLoop

    cfg = RenderConfig(width=96, height=64, max_depth=1, sky=True,
                       jitter=True, accumulate=True, denoise=True,
                       upscale=2, upscale_mode="temporal")
    graphed = FrameLoop(bench_scene(), cfg, device=cuda)
    eager = FrameLoop(bench_scene(), cfg, device=cuda)
    kept = []
    for f in range(4):
        with graphs.disable():
            want = eager.step(_post_cam(f))
        got = graphed.step(_post_cam(f))
        torch.cuda.synchronize()
        assert _bits_equal(got, want)
        for a, b in zip([*graphed.dn_state, graphed.accum,
                         graphed.up_history],
                        [*eager.dn_state, eager.accum, eager.up_history]):
            assert _bits_equal(a, b)
        kept.append((got, got.clone()))
    assert all(_bits_equal(a, b) for a, b in kept)
    assert graphed.captures == 1 and eager.captures == 0


def test_traced_loop_is_bit_equal_and_its_stage_clocks_read_the_frame(cuda):
    """A path-traced loop with the program's tracing on
    (utils/tracing.py): each captured step and its state bit for bit an
    untraced loop's; the traced graph holds the stage clocks and counters
    as extra nodes, the untraced graph none; the stage ms are positive
    and sum to the first-to-last mark, within the CUDA events' frame
    time; live.d0 is every pixel and the later depths fewer."""
    import dataclasses

    from hrt_tpu_torch.config import CONFIGS
    from hrt_tpu_torch.frameloop import FrameLoop
    from hrt_tpu_torch.utils import tracing

    cfg = dataclasses.replace(CONFIGS["path_tracing"], width=128,
                              height=96, accumulate=True)
    cam = Camera(**BENCH_CAM)
    plain = FrameLoop(bench_scene(), cfg, cull_threshold_px=0.0,
                      device=cuda)
    traced = FrameLoop(bench_scene(), cfg, cull_threshold_px=0.0,
                       device=cuda)
    tracing.reset()
    event_ms = []
    try:
        for f in range(4):
            tracing.disable()
            want = plain.step(cam)
            tracing.enable()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            got = traced.step(cam)
            b.record()
            torch.cuda.synchronize()
            event_ms.append(a.elapsed_time(b))
            assert _bits_equal(got, want)
            assert _bits_equal(traced.accum, plain.accum)
        snap = tracing.snapshot()
    finally:
        tracing.disable()
        tracing.reset()
    marks = 1 + 3 * cfg.max_depth - 1 + 2     # raygen .. accumulate, end
    assert (plain.program.last.graph.nodes + marks + cfg.max_depth
            <= traced.program.last.graph.nodes)
    assert snap["frames"] == 4 and "host_stage_ms" not in snap
    st = snap["stage_ms"]
    assert len(st) == marks - 1 and all(v > 0 for v in st.values())
    assert sum(st.values()) == pytest.approx(snap["frame_ms"])
    assert snap["frame_ms"] < sum(event_ms) / len(event_ms)
    live = [snap["counts"][f"live.d{k}"] for k in range(cfg.max_depth)]
    assert live[0] == cfg.width * cfg.height and live[-1] < live[0]


def test_capture_failure_raises_and_only_the_listed_cases_go_op_by_op(
        cuda, monkeypatch):
    """A body with a host sync raises at its capture (nothing retried op
    by op) and the card works on; a CUDA FrameLoop step captures, and
    plain=True, graphs.disable() and the guarded build do not."""
    from hrt_tpu_torch import graphs
    from hrt_tpu_torch.frameloop import FrameLoop

    def bad(x, frame):
        return x * float(x.sum())

    progs = graphs.Programs(1)
    with pytest.raises(RuntimeError):
        progs("bad", bad, (torch.ones(8, device=cuda), 0), cuda)
    assert progs.captures == 0
    torch.cuda.synchronize()
    cfg = RenderConfig(width=64, height=48, max_depth=1, sky=True)
    loop = FrameLoop(bench_scene(), cfg, device=cuda)
    loop.step(Camera(**BENCH_CAM))
    assert loop.captures == 1 and loop.program.last.graph.nodes > 0
    loop.step(Camera(**BENCH_CAM), plain=True)
    with graphs.disable():
        loop.step(Camera(**BENCH_CAM))
    monkeypatch.setattr(traversal_wide8, "GUARDS", True)
    loop.step(Camera(**BENCH_CAM))
    traversal_wide8.check_pending_guards()
    monkeypatch.setattr(traversal_wide8, "GUARDS", False)
    loop.step(Camera(**BENCH_CAM))
    assert loop.captures == 1


# ---- the device-side builds: refit and culling rebuild programs --------

_REFIT_FIELDS = ("nodes", "skip_rec", "w8_nodes", "w8_rec", "world_from_obj",
                 "obj_from_world", "normal_mat")


def _tables_equal(a, b) -> bool:
    return all((getattr(a, k) is None) == (getattr(b, k) is None)
               and (getattr(a, k) is None
                    or _bits_equal(getattr(a, k), getattr(b, k)))
               for k in _REFIT_FIELDS) and a.tlas_depth == b.tlas_depth


@pytest.mark.parametrize("route", ["k4", "k5"])
def test_refit_program_is_bit_equal_to_op_by_op(cuda, route):
    """Three moves through tlas.set_instance: the replayed refit program
    (one capture) against the same body op by op (plain=True) on a copy
    of the table, bit for bit; the moved instance found where it went by
    the route's kernel."""
    import dataclasses

    from hrt_tpu_torch import graphs
    from hrt_tpu_torch.models.instance import MeshInstance

    sc = instance_grid_scene(4)
    bound = dict(max_wide_nodes=32) if route == "k5" else {}
    graphed = tlas.build_two_level_flat(sc, 32, device=cuda, **bound)
    eager = dataclasses.replace(graphed, **{
        k: getattr(graphed, k).clone() for k in _REFIT_FIELDS
        if getattr(graphed, k) is not None})
    assert (graphed.w8_nodes is None) == (route == "k5")
    progs = graphs.Programs(1)
    for f, idx in enumerate((1, 5, 1)):
        cur = sc.instances[idx]
        new = MeshInstance(cur.mesh_id, cur.material_id,
                           (0.3 * f, -2.0 - f, 0.5), (0.2 * f, 0.1, 0.0),
                           cur.scale)
        mats = (new.transform, new.inverse_transform, new.normal_matrix)
        graphed = tlas.set_instance(graphed, idx, *mats, programs=progs)
        eager = tlas.set_instance(eager, idx, *mats, programs=progs,
                                  plain=True)
        torch.cuda.synchronize()
        assert _tables_equal(graphed, eager), f
    assert progs.captures == 1 and progs.last.graph.nodes > 0
    o = torch.tensor([[0.6, -4.0, -5.0]], device=cuda)
    d = torch.tensor([[0.0, 0.0, 1.0]], device=cuda)
    hit = tlas.closest_hit_tlas(graphed, V3(*o.unbind(-1)),
                                V3(*d.unbind(-1)), 1e-3, 1e32)
    assert int(hit[2][0]) == 1


@pytest.mark.parametrize("route", ["k4", "k5"])
def test_a_traced_refit_is_clocked_on_the_card(cuda, route):
    """Three moves on two copies of one table, one untraced and one
    traced: the tables bit for bit and the refit graphs' nodes equal;
    the traced side's `refit` clock holds three replays' device ms under
    `clock_ms`, never a stage, and its spans count three moves."""
    import dataclasses

    from hrt_tpu_torch import graphs
    from hrt_tpu_torch.models.instance import MeshInstance
    from hrt_tpu_torch.utils import tracing

    sc = instance_grid_scene(4)
    bound = dict(max_wide_nodes=32) if route == "k5" else {}
    off = tlas.build_two_level_flat(sc, 32, device=cuda, **bound)
    on = dataclasses.replace(off, **{
        k: getattr(off, k).clone() for k in _REFIT_FIELDS
        if getattr(off, k) is not None})
    p_off, p_on = graphs.Programs(1), graphs.Programs(1)
    tracing.reset()
    try:
        for f, idx in enumerate((1, 5, 1)):
            cur = sc.instances[idx]
            new = MeshInstance(cur.mesh_id, cur.material_id,
                               (0.3 * f, -2.0 - f, 0.5), (0.2 * f, 0.1, 0.0),
                               cur.scale)
            mats = (new.transform, new.inverse_transform, new.normal_matrix)
            tracing.disable()
            off = tlas.set_instance(off, idx, *mats, programs=p_off)
            tracing.enable()
            on = tlas.set_instance(on, idx, *mats, programs=p_on)
            torch.cuda.synchronize()
            assert _tables_equal(off, on), f
        snap = tracing.snapshot()
    finally:
        tracing.disable()
        tracing.reset()
    assert p_off.last.graph.nodes == p_on.last.graph.nodes
    refit = snap["clock_ms"]["refit"]
    assert refit["count"] == 3 and refit["total_ms"] > 0
    assert "host_clock_ms" not in snap
    assert "refit" not in snap.get("stage_ms", {})
    for name in ("tlas.copy_in", "tlas.refit"):
        assert snap["spans"][name]["count"] == 3


def test_culled_loop_captures_once_over_rebuilds(cuda):
    """Four orbit steps of the culled grid at 128x96, each rebuilding:
    one frame capture and one build capture; the rebuilt accel bit for
    bit a fresh build_bvh over the loop's mask, the frames an op-by-op
    loop's."""
    from hrt_tpu_torch import graphs
    from hrt_tpu_torch.frameloop import FrameLoop
    from hrt_tpu_torch.models.camera import orbit_camera
    from hrt_tpu_torch.ops import culling

    cfg = RenderConfig(width=128, height=96, max_depth=1, sky=True)
    graphed = FrameLoop(instance_grid_scene(), cfg, device=cuda)
    eager = FrameLoop(instance_grid_scene(), cfg, device=cuda)
    for f in range(4):
        cam = orbit_camera(0.15 * f, radius=4.0, height=-1.0)
        with graphs.disable():
            want = eager.step(cam)
        got = graphed.step(cam)
        torch.cuda.synchronize()
        assert _bits_equal(got, want) and graphed.rebuilds == f + 1
    assert graphed.captures == 1 and graphed.builds.captures == 1
    mask = culling.triangle_mask(graphed.visible, graphed.scene.tri_inst,
                                 graphed.scene.tri_valid)
    fresh = lbvh.build_bvh(graphed.scene, graphed.leaf_size, mask)
    for k in lbvh._REBUILT:
        a, b = getattr(graphed.accel, k), getattr(fresh, k)
        assert torch.equal(_bits(a), _bits(b)), k


def test_refit_that_k4_cannot_walk_raises(cuda, monkeypatch):
    """A refit whose TLAS needs more stack than K4 holds raises
    ValueError, and the table and the instance's matrices stay as they
    were."""
    import dataclasses

    from hrt_tpu_torch import graphs
    from hrt_tpu_torch.models.instance import MeshInstance

    sc = instance_grid_scene(4)
    tl = tlas.build_two_level_flat(sc, 32, device=cuda)
    before = dataclasses.replace(tl, **{
        k: getattr(tl, k).clone() for k in _REFIT_FIELDS
        if getattr(tl, k) is not None})
    monkeypatch.setattr(traversal_tlas8, "MAX_STACK", tl.stack - 1)
    new = MeshInstance(0, 0, (1.0, 2.0, 3.0))
    with pytest.raises(ValueError, match="K4 holds"):
        tlas.set_instance(tl, 3, new.transform, new.inverse_transform,
                          new.normal_matrix, programs=graphs.Programs(1))
    torch.cuda.synchronize()
    assert _tables_equal(tl, before)


# ---- training programs (graphs.Programs with grad) --------------------

def _train_state(opt) -> list:
    """Every tensor a training step writes."""
    return [*opt.params, *opt.grads, *opt.mu, *opt.nu, opt.count]


def _state_diff(a, b) -> float:
    return max(float((x.detach().float() - y.detach().float()).abs().max())
               for x, y in zip(_train_state(a), _train_state(b)))


@pytest.mark.parametrize("kind", ["spatial", "temporal", "recurrent",
                                  "spatial/deterministic",
                                  "temporal/deterministic"])
def test_train_step_graph_against_op_by_op(cuda, monkeypatch, kind):
    """3 steps replayed from the step's graph (the first the warm-up and
    the capture) against the same steps op by op from the same net and
    optimizer state, three times: where op by op repeats itself bit for
    bit the graph's state equals it bit for bit, else its largest
    difference to them stays within 4x of the largest between two of
    them (cuDNN's weight gradients and K6's backward add with atomics).
    With cuDNN's deterministic algorithms (no K6) op by op must repeat
    itself, and so the graph equal it.  One capture; the recurrent
    update (4 frames) launches 3 K6 backwards a step, replayed or
    not."""
    from hrt_tpu_torch import graphs, train_upscaler
    from hrt_tpu_torch.models import upscaler
    from hrt_tpu_torch.ops import warp_kernel

    kind, _, deterministic = kind.partition("/")
    monkeypatch.setattr(torch.backends.cudnn, "deterministic",
                        bool(deterministic))
    rs = np.random.RandomState(31)
    t = lambda a: torch.as_tensor(a, device=cuda)
    if kind == "recurrent":
        seqs = [train_upscaler.render_sequence(4, size=(64, 64), clean_spp=2,
                                               scene_kind=k, device=cuda)
                for k in ("bench", "cornell")]
        make = lambda: upscaler.create_temporal(seed=5, lr=2e-3, device=cuda)
        step = lambda net, opt, i: upscaler.update(
            net, opt, train_upscaler.recurrent_loss, seqs[i % 2])
    else:
        temporal = kind == "temporal"
        batches = []
        for _ in range(3):
            hr = rs.uniform(0, 2, (8, 64, 64, 3)).astype(np.float32)
            hist = np.concatenate([hr, rs.rand(8, 64, 64, 1) < 0.7],
                                  -1).astype(np.float32)
            batches.append((upscaler.downsample2(t(hr)),
                            *((t(hist),) if temporal else ()), t(hr)))
        fn = upscaler.train_step_temporal if temporal else \
            upscaler.train_step
        make = (upscaler.create_temporal if temporal else upscaler.create)
        make = (lambda m=make: m(seed=5, lr=2e-3, device=cuda))
        step = lambda net, opt, i: fn(net, opt, *batches[i])
    sides = [make() for _ in range(4)]
    caps = upscaler.TRAIN_PROGRAMS.captures
    before = warp_kernel.LAUNCHES["warp_bilinear_backward"]
    for i in range(3):
        step(*sides[0], i)
        with graphs.disable():
            for side in sides[1:]:
                step(*side, i)
    torch.cuda.synchronize()
    assert upscaler.TRAIN_PROGRAMS.captures == caps + 1
    assert upscaler.TRAIN_PROGRAMS.last.graph.nodes > 0
    assert warp_kernel.LAUNCHES["warp_bilinear_backward"] - before == \
        (36 if kind == "recurrent" else 0)
    eager = [opt for _, opt in sides[1:]]
    self_diff = max(_state_diff(a, b) for i, a in enumerate(eager)
                    for b in eager[i + 1:])
    graph_diff = max(_state_diff(sides[0][1], e) for e in eager)
    assert self_diff == 0 or not deterministic, self_diff
    if self_diff == 0:
        assert all(_bits_equal(a.float(), b.float()) for a, b in zip(
            _train_state(sides[0][1]), _train_state(sides[1][1])))
    else:
        assert graph_diff <= 4 * self_diff, (graph_diff, self_diff)
    assert int(sides[0][1].count) == 3


def test_frame_graph_between_training_replays(cuda):
    """A post frame loop's graph replayed between the replays of a
    spatial step's graph leaves every training tensor as it was (none
    lives in the pool the graphs share), and the steps go on replaying:
    one capture each."""
    from hrt_tpu_torch.frameloop import FrameLoop
    from hrt_tpu_torch.models import upscaler

    net, opt = upscaler.create(seed=2, lr=2e-3, device=cuda)
    hr = torch.rand((8, 64, 64, 3), generator=torch.Generator().manual_seed(
        3)).to(cuda)
    lr = upscaler.downsample2(hr)
    loop = FrameLoop(bench_scene(), RenderConfig(
        width=64, height=48, max_depth=1, sky=True, denoise=True, upscale=2,
        upscale_mode="temporal"), device=cuda)
    loop.step(_post_cam(0))
    caps = upscaler.TRAIN_PROGRAMS.captures
    losses = []
    for i in range(3):
        losses.append(float(upscaler.train_step(net, opt, lr, hr)))
        torch.cuda.synchronize()
        kept = [x.clone() for x in _train_state(opt)]
        loop.step(_post_cam(i + 1))
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(_train_state(opt),
                                                     kept)), i
    assert upscaler.TRAIN_PROGRAMS.captures == caps + 1
    assert loop.captures == 1 and losses[2] < losses[0]


def test_trainer_render_programs_bit_equal_to_op_by_op(cuda):
    """render_sequence's G-buffer and clean renders replayed from their
    graphs (two captures) against the same renders op by op, bit for
    bit."""
    from hrt_tpu_torch import graphs, train_upscaler

    progs = train_upscaler.RENDER_PROGRAMS
    caps = progs.captures
    got = train_upscaler.render_sequence(3, size=(64, 64), clean_spp=2,
                                         device=cuda)
    assert progs.captures == caps + 2
    with graphs.disable():
        want = train_upscaler.render_sequence(3, size=(64, 64), clean_spp=2,
                                              device=cuda)
    assert progs.captures == caps + 2
    for i in (0, 1, 4):
        assert _bits_equal(got[i], want[i]), i
    assert torch.equal(got[2], want[2])


# ---- programs over a process group (one-rank NCCL) and the stacked
# two-level trace, captured ----------------------------------------------

def _launch_delta(fn):
    """(fn()'s result, the launches it made per counter)."""
    before = _launches()
    out = fn()
    torch.cuda.synchronize()
    return out, [{k: c[k] - b[k] for k in c}
                 for c, b in zip(_launches(), before)]


def _flat(x) -> list:
    from torch.utils import _pytree as pytree

    return pytree.tree_flatten(x)[0]


def _same(a, b) -> bool:
    fa, fb = _flat(a), _flat(b)
    return len(fa) == len(fb) and all(
        _bits_equal(x, y) if x.is_floating_point() else torch.equal(x, y)
        for x, y in zip(fa, fb))


def test_mesh_loop_graph_is_bit_equal_to_op_by_op(nccl_group):
    """FrameLoop(mesh) over one NCCL rank, 3 post steps: one capture,
    each replayed step, its state and its launches those of the same
    mesh loop op by op."""
    from hrt_tpu_torch import graphs
    from hrt_tpu_torch.frameloop import FrameLoop

    cfg = RenderConfig(width=128, height=96, max_depth=1, sky=True,
                       jitter=True, accumulate=True, denoise=True,
                       upscale=2, upscale_mode="temporal")
    graphed = FrameLoop(bench_scene(), cfg, mesh=nccl_group)
    eager = FrameLoop(bench_scene(), cfg, mesh=nccl_group)
    for f in range(3):
        with graphs.disable():
            want, el = _launch_delta(lambda: eager.step(_post_cam(f)))
        got, gl = _launch_delta(lambda: graphed.step(_post_cam(f)))
        assert _bits_equal(got, want) and gl == el
        assert _same([*graphed.dn_state, graphed.accum, graphed.up_history],
                     [*eager.dn_state, eager.accum, eager.up_history])
    assert graphed.captures == 1 and eager.captures == 0
    assert graphed.program.last.graph.nodes > 0


def test_tiled_frame_graph_is_bit_equal_to_op_by_op(nccl_group):
    """render_frame_tiled with and without its G-buffer: one capture per
    key, each replay bit for bit the frame op by op with its launches."""
    from hrt_tpu_torch import graphs
    from hrt_tpu_torch.parallel import tiles

    dev = tiles.mesh_device(nccl_group)
    cfg = RenderConfig(width=128, height=96, max_depth=2, sky=True,
                       jitter=True)
    scene = bench_scene().build(dev)
    accel = lbvh.build_bvh_sah(scene, leaf_size=32)
    cams = renderer.camera_arrays(Camera(**BENCH_CAM), cfg, dev)
    progs = tiles.TILED_PROGRAMS
    caps = progs.captures
    for gb in (False, True):
        for f in range(3):
            call = lambda: tiles.render_frame_tiled(
                scene, accel, cams, f, cfg, nccl_group, want_gbuffer=gb)
            with graphs.disable():
                want, el = _launch_delta(call)
            got, gl = _launch_delta(call)
            assert _same(got, want) and gl == el
    assert progs.captures == caps + 2


def test_sharded_hits_graph_is_bit_equal_to_op_by_op(nccl_group):
    """closest_hit_sharded over one NCCL rank (one shard): replayed, bit
    for bit op by op and the whole soup's LBVH walk; one capture."""
    from hrt_tpu_torch import graphs
    from hrt_tpu_torch.ops import traversal
    from hrt_tpu_torch.parallel import scene_shard

    scene = bench_scene().build("cuda", pad=128)
    sharded, accs = scene_shard.build_sharded_accel(scene, 1, leaf_size=8)
    o, d = _rays(5, 4093, scene.tri_v0.device)
    progs = scene_shard.SHARD_PROGRAMS
    caps = progs.captures
    call = lambda: scene_shard.closest_hit_sharded(sharded, accs, o, d,
                                                   nccl_group, leaf_size=8)
    for _ in range(2):
        with graphs.disable():
            want, el = _launch_delta(call)
        got, gl = _launch_delta(call)
        assert _same(got, want) and gl == el
        assert gl[2]["closest"] == 1
    assert progs.captures == caps + 1
    whole = traversal.closest_hit_bvh_p(
        None, lbvh.build_bvh(scene, 8), V3(*o.unbind(-1)), V3(*d.unbind(-1)),
        1e-3, 1e32)
    assert _same(got, tuple(whole))
    assert (got[1] >= 0).float().mean().item() > 0.3


@pytest.mark.parametrize("kind", ["spatial", "temporal"])
def test_group_step_graph_is_bit_equal_under_deterministic_cudnn(
        nccl_group, monkeypatch, kind):
    """The data-parallel step over one NCCL rank, its all-reduce inside
    the graph: with cuDNN's deterministic algorithms op by op repeats
    itself, so 3 replayed steps equal 3 op-by-op steps bit for bit (two
    op-by-op sides); one capture."""
    from hrt_tpu_torch import graphs
    from hrt_tpu_torch.models import upscaler

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    group = nccl_group.get_group()
    temporal = kind == "temporal"
    rs = np.random.RandomState(41)
    t = lambda a: torch.as_tensor(a.astype(np.float32), device="cuda")
    batches = []
    for _ in range(3):
        hr = rs.uniform(0, 2, (8, 64, 64, 3))
        hist = np.concatenate([hr, rs.rand(8, 64, 64, 1) < 0.7], -1)
        batches.append((upscaler.downsample2(t(hr)),
                        *((t(hist),) if temporal else ()), t(hr)))
    fn = upscaler.train_step_temporal if temporal else upscaler.train_step
    make = upscaler.create_temporal if temporal else upscaler.create
    sides = [make(seed=5, lr=2e-3, device="cuda") for _ in range(3)]
    caps = upscaler.TRAIN_PROGRAMS.captures
    for b in batches:
        losses = [fn(*sides[0], *b, group=group)]
        with graphs.disable():
            losses += [fn(*s, *b, group=group) for s in sides[1:]]
        assert all(_bits_equal(losses[0], x) for x in losses[1:])
    torch.cuda.synchronize()
    assert upscaler.TRAIN_PROGRAMS.captures == caps + 1
    for s in sides[1:]:
        assert _same(_train_state(sides[0][1]), _train_state(s[1]))
    assert int(sides[0][1].count) == 3


def test_stacked_trace_graph_against_op_by_op_and_plain(cuda):
    """trace_two_level replayed: bit for bit op by op with the same K3
    launches (one per instance), and its plain walk on >= 0.99999 of
    rays; one capture per key, any-hit mode another."""
    from hrt_tpu_torch import graphs
    from hrt_tpu_torch.ops import twolevel

    sc = bench_scene()
    tl = twolevel.build_two_level(sc, 8)
    o, d = _rays(11, 8192, cuda)
    progs = twolevel.TRACE_PROGRAMS
    caps = progs.captures
    for closest in (True, False, True):
        call = lambda: twolevel.trace_two_level(tl, o, d,
                                                find_closest=closest)
        with graphs.disable():
            want, el = _launch_delta(call)
        got, gl = _launch_delta(call)
        assert _same(got, want) and gl == el
        assert gl[2]["closest" if closest else "any_hit"] == len(
            sc.instances)
    assert progs.captures == caps + 2
    pt, pi, ptri, _, _ = twolevel.trace_two_level(tl, o, d, plain=True)
    kt, ki, ktri = got[:3]
    same = (ki == pi) & (ktri == ptri)
    assert float(same.float().mean()) >= 0.99999
    hit = same & (pi >= 0)
    assert float((kt - pt)[hit].abs().max()) <= 1e-4


def test_capture_without_a_communicator_raises_on_the_card(nccl_group):
    """A capture whose NCCL collective meets no recorded communicator
    raises RuntimeError at once (the warm-up's record taken away), the
    card works on, and with the record the same body captures."""
    from hrt_tpu_torch import graphs
    from hrt_tpu_torch.parallel import tiles

    group = nccl_group.get_group()

    class Forgets(graphs.CudaGraph):
        def __init__(self, *args):
            graphs._communicators.clear()
            super().__init__(*args)

    body = lambda x: tiles.gather_rows(x * 2.0, group)
    x = torch.ones(16, 3, device="cuda")
    progs = graphs.Programs(1, capture=Forgets)
    with pytest.raises(RuntimeError, match="no communicator"):
        progs("k", body, (x,), "cuda", group=group)
    assert progs.captures == 0
    torch.cuda.synchronize()
    progs = graphs.Programs(1)
    for _ in range(2):
        out = progs("k", body, (x,), "cuda", group=group)
        assert torch.equal(out, x * 2.0)
    assert progs.captures == 1
