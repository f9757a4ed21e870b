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
from hrt_tpu_torch.ops import (lbvh, shade_kernel, tlas, traversal_tlas8,
                               traversal_wide8, wide8)
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
    validity identical; values within rel 1e-5 of the taps' absolute
    weighted sum (nvcc contracts the sum into FMAs) and finite."""
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


@pytest.mark.parametrize("layout", ["hwc", "chw"])
@pytest.mark.parametrize("c", [1, 3, 10])
def test_warp_kernel_tiles_match_plain(cuda, c, layout):
    """K6's tiles at a ragged size (a 37x29 grid from a 31x23 source, so
    the last tile and its last 16-byte store are partial) for each
    channel count, from a contiguous image and from a channels-first
    view (read through its strides): validity identical, values within
    rel 1e-5 of the taps' absolute weighted sum, finite."""
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
    kernels: five launches of each per frame, and the plain frame's
    image (PSNR > 45)."""
    cfg = _path_cfg(64, 48)
    scene = bench_scene().build(cuda)
    accel = lbvh.build_bvh_sah(scene, leaf_size=32)
    cams = renderer.camera_arrays(Camera(**BENCH_CAM), cfg, cuda)
    before = (dict(traversal_wide8.LAUNCHES), dict(shade_kernel.LAUNCHES))
    img = renderer.render_frames(scene, accel, cams, 3, 1, cfg)
    assert traversal_wide8.LAUNCHES == {
        m: c + 5 for m, c in before[0].items()}
    assert shade_kernel.LAUNCHES == {m: c + 5 for m, c in before[1].items()}
    ref = renderer.render_frames(scene, accel, cams, 3, 1, cfg, plain=True)
    assert torch.isfinite(img).all()
    assert psnr(img[0].clamp(0, 4).cpu().numpy(),
                ref[0].clamp(0, 4).cpu().numpy(), peak=4.0) > 45.0


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
    any hit, K2) against `want`, and the same frame through the plain
    versions; returns (frame, plain frame)."""
    scene = sc.build(cuda)
    accel = lbvh.build_bvh_sah(scene, leaf_size=32)
    cams = renderer.camera_arrays(Camera(**cam), cfg, cuda)
    before = (traversal_wide8.LAUNCHES["closest"],
              traversal_wide8.LAUNCHES["any_hit"],
              shade_kernel.LAUNCHES["brdf_light_major"])
    img = renderer.render_frames(scene, accel, cams, 2, 1, cfg)[0]
    got = (traversal_wide8.LAUNCHES["closest"] - before[0],
           traversal_wide8.LAUNCHES["any_hit"] - before[1],
           shade_kernel.LAUNCHES["brdf_light_major"] - before[2])
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
    hit (over the 2-sample batch) and one K2 (L = 2), and the plain
    frame's image."""
    from hrt_tpu_torch.models.scene import many_lights_scene

    cfg = RenderConfig(width=64, height=48, max_depth=1, sky=True,
                       light_samples=2, light_sampler=sampler)
    _frame_vs_plain(cuda, many_lights_scene(40), cfg, BENCH_CAM, (1, 1, 1))


@pytest.mark.parametrize("brdf", ["disney", "pbr"])
def test_studio_frame_matches_plain(cuda, brdf):
    """scenes/studio.yaml (its textured floor) at 64x48, depth 3 with
    bounces, through the kernels against the plain frame; the pbr BSDF
    launches no K2."""
    import chip_smoke
    from hrt_tpu_torch.models.scenefile import scene_from_dict

    cfg = RenderConfig(width=64, height=48, max_depth=3, sky=True,
                       indirect=True, brdf=brdf)
    img, _ = _frame_vs_plain(cuda, scene_from_dict(chip_smoke.STUDIO_SPEC),
                             cfg, chip_smoke.STUDIO_CAM,
                             (3, 3, 0 if brdf == "pbr" else 3))
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
