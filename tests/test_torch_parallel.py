"""hrt_tpu_torch.parallel on the CPU against the JAX package's
hrt_tpu.parallel on its 8-device CPU mesh (tests/conftest.py): the 8 row
bands, rendered in one process, against JAX's tiled frame and the port's
own whole frame; the 8 shard LBVHs and their combined hits against JAX's
sharded build and trace; the farm's plans; and, in a one-rank gloo
group, FrameLoop(mesh), the luminance statistics, the replicated scene
and the data-parallel upscaler step.  Two ranks run in
test_torch_parallel_spawn.py."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from hrt_tpu.config import RenderConfig as JRenderConfig
from hrt_tpu.models.camera import Camera as JCamera
from hrt_tpu.models.scene import reference_demo_scene as jdemo
from hrt_tpu.parallel import scene_shard as jscene_shard, tiles as jtiles
from hrt_tpu.renderer import camera_arrays as jcamera_arrays
from hrt_tpu.utils.image import psnr
from hrt_tpu_torch import renderer
from hrt_tpu_torch.config import RenderConfig
from hrt_tpu_torch.frameloop import FrameLoop
from hrt_tpu_torch.models import upscaler
from hrt_tpu_torch.models.camera import Camera, orbit_camera
from hrt_tpu_torch.models.scene import bench_scene, reference_demo_scene
from hrt_tpu_torch.ops import lbvh
from hrt_tpu_torch.parallel import farm, scene_shard, tiles
from hrt_tpu_torch.utils.interop import scene_from_numpy

from test_scene_shard import build_scene, rays
from test_torch_build import jax_scene_dict

SMALL = dict(width=64, height=48, max_depth=1, sky=True)
BENCH_CAM = dict(position=(0.0, -1.0, -6.0), rotation=(-0.15, 0.0, 0.0))
POST = dict(width=64, height=48, max_depth=1, sky=True, denoise=True,
            accumulate=True, upscale=2, upscale_mode="temporal")


@pytest.fixture
def group(tmp_path):
    """A one-rank gloo group on a file store, destroyed after the test."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    yield dist.group.WORLD
    dist.destroy_process_group()


def _bands(scene, accel, cams, frame, cfg, n):
    return torch.cat([tiles.render_band(scene, accel, cams, frame, cfg, r, n)
                      for r in range(n)])


def test_bands_match_jax_tiled_frame():
    """The port's 8 bands (brute force, as JAX's test_parallel) against
    JAX's render_frame_tiled on its 8 devices, with the tolerance of the
    port's demo frame against JAX's (test_torch_render.py), and bit for
    bit the port's whole frame."""
    cfg = JRenderConfig(shade_pallas=False, **SMALL)
    js = jdemo().build()
    mesh = jtiles.make_mesh(8)
    want = np.asarray(jtiles.render_frame_tiled(
        jtiles.replicate(js, mesh), None, jcamera_arrays(JCamera(), cfg),
        jnp.uint32(0), cfg, mesh))
    tcfg = RenderConfig(**SMALL)
    ts = reference_demo_scene().build("cpu")
    cams = renderer.camera_arrays(Camera(), tcfg, "cpu")
    got = _bands(ts, None, cams, 0, tcfg, 8)
    assert torch.equal(got, renderer.render_rows(ts, None, cams, 0, 48, tcfg))
    got = got.numpy()
    assert got.shape == want.shape == (48, 64, 3)
    assert psnr(np.clip(got, 0, 4), np.clip(want, 0, 4), peak=4.0) > 45.0


@pytest.mark.parametrize("n", [2, 8])
def test_path_traced_bands_are_the_frame(n):
    """Jitter, bounces, Russian roulette and the sorted wavefront on the
    SAH accel: the bands are the whole frame's rows, bit for bit."""
    cfg = RenderConfig(width=32, height=24, max_depth=3, sky=True,
                       indirect=True, jitter=True, sort_bounces=True)
    ts = bench_scene().build("cpu")
    acc = lbvh.build_bvh_sah(ts, leaf_size=32)
    cams = renderer.camera_arrays(Camera(**BENCH_CAM), cfg, "cpu")
    assert torch.equal(_bands(ts, acc, cams, 3, cfg, n),
                       renderer.render_rows(ts, acc, cams, 0, 24, cfg,
                                            frame=3))


def test_band_refuses_an_undivided_height():
    with pytest.raises(ValueError, match="not divisible"):
        tiles.band(0, 8, RenderConfig(width=64, height=50))
    assert tiles.band(3, 8, RenderConfig(width=64, height=48)) == (18, 6)


@pytest.fixture(scope="module")
def shard_scenes():
    """(JAX SceneData, port SceneData) of test_scene_shard's scene."""
    js = build_scene()
    return js, scene_from_numpy(jax_scene_dict(js), "cpu")


def test_shard_split_roundtrip(shard_scenes):
    js, ts = shard_scenes
    sharded = scene_shard.shard_scene_triangles(ts, 8)
    jsharded = jscene_shard.shard_scene_triangles(js, 8)
    for f in scene_shard.TRI_FIELDS:
        np.testing.assert_array_equal(getattr(sharded, f).numpy(),
                                      np.asarray(getattr(jsharded, f)))
        assert torch.equal(scene_shard.unshard_tri_attr(sharded, f),
                           getattr(ts, f))
    with pytest.raises(ValueError):
        scene_shard.shard_scene_triangles(ts, 3)


def test_shard_accels_match_jax(shard_scenes):
    """Each shard's LBVH: JAX's vmapped build, bit for bit."""
    js, ts = shard_scenes
    _, jacc = jscene_shard.build_sharded_accel(js, 8, leaf_size=8)
    _, accs = scene_shard.build_sharded_accel(ts, 8, leaf_size=8)
    assert len(accs) == 8
    bits = lambda a: a.view(np.int32) if a.dtype == np.float32 else a
    for s, acc in enumerate(accs):
        for f in ("tri_v0", "tri_e1", "tri_e2", "tri_perm"):
            np.testing.assert_array_equal(
                bits(np.asarray(getattr(jacc.tree, f))[s]),
                bits(getattr(acc, f).numpy()), err_msg=f"{f} shard {s}")
        np.testing.assert_array_equal(
            bits(np.asarray(jacc.flat.nodes)[s]), bits(acc.nodes.numpy()))


def test_sharded_hits_match_jax(shard_scenes):
    """combine_hits over the 8 shards' K3 walks against JAX's
    closest_hit_sharded (its K3 in interpret mode) on
    test_scene_shard's rays: ids equal, t within 1e-6."""
    js, ts = shard_scenes
    jsharded, jacc = jscene_shard.build_sharded_accel(js, 8, leaf_size=8)
    smesh = jax.sharding.Mesh(jtiles.make_mesh(8).devices, ("shards",))
    o, d = rays()
    jt, jtri, ju, jv = (np.asarray(a) for a in jscene_shard
                        .closest_hit_sharded(jsharded, jacc, o, d, smesh,
                                             leaf_size=8))
    sharded, accs = scene_shard.build_sharded_accel(ts, 8, leaf_size=8)
    to, td = torch.tensor(np.asarray(o)), torch.tensor(np.asarray(d))
    t_per = sharded.tri_v0.shape[1]
    hits = [scene_shard.shard_closest_hit(a, to, td, s, t_per)
            for s, a in enumerate(accs)]
    t, tri, u, v = (x.numpy() for x in scene_shard.combine_hits(
        *(torch.stack(h) for h in zip(*hits))))
    np.testing.assert_array_equal(tri, jtri)
    assert (tri >= 0).mean() > 0.3
    np.testing.assert_allclose(t, jt, rtol=1e-6)
    hit = tri >= 0
    np.testing.assert_allclose(u[hit], ju[hit], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(v[hit], jv[hit], rtol=1e-5, atol=1e-5)


def test_combine_hits_ties_and_misses():
    """Ties go to the lower shard; a ray that misses everywhere keeps
    shard 0's values."""
    t = torch.tensor([[2.0, 5.0, 1e32], [2.0, 3.0, 7.0]])
    tri = torch.tensor([[4, 9, -1], [130, 140, -1]], dtype=torch.int32)
    u = torch.tensor([[0.1, 0.2, 0.3], [0.4, 0.5, 0.6]])
    ct, ctri, cu, cv = scene_shard.combine_hits(t, tri, u, u + 1)
    assert ctri.tolist() == [4, 140, -1]
    assert torch.equal(ct, torch.tensor([2.0, 3.0, 1e32]))
    torch.testing.assert_close(cu, torch.tensor([0.1, 0.5, 0.3]))
    torch.testing.assert_close(cv, cu + 1)


@pytest.mark.parametrize("chunked", [True, False])
def test_farm_plan_partitions_exactly(chunked):
    seen = [f for p in range(3)
            for f in farm.FarmPlan(p, 3, 11, chunked=chunked).frames()]
    assert sorted(seen) == list(range(11))


def test_farm_chunked_blocks_are_contiguous():
    assert list(farm.FarmPlan(1, 4, 16).frames()) == [4, 5, 6, 7]
    assert list(farm.FarmPlan(1, 4, 16, chunked=False).frames()) == \
        [1, 5, 9, 13]


def test_render_frames_through_loop():
    cfg = RenderConfig(width=32, height=24, max_depth=1, sky=True,
                       traversal="bvh")
    loop = FrameLoop(reference_demo_scene(), cfg, cull_threshold_px=0,
                     device="cpu")
    got = {}
    n = farm.render_frames(loop, lambda f: orbit_camera(f * 0.3), 4,
                           lambda f, img: got.setdefault(f, img),
                           plan=farm.FarmPlan(0, 2, 4))
    assert n == 2 and sorted(got) == [0, 1]
    assert all(bool(torch.isfinite(v).all()) for v in got.values())
    # No group, no plan: this process is the whole farm.
    assert farm.initialize() == farm.FarmPlan(0, 1, 0)
    assert farm.render_frames(loop, lambda f: orbit_camera(f * 0.3), 3,
                              lambda f, img: None) == 3


def test_make_mesh_refuses_ranks_it_lacks(group):
    with pytest.raises(ValueError, match="2 devices asked for"):
        tiles.make_mesh(2, device="cpu")
    mesh = tiles.make_mesh(device="cpu")
    assert mesh.size() == 1 and mesh.mesh_dim_names == ("tiles",)
    assert tiles.mesh_device(mesh) == torch.device("cpu")


@pytest.mark.parametrize("kw", [dict(cfg=POST), dict(
    cfg=dict(width=64, height=48, max_depth=3, sky=True, indirect=True,
             jitter=True, accumulate=True, sort_bounces=True)),
    dict(cfg=dict(SMALL), two_level=True)], ids=["post", "sorted", "tlas"])
def test_frameloop_mesh_matches_plain_loop(group, kw):
    """FrameLoop(mesh) over one rank, two steps: the loop without a mesh,
    bit for bit (the post stages on the gathered frame; the sorted path
    tracer; the two-level loop, its accel replicated)."""
    from test_tlas import _instanced_scene
    from test_torch_tlas import port_scene

    cfg = RenderConfig(**kw["cfg"])
    two_level = kw.get("two_level", False)

    def run(mesh):
        sc = (port_scene(_instanced_scene()) if two_level
              else reference_demo_scene())
        loop = FrameLoop(sc, cfg, cull_threshold_px=0.0, mesh=mesh,
                         two_level=two_level, device=None if mesh else "cpu")
        return [loop.step(Camera(**BENCH_CAM)).clone() for _ in range(2)]

    want = run(None)
    got = run(tiles.make_mesh(1, device="cpu"))
    for w, g in zip(want, got):
        assert torch.equal(g, w)
    if cfg.upscale == 2:
        assert got[0].shape == (96, 128, 3)


def test_frame_stats_psum_matches_numpy(group):
    img = np.random.RandomState(3).rand(24, 32, 3).astype(np.float32) * 4
    mean, peak = tiles.frame_stats_psum(torch.as_tensor(img), group)
    lum = img @ np.float32([0.2126, 0.7152, 0.0722])
    np.testing.assert_allclose(float(mean), lum.mean(), rtol=1e-6)
    np.testing.assert_allclose(float(peak), lum.max(), rtol=1e-6)


def test_replicate_keeps_every_tensor(group):
    mesh = tiles.make_mesh(1, device="cpu")
    ts = bench_scene().build("cpu")
    acc = lbvh.build_bvh_sah(ts, leaf_size=32)
    for tree in (ts, acc):
        rep = tiles.replicate(tree, mesh)
        assert type(rep) is type(tree)
        pairs = list(zip(_leaves(rep), _leaves(tree)))
        assert len(pairs) == len(list(_leaves(tree)))
        for a, b in pairs:
            assert type(a) is type(b)
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, b)


def _leaves(x):
    """The leaves of nested dataclasses, tuples and lists."""
    if dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from _leaves(getattr(x, f.name))
    elif isinstance(x, (tuple, list)):
        for y in x:
            yield from _leaves(y)
    else:
        yield x


@pytest.mark.parametrize("temporal", [False, True])
def test_group_train_step_matches_plain_step(group, temporal):
    """update(group=...) over one rank: the step without a group."""
    make = upscaler.create_temporal if temporal else upscaler.create
    (net, opt), (ref, ref_opt) = make(device="cpu"), make(device="cpu")
    g = torch.Generator().manual_seed(5)
    lr = torch.rand((4, 8, 8, 3), generator=g)
    hr = torch.rand((4, 16, 16, 3), generator=g)
    if temporal:
        hist = torch.rand((4, 16, 16, 4), generator=g)
        step = lambda n, o, grp=None: upscaler.train_step_temporal(
            n, o, lr, hist, hr, group=grp)
    else:
        step = lambda n, o, grp=None: upscaler.train_step(n, o, lr, hr,
                                                          group=grp)
    for _ in range(2):
        loss, want = step(net, opt, group), step(ref, ref_opt)
        torch.testing.assert_close(loss, want, rtol=1e-6, atol=0)
    for p, q in zip(net.parameters(), ref.parameters()):
        torch.testing.assert_close(p, q, rtol=1e-6, atol=1e-7)
