"""Instance culling in hrt_tpu_torch against the JAX package, on the CPU:
the footprint, the hysteresis update (near-plane rule included) and the
triangle mask on the same inputs, the orbit camera, and a culled
FrameLoop (the default cull_threshold_px) over three orbit frames
against JAX's: the same visibility on every frame, LBVH rebuilds, and
the frames (K3's plain walk here, JAX's K3 in interpret mode there)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hrt_tpu.config import RenderConfig as JRenderConfig
from hrt_tpu.frameloop import FrameLoop as JFrameLoop
from hrt_tpu.models.camera import Camera as JCamera
from hrt_tpu.models.camera import orbit_camera as jorbit_camera
from hrt_tpu.models.mesh import icosphere, plane
from hrt_tpu.models.scene import Scene as JScene
from hrt_tpu.ops import culling as jculling
from hrt_tpu.renderer import camera_arrays as jcamera_arrays
from hrt_tpu_torch.config import RenderConfig
from hrt_tpu_torch.frameloop import FrameLoop
from hrt_tpu_torch.models.camera import CameraArrays, orbit_camera
from hrt_tpu_torch.ops import culling, traversal, traversal_skip
from hrt_tpu_torch.utils.image import psnr

from test_torch_native import jax_native_lib
from test_torch_tlas import port_scene


@pytest.fixture(scope="module", autouse=True)
def _jax_native_sah():
    """JAX's build_bvh_sah through its native builder, never the LBVH
    fallback (test_torch_native.jax_native_lib)."""
    jax_native_lib()


FRAME = dict(width=64, height=48, max_depth=1, sky=True, jitter=False)


def small_instances_scene() -> JScene:
    """A ground plane, a unit sphere and twelve small spheres (scales
    0.01-0.06, seeded): at 64x48 the small ones sit around the
    one-pixel threshold, so an orbit changes which of them show."""
    sc = JScene()
    sph = sc.add_mesh(icosphere(1))
    gnd = sc.add_mesh(plane(6.0))
    m0 = sc.create_material((0.8, 0.8, 0.8), 0.0, 0.8)
    m1 = sc.create_material((0.9, 0.6, 0.2), 1.0, 0.2)
    sc.create_light((0.0, -4.0, -2.0), (1.0, 1.0, 1.0), 25.0)
    sc.create_instance(gnd, m0, (0.0, 1.0, 0.0))
    sc.create_instance(sph, m1, (0.0, 0.0, 0.0))
    rs = np.random.RandomState(11)
    for k in range(12):
        s = float(rs.uniform(0.01, 0.06))
        pos = tuple(rs.uniform(-2.5, 2.5, 3) * [1.0, 0.2, 1.0])
        sc.create_instance(sph, m0 if k % 2 else m1, pos, scale=(s, s, s))
    return sc


def orbit(f: int):
    """Frame f of the test orbit (2 rad a frame, radius 4, height -1):
    visibility changes on every one of the first three frames."""
    return dict(t=2.0 * f, radius=4.0, height=-1.0)


@pytest.fixture(scope="module")
def scenes():
    js = small_instances_scene()
    return js.build(), port_scene(js).build("cpu")


def _cams(cam):
    """JAX's camera arrays of a JAX Camera, and the same arrays as the
    port's CameraArrays: the culling math is compared on equal inputs
    (the two packages' float32 trig may round a basis entry apart)."""
    jc = jcamera_arrays(cam, JRenderConfig(**FRAME))
    return jc, CameraArrays(*(torch.as_tensor(np.asarray(a)) for a in jc))


def test_orbit_camera_matches_jax():
    """The same path; the basis within an ulp (float32 trig)."""
    for f in range(4):
        j, p = jorbit_camera(**orbit(f)), orbit_camera(**orbit(f))
        assert j.position == p.position and j.rotation == p.rotation
        np.testing.assert_allclose(p.basis(), np.asarray(j.basis()),
                                   rtol=0, atol=1.2e-7)


@pytest.mark.parametrize("view", ["orbit0", "orbit1", "near"])
def test_footprint_matches_jax(scenes, view):
    """Bit for bit; the near view puts the camera inside the ground
    plane's box, whose footprint is then +inf."""
    jd, td = scenes
    jc, tc = _cams(jorbit_camera(**orbit(int(view[-1])))
                   if view.startswith("orbit")
                   else JCamera(position=(0.0, 1.0, 0.0)))
    want = np.asarray(jculling.footprint_px(jd.inst_bmin, jd.inst_bmax, jc,
                                            64, 48))
    got = culling.footprint_px(td.inst_bmin, td.inst_bmax, tc, 64, 48)
    np.testing.assert_array_equal(got.numpy(), want)
    if view == "near":
        assert np.isinf(want[0])
    else:
        assert (want < 1.0).any() and (want > 2.0).any()


def test_cull_hysteresis_and_mask_match_jax(scenes):
    """Every previous state through the update at two thresholds (the
    band between threshold and 2x threshold keeps the previous state),
    and the triangle mask of the result."""
    jd, td = scenes
    jc, tc = _cams(jorbit_camera(**orbit(0)))
    n = td.inst_bmin.shape[0]
    rs = np.random.RandomState(2)
    for threshold in (1.0, 0.5):
        for prev in (np.ones(n, bool), np.zeros(n, bool), rs.rand(n) < 0.5):
            want = np.asarray(jculling.cull_instances(
                jnp.asarray(prev), jd.inst_bmin, jd.inst_bmax, jc, 64, 48,
                threshold_px=threshold))
            got = culling.cull_instances(torch.as_tensor(prev), td.inst_bmin,
                                         td.inst_bmax, tc, 64, 48,
                                         threshold_px=threshold)
            np.testing.assert_array_equal(got.numpy(), want)
            mask = culling.triangle_mask(got, td.tri_inst, td.tri_valid)
            np.testing.assert_array_equal(mask.numpy(), np.asarray(
                jculling.triangle_mask(jnp.asarray(want), jd.tri_inst,
                                       jd.tri_valid)))
    # Some instance sits in the band: its state follows the previous one.
    area = np.asarray(jculling.footprint_px(jd.inst_bmin, jd.inst_bmax, jc,
                                            64, 48))
    assert ((area >= 1.0) & (area <= 2.0)).any()


def test_culled_frameloop_matches_jax():
    """Three orbit frames at 64x48 with the default cull_threshold_px:
    the same visibility as JAX's FrameLoop on every frame, a rebuild on
    each (frame 0 culls, frames 1 and 2 change the set), every trace
    through K3, and frames within PSNR 45 of JAX's (on the CPU: 135.9,
    135.2 and 127.3; the camera bases differ in an ulp, see
    test_orbit_camera_matches_jax)."""
    jloop = JFrameLoop(small_instances_scene(),
                       JRenderConfig(shade_pallas=False, **FRAME))
    loop = FrameLoop(port_scene(small_instances_scene()),
                     RenderConfig(**FRAME), device="cpu")
    assert loop.cull_threshold_px == jloop.cull_threshold_px == 1.0
    for f in range(3):
        jimg = np.asarray(jloop.step(jorbit_camera(**orbit(f))))
        img = loop.step(orbit_camera(**orbit(f))).numpy()
        np.testing.assert_array_equal(loop.visible.numpy(),
                                      np.asarray(jloop.visible))
        assert loop.rebuilds == f + 1
        assert loop.accel.w8 is None
        assert traversal._walk(loop.accel, False) is traversal_skip.trace
        p = psnr(np.clip(img, 0, 4), np.clip(jimg, 0, 4), peak=4.0)
        assert p > 45.0, (f, p)
    assert not loop.visible.all() and loop.visible.any()
