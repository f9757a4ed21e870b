"""hrt_tpu_torch.frameloop.FrameLoop on the CPU (plain versions): the
accumulate branch of the JAX package's `_post_stages`, resolution
switches, instance animation through the TLAS refit, and what the port
refuses (the denoise and upscale branches are held against JAX in
test_torch_post_loop.py).  The scene is test_tlas's four instances at 32x24."""
import numpy as np
import pytest
import torch

from hrt_tpu_torch import renderer
from hrt_tpu_torch.config import RenderConfig
from hrt_tpu_torch.frameloop import FrameLoop
from hrt_tpu_torch.models.camera import Camera
from hrt_tpu_torch.ops import tlas

from test_tlas import _instanced_scene
from test_torch_tlas import CAM, port_scene

SMALL = dict(width=32, height=24, max_depth=1, sky=True)


def _loop(**kw):
    cfg = RenderConfig(**{**SMALL, **kw.pop("cfg", {})})
    return FrameLoop(port_scene(_instanced_scene()), cfg, two_level=True,
                     device="cpu", **kw)


def test_step_is_the_rendered_frame():
    loop = _loop()
    img = loop.step(Camera(**CAM))
    cams = renderer.camera_arrays(Camera(**CAM), loop.config, "cpu")
    ref = renderer.render_frames(loop.scene, loop.accel, cams, 0, 1,
                                 loop.config)[0]
    assert img.shape == (24, 32, 3) and loop.frame == 1
    assert torch.equal(img, ref)


def test_accumulate_keeps_the_running_mean():
    """accum = (accum * n + img) / (n + 1), as the JAX _post_stages: a
    still scene's mean is the frame itself."""
    loop = _loop(cfg=dict(accumulate=True))
    first = loop.step(Camera(**CAM)).clone()
    for _ in range(3):
        img = loop.step(Camera(**CAM))
    torch.testing.assert_close(img, first, rtol=1e-6, atol=1e-6)
    assert torch.equal(loop.accum, img) and loop.frame == 4
    loop.reset_history()
    assert loop.frame == 0 and not loop.accum.any()


def test_set_resolution_keeps_the_accel():
    loop = _loop()
    accel = loop.accel
    loop.step(Camera(**CAM))
    loop.set_resolution(16, 12)
    assert loop.accel is accel and loop.frame == 0
    assert loop.step(Camera(**CAM)).shape == (12, 16, 3)
    assert loop.accum.shape == (12, 16, 3)


def test_set_instance_transform_refits_the_tlas():
    """Moving the sphere at the origin: the loop's table is the refit of
    the transforms, its BLAS region is untouched, and the frame changes
    where the sphere was."""
    loop = _loop()
    before_img = loop.step(Camera(**CAM)).clone()
    before = loop.accel
    loop.set_instance_transform(1, position=(0.0, -8.0, 0.0))
    after = loop.accel
    insts = loop.scene_obj.instances
    want = tlas.refit_two_level(
        before, *[np.stack([getattr(i, k) for i in insts])
                  for k in ("transform", "inverse_transform",
                            "normal_matrix")])
    assert torch.equal(after.w8_nodes, want.w8_nodes)
    rows = before.w8_tlas_nw // 16
    assert torch.equal(after.w8_nodes[rows:], before.w8_nodes[rows:])
    assert not torch.equal(after.w8_nodes[:rows], before.w8_nodes[:rows])
    assert insts[1].position == (0.0, -8.0, 0.0)
    img = loop.step(Camera(**CAM))
    assert (img - before_img).abs().max() > 0.1


def test_single_level_loop_renders_and_refuses_animation():
    loop = FrameLoop(port_scene(_instanced_scene()), RenderConfig(**SMALL),
                     cull_threshold_px=0.0, device="cpu")
    assert loop.step(Camera(**CAM)).shape == (24, 32, 3)
    with pytest.raises(ValueError):
        loop.set_instance_transform(1, position=(0.0, 0.0, 0.0))


@pytest.mark.parametrize("kw", [dict(mesh=object())])
def test_loop_refusals(kw):
    with pytest.raises(NotImplementedError):
        _loop(**kw)


def test_unknown_upscale_mode_raises():
    with pytest.raises(ValueError, match="upscale_mode"):
        _loop(cfg=dict(upscale=2, upscale_mode="bicubic"))
