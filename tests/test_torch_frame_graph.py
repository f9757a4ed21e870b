"""The port's frame programs (hrt_tpu_torch/graphs.py) on the CPU.

- `renderer.render_frames` with a 0-d tensor `frame0` against JAX's
  jitted `render_frames` with a uint32 `frame0`, on JAX's SAH accel, and
  bit for bit against the port's int path (render_rows frame by frame).
- `frameloop.frame_program` through the loop's runner (every input a
  tensor: the frame index too) against JAX's `frame_program` through its
  FrameLoop at frames 0, 1 and 5 (accumulate, jitter, SVGF and the
  temporal 2x upscaler), and bit for bit against the int path.
- The runner's bookkeeping with a stand-in for the capture (`StandIn`:
  the body runs at capture, and again at every replay, writing into the
  captured outputs as a graph's replay overwrites its pool): captures
  per key, the in-place refit, the launch counters, fresh outputs, and
  the op-by-op cases.

The card's graphs against the same bodies op by op are in
test_torch_cuda.py.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import bench
import jax.numpy as jnp
from hrt_tpu.config import RenderConfig as JRenderConfig
from hrt_tpu.frameloop import FrameLoop as JFrameLoop
from hrt_tpu.models.camera import Camera as JCamera
from hrt_tpu.ops import lbvh as jlbvh
from hrt_tpu.renderer import camera_arrays as jcamera_arrays
from hrt_tpu.renderer import render_frames as jrender_frames
from hrt_tpu_torch import frameloop, graphs, renderer
from hrt_tpu_torch.config import RenderConfig
from hrt_tpu_torch.frameloop import FrameLoop
from hrt_tpu_torch.models.camera import Camera
from hrt_tpu_torch.models.scene import bench_scene
from hrt_tpu_torch.ops import intersect, traversal_wide8
from hrt_tpu_torch.utils.interop import accel_from_numpy

from test_tlas import _instanced_scene
from test_torch_build import jax_accel_dict
from test_torch_native import jax_native_lib
from test_torch_path import BENCH_CAM, _check, _psnr4
from test_torch_post import cam_at, committed_npz, flax_params
from test_torch_tlas import CAM, port_scene


@pytest.fixture(scope="module", autouse=True)
def _jax_native_sah():
    """JAX's build_bvh_sah through its native builder, never the LBVH
    fallback (test_torch_native.jax_native_lib)."""
    jax_native_lib()


# 32x24 frames; JAX walks its plain BVH loop and plain BRDF, as the
# other parity tests.
SMALL = dict(width=32, height=24, sky=True, traversal="bvh",
             shade_pallas=False)
FRAMES = dict(max_depth=1, jitter=True)
POST = dict(max_depth=1, jitter=True, accumulate=True, denoise=True,
            upscale=2, upscale_mode="temporal")
K = 3
POST_FRAMES = (0, 1, 5)


@pytest.fixture(scope="module")
def jax_frames():
    """JAX's SAH accel of the bench scene and its render_frames(frame0=
    uint32 0, k=K)."""
    js = bench.build_bench_scene().build()
    ja = jlbvh.build_bvh_sah(js, leaf_size=32)
    cfg = JRenderConfig(**SMALL, **FRAMES)
    imgs = jrender_frames(js, ja, jcamera_arrays(JCamera(**BENCH_CAM), cfg),
                          jnp.uint32(0), K, cfg)
    return accel_from_numpy(jax_accel_dict(ja), 32, "cpu"), np.asarray(imgs)


def test_render_frames_tensor_frame_matches_jax_and_the_int_path(
        jax_frames):
    """Frames 0..K-1 (frame 0 through the pixel centre, the others
    jittered by their seeds): the tensor-frame program against JAX's at
    the path tests' tolerances, and bit for bit against render_rows with
    int frames."""
    acc, want = jax_frames
    cfg = RenderConfig(**SMALL, **FRAMES)
    scene = bench_scene().build("cpu")
    cams = renderer.camera_arrays(Camera(**BENCH_CAM), cfg, "cpu")
    got = renderer.render_frames(scene, acc, cams,
                                 torch.tensor(0, dtype=torch.int64), K, cfg)
    assert got.shape == (K, 24, 32, 3)
    for i in range(K):
        _check(got[i].numpy(), want[i])
        one = renderer.render_rows(scene, acc, cams, 0, 24, cfg, frame=i)
        assert torch.equal(got[i], one)
    assert not torch.equal(got[0], got[1])


def _jax_post_frames():
    loop = JFrameLoop(bench.build_bench_scene(),
                      JRenderConfig(**SMALL, **POST),
                      upscaler_params=flax_params("temporal"))
    return {f: np.asarray(loop.step(cam_at(f, JCamera)))
            for f in range(max(POST_FRAMES) + 1)}


@pytest.fixture(scope="module")
def post_frames():
    """JAX's and the port's post loops, frames 0..5 of a moving camera,
    the frame index the port's body received, and the port's
    frame_program called op by op with int frames on the loop's scene
    and accel."""
    loop = FrameLoop(bench_scene(), RenderConfig(**SMALL, **POST),
                     upscaler_params=committed_npz("temporal"),
                     device="cpu")
    program = frameloop.frame_program
    seen = []

    def spy(*args, **kw):
        seen.append(args[6])                    # the frame index
        return program(*args, **kw)

    port, by_int = {}, {}
    dn, accum, up = loop.dn_state, loop.accum, loop.up_history
    prev = None
    for f in range(max(POST_FRAMES) + 1):
        cams = renderer.camera_arrays(cam_at(f), loop.config, "cpu")
        by_int[f], dn, accum, up = program(
            loop.scene, loop.accel, cams, cams if prev is None else prev,
            dn, accum, f, loop.config, net=loop.net, up_history=up)
        prev = cams
        frameloop.frame_program = spy
        try:
            port[f] = loop.step(cam_at(f))
        finally:
            frameloop.frame_program = program
    return _jax_post_frames(), port, by_int, seen


@pytest.mark.parametrize("f", POST_FRAMES)
def test_frame_program_matches_jax_and_the_int_path(post_frames, f):
    """The loop's frame program at frame f: PSNR > 45 (peak 4) against
    JAX's (the post-loop tests' gate: bf16 trunks on both sides), bit
    for bit against frame_program with an int frame; the runner handed
    the body the frame index as a 0-d tensor."""
    want, port, by_int, seen = post_frames
    got = port[f]
    assert got.shape == want[f].shape == (48, 64, 3)
    assert torch.isfinite(got).all()
    assert _psnr4(got.numpy(), want[f]) > 45.0
    assert torch.equal(got, by_int[f])
    assert isinstance(seen[f], torch.Tensor) and seen[f].dim() == 0
    assert int(seen[f]) == f


# ---- the runner's bookkeeping ----------------------------------------

class StandIn:
    """A capture on the CPU: the body runs once at capture and at every
    replay, writing into the outputs it made at capture (a graph's
    replay overwrites its pool).  A replay runs no host code, so the
    launch counters are put back after it."""

    device_type = "cpu"
    replays = 0

    def __init__(self, body, args, device):
        self.body, self.args = body, args
        self.outputs = body(*args)

    def replay(self):
        counters = graphs.launch_counters()
        before = [dict(c) for c in counters]
        out = self.body(*self.args)
        for c, b in zip(counters, before):
            c.clear()
            c.update(b)
        for s, o in zip(pytree.tree_flatten(self.outputs)[0],
                        pytree.tree_flatten(out)[0]):
            if s is not None:
                s.copy_(o)
        StandIn.replays += 1


def _body(scale):
    """x -> (x * scale + frame, x), counting one 'launch' of K1."""
    def body(x, frame):
        traversal_wide8.LAUNCHES["closest"] += 1
        return x * scale + frame, x
    return body


def test_runner_captures_once_per_key_and_drops_the_oldest():
    progs = graphs.Programs(2, capture=StandIn)
    x = torch.arange(4.0)
    for _ in range(3):
        progs("a", _body(2.0), (x, 1), "cpu")
    assert progs.captures == 1
    progs("b", _body(3.0), (x, 1), "cpu")
    progs("a", _body(2.0), (x[:3], 1), "cpu")     # a new shape: captures
    assert progs.captures == 3
    out, _ = progs("b", _body(3.0), (x, 2), "cpu")
    assert progs.captures == 3 and torch.equal(out, x * 3.0 + 2)
    progs("a", _body(2.0), (x, 1), "cpu")         # dropped: captures again
    assert progs.captures == 4


def test_runner_replays_count_launches_and_return_fresh_tensors():
    progs = graphs.Programs(1, capture=StandIn)
    start = traversal_wide8.LAUNCHES["closest"]
    replays = StandIn.replays
    outs = [progs("k", _body(2.0), (torch.full((3,), float(i)), i), "cpu")
            for i in range(4)]
    # One launch per call: the warm-up's, then one per replay; the
    # capture's own host run is taken back.
    assert traversal_wide8.LAUNCHES["closest"] == start + 4
    assert StandIn.replays == replays + 3 and progs.captures == 1
    for i, (y, x) in enumerate(outs):
        assert torch.equal(y, torch.full((3,), 3.0 * i))
        assert torch.equal(x, torch.full((3,), float(i)))
    static = progs.last.out_flat
    assert all(y.data_ptr() not in {s.data_ptr() for s in static}
               for y, _ in outs)


def test_runner_runs_op_by_op_where_it_must(monkeypatch):
    progs = graphs.Programs(1, capture=StandIn)
    x = torch.ones(2)
    with graphs.disable():
        out, _ = progs("k", _body(2.0), (x, 5), "cpu")
    assert progs.captures == 0 and torch.equal(out, x * 2 + 5)
    progs("k", _body(2.0), (x, 5), "cpu", eager=True)
    monkeypatch.setattr(traversal_wide8, "GUARDS", True)
    progs("k", _body(2.0), (x, 5), "cpu")
    monkeypatch.setattr(traversal_wide8, "GUARDS", False)
    monkeypatch.setattr(intersect, "DEBUG_COUNTERS", True)
    progs("k", _body(2.0), (x, 5), "cpu")
    assert progs.captures == 0
    # A CPU tensor with the card's capture runs op by op.
    assert graphs.Programs(1)("k", _body(2.0), (x, 5), "cpu")[0].sum() == 14


def _instanced_loop(capture):
    loop = FrameLoop(port_scene(_instanced_scene()),
                     RenderConfig(width=32, height=24, max_depth=1, sky=True),
                     two_level=True, device="cpu")
    loop.program = graphs.Programs(1, capture=capture)
    return loop


def test_refit_replays_the_loop_program_and_a_new_size_captures():
    """An animated two-level loop: the refit writes into the captured
    tables, so the loop captures once and its frames are the op-by-op
    loop's, bit for bit; set_resolution drops the graph and the next
    step captures again."""
    graphed, eager = _instanced_loop(StandIn), _instanced_loop(StandIn)
    frames = []
    for f in range(3):
        for loop in (graphed, eager):
            loop.set_instance_transform(1, position=(0.0, -0.5 * f, 0.0))
        with graphs.disable():
            want = eager.step(Camera(**CAM))
        got = graphed.step(Camera(**CAM))
        assert torch.equal(got, want)
        frames.append(got)
    assert graphed.captures == 1 and eager.captures == 0
    assert not torch.equal(frames[0], frames[2])
    graphed.set_resolution(16, 12)
    assert graphed.program.last is None
    assert graphed.step(Camera(**CAM)).shape == (12, 16, 3)
    assert graphed.captures == 2


def test_constant_is_made_once():
    a = graphs.constant((0.5, 0.25), "cpu")
    assert a is graphs.constant((0.5, 0.25), "cpu")
    assert a.dtype == torch.float32 and a.tolist() == [0.5, 0.25]


def test_signature_follows_addresses():
    scene = bench_scene().build("cpu")
    sig = graphs.signature(scene)
    assert sig == graphs.signature(scene)
    moved = scene._replace(lights=scene.lights.clone())
    assert graphs.signature(moved) != sig
    cfg = dataclasses.replace(RenderConfig(), width=8)
    assert graphs.signature(cfg) == graphs.signature(
        dataclasses.replace(RenderConfig(), width=8))
    with pytest.raises(TypeError):
        graphs.signature(object())


def test_first_frame_probe_needs_a_card():
    """The first-frame probe measures on the card only: without one it
    stops before it starts a run."""
    from hrt_tpu_torch import first_frame

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        first_frame.main([])
