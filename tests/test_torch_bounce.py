"""The bounce stage of the path tracer (ops/bounce_kernel.py, K7's plain
version, argument block and routing) on the CPU: the plain version gives
the bits of the inline sequence it replaced in renderer.trace_paths, the
argument block takes the planes where they lie and refuses what the
kernel cannot read, and CPU tensors never launch the kernel.  The kernel
itself is held against the plain version on a card in
test_torch_cuda.py, on batches from `bounce_batch`."""
import dataclasses

import numpy as np
import pytest
import torch

from hrt_tpu_torch import renderer
from hrt_tpu_torch.config import CONFIGS
from hrt_tpu_torch.models import materials
from hrt_tpu_torch.models.camera import Camera
from hrt_tpu_torch.models.materials import MatP
from hrt_tpu_torch.models.scene import bench_scene
from hrt_tpu_torch.ops import bounce_kernel, lbvh, rng, v3
from hrt_tpu_torch.ops.v3 import V3

BENCH_CAM = dict(position=(0.0, -1.0, -6.0), rotation=(-0.15, 0.0, 0.0))
OFFSET = CONFIGS["path_tracing"].bounce_offset


def _unit(rs, n):
    a = rs.normal(size=(3, n)).astype(np.float32)
    return a / np.linalg.norm(a, axis=0)


def bounce_batch(seed: int, n: int, device, strided: bool = True):
    """The stage's inputs for n lanes, seeded: materials with metals,
    glass (transmission 1, ior 1.5), partial transmission, anisotropy
    and roughness at and below ROUGHNESS_MIN; unit normals facing
    views, a few grazing, entering and leaving faces; world positions,
    infinite on a tenth of the lanes (misses); throughputs, some below
    the retirement threshold; seed words with 0 and 0xFFFFFFFF; hit and
    active masks.  With `strided`, the material planes are rows of a
    transposed (n, 16 + MAT_W) table, as the frame's attribute gather
    gives them; else contiguous planes.  Returns the keyword arguments
    of sample_bounce without the offset and roulette flag."""
    rs = np.random.RandomState(seed)
    f = lambda lo, hi, k=n: rs.uniform(lo, hi, k).astype(np.float32)
    nrm = _unit(rs, n)
    view = _unit(rs, n)
    view = np.where((view * nrm).sum(0) < 0, -view, view)
    g = slice(0, n // 16)
    t = view[:, g] - (view[:, g] * nrm[:, g]).sum(0) * nrm[:, g]
    t /= np.linalg.norm(t, axis=0)
    view[:, g] = t + 1e-3 * nrm[:, g]
    view /= np.linalg.norm(view, axis=0)
    table = np.zeros((n, 16 + materials.MAT_W), np.float32)
    m = table[:, 16:]
    m[:, 0:3] = f(0, 1, (3, n)).T
    m[:, materials.METALLIC] = np.where(rs.rand(n) < 0.3, 1.0, f(0, 1))
    rough = f(0, 1)
    rough[:n // 8] = rs.choice([0.0, 1e-5, materials.ROUGHNESS_MIN], n // 8)
    m[:, materials.ROUGHNESS] = rough
    m[:, materials.ANISOTROPIC] = np.where(rs.rand(n) < 0.5, f(0, 0.9), 0.0)
    kind = rs.rand(n)
    glass = kind < 0.3
    m[:, materials.IOR] = np.where(glass, 1.5, f(1.0, 2.4))
    m[:, materials.TRANSMISSION] = np.where(
        glass, 1.0, np.where(kind < 0.5, f(0.2, 1), 0.0))
    m[glass, materials.METALLIC] = 0.0
    wp = f(-5, 5, (3, n))
    wp[:, rs.rand(n) < 0.1] = np.inf
    thr = f(0, 1, (3, n))
    thr[:, rs.rand(n) < 0.05] *= 1e-6
    words = rs.randint(0, 2**32, size=n, dtype=np.uint64).astype(np.int64)
    words[:2] = [0, 0xFFFFFFFF]
    t = lambda a: torch.as_tensor(a, device=device)
    if strided:
        mat = MatP.from_rows_t(t(table).T, base=16)
    else:
        mat = MatP.from_rows_t(t(np.ascontiguousarray(m.T)))
    return dict(mat=mat, n=V3(*map(t, nrm)), view=V3(*map(t, view)),
                world_pos=V3(*map(t, wp)), throughput=V3(*map(t, thr)),
                seed=t(words), entering=t(rs.rand(n) < 0.7),
                hit=t(rs.rand(n) < 0.85), active=t(rs.rand(n) < 0.9))


def _inline(mat, n, view, world_pos, throughput, seed, entering, hit, active,
            bounce_offset, roulette):
    """The bounce lines of trace_paths before the stage was one call."""
    basis = v3.orthonormal_basis(n)
    new_d, weight, seed, transmitted = bounce_kernel._sample_bounce_p(
        mat, n, view, seed, entering, basis)
    throughput = throughput * weight
    side = torch.where(transmitted, -1.0, 1.0)
    o = world_pos + n * (side * bounce_offset)
    d = new_d
    alive = v3.max_component(throughput) > 1e-5
    active = active & hit & alive
    if roulette:
        p_cont = torch.clamp(v3.max_component(throughput), 0.05, 0.95)
        u_rr, seed = rng.rand(seed)
        throughput = throughput * (1.0 / p_cont)
        active = active & (u_rr < p_cont)
    throughput = v3.where(active, throughput, 0.0)
    return o, d, throughput, seed, active


def bits(out):
    """The stage's outputs as one list of integer tensors (floats by
    their bit patterns), for comparisons bit for bit."""
    o, d, thr, seed, active = out
    return ([p.contiguous().view(torch.int32) for p in (*o, *d, *thr)]
            + [seed, active])


@pytest.mark.parametrize("roulette", [False, True])
@pytest.mark.parametrize("strided", [True, False])
def test_plain_equals_the_inline_sequence(roulette, strided):
    b = bounce_batch(11, 4096, "cpu", strided=strided)
    want = bits(_inline(**b, bounce_offset=OFFSET, roulette=roulette))
    got = bits(bounce_kernel.sample_bounce_plain(
        **b, bounce_offset=OFFSET, roulette=roulette))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    # The batch reaches every branch: transmitted lanes, retired lanes,
    # survivors.
    active = got[-1]
    assert 0.2 < active.float().mean() < 0.9
    words = b["seed"]
    draws = 6 if roulette else 5
    for _ in range(draws):
        _, words = rng.pcg(words)
    assert torch.equal(got[-2], words)


def test_cpu_route_is_the_plain_version_and_launches_nothing():
    b = bounce_batch(12, 1024, "cpu")
    before = dict(bounce_kernel.LAUNCHES)
    got = bits(bounce_kernel.sample_bounce(**b, bounce_offset=OFFSET,
                                           roulette=True))
    want = bits(bounce_kernel.sample_bounce_plain(**b, bounce_offset=OFFSET,
                                                  roulette=True))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert bounce_kernel.LAUNCHES == before


@pytest.mark.parametrize("depth,calls", [(5, 4), (3, 2), (1, 0)])
def test_trace_paths_runs_the_stage_once_a_bounce_depth(monkeypatch, depth,
                                                        calls):
    """A 16x12 path-traced CPU frame calls the stage once for each depth
    that bounces, with roulette from rr_start_depth, and launches no
    kernel; plain=True takes the plain version directly."""
    cfg = dataclasses.replace(CONFIGS["path_tracing"], width=16, height=12,
                              max_depth=depth)
    scene = bench_scene().build("cpu")
    accel = lbvh.build_bvh_sah(scene, leaf_size=32)
    cams = renderer.camera_arrays(Camera(**BENCH_CAM), cfg, "cpu")
    flags = []

    def counting(*args, **kw):
        flags.append(args[-1])
        return bounce_kernel.sample_bounce_plain(*args, **kw)

    monkeypatch.setattr(bounce_kernel, "sample_bounce", counting)
    before = dict(bounce_kernel.LAUNCHES)
    img = renderer.render_rows(scene, accel, cams, 0, 12, cfg, frame=1)
    assert flags == [d + 1 >= cfg.rr_start_depth for d in range(calls)]
    ref = renderer.render_rows(scene, accel, cams, 0, 12, cfg, frame=1,
                               plain=True)
    assert len(flags) == calls
    assert torch.equal(img, ref)
    assert bounce_kernel.LAUNCHES == before


def _pack(b, **over):
    nr = b["n"].x.shape[0]
    outs = dict(out=torch.empty((9, nr)),
                seed_out=torch.empty((nr,), dtype=torch.int64),
                active_out=torch.empty((nr,), dtype=torch.bool))
    kw = {**b, **outs, "bounce_offset": OFFSET, "roulette": True, **over}
    return bounce_kernel.pack_args(**kw)


def test_argument_block_reads_planes_where_they_lie():
    """Strided material rows keep their row stride, contiguous planes
    stride 1; the pointers are the planes' own (nothing copied)."""
    b = bounce_batch(13, 256, "cpu")
    a = _pack(b)
    width = 16 + materials.MAT_W
    assert list(a.stride)[:8] == [width] * 8
    assert list(a.stride)[8:] == [1] * 12
    assert a.plane[0] == b["mat"].color.x.data_ptr()
    assert a.plane[7] == b["mat"].transmission.data_ptr()
    assert a.seed == b["seed"].data_ptr() and a.seed_stride == 1
    assert list(a.flag) == [b[k].data_ptr()
                            for k in ("entering", "hit", "active")]
    assert (a.n, a.roulette) == (256, 1)
    assert a.bounce_offset == pytest.approx(OFFSET)
    assert a.roughness_min == pytest.approx(materials.ROUGHNESS_MIN)
    c = _pack(bounce_batch(13, 256, "cpu", strided=False), roulette=False)
    assert list(c.stride) == [1] * 20 and c.roulette == 0


@pytest.mark.parametrize("fault", ["dtype", "length", "device", "seed_dtype",
                                   "flag_dtype", "stride", "out_shape",
                                   "out_layout"])
def test_argument_block_refuses_what_the_kernel_cannot_read(fault):
    b = bounce_batch(14, 64, "cpu")
    over = {}
    if fault == "dtype":
        b["view"] = b["view"]._replace(y=b["view"].y.double())
    elif fault == "length":
        b["throughput"] = b["throughput"]._replace(z=b["throughput"].z[:-1])
    elif fault == "device":
        b["world_pos"] = b["world_pos"]._replace(
            x=torch.empty(64, device="meta"))
    elif fault == "seed_dtype":
        b["seed"] = b["seed"].to(torch.int32)
    elif fault == "flag_dtype":
        b["active"] = b["active"].to(torch.uint8)
    elif fault == "stride":
        b["n"] = b["n"]._replace(x=torch.zeros(()).expand(64))
    elif fault == "out_shape":
        over["out"] = torch.empty((3, 64))
    else:
        over["out"] = torch.empty((64, 9)).T
    with pytest.raises(ValueError, match="sample_bounce"):
        _pack(b, **over)
