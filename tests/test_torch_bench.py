"""The port's measuring entry points (hrt_tpu_torch.bench, .bench_full,
.profile_frame, .bench_bigscene and utils/profiling's device-time
readers) against the JAX programs they stand for, on the CPU.

The JAX programs are run as they are, with their expensive calls
replaced by recording stubs: `scripts/bench_full.py`'s `main` with
`hrt_tpu.frameloop.FrameLoop` and its own `time_loop` stubbed (each
config's scene, RenderConfig, `two_level` and camera recorded),
`bench.main` with JAX's `build_bvh_sah` and `render_frames` stubbed,
and `scripts/bench_bigscene.py`'s `main` with its SAH build and walk
stubbed.  What they recorded is held against the port's: every field
of JAX's RenderConfig equal, the built scenes' arrays bit for bit,
cameras equal, camera rays within 1e-6, and bench.py's ray count.  The
port's entry points then run small on the CPU (the kernels' plain
versions): one JSON line each, written where `--out` says.  The device
readers raise on a CPU and give the union of overlapping intervals.
"""
import dataclasses
import hashlib
import importlib.util
import json
import os
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jbench
from hrt_tpu_torch import bench, bench_bigscene, bench_full, profile_frame
from hrt_tpu_torch.models import scene as tscene
from hrt_tpu_torch.utils import profiling
from hrt_tpu_torch.utils.logging import rays_per_frame

from test_torch_native import jax_native_lib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _jax_native_sah():
    """JAX's build_bvh_sah through its native builder, never the LBVH
    fallback (test_torch_native.jax_native_lib)."""
    jax_native_lib()


class _Stop(Exception):
    """Ends a JAX program at its first expensive call."""


def _load_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_bench_full(tmp_path_factory):
    """What scripts/bench_full.py's main builds for each config: the
    FrameLoop's arguments and built scene, the camera, the record."""
    import hrt_tpu.frameloop as jframeloop

    jbf = _load_script("bench_full")
    loops, cams = [], []

    class RecordingLoop:
        def __init__(self, scene, cfg, **kw):
            self.scene_obj, self.config, self.kw = scene, cfg, kw
            self.scene = scene.build()
            loops.append(self)

    def time_loop(loop, cam):
        cams.append(cam)
        cfg = loop.config
        return 1.0, None, (cfg.height * cfg.upscale,
                           cfg.width * cfg.upscale, 3)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jframeloop, "FrameLoop", RecordingLoop)
        mp.setattr(jbf, "time_loop", time_loop)
        mp.delenv("HRT_BENCH_ONLY", raising=False)
        mp.chdir(tmp_path_factory.mktemp("jax_bench_full"))
        jbf.main()
        with open("BENCH_FULL.json") as f:
            recs = json.load(f)
    return {r["config"]: (loop, cam, r)
            for r, loop, cam in zip(recs, loops, cams)}


def _scene_equal(ts, js):
    """A port SceneData equals a JAX one: every array bit for bit, the
    light tree's permutation equal and its pair tables within 1e-6."""
    for field in tscene.SceneData._fields:
        if field == "light_tree":
            continue
        a, b = getattr(ts, field).numpy(), np.asarray(getattr(js, field))
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert (ts.light_tree is None) == (js.light_tree is None)
    if ts.light_tree is not None:
        np.testing.assert_array_equal(ts.light_tree.perm.numpy(),
                                      np.asarray(js.light_tree.perm))
        for a, b in zip(ts.light_tree.pair, js.light_tree.pair):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def _config_equal(tcfg, jcfg):
    for f in dataclasses.fields(jcfg):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name


def _camera_equal(tcam, jcam):
    for f in dataclasses.fields(jcam):
        np.testing.assert_array_equal(
            np.asarray(getattr(tcam, f.name), np.float64),
            np.asarray(getattr(jcam, f.name), np.float64), err_msg=f.name)


@pytest.mark.parametrize("index", range(7))
def test_bench_full_config_matches_jax(jax_bench_full, index):
    """Config `index` of the port's bench_full is JAX's: name and order,
    `two_level`, culling off, every RenderConfig field, the built scene,
    the camera, the notes and bench.py's ray count."""
    assert list(jax_bench_full) == [c.name for c in bench_full.configs()]
    bc = bench_full.configs()[index]
    loop, jcam, rec = jax_bench_full[bc.name]
    assert loop.kw == {"cull_threshold_px": 0.0,
                       "two_level": bc.two_level}
    _config_equal(bc.config, loop.config)
    ts = bc.scene().build("cpu")
    _scene_equal(ts, loop.scene)
    _camera_equal(bc.camera, jcam)
    assert bc.notes == rec["notes"]
    assert rec["max_depth"] == bc.config.max_depth
    assert rec["resolution"] == f"{bc.config.width}x{bc.config.height}"
    nl = ts.lights.shape[0]
    assert rays_per_frame(bc.config, nl) == jbench.rays_per_frame(
        loop.config, nl)


def test_bench_scene_and_config_match_jax(monkeypatch):
    """bench.py's main, stopped at its first render_frames: its scene,
    leaf size, config, camera and frames per call are the port's."""
    import hrt_tpu.ops.lbvh as jlbvh
    import hrt_tpu.renderer as jrenderer

    seen = {}

    def build(scene, leaf_size):
        seen.update(scene=scene, leaf_size=leaf_size)
        return "accel"

    def render_frames(scene, accel, cams, frame0, k, cfg):
        seen.update(cams=cams, frame0=int(frame0), k=k, cfg=cfg)
        raise _Stop

    monkeypatch.setattr(jlbvh, "build_bvh_sah", build)
    monkeypatch.setattr(jrenderer, "render_frames", render_frames)
    with pytest.raises(_Stop):
        jbench.main()
    cfg = bench.bench_config()
    _config_equal(cfg, seen["cfg"])
    assert seen["leaf_size"] == bench.LEAF_SIZE
    assert (seen["frame0"], seen["k"]) == (0, bench.parse_args([]).iters)
    assert bench.parse_args([]).batches == 4
    _scene_equal(tscene.bench_scene().build("cpu"), seen["scene"])
    _scene_equal(tscene.bench_scene().build("cpu"),
                 jbench.build_bench_scene().build())
    cams = bench.camera_arrays(bench.BENCH_CAMERA, cfg, "cpu")
    for a, b in zip(cams, seen["cams"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_bench_main_prints_one_line(capsys):
    res = bench.main(["--device", "cpu", "--width", "64", "--height", "48",
                      "--iters", "2", "--batches", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec == res["record"]
    assert rec["metric"] == "Mrays/sec/chip" and rec["unit"] == "Mray/s"
    assert rec["value"] > 0 and rec["median"] > 0
    assert rec["vs_baseline"] is None and rec["device"] == "cpu"
    assert len(rec["batch_ms"]) == 1 and rec["batch_event_ms"] is None
    assert rec["rays_per_frame"] == 64 * 48 * 3        # 2 lights
    assert res["frames"].shape == (2, 48, 64, 3)
    assert torch.isfinite(res["frames"]).all()


@pytest.mark.parametrize("mod", [bench, bench_full, profile_frame,
                                 bench_bigscene],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_entry_points_raise_without_a_card(mod):
    """Each entry point takes the card by default and raises without
    one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_bench_full_only_writes_its_out_file(monkeypatch, tmp_path, capsys):
    """`--only primary` at 16x12 on the CPU prints one line with
    bench_full's keys and writes `--out`; a second `--only` run merges
    into it; the JAX run's BENCH_FULL.json is left as it was."""
    before = _sha(os.path.join(ROOT, "BENCH_FULL.json"))
    monkeypatch.chdir(ROOT)
    out = str(tmp_path / "bf.json")
    small = ["--device", "cpu", "--resolution", "16x12", "--out", out]
    recs = bench_full.main(small + ["--only", "primary"])
    line = json.loads(capsys.readouterr().out.strip())
    assert [r["config"] for r in recs] == ["primary_800x600"]
    assert line == recs[0]
    assert {"config", "resolution", "output", "ms_per_frame",
            "device_ms_per_frame", "mrays_per_sec", "device_mrays_per_sec",
            "max_depth", "notes", "device", "peak_bytes"} == set(line)
    assert line["device_ms_per_frame"] is None and line["device"] == "cpu"
    assert line["resolution"] == "16x12" and line["output"] == "12x16"
    assert line["ms_per_frame"] > 0 and line["mrays_per_sec"] > 0
    bench_full.main(small + ["--only", "mesh_bvh"])
    with open(out) as f:
        assert [r["config"] for r in json.load(f)] == [
            "primary_800x600", "mesh_bvh_800x600"]
    assert _sha(os.path.join(ROOT, "BENCH_FULL.json")) == before
    assert bench_full.parse_args([]).out == bench_full.OUT
    with open(os.path.join(ROOT, ".gitignore")) as f:
        ignored = f.read().split()
    assert bench_full.OUT in ignored
    assert profile_frame.parse_args([]).dir + "/" in ignored


def test_profile_frame_on_the_cpu_reports_host_ops(tmp_path, capsys):
    """On the CPU profile_frame writes its trace and reports host ops,
    with every device key null."""
    out = profile_frame.main(["--device", "cpu", "--cfg", "bench",
                              "--resolution", "16x12", "--frames", "1",
                              "--top", "5", "--dir", str(tmp_path / "tr")])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == out
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0
    assert out["device_ms_per_frame"] is None and out["busy"] is None
    assert out["launches_per_frame"] is None and out["device"] == "cpu"
    assert out["cpu_ms_per_frame"] > 0 and len(out["top"]) == 5
    assert set(out["stages"]) == {"set-up", "warm-up", "frames"}


def _fake_profile(intervals_us, device="CUDA", name="kernel"):
    dt = getattr(torch.autograd.DeviceType, device)
    ev = [types.SimpleNamespace(name=name, device_type=dt,
                                time_range=types.SimpleNamespace(
                                    start=a, end=b))
          for a, b in intervals_us]
    ev.append(types.SimpleNamespace(
        name="cpu_op", device_type=torch.autograd.DeviceType.CPU,
        time_range=types.SimpleNamespace(start=0.0, end=1e6)))
    return types.SimpleNamespace(events=lambda: ev)


def test_busy_share_is_the_union_of_device_intervals():
    """Overlapping kernels (two streams) count once; nested ones too; a
    CPU event never counts, nor a program span's device annotation."""
    prof = _fake_profile([(0.0, 10.0), (5.0, 15.0), (20.0, 25.0),
                          (21.0, 22.0)])
    span = _fake_profile([(0.0, 40.0)], name="hrt.frameloop.step")
    both = types.SimpleNamespace(events=lambda: prof.events()
                                 + span.events())
    assert profiling.interval_union([(0, 10), (5, 15), (20, 25),
                                     (21, 22)]) == 20.0
    assert profiling.busy_share(prof, 0.04) == pytest.approx(0.5)
    assert profiling.busy_share(both, 0.04) == pytest.approx(0.5)
    # The summed times would read 0.7.
    with pytest.raises(RuntimeError, match="no device activity"):
        profiling.busy_share(_fake_profile([]), 1.0)


def test_device_ms_per_call_profiles_again_before_it_raises(monkeypatch,
                                                           caplog):
    """A window whose profile holds no device activity is logged,
    counted and profiled once more; two such windows raise, never a 0 or
    a nan."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as empty:
        torch.ones(64).sum()
    traced = types.SimpleNamespace(key_averages=lambda: [
        types.SimpleNamespace(key="k", count=4, self_device_time_total=40.0,
                              device_type=torch.autograd.DeviceType.CUDA)])
    windows = []

    def fake(fn, calls, device):
        windows.append(calls)
        return (empty if len(windows) < 3 else traced), 1.0

    monkeypatch.setattr(profiling, "profile_calls", fake)
    monkeypatch.setattr(profiling, "EMPTY_WINDOWS", 0)
    with caplog.at_level("WARNING", logger="hrt_tpu_torch"), \
            pytest.raises(RuntimeError, match="no device activity"):
        profiling.device_ms_per_call(lambda: None, calls=4)
    assert windows == [4, 4] and profiling.EMPTY_WINDOWS == 2
    assert [r.getMessage() for r in caplog.records] == [
        "profiler window of 4 call(s) held no device activity (1 in this "
        "process); profiling it once more",
        "profiler window of 4 call(s) held no device activity (2 in this "
        "process)"]
    assert profiling.device_ms_per_call(lambda: None, calls=4) == 0.01
    assert windows == [4, 4, 4] and profiling.EMPTY_WINDOWS == 2


def test_device_readers_raise_on_the_cpu():
    """No device time exists on the CPU: the readers raise, never a 0
    or a nan."""
    from torch.profiler import ProfilerActivity, profile

    with pytest.raises(ValueError, match="CUDA device"):
        profiling.device_ms_per_call(lambda: torch.ones(8).sum(),
                                     device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        profiling.profile_calls(lambda: torch.ones(8).sum(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            profiling.device_ms_per_call(lambda: torch.ones(8).sum())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(64).sum()
    with pytest.raises(RuntimeError, match="no device activity"):
        profiling.device_op_totals(prof)
    with pytest.raises(RuntimeError, match="no device activity"):
        profiling.busy_share(prof, 1.0)
    assert profiling.device_name("cpu") == "cpu"


@pytest.mark.parametrize("name,entry", [
    ("void (anonymous namespace)::bvh8_packet_kernel<24, true, false>"
     "(float const*, int)", "hrt_bvh8_trace:bvh8_packet_kernel<24, true, "
     "false>"),
    ("(anonymous namespace)::brdf_light_major_kernel(BrdfArgs)",
     "hrt_brdf_light_major:brdf_light_major_kernel"),
    ("void (anonymous namespace)::tlas_skip_trace_kernel<true>(float "
     "const*)", "hrt_tlas_skip_trace:tlas_skip_trace_kernel<true>"),
    ("void (anonymous namespace)::skip_trace_kernel<false, (Mode)1>(float "
     "const*)", "hrt_skip_trace:skip_trace_kernel<false, (Mode)1>"),
    ("void at::native::vectorized_elementwise_kernel<4>(int)",
     "void at::native::vectorized_elementwise_kernel<4>(int)")])
def test_op_label_names_port_kernels_by_entry(name, entry):
    assert profiling.op_label(name) == entry


def test_bench_bigscene_matches_jax_and_brute_force(monkeypatch, capsys):
    """scripts/bench_bigscene.py --sub 2, stopped at its first walk: its
    scene bit for bit and its 512x384 rays within 1e-6 are the port's;
    the port's run at 64x48 walks K1's plain version, whose ids equal
    brute force's on >= 0.999 of 256 rays spread over the frame."""
    import hrt_tpu.ops.lbvh as jlbvh
    import hrt_tpu.ops.traversal_pallas as jtp

    seen = {}

    def build(scene, leaf_size):
        seen.update(scene=scene, leaf_size=leaf_size)
        return types.SimpleNamespace(
            flat=types.SimpleNamespace(nodes=jnp.zeros((8,), jnp.float32)))

    def closest_hit_p(scene, accel, o, d, t_min, t_max, **kw):
        seen.update(o=o, d=d, t_min=t_min, t_max=t_max)
        raise _Stop

    jbb = _load_script("bench_bigscene")
    monkeypatch.setattr(jlbvh, "build_bvh_sah", build)
    monkeypatch.setattr(jtp, "closest_hit_p", closest_hit_p)
    monkeypatch.setattr(sys, "argv", ["bench_bigscene.py", "--sub", "2"])
    with pytest.raises(_Stop):
        jbb.main()
    capsys.readouterr()
    _scene_equal(bench_bigscene.big_scene(2).build("cpu"), seen["scene"])
    assert seen["leaf_size"] == bench_bigscene.LEAF_SIZE
    assert (seen["t_min"], seen["t_max"]) == (bench_bigscene.T_MIN,
                                              bench_bigscene.T_MAX)
    o, d = bench_bigscene.camera_rays(512, 384, "cpu")
    for a, b in zip(list(o) + list(d), list(seen["o"]) + list(seen["d"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)

    rec = bench_bigscene.main(["--sub", "2", "--oracle-rays", "256",
                               "--device", "cpu", "--width", "64",
                               "--height", "48", "--reps", "1"])
    assert json.loads(capsys.readouterr().out.strip()) == rec
    assert rec["tris"] == seen["scene"].tri_v0.shape[0]
    assert rec["route"] == "K1" and rec["oracle_rays"] == 256
    assert rec["oracle_hits"] > 64 and rec["oracle_tri_match"] >= 0.999
    assert rec["oracle_t_maxerr"] < 1e-4 and rec["value"] > 0
