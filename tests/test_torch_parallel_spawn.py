"""Two ranks of hrt_tpu_torch.parallel on the CPU over gloo: the JAX
package's multi-chip dry run (__graft_entry__.dryrun_multichip) at world
size 2.  The test spawns two worker processes (this file's `worker`);
each renders its band of the tiled frame and steps FrameLoop(mesh) with
the post stages, walks its shard of the triangle pool, takes a
data-parallel upscaler step, renders its farm frames, and runs the
render command with --devices 2 under torchrun's variables, set by
hand.  Each checks what it computed against the one-process result, and
the test checks that every farm frame was rendered once and that the
--devices 2 PNG equals --devices 1's.  The workers import neither JAX
nor the JAX package."""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

WORLD = 2
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = ["--scene", "demo", "--width", "32", "--height", "24",
         "--max-depth", "1", "--sky", "--traversal", "bvh", "--device",
         "cpu", "--frames", "2", "--orbit", "--stats"]


def worker(rank: int, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    from hrt_tpu_torch import cli, renderer
    from hrt_tpu_torch.config import RenderConfig
    from hrt_tpu_torch.frameloop import FrameLoop
    from hrt_tpu_torch.models import upscaler
    from hrt_tpu_torch.models.camera import Camera, orbit_camera
    from hrt_tpu_torch.models.scene import reference_demo_scene
    from hrt_tpu_torch.ops import lbvh, traversal
    from hrt_tpu_torch.ops.v3 import V3
    from hrt_tpu_torch.parallel import farm, scene_shard, tiles

    report = {}
    # The render command, its group started from the torchrun variables.
    cli.main(SMOKE + ["--devices", str(WORLD), "--out",
                      os.path.join(out_dir, "tiled.png")])
    assert not dist.is_initialized()

    tiles.init_group("cpu", WORLD, rank, f"file://{out_dir}/store")
    mesh = tiles.make_mesh(WORLD, device="cpu")
    assert mesh.get_local_rank() == rank

    # 1. The tiled frame: every rank holds the whole frame.
    cfg = RenderConfig(width=64, height=8 * WORLD, max_depth=2, sky=True,
                       indirect=True, jitter=True)
    scene = tiles.replicate(reference_demo_scene().build("cpu"), mesh)
    cams = renderer.camera_arrays(Camera(), cfg, "cpu")
    img = tiles.render_frame_tiled(scene, None, cams, 1, cfg, mesh)
    assert torch.equal(img, renderer.render_rows(scene, None, cams, 0,
                                                 cfg.height, cfg, frame=1))
    mean, peak = tiles.frame_stats_psum(
        tiles.render_band(scene, None, cams, 1, cfg, rank, WORLD))
    lum = img @ torch.tensor([0.2126, 0.7152, 0.0722])
    torch.testing.assert_close(mean, lum.mean(), rtol=1e-6, atol=0)
    assert float(peak) == float(lum.max())

    # 1b. Two post steps of FrameLoop(mesh) against the loop alone.
    post = RenderConfig(width=64, height=8 * WORLD, max_depth=1, sky=True,
                        denoise=True, accumulate=True, upscale=2,
                        upscale_mode="temporal")

    def two_frames(m):
        loop = FrameLoop(reference_demo_scene(), post, cull_threshold_px=0.0,
                         mesh=m, device=None if m else "cpu")
        return [loop.step(Camera()).clone() for _ in range(2)]

    for got, want in zip(two_frames(mesh), two_frames(None)):
        assert got.shape == (16 * WORLD, 128, 3) and torch.equal(got, want)
    try:
        FrameLoop(reference_demo_scene(), RenderConfig(width=64, height=17),
                  mesh=mesh)
        raise AssertionError("a height of 17 over 2 ranks was taken")
    except ValueError:
        pass

    # 2. Scene-sharded tracing: the combined hits, on every rank.
    data = reference_demo_scene().build("cpu", pad=WORLD * 128)
    sharded, accs = scene_shard.build_sharded_accel(data, WORLD, leaf_size=8)
    g = torch.Generator().manual_seed(0)
    o = torch.tensor([0.0, 0.0, -3.0]) + 0.5 * torch.rand((256, 3),
                                                          generator=g)
    d = torch.nn.functional.normalize(
        torch.rand((256, 3), generator=g) - torch.tensor([0.5, 0.5, 0.0]),
        dim=-1)
    hits = scene_shard.closest_hit_sharded(sharded, accs, o, d, mesh,
                                           leaf_size=8)
    t_per = sharded.tri_v0.shape[1]
    local = [scene_shard.shard_closest_hit(a, o, d, s, t_per)
             for s, a in enumerate(accs)]
    for a, b in zip(hits, scene_shard.combine_hits(
            *(torch.stack(h) for h in zip(*local)))):
        assert torch.equal(a, b)
    whole = traversal.closest_hit_bvh_p(
        None, lbvh.build_bvh(data, 8), V3(*o.unbind(-1)), V3(*d.unbind(-1)),
        1e-3, 1e32)
    assert torch.equal(hits[1] >= 0, whole[1] >= 0)
    both = whole[1] >= 0
    report["hit_share"] = float(both.float().mean())
    torch.testing.assert_close(hits[0][both], whole[0][both], rtol=1e-5,
                               atol=0)

    # 3. A data-parallel upscaler step on a 4-crop batch.
    net, opt = upscaler.create(device="cpu")
    ref, ref_opt = upscaler.create(device="cpu")
    g = torch.Generator().manual_seed(7)
    lr = torch.rand((4, 8, 8, 3), generator=g)
    hr = torch.rand((4, 16, 16, 3), generator=g)
    for _ in range(2):
        loss = upscaler.train_step(net, opt, lr, hr, group=mesh.get_group())
        want = upscaler.train_step(ref, ref_opt, lr, hr)
        torch.testing.assert_close(loss, want, rtol=1e-6, atol=0)
    for p, q in zip(net.parameters(), ref.parameters()):
        torch.testing.assert_close(p, q, rtol=1e-6, atol=1e-7)

    # 4. The farm: this rank's block of 5 frames.
    plan = farm.initialize()
    assert (plan.process_index, plan.process_count) == (rank, WORLD)
    frame_cfg = RenderConfig(width=32, height=24, max_depth=1, sky=True)
    loop = FrameLoop(reference_demo_scene(), frame_cfg, cull_threshold_px=0,
                     device="cpu")
    done = []
    farm.render_frames(loop, lambda f: orbit_camera(f * 0.3), 5,
                       lambda f, im: done.append(f) if bool(
                           torch.isfinite(im).all()) else None, plan)
    report["farm"] = done
    dist.destroy_process_group()

    if rank == 0:
        cli.main(SMOKE + ["--out", os.path.join(out_dir, "one.png")])
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)


def test_two_ranks_over_gloo(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, WORLD_SIZE=str(WORLD), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port), OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join(
                   [ROOT, os.path.join(ROOT, "tests"),
                    os.environ.get("PYTHONPATH", "")]))
    env.pop("PYTEST_CURRENT_TEST", None)
    code = ("import sys, test_torch_parallel_spawn as t; "
            "t.worker(int(sys.argv[1]), sys.argv[2])")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(tmp_path)],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=120)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("a worker timed out")
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    reports = [json.loads((tmp_path / f"rank{r}.json").read_text())
               for r in range(WORLD)]
    assert reports[0]["farm"] == [0, 1, 2] and reports[1]["farm"] == [3, 4]
    assert all(r["hit_share"] > 0.3 for r in reports)
    from PIL import Image

    for f in range(2):
        tiled = np.asarray(Image.open(tmp_path / f"tiled_{f:04d}.png"))
        one = np.asarray(Image.open(tmp_path / f"one_{f:04d}.png"))
        assert tiled.shape == (24, 32, 3)
        np.testing.assert_array_equal(tiled, one)
    # Rank 0 alone wrote the PNGs and printed the stats line.
    assert '"frames": 2' in outs[0] and '"frames": 2' not in outs[1]
