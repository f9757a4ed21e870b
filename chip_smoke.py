#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (hrt_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from hrt_tpu_torch/csrc/, then drives the
port's two paths.  The bench frame: the bench scene (three icospheres + ground plane, two
point lights), SAH build with 32-triangle leaves and its BVH8 records,
and `render_frames` of 32 frames at 512x384 (max_depth=1, sky on), plus
one 1920x1080 frame.  The instanced frame: the JAX package's
`instanced_tlas_512x384` scene through FrameLoop(two_level=True), the
two-level build and K4, animated.  Phases:

  1. device facts (name, nvidia-smi power limit)
  2. kernel build, timed
  3. scene + accel on the card
  4. K1 (BVH8 walk) closest and any-hit vs its plain version on the
     frame's primary and light-major shadow batches; both vs brute force
     on a 4096-ray subset
  5. K2 (light-major Disney BRDF) vs its plain version on the frame's batch
  6. render_frames x32 through the kernels vs the plain-path frame; the
     launch counters must show 32 closest, 32 any-hit and 32 BRDF launches
  7. one 1920x1080 frame, same checks
  8. the JAX package's golden frames (tests/goldens/bench_direct,
     demo_parity, demo_sky at 64x48) rendered through the kernels
  9. CUDA-event times (median of 7): each kernel vs its plain version at
     the 512x384 shapes, ms/frame and Mray/s at both sizes
 10. the instanced scene (16x16 grid of icosphere instances on a ground
     plane, one light): two-level build on the card, timed
 11. K4 (two-level wide walk) closest and any-hit vs its plain version on
     the 512x384 frame's primary and shadow batches; both vs brute force
     over the flattened soup on 4096-ray subsets
 12. FrameLoop(two_level=True): 32 steps at 512x384, each after moving
     one sphere (set_instance_transform); the launch counters must show
     32 K4 closest, 32 K4 any-hit and 32 K2 launches; the last frame vs
     the plain-path frame and vs the soup frame through K1
 13. one 1920x1080 two-level frame, same checks
 14. CUDA-event times (median of 7): K4 vs its plain version at the
     512x384 shapes, one refit, ms/frame and Mray/s at both sizes

Exits non-zero, printing no result, without a CUDA device or when any
check fails.  The line before the last is the kernels JSON; the last is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BENCH_CAM = dict(position=(0.0, -1.0, -6.0), rotation=(-0.15, 0.0, 0.0))
K1_SOURCE = "hrt_tpu_torch/csrc/bvh8_trace.cu"
K1_REPLACES = "hrt_tpu/ops/traversal_wide8.py:679"
K2_SOURCE = "hrt_tpu_torch/csrc/brdf_light_major.cu"
K2_REPLACES = "hrt_tpu/ops/shade_pallas.py:98"
K4_SOURCE = "hrt_tpu_torch/csrc/tlas8_trace.cu"
K4_REPLACES = "hrt_tpu/ops/traversal_tlas8.py:438"


class Smoke:
    def __init__(self):
        self.failures: list[str] = []

    def check(self, ok: bool, what: str) -> None:
        print(f"  [{'ok' if ok else 'FAIL'}] {what}", flush=True)
        if not ok:
            self.failures.append(what)


def time_ms(fn, reps: int = 7) -> float:
    """Median CUDA-event time of fn() in ms, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def psnr4(a, b) -> float:
    from hrt_tpu_torch.utils.image import psnr

    return psnr(a.clamp(0, 4).cpu().numpy(), b.clamp(0, 4).cpu().numpy(),
                peak=4.0)


def host_ms(fn, reps: int = 7) -> float:
    """Median host-clock time of fn() in ms, each call ending in a
    synchronize, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def soup_agreement(ids, inst, t, bi, bt, tri_inst) -> float:
    """Share of rays whose closest hit agrees with brute force over the
    flattened soup: same hit/miss, and the same instance (through the
    soup's per-triangle instance table) unless the two hits tie in t."""
    hit, bhit = ids >= 0, bi >= 0
    oracle = tri_inst[bi.clamp(min=0).long()]
    tie = hit & bhit & ((t - bt).abs() <= 1e-5 * bt.abs())
    ok = (hit == bhit) & (~bhit | (inst == oracle) | tie)
    return float(ok.float().mean())


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    from hrt_tpu_torch import renderer
    from hrt_tpu_torch.config import RenderConfig
    from hrt_tpu_torch.kernels import build
    from hrt_tpu_torch.models.camera import Camera
    from hrt_tpu_torch.models.scene import bench_scene, reference_demo_scene
    from hrt_tpu_torch.ops import intersect, lbvh, shade_kernel
    from hrt_tpu_torch.ops import traversal_wide8 as k1

    sm = Smoke()
    dev = torch.device("cuda", 0)

    print("phase 1: device", flush=True)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"  torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {name} count {torch.cuda.device_count()}", flush=True)

    print("phase 2: kernel build", flush=True)
    t0 = time.perf_counter()
    path = build.build()
    build.load()
    print(f"  built {os.path.basename(path)} in "
          f"{time.perf_counter() - t0:.1f} s",
          flush=True)
    with open(path[:-3] + ".log") as f:
        for line in f:
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())

    print("phase 3: scene + accel", flush=True)
    t0 = time.perf_counter()
    scene = bench_scene().build(dev)
    accel = lbvh.build_bvh_sah(scene, leaf_size=32)
    torch.cuda.synchronize()
    facts = {
        "build_s": time.perf_counter() - t0,
        "triangles": int(scene.num_triangles),
        "pool_slots": int(accel.tri_v0.shape[0]),
        "record_rows": int(accel.w8.shape[0]), "depth": accel.w8_depth}
    print(f"  {facts}", flush=True)

    cfg = RenderConfig(width=512, height=384, max_depth=1, sky=True,
                       traversal="auto")
    cams = renderer.camera_arrays(Camera(**BENCH_CAM), cfg, dev)
    o, d = renderer.primary_rays(cams, cfg.height, 0, cfg)
    n = o.x.shape[0]
    tmax = torch.full((n,), intersect.INF, device=dev)
    prim = (o.x, o.y, o.z, d.x, d.y, d.z, tmax)

    print(f"phase 4: K1 on the frame's batches ({n} primary rays)",
          flush=True)
    kt, ktri, ku, kv = k1.trace_kernel(accel, *prim, cfg.t_min, True)
    pt, ptri, pu, pv = k1.trace_plain(accel, *prim, cfg.t_min, True)
    torch.cuda.synchronize()
    same = ktri == ptri
    hit = same & (ktri >= 0)
    rel_t = ((kt - pt).abs() / pt.abs().clamp(min=1e-6))[hit]
    k1c_err = float((kt - pt)[hit].abs().max())
    sm.check(float(same.float().mean()) >= 0.999,
             f"closest ids agree on {float(same.float().mean()):.6f} of rays")
    sm.check(float(rel_t.max()) <= 1e-4,
             f"closest t rel err {float(rel_t.max()):.3g} where ids agree "
             f"(max abs {k1c_err:.3g})")
    sm.check(float(hit.float().mean()) > 0.3,
             f"{float(hit.float().mean()):.3f} of primary rays hit")

    sh = renderer.surface_hits(scene, accel, o, d, cfg)
    lb = renderer.light_batch(scene, sh.normal, sh.world_pos, cfg,
                              ray_mask=sh.hit)
    shadow = (lb.origin.x, lb.origin.y, lb.origin.z, lb.l.x, lb.l.y,
              lb.l.z, lb.t_max)
    ns = lb.t_max.shape[0]
    kocc = k1.trace_kernel(accel, *shadow, cfg.t_min, False)
    pocc = k1.trace_plain(accel, *shadow, cfg.t_min, False)
    agree = float((kocc == pocc).float().mean())
    k1a_err = float((kocc.float() - pocc.float()).abs().max())
    sm.check(agree >= 0.999, f"any-hit occlusion agrees on {agree:.6f} of "
             f"{ns} shadow rays ({float(pocc.float().mean()):.3f} occluded)")

    sub = torch.arange(0, n, max(1, n // 4096), device=dev)[:4096]
    bt, bi, _, _ = intersect.closest_hit_bruteforce(
        torch.stack([o.x, o.y, o.z], 1)[sub],
        torch.stack([d.x, d.y, d.z], 1)[sub],
        scene.tri_v0, scene.tri_e1, scene.tri_e2, cfg.t_min)
    korig = torch.where(ktri[sub] >= 0,
                        accel.tri_perm[ktri[sub].clamp(min=0).long()], -1)
    porig = torch.where(ptri[sub] >= 0,
                        accel.tri_perm[ptri[sub].clamp(min=0).long()], -1)
    for who, ids, tt in (("kernel", korig, kt[sub]),
                         ("plain", porig, pt[sub])):
        # Ids agree up to equal-t ties (edges shared by two triangles).
        tie = (ids >= 0) & (bi >= 0) & ((tt - bt).abs() <= 1e-5 * bt.abs())
        a = float(((ids == bi) | tie).float().mean())
        sm.check(a >= 0.999, f"closest {who} vs brute force on 4096 rays: "
                 f"{a:.6f} (ids differ on {int((ids != bi).sum())} rays)")
    ssub = torch.arange(0, ns, max(1, ns // 4096), device=dev)[:4096]
    bocc = intersect.any_hit_bruteforce(
        torch.stack(shadow[0:3], 1)[ssub], torch.stack(shadow[3:6], 1)[ssub],
        scene.tri_v0, scene.tri_e1, scene.tri_e2, cfg.t_min,
        lb.t_max[ssub])
    for who, occ in (("kernel", kocc), ("plain", pocc)):
        a = float((occ[ssub] == bocc).float().mean())
        sm.check(a >= 0.999, f"any-hit {who} vs brute force on 4096 "
                 f"rays: {a:.6f}")

    print(f"phase 5: K2 on the frame's light-major batch ({ns})",
          flush=True)
    nl = scene.lights.shape[0]
    k2_args = (sh.mat, sh.normal, sh.view, lb.l, lb.relevant, nl)
    kf = shade_kernel.brdf_light_major_kernel(*k2_args)
    pf = shade_kernel.brdf_light_major_plain(*k2_args)
    k2_err, k2_ok = 0.0, True
    for a, b in zip(kf, pf):
        k2_err = max(k2_err, float((a - b).abs().max()))
        k2_ok &= bool(((a - b).abs() <= 1e-6 + 1e-4 * b.abs()).all())
    sm.check(k2_ok, f"BRDF within rtol 1e-4 / atol 1e-6 (max abs err "
             f"{k2_err:.3g}; {float(lb.relevant.float().mean()):.3f} "
             "relevant)")

    print("phase 6: render_frames x32 at 512x384", flush=True)
    for c in (k1.LAUNCHES, shade_kernel.LAUNCHES):
        for key in c:
            c[key] = 0
    imgs = renderer.render_frames(scene, accel, cams, 0, 32, cfg)
    torch.cuda.synchronize()
    launches = {"closest": k1.LAUNCHES["closest"],
                "any_hit": k1.LAUNCHES["any_hit"],
                "brdf_light_major": shade_kernel.LAUNCHES["brdf_light_major"]}
    sm.check(launches == {"closest": 32, "any_hit": 32,
                          "brdf_light_major": 32},
             f"launch counters {launches}")
    sm.check(tuple(imgs.shape) == (32, 384, 512, 3)
             and bool(torch.isfinite(imgs).all()),
             f"frames {tuple(imgs.shape)} finite")
    sm.check(bool((imgs == imgs[0]).all()), "32 frames identical")
    ref = renderer.render_frames(scene, accel, cams, 0, 1, cfg, plain=True)
    p512 = psnr4(imgs[0], ref[0])
    sm.check(p512 > 45.0, f"kernel frame vs plain frame PSNR {p512:.2f}")

    print("phase 7: one 1920x1080 frame", flush=True)
    cfg_hd = RenderConfig(width=1920, height=1080, max_depth=1, sky=True,
                          traversal="auto")
    cams_hd = renderer.camera_arrays(Camera(**BENCH_CAM), cfg_hd, dev)
    before = (dict(k1.LAUNCHES), dict(shade_kernel.LAUNCHES))
    img_hd = renderer.render_frames(scene, accel, cams_hd, 0, 1, cfg_hd)
    torch.cuda.synchronize()
    sm.check(k1.LAUNCHES["closest"] == before[0]["closest"] + 1
             and k1.LAUNCHES["any_hit"] == before[0]["any_hit"] + 1
             and shade_kernel.LAUNCHES["brdf_light_major"]
             == before[1]["brdf_light_major"] + 1,
             "1080p frame launched each kernel once")
    sm.check(tuple(img_hd.shape) == (1, 1080, 1920, 3)
             and bool(torch.isfinite(img_hd).all()), "1080p frame finite")
    ref_hd = renderer.render_frames(scene, accel, cams_hd, 0, 1, cfg_hd,
                                    plain=True)
    p1080 = psnr4(img_hd[0], ref_hd[0])
    sm.check(p1080 > 45.0, f"1080p kernel vs plain frame PSNR {p1080:.2f}")
    del ref_hd

    print("phase 8: golden frames at 64x48 through the kernels", flush=True)
    goldens = {
        "bench_direct": (bench_scene(), Camera(**BENCH_CAM), True),
        "demo_parity": (reference_demo_scene(), Camera(), False),
        "demo_sky": (reference_demo_scene(), Camera(), True)}
    gold_psnr = {}
    for gname, (sc, cam, sky_on) in goldens.items():
        g_scene = sc.build(dev)
        g_accel = lbvh.build_bvh_sah(g_scene, leaf_size=32)
        g_cfg = RenderConfig(width=64, height=48, max_depth=1, sky=sky_on)
        before = k1.LAUNCHES["closest"]
        img = torch.as_tensor(renderer.render(g_scene, cam, g_cfg, g_accel))
        gold = torch.as_tensor(np.load(os.path.join(
            ROOT, "tests", "goldens", f"{gname}.npz"))["image"])
        gold_psnr[gname] = psnr4(img, gold)
        sm.check(k1.LAUNCHES["closest"] == before + 1
                 and gold_psnr[gname] > 45.0,
                 f"{gname}: kernel frame vs golden PSNR "
                 f"{gold_psnr[gname]:.2f}")

    print("phase 9: times (CUDA events, median of 7)", flush=True)
    times = {
        "k1_closest": time_ms(lambda: k1.trace_kernel(
            accel, *prim, cfg.t_min, True)),
        "k1_closest_plain": time_ms(lambda: k1.trace_plain(
            accel, *prim, cfg.t_min, True)),
        "k1_any_hit": time_ms(lambda: k1.trace_kernel(
            accel, *shadow, cfg.t_min, False)),
        "k1_any_hit_plain": time_ms(lambda: k1.trace_plain(
            accel, *shadow, cfg.t_min, False)),
        "k2": time_ms(lambda: shade_kernel.brdf_light_major_kernel(
            *k2_args)),
        "k2_plain": time_ms(lambda: shade_kernel.brdf_light_major_plain(
            *k2_args)),
    }
    rays_512 = cfg.width * cfg.height * cfg.spp * (1 + nl)
    rays_hd = cfg_hd.width * cfg_hd.height * cfg_hd.spp * (1 + nl)
    ms_512 = time_ms(lambda: renderer.render_frames(
        scene, accel, cams, 0, 32, cfg), reps=5) / 32
    ms_hd = time_ms(lambda: renderer.render_frames(
        scene, accel, cams_hd, 0, 1, cfg_hd), reps=5)
    frame = {"512x384": {"ms_per_frame": ms_512,
                         "mrays_per_s": rays_512 / ms_512 / 1e3},
             "1920x1080": {"ms_per_frame": ms_hd,
                           "mrays_per_s": rays_hd / ms_hd / 1e3}}
    for k, v in times.items():
        print(f"  {k}: {v:.4f} ms", flush=True)
    for k, v in frame.items():
        print(f"  frame {k}: {v['ms_per_frame']:.4f} ms/frame, "
              f"{v['mrays_per_s']:.2f} Mray/s", flush=True)

    print("phase 10: instanced scene + two-level build", flush=True)
    from hrt_tpu_torch.frameloop import FrameLoop
    from hrt_tpu_torch.models.scene import instance_grid_scene
    from hrt_tpu_torch.ops import tlas
    from hrt_tpu_torch.ops import traversal_tlas8 as k4

    grid = instance_grid_scene()
    t0 = time.perf_counter()
    tl = tlas.build_two_level_flat(grid, 32, device=dev)
    torch.cuda.synchronize()
    tl_facts = {
        "build_s": time.perf_counter() - t0,
        "instances": len(grid.instances),
        "pool_slots": int(tl.tris.shape[0]),
        "record_rows": int(tl.w8_nodes.shape[0]),
        "w8_tlas_nw": tl.w8_tlas_nw, "tlas_depth": tl.tlas_depth,
        "blas_depth": tl.blas_depth, "stack": tl.stack}
    print(f"  {tl_facts}", flush=True)
    g_scene = grid.build(dev)
    print(f"  flattened soup: {g_scene.num_triangles} triangles", flush=True)
    sm.check(tl_facts["instances"] == 257 and tl.w8_tlas_nw == 256,
             "257 instances, 256-node TLAS region")

    g_cfg = RenderConfig(width=512, height=384, max_depth=1, sky=True)
    g_cams = renderer.camera_arrays(Camera(**BENCH_CAM), g_cfg, dev)
    go, gd = renderer.primary_rays(g_cams, g_cfg.height, 0, g_cfg)
    gn = go.x.shape[0]
    g_prim = (go.x, go.y, go.z, gd.x, gd.y, gd.z,
              torch.full((gn,), intersect.INF, device=dev))

    print(f"phase 11: K4 on the instanced frame's batches ({gn} primary "
          "rays)", flush=True)
    kt4, ktri4, kinst4, _, _ = k4.trace_kernel(tl, *g_prim, g_cfg.t_min,
                                               True)
    pt4, ptri4, pinst4, _, _ = k4.trace_plain(tl, *g_prim, g_cfg.t_min,
                                              True)
    torch.cuda.synchronize()
    same4 = (ktri4 == ptri4) & (kinst4 == pinst4)
    hit4 = same4 & (ktri4 >= 0)
    rel4 = ((kt4 - pt4).abs() / pt4.abs().clamp(min=1e-6))[hit4]
    k4c_err = float((kt4 - pt4)[hit4].abs().max())
    sm.check(float(same4.float().mean()) >= 0.999,
             f"closest tri + inst ids agree on "
             f"{float(same4.float().mean()):.6f} of rays")
    sm.check(float(rel4.max()) <= 1e-4,
             f"closest t rel err {float(rel4.max()):.3g} where ids agree "
             f"(max abs {k4c_err:.3g})")
    sm.check(float(hit4.float().mean()) > 0.3,
             f"{float(hit4.float().mean()):.3f} of primary rays hit")

    g_sh = renderer.surface_hits(g_scene, tl, go, gd, g_cfg)
    g_lb = renderer.light_batch(g_scene, g_sh.normal, g_sh.world_pos, g_cfg,
                                ray_mask=g_sh.hit)
    g_shadow = (g_lb.origin.x, g_lb.origin.y, g_lb.origin.z, g_lb.l.x,
                g_lb.l.y, g_lb.l.z, g_lb.t_max)
    gns = g_lb.t_max.shape[0]
    kocc4 = k4.trace_kernel(tl, *g_shadow, g_cfg.t_min, False)
    pocc4 = k4.trace_plain(tl, *g_shadow, g_cfg.t_min, False)
    agree4 = float((kocc4 == pocc4).float().mean())
    k4a_err = float((kocc4.float() - pocc4.float()).abs().max())
    sm.check(agree4 >= 0.999, f"any-hit occlusion agrees on {agree4:.6f} "
             f"of {gns} shadow rays "
             f"({float(pocc4.float().mean()):.3f} occluded)")

    gsub = torch.arange(0, gn, max(1, gn // 4096), device=dev)[:4096]
    bt4, bi4, _, _ = intersect.closest_hit_bruteforce(
        torch.stack([go.x, go.y, go.z], 1)[gsub],
        torch.stack([gd.x, gd.y, gd.z], 1)[gsub],
        g_scene.tri_v0, g_scene.tri_e1, g_scene.tri_e2, g_cfg.t_min)
    for who, ids, inst, tt in (("kernel", ktri4, kinst4, kt4),
                               ("plain", ptri4, pinst4, pt4)):
        a = soup_agreement(ids[gsub], inst[gsub], tt[gsub], bi4, bt4,
                           g_scene.tri_inst)
        sm.check(a >= 0.999, f"closest {who} vs soup brute force on 4096 "
                 f"rays (hit, instance, modulo ties): {a:.6f}")
    gssub = torch.arange(0, gns, max(1, gns // 4096), device=dev)[:4096]
    bocc4 = intersect.any_hit_bruteforce(
        torch.stack(g_shadow[0:3], 1)[gssub],
        torch.stack(g_shadow[3:6], 1)[gssub],
        g_scene.tri_v0, g_scene.tri_e1, g_scene.tri_e2, g_cfg.t_min,
        g_lb.t_max[gssub])
    for who, occ in (("kernel", kocc4), ("plain", pocc4)):
        a = float((occ[gssub] == bocc4).float().mean())
        sm.check(a >= 0.999, f"any-hit {who} vs soup brute force on 4096 "
                 f"rays: {a:.6f}")
    del bt4, bi4, bocc4

    print("phase 12: animated FrameLoop(two_level=True), 32 steps at "
          "512x384", flush=True)
    loop = FrameLoop(instance_grid_scene(), g_cfg, two_level=True,
                     device=dev)
    cam = Camera(**BENCH_CAM)
    home = [inst.position for inst in loop.scene_obj.instances]

    def move(f: int) -> None:
        """Frame f lifts and turns sphere 1 + 8f (a different one each
        frame)."""
        idx = 1 + (8 * f) % 256
        x, y, z = home[idx]
        loop.set_instance_transform(idx, position=(x, y - 0.4, z),
                                    rotation=(0.1 * f, 0.2 * f, 0.0))

    for c in (k1.LAUNCHES, k4.LAUNCHES, shade_kernel.LAUNCHES):
        for key in c:
            c[key] = 0
    for f in range(32):
        move(f)
        img = loop.step(cam)
    torch.cuda.synchronize()
    launches4 = {"k4_closest": k4.LAUNCHES["closest"],
                 "k4_any_hit": k4.LAUNCHES["any_hit"],
                 "brdf_light_major": shade_kernel.LAUNCHES["brdf_light_major"],
                 "k1": k1.LAUNCHES["closest"] + k1.LAUNCHES["any_hit"]}
    sm.check(launches4 == {"k4_closest": 32, "k4_any_hit": 32,
                           "brdf_light_major": 32, "k1": 0},
             f"launch counters {launches4}")
    sm.check(tuple(img.shape) == (384, 512, 3)
             and bool(torch.isfinite(img).all()),
             f"frame {tuple(img.shape)} finite")
    ref4 = renderer.render_frames(loop.scene, loop.accel, g_cams, 0, 1,
                                  g_cfg, plain=True)[0]
    p4 = psnr4(img, ref4)
    sm.check(p4 > 45.0, f"last frame vs plain frame PSNR {p4:.2f}")
    t0 = time.perf_counter()
    soup = loop.scene_obj.build(dev)
    soup_accel = lbvh.build_bvh_sah(soup, leaf_size=32)
    torch.cuda.synchronize()
    print(f"  soup SAH build {time.perf_counter() - t0:.2f} s, "
          f"{soup.num_triangles} triangles", flush=True)
    soup_img = renderer.render_frames(soup, soup_accel, g_cams, 0, 1,
                                      g_cfg)[0]
    p4s = psnr4(img, soup_img)
    sm.check(p4s > 45.0, f"last frame vs soup frame (K1) PSNR {p4s:.2f}")

    print("phase 13: one 1920x1080 two-level frame", flush=True)
    loop.set_resolution(1920, 1080)
    hd_cfg = loop.config
    before = (dict(k4.LAUNCHES), dict(shade_kernel.LAUNCHES))
    img_hd4 = loop.step(cam)
    torch.cuda.synchronize()
    sm.check(k4.LAUNCHES == {m: c + 1 for m, c in before[0].items()}
             and shade_kernel.LAUNCHES["brdf_light_major"]
             == before[1]["brdf_light_major"] + 1,
             "1080p frame launched K4 closest, K4 any-hit and K2 once")
    sm.check(tuple(img_hd4.shape) == (1080, 1920, 3)
             and bool(torch.isfinite(img_hd4).all()), "1080p frame finite")
    hd_cams = renderer.camera_arrays(cam, hd_cfg, dev)
    ref_hd4 = renderer.render_frames(loop.scene, loop.accel, hd_cams, 0, 1,
                                     hd_cfg, plain=True)[0]
    p4hd = psnr4(img_hd4, ref_hd4)
    sm.check(p4hd > 45.0, f"1080p frame vs plain frame PSNR {p4hd:.2f}")
    del ref_hd4
    soup_hd = renderer.render_frames(soup, soup_accel, hd_cams, 0, 1,
                                     hd_cfg)[0]
    p4hds = psnr4(img_hd4, soup_hd)
    sm.check(p4hds > 45.0, f"1080p frame vs soup frame (K1) PSNR "
             f"{p4hds:.2f}")
    del soup_hd

    print("phase 14: instanced times (CUDA events, median of 7)",
          flush=True)
    times.update({
        "k4_closest": time_ms(lambda: k4.trace_kernel(
            tl, *g_prim, g_cfg.t_min, True)),
        "k4_any_hit": time_ms(lambda: k4.trace_kernel(
            tl, *g_shadow, g_cfg.t_min, False)),
        # The plain walk takes most of a second per call: 3 reps.
        "k4_closest_plain": time_ms(lambda: k4.trace_plain(
            tl, *g_prim, g_cfg.t_min, True), reps=3),
        "k4_any_hit_plain": time_ms(lambda: k4.trace_plain(
            tl, *g_shadow, g_cfg.t_min, False), reps=3),
    })
    nf = [0]

    def refit_once():
        move(nf[0] % 32)
        nf[0] += 1

    refit_ms = host_ms(refit_once)
    loop.set_resolution(512, 384)
    nl4 = g_scene.lights.shape[0]
    rays4 = {"512x384": 512 * 384 * g_cfg.spp * (1 + nl4),
             "1920x1080": 1920 * 1080 * g_cfg.spp * (1 + nl4)}
    frame4 = {}
    for size, (w, h) in (("512x384", (512, 384)),
                         ("1920x1080", (1920, 1080))):
        loop.set_resolution(w, h)
        k = 8 if w == 512 else 1
        still = time_ms(lambda: [loop.step(cam) for _ in range(k)],
                        reps=5) / k
        animated = time_ms(lambda: [(refit_once(), loop.step(cam))
                                    for _ in range(k)], reps=5) / k
        frame4[size] = {"ms_per_frame": still,
                        "mrays_per_s": rays4[size] / still / 1e3,
                        "animated_ms_per_frame": animated,
                        "animated_mrays_per_s": rays4[size] / animated / 1e3}
    for key in ("k4_closest", "k4_closest_plain", "k4_any_hit",
                "k4_any_hit_plain"):
        print(f"  {key}: {times[key]:.4f} ms", flush=True)
    print(f"  refit (set_instance_transform, host clock): {refit_ms:.4f} ms",
          flush=True)
    for size, v in frame4.items():
        print(f"  instanced frame {size}: {v['ms_per_frame']:.4f} ms/frame, "
              f"{v['mrays_per_s']:.2f} Mray/s; with a refit per frame "
              f"{v['animated_ms_per_frame']:.4f} ms/frame, "
              f"{v['animated_mrays_per_s']:.2f} Mray/s", flush=True)

    kernels = [
        {"name": "bvh8_trace_closest", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_REPLACES, "launches": launches["closest"],
         "max_abs_err": k1c_err, "ms": times["k1_closest"],
         "plain_ms": times["k1_closest_plain"]},
        {"name": "bvh8_trace_any_hit", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_REPLACES, "launches": launches["any_hit"],
         "max_abs_err": k1a_err, "ms": times["k1_any_hit"],
         "plain_ms": times["k1_any_hit_plain"]},
        {"name": "brdf_light_major", "route": "cuda", "source": K2_SOURCE,
         "replaces": K2_REPLACES, "launches": launches["brdf_light_major"],
         "max_abs_err": k2_err, "ms": times["k2"],
         "plain_ms": times["k2_plain"]},
        {"name": "tlas8_trace_closest", "route": "cuda", "source": K4_SOURCE,
         "replaces": K4_REPLACES, "launches": launches4["k4_closest"],
         "max_abs_err": k4c_err, "ms": times["k4_closest"],
         "plain_ms": times["k4_closest_plain"]},
        {"name": "tlas8_trace_any_hit", "route": "cuda", "source": K4_SOURCE,
         "replaces": K4_REPLACES, "launches": launches4["k4_any_hit"],
         "max_abs_err": k4a_err, "ms": times["k4_any_hit"],
         "plain_ms": times["k4_any_hit_plain"]},
    ]
    if sm.failures:
        print(f"chip_smoke: {len(sm.failures)} check(s) failed: "
              f"{sm.failures}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
