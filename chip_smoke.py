#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (hrt_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from hrt_tpu_torch/csrc/, then drives the
port's paths: the five direct-lighting ones, the path tracer, then
many-light sampled NEE, textures and the pbr BSDF on the shipped scene
files, the render command (`python -m hrt_tpu_torch.render`), the
upscaler's trainer (`python -m hrt_tpu_torch.train_upscaler`), whose
recurrent fine-tune differentiates through K6, and last multi-GPU
rendering (row bands, scene shards, a data-parallel step) over one- and
two-rank process groups on the one card.  The bench frame: the
bench scene (three icospheres + ground plane, two point lights), SAH build with 32-triangle leaves and
its BVH8 records, and `render_frames` of 32 frames at 512x384
(max_depth=1, sky on), plus one 1920x1080 frame.  The instanced frame:
the JAX package's `instanced_tlas_512x384` scene through
FrameLoop(two_level=True), the two-level build and K4, animated.  The
culled frame: the same grid flattened to one soup in a FrameLoop with
the default culling, rebuilt with the LBVH on the card as the orbiting
camera changes which instances show, traced by K3.  The instance forest:
a 182x182 grid (33,125 instances) whose unified BVH8 table would pass
MAX_WIDE_NODES, so its build makes the binary two-level tables, traced
by K5, animated.  The post frame: SVGF and the temporal 2x upscaler
over the bench frame, whose history fetches run K6.  Phases:

  1. device facts (name, nvidia-smi power limit)
  2. kernel build, timed, with ptxas's registers and spills; the
     baseline kernels, where chip_scratch/baseline/ holds copies
  3. scene + accel on the card
  4. K1 (BVH8 walk) closest and any-hit vs its plain version on the
     frame's primary and light-major shadow batches; both vs brute force
     on a 4096-ray subset, and kernel vs plain and brute force on 4093
     of those rays (a partial last warp); K1's visits per live ray in
     the table's order and nearest first (traversal_wide8.visit_counts)
  5. K2 (light-major Disney BRDF) vs its plain version on the frame's
     batch, read in place from its strided material planes, and on
     batches of the same rays with L = 1 and L = 3 lights
  6. render_frames x32 through the kernels vs the plain-path frame; the
     launch counters must show 32 closest, 32 any-hit and 32 BRDF launches
  7. one 1920x1080 frame, same checks
  8. the JAX package's golden frames (tests/goldens/bench_direct,
     demo_parity, demo_sky at 64x48) rendered through the kernels
  9. CUDA-event times (median of 7; the kernels 10 calls per sample,
     one call alone beside): K1 and K2 vs their plain versions at the
     512x384 and 1920x1080 shapes (K1's visits and K2 at 1080p too),
     ms/frame and Mray/s at both sizes; K1 and K2 against the baseline
     ones in turns, and the bench frames through either
 10. the instanced scene (16x16 grid of icosphere instances on a ground
     plane, one light): two-level build on the card, timed
 11. K4 (two-level wide walk) closest and any-hit vs its plain version on
     the 512x384 frame's primary and shadow batches; both vs brute force
     over the flattened soup on 4096-ray subsets; K4 and K5 (on the
     grid's binary tables) vs their plain versions and the soup's brute
     force on 4093 of those rays (a partial last warp)
 12. FrameLoop(two_level=True): 32 steps at 512x384, each after moving
     one sphere (set_instance_transform); the launch counters must show
     32 K4 closest, 32 K4 any-hit and 32 K2 launches; the last frame vs
     the plain-path frame and vs the soup frame through K1
 13. one 1920x1080 two-level frame, same checks
 14. CUDA-event times (median of 7; the kernels 10 calls per sample,
     one call alone beside): K4 vs its plain version at the 512x384
     shapes, one refit, ms/frame and Mray/s at both sizes; K4's node
     records' times; K4's visits per live ray in the table's order and
     nearest first (traversal_tlas8.visit_counts) and the operation
     bound they give; K4 against the baseline K4 in turns
 15. the culled FrameLoop (default cull_threshold_px) over the 16x16 grid
     soup: 32 steps at 512x384 along orbit_camera(0.15 f, radius 4,
     height -1), the visible count per frame, >= 2 LBVH rebuilds; the
     launch counters must show 32 K3 closest, 32 K3 any-hit, 32 K2 and
     no K1 launch; the card's LBVH bit-equal to the CPU's; K3 vs its
     plain version on the last frame's batches and both vs brute force
     over the masked soup; the last frame vs the plain-path frame and vs
     the K1 frame of a SAH build over the same mask
 16. one culled 1920x1080 frame, same checks
 17. the instance forest (instance_grid_scene(182)): two-level build on
     the binary route, timed; K5 vs its plain version on the 512x384
     frame's batches, and vs K4 on the same scene built with a raised
     wide bound; 8 steps, each after moving another sphere (the binary
     TLAS rebuilt on the card, timed); the launch counters must show 8
     K5 closest, 8 K5 any-hit, 8 K2 and no K4 launch; the last frame vs
     the K4 frame and vs the plain-path frame
 18. one 1920x1080 forest frame: K5 and K2 launched once each, finite,
     vs the K4 frame
 19. times: K3 and K5 vs their plain versions (CUDA events, median of
     7; 3 for the plain walks), the LBVH rebuild, and ms/frame and Mray/s
     of the culled frame (still, and along the orbit with its rebuilds)
     and of the forest frame (still, and with a refit per frame), at both
     sizes; K3's visits per ray on the culled frame's batches
     (traversal_skip.visit_counts) and the operation bound they give;
     K5's node records' times, its visits per live ray on the forest's
     batches in both orders (traversal_tlas_skip.visit_counts) and its
     operation bound; K3 and K5 against the baseline ones in turns
     (baseline, current, current, baseline)
 20. K6 (the reprojection warp) vs its plain version on the inputs of a
     moving-camera post frame at both of its shapes (SVGF's history,
     1920x1080 C=10; the temporal upscaler's, 3840x2160 C=3): validity
     identical, values within rel err 1e-5 (of the taps' absolute
     weighted sum) and finite; both vs grid_sample (float64, corner
     convention, border padding) at in-bounds pixels
 21. the post FrameLoop (SVGF + the temporal 2x upscaler with the
     committed trained weights): 8 steps at 512x384 -> 1024x768 along
     the bench camera moving each step; the launch counters must show per
     step 2 K6, 1 K1 closest, 1 K1 any-hit, 1 K2 and no K3, with no
     rebuild; the last frame vs the same loop replayed with the plain
     versions (PSNR > 45); one spatial-mode and one denoise-only step
 22. the same at full size, 1920x1080 -> 3840x2160, 4 steps; peak memory
 23. times (CUDA events, median of 7): K6 at both shapes vs its plain
     version and grid_sample, beside its bound, and against the baseline
     K6 in turns where there is one (each sample of these four 10 calls
     back to back, so that the card and not the host's cost of one call
     sets a 0.1 ms kernel's time; one call alone is printed beside);
     svgf, the upscaler forward and reproject_history alone at 1080p;
     ms/frame of the post loop at both sizes, and through the baseline
     K1 and K2 in turns
 24. the RNG (ops/rng.py) on the card bit-equal to the CPU on 1M words
     (0 and 0xFFFFFFFF among them), and tests/test_rng.py's fixed
     vectors (hash3 of six pixels, 8 PCG steps) from the card
 25. the bounce batches of the path_tracing frame (bench scene, depth 5,
     jitter, Russian roulette, sorted) at 512x384, captured through
     trace_paths' `_batches`: at depth 1 and depth 3 (most lanes retired
     with t_max = -1) K1 closest and any hit vs their plain walks on
     every ray, both vs brute force on 4093 rays spread over the batch
     (retired lanes among them), K1's visits per live ray in both orders,
     K2 vs its plain version
 26. path_tracing through FrameLoop at 1920x1080, depth 5, sorted: 8
     steps; the launch counters must show 5 K1 closest, 5 K1 any-hit and
     5 K2 launches a step and no K3; 2 steps replayed with the plain
     versions (PSNR > 45); frame 1 sorted vs unsorted within rtol 1e-4 /
     atol 1e-5; frames 0 and 1 finite and different
 27. BASELINE's whitted (depth 4, no Russian roulette) and mesh_bvh
     frames on the Cornell box at 800x600 through K1 and K2 (launches:
     4 and 1 of each), vs the plain frames
 28. the instanced (K4), culled (K3) and forest (K5) loops path-traced
     (indirect, depth 2) at 512x384, 2 steps each: 2 closest and 2
     any-hit launches of the route's walk a step and none of another
     walk; each walk vs its plain version on 4093 rays of its depth-1
     batch and of that batch's shadow rays
 29. animated_4k: the path_tracing frame at depth 3, 1920x1080, sorted,
     then SVGF and the temporal 2x upscaler (3840x2160), 4 steps along
     the moving camera; per step 3 K1 closest, 3 K1 any-hit, 3 K2 and 2
     K6 launches; step 1 vs its plain replay (PSNR > 45); peak memory
 30. times (CUDA events, median of 7): ms/frame and Mray/s (bench.py's
     count: pixels x spp x (1 + lights) x depth) of path_tracing at both
     sizes, sorted and unsorted, and of animated_4k; K1 closest, any hit
     and K2 on every depth's batch of the 1080p frame (10 calls per
     sample, one call alone beside), their plain versions and bounds,
     K1's visits; K1 on the depth-1 and depth-3 batches unsorted; the
     sort's own time (key, torch.sort, the gathers);
     the card's busy share of one 1080p path_tracing step
     (torch.profiler, once)
 31. many lights through FrameLoop, 32 steps each at 512x384 with 2
     light samples a ray: bench_full's many_lights_256_512x384 (256
     point lights over a sphere field, light_sampler="bvh": the light
     tree's descent), the same with "auto" (at 256 lights the flat CDF
     scan) and many_lights_scene(1024) with "auto" (the tree); per step
     one K1 closest, one K1 any hit (2N rays) and one K2 (L = 2), and no
     other walk; the last frame vs its plain replay; K1 both modes and K2
     on its batches vs their plain versions; the light picks of the
     kernel path vs the plain path's; peak memory
 32. one 1920x1080 many_lights_256 frame by the tree, same checks, and
     its time
 33. scenes/studio.yaml (held here as STUDIO_SPEC: a checkerboard
     texture, a spot light, glass and chrome) at 800x600 through
     FrameLoop, 4 steps each: direct (max_depth=2), path traced
     (max_depth=4, bounces, jitter: 4 K1 closest, 4 any hit, 4 K2 a
     step) and brdf='pbr' (the pbr BSDF in PyTorch, no K2); each vs its
     plain replay, K1 and K2 on its batches vs their plain versions
 34. scenes/colonnade.yaml (COLONNADE_SPEC: a directional sun and a
     point light) through FrameLoop(two_level=True) at 512x384, 4 steps,
     once per light and with light_samples=1 (sampled through K4): K4
     closest, K4 any hit and K2 once a step, no K1; vs the plain replay
     and vs the scene flattened through K1
 35. times (CUDA events, median of 7): ms/frame of phases 31-34's
     configurations with two Mray/s figures apiece, traced rays (pixels
     x (1 + S) per depth, S the shadow rays a ray traces) and bench.py's
     equivalent queries (pixels x (1 + L) per depth); the device ms of
     light sampling (tree against scan) and of texture sampling under
     torch.profiler; the tree's and the scan's 256-light frames in 10
     alternating pairs; the busy share of the many-light frames; K1 and
     K2 on the many_lights_256 frame's batches vs their plain versions
     and bounds
 36. the render command (hrt_tpu_torch.cli.main, as `python -m
     hrt_tpu_torch.render` runs it, in this process, --stats): the demo
     scene with sky at 800x600 (K1, K2), --config path_tracing on the
     bench scene at 1920x1080, depth 5, 2 frames, bench --frames 8
     --orbit (culling on: K3 where a visibility change rebuilt the
     LBVH), scenes/colonnade.yaml --two-level (K4), bench --denoise
     --upscale 2 --upscale-mode temporal --frames 3 (K6), and
     --traversal bruteforce on the demo scene (no walk; PSNR > 45
     against the K1 frame); each run's launch counters (set to 0 just
     before it), its PNGs against the tonemapped FrameLoop.step replay of
     the same arguments, its stats line beside the replay's per-frame
     ms; --checkpoint written and resumed; --preview --frames 3 on port
     0 with /frame.png fetched by urllib; the stacked two-level trace
     (ops/twolevel.py: K3 per instance) on the bench scene's 512x384
     rays against its plain walk (ids on >= 0.99999 of rays) and brute
     force, timed
 37. upscaler training (`python -m hrt_tpu_torch.train_upscaler`,
     `train_upscaler.main` in this process, checkpoints to a temporary
     directory), spatial: 4 path-traced 256x256 frames of the bench
     scene and the Cornell box through FrameLoop (K1, K2; no warp), 300
     Adam steps on 8 64-px crops (the script's sizes); the launch
     counters set to 0 just before and read just after; the mean of the
     last 10 losses < 0.8 x the first 10's
 38. the same, --temporal: two 16-frame orbits (1-spp 128x128 frames
     with their G-buffers, 8-spp 256x256 targets; K1, K2), temporal
     triples (K6), 600 steps on 8 corrupted 128-px crops, 60 recurrent
     steps over both sequences (K6 forward and, for the gradient, its
     backward: the counters must show 60 x 2 x 15 backward launches),
     the held-out PSNR (temporal / spatial / bilinear) of the trained
     nets beside the committed weights', the temporal net's more than
     1 dB over bilinear's; the temporal run's last-10 / first-10 loss
     ratio < 0.8, as phase 37's, and each net's loss on a fixed batch
     of 64 crops < 0.9 x its initial net's (free of crop noise), the
     recurrent fine-tune's last-10 / first-10 ratio of its steps'
     losses (both sequences) < 1; both checkpoints through load_params
     and upscaler_from_numpy give the trained nets' output bit for bit
 39. K6's backward against autograd of the plain warp at the trainer's
     history (256x256, C=3, a bench orbit step's motion) and at the 4K
     one of animated_4k's shape (phase 20's, 3840x2160, C=3): within
     1e-5 of the largest |grad| (float atomics); times (CUDA events, 10
     calls per sample) beside the plain backward's, grid_sample's input
     gradient's and the bound
 40. one recurrent update on the card through K6 against the plain
     route (`plain=True`): loss within rtol 1e-5, gradients within 1e-4
     of each tensor's largest entry; with the warped history detached
     the gradient moves; ms per spatial, temporal and recurrent step

 41. multi-GPU rendering (hrt_tpu_torch.parallel) over a one-rank NCCL
     group: the tiled bench frame (render_frame_tiled) and its G-buffer
     at 512x384 and 1920x1080 bit-equal to render_rows' whole frame,
     one K1 closest, K1 any-hit and K2 launch each; FrameLoop(mesh) on
     phase 22's post config, 3 steps (K1, K2, 2 K6 a step), within 1e-5
     of the loop without a mesh; both loops' ms/frame in turns; the
     all-gather's ms (the 1080p frame, and with its G-buffer)
 42. four ranks stood in for by one process at full width: the 1080p
     path_tracing frame as 4 render_bands bit-equal to the whole frame,
     and one band's ms against the frame's in turns; instance_grid_
     scene()'s soup as 4 shard LBVHs, each walked by K3 over the 1080p
     orbit rays, combined (combine_hits) against K3 on the whole soup's
     LBVH (ids on >= 0.999 of rays, t rel <= 1e-5); the 4 walks' ms
     against the one walk's in turns
 43. two ranks on cuda:0 over gloo, spawned (gloo_worker): the tiled
     512x384 frame bit-equal to render_rows', the sharded hits of the
     bench soup equal to the local combine, a data-parallel upscaler
     step on 4 crops against the one-process step

Phase 8 also renders BASELINE's cornell_gi golden (depth 3, bounces)
through K1 and K2, held off the image diagonals where the box's wall
edges tie.  Each phase prints the seconds it took.

Every kernel line carries its bound: the larger of the bytes it must
move (each input read once, each output written once) over 3.35 TB/s
and its float32 operations over 67 TFLOP/s (H100 SXM data sheet).  The
walks' operations are counted from this run's visits: K3's, and K1's,
K4's and K5's in the cheaper of the two orders (every box's slab test,
every triangle test up to the point where it can first reject, every
instance entry's transform).

The baseline (phases 9, 14, 19 and 23) is optional: copies of an
earlier commit's kernels (any of skip_trace.cu, warp_bilinear.cu,
tlas8_trace.cu, tlas_skip_trace.cu, bvh8_trace.cu and
brdf_light_major.cu, with the headers they include) under the
gitignored chip_scratch/baseline/, e.g. for the K1 and K2 of 6f624a9

    mkdir -p chip_scratch/baseline
    for f in bvh8_trace.cu brdf_light_major.cu walk_common.cuh disney.cuh
    do
      git show 6f624a9:hrt_tpu_torch/csrc/$f > chip_scratch/baseline/$f
    done

built into their own library at phase 2.  A plain checkout has none,
and the comparisons are skipped.

Exits non-zero, printing no result, without a CUDA device or when any
check fails.  The line before the last is the kernels JSON (the six
kernels on the direct-lighting paths, K6's backward on the trainer's
history, then K1's two modes and K2 on the path_tracing frame, one
frame's five launches each, then on the many_lights_256 frame); the
last is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BENCH_CAM = dict(position=(0.0, -1.0, -6.0), rotation=(-0.15, 0.0, 0.0))
# scripts/bench_full.py's camera of the Cornell box frames.
CORNELL_CAM = dict(position=(0.0, 0.0, -3.2), fov_y=0.7)
# The path-traced phases' frame sizes (width, height): the small one, the
# full one (BASELINE's path_tracing and animated_4k render size), and the
# Cornell box frames' (whitted, mesh_bvh).
PT_SMALL = (512, 384)
PT_FULL = (1920, 1080)
PT_CORNELL = (800, 600)
# scenes/studio.yaml and scenes/colonnade.yaml as dicts (no yaml import
# here: the card's machine need not have pyyaml); a CPU test holds them
# equal to the files.
STUDIO_SPEC = {
    "meshes": [{"name": "floor", "plane": {"size": 12.0}},
               {"name": "ball",
                "icosphere": {"subdivisions": 3, "radius": 1.0}},
               {"name": "block", "cube": {"size": 1.0}}],
    "textures": [{"name": "checker",
                  "checkerboard": {"n": 12, "res": 256}}],
    "materials": [
        {"name": "floor", "color": [0.9, 0.9, 0.9], "roughness": 0.85,
         "texture": "checker"},
        {"name": "chrome", "color": [0.92, 0.93, 0.95], "metallic": 1.0,
         "roughness": 0.04},
        {"name": "glass", "color": [0.98, 0.99, 0.98], "roughness": 0.02,
         "transmission": 1.0, "ior": 1.5},
        {"name": "clay", "color": [0.75, 0.3, 0.2], "roughness": 0.9},
        {"name": "gold", "color": [0.95, 0.75, 0.3], "metallic": 1.0,
         "roughness": 0.25}],
    "lights": [
        {"position": [-3.0, -4.0, -2.0], "color": [1.0, 0.85, 0.7],
         "intensity": 35.0},
        {"position": [3.5, -3.0, -3.0], "color": [0.6, 0.75, 1.0],
         "intensity": 25.0},
        {"position": [0.0, -6.0, 1.0], "color": [1.0, 1.0, 1.0],
         "intensity": 50.0, "type": "spot", "direction": [0.0, 1.0, 0.0],
         "cone_angle": 0.6}],
    "instances": [
        {"mesh": "floor", "material": "floor", "position": [0, 1, 0]},
        {"mesh": "ball", "material": "chrome", "position": [-1.6, 0.2, 0.6],
         "scale": [0.8, 0.8, 0.8]},
        {"mesh": "ball", "material": "glass", "position": [0.4, 0.45, -0.4],
         "scale": [0.55, 0.55, 0.55]},
        {"mesh": "ball", "material": "clay", "position": [1.8, 0.5, 0.8],
         "scale": [0.5, 0.5, 0.5]},
        {"mesh": "block", "material": "gold", "position": [0.9, 0.7, 1.6],
         "rotation": [0, 0.5, 0], "scale": [0.6, 0.6, 0.6]}],
    "sky": {"brightness": 0.6},
}
COLONNADE_SPEC = {
    "meshes": [{"name": "ground", "plane": {"size": 40.0}},
               {"name": "column", "cube": {"size": 1.0}},
               {"name": "cap", "cube": {"size": 1.0}},
               {"name": "orb",
                "icosphere": {"subdivisions": 2, "radius": 1.0}}],
    "materials": [
        {"name": "stone", "color": [0.75, 0.72, 0.65], "roughness": 0.9},
        {"name": "ground", "color": [0.45, 0.5, 0.4], "roughness": 1.0},
        {"name": "brass", "color": [0.85, 0.65, 0.3], "metallic": 1.0,
         "roughness": 0.3}],
    "lights": [
        {"position": [0.0, -50.0, 0.0], "color": [1.0, 0.95, 0.85],
         "intensity": 3.0, "type": "directional",
         "direction": [0.35, 1.0, 0.25]},
        {"position": [0.0, -1.5, 2.0], "color": [1.0, 0.2, 0.1],
         "intensity": 12.0}],
    "instances": (
        [{"mesh": "ground", "material": "ground", "position": [0, 1, 0]}]
        + [{"mesh": "column", "material": "stone",
            "position": [x, -0.5, z], "scale": [0.4, 3.0, 0.4]}
           for z in (-2.0, 4.0) for x in (-4.5, -1.5, 1.5, 4.5)]
        + [{"mesh": "cap", "material": "stone", "position": [x, -2.1, -2.0],
            "scale": [0.7, 0.2, 0.7]} for x in (-4.5, -1.5, 1.5, 4.5)]
        + [{"mesh": "orb", "material": "brass", "position": [0.0, 0.3, 1.0],
            "scale": [0.7, 0.7, 0.7]}]),
    "sky": {"brightness": 1.0},
}
# The studio frames' camera (tests/test_scenefile.py), also the
# colonnade's.
STUDIO_CAM = dict(position=(0.0, -1.5, -6.0), rotation=(-0.15, 0.0, 0.0))
K1_SOURCE = "hrt_tpu_torch/csrc/bvh8_trace.cu"
K1_REPLACES = "hrt_tpu/ops/traversal_wide8.py:679"
K2_SOURCE = "hrt_tpu_torch/csrc/brdf_light_major.cu"
K2_REPLACES = "hrt_tpu/ops/shade_pallas.py:98"
K4_SOURCE = "hrt_tpu_torch/csrc/tlas8_trace.cu"
K4_REPLACES = "hrt_tpu/ops/traversal_tlas8.py:438"
K3_SOURCE = "hrt_tpu_torch/csrc/skip_trace.cu"
K3_REPLACES = "hrt_tpu/ops/traversal_pallas.py:522"
K5_SOURCE = "hrt_tpu_torch/csrc/tlas_skip_trace.cu"
K5_REPLACES = "hrt_tpu/ops/tlas.py:538"
K6_SOURCE = "hrt_tpu_torch/csrc/warp_bilinear.cu"
K6_REPLACES = "hrt_tpu/ops/warp_pallas.py:291"
# H100 SXM (data sheet): device memory rate, float32 rate outside the
# tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Float operations of one relevant K2 element, counted from
# csrc/disney.cuh (each division, sqrt and log2 counted once).
K2_OPS_PER_ELEMENT = 300
# Float operations (an FMA counts two) of one K3 node visit, its slab
# test: 6 FMAs and 13 min/max/compares; and of one triangle test up to
# its first rejection (csrc/skip_common.cuh `moller_scaled`): P = D x E2
# (9), det (5), T (3), T.P (5) and 3 compares.
K3_OPS_PER_NODE = 25
K3_OPS_PER_TEST = 25
# K4's and K5's operations: K3's per box test and per triangle test, and
# one instance entry (csrc/walk_common.cuh `enter_instance`): the origin's
# 3x4 affine map (3 x 7), the direction's linear one (3 x 5), three
# clamped reciprocals (3 x 4) and o * inv (3).
ENTER_OPS = 51
BASELINE_DIR = os.path.join(ROOT, "chip_scratch", "baseline")
BASELINE_KERNELS = ("skip_trace.cu", "warp_bilinear.cu", "tlas8_trace.cu",
                    "tlas_skip_trace.cu", "bvh8_trace.cu",
                    "brdf_light_major.cu")


class Smoke:
    def __init__(self):
        self.failures: list[str] = []

    def check(self, ok: bool, what: str) -> None:
        print(f"  [{'ok' if ok else 'FAIL'}] {what}", flush=True)
        if not ok:
            self.failures.append(what)


_PHASE = {"name": "", "t0": 0.0}


def phase(title: str) -> None:
    """Print a phase's heading, after the seconds the previous phase
    took."""
    end_phase()
    print(title, flush=True)
    _PHASE.update(name=title.split(":")[0], t0=time.perf_counter())


def end_phase() -> None:
    if _PHASE["name"]:
        print(f"  ({_PHASE['name']} took "
              f"{time.perf_counter() - _PHASE['t0']:.1f} s)", flush=True)
        _PHASE["name"] = ""


def time_ms(fn, reps: int = 7, calls: int = 1) -> float:
    """Median CUDA-event time of one fn() call in ms, after one warm-up
    call.  Each of the `reps` samples times `calls` calls back to back
    between its two events; with calls > 1 the card, not the host's
    cost of one call, sets the time of a short kernel."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def load_baseline():
    """The baseline kernels in BASELINE_DIR (any of K3 skip_trace.cu, K6
    warp_bilinear.cu, K4 tlas8_trace.cu, K5 tlas_skip_trace.cu, K1
    bvh8_trace.cu and K2 brdf_light_major.cu, beside the headers they
    include), built like the package's kernels into chip_scratch/_build/,
    with the entry points they had at f3a1248 (hrt_skip_trace over the
    (Mp/128, 8, 128) skip-link table, hrt_warp_bilinear over a contiguous
    image, hrt_tlas8_trace over the (R, 8, 128) BVH8 table,
    hrt_tlas_skip_trace over the (R, 8, 128) two-level skip-link table)
    or at 6f624a9 (hrt_bvh8_trace over the (R, 8, 128) BVH8 table,
    hrt_brdf_light_major over 18 stacked per-ray planes and 3 stacked
    light planes) bound for the copies present; None without copies."""
    import ctypes
    import glob
    import hashlib

    from hrt_tpu_torch.kernels import build

    cu = [os.path.join(BASELINE_DIR, f) for f in BASELINE_KERNELS
          if os.path.exists(os.path.join(BASELINE_DIR, f))]
    if not cu:
        return None
    srcs = cu + sorted(glob.glob(os.path.join(BASELINE_DIR, "*.cuh")))
    h = hashlib.sha256(" ".join(build.NVCC_FLAGS).encode())
    for f in srcs:
        with open(f, "rb") as fh:
            h.update(os.path.basename(f).encode() + fh.read())
    path = os.path.join(ROOT, "chip_scratch", "_build",
                        f"baseline-{h.hexdigest()[:16]}.so")
    nvcc = build.nvcc_path()

    def stages(tmp):
        objs = [f"{tmp}.{os.path.basename(f)}.o" for f in cu]
        return [[[nvcc, *build.NVCC_FLAGS, "-I", BASELINE_DIR, "-c", "-o",
                  o, f] for f, o in zip(cu, objs)],
                [[nvcc, *build.ARCH_FLAGS, "-shared", "-o", tmp, *objs]]]

    try:
        build.build_once(path, stages, "nvcc (baseline)", timeout=600)
    finally:
        for leftover in glob.glob(f"{path}.*.tmp.*.o"):
            os.remove(leftover)
    lib = ctypes.CDLL(path)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    argtypes = {
        "hrt_skip_trace": [p] * 7 + [i, p, p, i, i, f, i] + [p] * 5 + [p],
        "hrt_warp_bilinear": [p, i, i, i, p, p, i, p, p, p],
        "hrt_tlas8_trace": [p] * 7 + [i, p, p, p, p, i, i, f, i, i]
        + [p] * 6 + [p],
        "hrt_tlas_skip_trace": [p] * 7 + [i, p, p, p, p, p, i, i, f, i]
        + [p] * 6 + [p],
        "hrt_bvh8_trace": [p] * 7 + [i, p, p, i, f, i, i] + [p] * 5 + [p],
        "hrt_brdf_light_major": [p, p, p, i, i, p, p]}
    for name, args in argtypes.items():
        if hasattr(lib, name):
            getattr(lib, name).restype = i
            getattr(lib, name).argtypes = args
    return lib


def has_baseline(lib, name: str) -> bool:
    return lib is not None and hasattr(lib, name)


def baseline_two_level(lib, tl, planes, t_min: float, closest: bool):
    """The baseline K4 (BVH8 route) or K5 (binary route) on the tables
    the kernels of f3a1248 read: the (R, 8, 128) w8_nodes or nodes."""
    import torch

    planes = [q.contiguous() for q in planes]
    n, dev = planes[0].numel(), planes[0].device
    if closest:
        res = (torch.empty(n, device=dev),
               torch.empty(n, dtype=torch.int32, device=dev),
               torch.empty(n, dtype=torch.int32, device=dev),
               torch.empty(n, device=dev), torch.empty(n, device=dev))
        outs = [q.data_ptr() for q in res] + [None]
    else:
        res = torch.empty(n, dtype=torch.bool, device=dev)
        outs = [None] * 5 + [res.data_ptr()]
    tf = tl.obj_from_world.reshape(-1, 12).contiguous()
    rays = [q.data_ptr() for q in planes]
    stream = torch.cuda.current_stream().cuda_stream
    if tl.w8_nodes is not None:
        rc = lib.hrt_tlas8_trace(
            *rays, n, tl.w8_nodes.data_ptr(), tl.tris.data_ptr(),
            tf.data_ptr(), tl.w8_root.data_ptr(), tl.w8_tlas_nw,
            tl.leaf_size, float(t_min), tl.stack, int(closest), *outs,
            stream)
    else:
        rc = lib.hrt_tlas_skip_trace(
            *rays, n, tl.nodes.data_ptr(), tl.tris.data_ptr(),
            tf.data_ptr(), tl.blas_base.data_ptr(), tl.blas_end.data_ptr(),
            tl.tlas_m, tl.leaf_size, float(t_min), int(closest), *outs,
            stream)
    if rc:
        raise RuntimeError(f"baseline two-level walk: CUDA error {rc}")
    return res


def baseline_k3(lib, accel, planes, t_min: float, closest: bool):
    """The baseline K3 on the accel's skip-link table."""
    import torch

    planes = [q.contiguous() for q in planes]
    n, dev = planes[0].numel(), planes[0].device
    if closest:
        res = (torch.empty(n, device=dev),
               torch.empty(n, dtype=torch.int32, device=dev),
               torch.empty(n, device=dev), torch.empty(n, device=dev))
        outs = [q.data_ptr() for q in res] + [None]
    else:
        res = torch.empty(n, dtype=torch.bool, device=dev)
        outs = [None] * 4 + [res.data_ptr()]
    rc = lib.hrt_skip_trace(*[q.data_ptr() for q in planes], n,
                            accel.nodes.data_ptr(), accel.tris.data_ptr(),
                            accel.m_real, accel.leaf_size, float(t_min),
                            int(closest), *outs,
                            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"baseline skip_trace: CUDA error {rc}")
    return res


def baseline_k1(lib, accel, planes, t_min: float, closest: bool):
    """The baseline K1 as its wrapper ran it: on the (R, 8, 128) table
    with a per-ray stack of depth + 1 entries."""
    import torch

    planes = [q.contiguous() for q in planes]
    n, dev = planes[0].numel(), planes[0].device
    if closest:
        res = (torch.empty(n, device=dev),
               torch.empty(n, dtype=torch.int32, device=dev),
               torch.empty(n, device=dev), torch.empty(n, device=dev))
        outs = [q.data_ptr() for q in res] + [None]
    else:
        res = torch.empty(n, dtype=torch.bool, device=dev)
        outs = [None] * 4 + [res.data_ptr()]
    rc = lib.hrt_bvh8_trace(*[q.data_ptr() for q in planes], n,
                            accel.w8.data_ptr(), accel.tris.data_ptr(),
                            accel.leaf_size, float(t_min),
                            accel.w8_depth + 1, int(closest), *outs,
                            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"baseline bvh8_trace: CUDA error {rc}")
    return res


def baseline_k2(lib, mat, n, view, l_lm, relevant_lm, num_lights: int):
    """The baseline K2 as its wrapper ran it: the 18 per-ray planes and
    the 3 light planes stacked into contiguous copies."""
    import torch

    from hrt_tpu_torch.ops.v3 import V3

    shared = torch.stack((
        mat.color.x, mat.color.y, mat.color.z, mat.subsurface, mat.metallic,
        mat.roughness, mat.specular, mat.specular_tint, mat.anisotropic,
        mat.sheen_tint, mat.clearcoat, mat.clearcoat_gloss, n.x, n.y, n.z,
        view.x, view.y, view.z)).contiguous()
    light = torch.stack([l_lm.x, l_lm.y, l_lm.z]).contiguous()
    rel = relevant_lm.to(torch.bool).contiguous()
    total = num_lights * n.x.shape[0]
    out = torch.empty((3, total), dtype=torch.float32, device=n.x.device)
    rc = lib.hrt_brdf_light_major(shared.data_ptr(), light.data_ptr(),
                                  rel.data_ptr(), n.x.shape[0], total,
                                  out.data_ptr(),
                                  torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"baseline brdf_light_major: CUDA error {rc}")
    return V3(out[0], out[1], out[2])


def baseline_k6(lib, img, px, py):
    """The baseline K6 as its wrapper ran it: on a contiguous copy of
    the image."""
    import torch

    img, px, py = img.contiguous(), px.contiguous(), py.contiguous()
    hs, ws, c = img.shape
    val = torch.empty((*px.shape, c), device=img.device)
    valid = torch.empty(px.shape, dtype=torch.bool, device=img.device)
    rc = lib.hrt_warp_bilinear(img.data_ptr(), hs, ws, c, px.data_ptr(),
                               py.data_ptr(), px.numel(), val.data_ptr(),
                               valid.data_ptr(),
                               torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"baseline warp_bilinear: CUDA error {rc}")
    return val, valid


def in_turns(base, cur, reps: int = 7, calls: int = 1):
    """time_ms of `base` and `cur` in turns base, cur, cur, base:
    ([base, base], [cur, cur])."""
    b1, c1, c2, b2 = (time_ms(f, reps, calls) for f in (base, cur, cur,
                                                          base))
    return [b1, b2], [c1, c2]


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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def walk_bytes(planes, out_bytes: int) -> int:
    """The bytes a walk must move for a batch (its seven ray planes): a
    live ray's 28 bytes, a retired ray's t_max alone (t_max < 0 drops
    it), and `out_bytes` of result for every ray.  The tables are
    counted apart."""
    n = planes[6].numel()
    live = int((planes[6] >= 0).sum())
    return live * 28 + (n - live) * 4 + n * out_bytes


def k2_bytes(args) -> int:
    """The bytes K2 must move for its arguments (brdf_light_major's):
    every element's relevance byte and its three output floats, the 18
    per-ray planes of a ray with any relevant light, and a relevant
    element's light direction."""
    rel = args[4]
    nl = args[5]
    rays = int(rel.view(nl, -1).any(0).sum())
    return rel.numel() * (1 + 12) + rays * 18 * 4 + int(rel.sum()) * 12


def bound(n_bytes: float, ops: float = 0.0):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the float32 operations over the peak rate."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / F32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def box_tests(c):
    """Box tests in a walk's counts: K1's child boxes, or a two-level
    walk's TLAS and BLAS boxes (a binary walk tests one box per node)."""
    if "boxes" in c:
        return c["boxes"]
    return (c.get("tlas_boxes", c["tlas_nodes"])
            + c.get("blas_boxes", c["blas_nodes"]))


def walk_ops(mod, acc, planes, t_min: float, closest: bool,
             label: str) -> int:
    """Visits per live ray of a wide or two-level walk (`mod.visit_counts`)
    on this batch in the table's order and nearest first, printed;
    returns the operations of the cheaper order (K3_OPS_PER_NODE per box
    test, K3_OPS_PER_TEST per triangle test, ENTER_OPS per instance
    entered), a floor for a walk in either order."""
    live = max(int((planes[6] >= 0).sum()), 1)
    n32 = planes[6].numel() // 32 * 32
    warp_live = (planes[6][:n32] >= 0).view(-1, 32).any(1)
    ops = []
    for nearest in (False, True):
        cnt = mod.visit_counts(acc, *planes, t_min, closest, nearest=nearest)
        cnt.pop("hits")
        tot = {k: int(v.sum()) for k, v in cnt.items()}
        ops.append(box_tests(tot) * K3_OPS_PER_NODE
                   + tot["tests"] * K3_OPS_PER_TEST
                   + tot.get("instances", 0) * ENTER_OPS)
        # Box and triangle tests per ray: the longest walks, and a warp's
        # busiest ray (what a warp of a thread per ray waits for).
        work = box_tests(cnt) + cnt["tests"]
        busiest = work[:n32].view(-1, 32).amax(1)[warp_live].float()
        print(f"  {label} visits per live ray ({live} live), "
              f"{'nearest first' if nearest else 'table order'}: "
              + ", ".join(f"{k} {v / live:.2f}" for k, v in tot.items())
              + f"; {ops[-1]:.4e} operations; box and triangle tests per "
              f"ray: max {int(work.max())}, a warp's busiest ray "
              f"{float(busiest.mean()):.1f} (mean over {busiest.numel()} "
              "warps with a live ray)", flush=True)
    return min(ops)


def time_walk_vs_baseline(sm: Smoke, baseline, name: str, kernel, tl,
                          planes, t_min: float, closest: bool) -> None:
    """A two-level kernel against the baseline one: agreement (>= 0.999,
    as check_closest / check_occlusion) and times in turns (10 calls per
    event pair)."""
    base = baseline_two_level(baseline, tl, planes, t_min, closest)
    cur = kernel(tl, *planes, t_min, closest)
    (check_closest if closest else check_occlusion)(
        sm, f"{name} vs the baseline", cur, base)
    b, c = in_turns(lambda: baseline_two_level(baseline, tl, planes, t_min,
                                               closest),
                    lambda: kernel(tl, *planes, t_min, closest), calls=10)
    print(f"  {name} in turns (baseline, current, current, baseline; 10 "
          f"calls per sample): {b[0]:.4f}, {c[0]:.4f}, {c[1]:.4f}, "
          f"{b[1]:.4f} ms; current / baseline {sum(c) / sum(b):.4f}",
          flush=True)


def frame_vs_baseline(swaps, frames, label: str, pairs: int = 10) -> None:
    """`frames()` (still frames through the current kernels) against the
    same frames with the baseline kernels put in their wrappers' places,
    `swaps` a list of (module, wrapper name, baseline function): `pairs`
    pairs of one sample each, alternating which runs first; prints both
    medians and the pairs the current kernels win (times only; no launch
    counter is read).  The frames are host-bound, so their spread is the
    host's."""
    cur = [getattr(mod, name) for mod, name, _ in swaps]

    def with_base():
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        try:
            frames()
        finally:
            for (mod, name, _), fn in zip(swaps, cur):
                setattr(mod, name, fn)

    b, c = [], []
    for p in range(pairs):
        for fn in ((with_base, frames) if p % 2 == 0 else (frames,
                                                            with_base)):
            (b if fn is with_base else c).append(time_ms(fn, reps=1))
    wins = sum(x < y for x, y in zip(c, b))
    mb, mc = statistics.median(b), statistics.median(c)
    print(f"  {label}, {pairs} pairs alternating: median baseline kernel "
          f"{mb:.4f} ms, current {mc:.4f} ms (current / baseline "
          f"{mc / mb:.4f}); current faster in {wins} of {pairs}; baseline "
          f"quartiles "
          f"{' '.join(f'{q:.4f}' for q in statistics.quantiles(b, n=4))}",
          flush=True)


def k2_check(sm: Smoke, label: str, args) -> float:
    """K2 against its plain version on `args` (brdf_light_major's):
    within rtol 1e-4 / atol 1e-6, exact zeros where irrelevant, finite;
    returns the max abs error."""
    import torch

    from hrt_tpu_torch.ops import shade_kernel

    kf = shade_kernel.brdf_light_major_kernel(*args)
    pf = shade_kernel.brdf_light_major_plain(*args)
    rel = args[4]
    err, ok = 0.0, True
    for a, b in zip(kf, pf):
        err = max(err, float((a - b).abs().max()))
        ok &= bool(((a - b).abs() <= 1e-6 + 1e-4 * b.abs()).all())
        ok &= bool((a[~rel] == 0).all()) and bool(torch.isfinite(a).all())
    sm.check(ok, f"K2 {label}: within rtol 1e-4 / atol 1e-6 of plain, zero "
             f"where irrelevant, finite (max abs err {err:.3g}; "
             f"{float(rel.float().mean()):.3f} of {rel.numel()} relevant)")
    return err


def bench_kernel_times(sm: Smoke, baseline, accel, prim, shadow, k2_args,
                       t_min: float, size: str) -> dict:
    """Phase 9's times of K1 (both modes) and K2 on one frame's batches:
    10 calls per event pair, one call alone, the plain version, and the
    baseline kernels in turns (baseline, current, current, baseline; 10
    calls per sample) after checking that they agree.  Keys k1_closest,
    k1_any_hit and k2 with `size` appended, each with _one_call and
    _plain beside."""
    from hrt_tpu_torch.ops import shade_kernel, traversal_wide8 as k1

    jobs = {
        "k1_closest": (lambda: k1.trace_kernel(accel, *prim, t_min, True),
                       lambda: k1.trace_plain(accel, *prim, t_min, True),
                       lambda: baseline_k1(baseline, accel, prim, t_min,
                                           True), "hrt_bvh8_trace"),
        "k1_any_hit": (lambda: k1.trace_kernel(accel, *shadow, t_min, False),
                       lambda: k1.trace_plain(accel, *shadow, t_min, False),
                       lambda: baseline_k1(baseline, accel, shadow, t_min,
                                           False), "hrt_bvh8_trace"),
        "k2": (lambda: shade_kernel.brdf_light_major_kernel(*k2_args),
               lambda: shade_kernel.brdf_light_major_plain(*k2_args),
               lambda: baseline_k2(baseline, *k2_args),
               "hrt_brdf_light_major")}
    out = {}
    for key, (cur, plain, base, entry) in jobs.items():
        k = key + size
        out[k] = time_ms(cur, calls=10)
        out[k + "_one_call"] = time_ms(cur)
        out[k + "_plain"] = time_ms(plain, reps=3 if key != "k2" else 7)
        line = (f"  {k}: {out[k]:.4f} ms (one call alone, the host's cost "
                f"included: {out[k + '_one_call']:.4f} ms); plain "
                f"{out[k + '_plain']:.4f} ms")
        if has_baseline(baseline, entry):
            c, b = cur(), base()
            if key == "k1_closest":
                check_closest(sm, f"{k} vs the baseline", c, b)
            elif key == "k1_any_hit":
                check_occlusion(sm, f"{k} vs the baseline", c, b)
            else:
                d = max(float(((x - y).abs() - 1e-4 * y.abs()).max())
                        for x, y in zip(c, b))
                sm.check(d <= 1e-6, f"{k} vs the baseline K2 within rtol "
                         f"1e-4 / atol 1e-6 ({d:.3g} past rtol)")
            del c, b
            bt, ct = in_turns(base, cur, calls=10)
            line += (f"; in turns (baseline, current, current, baseline; 10 "
                     f"calls per sample): {bt[0]:.4f}, {ct[0]:.4f}, "
                     f"{ct[1]:.4f}, {bt[1]:.4f} ms; current / baseline "
                     f"{sum(ct) / sum(bt):.4f}")
        print(line, flush=True)
    return out


def two_level_swaps(baseline, mod):
    """frame_vs_baseline's swap of a two-level walk's kernel."""
    def base_kernel(tl, *args):
        return baseline_two_level(baseline, tl, args[:7], args[7], args[8])

    return [(mod, "trace_kernel", base_kernel)]


def bench_swaps(baseline):
    """frame_vs_baseline's swaps of K1 and K2, the bench and post
    frames' kernels."""
    from hrt_tpu_torch.ops import shade_kernel, traversal_wide8 as k1

    def base_k1(accel, *args):
        return baseline_k1(baseline, accel, args[:7], args[7], args[8])

    return [(k1, "trace_kernel", base_k1),
            (shade_kernel, "brdf_light_major_kernel",
             lambda *args: baseline_k2(baseline, *args))]


def post_cam(f: int):
    """BENCH_CAM moving a little each step (x and yaw)."""
    from hrt_tpu_torch.models.camera import Camera

    (x, y, z), (rx, ry, rz) = BENCH_CAM["position"], BENCH_CAM["rotation"]
    return Camera(position=(x + 0.03 * f, y, z),
                  rotation=(rx, ry + 0.004 * f, rz))


def reset(*counters) -> None:
    for c in counters:
        for key in c:
            c[key] = 0


def check_closest(sm: Smoke, label: str, k, p,
                  min_hits: float = 0.3) -> float:
    """Closest hits of a kernel `k` against another walk `p`, as tuples
    (t, tri, u, v) or (t, tri, inst, u, v): ids (and instance ids) agree
    on >= 0.999 of rays, more than `min_hits` of the rays hit, and t
    within rel err 1e-4 where they agree.  Returns the max abs t error
    there."""
    same = k[1] == p[1]
    if len(k) == 5:
        same &= k[2] == p[2]
    hit = same & (k[1] >= 0)
    share, hits = float(same.float().mean()), float(hit.float().mean())
    sm.check(share >= 0.999 and hits > min_hits,
             f"{label}: closest ids agree on {share:.6f} of "
             f"{k[1].numel()} rays ({hits:.3f} hit)")
    if not bool(hit.any()):
        return float("nan")
    rel = ((k[0] - p[0]).abs() / p[0].abs().clamp(min=1e-6))[hit]
    err = float((k[0] - p[0])[hit].abs().max())
    sm.check(float(rel.max()) <= 1e-4,
             f"{label}: closest t rel err {float(rel.max()):.3g} where ids "
             f"agree (max abs {err:.3g})")
    return err


def check_occlusion(sm: Smoke, label: str, k, p) -> float:
    """Occlusion masks agree on >= 0.999 of rays; returns the max abs
    difference (0 or 1)."""
    agree = float((k == p).float().mean())
    sm.check(agree >= 0.999, f"{label}: occlusion agrees on {agree:.6f} of "
             f"{k.numel()} rays ({float(p.float().mean()):.3f} occluded)")
    return float((k.float() - p.float()).abs().max())


def frame_batches(scene, accel, cams, cfg):
    """A frame's primary batch and its light-major shadow batch, as the
    seven ray planes each (the shadow batch from the accel's own hits),
    and its K2 arguments (the hits' strided material planes, normals and
    view directions, the light-major light directions and relevance,
    the light count)."""
    import torch

    from hrt_tpu_torch import renderer
    from hrt_tpu_torch.ops import intersect

    o, d = renderer.primary_rays(cams, cfg.height, 0, cfg)
    n = o.x.shape[0]
    prim = (o.x, o.y, o.z, d.x, d.y, d.z,
            torch.full((n,), intersect.INF, device=o.x.device))
    sh = renderer.surface_hits(scene, accel, o, d, cfg)
    lb = renderer.light_batch(scene, sh.normal, sh.world_pos, cfg,
                              ray_mask=sh.hit)
    shadow = (lb.origin.x, lb.origin.y, lb.origin.z, lb.l.x, lb.l.y,
              lb.l.z, lb.t_max)
    k2_args = (sh.mat, sh.normal, sh.view, lb.l, lb.relevant,
               scene.lights.shape[0])
    return prim, shadow, k2_args


def run_post_loop(dev, cfg, steps: int, replay: int | None = None):
    """A post FrameLoop on the bench scene along post_cam, through the
    kernels, then its first `replay` steps (all by default) replayed
    with the plain versions.  The counters are set to 0 just before the
    kernel loop and read just after it.  Returns (per-step launch
    deltas, totals, peak bytes, the kernel frame and the plain frame of
    the last replayed step, the kernel loop)."""
    import torch

    from hrt_tpu_torch.frameloop import FrameLoop
    from hrt_tpu_torch.models.scene import bench_scene
    from hrt_tpu_torch.ops import shade_kernel, traversal_skip as k3
    from hrt_tpu_torch.ops import traversal_wide8 as k1, warp_kernel as k6

    def counts():
        return {"k6": k6.LAUNCHES["warp_bilinear"],
                "k1_closest": k1.LAUNCHES["closest"],
                "k1_any_hit": k1.LAUNCHES["any_hit"],
                "k2": shade_kernel.LAUNCHES["brdf_light_major"],
                "k3": k3.LAUNCHES["closest"] + k3.LAUNCHES["any_hit"]}

    loop = FrameLoop(bench_scene(), cfg, device=dev)
    ref_loop = FrameLoop(bench_scene(), cfg, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset(k6.LAUNCHES, k1.LAUNCHES, k3.LAUNCHES, shade_kernel.LAUNCHES)
    replay = steps if replay is None else replay
    deltas = []
    for f in range(steps):
        before = counts()
        out = loop.step(post_cam(f))
        if f == replay - 1:
            img = out
        deltas.append({k: v - before[k] for k, v in counts().items()})
    torch.cuda.synchronize()
    totals = counts()
    peak = torch.cuda.max_memory_allocated()
    for f in range(replay):
        ref = ref_loop.step(post_cam(f), plain=True)
    torch.cuda.synchronize()
    return deltas, totals, peak, img, ref, loop


def post_phases(sm: Smoke, dev, baseline=None) -> tuple:
    """Phases 20-23, the post frame; `baseline` is load_baseline()'s
    library or None.  Returns K6's entry of the kernels line (its ms,
    plain_ms, library_ms and bound_ms are those of one frame's two
    launches, one at each shape) and phase 20's 3840x2160 C=3 warp
    inputs (history, px, py)."""
    import torch
    import torch.nn.functional as F

    from hrt_tpu_torch import renderer
    from hrt_tpu_torch.config import RenderConfig
    from hrt_tpu_torch.frameloop import FrameLoop
    from hrt_tpu_torch.models import upscaler
    from hrt_tpu_torch.models.scene import bench_scene
    from hrt_tpu_torch.ops import denoise, warp_kernel as k6

    post = dict(max_depth=1, sky=True, denoise=True, upscale=2,
                upscale_mode="temporal")
    full_cfg = RenderConfig(width=1920, height=1080, **post)

    phase("phase 20: K6 vs its plain version and grid_sample on a "
          "moving-camera post frame's inputs")
    wloop = FrameLoop(bench_scene(), full_cfg, device=dev)
    for f in range(2):
        wloop.step(post_cam(f))
    w_cams = renderer.camera_arrays(post_cam(2), full_cfg, dev)
    w_img, w_gb = renderer.render_rows(wloop.scene, wloop.accel, w_cams, 0,
                                       1080, full_cfg, want_gbuffer=True)
    prev = wloop.prev_cams
    proj = lambda wp, w, h: denoise._project(
        wp, prev.origin, prev.basis, prev.tan_half_fovy, prev.aspect, w,
        h)[:2]
    shapes = {
        "svgf 1920x1080 C=10": (torch.cat(list(wloop.dn_state), -1),
                                *proj(w_gb["world_pos"], 1920, 1080)),
        "upscaler 3840x2160 C=3": (wloop.up_history, *proj(
            upscaler._upsample2_corner(w_gb["world_pos"]), 3840, 2160))}
    k6_err = 0.0
    grids = {}
    for label, (img, px, py) in shapes.items():
        kv, kvalid = k6.warp_bilinear_kernel(img, px, py)
        pv, pvalid = k6.warp_bilinear_plain(img, px, py)
        # The error scale of a pixel: its taps' absolute weighted sum.
        scale = k6.warp_bilinear_plain(img.abs(), px, py)[0].clamp(
            min=1e-30)
        torch.cuda.synchronize()
        inb = pvalid[..., None].expand_as(kv)
        rel = float(((kv - pv).abs() / scale)[inb].max())
        err = float((kv - pv)[inb].abs().max())
        k6_err = max(k6_err, err)
        sm.check(torch.equal(kvalid, pvalid),
                 f"{label}: valid identical on {kvalid.numel()} pixels "
                 f"({float(pvalid.float().mean()):.4f} in bounds)")
        sm.check(rel <= 1e-5 and bool(torch.isfinite(kv).all()),
                 f"{label}: rel err {rel:.3g} at in-bounds pixels (max abs "
                 f"{err:.3g}), finite everywhere")
        # grid_sample's normalized coordinates, in float64 for the check
        # (in float32 their rounding moves a tap by ~1e-6 px, which the
        # moments' steep edges turn into errors far above 1e-5).
        hs, ws, c = img.shape
        grid = lambda x, y: torch.stack([x / (ws - 1) * 2 - 1,
                                         y / (hs - 1) * 2 - 1], -1)[None]
        src = img.permute(2, 0, 1)[None].contiguous()
        grids[label] = (src, grid(px, py))
        gs = F.grid_sample(src.double(), grid(px.double(), py.double()),
                           mode="bilinear", padding_mode="border",
                           align_corners=True)
        gs = gs[0].permute(1, 2, 0)
        rel_gs = float(((kv.double() - gs).abs() / scale)[inb].max())
        sm.check(rel_gs <= 1e-5, f"{label}: vs grid_sample (float64) rel "
                 f"err {rel_gs:.3g} at in-bounds pixels")
        del kv, pv, scale, gs

    results = {}
    for ph, (w, h, steps) in ((21, (512, 384, 8)), (22, (1920, 1080, 4))):
        phase(f"phase {ph}: post FrameLoop, {steps} steps at {w}x{h} -> "
              f"{2 * w}x{2 * h} along the moving camera")
        cfg = RenderConfig(width=w, height=h, **post)
        deltas, totals, peak, img, ref, loop = run_post_loop(dev, cfg, steps)
        want = {"k6": 2, "k1_closest": 1, "k1_any_hit": 1, "k2": 1, "k3": 0}
        sm.check(all(d == want for d in deltas) and loop.rebuilds == 0,
                 f"launches per step {deltas[-1]} on all {steps} steps, "
                 f"totals {totals}, {loop.rebuilds} rebuilds")
        sm.check(tuple(img.shape) == (2 * h, 2 * w, 3)
                 and bool(torch.isfinite(img).all()),
                 f"frame {tuple(img.shape)} finite")
        p = psnr4(img, ref)
        sm.check(p > 45.0, f"last frame vs the plain replay PSNR {p:.2f}")
        print(f"  peak memory of the kernel loop: {peak / 2**30:.3f} GiB",
              flush=True)
        results[ph] = dict(totals=totals, loop=loop, steps=steps)
        if ph == 21:
            for mode, kw in (("spatial", dict(upscale_mode="spatial")),
                             ("denoise-only", dict(upscale=1))):
                c = RenderConfig(width=w, height=h, **{**post, **kw})
                before = k6.LAUNCHES["warp_bilinear"]
                out = FrameLoop(bench_scene(), c, device=dev).step(
                    post_cam(0))
                torch.cuda.synchronize()
                shape = (2 * h, 2 * w, 3) if c.upscale == 2 else (h, w, 3)
                sm.check(tuple(out.shape) == shape
                         and bool(torch.isfinite(out).all())
                         and k6.LAUNCHES["warp_bilinear"] == before + 1,
                         f"{mode} step: frame {tuple(out.shape)} finite, one "
                         "K6 launch (SVGF)")
        del ref

    phase("phase 23: post times (CUDA events, median of 7; K6, its plain "
          "version, grid_sample and the baseline K6 10 calls per sample)")
    t = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    for label, (img, px, py) in shapes.items():
        src, grid = grids[label]
        ho, wo = px.shape
        n_bytes = nbytes(img, px, py) + ho * wo * (4 * img.shape[2] + 1)
        ops = ho * wo * (7 * img.shape[2] + 12)
        kernel = lambda: k6.warp_bilinear_kernel(img, px, py)
        row = {"ms": time_ms(kernel, calls=10),
               "plain_ms": time_ms(lambda: k6.warp_bilinear_plain(img, px,
                                                                  py),
                                   calls=10),
               "library_ms": time_ms(lambda: F.grid_sample(
                   src, grid, mode="bilinear", padding_mode="border",
                   align_corners=True), calls=10),
               "bound_ms": bound(n_bytes, ops)[0]}
        print(f"  K6 {label}: kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, grid_sample {row['library_ms']:.4f}"
              f" ms, bound {row['bound_ms']:.4f} ms ({n_bytes} bytes, "
              f"{bound(n_bytes, ops)[1]}); one call alone (the host's "
              f"cost included) {time_ms(kernel):.4f} ms", flush=True)
        if has_baseline(baseline, "hrt_warp_bilinear"):
            bv, bvalid = baseline_k6(baseline, img, px, py)
            kv, kvalid = k6.warp_bilinear_kernel(img, px, py)
            dv = float(((bv - kv).abs() / bv.abs().clamp(min=1.0)).max())
            sm.check(torch.equal(bvalid, kvalid) and dv <= 1e-6,
                     f"K6 {label} vs the baseline K6: valid identical, "
                     f"values within rel {dv:.3g}")
            del bv, kv
            b, c = in_turns(lambda: baseline_k6(baseline, img, px, py),
                            kernel, calls=10)
            print(f"  K6 {label} in turns (baseline, current, current, "
                  f"baseline): {b[0]:.4f}, {c[0]:.4f}, {c[1]:.4f}, "
                  f"{b[1]:.4f} ms; current / baseline "
                  f"{sum(c) / sum(b):.4f}", flush=True)
        for k in t:
            t[k] += row[k]
    hist = upscaler.reproject_history(wloop.up_history, w_gb["world_pos"],
                                      w_gb["hit"], prev, 1920, 1080)
    stages = {
        "svgf": lambda: denoise.svgf(wloop.dn_state, w_img, w_gb, prev, 1920,
                                     1080),
        "reproject_history": lambda: upscaler.reproject_history(
            wloop.up_history, w_gb["world_pos"], w_gb["hit"], prev, 1920,
            1080),
        "upscale_temporal (bf16 trunk)": lambda: upscaler.upscale_temporal(
            wloop.net, w_img, hist)}
    for key, fn in stages.items():
        print(f"  {key} at 1920x1080: {time_ms(fn):.4f} ms", flush=True)
    for ph, size in ((21, "512x384"), (22, "1920x1080")):
        r = results[ph]
        k = 4 if ph == 21 else 1
        nxt = [r["steps"]]

        def steps_k(loop=r["loop"], k=k, nxt=nxt):
            for _ in range(k):
                loop.step(post_cam(nxt[0]))
                nxt[0] += 1

        ms = time_ms(steps_k, reps=5) / k
        print(f"  post frame {size} -> 2x: {ms:.4f} ms/frame", flush=True)
        if has_baseline(baseline, "hrt_bvh8_trace") \
                and has_baseline(baseline, "hrt_brdf_light_major"):
            frame_vs_baseline(bench_swaps(baseline), steps_k,
                              f"post frame {size} -> 2x, {k} steps")
    return ({"launches": results[22]["totals"]["k6"],
             "max_abs_err": k6_err, "bound_by": "bytes", **t},
            shapes["upscaler 3840x2160 C=3"])


def bench_phases(sm: Smoke, dev, baseline=None) -> dict:
    """Phases 3-9, the bench frame; `baseline` is load_baseline()'s
    library or None.  Returns K1's and K2's times (`times`), launch
    counts over the 32 frames (`launches`), max abs errors (`errs`) and
    bounds (`bounds`, by frame size: "" for 512x384, "_1080p")."""
    import numpy as np
    import torch

    from hrt_tpu_torch import renderer
    from hrt_tpu_torch.config import RenderConfig
    from hrt_tpu_torch.models.camera import Camera
    from hrt_tpu_torch.models.scene import bench_scene, reference_demo_scene
    from hrt_tpu_torch.ops import intersect, lbvh, shade_kernel, v3
    from hrt_tpu_torch.ops import traversal_wide8 as k1
    from hrt_tpu_torch.ops.v3 import V3

    phase("phase 3: scene + accel")
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
    prim, shadow, k2_args = frame_batches(scene, accel, cams, cfg)
    n, ns = prim[0].numel(), shadow[0].numel()
    nl = scene.lights.shape[0]
    k1_ops = {}

    phase(f"phase 4: K1 on the frame's batches ({n} primary, {ns} shadow "
          "rays)")
    kc = k1.trace_kernel(accel, *prim, cfg.t_min, True)
    k1c_err = check_closest(sm, "K1 vs plain", kc,
                            k1.trace_plain(accel, *prim, cfg.t_min, True))
    ka = k1.trace_kernel(accel, *shadow, cfg.t_min, False)
    k1a_err = check_occlusion(sm, "K1 vs plain", ka,
                              k1.trace_plain(accel, *shadow, cfg.t_min,
                                             False))
    sub = torch.arange(0, n, max(1, n // 4096), device=dev)[:4096]
    bt, bi, _, _ = intersect.closest_hit_bruteforce(
        torch.stack(prim[0:3], 1)[sub], torch.stack(prim[3:6], 1)[sub],
        scene.tri_v0, scene.tri_e1, scene.tri_e2, cfg.t_min)
    ssub = torch.arange(0, ns, max(1, ns // 4096), device=dev)[:4096]
    bocc = intersect.any_hit_bruteforce(
        torch.stack(shadow[0:3], 1)[ssub], torch.stack(shadow[3:6], 1)[ssub],
        scene.tri_v0, scene.tri_e1, scene.tri_e2, cfg.t_min,
        shadow[6][ssub])

    def vs_bruteforce(who, tt, ids, occ, m):
        """Closest ids (original triangle ids, up to equal-t ties with
        brute force) and occlusion of the first m rays of the subsets."""
        orig = torch.where(ids >= 0, accel.tri_perm[ids.clamp(min=0).long()],
                           -1)
        tie = (orig >= 0) & (bi[:m] >= 0) & (
            (tt - bt[:m]).abs() <= 1e-5 * bt[:m].abs())
        a = float(((orig == bi[:m]) | tie).float().mean())
        sm.check(a >= 0.999, f"closest {who} vs brute force on {m} rays: "
                 f"{a:.6f} (ids differ on {int((orig != bi[:m]).sum())})")
        a = float((occ == bocc[:m]).float().mean())
        sm.check(a >= 0.999, f"any-hit {who} vs brute force on {m} rays: "
                 f"{a:.6f}")

    vs_bruteforce("kernel", kc[0][sub], kc[1][sub], ka[ssub], 4096)
    pc = k1.trace_plain(accel, *[q[sub] for q in prim], cfg.t_min, True)
    vs_bruteforce("plain", pc[0], pc[1],
                  k1.trace_plain(accel, *[q[ssub] for q in shadow],
                                 cfg.t_min, False), 4096)
    # 4093 of those rays: a partial last warp.
    pp = [q[sub[:4093]] for q in prim]
    ps = [q[ssub[:4093]] for q in shadow]
    kc93 = k1.trace_kernel(accel, *pp, cfg.t_min, True)
    check_closest(sm, "K1 vs plain on 4093 primary rays", kc93,
                  k1.trace_plain(accel, *pp, cfg.t_min, True))
    ka93 = k1.trace_kernel(accel, *ps, cfg.t_min, False)
    check_occlusion(sm, "K1 vs plain on 4093 shadow rays", ka93,
                    k1.trace_plain(accel, *ps, cfg.t_min, False))
    vs_bruteforce("kernel, 4093 rays,", kc93[0], kc93[1], ka93, 4093)
    del kc, ka, pc, bt, bi, bocc
    for key, planes, closest in (("k1_closest", prim, True),
                                 ("k1_any_hit", shadow, False)):
        k1_ops[key] = walk_ops(k1, accel, planes, cfg.t_min, closest,
                               f"K1 {key[3:]} 512x384")

    phase(f"phase 5: K2 on the frame's light-major batch ({ns})")
    mat, nrm, view, l_lm, rel, _ = k2_args
    print(f"  plane element strides: material {mat.color.x.stride(0)}, "
          f"normal {nrm.x.stride(0)}, view {view.x.stride(0)}, light "
          f"{l_lm.x.stride(0)}", flush=True)
    k2_err = k2_check(sm, "frame batch (L = 2)", k2_args)
    one = lambda a, i: a[i * n:(i + 1) * n]
    l3 = v3.normalize(l_lm.map(lambda a: one(a, 0))
                      + l_lm.map(lambda a: one(a, 1)))
    k2_check(sm, "L = 1", (mat, nrm, view, l_lm.map(lambda a: one(a, 0)),
                           one(rel, 0), 1))
    k2_check(sm, "L = 3", (mat, nrm, view,
                           V3(*(torch.cat([a, b]) for a, b in zip(l_lm, l3))),
                           torch.cat([rel, one(rel, 0) & one(rel, 1)]), 3))

    phase("phase 6: render_frames x32 at 512x384")
    reset(k1.LAUNCHES, shade_kernel.LAUNCHES)
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
    del imgs, ref

    phase("phase 7: one 1920x1080 frame")
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
    del ref_hd, img_hd
    prim_hd, shadow_hd, k2_hd = frame_batches(scene, accel, cams_hd, cfg_hd)
    k2_check(sm, "1080p frame batch", k2_hd)
    for key, planes, closest in (("k1_closest_1080p", prim_hd, True),
                                 ("k1_any_hit_1080p", shadow_hd, False)):
        k1_ops[key] = walk_ops(k1, accel, planes, cfg.t_min, closest,
                               f"K1 {key[3:-6]} 1920x1080")

    phase("phase 8: golden frames at 64x48 through the kernels")
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
    # cornell_gi: the Cornell box at depth 3 with bounces and Russian
    # roulette, through the kernels at every depth.  Its walls meet on
    # edges that the golden camera's unjittered rays hit exactly along
    # the image diagonals |px - 32| = |py - 24|, where two walls tie in t
    # and rounding picks one (JAX's own frame on another walk differs
    # from the golden there): held off those diagonals.
    from hrt_tpu_torch.models.scenefile import cornell_box

    c_scene = cornell_box().build(dev)
    c_accel = lbvh.build_bvh_sah(c_scene, leaf_size=32)
    c_cfg = RenderConfig(width=64, height=48, max_depth=3, indirect=True)
    before = k1.LAUNCHES["closest"]
    img = torch.as_tensor(renderer.render(c_scene, Camera(**CORNELL_CAM),
                                          c_cfg, c_accel))
    gold = torch.as_tensor(np.load(os.path.join(
        ROOT, "tests", "goldens", "cornell_gi.npz"))["image"])
    py, px = np.mgrid[0:48, 0:64]
    tie = torch.as_tensor(np.abs(px - 32) == np.abs(py - 24))
    off = (img - gold).abs().amax(-1) > 1e-3
    gold_psnr["cornell_gi"] = psnr4(img[~tie], gold[~tie])
    sm.check(k1.LAUNCHES["closest"] == before + 3
             and gold_psnr["cornell_gi"] > 45.0 and not bool((off & ~tie)
                                                             .any()),
             f"cornell_gi: kernel frame vs golden PSNR "
             f"{gold_psnr['cornell_gi']:.2f} off the {int(tie.sum())} "
             f"edge-tie pixels, none off them beyond 1e-3 (whole frame "
             f"{psnr4(img, gold):.2f}, {int(off.sum())} pixels beyond 1e-3)")

    phase("phase 9: K1 and K2 times (CUDA events, median of 7; the kernels "
          "10 calls per sample, one call alone beside; the plain walks 3 "
          "samples), against the baseline ones in turns; frames")
    times = {}
    for size, (pr, sh, ka2) in (("", (prim, shadow, k2_args)),
                                ("_1080p", (prim_hd, shadow_hd, k2_hd))):
        times.update(bench_kernel_times(sm, baseline, accel, pr, sh, ka2,
                                        cfg.t_min, size))
    rays_512 = cfg.width * cfg.height * cfg.spp * (1 + nl)
    rays_hd = cfg_hd.width * cfg_hd.height * cfg_hd.spp * (1 + nl)
    ms_512 = time_ms(lambda: renderer.render_frames(
        scene, accel, cams, 0, 32, cfg), reps=5) / 32
    ms_hd = time_ms(lambda: renderer.render_frames(
        scene, accel, cams_hd, 0, 1, cfg_hd), reps=5)
    for key, ms, rays in (("512x384", ms_512, rays_512),
                          ("1920x1080", ms_hd, rays_hd)):
        print(f"  frame {key}: {ms:.4f} ms/frame, {rays / ms / 1e3:.2f} "
              "Mray/s", flush=True)
    if has_baseline(baseline, "hrt_bvh8_trace") \
            and has_baseline(baseline, "hrt_brdf_light_major"):
        frame_vs_baseline(bench_swaps(baseline),
                          lambda: renderer.render_frames(scene, accel, cams,
                                                         0, 4, cfg),
                          "bench frame 512x384, 4 frames")
        frame_vs_baseline(bench_swaps(baseline),
                          lambda: renderer.render_frames(scene, accel,
                                                         cams_hd, 0, 1,
                                                         cfg_hd),
                          "bench frame 1920x1080, 1 frame")
    # Rays, shadow rays and relevant BRDF elements of the two sizes.
    sizes = {"": (walk_bytes(prim, 16), walk_bytes(shadow, 1),
                  k2_bytes(k2_args), int(rel.sum())),
             "_1080p": (walk_bytes(prim_hd, 16), walk_bytes(shadow_hd, 1),
                        k2_bytes(k2_hd), int(k2_hd[4].sum()))}
    del prim_hd, shadow_hd, k2_hd

    # K1's and K2's bounds: the bytes walk_bytes (hits out: t, tri, u, v;
    # a byte of occlusion) and k2_bytes count, the tables the walk reads
    # once.
    w8_tab = nbytes(accel.w8_rec, accel.tris)
    bounds = {}
    for size, (c_bytes, a_bytes, b_bytes, n_rel) in sizes.items():
        work = {"k1_closest": (w8_tab + c_bytes,
                               k1_ops["k1_closest" + size]),
                "k1_any_hit": (w8_tab + a_bytes,
                               k1_ops["k1_any_hit" + size]),
                "k2": (b_bytes, n_rel * K2_OPS_PER_ELEMENT)}
        for key, (n_bytes, ops) in work.items():
            bounds[key + size] = bound(n_bytes, ops)
            print(f"  {key + size} bound: bytes {bound(n_bytes)[0]:.6f} ms "
                  f"({n_bytes} bytes), operations {bound(0, ops)[0]:.6f} ms "
                  f"({ops:.4e})", flush=True)
    return {"times": times, "launches": launches, "bounds": bounds,
            "errs": {"k1_closest": k1c_err, "k1_any_hit": k1a_err,
                     "k2": k2_err}}


def py_hash3(x: int, y: int, z: int) -> int:
    """shaders/random.slang's hash, in Python integers (as
    tests/test_rng.py reimplements it)."""
    m = 0xFFFFFFFF
    p1, p2, p3, p4 = 2246822519, 3266489917, 668265263, 374761393
    h = (z + p4 + x * p2) & m
    h = (p3 * (((h << 17) | (h >> 15)) & m)) & m
    h = (h + y * p2) & m
    h = (p3 * (((h << 17) | (h >> 15)) & m)) & m
    h = (p1 * (h ^ (h >> 15))) & m
    h = (p2 * (h ^ (h >> 13))) & m
    return h ^ (h >> 16)


def py_pcg(state: int):
    """shaders/random.slang's PCG step -> (word, new state)."""
    m = 0xFFFFFFFF
    prev = (state * 747796405 + 2891336453) & m
    word = ((((prev >> ((prev >> 28) + 4)) & m) ^ prev) * 277803737) & m
    return ((word >> 22) ^ word) & m, prev


def rng_phase(sm: Smoke, dev) -> None:
    """Phase 24: the RNG on the card against the CPU, bit for bit, and
    the fixed vectors of tests/test_rng.py."""
    import torch

    from hrt_tpu_torch.ops import rng

    phase("phase 24: the RNG on the card (1M words with 0 and 0xFFFFFFFF) "
          "against the CPU, and tests/test_rng.py's fixed vectors")
    g = torch.Generator().manual_seed(24)
    w = torch.randint(0, 2**32, (1 << 20,), dtype=torch.int64, generator=g)
    w[:4] = torch.tensor([0, 0xFFFFFFFF, 1, 0xFFFFFFFE])
    bits = lambda u: u.view(torch.int32).to(torch.int64)
    fns = {
        "hash3": lambda a: rng.hash3(a, a.roll(1), a.flip(0)),
        "pcg": lambda a: torch.stack(rng.pcg(a)),
        "rand": lambda a: torch.stack([bits(rng.rand(a)[0]), rng.rand(a)[1]]),
        "rand2": lambda a: torch.stack([bits(x) for x in rng.rand2(a)[:2]]
                                       + [rng.rand2(a)[2]]),
        "pixel_seed": lambda a: torch.stack([rng.pixel_seed(a, a.roll(3), f)
                                             for f in (0, 1, 0xFFFFFFFF)])}
    for name, fn in fns.items():
        card = fn(w.to(dev)).cpu()
        sm.check(torch.equal(card, fn(w)), f"{name} on the card bit-equal to "
                 f"the CPU on {w.numel()} words")
    xs = [0, 1, 2, 123, 799, 2**31]
    ys = [0, 5, 599, 7, 12, 99]
    zs = [0, 0, 1, 2, 3, 1000]
    t = lambda v: torch.tensor(v, dtype=torch.int64, device=dev)
    got = rng.hash3(t(xs), t(ys), t(zs)).cpu().tolist()
    want = [py_hash3(x, y, z) for x, y, z in zip(xs, ys, zs)]
    ok = got == want
    state, card_state = 12345, t([12345])
    for _ in range(8):
        want_word, state = py_pcg(state)
        word, card_state = rng.pcg(card_state)
        ok &= int(word) == want_word and int(card_state) == state
    sm.check(ok, "fixed vectors on the card: hash3 of six pixels and 8 PCG "
             "steps from 12345 as shaders/random.slang")


def batch_planes(b: dict, scene, cfg):
    """One depth's captured batch (trace_paths' _batches): its closest-hit
    planes (seven), its light-major shadow planes (seven) and K2's
    arguments, as the frame built them."""
    import torch

    from hrt_tpu_torch import renderer

    o, d, sh = b["o"], b["d"], b["hits"]
    n = o.x.numel()
    tmax = torch.broadcast_to(torch.as_tensor(
        b["t_max"], dtype=torch.float32, device=o.x.device), (n,)).contiguous()
    lb, _ = renderer.nee_light_batch(scene, sh.normal, sh.world_pos, cfg,
                                     sh.hit, b["seed"])
    shadow = (*lb.origin, *lb.l, lb.t_max)
    k2 = (sh.mat, sh.normal, sh.view, lb.l, lb.relevant, len(lb.color))
    return (*o, *d, tmax), shadow, k2


def capture_batches(scene, accel, cams, cfg, frame: int) -> list:
    """Every depth's batch of one frame through the kernels."""
    from hrt_tpu_torch import renderer

    batches = []
    renderer.render_rows(scene, accel, cams, 0, cfg.height, cfg, frame=frame,
                         _batches=batches)
    return batches


def strided(n: int, m: int, dev):
    """m ray indices spread over a batch of n (a sorted batch's retired
    rays, at its end, among them)."""
    import torch

    return torch.linspace(0, n - 1, m, device=dev).long()


def bounce_phase(sm: Smoke, dev, scene, accel) -> None:
    """Phase 25: K1 and K2 on the bounce batches of the path_tracing frame
    at 512x384."""
    import dataclasses

    import torch

    from hrt_tpu_torch import renderer
    from hrt_tpu_torch.config import CONFIGS
    from hrt_tpu_torch.models.camera import Camera
    from hrt_tpu_torch.ops import intersect
    from hrt_tpu_torch.ops import traversal_wide8 as k1

    w, h = PT_SMALL
    cfg = dataclasses.replace(CONFIGS["path_tracing"], width=w, height=h,
                              sort_bounces=True)
    phase(f"phase 25: K1 and K2 on the bounce batches of the path_tracing "
          f"frame at {w}x{h} (sorted, frame 1): kernel vs plain on all rays, "
          "both vs brute force on 4093 rays with retired lanes among them")
    cams = renderer.camera_arrays(Camera(**BENCH_CAM), cfg, dev)
    batches = capture_batches(scene, accel, cams, cfg, frame=1)
    for depth in (1, 3):
        prim, shadow, k2 = batch_planes(batches[depth], scene, cfg)
        n, ns = prim[0].numel(), shadow[0].numel()
        live = float((prim[6] >= 0).float().mean())
        print(f"  depth {depth}: {n} rays, {live:.4f} live; {ns} shadow rays, "
              f"{float((shadow[6] >= 0).float().mean()):.4f} live",
              flush=True)
        label = f"K1 vs plain, depth-{depth} bounce batch"
        kc = k1.trace_kernel(accel, *prim, cfg.t_min, True)
        pc = k1.trace_plain(accel, *prim, cfg.t_min, True)
        check_closest(sm, label, kc, pc, min_hits=0.01 * live)
        ka = k1.trace_kernel(accel, *shadow, cfg.t_min, False)
        pa = k1.trace_plain(accel, *shadow, cfg.t_min, False)
        check_occlusion(sm, label, ka, pa)
        sub = strided(n, 4093, dev)
        bt, bi, _, _ = intersect.closest_hit_bruteforce(
            torch.stack(prim[0:3], 1)[sub], torch.stack(prim[3:6], 1)[sub],
            scene.tri_v0, scene.tri_e1, scene.tri_e2, cfg.t_min)
        dead = prim[6][sub] < 0
        bi = torch.where(dead, -1, bi)
        ssub = strided(ns, 4093, dev)
        bocc = intersect.any_hit_bruteforce(
            torch.stack(shadow[0:3], 1)[ssub],
            torch.stack(shadow[3:6], 1)[ssub], scene.tri_v0, scene.tri_e1,
            scene.tri_e2, cfg.t_min, shadow[6][ssub])
        for who, (tt, ids), occ in (("kernel", kc[:2], ka), ("plain", pc[:2],
                                                           pa)):
            ids = ids[sub]
            orig = torch.where(ids >= 0,
                               accel.tri_perm[ids.clamp(min=0).long()], -1)
            tie = (orig >= 0) & (bi >= 0) & (
                (tt[sub] - bt).abs() <= 1e-5 * bt.abs())
            a = float(((orig == bi) | tie).float().mean())
            sm.check(a >= 0.999 and bool((ids[dead] < 0).all()),
                     f"depth {depth}: closest {who} vs brute force on 4093 "
                     f"rays ({int(dead.sum())} retired, all missing): {a:.6f}")
            a = float((occ[ssub] == bocc).float().mean())
            sm.check(a >= 0.999, f"depth {depth}: any-hit {who} vs brute "
                     f"force on 4093 shadow rays: {a:.6f}")
        for key, planes, closest in (("closest", prim, True),
                                     ("any-hit", shadow, False)):
            ops = walk_ops(k1, accel, planes, cfg.t_min, closest,
                           f"K1 {key} depth-{depth} bounce batch {w}x{h}")
            print(f"    operation bound {bound(0, ops)[0]:.6f} ms",
                  flush=True)
        k2_check(sm, f"depth-{depth} bounce batch", k2)
        del kc, pc, ka, pa


def path_loop_phase(sm: Smoke, dev) -> dict:
    """Phase 26: the path_tracing config through FrameLoop at 1920x1080,
    depth 5, sorted: 8 steps through the kernels, 2 replayed with the
    plain versions, the same frame unsorted.  Returns the launch totals
    and the loop."""
    import dataclasses

    import torch

    from hrt_tpu_torch import renderer
    from hrt_tpu_torch.config import CONFIGS
    from hrt_tpu_torch.frameloop import FrameLoop
    from hrt_tpu_torch.models.camera import Camera
    from hrt_tpu_torch.models.scene import bench_scene
    from hrt_tpu_torch.ops import shade_kernel, traversal_skip as k3
    from hrt_tpu_torch.ops import traversal_wide8 as k1

    cfg = dataclasses.replace(CONFIGS["path_tracing"], width=PT_FULL[0],
                              height=PT_FULL[1], sort_bounces=True)
    phase(f"phase 26: path_tracing through FrameLoop at {cfg.width}x"
          f"{cfg.height}, depth {cfg.max_depth}, sorted, 8 steps; 2 replayed "
          "with the plain versions; the frame unsorted")
    cam = Camera(**BENCH_CAM)

    def counts():
        return {"k1_closest": k1.LAUNCHES["closest"],
                "k1_any_hit": k1.LAUNCHES["any_hit"],
                "k2": shade_kernel.LAUNCHES["brdf_light_major"],
                "k3": k3.LAUNCHES["closest"] + k3.LAUNCHES["any_hit"]}

    loop = FrameLoop(bench_scene(), cfg, device=dev)
    ref_loop = FrameLoop(bench_scene(), cfg, device=dev)
    torch.cuda.synchronize()
    reset(k1.LAUNCHES, k3.LAUNCHES, shade_kernel.LAUNCHES)
    deltas, imgs = [], []
    for f in range(8):
        before = counts()
        imgs.append(loop.step(cam))
        deltas.append({k: v - before[k] for k, v in counts().items()})
    torch.cuda.synchronize()
    totals = counts()
    d = cfg.max_depth
    want = {"k1_closest": d, "k1_any_hit": d, "k2": d, "k3": 0}
    sm.check(all(x == want for x in deltas) and loop.frame == 8,
             f"launches per step {deltas[-1]} on all 8 steps, totals {totals}")
    sm.check(all(bool(torch.isfinite(x).all()) for x in imgs)
             and tuple(imgs[-1].shape) == (cfg.height, cfg.width, 3),
             f"8 accumulated frames {tuple(imgs[-1].shape)} finite")
    for f in range(2):
        ref = ref_loop.step(cam, plain=True)
    p = psnr4(imgs[1], ref)
    sm.check(p > 45.0, f"step 2 (the mean of frames 0 and 1) vs the plain "
             f"replay PSNR {p:.2f}")
    del ref, ref_loop
    cams = renderer.camera_arrays(cam, cfg, dev)
    two = renderer.render_frames(loop.scene, loop.accel, cams, 0, 2, cfg)
    uns = renderer.render_frames(loop.scene, loop.accel, cams, 1, 1,
                                 dataclasses.replace(cfg, sort_bounces=False))
    close = torch.isclose(two[1], uns[0], rtol=1e-4, atol=1e-5)
    sm.check(bool(close.all()), f"frame 1 sorted vs unsorted within rtol "
             f"1e-4 / atol 1e-5 on {float(close.float().mean()):.6f} of "
             f"values (max abs diff {float((two[1] - uns[0]).abs().max()):.3g})")
    diff = float((two[0] - two[1]).abs().mean())
    sm.check(bool(torch.isfinite(two).all()) and diff > 0,
             f"frames 0 and 1 finite and different (mean abs diff "
             f"{diff:.4g})")
    return {"totals": totals, "loop": loop}


def cornell_phase(sm: Smoke, dev) -> None:
    """Phase 27: whitted and mesh_bvh on the Cornell box at 800x600
    through K1 and K2, against the plain frame."""
    import dataclasses

    import torch

    from hrt_tpu_torch import renderer
    from hrt_tpu_torch.config import CONFIGS
    from hrt_tpu_torch.models.camera import Camera
    from hrt_tpu_torch.models.scenefile import cornell_box
    from hrt_tpu_torch.ops import lbvh, shade_kernel
    from hrt_tpu_torch.ops import traversal_wide8 as k1

    phase(f"phase 27: whitted and mesh_bvh on the Cornell box at "
          f"{PT_CORNELL[0]}x{PT_CORNELL[1]} through K1 and K2")
    scene = cornell_box().build(dev)
    accel = lbvh.build_bvh_sah(scene, leaf_size=32)
    for name in ("whitted", "mesh_bvh"):
        cfg = dataclasses.replace(CONFIGS[name], width=PT_CORNELL[0],
                                  height=PT_CORNELL[1])
        cams = renderer.camera_arrays(Camera(**CORNELL_CAM), cfg, dev)
        reset(k1.LAUNCHES, shade_kernel.LAUNCHES)
        img = renderer.render_frames(scene, accel, cams, 0, 1, cfg)[0]
        torch.cuda.synchronize()
        d = cfg.max_depth if cfg.indirect else 1
        got = (k1.LAUNCHES["closest"], k1.LAUNCHES["any_hit"],
               shade_kernel.LAUNCHES["brdf_light_major"])
        sm.check(got == (d, d, d), f"{name}: K1 closest, any-hit and K2 "
                 f"launches {got}, {d} each")
        ref = renderer.render_frames(scene, accel, cams, 0, 1, cfg,
                                     plain=True)[0]
        p = psnr4(img, ref)
        sm.check(bool(torch.isfinite(img).all()) and p > 45.0,
                 f"{name}: frame {tuple(img.shape)} finite, vs the plain "
                 f"frame PSNR {p:.2f}")


def route_phase(sm: Smoke, dev, routes: dict) -> None:
    """Phase 28: the instanced (K4), culled (K3) and forest (K5) loops
    path-traced (indirect, depth 2) at 512x384, 2 steps each; each walk
    against its plain version on 4093 rays of its depth-1 batch.
    `routes`: walk name -> (loop, walk module, step(f))."""
    import dataclasses

    import torch

    from hrt_tpu_torch.ops import shade_kernel, traversal_skip as k3
    from hrt_tpu_torch.ops import traversal_tlas8 as k4
    from hrt_tpu_torch.ops import traversal_tlas_skip as k5
    from hrt_tpu_torch.ops import traversal_wide8 as k1

    w, h = PT_SMALL
    phase(f"phase 28: the instanced (K4), culled (K3) and forest (K5) loops "
          f"with indirect=True, max_depth=2 at {w}x{h}, 2 steps each")
    walks = {"K1": k1, "K3": k3, "K4": k4, "K5": k5}
    for name, (loop, walk, step) in routes.items():
        loop.set_resolution(w, h)
        loop.config = dataclasses.replace(loop.config, indirect=True,
                                          max_depth=2)
        loop.reset_history()
        ok = True
        for f in range(2):
            reset(shade_kernel.LAUNCHES,
                  *(m.LAUNCHES for m in walks.values()))
            img = step(f)
            torch.cuda.synchronize()
            got = {k: dict(m.LAUNCHES) for k, m in walks.items()}
            want = {k: ({"closest": 2, "any_hit": 2} if k == name
                        else {"closest": 0, "any_hit": 0}) for k in walks}
            ok &= (got == want
                   and shade_kernel.LAUNCHES["brdf_light_major"] == 2)
        sm.check(ok, f"{name} loop: launches per step {got[name]} on both "
                 f"steps, K2 {shade_kernel.LAUNCHES['brdf_light_major']}, no "
                 "other walk")
        sm.check(tuple(img.shape) == (h, w, 3)
                 and bool(torch.isfinite(img).all()),
                 f"{name} loop: frame {tuple(img.shape)} finite")
        b = capture_batches(loop.scene, loop.accel, loop.prev_cams,
                            loop.config, frame=loop.frame)
        prim, shadow, _ = batch_planes(b[1], loop.scene, loop.config)
        sub = strided(prim[0].numel(), 4093, dev)
        ssub = strided(shadow[0].numel(), 4093, dev)
        pp = [q[sub] for q in prim]
        ps = [q[ssub] for q in shadow]
        live = float((pp[6] >= 0).float().mean())
        t_min = loop.config.t_min
        check_closest(sm, f"{name} vs plain on 4093 rays of the depth-1 "
                      f"bounce batch ({live:.3f} live)",
                      walk.trace_kernel(loop.accel, *pp, t_min, True),
                      walk.trace_plain(loop.accel, *pp, t_min, True),
                      min_hits=0.01 * live)
        check_occlusion(sm, f"{name} vs plain on 4093 shadow rays of the "
                        "depth-1 bounce batch",
                        walk.trace_kernel(loop.accel, *ps, t_min, False),
                        walk.trace_plain(loop.accel, *ps, t_min, False))


def animated_phase(sm: Smoke, dev) -> dict:
    """Phase 29: animated_4k (the path_tracing frame at depth 3, SVGF and
    the temporal 2x upscaler, 1080p -> 4K), 4 steps along post_cam; the
    first replayed with the plain versions.  Returns the kernel loop and
    its launch totals."""
    import dataclasses

    import torch

    from hrt_tpu_torch.config import CONFIGS

    w, h = PT_FULL
    cfg = dataclasses.replace(CONFIGS["animated_4k"], width=w, height=h,
                              sort_bounces=True, upscale_mode="temporal")
    phase(f"phase 29: animated_4k, {w}x{h} depth 3 -> SVGF -> the temporal "
          f"2x upscaler -> {2 * w}x{2 * h}, 4 steps along the moving camera")
    deltas, totals, peak, img, ref, loop = run_post_loop(dev, cfg, 4,
                                                         replay=1)
    want = {"k6": 2, "k1_closest": 3, "k1_any_hit": 3, "k2": 3, "k3": 0}
    sm.check(all(d == want for d in deltas), f"launches per step "
             f"{deltas[-1]} on all 4 steps, totals {totals}")
    sm.check(tuple(img.shape) == (2 * h, 2 * w, 3)
             and bool(torch.isfinite(img).all()),
             f"frame {tuple(img.shape)} finite")
    p = psnr4(img, ref)
    sm.check(p > 45.0, f"step 1 vs the plain replay PSNR {p:.2f}")
    print(f"  peak memory of the kernel loop: {peak / 2**30:.3f} GiB",
          flush=True)
    return {"loop": loop, "totals": totals, "steps": 4}


def busy_share(fn) -> None:
    """The card's busy share of one fn() call (torch.profiler, once): the
    device kernels' summed time over the call's host-clock time, with
    the ten kernels that took most."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev_ms, n_kern, rows = 0.0, 0, []
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0)) / 1e3
        if t > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            dev_ms += t
            n_kern += e.count
            rows.append((t, e.count, e.key))
    if not rows:
        print("  busy share: not measured (the profile shows no device "
              "time)", flush=True)
        return
    print(f"  busy share of one call: {dev_ms:.4f} ms of device kernels "
          f"({n_kern} launches) in {wall:.4f} ms under the profiler = "
          f"{dev_ms / wall:.4f}", flush=True)
    for t, c, k in sorted(rows, reverse=True)[:10]:
        print(f"    {t:.4f} ms, {c} calls: {k[:90]}", flush=True)


def path_times(sm: Smoke, dev, scene, accel, pt: dict, anim: dict) -> dict:
    """Phase 30: the path-traced frames' times, K1 and K2 on every depth's
    batch of the 1080p frame beside their bounds and held against their
    plain versions, the sort's own time and the card's busy share.
    Returns the kernels line's entries for the path_tracing frame's K1
    (both modes) and K2 launches, their max abs errors from these
    batches."""
    import dataclasses

    import torch

    from hrt_tpu_torch import renderer
    from hrt_tpu_torch.config import CONFIGS
    from hrt_tpu_torch.frameloop import FrameLoop
    from hrt_tpu_torch.models.camera import Camera
    from hrt_tpu_torch.models.scene import bench_scene
    from hrt_tpu_torch.ops import shade_kernel, wavefront
    from hrt_tpu_torch.ops import traversal_wide8 as k1

    phase("phase 30: path-traced times (CUDA events, median of 7; the "
          "kernels 10 calls per sample, the plain versions 3 samples)")
    cam = Camera(**BENCH_CAM)
    nl = scene.lights.shape[0]
    for srt in (True, False):
        for (w, h), k in ((PT_SMALL, 4), (PT_FULL, 2)):
            cfg = dataclasses.replace(CONFIGS["path_tracing"], width=w,
                                      height=h, sort_bounces=srt)
            loop = FrameLoop(bench_scene(), cfg, device=dev)
            ms = time_ms(lambda: [loop.step(cam) for _ in range(k)],
                         reps=5) / k
            rays = w * h * cfg.spp * (1 + nl) * cfg.max_depth
            print(f"  path_tracing {w}x{h} {'sorted' if srt else 'unsorted'}"
                  f": {ms:.4f} ms/frame, {rays / ms / 1e3:.2f} Mray/s "
                  f"({rays} rays a frame)", flush=True)
    aloop, nxt = anim["loop"], [anim["steps"]]

    def anim_steps():
        for _ in range(2):
            aloop.step(post_cam(nxt[0]))
            nxt[0] += 1

    print(f"  animated_4k {PT_FULL[0]}x{PT_FULL[1]} -> 2x: "
          f"{time_ms(anim_steps, reps=3) / 2:.4f} ms/frame", flush=True)

    w, h = PT_FULL
    cfg = dataclasses.replace(CONFIGS["path_tracing"], width=w, height=h,
                              sort_bounces=True)
    cams = renderer.camera_arrays(cam, cfg, dev)
    batches = capture_batches(scene, accel, cams, cfg, frame=1)
    w8_tab = nbytes(accel.w8_rec, accel.tris)
    tot = {key: dict(ms=0.0, plain_ms=0.0, ops=0.0, bytes=0.0, err=0.0)
           for key in ("closest", "any_hit", "k2")}
    for b in batches:
        depth = b["depth"]
        prim, shadow, k2 = batch_planes(b, scene, cfg)
        jobs = {
            "closest": (lambda: k1.trace_kernel(accel, *prim, cfg.t_min, True),
                        lambda: k1.trace_plain(accel, *prim, cfg.t_min, True),
                        w8_tab + walk_bytes(prim, 16),
                        walk_ops(k1, accel, prim, cfg.t_min, True,
                                 f"K1 closest depth {depth} full size")),
            "any_hit": (lambda: k1.trace_kernel(accel, *shadow, cfg.t_min,
                                                False),
                        lambda: k1.trace_plain(accel, *shadow, cfg.t_min,
                                               False),
                        w8_tab + walk_bytes(shadow, 1),
                        walk_ops(k1, accel, shadow, cfg.t_min, False,
                                 f"K1 any-hit depth {depth} full size")),
            "k2": (lambda: shade_kernel.brdf_light_major_kernel(*k2),
                   lambda: shade_kernel.brdf_light_major_plain(*k2),
                   k2_bytes(k2), int(k2[4].sum()) * K2_OPS_PER_ELEMENT)}
        for key, (kern, plain, n_bytes, ops) in jobs.items():
            ms = time_ms(kern, calls=10)
            plain_ms = time_ms(plain, reps=3)
            bms, by = bound(n_bytes, ops)
            live = float(((shadow if key == "any_hit" else prim)[6] >= 0)
                         .float().mean())
            print(f"  {key} depth {depth} ({live:.4f} live): {ms:.4f} ms "
                  f"(one call alone {time_ms(kern):.4f}), plain "
                  f"{plain_ms:.4f} ms, bound {bms:.6f} ms ({by}; "
                  f"{n_bytes} bytes, {ops:.4e} operations)", flush=True)
            label = f"{key} depth-{depth} batch {w}x{h}"
            if key == "closest":
                err = check_closest(sm, f"K1 vs plain, {label}", kern(),
                                    plain(), min_hits=0.01 * live)
            elif key == "any_hit":
                err = check_occlusion(sm, f"K1 vs plain, {label}", kern(),
                                      plain())
            else:
                err = k2_check(sm, label, k2)
            t = tot[key]
            t["ms"] += ms
            t["plain_ms"] += plain_ms
            t["ops"] += ops
            t["bytes"] += n_bytes
            t["err"] = max(t["err"], err)
    # K1 on the same frame's depth-1 and depth-3 batches unsorted: what
    # the sort buys the walks.
    uns_cfg = dataclasses.replace(cfg, sort_bounces=False)
    uns = capture_batches(scene, accel, cams, uns_cfg, frame=1)
    for depth in (1, 3):
        ordered = {"sorted": batch_planes(batches[depth], scene, cfg),
                   "unsorted": batch_planes(uns[depth], scene, uns_cfg)}
        line = []
        for key, i, closest in (("closest", 0, True), ("any_hit", 1, False)):
            for order, planes in ordered.items():
                ms = time_ms(lambda: k1.trace_kernel(
                    accel, *planes[i], cfg.t_min, closest), calls=10)
                line.append(f"{key} {order} {ms:.4f}")
        print(f"  K1 on depth {depth}, sorted and unsorted (ms): "
              + ", ".join(line), flush=True)
    # The sort of depth 1 alone: its key, torch.sort and the gathers of
    # the wavefront's planes (o, d, seed, throughput, radiance, pixel
    # index).
    o, d = batches[1]["o"], batches[1]["d"]
    n = o.x.numel()
    active = batches[1]["t_max"] >= 0
    planes = [*o, *d, *(torch.rand(n, device=dev) for _ in range(6))]
    seed = torch.randint(0, 2**32, (n,), device=dev)
    orig = torch.randperm(n, device=dev)
    keyf = lambda: torch.where(active, wavefront.bounce_sort_key_p(o, d) >> 1,
                               0xFFFFFFFF)
    key = keyf()
    perm = torch.sort(key, stable=True)[1]
    parts = {"key": keyf,
             "torch.sort": lambda: torch.sort(key, stable=True),
             "gathers (13 planes)": lambda: [a[perm] for a in
                                             (*planes, seed, orig)]}
    for label, fn in parts.items():
        print(f"  sort at full size, {label}: {time_ms(fn):.4f} ms", flush=True)
    loop = FrameLoop(bench_scene(), cfg, device=dev)
    print("  one full-size path_tracing step (FrameLoop.step), profiled:",
          flush=True)
    busy_share(lambda: loop.step(cam))
    entries = {}
    for key, t in tot.items():
        bms, by = bound(t["bytes"], t["ops"])
        entries[key] = {"max_abs_err": t["err"], "ms": t["ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": bms,
                        "bound_by": by, "library_ms": None}
        print(f"  {key}, the frame's {cfg.max_depth} launches: {t['ms']:.4f} "
              f"ms, plain {t['plain_ms']:.4f} ms, bound {bms:.6f} ms ({by})",
              flush=True)
    return entries


def launch_counts() -> dict:
    """Every kernel's launch counters, by kernel."""
    from hrt_tpu_torch.ops import shade_kernel, traversal_skip as k3
    from hrt_tpu_torch.ops import traversal_tlas8 as k4
    from hrt_tpu_torch.ops import traversal_tlas_skip as k5
    from hrt_tpu_torch.ops import traversal_wide8 as k1
    from hrt_tpu_torch.ops import warp_kernel as k6

    return {"k1_closest": k1.LAUNCHES["closest"],
            "k1_any_hit": k1.LAUNCHES["any_hit"],
            "k2": shade_kernel.LAUNCHES["brdf_light_major"],
            "k3": k3.LAUNCHES["closest"] + k3.LAUNCHES["any_hit"],
            "k4_closest": k4.LAUNCHES["closest"],
            "k4_any_hit": k4.LAUNCHES["any_hit"],
            "k5": k5.LAUNCHES["closest"] + k5.LAUNCHES["any_hit"],
            "k6": k6.LAUNCHES["warp_bilinear"],
            "k6_backward": k6.LAUNCHES["warp_bilinear_backward"]}


def reset_all() -> None:
    from hrt_tpu_torch.ops import shade_kernel, traversal_skip as k3
    from hrt_tpu_torch.ops import traversal_tlas8 as k4
    from hrt_tpu_torch.ops import traversal_tlas_skip as k5
    from hrt_tpu_torch.ops import traversal_wide8 as k1
    from hrt_tpu_torch.ops import warp_kernel as k6

    reset(k1.LAUNCHES, k3.LAUNCHES, k4.LAUNCHES, k5.LAUNCHES,
          shade_kernel.LAUNCHES, k6.LAUNCHES)


def drive_loop(sm: Smoke, label: str, loop, cam, steps: int,
               want: dict) -> dict:
    """`steps` steps of a FrameLoop through the kernels, the counters set
    to 0 just before and read just after: every step must launch `want`
    (the counts not named there: none).  Returns the last frame, the
    totals and the run's peak memory above what was held before it
    (earlier phases' loops stay alive)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_all()
    deltas = []
    for _ in range(steps):
        before = launch_counts()
        img = loop.step(cam)
        deltas.append({k: v - before[k] for k, v in launch_counts().items()})
    torch.cuda.synchronize()
    totals = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    full = {k: want.get(k, 0) for k in totals}
    sm.check(all(d == full for d in deltas),
             f"{label}: launches per step {deltas[-1]} on all {steps} steps")
    sm.check(tuple(img.shape) == (loop.config.height, loop.config.width, 3)
             and bool(torch.isfinite(img).all()),
             f"{label}: frame {tuple(img.shape)} finite")
    print(f"  {label}: peak memory {peak / 2**30:.3f} GiB, "
          f"{(peak - held) / 2**30:.3f} GiB above the {held / 2**30:.3f} GiB "
          "held before the run", flush=True)
    return {"img": img, "totals": totals, "peak": peak - held}


def frame_with_batches(loop, frame: int, plain: bool):
    """Frame `frame` of a loop without post stages, rendered again at the
    loop's last camera (plain versions with `plain`), with every depth's
    batch."""
    from hrt_tpu_torch import renderer

    b = []
    img = renderer.render_rows(loop.scene, loop.accel, loop.prev_cams, 0,
                               loop.config.height, loop.config, plain=plain,
                               frame=frame, _batches=b)
    return img, b


def nee_checks(sm: Smoke, label: str, loop, walk, steps: int) -> dict:
    """The last step's frame against its plain replay, and on its depth-0
    batch: the walk's closest and any hit (over the light-major NEE
    batch: the S samples, or every light) and K2 against their plain
    versions, and the sampled lights' picks of the kernel path against
    the plain path's.  Returns the batch's planes and the max errors."""
    import torch

    from hrt_tpu_torch import renderer

    img, kb = frame_with_batches(loop, steps - 1, False)
    ref, pb = frame_with_batches(loop, steps - 1, True)
    p = psnr4(img, ref)
    sm.check(p > 45.0, f"{label}: frame {steps - 1} vs the plain replay PSNR "
             f"{p:.2f}")
    cfg, scene, t_min = loop.config, loop.scene, loop.config.t_min
    prim, shadow, k2 = batch_planes(kb[0], scene, cfg)
    errs = {"closest": check_closest(
        sm, f"{label}: closest vs plain", walk.trace_kernel(
            loop.accel, *prim, t_min, True),
        walk.trace_plain(loop.accel, *prim, t_min, True)),
        "any_hit": check_occlusion(
        sm, f"{label}: any hit vs plain on the light-major batch of "
        f"{k2[5]} samples a ray", walk.trace_kernel(
            loop.accel, *shadow, t_min, False),
        walk.trace_plain(loop.accel, *shadow, t_min, False)),
        "k2": k2_check(sm, f"{label}: L = {k2[5]}", k2) if cfg.brdf != "pbr"
        else float("nan")}
    if cfg.light_samples:
        picks = []
        for b in (kb[0], pb[0]):
            sh = b["hits"]
            lb, _ = renderer.nee_light_batch(scene, sh.normal, sh.world_pos,
                                             cfg, sh.hit, b["seed"])
            picks.append(lb.pick)
        both = kb[0]["hits"].hit & pb[0]["hits"].hit
        agree = min(float((a == b)[both].float().mean())
                    for a, b in zip(*picks))
        sm.check(agree >= 0.999, f"{label}: light picks of the kernel path "
                 f"equal the plain path's on {agree:.6f} of the "
                 f"{int(both.sum())} rays both hit")
    return {"prim": prim, "shadow": shadow, "k2": k2, "errs": errs,
            "batch": kb[0]}


def many_lights_phases(sm: Smoke, dev) -> dict:
    """Phases 31-32: bench_full's many_lights_256_512x384 (the light tree,
    light_sampler="bvh"), the same scene with "auto" (the flat CDF scan
    at 256 lights) and many_lights_scene(1024) with "auto" (the tree)
    through FrameLoop, 32 steps each at 512x384; one 1920x1080 frame of
    the first."""
    import dataclasses

    from hrt_tpu_torch.config import RenderConfig
    from hrt_tpu_torch.frameloop import FrameLoop
    from hrt_tpu_torch.models.camera import Camera
    from hrt_tpu_torch.models.scene import many_lights_scene
    from hrt_tpu_torch.ops import traversal_wide8 as k1

    steps = 32
    base = RenderConfig(width=512, height=384, max_depth=1, sky=True,
                        light_samples=2, light_sampler="bvh",
                        traversal="pallas")
    runs = {"many_lights_256 bvh": (256, base),
            "many_lights_256 auto (scan)": (256, dataclasses.replace(
                base, light_sampler="auto")),
            "many_lights_1024 auto (tree)": (1024, dataclasses.replace(
                base, light_sampler="auto"))}
    phase(f"phase 31: many lights through FrameLoop, {steps} steps each at "
          "512x384 (2 light samples a ray): 256 lights by the tree and by "
          "'auto' (the scan), 1024 lights by 'auto' (the tree)")
    cam = Camera(**BENCH_CAM)
    out = {}
    want = {"k1_closest": 1, "k1_any_hit": 1, "k2": 1}
    for label, (n_lights, cfg) in runs.items():
        loop = FrameLoop(many_lights_scene(n_lights), cfg,
                         cull_threshold_px=0.0, device=dev)
        r = drive_loop(sm, label, loop, cam, steps, want)
        r.update(nee_checks(sm, label, loop, k1, steps), loop=loop)
        out[label] = r
    w, h = PT_FULL
    phase(f"phase 32: one {w}x{h} many_lights_256 frame by the tree")
    loop = out["many_lights_256 bvh"]["loop"]
    loop.set_resolution(w, h)
    drive_loop(sm, f"many_lights_256 bvh {w}x{h}", loop, cam, 1, want)
    img, _ = frame_with_batches(loop, 0, False)
    ref, _ = frame_with_batches(loop, 0, True)
    sm.check(psnr4(img, ref) > 45.0, f"{w}x{h} frame vs the plain replay "
             f"PSNR {psnr4(img, ref):.2f}")
    ms = time_ms(lambda: loop.step(cam))
    px = w * h
    print(f"  many_lights_256 bvh {w}x{h}: {ms:.4f} ms/frame (CUDA events, "
          f"median of 7); traced rays {px * 3} = {px * 3 / ms / 1e3:.2f} "
          f"Mray/s; equivalent queries {px * 257} = "
          f"{px * 257 / ms / 1e3:.2f} Mray/s", flush=True)
    loop.set_resolution(512, 384)
    return out


def scene_file_phases(sm: Smoke, dev) -> dict:
    """Phases 33-34: scenes/studio.yaml at 800x600 (a checkerboard
    texture, a spot light, glass and chrome) direct, path traced and with
    the pbr BSDF; scenes/colonnade.yaml (a directional sun) through
    FrameLoop(two_level=True) (K4) once per light and with one sampled
    light, against its plain replay and the same scene flattened through
    K1."""
    import dataclasses

    from hrt_tpu_torch.config import RenderConfig
    from hrt_tpu_torch.frameloop import FrameLoop
    from hrt_tpu_torch.models.camera import Camera
    from hrt_tpu_torch.models.scenefile import scene_from_dict
    from hrt_tpu_torch.ops import traversal_tlas8 as k4
    from hrt_tpu_torch.ops import traversal_wide8 as k1

    steps = 4
    w, h = PT_CORNELL
    direct = RenderConfig(width=w, height=h, max_depth=2, sky=True)
    studio = {"studio direct": (direct, 1),
              "studio path traced": (dataclasses.replace(
                  direct, max_depth=4, indirect=True, jitter=True), 4),
              "studio pbr": (dataclasses.replace(direct, brdf="pbr"), 1)}
    phase(f"phase 33: scenes/studio.yaml at {w}x{h}, {steps} steps each: "
          "direct (max_depth=2), path traced (max_depth=4, bounces, jitter) "
          "and brdf='pbr'")
    cam = Camera(**STUDIO_CAM)
    out = {}
    for label, (cfg, d) in studio.items():
        loop = FrameLoop(scene_from_dict(STUDIO_SPEC), cfg,
                         cull_threshold_px=0.0, device=dev)
        sm.check(tuple(loop.scene.textures.shape) == (1, 256, 256, 3),
                 f"{label}: one 256x256 texture on the card")
        want = {"k1_closest": d, "k1_any_hit": d,
                "k2": 0 if cfg.brdf == "pbr" else d}
        r = drive_loop(sm, label, loop, cam, steps, want)
        r.update(nee_checks(sm, label, loop, k1, steps), loop=loop)
        out[label] = r
    w, h = PT_SMALL
    phase(f"phase 34: scenes/colonnade.yaml through FrameLoop(two_level="
          f"True) at {w}x{h}, {steps} steps each, once per light and with "
          "one sampled light; vs the scene flattened through K1")
    for label, ls in (("colonnade", 0), ("colonnade sampled", 1)):
        cfg = RenderConfig(width=w, height=h, max_depth=1, sky=True,
                           light_samples=ls)
        loop = FrameLoop(scene_from_dict(COLONNADE_SPEC), cfg,
                         two_level=True, device=dev)
        r = drive_loop(sm, label, loop, cam, steps,
                       {"k4_closest": 1, "k4_any_hit": 1, "k2": 1})
        r.update(nee_checks(sm, label, loop, k4, steps), loop=loop)
        flat = FrameLoop(scene_from_dict(COLONNADE_SPEC), cfg,
                         cull_threshold_px=0.0, device=dev)
        for _ in range(steps):
            img = flat.step(cam)
        p = psnr4(r["img"], img)
        sm.check(p > 45.0, f"{label}: the two-level frame vs the flattened "
                 f"scene's through K1 PSNR {p:.2f}")
        out[label] = r
    return out


def profiled_device_ms(fn) -> float:
    """The device kernels' summed time of one fn() call under
    torch.profiler (after a warm-up call); nan when the profile shows no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ms = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
             for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return ms if ms > 0 else float("nan")


def materials_times(sm: Smoke, dev, ml: dict, sf: dict) -> list:
    """Phase 35: ms/frame (CUDA events, median of 7 steps) and Mray/s of
    every configuration of phases 31-34, counted twice: traced rays
    (pixels x (1 + S) per depth, S the shadow rays a ray traces: the
    light samples, or every light) and bench.py's equivalent queries
    (pixels x (1 + L) per depth, bench.py:36-43); the device ms of light
    sampling (the tree's descent against the scan) and of texture
    sampling (torch.profiler); the tree's and the scan's 256-light
    frames in alternating pairs; the busy share of the many-light
    frames; K1 and K2 on the many_lights_256 frame's batches against
    their plain versions and bounds.  Returns the kernels line's entries
    for them."""
    import torch

    from hrt_tpu_torch import renderer
    from hrt_tpu_torch.models.camera import Camera
    from hrt_tpu_torch.models.materials import BASE_COLOR_TEX
    from hrt_tpu_torch.models.textures import sample_texture_p
    from hrt_tpu_torch.ops import shade_kernel
    from hrt_tpu_torch.ops import traversal_wide8 as k1

    phase("phase 35: many-light, studio and colonnade times (CUDA events, "
          "median of 7; kernels 10 calls per sample)")
    for runs, cam in ((ml, Camera(**BENCH_CAM)), (sf, Camera(**STUDIO_CAM))):
        for label, r in runs.items():
            loop = r["loop"]
            cfg = loop.config
            nl = loop.scene.lights.shape[0]
            s = (cfg.light_samples if cfg.light_samples
                 and nl > cfg.light_samples else nl)
            d = cfg.max_depth if cfg.indirect else 1
            px = cfg.width * cfg.height * cfg.spp
            ms = time_ms(lambda: loop.step(cam))
            print(f"  {label} {cfg.width}x{cfg.height}: {ms:.4f} ms/frame; "
                  f"traced rays {px * (1 + s) * d} = "
                  f"{px * (1 + s) * d / ms / 1e3:.2f} Mray/s; equivalent "
                  f"queries {px * (1 + nl) * d} = "
                  f"{px * (1 + nl) * d / ms / 1e3:.2f} Mray/s; peak memory "
                  f"{r['peak'] / 2**30:.3f} GiB above the run's start",
                  flush=True)
    # The tree against the scan at 256 lights, frame for frame: the
    # frames are host-bound, so only alternating pairs in one call
    # compare them.
    steps = {k: (lambda loop=ml[k]["loop"]: loop.step(Camera(**BENCH_CAM)))
             for k in ("many_lights_256 bvh", "many_lights_256 auto (scan)")}
    tree, scan = steps.values()
    t, c = [], []
    for p in range(10):
        for fn in ((tree, scan) if p % 2 == 0 else (scan, tree)):
            (t if fn is tree else c).append(time_ms(fn, reps=1))
    print(f"  many_lights_256 at 512x384, 10 pairs alternating: median tree "
          f"{statistics.median(t):.4f} ms/frame, scan "
          f"{statistics.median(c):.4f} (tree / scan "
          f"{statistics.median(t) / statistics.median(c):.4f}); tree faster "
          f"in {sum(a < b for a, b in zip(t, c))} of 10", flush=True)
    for label, r in ml.items():
        loop, b = r["loop"], r["batch"]
        sh = b["hits"]
        sample = lambda: renderer.nee_light_batch(
            loop.scene, sh.normal, sh.world_pos, loop.config, sh.hit,
            b["seed"])
        print(f"  {label}: light sampling (nee_light_batch, 2 samples over "
              f"{sh.hit.numel()} rays) {profiled_device_ms(sample):.4f} ms "
              f"device (torch.profiler), {time_ms(sample):.4f} ms CUDA events",
              flush=True)
    st = sf["studio direct"]
    loop = st["loop"]
    t, tri, u, v = k1.trace_kernel(loop.accel, *st["prim"], loop.config.t_min,
                                   True)
    _, _, rows, (tu, tv) = renderer._shade_attrs_p(loop.accel.attr, tri, u, v)
    tex_id = rows[:, BASE_COLOR_TEX].to(torch.int32)
    tex = lambda: sample_texture_p(loop.scene.textures, tex_id, tu, tv)
    print(f"  studio 800x600: texture sampling {profiled_device_ms(tex):.4f} "
          f"ms device (torch.profiler), {time_ms(tex):.4f} ms CUDA events; "
          f"{float((tex_id >= 0).float().mean()):.3f} of rays textured",
          flush=True)
    for label in ("many_lights_256 bvh", "many_lights_256 auto (scan)"):
        loop = ml[label]["loop"]
        print(f"  {label}: one step (FrameLoop.step), profiled:", flush=True)
        busy_share(lambda: loop.step(Camera(**BENCH_CAM)))
    r = ml["many_lights_256 bvh"]
    acc, t_min = r["loop"].accel, r["loop"].config.t_min
    tab = nbytes(acc.w8_rec, acc.tris)
    jobs = {
        "closest": (lambda: k1.trace_kernel(acc, *r["prim"], t_min, True),
                    lambda: k1.trace_plain(acc, *r["prim"], t_min, True),
                    tab + walk_bytes(r["prim"], 16),
                    walk_ops(k1, acc, r["prim"], t_min, True,
                             "K1 closest, many_lights_256")),
        "any_hit": (lambda: k1.trace_kernel(acc, *r["shadow"], t_min, False),
                    lambda: k1.trace_plain(acc, *r["shadow"], t_min, False),
                    tab + walk_bytes(r["shadow"], 1),
                    walk_ops(k1, acc, r["shadow"], t_min, False,
                             "K1 any-hit, many_lights_256 (2 samples)")),
        "k2": (lambda: shade_kernel.brdf_light_major_kernel(*r["k2"]),
               lambda: shade_kernel.brdf_light_major_plain(*r["k2"]),
               k2_bytes(r["k2"]), int(r["k2"][4].sum()) * K2_OPS_PER_ELEMENT)}
    entries = []
    names = {"closest": ("bvh8_trace_closest", K1_SOURCE, K1_REPLACES,
                         "k1_closest"),
             "any_hit": ("bvh8_trace_any_hit", K1_SOURCE, K1_REPLACES,
                         "k1_any_hit"),
             "k2": ("brdf_light_major", K2_SOURCE, K2_REPLACES, "k2")}
    for key, (kern, plain, n_bytes, ops) in jobs.items():
        ms = time_ms(kern, calls=10)
        plain_ms = time_ms(plain, reps=3)
        bms, by = bound(n_bytes, ops)
        print(f"  many_lights_256 bvh {key}: {ms:.4f} ms (one call alone "
              f"{time_ms(kern):.4f}), plain {plain_ms:.4f} ms, bound "
              f"{bms:.6f} ms ({by}; {n_bytes} bytes, {ops:.4e} operations)",
              flush=True)
        name, src, rep, count = names[key]
        entries.append({
            "name": f"{name} (many_lights_256 frame)", "route": "cuda",
            "source": src, "replaces": rep,
            "launches": r["totals"][count], "max_abs_err": r["errs"][key],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": None})
    return entries



# The render command's runs of phase 36: (label, arguments).  Each adds
# --device cuda --stats and an --out of its own.  The bench and colonnade
# runs look from the bench frame's camera (the command's default camera
# at (0, 0, -2) sits inside the bench spheres' field).
_BENCH_ARGS = ["--camera", "0", "-1", "-6", "-0.15", "0", "0"]
CLI_RUNS = [
    ("demo", ["--scene", "demo", "--sky"]),
    ("path_tracing", ["--config", "path_tracing", "--scene", "bench",
                      "--frames", "2", *_BENCH_ARGS]),
    ("orbit", ["--scene", "bench", "--sky", "--frames", "8", "--orbit"]),
    ("colonnade two-level", ["--scene", os.path.join(
        ROOT, "scenes", "colonnade.yaml"),
                             "--two-level", "--sky", *_BENCH_ARGS]),
    ("post", ["--scene", "bench", "--sky", "--denoise", "--upscale", "2",
              "--upscale-mode", "temporal", "--frames", "3", *_BENCH_ARGS]),
    ("bruteforce", ["--scene", "demo", "--sky", "--traversal",
                    "bruteforce"]),
]


def cli_cameras(args) -> list:
    """The cameras the command steps through, frame by frame."""
    from hrt_tpu_torch.models.camera import Camera, orbit_camera

    cam = Camera(position=tuple(args.camera[:3]),
                 rotation=tuple(args.camera[3:]))
    return [orbit_camera(f * 0.15, radius=4.0, height=-1.0) if args.orbit
            else cam for f in range(args.frames)]


def cli_replay(args, dev, state: str | None = None, plain: bool = False):
    """The command's frames again through a FrameLoop built as the
    command builds it (from `state` when given), through the kernels or,
    with `plain`, through their plain versions: the tonemapped frames,
    the HDR frames and each step's host-clock ms (synchronised)."""
    import torch

    from hrt_tpu_torch import cli
    from hrt_tpu_torch.frameloop import FrameLoop
    from hrt_tpu_torch.utils.image import tonemap

    loop = FrameLoop(cli.load_scene(args.scene), cli.render_config(args),
                     cull_threshold_px=1.0 if args.frames > 1 else 0.0,
                     two_level=args.two_level, device=dev)
    if state is not None:
        loop.load_state(state)
    frames, hdr, ms = [], [], []
    for cam in cli_cameras(args):
        t0 = time.perf_counter()
        img = loop.step(cam, plain=plain)
        torch.cuda.synchronize(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        hdr.append(img)
        frames.append(tonemap(img.cpu().numpy(), gamma=args.gamma))
    return frames, hdr, ms


def check_plain(sm: Smoke, label: str, args, dev, hdr: list,
                state: str | None = None) -> float:
    """Every HDR frame of a run against the plain replay of the same
    arguments (the kernels' plain versions, cli_replay(plain=True)):
    PSNR > 45 on each frame, as phases 20-35 hold their frames.  Returns
    the plain replay's seconds."""
    t0 = time.perf_counter()
    _, ref, _ = cli_replay(args, dev, state, plain=True)
    secs = time.perf_counter() - t0
    ps = [psnr4(a, b) for a, b in zip(hdr, ref)]
    sm.check(len(ps) == len(hdr) and min(ps) > 45.0,
             f"{label}: {len(ps)} frame(s) vs the plain replay (every "
             f"kernel's plain version), PSNR "
             f"{', '.join(f'{p:.2f}' for p in ps)} (replay {secs:.2f} s)")
    return secs


class _FrameLog:
    """Collects the ms of each `frame f -> path (x ms)` line the command
    logs."""

    def __init__(self):
        import logging

        self.ms: list[float] = []
        self.handler = logging.Handler()
        self.handler.emit = self._emit

    def _emit(self, record) -> None:
        msg = record.getMessage()
        if msg.startswith("frame ") and msg.endswith(" ms)"):
            self.ms.append(float(msg.rsplit("(", 1)[1].split()[0]))


def run_cli(argv: list) -> tuple:
    """cli.main(argv) in this process with the counters set to 0 just
    before it: (the loop, the launches, the stats line, host seconds,
    each frame's ms as the command logs it)."""
    import contextlib
    import io

    from hrt_tpu_torch import cli
    from hrt_tpu_torch.utils.logging import logger

    buf, log = io.StringIO(), _FrameLog()
    logger.addHandler(log.handler)
    reset_all()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            loop = cli.main(argv)
    finally:
        logger.removeHandler(log.handler)
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    return (loop, counts, json.loads(lines[-1]) if lines else None, seconds,
            log.ms)


def read_own_png(path: str):
    """An (H, W, 3) uint8 image from a PNG that utils/image.encode_png
    wrote (8-bit RGB, filter-0 rows); any other PNG raises."""
    import struct
    import zlib

    import numpy as np

    with open(path, "rb") as f:
        blob = f.read()
    w, h, depth, ctype, _, _, lace = struct.unpack(">IIBBBBB", blob[16:29])
    if blob[12:16] != b"IHDR" or (depth, ctype, lace) != (8, 2, 0):
        raise ValueError(f"{path}: not an 8-bit RGB PNG of encode_png")
    pos, idat = 8, b""
    while pos < len(blob):
        (n,) = struct.unpack(">I", blob[pos:pos + 4])
        if blob[pos + 4:pos + 8] == b"IDAT":
            idat += blob[pos + 8:pos + 8 + n]
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError(f"{path}: filtered rows")
    return rows[:, 1:].reshape(h, w, 3)


def check_pngs(sm: Smoke, label: str, paths: list, frames: list) -> None:
    """Each PNG the command wrote decodes to the replay's frame."""
    import numpy as np

    worst, equal = 0, 1.0
    for path, want in zip(paths, frames):
        got = read_own_png(path)
        if got.shape != want.shape:
            sm.check(False, f"{label}: {os.path.basename(path)} shape "
                     f"{got.shape}, the replay's {want.shape}")
            return
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        worst = max(worst, int(diff.max()))
        equal = min(equal, float((diff == 0).mean()))
    sm.check(len(paths) == len(frames) and worst <= 1 and equal >= 0.999,
             f"{label}: {len(paths)} PNG(s) equal the tonemapped FrameLoop."
             f"step replay on {equal:.6f} of values, max diff {worst}")


def want_launches(sm: Smoke, label: str, counts: dict, loop, frames: int,
                  depth: int, k6: int = 0) -> None:
    """A run's launches: a BRDF call and a closest and an any-hit walk a
    depth a frame, by the accel's route (K1, or K3 after a culling
    rebuild; K4 for a two-level loop), and `k6` warps."""
    n = frames * depth
    if loop.two_level:
        want = {"k4_closest": n, "k4_any_hit": n, "k2": n, "k6": k6}
        ok = counts == {k: want.get(k, 0) for k in counts}
    elif loop.accel is None:
        want = {"k2": n, "k6": k6}
        ok = counts == {k: want.get(k, 0) for k in counts}
    else:
        walks = counts["k1_closest"] + counts["k1_any_hit"] + counts["k3"]
        ok = (counts["k2"] == n and walks == 2 * n
              and counts["k1_closest"] == counts["k1_any_hit"]
              and counts["k4_closest"] + counts["k4_any_hit"]
              + counts["k5"] == 0 and counts["k6"] == k6
              and (loop.rebuilds > 0 or counts["k3"] == 0))
    sm.check(ok, f"{label}: launches {counts} ({frames} frame(s) x {depth} "
             f"depth(s), {loop.rebuilds} rebuild(s))")


def cli_phase(sm: Smoke, dev) -> dict:
    """Phase 36: the render command (hrt_tpu_torch.cli.main) in this
    process, as a user runs it: each of CLI_RUNS, a checkpoint written
    and resumed, the live preview; then the stacked two-level trace
    (ops/twolevel.py) through K3 against its plain walk."""
    import shutil
    import tempfile
    import urllib.request

    import numpy as np
    import torch

    from hrt_tpu_torch import cli, preview, renderer
    from hrt_tpu_torch.config import RenderConfig
    from hrt_tpu_torch.models.camera import Camera
    from hrt_tpu_torch.models.scene import bench_scene
    from hrt_tpu_torch.ops import twolevel
    from hrt_tpu_torch.ops import traversal_skip as k3
    from hrt_tpu_torch.utils.image import psnr

    phase("phase 36: the render command on the card (cli.main, --stats): "
          "demo, path_tracing, orbit, colonnade --two-level, post, brute "
          "force, a checkpoint resumed, the preview, each against a replay "
          "through the kernels and one through their plain versions; the "
          "stacked two-level trace")
    out, loops, pngs = {}, {}, {}
    tmp = tempfile.TemporaryDirectory()
    base = ["--device", str(dev), "--stats"]
    for label, argv in CLI_RUNS:
        path = os.path.join(tmp.name, f"{label.split()[0]}.png")
        full = argv + base + ["--out", path]
        loop, counts, stats, secs, cli_ms = run_cli(full)
        args = cli.build_parser().parse_args(full)
        frames, hdr, ms = cli_replay(args, dev)
        paths = [cli.frame_path(path, f, args.frames)
                 for f in range(args.frames)]
        sm.check(all(os.path.exists(p) for p in paths) and stats is not None
                 and stats["frames"] == args.frames,
                 f"{label}: {args.frames} PNG(s) written, stats line "
                 f"{stats}")
        check_pngs(sm, label, paths, frames)
        cfg = loop.config
        depth = cfg.max_depth if cfg.indirect else 1
        k6 = 2 * args.frames if cfg.denoise and cfg.upscale == 2 else 0
        want_launches(sm, label, counts, loop, args.frames, depth, k6)
        sm.check(all(bool(torch.isfinite(h).all()) for h in hdr),
                 f"{label}: replay frames finite")
        check_plain(sm, label, args, dev, hdr)
        print(f"  {label}: {cfg.width}x{cfg.height} -> "
              f"{tuple(hdr[-1].shape[:2])}, {args.frames} frame(s); the "
              f"command's stats: {stats['ms_per_frame']} ms/frame, "
              f"{stats['mrays_per_sec']} Mray/s (every frame, the first "
              f"included; frames {', '.join(f'{x:.1f}' for x in cli_ms)} "
              f"ms as logged); FrameLoop.step replay: median "
              f"{statistics.median(ms):.4f} ms/frame (frames "
              f"{', '.join(f'{x:.2f}' for x in ms)} ms); cli.main "
              f"{secs:.2f} s in all; {loop.rebuilds} rebuild(s)", flush=True)
        out[label] = {"stats": stats, "replay_ms": ms, "counts": counts,
                      "rebuilds": loop.rebuilds, "cli_ms": cli_ms}
        loops[label] = (loop, cli_cameras(args)[-1])
        pngs[label] = (paths, hdr)
    if out["orbit"]["rebuilds"] == 0:
        print("  orbit: no orbit frame changed visibility, so no LBVH "
              "rebuild and no K3 launch in this run (K3 is held by the "
              "stacked two-level trace below and by phase 28)", flush=True)
    else:
        print(f"  orbit: {out['orbit']['rebuilds']} LBVH rebuild(s), K3 "
              f"launched {out['orbit']['counts']['k3']} times", flush=True)

    # The brute-force frame against the K1 frame of the same arguments.
    a = read_own_png(pngs["bruteforce"][0][0]).astype(np.float64) / 255.0
    b = read_own_png(pngs["demo"][0][0]).astype(np.float64) / 255.0
    p8 = psnr(a, b)
    phdr = psnr4(pngs["bruteforce"][1][0], pngs["demo"][1][0])
    size = "x".join(map(str, pngs["demo"][1][0].shape[1::-1]))
    sm.check(p8 > 45.0 and phdr > 45.0,
             f"brute-force frame vs the K1 frame at {size}: PSNR {p8:.2f} "
             f"(8-bit PNGs), {phdr:.2f} (HDR)")
    step_ms = {k: time_ms(lambda k=k: loops[k][0].step(loops[k][1]))
               for k in ("bruteforce", "demo")}
    print(f"  demo {size} FrameLoop.step (CUDA events, median of 7): brute "
          f"force {step_ms['bruteforce']:.4f} ms, K1 {step_ms['demo']:.4f} "
          f"ms", flush=True)
    out["step_ms"] = step_ms

    # --checkpoint: written by one call, resumed by the next.
    ckpt = os.path.join(tmp.name, "state.npz")
    argv = ["--scene", "demo", "--sky", "--checkpoint", ckpt] + base
    run_cli(argv + ["--out", os.path.join(tmp.name, "c0.png")])
    first = os.path.join(tmp.name, "state0.npz")
    shutil.copy(ckpt, first)
    path = os.path.join(tmp.name, "c1.png")
    loop, counts, _, _, _ = run_cli(argv + ["--out", path])
    with np.load(ckpt) as state:
        resumed = int(state["frame"])
    sm.check(resumed == 2 and loop.frame == 2,
             f"checkpoint: the second call resumed at frame 1 and saved "
             f"frame {resumed}")
    args = cli.build_parser().parse_args(argv)
    frames, hdr, _ = cli_replay(args, dev, first)
    check_pngs(sm, "checkpoint resumed", [path], frames)
    check_plain(sm, "checkpoint resumed", args, dev, hdr, first)
    want_launches(sm, "checkpoint resumed", counts, loop, 1, 1)

    # --preview on port 0: each published frame fetched by urllib.
    fetched = []
    publish = preview.PreviewServer.publish

    def fetch_after_publish(self, rgb8):
        publish(self, rgb8)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{self.port}/frame.png", timeout=30) as r:
            fetched.append((np.array(rgb8), r.read()))

    preview.PreviewServer.publish = fetch_after_publish
    try:
        argv = ["--scene", "demo", "--sky", "--preview", "--frames", "3",
                "--port", "0", "--device", str(dev)]
        loop, counts, _, _, _ = run_cli(argv)
    finally:
        preview.PreviewServer.publish = publish
    args = cli.build_parser().parse_args(argv)
    frames, hdr, _ = cli_replay(args, dev)
    check_plain(sm, "preview", args, dev, hdr)
    decoded = []
    for i, (_, body) in enumerate(fetched):
        p = os.path.join(tmp.name, f"preview_{i}.png")
        with open(p, "wb") as f:
            f.write(body)
        decoded.append(read_own_png(p))
    sm.check(len(fetched) == 3 and all(
        np.array_equal(d, rgb8) for d, (rgb8, _) in zip(decoded, fetched)),
        f"preview: {len(fetched)} frames fetched from /frame.png, each the "
        "frame published")
    check_pngs(sm, "preview", [os.path.join(tmp.name, f"preview_{i}.png")
                               for i in range(len(fetched))], frames)
    want_launches(sm, "preview", counts, loop, 3, 1)
    tmp.cleanup()

    # The stacked two-level trace: K3 over each instance's BLAS, against
    # its plain walk, on the bench scene's 512x384 primary rays.
    w, h = PT_SMALL
    scene_obj = bench_scene()
    t0 = time.perf_counter()
    tl = twolevel.build_two_level(scene_obj, 8, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cfg = RenderConfig(width=w, height=h)
    o, d = renderer.primary_rays(renderer.camera_arrays(
        Camera(**BENCH_CAM), cfg, dev), h, 0, cfg)
    o, d = o.to_array(), d.to_array()
    reset(k3.LAUNCHES)
    kt, ki, ktri, ku, kv = twolevel.trace_two_level(tl, o, d)
    torch.cuda.synchronize()
    k3_launches = dict(k3.LAUNCHES)
    pt, pi, ptri, pu, pv = twolevel.trace_two_level(tl, o, d, plain=True)
    same = (ki == pi) & (ktri == ptri)
    agree = float(same.float().mean())
    hit = same & (pi >= 0)
    t_err = float((kt - pt)[hit].abs().max())
    n_inst = len(scene_obj.instances)
    sm.check(k3_launches == {"closest": n_inst, "any_hit": 0},
             f"stacked two-level trace: K3 launched {k3_launches} "
             f"(one closest walk per instance, {n_inst} instances)")
    sm.check(agree >= 0.99999 and t_err <= 1e-4,
             f"stacked two-level trace (K3) vs its plain walk on {o.shape[0]}"
             f" rays: instance and triangle ids agree on {agree:.6f}, "
             f"{float(hit.float().mean()):.3f} hit, max t err {t_err:.3g}")
    occ = twolevel.trace_two_level(tl, o, d, find_closest=False)[1]
    sm.check(bool(torch.equal(occ >= 0, ki >= 0)),
             "stacked two-level any-hit mode: occluded exactly where the "
             "closest walk hits")
    soup = scene_obj.build(dev)
    sub = torch.arange(0, o.shape[0], max(1, o.shape[0] // 4096),
                       device=dev)[:4096]
    from hrt_tpu_torch.ops import intersect

    bt, bi, _, _ = intersect.closest_hit_bruteforce(
        o[sub], d[sub], soup.tri_v0, soup.tri_e1, soup.tri_e2)
    a = soup_agreement(ktri[sub], ki[sub], kt[sub], bi, bt, soup.tri_inst)
    sm.check(a >= 0.999, f"stacked two-level trace vs brute force over the "
             f"soup on {sub.numel()} rays (hit, instance, modulo ties): "
             f"{a:.6f}")
    ms = time_ms(lambda: twolevel.trace_two_level(tl, o, d))
    pms = time_ms(lambda: twolevel.trace_two_level(tl, o, d, plain=True),
                  reps=3)
    print(f"  stacked two-level accel: build {build_s:.3f} s "
          f"({len(tl.blas)} LBVHs of {int(tl.nrm0.shape[1])} slots, leaf "
          f"8); trace of {o.shape[0]} "
          f"rays {ms:.4f} ms through K3 ({n_inst} launches), plain "
          f"{pms:.4f} ms (CUDA events, median of 7 / 3)", flush=True)
    out["two_level"] = {"agree": agree, "ms": ms, "plain_ms": pms,
                        "launches": k3_launches}
    return out


# The trainer's sizes (scripts/train_upscaler.py): steps of the spatial
# and temporal runs (its usage lines: 300 / 600) and of the recurrent
# fine-tune (its default, 60).
SPATIAL_STEPS = 300
TEMPORAL_STEPS = 600
RECURRENT_STEPS = 60
# The least held-out PSNR gain of the trained temporal net over bilinear.
PSNR_MARGIN_DB = 1.0


def window_ratio(losses: list) -> float:
    """The mean of the last 10 losses over that of the first 10 (crops
    are random: single losses are too noisy to compare)."""
    return statistics.mean(losses[-10:]) / statistics.mean(losses[:10])


def fixed_batch_losses(make, loss_fn, trained, batch) -> tuple:
    """The loss of the trained net and of the trainer's initial net
    (`make()` rebuilds it from the trainer's seed) on one fixed batch,
    in full float32: (initial, trained)."""
    import torch

    from hrt_tpu_torch.models import upscaler

    init, _ = make()
    with torch.no_grad(), upscaler.fp32_convs():
        return float(loss_fn(init, *batch)), float(loss_fn(trained, *batch))


def round_trip(sm: Smoke, label: str, net, path: str, temporal: bool,
               args) -> None:
    """The checkpoint the trainer wrote, through load_params and
    upscaler_from_numpy, gives the trained net's output bit for bit."""
    import torch

    from hrt_tpu_torch.models import upscaler
    from hrt_tpu_torch.utils.checkpoint import load_params
    from hrt_tpu_torch.utils.interop import (upscaler_from_numpy,
                                             upscaler_to_numpy)

    template = upscaler_to_numpy(upscaler.TemporalUpscalerNet() if temporal
                                 else upscaler.UpscalerNet())
    back = upscaler_from_numpy(load_params(path, template), temporal,
                               args[0].device)
    with torch.no_grad(), upscaler.fp32_convs():
        same = torch.equal(back(*args), net(*args))
    sm.check(same, f"{label}: save -> load_params -> upscaler_from_numpy "
             f"gives the trained net's output bit for bit ({path})")


def warp_backward_check(sm: Smoke, label: str, img, px, py, seed: int):
    """K6's backward (the adjoint's kernel, and through WarpBilinear)
    against autograd of the plain warp on an (Ho, Wo, C) grad_val drawn
    from `seed`.  The kernel's adds are float atomics in an order that
    changes from run to run, and an edge tap takes an add from every
    pixel clamped onto it (up to ~1.3M at 4K), so each element is held
    within 1e-5 of its terms' absolute sum (the plain adjoint of
    |grad_val|), as K6's forward is held to its taps' absolute weighted
    sum.  Returns (grad_val, max abs err, plain backward ms)."""
    import torch

    from hrt_tpu_torch.ops import warp_kernel as k6

    g = torch.Generator(device=img.device).manual_seed(seed)
    gv = torch.randn((*px.shape, img.shape[2]), generator=g,
                     device=img.device)
    hs, ws = img.shape[0], img.shape[1]
    kg = k6.warp_bilinear_backward_kernel(gv, px, py, hs, ws)
    src = img.detach().clone().requires_grad_(True)
    val = k6.warp_bilinear_plain(src, px, py)[0]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    (pg,) = torch.autograd.grad(val, src, gv, retain_graph=True)
    ev[1].record()
    (scale,) = torch.autograd.grad(val, src, gv.abs())
    before = k6.LAUNCHES["warp_bilinear_backward"]
    (fg,) = torch.autograd.grad(k6.warp_bilinear(src, px, py)[0], src, gv)
    torch.cuda.synchronize()
    err = float((kg - pg).abs().max())
    rel = float(((kg - pg).abs() / scale.clamp(min=1e-30)).max())
    frel = float(((fg - pg).abs() / scale.clamp(min=1e-30)).max())
    sm.check(rel <= 1e-5 and frel <= 1e-5 and bool(torch.isfinite(kg).all())
             and k6.LAUNCHES["warp_bilinear_backward"] == before + 1,
             f"{label}: K6 backward vs autograd of the plain warp: rel err "
             f"{rel:.3g} of each element's absolute sum (max abs {err:.3g}, "
             f"max |grad| {float(pg.abs().max()):.4g}, max sum "
             f"{float(scale.max()):.4g}); through WarpBilinear {frel:.3g}, "
             f"one backward launch")
    return gv, err, ev[0].elapsed_time(ev[1])


def train_phases(sm: Smoke, dev, hist4k) -> dict:
    """Phases 37-40, upscaler training (hrt_tpu_torch.train_upscaler) on
    the card.  `hist4k`: phase 20's (history, px, py) at 3840x2160, C=3.
    Returns the kernels line's entry of K6's backward."""
    import copy
    import tempfile

    import torch
    import torch.nn.functional as F

    from hrt_tpu_torch import train_upscaler as tu
    from hrt_tpu_torch.models import upscaler
    from hrt_tpu_torch.ops import denoise, warp_kernel as k6

    tmp = tempfile.TemporaryDirectory()
    spath = os.path.join(tmp.name, "upscaler_torch.npz")
    tpath = os.path.join(tmp.name, "upscaler_temporal_torch.npz")
    dflag = ["--device", str(dev)]

    phase(f"phase 37: train_upscaler, spatial: 4 frames at 256x256, "
          f"{SPATIAL_STEPS} steps of 8 64-px crops")
    reset_all()
    t0 = time.perf_counter()
    sp = tu.main(dflag + ["--steps", str(SPATIAL_STEPS), "--out", spath])
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"  trainer run {time.perf_counter() - t0:.1f} s, launches "
          f"{counts}", flush=True)
    sm.check(counts["k1_closest"] > 0 and counts["k1_any_hit"] > 0
             and counts["k2"] > 0 and counts["k6"] == 0
             and counts["k6_backward"] == 0 and counts["k3"] == 0,
             f"spatial run: K1 and K2 launched (the frames), no warp")
    r = window_ratio(sp["losses"])
    sm.check(r < 0.8 and all(map(math.isfinite, sp["losses"])),
             f"spatial: the mean of the last 10 losses over the first 10's "
             f"{r:.4f} < 0.8 ({len(sp['losses'])} steps)")

    phase(f"phase 38: train_upscaler --temporal: 2 x 16-frame orbits "
          f"(128x128 -> 256x256, 8-spp targets), {TEMPORAL_STEPS} steps, "
          f"{RECURRENT_STEPS} recurrent steps, held-out PSNR")
    reset_all()
    t0 = time.perf_counter()
    tr = tu.main(dflag + ["--temporal", "--steps", str(TEMPORAL_STEPS),
                          "--recurrent-steps", str(RECURRENT_STEPS),
                          "--out", tpath])
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"  trainer run {time.perf_counter() - t0:.1f} s, launches "
          f"{counts}", flush=True)
    seqs, ev = tr["seqs"], tr["held_out"]
    n_seq = seqs[0][0].shape[0]
    warps = RECURRENT_STEPS * len(seqs) * (n_seq - 1)
    want_fwd = len(seqs) * (n_seq - 1) + warps + ev[0].shape[0] - 1
    sm.check(counts["k6_backward"] == warps and counts["k6"] == want_fwd
             and counts["k1_closest"] > 0 and counts["k1_any_hit"] > 0
             and counts["k2"] > 0 and counts["k3"] == 0,
             f"temporal run: {counts['k6_backward']} K6 backward launches "
             f"(want {warps}: {RECURRENT_STEPS} steps x {len(seqs)} "
             f"sequences x {n_seq - 1} warped frames), {counts['k6']} K6 "
             f"forward (want {want_fwd}: triples, unrolls, held-out)")
    # The window ratio is noisy (a CPU rehearsal at these sizes read it
    # at 0.75-0.85 from 30 to 100 steps, as the 1-spp inputs' loss nears
    # its floor), so a fixed batch of 64 crops through the initial and
    # the trained net, free of crop noise, must show a 10% fall too.
    gen = torch.Generator().manual_seed(99)
    lr_t, hist_t, hr_t = (torch.cat(x) for x in zip(
        *(tu.temporal_triples(*s) for s in seqs)))
    fixed = tu.crops(gen, lr_t, hist_t, hr_t, batch=64)
    l0, l1 = fixed_batch_losses(
        lambda: upscaler.create_temporal(lr=2e-3, device=dev),
        upscaler._loss_fn_temporal, tr["net"], fixed)
    r = window_ratio(tr["losses"])
    sm.check(r < 0.8 and l1 < 0.9 * l0
             and all(map(math.isfinite, tr["losses"])),
             f"temporal: the mean of the last 10 losses over the first "
             f"10's {r:.4f} < 0.8 ({len(tr['losses'])} steps); on a fixed "
             f"batch of 64 crops the trained net's loss {l1:.5f} < 0.9 x "
             f"the initial net's {l0:.5f} (ratio {l1 / l0:.4f})")
    clean = torch.cat([s[4] for s in seqs])
    fixed_s = upscaler.self_supervised_batch(clean, gen, 64, 64)
    l0, l1 = fixed_batch_losses(lambda: upscaler.create(lr=2e-3, device=dev),
                               upscaler._loss_fn, sp["net"], fixed_s)
    sm.check(l1 < 0.9 * l0,
             f"spatial: on a fixed batch of 64 crops of phase 38's clean "
             f"frames the trained net's loss {l1:.5f} < 0.9 x the initial "
             f"net's {l0:.5f} (ratio {l1 / l0:.4f})")
    # The fine-tune starts with a transient (Adam's moments come from the
    # crop objective: a sequence's loss rises for a few steps, then
    # falls), so a step's loss against the first step's can still be
    # higher after 60 steps; the windows' means over both sequences fall.
    rec = tr["recurrent_losses"]
    per_seq = [rec[i::len(seqs)] for i in range(len(seqs))]
    r = window_ratio([sum(x) for x in zip(*per_seq)])
    sm.check(r < 1.0 and all(map(math.isfinite, rec)),
             f"recurrent fine-tune: the mean of the last 10 steps' losses "
             f"(both sequences) over the first 10's {r:.4f} < 1 (first -> "
             f"highest -> last step, per sequence: "
             + "; ".join(f"{s[0]:.5f} -> {max(s):.5f} -> {s[-1]:.5f}"
                         for s in per_seq) + ")")
    trained_s = sp["net"]
    p_new = tu.eval_temporal(tr["net"], trained_s, *ev)
    p_old = tu.eval_temporal(upscaler.load_weights("temporal", dev),
                             upscaler.load_weights("spatial", dev), *ev)
    p_run = tr["psnr"]
    spatial_from = ("a checkpoint" if os.path.exists(tu.SPATIAL_CKPT)
                    else "the committed weights")
    print(f"  held-out PSNR (temporal / spatial / bilinear, dB): the "
          f"trainer's report (trained temporal, spatial from "
          f"{spatial_from}) {p_run[0]:.4f} / {p_run[1]:.4f} / "
          f"{p_run[2]:.4f}; both "
          f"trained {p_new[0]:.4f} / {p_new[1]:.4f} / "
          f"{p_new[2]:.4f}; committed {p_old[0]:.4f} / {p_old[1]:.4f} / "
          f"{p_old[2]:.4f}", flush=True)
    sm.check(all(math.isfinite(p) for p in (*p_run, *p_new, *p_old)),
             "held-out PSNRs finite")
    # At the script's sizes the trained temporal net must beat bilinear
    # on the held-out frames (the committed weights: by 2.69 dB).
    sm.check(p_new[0] > p_new[2] + PSNR_MARGIN_DB,
             f"held-out: the trained temporal net {p_new[0]:.4f} dB beats "
             f"bilinear {p_new[2]:.4f} by {p_new[0] - p_new[2]:.4f} > "
             f"{PSNR_MARGIN_DB} dB")
    round_trip(sm, "spatial", trained_s, spath, False, (lr_t[:2],))
    round_trip(sm, "temporal", tr["net"], tpath, True,
               (lr_t[:2], hist_t[:2]))

    phase("phase 39: K6 backward vs its plain backward: the trainer's "
          "history (256x256, C=3, a bench orbit step's motion) and the 4K "
          "one of animated_4k's shape (3840x2160, C=3, phase 20's)")
    lrs, wps, hits, cams, cleans = seqs[0]
    prev = cams[0]
    px, py, _ = denoise._project(upscaler._upsample2_corner(wps[1]),
                                 prev.origin, prev.basis, prev.tan_half_fovy,
                                 prev.aspect, cleans.shape[2],
                                 cleans.shape[1])
    shapes = {"trainer 256x256 C=3": (cleans[0], px, py),
              "4K history 3840x2160 C=3 (animated_4k's)": hist4k}
    entry = None
    for i, (label, (img, px, py)) in enumerate(shapes.items()):
        gv, err, plain_once = warp_backward_check(sm, label, img, px, py,
                                                  seed=i)
        hi, wi, c = img.shape
        # grad_val and the coordinates read, grad_img written once (the
        # zero fill is this design's cost: it stays in `ms`, not here).
        n_bytes = nbytes(gv, px, py) + hi * wi * c * 4
        src = img.detach().clone().requires_grad_(True)
        val = k6.warp_bilinear_plain(src, px, py)[0]
        gsrc = img.permute(2, 0, 1)[None].contiguous().requires_grad_(True)
        grid = torch.stack([px / (wi - 1) * 2 - 1, py / (hi - 1) * 2 - 1],
                           -1)[None]
        gs = F.grid_sample(gsrc, grid, mode="bilinear",
                           padding_mode="border", align_corners=True)
        ggv = gv.permute(2, 0, 1)[None].contiguous()
        row = {
            "ms": time_ms(lambda: k6.warp_bilinear_backward_kernel(
                gv, px, py, hi, wi), calls=10),
            # The plain backward at 4K takes seconds (its index_put
            # serialises the ~1.3M adds of a clamped edge tap): the
            # check's one call is its time there.
            "plain_ms": plain_once if entry is not None else time_ms(
                lambda: torch.autograd.grad(val, src, gv, retain_graph=True),
                calls=10),
            "library_ms": time_ms(lambda: torch.autograd.grad(
                gs, gsrc, ggv, retain_graph=True), calls=10),
            "bound_ms": bound(n_bytes)[0]}
        print(f"  K6 backward {label}: kernel {row['ms']:.4f} ms (with the "
              f"zero fill), plain (autograd of the plain warp"
              f"{', one call' if entry is not None else ''}) "
              f"{row['plain_ms']:.4f} ms, grid_sample backward "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({n_bytes} bytes)", flush=True)
        if entry is None:
            entry = {"max_abs_err": err, "bound_by": "bytes", **row}
        del val, gs, src, gsrc

    phase("phase 40: one recurrent step on the card, K6 route vs the plain "
          "route, the history path's gradient; ms per step (CUDA events)")
    net = copy.deepcopy(tr["net"])
    seq = seqs[0]

    def grads(plain: bool):
        net.zero_grad(set_to_none=True)
        with upscaler.fp32_convs():
            loss = tu.recurrent_loss(net, *seq, plain=plain)
            loss.backward()
        return float(loss.detach()), [p.grad.clone()
                                      for p in net.parameters()]

    before = k6.LAUNCHES["warp_bilinear_backward"]
    loss_k, g_k = grads(False)
    bwd = k6.LAUNCHES["warp_bilinear_backward"] - before
    loss_p, g_p = grads(True)
    rel = max(float((a - b).abs().max() / b.abs().max())
              for a, b in zip(g_k, g_p))
    sm.check(abs(loss_k - loss_p) <= 1e-5 * abs(loss_p) and rel <= 1e-4
             and bwd == n_seq - 1,
             f"recurrent step ({n_seq} frames): loss {loss_k:.7f} through "
             f"K6 vs {loss_p:.7f} plain; gradients within {rel:.3g} of "
             f"each tensor's largest entry; {bwd} K6 backward launches")
    orig = upscaler.reproject_history
    upscaler.reproject_history = \
        lambda hist, *a, **k: orig(hist.detach(), *a, **k)
    try:
        loss_d, g_d = grads(False)
    finally:
        upscaler.reproject_history = orig
    hist_rel = max(float((a - b).abs().max() / a.abs().max())
                   for a, b in zip(g_k, g_d))
    sm.check(loss_d == loss_k and hist_rel > 1e-3,
             f"the history path carries gradient: with the warped history "
             f"detached the loss is the same and the gradient moves by "
             f"{hist_rel:.3g} of a tensor's largest entry")
    gen = torch.Generator().manual_seed(5)
    frames = torch.cat([cleans[:4], seqs[1][4][:4]])
    lr_b, hr_b = upscaler.self_supervised_batch(frames, gen, 64, 8)
    s_net, s_opt = upscaler.create(lr=2e-3, device=dev)
    tb = tu.crops(gen, lr_t, hist_t, hr_t)
    t_opt = upscaler.adam(net, 2e-3)
    step_ms = {
        "spatial step (8 x 64 px)": time_ms(
            lambda: upscaler.train_step(s_net, s_opt, lr_b, hr_b)),
        "temporal step (8 x 128 px)": time_ms(
            lambda: upscaler.train_step_temporal(net, t_opt, *tb)),
        f"recurrent update ({n_seq} frames)": time_ms(
            lambda: upscaler.update(t_opt, lambda: tu.recurrent_loss(
                net, *seq)), reps=5)}
    for k, v in step_ms.items():
        print(f"  {k}: {v:.4f} ms", flush=True)
    tmp.cleanup()
    return {"launches": counts["k6_backward"], **entry}


def gather_ms(group, tensors) -> float:
    """CUDA-event time of all-gathering `tensors` along rows over
    `group` (10 gathers per sample)."""
    from hrt_tpu_torch.parallel import tiles

    return time_ms(lambda: [tiles.gather_rows(t, group) for t in tensors],
                   calls=10)


def multi_gpu_phases(sm: Smoke, dev, scene, accel) -> dict:
    """Phases 41-42, multi-GPU rendering (hrt_tpu_torch.parallel) on the
    one card: a one-rank NCCL group, then four ranks stood in for by one
    process.  `scene` and `accel` are the bench scene's on the card.
    Returns the times."""
    import torch
    import torch.distributed as dist

    from hrt_tpu_torch import renderer
    from hrt_tpu_torch.config import CONFIGS, RenderConfig
    from hrt_tpu_torch.frameloop import FrameLoop
    from hrt_tpu_torch.models.camera import Camera, orbit_camera
    from hrt_tpu_torch.models.scene import bench_scene, instance_grid_scene
    from hrt_tpu_torch.ops import lbvh, traversal
    from hrt_tpu_torch.parallel import scene_shard, tiles

    times = {}
    phase("phase 41: a one-rank NCCL group: the tiled bench frame at "
          "512x384 and 1920x1080, FrameLoop(mesh) on the 1080p post "
          "config, the all-gather")
    mesh = tiles.make_mesh(1)
    group = mesh.get_group()
    sm.check(dist.get_backend() == "nccl" and mesh.size() == 1
             and tiles.mesh_device(mesh) == dev,
             f"group {dist.get_backend()}, mesh {mesh}")
    one_frame = {"k1_closest": 1, "k1_any_hit": 1, "k2": 1}
    for w, h in ((512, 384), PT_FULL):
        cfg = RenderConfig(width=w, height=h, max_depth=1, sky=True)
        cams = renderer.camera_arrays(Camera(**BENCH_CAM), cfg, dev)
        torch.cuda.synchronize()
        reset_all()
        img, gb = tiles.render_frame_tiled(scene, accel, cams, 0, cfg, mesh,
                                           want_gbuffer=True)
        torch.cuda.synchronize()
        counts = launch_counts()
        want_img, want_gb = renderer.render_rows(scene, accel, cams, 0, h,
                                                 cfg, want_gbuffer=True)
        sm.check(counts == {k: one_frame.get(k, 0) for k in counts},
                 f"{w}x{h} tiled frame: launches {counts}")
        sm.check(torch.equal(img, want_img)
                 and all(torch.equal(gb[k], want_gb[k]) for k in want_gb),
                 f"{w}x{h} tiled frame and its G-buffer bit-equal to "
                 "render_rows' whole frame")
        times[f"tiled_{w}x{h}_ms"], times[f"rows_{w}x{h}_ms"] = (
            time_ms(lambda: tiles.render_frame_tiled(
                scene, accel, cams, 0, cfg, mesh)),
            time_ms(lambda: renderer.render_rows(scene, accel, cams, 0, h,
                                                 cfg)))
    times["gather_frame_ms"] = gather_ms(group, [img])
    times["gather_gbuffer_ms"] = gather_ms(group, [img, *gb.values()])
    gb_bytes = nbytes(img, *gb.values())
    print(f"  all-gather of the 1080p frame ({nbytes(img)} bytes): "
          f"{times['gather_frame_ms']:.4f} ms; with its G-buffer "
          f"({gb_bytes} bytes, {1 + len(gb)} gathers): "
          f"{times['gather_gbuffer_ms']:.4f} ms", flush=True)

    post = RenderConfig(width=1920, height=1080, max_depth=1, sky=True,
                        denoise=True, upscale=2, upscale_mode="temporal")
    tloop = FrameLoop(bench_scene(), post, mesh=mesh)
    loop = FrameLoop(bench_scene(), post, device=dev)
    torch.cuda.synchronize()
    reset_all()
    outs = [tloop.step(post_cam(f)).clone() for f in range(3)]
    torch.cuda.synchronize()
    counts = launch_counts()
    per_step = {"k1_closest": 1, "k1_any_hit": 1, "k2": 1, "k6": 2}
    sm.check(counts == {k: 3 * per_step.get(k, 0) for k in counts},
             f"FrameLoop(mesh) 3 post steps: launches {counts}")
    errs = []
    for f, got in enumerate(outs):
        want = loop.step(post_cam(f))
        errs.append(float((got - want).abs().max()))
    sm.check(tuple(outs[-1].shape) == (2160, 3840, 3) and max(errs) <= 1e-5
             and all(bool(torch.isfinite(o).all()) for o in outs),
             f"FrameLoop(mesh) vs the loop without a mesh, 3 steps at "
             f"3840x2160: max abs {errs}")
    del outs
    (p1, p2), (t1, t2) = in_turns(lambda: loop.step(post_cam(3)),
                                  lambda: tloop.step(post_cam(3)))
    times["post_plain_ms"], times["post_tiled_ms"] = [p1, p2], [t1, t2]
    print(f"  post frame 1080p -> 4K in turns (plain loop, mesh loop, mesh "
          f"loop, plain loop): {p1:.4f} {t1:.4f} {t2:.4f} {p2:.4f} ms",
          flush=True)
    for k in (f"tiled_512x384_ms", "rows_512x384_ms", "tiled_1920x1080_ms",
              "rows_1920x1080_ms"):
        print(f"  {k}: {times[k]:.4f}", flush=True)
    del tloop, loop

    phase("phase 42: four ranks stood in for by one process: the 1080p "
          "path_tracing frame as 4 bands, instance_grid_scene()'s soup as "
          "4 shard LBVHs walked by K3")
    cfg = CONFIGS["path_tracing"]
    cams = renderer.camera_arrays(Camera(**BENCH_CAM), cfg, dev)
    torch.cuda.synchronize()
    reset_all()
    bands = torch.cat([tiles.render_band(scene, accel, cams, 1, cfg, r, 4)
                       for r in range(4)])
    torch.cuda.synchronize()
    counts = launch_counts()
    whole = renderer.render_rows(scene, accel, cams, 0, cfg.height, cfg,
                                 frame=1)
    differ = (bands != whole).any(-1)
    sm.check(all(counts[k] >= 4 for k in one_frame)
             and counts["k3"] == 0, f"4 path_tracing bands: launches "
             f"{counts}")
    sm.check(not bool(differ.any()),
             f"4 bands bit-equal to the whole frame ({int(differ.sum())} "
             "pixels differ, rows "
             f"{torch.nonzero(differ.any(-1)).flatten()[:8].tolist()})")
    del bands, whole
    # What one of 4 ranks would spend on its band, against the whole
    # frame on one card.
    (w1, w2), (b1, b2) = in_turns(
        lambda: renderer.render_rows(scene, accel, cams, 0, cfg.height, cfg,
                                     frame=1),
        lambda: tiles.render_band(scene, accel, cams, 1, cfg, 1, 4))
    times.update(pt_frame_ms=[w1, w2], pt_band_ms=[b1, b2])
    print(f"  path_tracing 1080p in turns (whole frame, one band of 4, one "
          f"band, whole frame): {w1:.4f} {b1:.4f} {b2:.4f} {w2:.4f} ms",
          flush=True)

    soup = instance_grid_scene().build(dev, pad=4 * 128)
    t0 = time.perf_counter()
    sharded, accs = scene_shard.build_sharded_accel(soup, 4, leaf_size=32)
    full = lbvh.build_bvh(soup, 32)
    torch.cuda.synchronize()
    print(f"  {soup.num_triangles} triangles, 4 shard LBVHs and the whole "
          f"one built in {time.perf_counter() - t0:.2f} s", flush=True)
    rcfg = RenderConfig(width=1920, height=1080)
    rcams = renderer.camera_arrays(
        orbit_camera(0.0, radius=4.0, height=-1.0), rcfg, dev)
    o, d = renderer.primary_rays(rcams, 1080, 0, rcfg)
    o3, d3 = torch.stack(list(o), -1), torch.stack(list(d), -1)
    t_per = sharded.tri_v0.shape[1]

    def four():
        return scene_shard.combine_hits(*(torch.stack(h) for h in zip(*[
            scene_shard.shard_closest_hit(a, o3, d3, s, t_per)
            for s, a in enumerate(accs)])))

    def one():
        return traversal.closest_hit_bvh_p(None, full, o, d, 1e-3, 1e32)

    torch.cuda.synchronize()
    reset_all()
    hits = four()
    torch.cuda.synchronize()
    counts = launch_counts()
    sm.check(counts == {k: 4 if k == "k3" else 0 for k in counts},
             f"4 shard walks: launches {counts}")
    ref = one()
    check_closest(sm, "4 shards combined vs the whole soup's LBVH (K3, "
                  "1920x1080 orbit rays)", hits, ref)
    agree = (hits[1] == ref[1]) & (hits[1] >= 0)
    rel = float(((hits[0] - ref[0]).abs()
                 / ref[0].abs().clamp(min=1e-6))[agree].max())
    sm.check(rel <= 1e-5, f"combined t rel err {rel:.3g} where ids agree")
    (w1, w2), (f1, f2) = in_turns(one, four)
    shard_ms = [time_ms(lambda: scene_shard.shard_closest_hit(
        a, o3, d3, s, t_per)) for s, a in enumerate(accs)]
    times.update(one_walk_ms=[w1, w2], four_walks_ms=[f1, f2],
                 shard_ms=shard_ms)
    print(f"  in turns (one walk, 4 shards + combine, 4 shards + combine, "
          f"one walk): {w1:.4f} {f1:.4f} {f2:.4f} {w2:.4f} ms; each shard "
          f"alone {[round(x, 4) for x in shard_ms]} ms", flush=True)
    dist.destroy_process_group()
    return times


def gloo_worker(rank: int, out_dir: str) -> None:
    """Phase 43's rank `rank` of two on cuda:0 over gloo: the tiled
    frame, the sharded hits and a data-parallel upscaler step, each
    against the one-process result; writes rank<r>.json."""
    import torch
    import torch.distributed as dist

    from hrt_tpu_torch import renderer
    from hrt_tpu_torch.config import RenderConfig
    from hrt_tpu_torch.models import upscaler
    from hrt_tpu_torch.models.camera import Camera
    from hrt_tpu_torch.models.scene import bench_scene
    from hrt_tpu_torch.ops import lbvh, traversal
    from hrt_tpu_torch.parallel import scene_shard, tiles

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store",
                            rank=rank, world_size=2)
    mesh = tiles.make_mesh(2)
    dev = tiles.mesh_device(mesh)
    res = {"device": str(dev), "backend": dist.get_backend()}
    scene = tiles.replicate(bench_scene().build(dev), mesh)
    accel = tiles.replicate(lbvh.build_bvh_sah(scene, leaf_size=32), mesh)
    cfg = RenderConfig(width=512, height=384, max_depth=1, sky=True)
    cams = renderer.camera_arrays(Camera(**BENCH_CAM), cfg, dev)
    torch.cuda.synchronize()
    reset_all()
    img = tiles.render_frame_tiled(scene, accel, cams, 0, cfg, mesh)
    torch.cuda.synchronize()
    res["launches"] = launch_counts()
    res["frame_equal"] = torch.equal(img, renderer.render_rows(
        scene, accel, cams, 0, 384, cfg))
    res["gather_ms"] = host_ms(lambda: tiles.gather_rows(
        img[:192] if rank == 0 else img[192:], mesh.get_group()))

    soup = bench_scene().build(dev, pad=2 * 128)
    sharded, accs = scene_shard.build_sharded_accel(soup, 2, leaf_size=8)
    o, d = renderer.primary_rays(cams, 384, 0, cfg)
    o3, d3 = torch.stack(list(o), -1), torch.stack(list(d), -1)
    reset_all()
    hits = scene_shard.closest_hit_sharded(sharded, accs, o3, d3, mesh,
                                           leaf_size=8)
    torch.cuda.synchronize()
    res["shard_launches"] = launch_counts()["k3"]
    local = scene_shard.combine_hits(*(torch.stack(h) for h in zip(*[
        scene_shard.shard_closest_hit(a, o3, d3, s, sharded.tri_v0.shape[1])
        for s, a in enumerate(accs)])))
    res["hits_equal"] = all(torch.equal(a, b) for a, b in zip(hits, local))
    whole = traversal.closest_hit_bvh_p(None, lbvh.build_bvh(soup, 8), o, d,
                                        1e-3, 1e32)
    res["ids_agree"] = float((hits[1] == whole[1]).float().mean())
    res["hit_share"] = float((hits[1] >= 0).float().mean())

    net, opt = upscaler.create(device=dev)
    ref, ref_opt = upscaler.create(device=dev)
    g = torch.Generator().manual_seed(11)
    lr = torch.rand((4, 32, 32, 3), generator=g).to(dev)
    hr = torch.rand((4, 64, 64, 3), generator=g).to(dev)
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
    losses, grads = [], []
    for _ in range(2):
        loss = upscaler.train_step(net, opt, lr, hr, group=mesh.get_group())
        losses.append(rel(loss, upscaler.train_step(ref, ref_opt, lr, hr)))
        # The averaged gradient the step took, against the whole batch's.
        grads.append(max(rel(p.grad, q.grad) for p, q in zip(
            net.parameters(), ref.parameters())))
    res["loss_rel"], res["grad_rel"] = max(losses), max(grads)
    res["param_rel"] = max(rel(p, q) for p, q in zip(net.parameters(),
                                                     ref.parameters()))
    dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def gloo_phase(sm: Smoke) -> None:
    """Phase 43: two ranks on the one card over gloo, spawned."""
    import tempfile

    phase("phase 43: two ranks on cuda:0 over gloo (spawned processes): "
          "the tiled frame, the sharded hits, a data-parallel upscaler "
          "step")
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, LOCAL_RANK="0", PYTHONPATH=os.pathsep.join(
            [ROOT, os.environ.get("PYTHONPATH", "")]))
        code = ("import sys, chip_smoke; "
                "chip_smoke.gloo_worker(int(sys.argv[1]), sys.argv[2])")
        procs = [subprocess.Popen(
            [sys.executable, "-c", code, str(r), tmp], cwd=ROOT,
            env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(2)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=300)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        ok = all(p.returncode == 0 for p in procs)
        sm.check(ok, f"both ranks exit 0 ({[p.returncode for p in procs]})")
        if not ok:
            for r, out in enumerate(outs):
                print(f"  rank {r} output:\n{out[-3000:]}", flush=True)
            return
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                res = json.load(f)
            launches = res["launches"]
            sm.check(res["backend"] == "gloo" and res["device"] == "cuda:0"
                     and launches["k1_closest"] == 1
                     and launches["k1_any_hit"] == 1 and launches["k2"] == 1
                     and res["frame_equal"],
                     f"rank {r} ({res['backend']} on {res['device']}): the "
                     f"tiled 512x384 frame bit-equal to render_rows', "
                     f"launches {launches}")
            sm.check(res["shard_launches"] == 1 and res["hits_equal"]
                     and res["ids_agree"] >= 0.999
                     and res["hit_share"] > 0.3,
                     f"rank {r}: sharded hits equal to the local combine "
                     f"(1 K3 launch), ids agree with the whole LBVH on "
                     f"{res['ids_agree']:.6f} ({res['hit_share']:.3f} hit)")
            # Adam's first steps move each parameter by about lr times
            # the sign of its gradient, so where a gradient is near 0 the
            # last bits of the two sums (cuDNN picks its algorithm by
            # batch size) can move a parameter by up to 2 lr: the
            # parameters are held to 1e-4 of their largest, the loss
            # and the gradients to 1e-6 and 1e-5.
            sm.check(res["loss_rel"] <= 1e-6 and res["grad_rel"] <= 1e-5
                     and res["param_rel"] <= 1e-4,
                     f"rank {r}: data-parallel step vs the one-process step "
                     f"on 4 crops, 2 steps: loss rel {res['loss_rel']:.3g}, "
                     f"gradients rel {res['grad_rel']:.3g} (of each "
                     f"tensor's largest), parameters rel "
                     f"{res['param_rel']:.3g}")
            print(f"  rank {r}: gloo all-gather of a 192-row band of CUDA "
                  f"tensors (host clock): {res['gather_ms']:.4f} ms",
                  flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    from hrt_tpu_torch import renderer
    from hrt_tpu_torch.config import RenderConfig
    from hrt_tpu_torch.kernels import build
    from hrt_tpu_torch.models.camera import Camera
    from hrt_tpu_torch.ops import intersect, lbvh, shade_kernel, wide8
    from hrt_tpu_torch.ops import traversal_wide8 as k1

    sm = Smoke()
    dev = torch.device("cuda", 0)

    phase("phase 1: device")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"  torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {name} count {torch.cuda.device_count()}", flush=True)

    phase("phase 2: kernel build")
    t0 = time.perf_counter()
    path = build.build()
    build.load()
    print(f"  built {os.path.basename(path)} in "
          f"{time.perf_counter() - t0:.1f} s",
          flush=True)
    with open(path[:-3] + ".log") as f:
        for line in f:
            if "entry function" in line:  # the mangled name, cut short
                print("  ptxas:", line.split("'")[1][:72])
            elif "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())
    t0 = time.perf_counter()
    baseline = load_baseline()
    copies = [f for f in BASELINE_KERNELS
              if os.path.exists(os.path.join(BASELINE_DIR, f))]
    print(f"  baseline kernels: {', '.join(copies) or 'none'} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    bench = bench_phases(sm, dev, baseline)
    times, launches, errs = bench["times"], bench["launches"], bench["errs"]

    phase("phase 10: instanced scene + two-level build")
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

    phase(f"phase 11: K4 on the instanced frame's batches ({gn} primary "
          "rays)")
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
    # 4093 of those rays (a partial last warp) through K4 and through K5
    # on the grid's binary tables, against their plain walks and brute
    # force over the soup.
    from hrt_tpu_torch.ops import traversal_tlas_skip as k5

    tl5g = tlas.build_two_level_flat(grid, 32, device=dev, max_wide_nodes=32)
    pp = [q[gsub[:4093]] for q in g_prim]
    ps = [q[gssub[:4093]] for q in g_shadow]
    for kname, walk, table in (("K4", k4, tl), ("K5", k5, tl5g)):
        kc = walk.trace_kernel(table, *pp, g_cfg.t_min, True)
        check_closest(sm, f"{kname} vs plain on 4093 primary rays", kc,
                      walk.trace_plain(table, *pp, g_cfg.t_min, True))
        a = soup_agreement(kc[1], kc[2], kc[0], bi4[:4093], bt4[:4093],
                           g_scene.tri_inst)
        sm.check(a >= 0.999, f"{kname} closest vs soup brute force on 4093 "
                 f"rays (hit, instance, modulo ties): {a:.6f}")
        ka = walk.trace_kernel(table, *ps, g_cfg.t_min, False)
        check_occlusion(sm, f"{kname} vs plain on 4093 shadow rays", ka,
                        walk.trace_plain(table, *ps, g_cfg.t_min, False))
        a = float((ka == bocc4[:4093]).float().mean())
        sm.check(a >= 0.999, f"{kname} any-hit vs soup brute force on 4093 "
                 f"rays: {a:.6f}")
    del bt4, bi4, bocc4, tl5g

    phase("phase 12: animated FrameLoop(two_level=True), 32 steps at "
          "512x384")
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

    phase("phase 13: one 1920x1080 two-level frame")
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

    phase("phase 14: instanced times (CUDA events, median of 7)")
    times.update({
        "k4_closest": time_ms(lambda: k4.trace_kernel(
            tl, *g_prim, g_cfg.t_min, True), calls=10),
        "k4_any_hit": time_ms(lambda: k4.trace_kernel(
            tl, *g_shadow, g_cfg.t_min, False), calls=10),
        "k4_closest_one_call": time_ms(lambda: k4.trace_kernel(
            tl, *g_prim, g_cfg.t_min, True)),
        "k4_any_hit_one_call": time_ms(lambda: k4.trace_kernel(
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
    for key in ("k4_closest", "k4_closest_one_call", "k4_closest_plain",
                "k4_any_hit", "k4_any_hit_one_call", "k4_any_hit_plain"):
        print(f"  {key}: {times[key]:.4f} ms", flush=True)
    print(f"  refit (set_instance_transform, host clock): {refit_ms:.4f} ms",
          flush=True)
    rows = tl.w8_tlas_nw // 16
    rec_full = time_ms(lambda: wide8.node_records(tl.w8_nodes))
    rec_tlas = time_ms(lambda: wide8.node_records(tl.w8_nodes[:rows]))
    print(f"  K4 node records (wide8.node_records): whole table "
          f"{rec_full:.4f} ms at the build, TLAS region {rec_tlas:.4f} ms at "
          f"each refit", flush=True)
    k4_ops = {
        "k4_closest": walk_ops(k4, tl, g_prim, g_cfg.t_min, True,
                                    "K4 closest"),
        "k4_any_hit": walk_ops(k4, tl, g_shadow, g_cfg.t_min, False,
                                    "K4 any-hit")}
    if has_baseline(baseline, "hrt_tlas8_trace"):
        for key, planes, closest in (("closest", g_prim, True),
                                     ("any-hit", g_shadow, False)):
            time_walk_vs_baseline(sm, baseline, f"K4 {key}", k4.trace_kernel,
                                  tl, planes, g_cfg.t_min, closest)
        loop.set_resolution(512, 384)
        frame_vs_baseline(two_level_swaps(baseline, k4),
                          lambda: [loop.step(cam) for _ in range(4)],
                          "instanced still frame 512x384, 4 frames")
    else:
        print("  K4 baseline: none", flush=True)
    for size, v in frame4.items():
        print(f"  instanced frame {size}: {v['ms_per_frame']:.4f} ms/frame, "
              f"{v['mrays_per_s']:.2f} Mray/s; with a refit per frame "
              f"{v['animated_ms_per_frame']:.4f} ms/frame, "
              f"{v['animated_mrays_per_s']:.2f} Mray/s", flush=True)

    phase("phase 15: culled FrameLoop over the grid soup, 32 steps at "
          "512x384 along the orbit")
    from hrt_tpu_torch.models.camera import orbit_camera
    from hrt_tpu_torch.ops import culling
    from hrt_tpu_torch.ops import traversal_skip as k3
    from hrt_tpu_torch.ops import traversal_tlas_skip as k5

    def orbit_cam(f: int):
        return orbit_camera(f * 0.15, radius=4.0, height=-1.0)

    t0 = time.perf_counter()
    cloop = FrameLoop(instance_grid_scene(), g_cfg, device=dev)
    torch.cuda.synchronize()
    print(f"  loop init (soup, SAH build on the host) "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    sm.check(cloop.cull_threshold_px == 1.0 and cloop.accel.w8 is not None,
             "default cull_threshold_px 1.0, loop starts on the SAH accel")
    reset(k1.LAUNCHES, k3.LAUNCHES, shade_kernel.LAUNCHES)
    first_rebuild_before_trace = None
    steps = 32
    for f in range(steps):
        img_c = cloop.step(orbit_cam(f))
        if f == 0:
            first_rebuild_before_trace = (cloop.rebuilds == 1
                                          and k1.LAUNCHES["closest"] == 0)
        print(f"  frame {f}: {int(cloop.visible.sum())} of "
              f"{cloop.visible.numel()} instances visible, "
              f"{cloop.rebuilds} rebuilds", flush=True)
    torch.cuda.synchronize()
    launches3 = {"k3_closest": k3.LAUNCHES["closest"],
                 "k3_any_hit": k3.LAUNCHES["any_hit"],
                 "brdf_light_major": shade_kernel.LAUNCHES["brdf_light_major"],
                 "k1": k1.LAUNCHES["closest"] + k1.LAUNCHES["any_hit"]}
    sm.check(launches3 == {"k3_closest": steps, "k3_any_hit": steps,
                           "brdf_light_major": steps, "k1": 0},
             f"launch counters {launches3}")
    sm.check(cloop.rebuilds >= 2 and bool(first_rebuild_before_trace),
             f"{cloop.rebuilds} LBVH rebuilds, the first before frame 0's "
             "trace")
    sm.check(tuple(img_c.shape) == (384, 512, 3)
             and bool(torch.isfinite(img_c).all()),
             f"frame {tuple(img_c.shape)} finite")
    cscene = cloop.scene
    cmask = culling.triangle_mask(cloop.visible, cscene.tri_inst,
                                  cscene.tri_valid)
    t0 = time.perf_counter()
    card_tree = lbvh.lbvh_tree(cscene, 32, cmask)
    card_nodes, _ = lbvh.flatten_tree(card_tree, 32)
    torch.cuda.synchronize()
    print(f"  LBVH rebuild on the card (host clock): "
          f"{(time.perf_counter() - t0) * 1e3:.2f} ms", flush=True)
    cpu_tree = lbvh.lbvh_tree(instance_grid_scene().build("cpu"), 32,
                              cmask.cpu())
    cpu_nodes, _ = lbvh.flatten_tree(cpu_tree, 32)
    bits = lambda a: (a.cpu().view(torch.int32)
                      if a.dtype == torch.float32 else a.cpu())
    same_bits = all(torch.equal(bits(card_tree[key]), bits(cpu_tree[key]))
                    for key in cpu_tree)
    same_bits &= torch.equal(bits(card_nodes), bits(cpu_nodes))
    same_bits &= torch.equal(bits(cloop.accel.nodes), bits(cpu_nodes))
    sm.check(same_bits, "LBVH built on the card bit-equal to the CPU build "
             "(codes, tri_perm, children, boxes, skip-link nodes)")

    c_cams = renderer.camera_arrays(orbit_cam(steps - 1), g_cfg, dev)
    c_prim, c_shadow, _ = frame_batches(cscene, cloop.accel, c_cams, g_cfg)
    caccel = cloop.accel
    kc3 = k3.trace_kernel(caccel, *c_prim, g_cfg.t_min, True)
    pc3 = k3.trace_plain(caccel, *c_prim, g_cfg.t_min, True)
    k3c_err = check_closest(sm, "K3 vs plain", kc3, pc3)
    ka3 = k3.trace_kernel(caccel, *c_shadow, g_cfg.t_min, False)
    pa3 = k3.trace_plain(caccel, *c_shadow, g_cfg.t_min, False)
    k3a_err = check_occlusion(sm, "K3 vs plain", ka3, pa3)
    sel = torch.nonzero(cmask).squeeze(1)
    cn = c_prim[0].shape[0]
    csub = torch.arange(0, cn, max(1, cn // 4096), device=dev)[:4096]
    bt3, bi3, _, _ = intersect.closest_hit_bruteforce(
        torch.stack(c_prim[0:3], 1)[csub], torch.stack(c_prim[3:6], 1)[csub],
        cscene.tri_v0[sel], cscene.tri_e1[sel], cscene.tri_e2[sel],
        g_cfg.t_min)
    for who, (tt, ids) in (("kernel", kc3[:2]), ("plain", pc3[:2])):
        ids = ids[csub]
        inst = torch.where(ids >= 0, cscene.tri_inst[
            caccel.tri_perm[ids.clamp(min=0).long()].long()], -1)
        a = soup_agreement(ids, inst, tt[csub], bi3, bt3,
                           cscene.tri_inst[sel])
        sm.check(a >= 0.999, f"closest {who} vs brute force over the "
                 f"masked soup on 4096 rays: {a:.6f}")
    cns = c_shadow[0].shape[0]
    cssub = torch.arange(0, cns, max(1, cns // 4096), device=dev)[:4096]
    bocc3 = intersect.any_hit_bruteforce(
        torch.stack(c_shadow[0:3], 1)[cssub],
        torch.stack(c_shadow[3:6], 1)[cssub], cscene.tri_v0[sel],
        cscene.tri_e1[sel], cscene.tri_e2[sel], g_cfg.t_min,
        c_shadow[6][cssub])
    for who, occ in (("kernel", ka3), ("plain", pa3)):
        a = float((occ[cssub] == bocc3).float().mean())
        sm.check(a >= 0.999, f"any-hit {who} vs brute force over the "
                 f"masked soup on 4096 rays: {a:.6f}")
    ref_c = renderer.render_frames(cscene, caccel, c_cams, 0, 1, g_cfg,
                                   plain=True)[0]
    pc = psnr4(img_c, ref_c)
    sm.check(pc > 45.0, f"last frame vs plain frame PSNR {pc:.2f}")
    sah_c = lbvh.build_bvh_sah(cscene, 32, tri_mask=cmask)
    k1_c = renderer.render_frames(cscene, sah_c, c_cams, 0, 1, g_cfg)[0]
    pk1 = psnr4(img_c, k1_c)
    sm.check(sah_c.w8 is not None and pk1 > 45.0,
             f"last frame vs K1 frame of the SAH build over the same mask "
             f"PSNR {pk1:.2f}")
    del ref_c, k1_c, bt3, bi3, bocc3

    phase("phase 16: one culled 1920x1080 frame")
    cloop.set_resolution(1920, 1080)
    chd_cfg = cloop.config
    before = (dict(k3.LAUNCHES), dict(shade_kernel.LAUNCHES))
    img_chd = cloop.step(orbit_cam(steps - 1))
    torch.cuda.synchronize()
    sm.check(k3.LAUNCHES == {m: c + 1 for m, c in before[0].items()}
             and shade_kernel.LAUNCHES["brdf_light_major"]
             == before[1]["brdf_light_major"] + 1,
             f"1080p frame launched K3 closest, K3 any-hit and K2 once "
             f"({int(cloop.visible.sum())} instances visible, "
             f"{cloop.rebuilds} rebuilds)")
    sm.check(tuple(img_chd.shape) == (1080, 1920, 3)
             and bool(torch.isfinite(img_chd).all()), "1080p frame finite")
    chd_cams = renderer.camera_arrays(orbit_cam(steps - 1),
                                        chd_cfg, dev)
    ref_chd = renderer.render_frames(cscene, cloop.accel, chd_cams, 0, 1,
                                     chd_cfg, plain=True)[0]
    pchd = psnr4(img_chd, ref_chd)
    sm.check(pchd > 45.0, f"1080p frame vs plain frame PSNR {pchd:.2f}")
    del ref_chd
    hd_mask = culling.triangle_mask(cloop.visible, cscene.tri_inst,
                                    cscene.tri_valid)
    k1_chd = renderer.render_frames(
        cscene, lbvh.build_bvh_sah(cscene, 32, tri_mask=hd_mask), chd_cams,
        0, 1, chd_cfg)[0]
    pchd1 = psnr4(img_chd, k1_chd)
    sm.check(pchd1 > 45.0, f"1080p frame vs K1 frame of the SAH build over "
             f"the same mask PSNR {pchd1:.2f}")
    del k1_chd

    phase("phase 17: the instance forest (instance_grid_scene(182)), "
          "two-level at 512x384")
    forest = instance_grid_scene(182)
    t0 = time.perf_counter()
    ftl = tlas.build_two_level_flat(forest, 32, device=dev)
    torch.cuda.synchronize()
    f_facts = {"build_s": time.perf_counter() - t0,
               "instances": len(forest.instances), "tlas_m": ftl.tlas_m,
               "node_rows": int(ftl.nodes.shape[0]),
               "pool_slots": int(ftl.tris.shape[0]),
               "w8_nodes_is_none": ftl.w8_nodes is None}
    print(f"  {f_facts}", flush=True)
    sm.check(ftl.w8_nodes is None and f_facts["instances"] == 33125,
             "33125 instances on the binary route (no BVH8 table)")
    t0 = time.perf_counter()
    ftl4 = tlas.build_two_level_flat(forest, 32, device=dev,
                                     max_wide_nodes=1 << 23)
    torch.cuda.synchronize()
    print(f"  raised-bound BVH8 build {time.perf_counter() - t0:.2f} s: "
          f"{ftl4.w8_nodes.shape[0]} record rows, TLAS depth "
          f"{ftl4.tlas_depth}, BLAS depth {ftl4.blas_depth}, stack "
          f"{ftl4.stack}", flush=True)
    t0 = time.perf_counter()
    floop = FrameLoop(forest, g_cfg, two_level=True, device=dev)
    torch.cuda.synchronize()
    print(f"  FrameLoop init (soup, two-level build, instance matrices) "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    fscene = floop.scene
    f_prim, f_shadow, _ = frame_batches(fscene, ftl, g_cams, g_cfg)
    kc5 = k5.trace_kernel(ftl, *f_prim, g_cfg.t_min, True)
    pc5 = k5.trace_plain(ftl, *f_prim, g_cfg.t_min, True)
    k5c_err = check_closest(sm, "K5 vs plain (whole batch)", kc5, pc5)
    ka5 = k5.trace_kernel(ftl, *f_shadow, g_cfg.t_min, False)
    pa5 = k5.trace_plain(ftl, *f_shadow, g_cfg.t_min, False)
    k5a_err = check_occlusion(sm, "K5 vs plain (whole batch)", ka5, pa5)
    check_closest(sm, "K5 vs K4 on the raised-bound table", kc5,
                  k4.trace_kernel(ftl4, *f_prim, g_cfg.t_min, True))
    check_occlusion(sm, "K5 vs K4 on the raised-bound table", ka5,
                    k4.trace_kernel(ftl4, *f_shadow, g_cfg.t_min, False))
    fhome = [inst.position for inst in floop.scene_obj.instances]

    def fmove(f: int) -> float:
        """Lift and turn another sphere; returns the refit's host ms."""
        idx = 1 + (977 * f) % (len(fhome) - 1)
        x, y, z = fhome[idx]
        t0 = time.perf_counter()
        floop.set_instance_transform(idx, position=(x, y - 0.4, z),
                                     rotation=(0.1 * f, 0.2 * f, 0.0))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    reset(k4.LAUNCHES, k5.LAUNCHES, shade_kernel.LAUNCHES)
    refit_f = []
    f_steps = 8
    for f in range(f_steps):
        refit_f.append(fmove(f))
        img_f = floop.step(cam)
    torch.cuda.synchronize()
    print(f"  binary TLAS rebuild per set_instance_transform (host clock, "
          f"ms): {', '.join(f'{x:.2f}' for x in refit_f)}", flush=True)
    launches5 = {"k5_closest": k5.LAUNCHES["closest"],
                 "k5_any_hit": k5.LAUNCHES["any_hit"],
                 "brdf_light_major": shade_kernel.LAUNCHES["brdf_light_major"],
                 "k4": k4.LAUNCHES["closest"] + k4.LAUNCHES["any_hit"]}
    sm.check(launches5 == {"k5_closest": f_steps, "k5_any_hit": f_steps,
                           "brdf_light_major": f_steps, "k4": 0},
             f"launch counters {launches5}")
    sm.check(floop.accel.w8_nodes is None and tuple(img_f.shape)
             == (384, 512, 3) and bool(torch.isfinite(img_f).all()),
             f"frame {tuple(img_f.shape)} finite, still on the binary route")
    ftl4 = tlas.refit_two_level(ftl4, *floop._mats)
    k4_f = renderer.render_frames(fscene, ftl4, g_cams, 0, 1, g_cfg)[0]
    pf4 = psnr4(img_f, k4_f)
    sm.check(pf4 > 45.0, f"last frame vs K4 frame of the raised-bound table "
             f"PSNR {pf4:.2f}")
    ref_f = renderer.render_frames(fscene, floop.accel, g_cams, 0, 1, g_cfg,
                                   plain=True)[0]
    pfp = psnr4(img_f, ref_f)
    sm.check(pfp > 45.0, f"last frame vs plain frame (512x384) PSNR "
             f"{pfp:.2f}")
    del k4_f, ref_f

    phase("phase 18: one 1920x1080 forest frame")
    floop.set_resolution(1920, 1080)
    before = (dict(k5.LAUNCHES), dict(shade_kernel.LAUNCHES))
    img_fhd = floop.step(cam)
    torch.cuda.synchronize()
    sm.check(k5.LAUNCHES == {m: c + 1 for m, c in before[0].items()}
             and shade_kernel.LAUNCHES["brdf_light_major"]
             == before[1]["brdf_light_major"] + 1,
             "1080p frame launched K5 closest, K5 any-hit and K2 once")
    sm.check(tuple(img_fhd.shape) == (1080, 1920, 3)
             and bool(torch.isfinite(img_fhd).all()), "1080p frame finite")
    k4_fhd = renderer.render_frames(fscene, ftl4, hd_cams, 0, 1,
                                    floop.config)[0]
    pfhd = psnr4(img_fhd, k4_fhd)
    sm.check(pfhd > 45.0, f"1080p frame vs K4 frame PSNR {pfhd:.2f}")
    del k4_fhd

    phase("phase 19: K3 / K5 times (CUDA events, median of 7; 3 for the "
          "plain walks), LBVH rebuild, culled and forest frames")
    times.update({
        "k3_closest": time_ms(lambda: k3.trace_kernel(
            caccel, *c_prim, g_cfg.t_min, True)),
        "k3_any_hit": time_ms(lambda: k3.trace_kernel(
            caccel, *c_shadow, g_cfg.t_min, False)),
        "k3_closest_plain": time_ms(lambda: k3.trace_plain(
            caccel, *c_prim, g_cfg.t_min, True), reps=3),
        "k3_any_hit_plain": time_ms(lambda: k3.trace_plain(
            caccel, *c_shadow, g_cfg.t_min, False), reps=3),
        "k5_closest": time_ms(lambda: k5.trace_kernel(
            ftl, *f_prim, g_cfg.t_min, True), calls=10),
        "k5_any_hit": time_ms(lambda: k5.trace_kernel(
            ftl, *f_shadow, g_cfg.t_min, False), calls=10),
        "k5_closest_one_call": time_ms(lambda: k5.trace_kernel(
            ftl, *f_prim, g_cfg.t_min, True)),
        "k5_any_hit_one_call": time_ms(lambda: k5.trace_kernel(
            ftl, *f_shadow, g_cfg.t_min, False)),
        "k5_closest_plain": time_ms(lambda: k5.trace_plain(
            ftl, *f_prim, g_cfg.t_min, True), reps=3),
        "k5_any_hit_plain": time_ms(lambda: k5.trace_plain(
            ftl, *f_shadow, g_cfg.t_min, False), reps=3),
        "k4_forest_closest": time_ms(lambda: k4.trace_kernel(
            ftl4, *f_prim, g_cfg.t_min, True), calls=10),
        "k4_forest_any_hit": time_ms(lambda: k4.trace_kernel(
            ftl4, *f_shadow, g_cfg.t_min, False), calls=10),
    })
    lbvh_ms = host_ms(lambda: lbvh.build_bvh(cscene, 32, tri_mask=cmask))
    for key in ("k3_closest", "k3_closest_plain", "k3_any_hit",
                "k3_any_hit_plain", "k5_closest", "k5_closest_one_call",
                "k5_closest_plain", "k5_any_hit", "k5_any_hit_one_call",
                "k5_any_hit_plain", "k4_forest_closest",
                "k4_forest_any_hit"):
        print(f"  {key}: {times[key]:.4f} ms", flush=True)
    tl_rows = int(ftl.blas_base.min()) // 128
    rec_full = time_ms(lambda: k3.skip_records(ftl.nodes,
                                               ftl.nodes.shape[0] * 128))
    rec_tlas = time_ms(lambda: k3.skip_records(ftl.nodes[:tl_rows],
                                               tl_rows * 128))
    print(f"  K5 node records (traversal_skip.skip_records): whole table "
          f"{rec_full:.4f} ms at the build, TLAS rows {rec_tlas:.4f} ms at "
          f"each refit", flush=True)
    k5_ops = {
        "k5_closest": walk_ops(k5, ftl, f_prim, g_cfg.t_min, True,
                                    "K5 closest"),
        "k5_any_hit": walk_ops(k5, ftl, f_shadow, g_cfg.t_min, False,
                                    "K5 any-hit")}
    if has_baseline(baseline, "hrt_tlas_skip_trace"):
        for key, planes, closest in (("closest", f_prim, True),
                                     ("any-hit", f_shadow, False)):
            time_walk_vs_baseline(sm, baseline, f"K5 {key}", k5.trace_kernel,
                                  ftl, planes, g_cfg.t_min, closest)
    else:
        print("  K5 baseline: none", flush=True)
    print(f"  LBVH rebuild of the culled grid (host clock, median of 7): "
          f"{lbvh_ms:.4f} ms", flush=True)
    rec_ms = time_ms(lambda: k3.skip_records(caccel.nodes, caccel.m_real))
    print(f"  K3 node records from the table (skip_records, at each "
          f"rebuild): {rec_ms:.4f} ms", flush=True)
    k3_ops = {}
    for key, planes, closest in (("k3_closest", c_prim, True),
                                 ("k3_any_hit", c_shadow, False)):
        cnt = k3.visit_counts(caccel, *planes, g_cfg.t_min, closest)
        live = int((planes[6] >= 0).sum())
        tot = {c: int(v.sum()) for c, v in cnt.items()}
        k3_ops[key] = (tot["nodes"] * K3_OPS_PER_NODE
                       + tot["tests"] * K3_OPS_PER_TEST)
        # A warp steps through the union of its rays' leaves: at least
        # as many steps as its busiest ray.
        lw = cnt["leaves"][:cnt["leaves"].numel() // 32 * 32].view(-1, 32)
        lw = lw[cnt["nodes"][:lw.numel()].view(-1, 32).amax(1) > 0]
        print(f"  K3 {key[3:]} visits per live ray ({live} of "
              f"{planes[0].numel()} live): nodes "
              f"{tot['nodes'] / max(live, 1):.1f} (max "
              f"{int(cnt['nodes'].max())}), leaves "
              f"{tot['leaves'] / max(live, 1):.1f} (max "
              f"{int(cnt['leaves'].max())}), triangle tests "
              f"{tot['tests'] / max(live, 1):.1f}; leaves of a warp's "
              f"busiest ray {float(lw.amax(1).float().mean()):.1f} (mean "
              f"over {lw.shape[0]} warps with a live ray); "
              f"{k3_ops[key]:.4e} operations, bound "
              f"{bound(0, k3_ops[key])[0]:.4f} ms", flush=True)
        sah = {c: int(v.sum()) for c, v in k3.visit_counts(
            sah_c, *planes, g_cfg.t_min, closest).items()}
        print(f"    the same rays over the SAH tree of the same mask "
              f"(phase 15's K1 frame): nodes "
              f"{sah['nodes'] / max(live, 1):.1f}, leaves "
              f"{sah['leaves'] / max(live, 1):.1f}, triangle tests "
              f"{sah['tests'] / max(live, 1):.1f} per live ray", flush=True)
    if not has_baseline(baseline, "hrt_skip_trace"):
        print("  K3 baseline: none (chip_scratch/baseline/ holds no copy)",
              flush=True)
    else:
        for key, planes, closest in (("k3_closest", c_prim, True),
                                     ("k3_any_hit", c_shadow, False)):
            base = baseline_k3(baseline, caccel, planes, g_cfg.t_min,
                               closest)
            cur = k3.trace_kernel(caccel, *planes, g_cfg.t_min, closest)
            same = (base[1] == cur[1]) if closest else (base == cur)
            agree = float(same.float().mean())
            sm.check(agree >= 0.999, f"K3 {key[3:]} vs the baseline K3: "
                     f"agree on {agree:.6f} of {same.numel()} rays")
            b, c = in_turns(
                lambda: baseline_k3(baseline, caccel, planes, g_cfg.t_min,
                                    closest),
                lambda: k3.trace_kernel(caccel, *planes, g_cfg.t_min,
                                        closest))
            print(f"  K3 {key[3:]} in turns (baseline, current, current, "
                  f"baseline): {b[0]:.4f}, {c[0]:.4f}, {c[1]:.4f}, "
                  f"{b[1]:.4f} ms; current / baseline "
                  f"{sum(c) / sum(b):.4f}", flush=True)
    nf_orbit = [steps]

    def orbit_steps(k: int):
        for _ in range(k):
            cloop.step(orbit_cam(nf_orbit[0]))
            nf_orbit[0] += 1

    nf_forest = [f_steps]

    def forest_steps(k: int, refit: bool):
        for _ in range(k):
            if refit:
                fmove(nf_forest[0])
                nf_forest[0] += 1
            floop.step(cam)

    frame_t = {}
    for size, (w, h) in (("512x384", (512, 384)),
                         ("1920x1080", (1920, 1080))):
        k = 4 if w == 512 else 1
        rays = w * h * g_cfg.spp * 2
        cloop.set_resolution(w, h)
        floop.set_resolution(w, h)
        cull_cam = orbit_cam(steps - 1)
        r0 = cloop.rebuilds
        ts = {
            "culled still": time_ms(lambda: [cloop.step(cull_cam)
                                             for _ in range(k)], reps=5) / k,
            "culled orbit": time_ms(lambda: orbit_steps(k), reps=5) / k,
            "forest still": time_ms(lambda: forest_steps(k, False),
                                    reps=5) / k,
            "forest refit": time_ms(lambda: forest_steps(k, True),
                                    reps=5) / k}
        frame_t[size] = {key: {"ms_per_frame": v,
                               "mrays_per_s": rays / v / 1e3}
                         for key, v in ts.items()}
        for key, v in ts.items():
            print(f"  {key} frame {size}: {v:.4f} ms/frame, "
                  f"{rays / v / 1e3:.2f} Mray/s", flush=True)
        print(f"  culled orbit at {size}: {cloop.rebuilds - r0} rebuilds "
              f"over {6 * k} orbit steps", flush=True)
    if has_baseline(baseline, "hrt_tlas_skip_trace"):
        floop.set_resolution(512, 384)
        frame_vs_baseline(two_level_swaps(baseline, k5),
                          lambda: forest_steps(4, False),
                          "forest still frame 512x384, 4 frames")

    post, hist4k = post_phases(sm, dev, baseline)

    rng_phase(sm, dev)
    from hrt_tpu_torch.models.scene import bench_scene

    p_scene = bench_scene().build(dev)
    p_accel = lbvh.build_bvh_sah(p_scene, leaf_size=32)
    bounce_phase(sm, dev, p_scene, p_accel)
    pt = path_loop_phase(sm, dev)
    cornell_phase(sm, dev)

    def instanced_step(f: int):
        move(f)
        return loop.step(cam)

    def forest_step(f: int):
        fmove(f)
        return floop.step(cam)

    route_phase(sm, dev, {
        "K4": (loop, k4, instanced_step),
        "K3": (cloop, k3, lambda f: cloop.step(orbit_cam(steps + f))),
        "K5": (floop, k5, forest_step)})
    anim = animated_phase(sm, dev)
    p_times = path_times(sm, dev, p_scene, p_accel, pt, anim)
    ml = many_lights_phases(sm, dev)
    sf = scene_file_phases(sm, dev)
    m_entries = materials_times(sm, dev, ml, sf)
    cli_phase(sm, dev)
    k6_bwd = train_phases(sm, dev, hist4k)
    del hist4k
    multi_gpu_phases(sm, dev, p_scene, p_accel)
    gloo_phase(sm)
    end_phase()

    # Bounds of the walks: the bytes walk_bytes counts (hits out: t, tri,
    # u, v and the instance where there is one; a byte of occlusion), the
    # tables the kernel reads once.
    k4_tab = nbytes(tl.w8_rec, tl.tris, tl.obj_from_world, tl.w8_root)
    k3_tab = nbytes(caccel.skip_rec, caccel.tris)
    k5_tab = nbytes(ftl.skip_rec, ftl.tris, ftl.obj_from_world,
                    ftl.blas_base, ftl.blas_end)
    bounds = dict(bench["bounds"])
    bounds.update({
        "k4_closest": bound(k4_tab + walk_bytes(g_prim, 20),
                            k4_ops["k4_closest"]),
        "k4_any_hit": bound(k4_tab + walk_bytes(g_shadow, 1),
                            k4_ops["k4_any_hit"]),
        "k3_closest": bound(k3_tab + walk_bytes(c_prim, 16),
                            k3_ops["k3_closest"]),
        "k3_any_hit": bound(k3_tab + walk_bytes(c_shadow, 1),
                            k3_ops["k3_any_hit"]),
        "k5_closest": bound(k5_tab + walk_bytes(f_prim, 20),
                            k5_ops["k5_closest"]),
        "k5_any_hit": bound(k5_tab + walk_bytes(f_shadow, 1),
                            k5_ops["k5_any_hit"]),
    })
    for key, (ms, by) in bounds.items():
        print(f"  bound {key}: {ms:.6f} ms ({by})", flush=True)

    def extra(key):
        ms, by = bounds[key]
        return {"bound_ms": ms, "bound_by": by, "library_ms": None}

    kernels = [
        {"name": "bvh8_trace_closest", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_REPLACES, "launches": launches["closest"],
         "max_abs_err": errs["k1_closest"], "ms": times["k1_closest"],
         "plain_ms": times["k1_closest_plain"], **extra("k1_closest")},
        {"name": "bvh8_trace_any_hit", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_REPLACES, "launches": launches["any_hit"],
         "max_abs_err": errs["k1_any_hit"], "ms": times["k1_any_hit"],
         "plain_ms": times["k1_any_hit_plain"], **extra("k1_any_hit")},
        {"name": "brdf_light_major", "route": "cuda", "source": K2_SOURCE,
         "replaces": K2_REPLACES, "launches": launches["brdf_light_major"],
         "max_abs_err": errs["k2"], "ms": times["k2"],
         "plain_ms": times["k2_plain"], **extra("k2")},
        {"name": "tlas8_trace_closest", "route": "cuda", "source": K4_SOURCE,
         "replaces": K4_REPLACES, "launches": launches4["k4_closest"],
         "max_abs_err": k4c_err, "ms": times["k4_closest"],
         "plain_ms": times["k4_closest_plain"], **extra("k4_closest")},
        {"name": "tlas8_trace_any_hit", "route": "cuda", "source": K4_SOURCE,
         "replaces": K4_REPLACES, "launches": launches4["k4_any_hit"],
         "max_abs_err": k4a_err, "ms": times["k4_any_hit"],
         "plain_ms": times["k4_any_hit_plain"], **extra("k4_any_hit")},
        {"name": "skip_trace_closest", "route": "cuda", "source": K3_SOURCE,
         "replaces": K3_REPLACES, "launches": launches3["k3_closest"],
         "max_abs_err": k3c_err, "ms": times["k3_closest"],
         "plain_ms": times["k3_closest_plain"], **extra("k3_closest")},
        {"name": "skip_trace_any_hit", "route": "cuda", "source": K3_SOURCE,
         "replaces": K3_REPLACES, "launches": launches3["k3_any_hit"],
         "max_abs_err": k3a_err, "ms": times["k3_any_hit"],
         "plain_ms": times["k3_any_hit_plain"], **extra("k3_any_hit")},
        {"name": "tlas_skip_trace_closest", "route": "cuda",
         "source": K5_SOURCE, "replaces": K5_REPLACES,
         "launches": launches5["k5_closest"], "max_abs_err": k5c_err,
         "ms": times["k5_closest"], "plain_ms": times["k5_closest_plain"],
         **extra("k5_closest")},
        {"name": "tlas_skip_trace_any_hit", "route": "cuda",
         "source": K5_SOURCE, "replaces": K5_REPLACES,
         "launches": launches5["k5_any_hit"], "max_abs_err": k5a_err,
         "ms": times["k5_any_hit"], "plain_ms": times["k5_any_hit_plain"],
         **extra("k5_any_hit")},
        {"name": "warp_bilinear", "route": "cuda", "source": K6_SOURCE,
         "replaces": K6_REPLACES, **post},
        # K6's adjoint (the image gradient) in the recurrent fine-tune:
        # launches over phase 38's run; times and bound at the trainer's
        # 256x256 C=3 history, library_ms grid_sample's input gradient.
        {"name": "warp_bilinear_backward", "route": "cuda",
         "source": K6_SOURCE, "replaces": K6_REPLACES, **k6_bwd},
        # The path_tracing frame (1080p, depth 5, sorted): one frame's five
        # launches of each, every depth's batch; launches over phase 26's
        # 8 steps.
        {"name": "bvh8_trace_closest (path_tracing frame)", "route": "cuda",
         "source": K1_SOURCE, "replaces": K1_REPLACES,
         "launches": pt["totals"]["k1_closest"], **p_times["closest"]},
        {"name": "bvh8_trace_any_hit (path_tracing frame)", "route": "cuda",
         "source": K1_SOURCE, "replaces": K1_REPLACES,
         "launches": pt["totals"]["k1_any_hit"], **p_times["any_hit"]},
        {"name": "brdf_light_major (path_tracing frame)", "route": "cuda",
         "source": K2_SOURCE, "replaces": K2_REPLACES,
         "launches": pt["totals"]["k2"], **p_times["k2"]},
        # The many_lights_256 frame by the tree (512x384, 2 samples): its
        # batches' K1 closest, K1 any hit over the 2-sample light-major
        # batch and K2 with L = 2; launches over phase 31's 32 steps.
        *m_entries,
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
