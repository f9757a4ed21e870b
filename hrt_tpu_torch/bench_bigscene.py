"""Big-scene check and benchmark of the port (the JAX package's
scripts/bench_bigscene.py).

    python -m hrt_tpu_torch.bench_bigscene [--sub 8] [--oracle-rays 1024] [--reps 8]

The scene: two `icosphere(--sub)` meshes at (0, 0, 0) and (2.5, 0, 0)
and `plane(8.0)` at (0, 1.2, 0), one default material (2,621,442
triangles at --sub 8).  `lbvh.build_bvh_sah(scene, leaf_size=16)`
builds the accel on the host (timed, utils/logging.timed).  Its walk
goes through `traversal.closest_hit_bvh_p`, routed as the JAX package
routes it: K1 over the BVH8 records while the SAH tree stays under
wide8.MAX_WIDE_NODES, K3 over the skip-link records past it (--sub 8).

The 512x384 primary rays of `Camera((1.2, -1, -7), (-0.1, 0, 0))` are
walked once and `--oracle-rays` of them, spread evenly over the frame,
checked against `intersect.closest_hit_bruteforce` (triangle ids and
t).  The JAX script checks the first rays, the top rows, which miss
every triangle; spread over the frame about half of them hit.  The rate is
the best of 3 batches of `--reps` closest passes (leaf-pool ids, as
JAX's timed pass), timed with CUDA events (the host clock on the CPU).

Prints one JSON line: `metric`, `value` (Mray/s), `tris`, `route` (the
walk that ran: "K1" or "K3", in the place of JAX's `streams_nodes`),
`node_bytes` (the walked node records) and `tri_bytes`, `scene_s` and
`build_s`, `oracle_rays`, `oracle_hits` (those brute force hits),
`oracle_tri_match`, `oracle_t_maxerr` and the
card (`device`).  The device defaults to the first CUDA device and
raises without one; `--device cpu` runs the plain walks (`--width` and
`--height` let a CPU run stay small).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from .config import RenderConfig, resolve_device
from .models.camera import Camera
from .models.mesh import icosphere, plane
from .models.scene import Scene
from .ops import intersect, lbvh, traversal
from .renderer import camera_arrays, primary_rays
from .utils.logging import timed
from .utils.profiling import device_name, timed_call

CAMERA = Camera(position=(1.2, -1.0, -7.0), rotation=(-0.1, 0.0, 0.0))
LEAF_SIZE = 16
T_MIN = 1e-3
T_MAX = 1e32


def big_scene(sub: int) -> Scene:
    sc = Scene()
    big = sc.add_mesh(icosphere(sub))
    mat = sc.create_material()
    sc.create_instance(big, mat, (0.0, 0.0, 0.0))
    sc.create_instance(big, mat, (2.5, 0.0, 0.0))
    gnd = sc.add_mesh(plane(8.0))
    sc.create_instance(gnd, mat, (0.0, 1.2, 0.0))
    return sc


def camera_rays(width: int, height: int, dev):
    """The camera's unjittered primary rays, (o, d) as V3 planes."""
    cfg = RenderConfig(width=width, height=height)
    return primary_rays(camera_arrays(CAMERA, cfg, dev), height, 0, cfg)


def oracle_check(scene, tri, t, o, d, k: int) -> tuple[float, float, int]:
    """Brute force on k rays spread evenly over the frame (every
    (n // k)-th ray): (the share whose triangle id equals brute force's,
    the largest |t - t_brute| where both hit, the rays brute force hits).
    """
    n = t.shape[0]
    idx = torch.arange(k, device=t.device) * (n // k)
    oa = o.to_array()[idx]
    da = d.to_array()[idx]
    tb, trib, _, _ = intersect.closest_hit_bruteforce(
        oa, da, scene.tri_v0, scene.tri_e1, scene.tri_e2, T_MIN,
        torch.full((k,), T_MAX, device=oa.device), chunk=65536)
    match = (tri[idx] == trib).float().mean().item()
    both = (trib >= 0) & (tri[idx] >= 0)
    err = ((t[idx] - tb).abs()[both].max().item() if bool(both.any())
           else 0.0)
    return match, err, int((trib >= 0).sum().item())


def time_passes(fn, dev, reps: int, batches: int = 3) -> float:
    """Best seconds of one fn() over `batches` batches of `reps` calls
    (CUDA events on the card, the host clock on the CPU), after one
    warm-up call."""
    fn()
    best = float("inf")
    for _ in range(batches):
        _, sec, ev = timed_call(lambda: [fn() for _ in range(reps)], dev)
        best = min(best, (sec if ev is None else ev / 1e3) / reps)
    return best


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="python -m hrt_tpu_torch.bench_bigscene")
    ap.add_argument("--sub", type=int, default=8,
                    help="icosphere subdivision (8 -> 2.62M triangles)")
    ap.add_argument("--oracle-rays", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=384)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Build, check, time; print and return the line's object."""
    args = parse_args(sys.argv[1:] if argv is None else argv)
    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    scene = big_scene(args.sub).build(dev)
    scene_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with timed(f"bigscene: SAH build of {scene.num_triangles} triangles"):
        accel = lbvh.build_bvh_sah(scene, leaf_size=LEAF_SIZE)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    build_s = time.perf_counter() - t0
    route = "K1" if accel.w8 is not None else "K3"
    nodes = accel.w8_rec if accel.w8 is not None else accel.skip_rec
    o, d = camera_rays(args.width, args.height, dev)
    n = o.x.shape[0]

    t, tri, _, _ = traversal.closest_hit_bvh_p(scene, accel, o, d, T_MIN,
                                               T_MAX)
    k = min(args.oracle_rays, n)
    match, t_err, hits = oracle_check(scene, tri, t, o, d, k)
    sec = time_passes(lambda: traversal.closest_hit_bvh_p(
        scene, accel, o, d, T_MIN, T_MAX, sorted_ids=True), dev, args.reps)
    rec = {
        "metric": "bigscene_closest_Mray/s",
        "value": n / sec / 1e6,
        "tris": scene.num_triangles,
        "route": route,
        "node_bytes": nodes.numel() * nodes.element_size(),
        "tri_bytes": accel.tris.numel() * accel.tris.element_size(),
        "scene_s": scene_s,
        "build_s": build_s,
        "rays": n,
        "oracle_rays": k,
        "oracle_hits": hits,
        "oracle_tri_match": match,
        "oracle_t_maxerr": t_err,
        "device": device_name(dev),
    }
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
