"""Where K1's and K2's time goes on the card, and the K1 designs tried
beside the one kept (hrt_tpu_torch, bench frame batches).

    python3 scripts/torch_k1_k2_probe.py

Needs a CUDA device, nvcc, and the 6f624a9 kernels under the gitignored
chip_scratch/baseline/ (chip_smoke.py's docstring says how to copy
them).  Prints, at 512x384 and 1920x1080:
- each kernel alone (raw ctypes calls on prepared arguments, 50 calls
  per CUDA-event pair, median of 7), the current and the 6f624a9 one in
  turns (baseline, current, current, baseline);
- K1 variants built from the current csrc/bvh8_trace.cu by one change
  each, checked against the plain walk and timed in turns with the
  current kernel: the lanes-over-triangles threshold at 0 (never), 8,
  24 and 33 (always), 64-thread blocks, a launch-bounds register cap,
  the leaf loop not unrolled, and any hit as a thread per ray with
  while-while leaves (the first redesign of this PR, kept below as
  source);
- the wrappers' host cost per call (200 calls without a synchronize,
  median of 7) and its pieces;
- K2 of both commits against its plain version on random strided
  planes (the card test's data).
"""
from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

# Any hit as a thread per ray: a per-ray stack of node entries
# (base << 8 | rank-mask) and leaf entries -(pool start + 1), a lane
# parking on its leaf until every live lane of the warp has one (Aila &
# Laine's while-while), then all parked lanes testing theirs.
ANY_HIT_THREAD = r'''
namespace {
__global__ void __launch_bounds__(kThreads)
any_hit_thread_kernel(const float* __restrict__ ox,
                      const float* __restrict__ oy,
                      const float* __restrict__ oz,
                      const float* __restrict__ dx,
                      const float* __restrict__ dy,
                      const float* __restrict__ dz,
                      const float* __restrict__ tmax, int n,
                      const int4* __restrict__ rec,
                      const float4* __restrict__ tris, int leaf_size,
                      float t_min, unsigned char* __restrict__ occ_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int jr = min(i, n - 1);
  Ray r;
  hrt::set_ray(r, ox[jr], oy[jr], oz[jr], dx[jr], dy[jr], dz[jr]);
  const float t = tmax[jr];
  bool blocked = false;
  bool done = !(i < n && t >= 0.0f);
  int stack[40];
  stack[0] = 1;
  int sp = 1;
  int parked = -1;
  while (__any_sync(kFull, !done)) {
    if (!done && parked < 0) {
      if (sp == 0) {
        done = true;
      } else {
        const int e = stack[--sp];
        if (e < 0) {
          parked = -e - 1;
        } else {
          const int mask = e & 255;
          const int base_e = e >> 8;
          const int low = mask & -mask;
          if (mask ^ low) stack[sp++] = (base_e << 8) | (mask ^ low);
          const int4* node = rec + 16 * (base_e + __ffs(low) - 1);
          const int first_child = __ldg(node + 1).w;
          int int_mask = 0, leaf_mask = 0;
          for (int c = 0; c < 8; ++c) {
            const int4 a = __ldg(node + 2 * c), b = __ldg(node + 2 * c + 1);
            if (b.z == 0) break;
            if (!hrt::slab_hit(__int_as_float(a.x), __int_as_float(a.y),
                               __int_as_float(a.z), __int_as_float(a.w),
                               __int_as_float(b.x), __int_as_float(b.y), r,
                               t_min, t))
              continue;
            if (b.z < 0)
              int_mask |= 1 << (-b.z - 1);
            else
              leaf_mask |= 1 << c;
          }
          if (int_mask) stack[sp++] = (first_child << 8) | int_mask;
          while (leaf_mask) {
            const int c = 31 - __clz(leaf_mask);
            leaf_mask ^= 1 << c;
            stack[sp++] = -__ldg(reinterpret_cast<const int*>(node) + 8 * c +
                                 6);
          }
        }
      }
    }
    if (!__any_sync(kFull, !done && parked < 0) && parked >= 0) {
      const float4* tp = tris + 3 * static_cast<size_t>(parked);
      for (int k = 0; k < leaf_size; ++k) {
        float th, uh, vh;
        if (hrt::moller_scaled(__ldg(tp + 3 * k), __ldg(tp + 3 * k + 1),
                               __ldg(tp + 3 * k + 2), r, t_min, t, th, uh,
                               vh)) {
          blocked = done = true;
          break;
        }
      }
      parked = -1;
    }
  }
  if (i < n) occ_out[i] = blocked ? 1 : 0;
}
}  // namespace

extern "C" int hrt_bvh8_any_hit_thread(const float* ox, const float* oy,
                                       const float* oz, const float* dx,
                                       const float* dy, const float* dz,
                                       const float* tmax, int n,
                                       const int* records, const float* tris,
                                       int leaf_size, float t_min,
                                       unsigned char* occ, void* stream) {
  any_hit_thread_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      ox, oy, oz, dx, dy, dz, tmax, n,
      reinterpret_cast<const int4*>(records),
      reinterpret_cast<const float4*>(tris), leaf_size, t_min, occ);
  return static_cast<int>(cudaGetLastError());
}
'''

PACKET_HEAD = ("template <int STACK, bool CLOSEST>\n__global__ void "
               "__launch_bounds__(kThreads)")
VARIANTS = {
    "never over triangles": [("kLanesOverTriangles = 16;",
                              "kLanesOverTriangles = 0;")],
    "over triangles below 8 lanes": [("kLanesOverTriangles = 16;",
                                      "kLanesOverTriangles = 8;")],
    "over triangles below 24 lanes": [("kLanesOverTriangles = 16;",
                                       "kLanesOverTriangles = 24;")],
    "always over triangles": [("kLanesOverTriangles = 16;",
                               "kLanesOverTriangles = 33;")],
    "64-thread blocks": [("kThreads = 128;", "kThreads = 64;")],
    "launch bounds (128, 8)": [(PACKET_HEAD, PACKET_HEAD[:-1] + ", 8)")],
    "leaf loop not unrolled": [("#pragma unroll 4", "#pragma unroll 1")],
}


def host_us(fn, calls: int = 200, reps: int = 7) -> float:
    """Median host time of one fn() call in µs, over `calls` calls
    without a synchronize (the enqueue only)."""
    import torch

    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        ts.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(ts)


def guard(dev) -> None:
    """Enter and leave the wrappers' device guard."""
    import torch

    with torch.cuda.device(dev):
        pass


def build_variants(src: str, build) -> dict:
    """Each variant of the current K1 source as its own library, built
    with the package's flags, all at once."""
    vdir = os.path.join(ROOT, "chip_scratch", "_build", "variants")
    os.makedirs(vdir, exist_ok=True)
    jobs = {}
    sources = {name: src for name in VARIANTS}
    for name, reps in VARIANTS.items():
        for a, b in reps:
            if a not in sources[name]:
                raise RuntimeError(f"variant {name!r}: {a!r} not in source")
            sources[name] = sources[name].replace(a, b)
    sources["any hit, thread per ray"] = src + ANY_HIT_THREAD
    for k, (name, s) in enumerate(sources.items()):
        cu = os.path.join(vdir, f"bvh8_variant{k}.cu")
        with open(cu, "w") as f:
            f.write(s)
        so = cu[:-3] + ".so"
        jobs[name] = (subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-shared", "-I",
             os.path.join(ROOT, "hrt_tpu_torch", "csrc"), "-o", so, cu],
            stderr=subprocess.PIPE, text=True), so)
    libs = {}
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, (proc, so) in jobs.items():
        err = proc.communicate(timeout=900)[1]
        if proc.returncode:
            raise RuntimeError(f"variant {name!r} failed:\n{err}")
        lib = ctypes.CDLL(so)
        lib.hrt_bvh8_trace.restype = i
        lib.hrt_bvh8_trace.argtypes = [p] * 7 + [i, p, p, i, f, i, i] \
            + [p] * 5 + [p]
        if hasattr(lib, "hrt_bvh8_any_hit_thread"):
            lib.hrt_bvh8_any_hit_thread.restype = i
            lib.hrt_bvh8_any_hit_thread.argtypes = [p] * 7 + [i, p, p, i, f,
                                                              p, p]
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from hrt_tpu_torch import renderer
    from hrt_tpu_torch.config import RenderConfig
    from hrt_tpu_torch.kernels import build
    from hrt_tpu_torch.models.camera import Camera
    from hrt_tpu_torch.models.scene import bench_scene
    from hrt_tpu_torch.ops import lbvh, shade_kernel
    from hrt_tpu_torch.ops import traversal_wide8 as k1

    baseline = cs.load_baseline()
    if not (cs.has_baseline(baseline, "hrt_bvh8_trace")
            and cs.has_baseline(baseline, "hrt_brdf_light_major")):
        print("needs the 6f624a9 K1 and K2 under chip_scratch/baseline/",
              file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    lib = build.load()
    with open(os.path.join(ROOT, "hrt_tpu_torch", "csrc",
                           "bvh8_trace.cu")) as f:
        variants = build_variants(f.read(), build)
    sm = cs.Smoke()
    scene = bench_scene().build(dev)
    accel = lbvh.build_bvh_sah(scene, leaf_size=32)
    se = k1.stack_entries(accel.w8_depth)
    st = torch.cuda.current_stream().cuda_stream
    for w, h in ((512, 384), (1920, 1080)):
        print(f"{w}x{h}", flush=True)
        cfg = RenderConfig(width=w, height=h, max_depth=1, sky=True)
        cams = renderer.camera_arrays(Camera(**cs.BENCH_CAM), cfg, dev)
        prim, shadow, k2a = cs.frame_batches(scene, accel, cams, cfg)
        n, ns = prim[0].numel(), shadow[0].numel()
        pp = [q.data_ptr() for q in prim]
        sp = [q.data_ptr() for q in shadow]
        o4 = torch.empty((4, n), device=dev)
        b0 = o4.data_ptr()
        occ = torch.empty(ns, dtype=torch.bool, device=dev)
        rec, tris = accel.w8_rec.data_ptr(), accel.tris.data_ptr()

        def closest(lb, table=rec, stack=se):
            return lambda: lb.hrt_bvh8_trace(
                *pp, n, table, tris, 32, cfg.t_min, stack, 1, b0, b0 + 4 * n,
                b0 + 8 * n, b0 + 12 * n, None, st)

        def any_hit(lb, table=rec, stack=se):
            return lambda: lb.hrt_bvh8_trace(
                *sp, ns, table, tris, 32, cfg.t_min, stack, 0, None, None,
                None, None, occ.data_ptr(), st)

        def any_thread(lb):
            return lambda: lb.hrt_bvh8_any_hit_thread(
                *sp, ns, rec, tris, 32, cfg.t_min, occ.data_ptr(), st)

        ref_c = k1.trace_plain(accel, *prim, cfg.t_min, True)
        ref_a = k1.trace_plain(accel, *shadow, cfg.t_min, False)

        def check(name, closest_fn, any_fn):
            closest_fn()
            torch.cuda.synchronize()
            t, tri, u, v = o4.unbind(0)
            cs.check_closest(sm, f"{name} closest vs plain",
                             (t, tri.view(torch.int32), u, v), ref_c)
            any_fn()
            torch.cuda.synchronize()
            cs.check_occlusion(sm, f"{name} any-hit vs plain", occ.clone(),
                               ref_a)

        old = dict(table=accel.w8.data_ptr(), stack=accel.w8_depth + 1)
        check("6f624a9", closest(baseline, **old), any_hit(baseline, **old))
        check("current", closest(lib), any_hit(lib))
        for name, vl in variants.items():
            check(name, closest(vl),
                  any_thread(vl) if hasattr(vl, "hrt_bvh8_any_hit_thread")
                  else any_hit(vl))

        def turns(label, base, cur):
            b, c = cs.in_turns(base, cur, calls=50)
            print(f"  {label}: {b[0]:.4f}, {c[0]:.4f}, {c[1]:.4f}, "
                  f"{b[1]:.4f} ms; ratio {sum(c) / sum(b):.4f}", flush=True)

        print("  kernels alone, 50 calls per event pair, in turns (first "
              "named, second named, second, first):", flush=True)
        turns("K1 closest 6f624a9 / current", closest(baseline, **old),
              closest(lib))
        turns("K1 any-hit 6f624a9 / current", any_hit(baseline, **old),
              any_hit(lib))
        for name, vl in variants.items():
            if hasattr(vl, "hrt_bvh8_any_hit_thread"):
                turns(f"K1 any-hit current / {name}", any_hit(lib),
                      any_thread(vl))
                continue
            turns(f"K1 closest current / {name}", closest(lib),
                  closest(vl))
            turns(f"K1 any-hit current / {name}", any_hit(lib), any_hit(vl))
        out2 = torch.empty((3, ns), device=dev)
        args2 = shade_kernel.pack_args(*k2a, out2)
        mat, nrm, view, l_lm, rel, nl = k2a
        shared = torch.stack(shade_kernel._shared_planes(mat, nrm,
                                                         view)).contiguous()
        light = torch.stack([l_lm.x, l_lm.y, l_lm.z]).contiguous()
        k2_old = lambda: baseline.hrt_brdf_light_major(
            shared.data_ptr(), light.data_ptr(), rel.data_ptr(), n, ns,
            out2.data_ptr(), st)
        k2_new = lambda: lib.hrt_brdf_light_major(args2, st)
        turns("K2 6f624a9 kernel alone / current", k2_old, k2_new)
        stacks = lambda: (torch.stack(shade_kernel._shared_planes(
            mat, nrm, view)), torch.stack([l_lm.x, l_lm.y, l_lm.z]))
        print(f"  K2 6f624a9 wrapper's two stacks alone: "
              f"{cs.time_ms(stacks, calls=50):.4f} ms", flush=True)

        print("  wrappers' host cost per call (µs; 200 calls without a "
              "synchronize, median of 7):", flush=True)
        wr = {
            "K1 closest": (lambda: cs.baseline_k1(baseline, accel, prim,
                                                  cfg.t_min, True),
                           lambda: k1.trace_kernel(accel, *prim, cfg.t_min,
                                                   True)),
            "K1 any-hit": (lambda: cs.baseline_k1(baseline, accel, shadow,
                                                  cfg.t_min, False),
                           lambda: k1.trace_kernel(accel, *shadow, cfg.t_min,
                                                   False)),
            "K2": (lambda: cs.baseline_k2(baseline, *k2a),
                   lambda: shade_kernel.brdf_light_major_kernel(*k2a))}
        for key, (o, c) in wr.items():
            print(f"    {key}: 6f624a9 {host_us(o):.1f}, current "
                  f"{host_us(c):.1f}", flush=True)
        pieces = {
            "K1: 7 planes' checks": lambda: k1._check_inputs(accel,
                                                             list(prim)),
            "K1: the (4, N) output": lambda: torch.empty((4, n), device=dev),
            "K1: its 4 planes (unbind, int32 view)": lambda: (
                lambda t, tri, u, v: tri.view(torch.int32))(*o4.unbind(0)),
            "K1: the ctypes call (20 arguments)": closest(lib),
            "K2: pack_args (22 planes)": lambda: shade_kernel.pack_args(
                *k2a, out2),
            "K2: the ctypes call (by-value block)": k2_new,
            "device guard": lambda: guard(dev),
            "raw stream handle": lambda: build.stream(dev)}
        for key, fn in pieces.items():
            print(f"    {key}: {host_us(fn):.2f}", flush=True)
        torch.cuda.synchronize()

    from test_torch_cuda import _brdf_args

    print("K2 vs plain on the card test's random strided planes (4093 "
          "rays; worst excess over rtol 1e-4 / atol 1e-6):", flush=True)
    for nl, seed in ((1, 11), (2, 12), (3, 13)):
        args = _brdf_args(dev, 4093, nl, 0.7, seed)
        pf = shade_kernel.brdf_light_major_plain(*args)
        for who, fn in (("6f624a9", lambda: cs.baseline_k2(baseline, *args)),
                        ("current", lambda: shade_kernel
                         .brdf_light_major_kernel(*args))):
            ex = max(float(((a - b).abs() - 1e-4 * b.abs() - 1e-6).max())
                     for a, b in zip(fn(), pf))
            print(f"  L={nl} {who}: {ex:.3g}", flush=True)
    print(f"checks failed: {sm.failures}", flush=True)
    return 1 if sm.failures else 0


if __name__ == "__main__":
    sys.exit(main())
