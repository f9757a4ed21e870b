"""K6's backward on the card: the kept design against the designs tried
beside it and against the first backward kernel (commit 9346733), in
turns, at the upscaler trainer's shapes (hrt_tpu_torch).

    python3 scripts/torch_k6_backward_probe.py [--out PATH]

Needs a CUDA device and nvcc; the first kernel (kept below as source)
and the designs tried (csrc/warp_bilinear.cu with the substitutions of
VARIANTS) build into the gitignored chip_scratch/_build/.  Prints, after
the card's name and power limit:
- each design on an all-zero gradient (an all-+0 result, bit for bit)
  and on NaN and +Inf at a sky and an off-image pixel (non-finite where
  the plain adjoint is);
- each design against autograd of the plain warp, within 1e-5 of each
  element's absolute sum, on three gradients: randn over the trainer's
  256x256 C=3 history (a bench orbit step's motion), the gradients one
  recurrent step of the trainer sends (`trainer_grads`: 15 warps,
  masked to 0 at sky and off-image pixels), and randn over the
  3840x2160 C=3 history of the 1080p post frame;
- each design's ms a call with its zero fill (`launcher`: 10 raw ctypes
  calls per CUDA-event pair, median of 7), in turns (first, kept, kept,
  first) and (tried, kept, kept, tried) for each tried design, and its
  device ms a call replayed from a CUDA graph of 10 calls (no host
  work between), beside the graph ms of the zero fill alone and of the
  kept design without its adds (ABLATIONS);
- nvcc's ptxas lines of each build.
The last line is one JSON object of the numbers (also written to --out).
chip_smoke.py phase 39 loads this file for build_designs (the first
kernel), launcher, trainer_grads, with_special_values and compare.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# The first backward kernel, as commit 9346733 had it: a block per 128
# output pixels, a thread per output float, four global atomicAdds per
# float whatever its gradient.  Its entry point takes the output grid's
# (ho, wo) as the kept one does, where it took their product n.
FIRST_BACKWARD = r'''
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 128;

__device__ __forceinline__ void bilinear_taps(float x, float y, int hs,
                                              int ws, int sy, int sx,
                                              int4* off, float4* w) {
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float fx = x - x0;
  const float fy = y - y0;
  const int xi = static_cast<int>(fminf(fmaxf(x0, 0.0f),
                                        static_cast<float>(ws - 1)));
  const int yi = static_cast<int>(fminf(fmaxf(y0, 0.0f),
                                        static_cast<float>(hs - 1)));
  const int xr = min(xi + 1, ws - 1);
  const int yd = min(yi + 1, hs - 1);
  *off = make_int4(yi * sy + xi * sx, yi * sy + xr * sx,
                   yd * sy + xi * sx, yd * sy + xr * sx);
  *w = make_float4((1.0f - fx) * (1.0f - fy), fx * (1.0f - fy),
                   (1.0f - fx) * fy, fx * fy);
}

__global__ void __launch_bounds__(kThreads)
warp_bilinear_backward_kernel(const float* __restrict__ grad_val, int hs,
                              int ws, int c, const float* __restrict__ px,
                              const float* __restrict__ py, int n,
                              float* __restrict__ grad_img) {
  __shared__ int4 s_off[kTile];
  __shared__ float4 s_w[kTile];
  const int p0 = blockIdx.x * kTile;
  const int np = min(kTile, n - p0);
  const int p = threadIdx.x;
  if (p < np) {
    bilinear_taps(px[p0 + p], py[p0 + p], hs, ws, ws * c, c, &s_off[p],
                  &s_w[p]);
  }
  __syncthreads();
  const int m = np * c;
  const float* g = grad_val + static_cast<size_t>(p0) * c;
  for (int e = threadIdx.x; e < m; e += kThreads) {
    const int q = e / c;
    const int k = e - q * c;
    const int4 o = s_off[q];
    const float4 w = s_w[q];
    const float v = g[e];
    atomicAdd(grad_img + o.x + k, v * w.x);
    atomicAdd(grad_img + o.y + k, v * w.y);
    atomicAdd(grad_img + o.z + k, v * w.z);
    atomicAdd(grad_img + o.w + k, v * w.w);
  }
}

}  // namespace

extern "C" int hrt_warp_bilinear_backward(const float* grad_val, int hs,
                                          int ws, int c, const float* px,
                                          const float* py, int ho, int wo,
                                          float* grad_img, void* stream) {
  const int n = ho * wo;
  if (n <= 0) return 0;
  if (c < 1 || hs < 1 || ws < 1 ||
      static_cast<long long>(hs) * ws * c >= (1LL << 31))
    return cudaErrorInvalidValue;
  const int blocks = (n + kTile - 1) / kTile;
  warp_bilinear_backward_kernel<<<blocks, kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      grad_val, hs, ws, c, px, py, n, grad_img);
  return static_cast<int>(cudaGetLastError());
}
'''

# The designs tried beside the kept one, each csrc/warp_bilinear.cu with
# these substitutions: "warp", the warp-level merge alone (no
# shared-memory window); "always", the window for every block whose box
# fits, whether or not its warps share taps; "rows", blocks over row
# segments of 256 output pixels instead of 32 x 8 tiles; "c4", channels
# summed four at a pass with no register cap (96 registers, 2 blocks an
# SM, against 64 and 4); "gated", __match_any_sync only on a slot where
# two neighbouring lanes share a tap (as a cluster's lanes do).
VARIANTS = {
    "warp": [("constexpr int kWindowFloats = 4096;",
              "constexpr int kWindowFloats = 0;")],
    "always": [("constexpr int kWindowGroup = 8;",
                "constexpr int kWindowGroup = 1;")],
    "rows": [("constexpr int kBwdW = 32;", "constexpr int kBwdW = 256;"),
             ("constexpr int kBwdH = 8;", "constexpr int kBwdH = 1;")],
    "c4": [("constexpr int kBwdChunk = 3;", "constexpr int kBwdChunk = 4;"),
           ("constexpr int kBwdMinBlocks = 4;",
            "constexpr int kBwdMinBlocks = 1;")],
    "gated": [("      grp[j] = __match_any_sync(kFull, key);\n"
               "      shared |= adds[j] && __popc(grp[j]) >= kWindowGroup;\n",
               "      const int left = __shfl_up_sync(kFull, key, 1);\n"
               "      if (__any_sync(kFull, lane > 0 && key == left)) {\n"
               "        grp[j] = __match_any_sync(kFull, key);\n"
               "        shared |= adds[j] && __popc(grp[j]) >= "
               "kWindowGroup;\n"
               "      }\n")],
}
# Timing only (their results are wrong on purpose): "no_adds" drops
# every add to grad_img, so its time is the loads, products, merges and
# window without the L2 atomics.
ABLATIONS = {
    "no_adds": [("  atomicAdd(dst, v);\n}",
                 "  if (v == 1.5e-38f) atomicAdd(dst, v);\n}")],
}
BUILD_DIR = os.path.join(ROOT, "chip_scratch", "_build")


def build_designs(names=None) -> dict:
    """{name: hrt_warp_bilinear_backward of that design's library} for
    `names` of "first" (FIRST_BACKWARD) and VARIANTS' keys, each built
    by its own nvcc process, all started together; ptxas's lines are
    printed."""
    from hrt_tpu_torch.kernels import build

    with open(os.path.join(build.CSRC_DIR, "warp_bilinear.cu")) as f:
        src = f.read()
    names = names or ("first", *VARIANTS)
    sources = {"first": FIRST_BACKWARD}
    for name, subs in {**VARIANTS, **ABLATIONS}.items():
        sources[name] = src
        for old, new in subs:
            if old not in src:
                raise RuntimeError(f"csrc/warp_bilinear.cu lacks {old!r}")
            sources[name] = sources[name].replace(old, new)
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = build.nvcc_path()
    paths, procs = {}, {}
    for name in names:
        text = sources[name]
        h = hashlib.sha256((" ".join(build.NVCC_FLAGS) + text).encode())
        cu = os.path.join(BUILD_DIR, f"k6_{name}-{h.hexdigest()[:16]}.cu")
        paths[name] = cu[:-3] + ".so"
        if os.path.exists(paths[name]):
            continue
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-I", build.CSRC_DIR, "-shared", "-o",
             paths[name] + ".tmp", cu],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for name, proc in procs.items():
        out, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc ({name}) failed:\n{out}{err}")
        os.replace(paths[name] + ".tmp", paths[name])
        for line in err.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas ({name}): {line.strip()}", flush=True)
    fns = {}
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in names:
        fn = ctypes.CDLL(paths[name]).hrt_warp_bilinear_backward
        fn.restype = i
        fn.argtypes = [p, i, i, i, p, p, i, i, p, p]
        fns[name] = fn
    return fns


def launcher(fn, grad_val, px, py, hs: int, ws: int):
    """A no-argument call of the entry point `fn` (the signature of
    csrc/warp_bilinear.cu's hrt_warp_bilinear_backward) on these
    inputs, zero fill included, returning the new grad_img; raises on a
    CUDA error."""
    import torch

    grad_val = grad_val.contiguous()
    px, py = px.contiguous(), py.contiguous()
    c = grad_val.shape[2]

    def call():
        out = torch.zeros((hs, ws, c), device=grad_val.device)
        rc = fn(grad_val.data_ptr(), hs, ws, c, px.data_ptr(),
                py.data_ptr(), *px.shape, out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"warp_bilinear backward: CUDA error {rc}")
        return out

    return call


def trainer_grads(net, seq) -> list:
    """The (grad_val, px, py, hs, ws) that each K6 backward launch of one
    `recurrent_loss(net, *seq).backward()` receives, in launch order
    (the last warped frame first); the net's gradients are cleared
    after."""
    from hrt_tpu_torch import train_upscaler as tu
    from hrt_tpu_torch.models import upscaler
    from hrt_tpu_torch.ops import warp_kernel as k6

    got = []
    orig = k6.warp_bilinear_backward_kernel

    def record(grad_val, px, py, hs, ws):
        got.append((grad_val.detach().contiguous().clone(), px, py, hs, ws))
        return orig(grad_val, px, py, hs, ws)

    k6.warp_bilinear_backward_kernel = record
    try:
        net.zero_grad(set_to_none=True)
        with upscaler.fp32_convs():
            tu.recurrent_loss(net, *seq).backward()
    finally:
        k6.warp_bilinear_backward_kernel = orig
        net.zero_grad(set_to_none=True)
    return got


def with_special_values(grad_val, px, py, hit, hs: int, ws: int):
    """grad_val with NaN in channel 0 and +Inf in channel 1 at a sky
    pixel (hit 0) and at an off-image pixel, px moved 2.25 pixels past
    the right edge at the first hit pixel when no pixel leaves the
    image: (grad_val, px, py, the two flat pixel indices)."""
    import torch

    first = lambda mask: torch.nonzero(mask.reshape(-1)).reshape(-1)
    inb = (px >= 0) & (px <= ws - 1) & (py >= 0) & (py <= hs - 1)
    sky = int(first(hit < 0.5)[0])
    off = first(~inb)
    px = px.clone()
    if off.numel():
        off = int(off[0])
    else:
        off = int(first(hit >= 0.5)[0])
        px.view(-1)[off] = ws + 1.25
    gv = grad_val.clone().reshape(-1, grad_val.shape[-1])
    for i in (sky, off):
        gv[i, 0] = float("nan")
        gv[i, 1] = float("inf")
    return gv.reshape(grad_val.shape), px, py, (sky, off)


def plain_adjoint(grad_val, px, py, hs: int, ws: int):
    """Autograd of the plain warp: the adjoint the kernels are held to
    (it does not depend on the image's values)."""
    import torch

    from hrt_tpu_torch.ops import warp_kernel as k6

    src = torch.zeros((hs, ws, grad_val.shape[2]), device=grad_val.device,
                      requires_grad=True)
    with torch.enable_grad():
        val = k6.warp_bilinear_plain(src, px, py)[0]
        return torch.autograd.grad(val, src, grad_val)[0]


def compare(got, grad_val, px, py, hs: int, ws: int) -> dict:
    """`got` against the plain adjoint: the largest error over each
    finite element's absolute sum (the plain adjoint of |grad_val|,
    non-finite values taken as 0), and whether NaN, +Inf and -Inf sit
    exactly where the plain adjoint has them."""
    import torch

    want = plain_adjoint(grad_val, px, py, hs, ws)
    mag = torch.where(torch.isfinite(grad_val), grad_val.abs(), 0.0)
    scale = plain_adjoint(mag, px, py, hs, ws)
    fin = torch.isfinite(want) & torch.isfinite(got)
    err = (got - want).abs()
    rel = float(torch.where(fin, err / scale.clamp(min=1e-30), 0.0).max())
    same = all(torch.equal(f(got), f(want)) for f in (
        torch.isnan, torch.isposinf, torch.isneginf))
    return {"rel": rel, "max_abs": float(torch.where(fin, err, 0.0).max()),
            "nonfinite_match": same,
            "nonfinite": int((~torch.isfinite(want)).sum())}


def graph_ms(call, calls: int = 10, reps: int = 7) -> float:
    """Device ms of one call: `calls` calls captured in a CUDA graph,
    replayed between two events (median of `reps`)."""
    import torch

    call()
    torch.cuda.synchronize()
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        call()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            call()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def cases(dev) -> dict:
    """{label: [(grad_val, px, py, hs, ws), ...]}: randn over the
    trainer's history, the trainer's own gradients (the committed
    temporal net's), randn over the 4K post history; and the trainer
    history's hit mask at 256x256."""
    import torch

    import chip_smoke
    from hrt_tpu_torch import train_upscaler as tu
    from hrt_tpu_torch.config import RenderConfig
    from hrt_tpu_torch.frameloop import FrameLoop
    from hrt_tpu_torch.models import upscaler
    from hrt_tpu_torch.models.scene import bench_scene
    from hrt_tpu_torch.ops import denoise

    seq = tu.render_sequence(16, scene_kind="bench", device=dev)
    lrs, wps, hits, cams, cleans = seq
    h2, w2 = cleans.shape[1], cleans.shape[2]
    px, py, _ = denoise._project(upscaler._upsample2_corner(wps[1]),
                                 cams[0].origin, cams[0].basis,
                                 cams[0].tan_half_fovy, cams[0].aspect, w2,
                                 h2)
    g = torch.Generator(device=dev).manual_seed(0)
    randn = torch.randn((h2, w2, 3), generator=g, device=dev)
    net = upscaler.load_weights("temporal", dev).requires_grad_(True)
    out = {"trainer 256x256 C=3, randn": [(randn, px, py, h2, w2)],
           "trainer 256x256 C=3, the trainer's gradient (15 warps)":
               trainer_grads(net, seq)}
    loop = FrameLoop(bench_scene(), RenderConfig(
        width=1920, height=1080, max_depth=1, sky=True, denoise=True,
        upscale=2, upscale_mode="temporal"), device=dev)
    for f in range(2):
        loop.step(chip_smoke.post_cam(f))
    from hrt_tpu_torch import renderer

    cfg = loop.config
    cams4 = renderer.camera_arrays(chip_smoke.post_cam(2), cfg, dev)
    _, gb = renderer.render_rows(loop.scene, loop.accel, cams4, 0, 1080,
                                 cfg, want_gbuffer=True)
    prev = loop.prev_cams
    px4, py4, _ = denoise._project(
        upscaler._upsample2_corner(gb["world_pos"]), prev.origin,
        prev.basis, prev.tan_half_fovy, prev.aspect, 3840, 2160)
    randn4 = torch.randn((2160, 3840, 3), generator=g, device=dev)
    out["4K history 3840x2160 C=3, randn"] = [(randn4, px4, py4, 2160,
                                               3840)]
    hit = hits[1].repeat_interleave(2, 0).repeat_interleave(2, 1)
    return out, hit


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from hrt_tpu_torch.kernels import build

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    limit = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"{name}; nvidia-smi: {limit.strip()}", flush=True)
    fns = {"kept": build.load().hrt_warp_bilinear_backward,
           **build_designs()}
    ablated = build_designs(tuple(ABLATIONS))
    result = {"device": name, "power": limit.strip(), "cases": {}}
    ok = True
    all_cases, hit = cases(dev)
    g0, px0, py0, hs, ws = all_cases["trainer 256x256 C=3, randn"][0]
    special = with_special_values(torch.where(hit[..., None] > 0.5, g0, 0.0),
                                  px0, py0, hit, hs, ws)[:3]
    for d, fn in fns.items():
        zero = launcher(fn, torch.zeros_like(g0), px0, py0, hs, ws)()
        cmp = compare(launcher(fn, *special, hs, ws)(), *special, hs, ws)
        good = (bool((zero.view(torch.int32) == 0).all())
                and cmp["nonfinite_match"] and cmp["rel"] <= 1e-5)
        ok &= good
        print(f"  {d}: all-zero gradient -> all +0 "
              f"{bool((zero.view(torch.int32) == 0).all())}; NaN / +Inf at a "
              f"sky and an off-image pixel: {cmp['nonfinite']} non-finite "
              f"elements, where the plain adjoint has them "
              f"{cmp['nonfinite_match']}, rel {cmp['rel']:.3g}", flush=True)
    for label, items in all_cases.items():
        row = {}
        calls = {d: [launcher(fn, *it) for it in items]
                 for d, fn in fns.items()}
        for d, cs in calls.items():
            worst = {"rel": 0.0, "nonfinite_match": True}
            for call, it in zip(cs, items):
                cmp = compare(call(), *it)
                worst["rel"] = max(worst["rel"], cmp["rel"])
                worst["nonfinite_match"] &= cmp["nonfinite_match"]
            ok &= worst["rel"] <= 1e-5 and worst["nonfinite_match"]
            row[f"{d}_rel"] = worst["rel"]
        run = {d: (lambda cs=cs: [c() for c in cs])
               for d, cs in calls.items()}
        k = len(items)
        for other in ("first", *VARIANTS):
            b, c = chip_smoke.in_turns(run[other], run["kept"], calls=10)
            row[f"turns_{other}"] = [x / k for x in (b[0], c[0], c[1], b[1])]
        for d in run:
            row[f"{d}_graph_ms"] = graph_ms(run[d]) / k
        for d, fn in ablated.items():
            cs = [launcher(fn, *it) for it in items]
            row[f"{d}_graph_ms"] = graph_ms(lambda: [c() for c in cs]) / k
        row["zero_fill_graph_ms"] = graph_ms(lambda: [torch.zeros(
            (it[3], it[4], it[0].shape[2]), device=dev) for it in items]) / k
        g0, px0, py0, hs, ws = items[0]
        n_bytes = chip_smoke.nbytes(g0, px0, py0) + hs * ws * g0.shape[2] * 4
        row["bound_ms"] = chip_smoke.bound(n_bytes)[0]
        row["nonzero_share"] = float(
            sum(int((it[0] != 0).any(-1).sum()) for it in items)
            / sum(it[1].numel() for it in items))
        result["cases"][label] = row
        print(f"  {label}: " + ", ".join(
            f"{key} " + (f"{v:.6g}" if isinstance(v, float) else
                         "[" + ", ".join(f"{x:.4f}" for x in v) + "]")
            for key, v in row.items()), flush=True)
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
