"""The spread of chip_smoke.py phase 40's gradient check, on the card, and
where it comes from.

Phase 40 holds one recurrent step of a freshly trained temporal upscaler
(`python -m hrt_tpu_torch.train_upscaler --temporal`) through K6 and its
backward against the plain warp route, the parameter gradients within
1e-4 of each tensor's largest entry.  This probe trains N nets anew at
the trainer's sizes (600 steps, 60 recurrent), with cuDNN deterministic
so that only the warp differs, and for both of each run's sequences
prints the check's reading (each tensor's largest |a - b| over its
largest |b|, the worst tensor) for:
- `contracted` against plain: K6 as it was before its tap sum was
  rounded an operation at a time (nvcc contracting it into FMAs), built
  from csrc/warp_bilinear.cu by the substitution of CONTRACTED into the
  gitignored chip_scratch/_build/;
- the contracted K6 against itself, and the plain route against itself
  (torch's index backward on the card also adds with atomics);
- the committed K6 against plain, and against itself.
For the forward it counts, over the 15 warps of a plain-route pass of
the sequence, the output floats where each K6 differs from
`warp_bilinear_plain` on the same CUDA tensors, by how many ulps at
most, and the fractional source coordinates (fx, fy) of a few such
pixels.  Before the nets it holds each K6's adjoint against autograd of
the plain warp on a motion whose taps never coincide between pixels (so
each image-gradient float is one product, or two at a clamped edge):
the products must agree bit for bit.

    python scripts/torch_recurrent_grad_probe.py [N]     (default 8)

It needs a CUDA device and nvcc; on an H100 a net takes about 40 s.
The last line is one JSON object of the readings.
"""
import contextlib
import ctypes
import hashlib
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from hrt_tpu_torch import train_upscaler as tu  # noqa: E402
from hrt_tpu_torch.kernels import build  # noqa: E402
from hrt_tpu_torch.models import upscaler  # noqa: E402
from hrt_tpu_torch.ops import warp_kernel as k6  # noqa: E402

# K6 as its tap sum was before it was rounded an operation at a time:
# csrc/warp_bilinear.cu with this substitution.
CONTRACTED = [
    ("        r[j] = tap_sum(img + k * sc, o, w);\n",
     "        const float* src = img + k * sc;\n"
     "        r[j] = __ldg(src + o.x) * w.x + __ldg(src + o.y) * w.y +\n"
     "               __ldg(src + o.z) * w.z + __ldg(src + o.w) * w.w;\n"),
]
BUILD_DIR = os.path.join(ROOT, "chip_scratch", "_build")


def build_contracted() -> ctypes.CDLL:
    """The contracted K6's library (both entry points), bound as
    kernels/build.py binds the package's."""
    with open(os.path.join(build.CSRC_DIR, "warp_bilinear.cu")) as f:
        src = f.read()
    for old, new in CONTRACTED:
        if old not in src:
            raise RuntimeError(f"csrc/warp_bilinear.cu lacks {old!r}")
        src = src.replace(old, new)
    h = hashlib.sha256((" ".join(build.NVCC_FLAGS) + src).encode())
    os.makedirs(BUILD_DIR, exist_ok=True)
    cu = os.path.join(BUILD_DIR, f"k6_contracted-{h.hexdigest()[:16]}.cu")
    so = cu[:-3] + ".so"
    if not os.path.exists(so):
        with open(cu, "w") as f:
            f.write(src)
        r = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I",
                            build.CSRC_DIR, "-shared", "-o", so, cu],
                           capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc (contracted K6) failed:\n{r.stderr}")
    lib = ctypes.CDLL(so)
    real = build.load()
    for name in ("hrt_warp_bilinear", "hrt_warp_bilinear_backward"):
        getattr(lib, name).restype = getattr(real, name).restype
        getattr(lib, name).argtypes = getattr(real, name).argtypes
    return lib


class _Swap:
    """The package's kernel library with K6's two entry points taken
    from another build."""

    def __init__(self, real, other):
        self._real = real
        self.hrt_warp_bilinear = other.hrt_warp_bilinear
        self.hrt_warp_bilinear_backward = other.hrt_warp_bilinear_backward

    def __getattr__(self, name):
        return getattr(self._real, name)


@contextlib.contextmanager
def k6_from(lib):
    """K6's wrappers launch `lib`'s entry points inside the block (None:
    the package's own)."""
    real = build.load()
    if lib is not None:
        build._lib = _Swap(real, lib)
    try:
        yield
    finally:
        build._lib = real


def grads(net, seq, plain: bool):
    net.zero_grad(set_to_none=True)
    with upscaler.fp32_convs():
        loss = tu.recurrent_loss(net, *seq, plain=plain)
        loss.backward()
    return float(loss.detach()), [p.grad.clone() for p in net.parameters()]


def rel(ga, gb) -> list:
    """Each tensor's largest |a - b| over its largest |b|."""
    return [float((a - b).abs().max() / b.abs().max())
            for a, b in zip(ga, gb)]


def ordered(a: torch.Tensor) -> torch.Tensor:
    """float32 bits as int64 in the floats' order (ulps apart = the
    difference)."""
    i = a.contiguous().view(torch.int32).to(torch.int64)
    return torch.where(i < 0, -(i & 0x7FFFFFFF), i)


def forward_diffs(net, seq, libs: dict) -> dict:
    """Over a plain-route pass of `seq`, each K6 of `libs` against
    warp_bilinear_plain on the warps' own CUDA tensors: floats that
    differ, most ulps, and (fx, fy) of the first differing pixels."""
    calls = []
    plain = upscaler.warp_bilinear_plain

    def record(img, px, py):
        calls.append((img.detach().clone(), px, py))
        return plain(img, px, py)

    upscaler.warp_bilinear_plain = record
    try:
        with torch.no_grad():
            tu.recurrent_loss(net, *seq, plain=True)
    finally:
        upscaler.warp_bilinear_plain = plain
    out = {}
    for name, lib in libs.items():
        floats = differ = most = 0
        where = []
        for img, px, py in calls:
            pv, _ = plain(img, px, py)
            with k6_from(lib):
                kv, _ = k6.warp_bilinear_kernel(img, px, py)
            ulps = (ordered(kv) - ordered(pv)).abs()
            bad = ulps > 0
            floats += kv.numel()
            differ += int(bad.sum())
            most = max(most, int(ulps.max()))
            pix = bad.any(dim=-1).nonzero()[:8 - len(where)]
            for yy, xx in pix.tolist():
                x, y = float(px[yy, xx]), float(py[yy, xx])
                where.append([round(x - float(torch.floor(px[yy, xx])), 7),
                              round(y - float(torch.floor(py[yy, xx])), 7)])
        out[name] = {"floats": floats, "differ": differ, "max_ulps": most,
                     "fx_fy": where}
    return out


def adjoint_products(libs: dict, dev) -> dict:
    """Each K6 adjoint against autograd of the plain warp where every
    image-gradient float is one product (or, at the right edge, two):
    output pixel (i, j) samples source (3 j + fx, 3 i + fy), the last
    column past the edge.  Returns, per K6, the floats that differ."""
    gen = torch.Generator().manual_seed(3)
    ho, wo, c = 64, 48, 3
    hs, ws = 3 * ho + 2, 3 * wo
    fx = torch.rand((ho, wo), generator=gen)
    fy = torch.rand((ho, wo), generator=gen)
    jj = torch.arange(wo, dtype=torch.float32)[None].expand(ho, wo)
    ii = torch.arange(ho, dtype=torch.float32)[:, None].expand(ho, wo)
    px = (3 * jj + fx).to(dev)
    px[:, -1] = ws - 1 + 0.5        # clamped: xr == xi, two products
    py = (3 * ii + fy).to(dev)
    img = torch.randn((hs, ws, c), generator=gen).to(dev)
    g = torch.randn((ho, wo, c), generator=gen).to(dev)
    src = img.clone().requires_grad_(True)
    k6.warp_bilinear_plain(src, px, py)[0].backward(g)
    want = src.grad
    out = {}
    for name, lib in libs.items():
        with k6_from(lib):
            got = k6.warp_bilinear_backward_kernel(g, px, py, hs, ws)
        out[name] = int((got.view(torch.int32)
                         != want.view(torch.int32)).sum())
    return out


def main() -> None:
    runs = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    build.build()
    build.load()
    contracted = build_contracted()
    libs = {"contracted": contracted, "k6": None}
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.deterministic = True
    adj = adjoint_products(libs, dev)
    print(f"adjoint products vs autograd of plain, floats that differ: "
          f"{adj}", flush=True)
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for run in range(runs):
            tr = tu.main(["--device", "cuda", "--temporal", "--steps",
                          "600", "--recurrent-steps", "60", "--out",
                          os.path.join(tmp, "t.npz")])
            net = tr["net"]
            names = [n for n, _ in net.named_parameters()]
            for si, seq in enumerate(tr["seqs"]):
                g = {}
                for key, lib, plain in (
                        ("contracted", contracted, False),
                        ("contracted2", contracted, False),
                        ("plain", None, True), ("plain2", None, True),
                        ("k6", None, False), ("k62", None, False)):
                    with k6_from(lib):
                        g[key] = grads(net, seq, plain)[1]
                r = {"contracted_vs_plain": rel(g["contracted"], g["plain"]),
                     "contracted_vs_contracted": rel(g["contracted"],
                                                     g["contracted2"]),
                     "plain_vs_plain": rel(g["plain"], g["plain2"]),
                     "k6_vs_plain": rel(g["k6"], g["plain"]),
                     "k6_vs_k6": rel(g["k6"], g["k62"])}
                worst = {k: max(v) for k, v in r.items()}
                at = max(range(len(names)),
                         key=r["contracted_vs_plain"].__getitem__)
                fwd = forward_diffs(net, seq, libs)
                row = {"run": run, "seq": si, **worst,
                       "contracted_worst_tensor": names[at],
                       "forward": fwd}
                rows.append(row)
                print(f"run {run} seq {si}: " + ", ".join(
                    f"{k} {v:.3g}" for k, v in worst.items())
                    + f" (contracted worst at {names[at]}); forward "
                    + "; ".join(f"{k}: {v['differ']} of {v['floats']} "
                                f"differ, max {v['max_ulps']} ulps, (fx, "
                                f"fy) {v['fx_fy'][:4]}"
                                for k, v in fwd.items()), flush=True)
    ok = all(r["k6_vs_plain"] <= 10 * max(r["k6_vs_k6"],
                                          r["plain_vs_plain"])
             for r in rows)
    print(f"k6 vs plain within 10x of max(k6 vs k6, plain vs plain) on "
          f"all {len(rows)}: {ok}", flush=True)
    print(json.dumps({"device": smi, "adjoint_products": adj,
                      "rows": rows}))


if __name__ == "__main__":
    main()
