"""The profiled stretch of a traced run: the device operations that
torch.profiler's CUDA activities recorded, named and sorted into the
layers that the per-layer metrics read, and the benchmark's own host
spans in the same time base.

The program's kernels carry their CUDA symbols; `op_label` names them
`<C entry>:<symbol><template args>` as the program's records do (the
table below is the yardstick's copy, so that a renamed kernel shows as
a new name rather than moving between layers unseen).
"""
from __future__ import annotations

import re
from typing import NamedTuple

from . import stats

# Kernel symbols of the program's CUDA sources -> their C entry points.
KERNEL_ENTRIES = {
    "bvh8_packet_kernel": "hrt_bvh8_trace",
    "skip_trace_kernel": "hrt_skip_trace",
    "tlas8_closest_kernel": "hrt_tlas8_trace",
    "tlas8_any_hit_kernel": "hrt_tlas8_trace",
    "tlas_skip_trace_kernel": "hrt_tlas_skip_trace",
    "brdf_light_major_kernel": "hrt_brdf_light_major",
    "warp_bilinear_kernel": "hrt_warp_bilinear",
    "warp_bilinear_backward_kernel": "hrt_warp_bilinear_backward",
}
WALK_ENTRIES = ("hrt_bvh8_trace", "hrt_skip_trace", "hrt_tlas8_trace",
                "hrt_tlas_skip_trace")
SHADE_ENTRIES = ("hrt_brdf_light_major",)
WARP_ENTRIES = ("hrt_warp_bilinear",)
# cuDNN and CUTLASS convolution kernels, and the layout transposes
# cuDNN runs around them.
_CONV_RE = re.compile(r"conv|cudnn|xmma|implicit_gemm|fprop|dgrad|wgrad"
                      r"|cutlass|nchwtonhwc|nhwctonchw", re.I)


def _unqualified(name: str) -> str:
    return re.sub(r"^void\s+", "",
                  name.replace("(anonymous namespace)::", "").strip())


def kernel_symbol(name: str) -> str:
    m = re.match(r"[\w:]+", _unqualified(name))
    return m.group(0).split("::")[-1] if m else name


def op_label(name: str) -> str:
    """A port kernel's `entry:symbol<args>`; any other op's own name."""
    sym = kernel_symbol(name)
    entry = KERNEL_ENTRIES.get(sym)
    if entry is None:
        return name
    args = re.match(r"<[^<>]*>", _unqualified(name).split(sym, 1)[1])
    return f"{entry}:{sym}{args.group(0) if args else ''}"


def is_port_kernel(label: str) -> bool:
    return label.startswith("hrt_")


def is_conv(label: str) -> bool:
    return not is_port_kernel(label) and bool(_CONV_RE.search(label))


def entry_of(label: str) -> str:
    return label.split(":", 1)[0]


class Op(NamedTuple):
    label: str
    start: float   # seconds, the profile's time base
    end: float


class Stretch(NamedTuple):
    """Device ops inside [start, end] (clipped), the frames issued in
    it, and the benchmark's host spans (name, start, end) in it."""

    ops: list
    frames: int
    start: float
    end: float
    spans: list

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def busy_s(self) -> float:
        return stats.interval_union((o.start, o.end) for o in self.ops)

    def device_s(self, pick) -> float:
        """Device seconds of the ops whose label `pick` accepts."""
        return sum(o.end - o.start for o in self.ops if pick(o.label))

    def per_frame_ms(self, pick) -> float:
        return self.device_s(pick) * 1e3 / self.frames


def read_profile(prof, frames: int, stretch_name: str) -> Stretch:
    """The Stretch of a torch.profiler profile whose user span
    `stretch_name` brackets `frames` frames; host spans are the other
    user spans named 'rtbench.<what>'."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    ops, spans, lo, hi = [], [], None, None
    for e in prof.events():
        a, b = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.device_type == cuda:
            # The user spans also leave an annotation on the device's
            # timeline; only real device work counts.
            if not e.name.startswith("rtbench."):
                ops.append(Op(op_label(e.name), a, b))
        elif e.name == stretch_name:
            lo, hi = a, b
        elif e.name.startswith("rtbench."):
            spans.append((e.name[len("rtbench."):], a, b))
    if lo is None:
        raise RuntimeError(f"the profile holds no {stretch_name!r} span")
    ops = [Op(o.label, max(o.start, lo), min(o.end, hi)) for o in ops
           if o.end > lo and o.start < hi]
    spans = [s for s in spans if s[2] > lo and s[1] < hi]
    return Stretch(ops, frames, lo, hi, spans)


def short(label: str, width: int = 120) -> str:
    """A label cut to `width` characters for the breakdown."""
    return label if len(label) <= width else label[:width - 3] + "..."


def breakdown(st: Stretch, top: int = 10) -> dict:
    """The device ops that took most time, by label, and the longest
    idle gaps, each named by the host span open at its midpoint."""
    by = {}
    for o in st.ops:
        by[o.label] = by.get(o.label, 0.0) + (o.end - o.start)
    dev = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    dev = [(short(k), v) for k, v in dev]
    idle = stats.gaps([(o.start, o.end) for o in st.ops], st.start, st.end)
    named = []
    for a, b in sorted(idle, key=lambda g: g[0] - g[1])[:top]:
        mid = 0.5 * (a + b)
        open_ = [(s, n) for n, s, e in st.spans if s <= mid <= e]
        named.append([max(open_)[1] if open_ else "other", b - a])
    return {"device_ops": [[k, v] for k, v in dev], "idle_gaps": named}
