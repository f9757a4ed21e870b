"""The port's tracing: host spans, device stage clocks and device
counters on the frame path, and device clocks around work between
frames, off by default.

    from hrt_tpu_torch.utils import tracing
    tracing.enable()
    ... loop.step(cam) ...
    print(tracing.snapshot())
    tracing.disable()

`enable()` / `disable()` switch it for the process (the render
command's `--stats` does).  When it is off, `span` and `clock` return
one shared no-op context, and `mark`, `count` and `frame` do nothing:
nothing is recorded, no event or profiler annotation is made and no
node is added to a captured frame.

- `span(name)`, a host span: name, start, end (`time.perf_counter_ns`)
  and parent (the enclosing span of the same thread) go into a ring of
  the last SPANS spans, and the totals, self times (the span less its
  children) and counts per name add up.  While a torch profiler is
  active it also opens `record_function("hrt." + name)`, which puts
  the span in the device trace's time base.
- `frame(device)` brackets one frame body: inside it, `mark(stage)`
  enqueues `hrt_timestamp` (csrc/timestamp.cu), a one-thread kernel
  that writes the GPU's `%globaltimer` into the next slot of a
  preallocated buffer, and `count(name, tensor)` writes `tensor.sum()`
  into the next slot.  The slots are fixed when the body runs, so a
  captured graph writes the same slots at every replay.  The frame's
  last mark (`end`) closes its last stage; a stage's time is the gap
  between its mark and the next.  On the CPU a mark holds the host
  clock, reported under `host_stage_ms`, never as a device time.
- `collect(rec)`, called after each frame (replayed or not), enqueues
  one device-to-device copy of the buffer into the next row of a ring
  of RING frames, outside any graph: the next replay overwrites the
  buffer, and the host, with frames in flight, never reads it in time.
  Nothing waits for the device.
- `clock(name, device)` times work outside any frame body, such as a
  build program's replay between frames: on the card a pair of CUDA
  events recorded on the current stream before and after the block,
  outside any capture, resolved once the device has passed them (a
  later clock takes the finished pairs without waiting; `snapshot`
  waits for the rest).  On the CPU it holds the host clock, reported
  under `host_clock_ms`, never as a device time.  Its totals are not
  frame stages: they never go into `stage_ms`, whose means divide by
  the frames in the ring.
- `snapshot()` waits for the device and reads the ring: per-span host
  ms, per-stage ms a frame over the frames in the ring, counts a frame
  and the live-lane share (`live.d<k>`: rays active on entry to depth
  k), and each clock's total ms and count.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import re
import threading
import time

import torch

SLOTS = 128      # stage clocks and counters of one frame
RING = 64        # frames kept for snapshot()
SPANS = 4096     # host spans kept
_NOOP = contextlib.nullcontext()
_LIVE = re.compile(r"live\.d(\d+)$")


class _Frame:
    """One frame body's slots: (kind, name) in order, and the buffer
    they are written into."""

    def __init__(self, buf: torch.Tensor):
        self.buf = buf
        self.slots: list[tuple[str, str]] = []

    def take(self, kind: str, name: str):
        """The next slot's one-element view, or None when full."""
        i = len(self.slots)
        if i >= SLOTS:
            return None
        self.slots.append((kind, name))
        return self.buf[i:i + 1]


class _Ring:
    """A device's frame buffer and the ring of frames copied from it."""

    def __init__(self, device: torch.device):
        self.device = device
        self.buf = torch.zeros(SLOTS, dtype=torch.int64, device=device)
        self.rows = torch.zeros((RING, SLOTS), dtype=torch.int64,
                                device=device)
        self.layouts: list = [None] * RING
        self.next = 0


class _Tracer:
    def __init__(self):
        self.on = False
        self.local = threading.local()
        self.ring: _Ring | None = None
        self.frame: _Frame | None = None
        self.clear()

    def clear(self) -> None:
        self.spans = collections.deque(maxlen=SPANS)
        self.total: dict[str, int] = collections.defaultdict(int)
        self.self_ns: dict[str, int] = collections.defaultdict(int)
        self.count: dict[str, int] = collections.defaultdict(int)
        # Clocks: (name, start event, end event) not yet resolved, and
        # {"device" | "host": {name: [total ms, count]}}.
        self.pending: collections.deque = collections.deque()
        self.clocks: dict[str, dict[str, list]] = {"device": {}, "host": {}}
        if self.ring is not None:
            self.ring.layouts = [None] * RING
            self.ring.next = 0

    def add_clock(self, kind: str, name: str, ms: float) -> None:
        tot = self.clocks[kind].setdefault(name, [0.0, 0])
        tot[0] += ms
        tot[1] += 1

    def settle(self, wait: bool) -> None:
        """Resolve the pending clocks in order: those the device has
        passed, or (`wait`) all of them, waiting for each."""
        while self.pending:
            name, a, b = self.pending[0]
            if wait:
                b.synchronize()
            elif not b.query():
                return
            self.pending.popleft()
            self.add_clock("device", name, a.elapsed_time(b))

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def ring_for(self, device: torch.device) -> _Ring:
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if self.ring is None or self.ring.device != device:
            if (device.type == "cuda"
                    and torch.cuda.is_current_stream_capturing()):
                raise RuntimeError("tracing: the frame buffer is made op by "
                                   "op, before a capture")
            self.ring = _Ring(device)
        return self.ring


_T = _Tracer()


def enable() -> None:
    _T.on = True


def disable() -> None:
    _T.on = False


def enabled() -> bool:
    return _T.on


def reset() -> None:
    """Forget the spans, totals and frames recorded so far."""
    _T.clear()


class _Span:
    __slots__ = ("name", "t0", "child_ns", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.child_ns = 0
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function("hrt." + self.name)
            self.rf.__enter__()
        _T.stack().append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        stack = _T.stack()
        stack.pop()
        parent = stack[-1] if stack else None
        dur = t1 - self.t0
        if parent is not None:
            parent.child_ns += dur
        _T.total[self.name] += dur
        _T.self_ns[self.name] += dur - self.child_ns
        _T.count[self.name] += 1
        _T.spans.append((self.name, self.t0, t1,
                         None if parent is None else parent.name))
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        return False


def span(name: str):
    """A host span around the block (see the module's docstring)."""
    return _Span(name) if _T.on else _NOOP


def spans() -> list:
    """The ring's spans, oldest first: (name, start ns, end ns,
    parent's name or None)."""
    return list(_T.spans)


class _Clock:
    __slots__ = ("name", "stream", "start", "t0")

    def __init__(self, name: str, device: torch.device):
        self.name = name
        self.stream = (torch.cuda.current_stream(device)
                       if device.type == "cuda" else None)

    def __enter__(self):
        if self.stream is None:
            self.t0 = time.perf_counter_ns()
            return self
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("tracing: a clock times work outside any "
                               "capture")
        self.start = torch.cuda.Event(enable_timing=True)
        self.start.record(self.stream)
        return self

    def __exit__(self, *exc):
        if self.stream is None:
            _T.add_clock("host", self.name,
                         (time.perf_counter_ns() - self.t0) / 1e6)
            return False
        end = torch.cuda.Event(enable_timing=True)
        end.record(self.stream)
        _T.pending.append((self.name, self.start, end))
        _T.settle(wait=False)
        return False


def clock(name: str, device):
    """A clock around the block, which runs outside any frame body and
    any capture (see the module's docstring); the shared no-op context
    when tracing is off."""
    return _Clock(name, torch.device(device)) if _T.on else _NOOP


@contextlib.contextmanager
def frame(device):
    """Bracket one frame body; yields the frame's record (None when
    tracing is off), which `collect` takes after the frame ran."""
    if not _T.on:
        yield None
        return
    rec = _Frame(_T.ring_for(torch.device(device)).buf)
    prev, _T.frame = _T.frame, rec
    try:
        yield rec
        mark("end")
    finally:
        _T.frame = prev


def mark(stage: str) -> None:
    """The stage clock: `stage` starts here, in the frame body being
    run (nothing outside a frame or with tracing off)."""
    rec = _T.frame
    if rec is None:
        return
    slot = rec.take("mark", stage)
    if slot is None:
        return
    if slot.is_cuda:
        from ..kernels import build

        dev = slot.device
        build.check(build.load().hrt_timestamp(
            ctypes.c_void_p(slot.data_ptr()),
            ctypes.c_void_p(build.stream(dev))), "hrt_timestamp")
    else:
        slot.fill_(time.perf_counter_ns())


def count(name: str, tensor: torch.Tensor) -> None:
    """The device counter: tensor.sum() into the frame's next slot
    (nothing outside a frame or with tracing off)."""
    rec = _T.frame
    if rec is None:
        return
    slot = rec.take("count", name)
    if slot is not None:
        torch.sum(tensor.reshape(-1), 0, keepdim=True, dtype=torch.int64,
                  out=slot)


def collect(rec) -> None:
    """After a frame ran (or was replayed): copy its slots into the
    ring's next row, on the device, without waiting for it."""
    if rec is None or not _T.on or not rec.slots:
        return
    ring = _T.ring
    if ring is None or rec.buf.data_ptr() != ring.buf.data_ptr():
        return
    n = len(rec.slots)
    ring.rows[ring.next, :n].copy_(ring.buf[:n], non_blocking=True)
    ring.layouts[ring.next] = tuple(rec.slots)
    ring.next = (ring.next + 1) % RING


def live_lane_share(counts: dict):
    """Σ_k live.d<k> / (depths × live.d0): the share of the lanes that
    every depth runs over that hold a live ray; None without counts."""
    live = {int(m.group(1)): v for k, v in counts.items()
            if (m := _LIVE.match(k))}
    if not live or not live.get(0):
        return None
    return sum(live.values()) / (len(live) * live[0])


def snapshot() -> dict:
    """The operator's view: `spans` ({name: {total_ms, self_ms, count}}),
    `frames` (frames in the ring), `stage_ms` on the card or
    `host_stage_ms` on the CPU ({stage: mean ms a frame}), the frame's
    first to last mark under `frame_ms` / `host_frame_ms`, `counts`
    ({name: mean a frame}), `live_lane_share`, and where a clock ran,
    `clock_ms` on the card or `host_clock_ms` on the CPU ({name:
    {total_ms, count}}).  Waits for the device."""
    out = {"spans": {k: {"total_ms": _T.total[k] / 1e6,
                         "self_ms": _T.self_ns[k] / 1e6,
                         "count": _T.count[k]} for k in _T.total}}
    ring = _T.ring
    filled = [] if ring is None else [
        i for i in range(RING) if ring.layouts[i] is not None]
    stages: dict[str, float] = collections.defaultdict(float)
    counts: dict[str, float] = collections.defaultdict(float)
    span_ns = 0
    if filled:
        if ring.device.type == "cuda":
            torch.cuda.synchronize(ring.device)
        rows = ring.rows.cpu().tolist()
        for i in filled:
            marks = []
            for (kind, name), v in zip(ring.layouts[i], rows[i]):
                if kind == "mark":
                    marks.append((name, v))
                else:
                    counts[name] += v
            for (name, a), (_, b) in zip(marks, marks[1:]):
                stages[name] += b - a
            span_ns += marks[-1][1] - marks[0][1]
    n = len(filled)
    host = ring is not None and ring.device.type != "cuda"
    out["frames"] = n
    out["host_stage_ms" if host else "stage_ms"] = {
        k: v / 1e6 / n for k, v in stages.items()}
    out["host_frame_ms" if host else "frame_ms"] = (span_ns / 1e6 / n
                                                    if n else None)
    out["counts"] = {k: v / n for k, v in counts.items()}
    out["live_lane_share"] = live_lane_share(out["counts"])
    _T.settle(wait=True)
    for kind, key in (("device", "clock_ms"), ("host", "host_clock_ms")):
        if _T.clocks[kind]:
            out[key] = {k: {"total_ms": ms, "count": n}
                        for k, (ms, n) in _T.clocks[kind].items()}
    return out
