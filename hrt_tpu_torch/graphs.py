"""Frame and training programs captured as CUDA graphs: the port's
counterpart of the JAX package's `jax.jit` frame programs
(hrt_tpu/renderer.py `render_frames`, hrt_tpu/frameloop.py
`frame_program`) and training steps (hrt_tpu/models/upscaler.py
`train_step`, `train_step_temporal`; scripts/train_upscaler.py
`seq_step`, `render_gb`, `render_clean`).

A jit program is compiled once per static config and shape, then
dispatched once per call.  Here a frame body is captured once per key
into a `torch.cuda.CUDAGraph` and replayed afterwards, so a frame's
hundreds to thousands of kernel launches leave the host as one graph
launch.  `Programs` is a bounded cache of captured bodies:

- The key is what the body reads as it was captured: the caller's key
  (the config and whatever else is static), the pytree structure of the
  arguments, each argument tensor's shape, dtype and device, and, for
  the tensors the body closes over (scene, accel, net), their addresses
  (`signature`).  A new key captures again; the least recently used
  program is dropped past the cache's size, and its memory pool with it.
- The first call of a key runs the body once op by op under
  `torch.no_grad()` (the warm-up: it loads CUDA's lazily loaded kernels
  and creates cuDNN's handles, and its result is the call's result),
  then captures the body on a side stream into the memory pool that
  every capture on the device shares (`_pool`).
  Nothing of autograd is recorded in a frame: the upscaler's parameters
  require gradients, and the body runs without them.  A training step
  (models/upscaler.py `update`) turns gradients on inside its body, so
  its graph holds the forward, autograd's backward (whose kernels go to
  the stream of their forward, the capture's) and the optimizer's
  update, and its output is the detached loss.  Such a body writes only
  tensors made before the capture (the parameters, their gradients, the
  optimizer's moments and count), in place, and its key holds their
  addresses.
- Every later call copies its arguments into the graph's static input
  tensors (`copy_` on the device; a Python int, the frame index, by
  `fill_`, which needs no host copy), replays the graph, and returns
  fresh copies of the outputs: a replay overwrites the pool, so nothing
  returned aliases it, and a frame kept from one call stays as it was
  after the next.
- One pool for every live graph of a device: a graph's intermediates are dead
  once its outputs are copied out, so another capture may reuse their
  memory, and the graphs together hold the largest frame's memory, not
  the sum of all of theirs.  This holds because the replays run on one
  stream, one after another, and nothing a body makes outlives its
  replay but its outputs, which stay allocated: a training body's
  persistent state is made outside the pool, before its capture.
- The kernel wrappers' launch counters (`LAUNCHES` of K1 to K7) count
  launches on the card, replayed or not: the counters' change during a
  capture (host code that ran once, launching nothing) is taken back
  and added again at every replay.
- A capture or a replay that fails raises.  Nothing retries op by op.
- With tracing on (utils/tracing.py), a call's copies in, its replay
  and its copies out are the host spans `graphs.copy_in`,
  `graphs.replay` and `graphs.copy_out`, and a capture `graphs.capture`.

The same runner replays the device-side builds that change what a frame
reads: the TLAS refit (ops/tlas.py `refit_body`, the counterpart of JAX's
jitted `refit_two_level`) and the culling LBVH rebuild (ops/lbvh.py
`rebuild_body`, of JAX's jitted `build_bvh`).  Their bodies write an
accel's own tensors in place, so the frame programs captured over it
read the new tables and are not captured again.

A body over a process group (the tiled frame and the sharded closest
hit gather across ranks, a data-parallel step all-reduces its
gradients) passes the group to the runner, which keys it by the group's
`signature` (backend, world size, this rank, the group's name and which
group object it is) and captures it only where the capture class can
hold the group's backend (`CudaGraph.backends`: NCCL, whose kernels a
CUDA graph records like any other).  Gloo stages its collectives
through the host, which no CUDA graph can hold, so a body over a gloo
group runs op by op, on CUDA tensors too; that is what gloo is, not a
fallback.  Over NCCL:
- The communicator must exist before the capture: NCCL makes a group's
  communicator at its first collective, which is not capturable.  The
  warm-up makes it (its collectives run op by op), and the port's
  collectives (parallel/tiles.gather_rows, models/upscaler._average)
  call `collective` first, which records the group op by op and raises
  inside a capture when none was recorded: such a capture fails at once
  and never hangs.
- Ranks are bound: every rank captures at the same call of the same
  key.  The warm-up executes its collectives and the capture executes
  none, so a rank that captured alone would leave the others waiting in
  theirs.  So what changes a key changes on every rank at once: the
  config, the shapes, a culling rebuild over replicated data, the
  least-recently-used drops of a cache that sees the same calls.
- `capture_error_mode="thread_local"`: NCCL's watchdog thread queries
  CUDA events while a capture is open, which the global mode would
  fail.

A frame or a step runs op by op (the body called directly, under
no_grad, which a training body overrides) on CPU tensors, inside
`disable()` (the counterpart of `jax.disable_jit()`, which the checks
use to hold a graph against the same body op by op, and the way to run
a plain reference step), under the walks' debug builds
(`HRT_KERNEL_GUARDS`, `HRT_DEBUG_COUNTERS`: they keep host state per
launch), over a group whose backend the capture cannot hold (gloo), and
where the caller says so: `plain=True` (the plain versions of the
kernels on the card).  Nothing else runs op by op.

`constant` holds the small host constants that the frame's code puts on
the device (a copy from pageable host memory cannot be captured).
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import time
import weakref
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.utils import _pytree as pytree

from .utils import tracing

_disabled = 0
_capturing = 0
_constants: dict = {}
_pools: dict = {}
# id(group) -> (group, serial): the group is held, so its id is never
# another group's while this process runs.
_groups: dict = {}
# (group signature, device) pairs whose communicator a collective made.
_communicators: set = set()


@contextlib.contextmanager
def disable():
    """Run every frame body op by op inside the block (nesting allowed)."""
    global _disabled
    _disabled += 1
    try:
        yield
    finally:
        _disabled -= 1


def _debug_builds() -> bool:
    from .ops import intersect, traversal_wide8

    return bool(traversal_wide8.GUARDS or intersect.DEBUG_COUNTERS)


def launch_counters() -> list[dict]:
    """The kernel wrappers' launch counters, K1 to K7."""
    from .ops import (bounce_kernel, shade_kernel, traversal_skip,
                      traversal_tlas8, traversal_tlas_skip, traversal_wide8,
                      warp_kernel)

    return [m.LAUNCHES for m in (traversal_wide8, shade_kernel,
                                 traversal_skip, traversal_tlas8,
                                 traversal_tlas_skip, warp_kernel,
                                 bounce_kernel)]


def constant(values, device, dtype=torch.float32) -> torch.Tensor:
    """`values` (a number or a tuple of them) as a tensor on `device`,
    copied from the host once per process and kept: code on the frame
    path takes its constants from here, since a copy from pageable host
    memory cannot be captured.  Read-only."""
    key = (values, dtype, torch.device(device))
    t = _constants.get(key)
    if t is None:
        t = _constants[key] = torch.tensor(values, dtype=dtype,
                                           device=device)
    return t


def signature(obj) -> Any:
    """What a captured body reads of `obj`, as a hashable value: each
    tensor's shape, dtype, device and address, through NamedTuples,
    dataclasses, tuples, lists and modules (their parameters and
    buffers); numbers, strings and None as they are; a numpy array (host
    data, which no graph reads) by its shape and dtype; a process group
    by its backend, world size, this rank, its name and a serial number
    of the group object (a group made anew under the same name has a
    new communicator); a DeviceMesh by its device type, dimension names,
    ranks, this rank's coordinate and its group."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, torch.Tensor):
        return ("tensor", tuple(obj.shape), obj.dtype, obj.device,
                obj.data_ptr(), obj.stride())
    if isinstance(obj, np.ndarray):
        return ("ndarray", obj.shape, obj.dtype.str)
    if isinstance(obj, nn.Module):
        return (type(obj).__name__,) + tuple(
            (k, signature(v)) for k, v in obj.state_dict(
                keep_vars=True).items())
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__,) + tuple(
            signature(getattr(obj, f.name))
            for f in dataclasses.fields(obj))
    if isinstance(obj, (tuple, list)):
        return (type(obj).__name__,) + tuple(signature(v) for v in obj)
    if isinstance(obj, dist.ProcessGroup):
        entry = _groups.setdefault(id(obj), (obj, len(_groups)))
        return ("ProcessGroup", str(dist.get_backend(obj)), obj.size(),
                obj.rank(), obj.group_name, entry[1])
    from torch.distributed.device_mesh import DeviceMesh

    if isinstance(obj, DeviceMesh):
        return ("DeviceMesh", obj.device_type, obj.mesh_dim_names,
                tuple(obj.mesh.flatten().tolist()), obj.get_local_rank(),
                signature(obj.get_group()))
    raise TypeError(f"no capture signature for {type(obj).__name__}")


def collective(group, device) -> None:
    """Called by the port's collectives just before they run on `group`
    for tensors on `device`.  Op by op it records that the group's
    communicator exists there (NCCL makes it at the first collective);
    inside a capture it raises RuntimeError when none was recorded, since
    a communicator cannot be made inside a capture and the capture would
    otherwise fail inside NCCL or wait on the other ranks."""
    key = (signature(group), torch.device(device))
    if not _capturing:
        _communicators.add(key)
    elif key not in _communicators:
        raise RuntimeError(
            f"a collective on {key[0]} in a capture, but no communicator "
            "was made on this rank: run one op by op first (the "
            "program's warm-up does)")


def _node_count(graph: torch.cuda.CUDAGraph) -> int:
    """The captured graph's node count (the driver's cuGraphGetNodes)."""
    n = ctypes.c_size_t(0)
    rc = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes: CUDA driver error {rc}")
    return n.value


def _pool(device: torch.device) -> tuple:
    """(device index, the memory pool that every live capture on it
    shares, the set of those captures).  Torch releases a pool once
    every graph captured into it is gone and refuses to capture into its
    handle again, so a new pool is opened then."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if index not in _pools or not _pools[index][1]:
        _pools[index] = (torch.cuda.graph_pool_handle(), weakref.WeakSet())
    return (index, *_pools[index])


class CudaGraph:
    """A body captured on the card: `outputs` are the graph's static
    output tensors, which `replay()` overwrites.  `capture_ms` is the
    host time of the capture and instantiation, `nodes` the graph's node
    count."""

    device_type = "cuda"
    # The process groups whose collectives a graph can hold.
    backends = frozenset({"nccl"})

    def __init__(self, body: Callable, args, device: torch.device):
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        stream = torch.cuda.Stream(device)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        stream.wait_stream(torch.cuda.current_stream(device))
        index, pool, members = _pool(device)
        with torch.cuda.stream(stream):
            self.graph.capture_begin(pool=pool,
                                     capture_error_mode="thread_local")
            members.add(self)
            try:
                self.outputs = body(*args)
            except BaseException:
                # End the invalidated capture and the allocator's routing of
                # this stream's allocations into the pool, which
                # capture_end leaves on when the capture failed.  The pool
                # still counts as recording after that (torch refuses to
                # capture into it again), so later captures take a new
                # one; the graphs already in it replay as before.  Then
                # raise the body's error.
                with contextlib.suppress(RuntimeError):
                    self.graph.capture_end()
                with contextlib.suppress(RuntimeError):
                    torch._C._cuda_endAllocateToPool(index, pool)
                _pools.pop(index, None)
                raise
            self.graph.capture_end()
        torch.cuda.current_stream(device).wait_stream(stream)
        self.nodes = _node_count(self.graph)
        self.graph.instantiate()
        torch.cuda.synchronize(device)
        self.capture_ms = (time.perf_counter() - t0) * 1e3

    def replay(self) -> None:
        self.graph.replay()


class Program:
    """One body captured for one key: its static inputs, the flattened
    outputs' structure, and the launches one replay makes (per counter,
    per key).  `first` is the warm-up's result, fresh tensors."""

    def __init__(self, body: Callable, flat: list, spec, device,
                 capture=CudaGraph):
        global _capturing
        self.static = [None if x is None else _as_tensor(x, device).clone()
                       for x in flat]
        args = pytree.tree_unflatten(self.static, spec)
        with torch.no_grad():
            self.first = pytree.tree_map(_fresh, body(*args))
        counters = launch_counters()
        before = [dict(c) for c in counters]
        _capturing += 1
        try:
            with torch.no_grad(), tracing.span("graphs.capture"):
                self.graph = capture(body, args, device)
        finally:
            _capturing -= 1
            self.launches = [{k: c[k] - b[k] for k in c}
                             for c, b in zip(counters, before)]
            for c, b in zip(counters, before):
                c.update(b)
        self.out_flat, self.out_spec = pytree.tree_flatten(
            self.graph.outputs)

    def __call__(self, flat: list):
        """Copy the call's arguments into the static inputs, replay, and
        return copies of the outputs."""
        with tracing.span("graphs.copy_in"):
            for s, x in zip(self.static, flat):
                if isinstance(x, torch.Tensor):
                    s.copy_(x)
                elif x is not None:
                    s.fill_(x)
        with tracing.span("graphs.replay"):
            self.graph.replay()
        for c, d in zip(launch_counters(), self.launches):
            for k, v in d.items():
                c[k] += v
        with tracing.span("graphs.copy_out"):
            return pytree.tree_unflatten(
                [_fresh(t) for t in self.out_flat], self.out_spec)


def capture_line(what: str, programs: "Programs") -> str | None:
    """The line an entry point prints after its warm-up: the last
    capture's host ms and node count and the captures so far; None where
    nothing was captured (a frame op by op)."""
    prog = programs.last
    if prog is None:
        return None
    g = prog.graph
    return (f"capture: {what}: {g.capture_ms:.1f} ms, {g.nodes} nodes, "
            f"{programs.captures} capture(s)")


def _fresh(t):
    return None if t is None else t.clone()


def _as_tensor(x, device) -> torch.Tensor:
    """An argument leaf as a tensor: a Python int (a frame index) as a
    0-d int64 tensor made on the device by a fill; None stays None."""
    if x is None or isinstance(x, torch.Tensor):
        return x
    if isinstance(x, int) and not isinstance(x, bool):
        return torch.full((), x, dtype=torch.int64, device=device)
    raise TypeError(f"a frame program takes tensors and ints, not "
                    f"{type(x).__name__}")


def _leaf_key(x):
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype, x.device)
    return None if x is None else "int"


class Programs:
    """A cache of at most `size` captured bodies, the least recently used
    dropped first.  `captures` counts this cache's captures and `last`
    is the program of the last call through a graph (its `graph.
    capture_ms` and `graph.nodes`).  `capture` makes a capture
    (CudaGraph; the CPU tests pass a stand-in whose `device_type` is
    "cpu", and whose `backends`, empty when it has none, name the
    process groups it can hold)."""

    def __init__(self, size: int, capture=CudaGraph):
        self.size = size
        self.capture = capture
        self.captures = 0
        self.last: Program | None = None
        self._cache: collections.OrderedDict = collections.OrderedDict()

    def clear(self) -> None:
        """Drop every program (its outputs' memory goes back to the
        device's shared pool)."""
        self._cache.clear()
        self.last = None

    def enabled(self, device, group=None) -> bool:
        """Whether a body on `device`, over the process `group` or none,
        goes through a graph: the capture's device type, outside
        disable(), neither debug build on, and a group's backend one the
        capture can hold."""
        return (torch.device(device).type == self.capture.device_type
                and not _disabled and not _debug_builds()
                and (group is None or str(dist.get_backend(group)) in getattr(
                    self.capture, "backends", frozenset())))

    def __call__(self, key, body: Callable, args, device, group=None,
                 eager: bool = False):
        """body(*args) -> a pytree of tensors: replayed from the graph of
        this key (captured at its first call, after an op-by-op warm-up
        whose result that call returns), or called op by op (see the
        module's docstring).  `args` is a tuple of tensors, ints (made
        0-d int64 tensors on `device`), None, and lists and NamedTuples
        of them.  `group`: the process group whose collectives the body
        runs, part of the key."""
        device = torch.device(device)
        flat, spec = pytree.tree_flatten(args)
        if eager or not self.enabled(device, group):
            with torch.no_grad():
                return body(*pytree.tree_unflatten(
                    [_as_tensor(x, device) for x in flat], spec))
        full = (key, signature(group), repr(spec),
                tuple(_leaf_key(x) for x in flat))
        prog = self._cache.get(full)
        if prog is not None:
            self._cache.move_to_end(full)
            self.last = prog
            return prog(flat)
        while len(self._cache) >= self.size:
            self._cache.popitem(last=False)
        prog = Program(body, flat, spec, device, self.capture)
        self._cache[full] = prog
        self.captures += 1
        self.last = prog
        out, prog.first = prog.first, None
        return out
