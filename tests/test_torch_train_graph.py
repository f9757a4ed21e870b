"""The port's training programs (hrt_tpu_torch/graphs.py programs whose
bodies train: the upscaler's steps; and the trainer's renders) on the
CPU.

- The port's Adam (models/upscaler.Adam) against optax's `adam` through
  JAX's jitted `train_step` / `train_step_temporal`, over 3 steps
  through the runner, from step 0 and from a state in the middle of
  training carried across by utils/interop.adam_from_numpy (the
  recurrent update's loss and gradients against scripts/
  train_upscaler.py's `seq_step` are in test_torch_train_loop.py; here
  the update through the runner equals it op by op).
- Training bodies in the runner with a stand-in for the capture
  (`stand_in`: test_torch_frame_graph's StandIn, which leaves the
  optimizer's state as it found it, as a CUDA graph's capture runs no
  kernel): spatial, temporal and recurrent steps bit for bit against the
  same steps op by op, the state written in place; a capture per key;
  the op-by-op cases.
- The trainer's G-buffer and clean renders (train_upscaler.
  RENDER_PROGRAMS) against the same renders op by op.

The card's graphs against the same bodies op by op are in
test_torch_cuda.py.
"""
import dataclasses
import functools

import numpy as np
import jax.numpy as jnp
import optax
import pytest
import torch
import torch.distributed as dist

from hrt_tpu.models import upscaler as jupscaler
from hrt_tpu_torch import graphs, train_upscaler
from hrt_tpu_torch.models import upscaler
from hrt_tpu_torch.utils.interop import (adam_from_numpy, upscaler_from_numpy,
                                         upscaler_to_numpy)

from test_torch_frame_graph import StandIn
from test_torch_train import flax_numpy
from test_torch_train_loop import _wall_sequence


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Torch on one thread: these small steps spin in OpenMP when the
    suite's workers share the cores (the file took ~98 s of one worker
    in a six-worker run on eight cores, ~15 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.array(a))


def state(opt) -> list:
    """Every tensor a training step writes."""
    return [*opt.params, *opt.grads, *opt.mu, *opt.nu, opt.count]


def stand_in(*opts):
    """A capture on the CPU for training bodies: the StandIn, which also
    runs the body at capture, after which the state of `opts` is put
    back (a CUDA graph's capture launches nothing)."""

    class Capture(StandIn):
        def __init__(self, body, args, device):
            saved = [[t.detach().clone() for t in state(o)] for o in opts]
            super().__init__(body, args, device)
            with torch.no_grad():
                for o, ts in zip(opts, saved):
                    for t, s in zip(state(o), ts):
                        t.copy_(s)

    return Capture


@pytest.fixture
def train_programs(monkeypatch):
    """Install a stand-in TRAIN_PROGRAMS for the given optimizers."""
    def install(*opts):
        progs = graphs.Programs(8, capture=stand_in(*opts))
        monkeypatch.setattr(upscaler, "TRAIN_PROGRAMS", progs)
        return progs
    return install


def _batches(temporal: bool, n: int, seed: int = 5):
    """n (lr, [hist,] hr) batches of 4 16x16 -> 32x32 samples."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        hr = rs.uniform(0, 2, (4, 32, 32, 3)).astype(np.float32)
        lr = (hr.reshape(4, 16, 2, 16, 2, 3).mean((2, 4))
              + rs.normal(0, 0.05, (4, 16, 16, 3))).astype(np.float32)
        if not temporal:
            out.append((lr, hr))
            continue
        hist = np.concatenate([hr * rs.uniform(0.8, 1.2, hr.shape),
                               rs.rand(4, 32, 32, 1) < 0.7],
                              -1).astype(np.float32)
        hist[..., :3] *= hist[..., 3:]
        out.append((lr, hist, hr))
    return out


def _opt_numpy(opt_state) -> dict:
    """optax's adam state (JAX's TrainState.opt_state) as the numpy dict
    adam_from_numpy reads."""
    s = opt_state[0]
    return {"count": np.asarray(s.count),
            **{f"{m}/{k}": v for m in ("mu", "nu")
               for k, v in flax_numpy(getattr(s, m)).items()}}


def _state_errs(net, opt, jstate) -> tuple:
    """(params, mu, nu) largest abs differences against JAX's state; the
    counts must be equal."""
    s = _opt_numpy(jstate.opt_state)
    assert int(opt.count) == int(s["count"])
    got = {"params": upscaler_to_numpy(net)}
    for m in ("mu", "nu"):
        names = [f"{n}/{f}" for n, _ in net.named_children()
                 for f in ("kernel", "bias")]
        ts = [t.permute(2, 3, 1, 0) if t.dim() == 4 else t
              for t in getattr(opt, m)]
        got[m] = dict(zip(names, (t.detach().numpy() for t in ts)))
    want = {"params": flax_numpy(jstate.params),
            **{m: {k[len(m) + 1:]: v for k, v in s.items()
                   if k.startswith(m + "/")} for m in ("mu", "nu")}}
    return tuple(max(float(np.abs(got[m][k] - want[m][k]).max())
                     for k in want[m]) for m in ("params", "mu", "nu"))


@pytest.fixture(scope="module")
def jax_nets():
    """JAX's spatial and temporal nets, each (net, TrainState, tx) with
    optax's adam at lr 2e-3 (the trainer's) in its initial state, the
    parameters the port's seed-3 nets' (flax's own init takes seconds
    to trace; test_torch_train.py holds the port's init to it)."""
    out = []
    for temporal in (False, True):
        make = upscaler.create_temporal if temporal else upscaler.create
        flat = upscaler_to_numpy(make(seed=3, device="cpu")[0])
        params = {"params": {}}
        for k, v in flat.items():
            conv, f = k.split("/")
            params["params"].setdefault(conv, {})[f] = jnp.asarray(v)
        tx = optax.adam(2e-3)
        net = (jupscaler.TemporalUpscalerNet() if temporal
               else jupscaler.UpscalerNet())
        out.append((net, jupscaler.TrainState(params, tx.init(params),
                                              jnp.zeros((), jnp.int32)),
                    tx))
    return out


@pytest.mark.parametrize("start", [0, 2])
@pytest.mark.parametrize("temporal", [False, True])
def test_steps_through_the_runner_match_optax(jax_nets, train_programs,
                                              temporal, start):
    """3 steps of train_step (train_step_temporal) through the runner
    against JAX's jitted step, from step 0 (upscaler.adam) and from
    JAX's state after 2 steps (adam_from_numpy): every loss within rtol
    1e-5, the parameters after each step within atol 2e-5 (1% of the
    learning rate: Adam's step g / (|g| + eps) has a slope of 1 / eps
    where the gradient is near eps, and the two packages' gradients
    differ in their last bits), the moments within 1e-4 of their
    largest entry (the gradients' gate in test_torch_train.py), the
    counts equal; one capture.  Measured after the third step:
    parameters 1.3e-7 / 3.0e-8 spatial (from step 0 / 2), 3.7e-6 / 8.4e-8
    temporal, moments 4.4e-8 to 1.2e-6 of their largest entry (with
    flax's own init, 9.3e-6 temporal from step 0, on a kernel entry
    whose first gradient is -2.1e-9)."""
    jnet, jstate, tx = jax_nets[temporal]
    jstep = jupscaler.train_step_temporal if temporal else \
        jupscaler.train_step
    step = upscaler.train_step_temporal if temporal else upscaler.train_step
    batches = _batches(temporal, start + 3)
    for b in batches[:start]:
        jstate, _ = jstep(jstate, jnet, tx, *map(jnp.asarray, b))
    net = upscaler_from_numpy(flax_numpy(jstate.params), temporal, "cpu")
    net.requires_grad_(True).train()
    opt = (adam_from_numpy(_opt_numpy(jstate.opt_state), net, 2e-3)
           if start else upscaler.adam(net, 2e-3))
    progs = train_programs(opt)
    for b in batches[start:]:
        jstate, jl = jstep(jstate, jnet, tx, *map(jnp.asarray, b))
        loss = float(step(net, opt, *map(_t, b)))
        assert abs(loss - float(jl)) <= 1e-5 * abs(float(jl))
        p_err, mu_err, nu_err = _state_errs(net, opt, jstate)
        assert p_err <= 2e-5
        mu_max = max(float(m.abs().max()) for m in opt.mu)
        nu_max = max(float(n.abs().max()) for n in opt.nu)
        assert mu_err <= 1e-4 * mu_max and nu_err <= 1e-4 * nu_max
    assert progs.captures == 1 and int(opt.count) == start + 3
    print("state errors (params abs, mu rel, nu rel):", p_err,
          mu_err / mu_max, nu_err / nu_max)


def _sequences(n: int = 4):
    """Two n-frame 8x8 -> 16x16 sequences of one shape (the trainer's
    two orbits): the wall sequence and a darker copy."""
    _, a = _wall_sequence(n, 8, 8)
    b = (a[0] * 0.5, a[1], a[2], a[3], a[4] * 0.75)
    return a, b


def _stepper(kind: str):
    """(make, step(net, opt, i)) of a kind: step i of the 3 takes batch
    i (the recurrent kind: the sequences in turn)."""
    if kind == "recurrent":
        seqs = _sequences()
        return upscaler.create_temporal, lambda net, opt, i: \
            train_upscaler.recurrent_finetune(net, opt, [seqs[i % 2]], 1)[0]
    temporal = kind == "temporal"
    batches = [tuple(map(_t, b)) for b in _batches(temporal, 3, seed=8)]
    step = upscaler.train_step_temporal if temporal else upscaler.train_step
    make = upscaler.create_temporal if temporal else upscaler.create
    return make, lambda net, opt, i: float(step(net, opt, *batches[i]))


@pytest.mark.parametrize("kind", ["spatial", "temporal", "recurrent"])
def test_captured_steps_equal_op_by_op(train_programs, capsys, kind):
    """Steps through the runner against the same steps inside
    graphs.disable(), from equal nets: each loss and every tensor of the
    state bit for bit after each of 3 steps (the first the warm-up, the
    others replays with new batches copied in), the state's tensors at
    the addresses they had, one capture and two replays."""
    make, step = _stepper(kind)
    (net_g, opt_g), (net_e, opt_e) = (make(seed=3, device="cpu")
                                      for _ in range(2))
    progs = train_programs(opt_g)
    ptrs = [t.data_ptr() for t in state(opt_g)]
    replays = StandIn.replays
    for i in range(3):
        with graphs.disable():
            want = step(net_e, opt_e, i)
        got = step(net_g, opt_g, i)
        assert got == want
        assert all(torch.equal(a, b)
                   for a, b in zip(state(opt_g), state(opt_e)))
    capsys.readouterr()
    assert progs.captures == 1 and StandIn.replays == replays + 2
    assert [t.data_ptr() for t in state(opt_g)] == ptrs
    assert int(opt_g.count) == 3
    assert all(p.grad is g for p, g in zip(net_g.parameters(), opt_g.grads))


def test_a_capture_per_key(train_programs):
    """A new capture for another net (its addresses), another learning
    rate on the same tensors, another batch shape; none for new batches
    of a shape seen; a gradient set to None is put back before the
    step."""
    (net, opt), (net2, opt2) = (upscaler.create(seed=1, device="cpu")
                                for _ in range(2))
    progs = train_programs(opt, opt2)
    (lr, hr), (lr2, hr2) = (tuple(map(_t, b))
                            for b in _batches(False, 2, seed=2))
    upscaler.train_step(net, opt, lr, hr)
    upscaler.train_step(net, opt, lr2, hr2)
    assert progs.captures == 1
    upscaler.train_step(net2, opt2, lr, hr)
    assert progs.captures == 2
    upscaler.train_step(net, dataclasses.replace(opt, lr=5e-4), lr, hr)
    assert progs.captures == 3
    upscaler.train_step(net, opt, lr[:2], hr[:2])
    assert progs.captures == 4
    net.zero_grad(set_to_none=True)
    upscaler.train_step(net, opt, lr, hr)
    assert progs.captures == 4 and net.Conv_0.weight.grad is opt.grads[0]


def test_steps_run_op_by_op_where_they_must(train_programs, monkeypatch,
                                            tmp_path, capsys):
    """No capture inside graphs.disable() (a spatial step and a plain
    recurrent update, recurrent_loss with `plain=True`, the reference
    step), over a process group (gloo, one rank), and for CPU tensors
    with the card's capture, whose step equals the same step inside
    graphs.disable()."""
    (net, opt), (ref, ref_opt) = (upscaler.create_temporal(seed=4,
                                                           device="cpu")
                                  for _ in range(2))
    progs = train_programs(opt)
    lr, hist, hr = map(_t, _batches(True, 1)[0])
    with graphs.disable():
        upscaler.train_step_temporal(net, opt, lr, hist, hr)
        upscaler.update(net, opt, functools.partial(
            train_upscaler.recurrent_loss, plain=True), _sequences()[0])
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        upscaler.train_step_temporal(net, opt, lr, hist, hr,
                                     group=dist.group.WORLD)
    finally:
        dist.destroy_process_group()
    capsys.readouterr()
    assert progs.captures == 0 and int(opt.count) == 3
    card = graphs.Programs(1)
    monkeypatch.setattr(upscaler, "TRAIN_PROGRAMS", card)
    loss = upscaler.train_step_temporal(ref, ref_opt, lr, hist, hr)
    (net2, opt2) = upscaler.create_temporal(seed=4, device="cpu")
    with graphs.disable():
        want = upscaler.train_step_temporal(net2, opt2, lr, hist, hr)
    assert card.captures == 0 and torch.equal(loss, want)
    assert all(torch.equal(a, b) for a, b in zip(state(ref_opt),
                                                 state(opt2)))


def test_render_programs_equal_op_by_op(monkeypatch):
    """render_sequence through RENDER_PROGRAMS (stand-in captures) and
    inside graphs.disable(): every frame, G-buffer field and camera bit
    for bit; two captures (render_gb, render_clean), each replayed for
    the later frame and dropped at the end of the call; the frame index
    a 0-d tensor, f and 1000 + f."""
    progs = graphs.Programs(2, capture=StandIn)
    monkeypatch.setattr(train_upscaler, "RENDER_PROGRAMS", progs)
    orig, seen = train_upscaler.render_rows, []

    def spy(*args, frame=0, **kw):
        seen.append((isinstance(frame, torch.Tensor) and frame.dim() == 0,
                     int(frame)))
        return orig(*args, frame=frame, **kw)

    monkeypatch.setattr(train_upscaler, "render_rows", spy)
    replays = StandIn.replays
    kw = dict(size=(16, 16), scene_kind="cornell", clean_spp=1,
              device="cpu")
    got = train_upscaler.render_sequence(2, **kw)
    assert progs.captures == 2 and StandIn.replays == replays + 2
    assert progs.last is None
    assert all(t for t, _ in seen)
    assert sorted({f for _, f in seen}) == [0, 1, 1000, 1001]
    with graphs.disable():
        want = train_upscaler.render_sequence(2, **kw)
    assert progs.captures == 2
    for a, b in zip(got, want):
        if isinstance(a, list):
            assert all(torch.equal(x, y) for c, d in zip(a, b)
                       for x, y in zip(c, d))
        else:
            assert torch.equal(a, b)
    assert not torch.equal(got[0][0], got[0][1])
    assert set(got[2].unique().tolist()) <= {0.0, 1.0}
