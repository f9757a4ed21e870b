"""The walks' debug builds on the CPU, against the JAX package's.

Guards (HRT_KERNEL_GUARDS=1): the port's plain BVH8 walk
(traversal_wide8.trace_plain) on the tables of JAX's own guard test
(tests/test_wide8.py: `_wide8_accel(4)`, 220 triangles in 8-triangle
leaves, 256 rays), corrupted as that test corrupts them, raises through
`check_pending_guards()` with the JAX kernel's mask bits; clean tables
stay silent and give the unguarded walk's results bit for bit.  JAX's
kernel runs once per corruption in interpret mode (a module fixture).
Counters (HRT_DEBUG_COUNTERS=1): the plain walks of K1, K3 and K4 keep
`visit_counts`' counts as LAST_COUNTERS.  The render command checks the
guards after each frame.  The kernels' debug builds are held to their
normal builds on a card in test_torch_cuda.py."""
import dataclasses
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrt_tpu.ops import traversal_pallas as tp
from hrt_tpu.ops import traversal_wide8 as jtw
from hrt_tpu_torch import cli
from hrt_tpu_torch.ops import (intersect, tlas, traversal_skip,
                               traversal_tlas8, traversal_wide8, wide8)
from hrt_tpu_torch.utils.interop import accel_from_numpy

from test_fuzz import random_rays
from test_torch_build import jax_accel_dict
from test_torch_cuda import _instanced_scene, corrupt_w8
from test_torch_native import jax_native_lib
from test_torch_twolevel_redesign import _batch
from test_wide8 import _wide8_accel

T_MIN = 1e-3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _jax_native_sah():
    """JAX's native builder loaded, as every port parity file has it
    (test_torch_native.jax_native_lib)."""
    jax_native_lib()


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    """Each test starts with the debug builds off and no pending guard
    words, and leaves none behind."""
    monkeypatch.setattr(traversal_wide8, "GUARDS", False)
    monkeypatch.setattr(intersect, "DEBUG_COUNTERS", False)
    traversal_wide8._pending_guards.clear()
    yield
    traversal_wide8._pending_guards.clear()


@pytest.fixture(scope="module")
def guard_case():
    """JAX's guard-test accel and rays, the port's accel carried over
    from it, and the mask bits JAX's guarded kernel records for each
    corruption of the per-child leg (HRT_W8_PACK=0)."""
    data, jacc, _, _, _ = _wide8_accel(4)
    o, d = random_rays(4, n=256)
    rec = np.asarray(jacc.w8)
    jax_bits = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HRT_WIDE8_CPU", "1")
        mp.setenv("HRT_KERNEL_GUARDS", "1")
        mp.setenv("HRT_W8_PACK", "0")
        mp.setattr(tp, "WIDE8", True)
        for how in ("base", "leaf"):
            bad = jacc.replace(w8=jnp.asarray(corrupt_w8(rec, how)))
            jtw._pending_violations.clear()
            out = tp.closest_hit(data, bad, jnp.asarray(o), jnp.asarray(d),
                                 T_MIN, 1e32)
            np.asarray(out[0])
            jax_bits[how] = int(np.bitwise_or.reduce(np.concatenate(
                [v.ravel() for v in jtw._pending_violations])))
            jtw._pending_violations.clear()
    acc = accel_from_numpy(jax_accel_dict(jacc), jacc.leaf_size, "cpu")
    n = o.shape[0]
    planes = [torch.as_tensor(np.ascontiguousarray(a)) for a in
              (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2])]
    planes.append(torch.full((n,), 1e32))
    return {"accel": acc, "planes": planes, "jax_bits": jax_bits,
            "rec": rec}


def _with_table(acc, rec: np.ndarray):
    w8 = torch.as_tensor(rec)
    return dataclasses.replace(acc, w8=w8, w8_rec=wide8.node_records(w8))


def _shadow(planes):
    """Segments of the same rays to t = 5, for the any-hit walk."""
    return planes[:6] + [torch.full_like(planes[6], 5.0)]


def _mask_of(err: pytest.ExceptionInfo) -> int:
    return int(re.search(r"mask (0x[0-9a-f]+)", str(err.value)).group(1), 16)


@pytest.mark.parametrize("how", ["base", "leaf"])
def test_guards_raise_with_jax_bits(guard_case, how, monkeypatch):
    """A corrupt root base (bit 1) or leaf start (bit 4): JAX's guarded
    kernel and the port's guarded plain walk record the same bits, and
    the port raises through check_pending_guards instead of indexing
    past its tables."""
    jax_bits = guard_case["jax_bits"][how]
    assert jax_bits == {"base": traversal_wide8.NODE_ID,
                        "leaf": traversal_wide8.LEAF_START}[how]
    acc = _with_table(guard_case["accel"], corrupt_w8(guard_case["rec"], how))
    monkeypatch.setattr(traversal_wide8, "GUARDS", True)
    t, tri, _, _ = traversal_wide8.trace(acc, *guard_case["planes"], T_MIN,
                                         True)
    assert t.shape == tri.shape == (256,)
    with pytest.raises(RuntimeError, match="guard violation") as err:
        traversal_wide8.check_pending_guards()
    assert _mask_of(err) == jax_bits
    assert re.search(r"in blocks \[\d", str(err.value))


@pytest.mark.parametrize("closest", [True, False], ids=["closest", "any"])
@pytest.mark.parametrize("how", ["clean", "pack"])
def test_guards_silent_and_bit_equal(guard_case, how, closest,
                                     monkeypatch):
    """On the clean table, and on the word that only JAX's pack mode
    reads (the port's walk never reads slot 1's word 7), the guarded
    walk records nothing and returns the clean unguarded walk's results
    bit for bit."""
    planes = guard_case["planes"] if closest \
        else _shadow(guard_case["planes"])
    clean = guard_case["accel"]
    want = traversal_wide8.trace(clean, *planes, T_MIN, closest)
    acc = clean if how == "clean" \
        else _with_table(clean, corrupt_w8(guard_case["rec"], how))
    monkeypatch.setattr(traversal_wide8, "GUARDS", True)
    got = traversal_wide8.trace(acc, *planes, T_MIN, closest)
    assert len(traversal_wide8._pending_guards) == 1
    traversal_wide8.check_pending_guards()
    assert traversal_wide8._pending_guards == []
    if closest:
        for a, b in zip(got, want):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert (want[1] >= 0).float().mean() > 0.2
    else:
        assert torch.equal(got, want) and 0.05 < want.float().mean() < 0.95


def test_understated_depth_overflows_the_stack(guard_case, monkeypatch):
    """A w8_depth below the tree's: the walk's stack is too short for
    it, bit 2, and the walk still ends."""
    acc = dataclasses.replace(guard_case["accel"], w8_depth=0)
    monkeypatch.setattr(traversal_wide8, "GUARDS", True)
    traversal_wide8.trace(acc, *guard_case["planes"], T_MIN, True)
    with pytest.raises(RuntimeError, match="stack-overflow") as err:
        traversal_wide8.check_pending_guards()
    assert _mask_of(err) == traversal_wide8.STACK_OVERFLOW


def test_check_pending_guards_clears_its_list(guard_case, monkeypatch):
    """Words of several walks are ORed with the blocks that set them;
    the check clears the list whether it raises or not, so the next
    check is silent."""
    monkeypatch.setattr(traversal_wide8, "GUARDS", True)
    base = _with_table(guard_case["accel"],
                       corrupt_w8(guard_case["rec"], "base"))
    planes = guard_case["planes"]
    traversal_wide8.trace(guard_case["accel"], *planes, T_MIN, True)
    traversal_wide8.trace(base, *planes, T_MIN, True)
    traversal_wide8.trace(dataclasses.replace(guard_case["accel"],
                                              w8_depth=0),
                          *planes, T_MIN, True)
    assert len(traversal_wide8._pending_guards) == 3
    with pytest.raises(RuntimeError) as err:
        traversal_wide8.check_pending_guards()
    assert _mask_of(err) == (traversal_wide8.NODE_ID
                             | traversal_wide8.STACK_OVERFLOW)
    assert traversal_wide8._pending_guards == []
    traversal_wide8.check_pending_guards()
    traversal_wide8.trace(guard_case["accel"], *planes, T_MIN, True)
    traversal_wide8.check_pending_guards()
    assert traversal_wide8._pending_guards == []


@pytest.fixture(scope="module")
def two_level():
    """The test_tlas scene's unified BVH8 two-level table, 8-triangle
    leaves."""
    return tlas.build_two_level_flat(_instanced_scene(), 8, device="cpu")


@pytest.mark.parametrize("closest", [True, False], ids=["closest", "any"])
@pytest.mark.parametrize("walk", ["k1", "k3", "k4"])
def test_plain_walks_keep_their_counts(guard_case, two_level, walk, closest,
                                       monkeypatch):
    """Under HRT_DEBUG_COUNTERS the plain walks of K1, K3 and K4 keep
    their visit_counts (the table's order) as LAST_COUNTERS, int32 under
    the module's COUNTS, and their results do not change."""
    mod, table = {"k1": (traversal_wide8, guard_case["accel"]),
                  "k3": (traversal_skip, guard_case["accel"]),
                  "k4": (traversal_tlas8, two_level)}[walk]
    planes = guard_case["planes"] if closest \
        else _shadow(guard_case["planes"])
    if walk == "k4":
        planes = _batch(closest, n=256)
    want = mod.trace(table, *planes, T_MIN, closest)
    monkeypatch.setattr(mod, "LAST_COUNTERS", None)
    monkeypatch.setattr(intersect, "DEBUG_COUNTERS", True)
    got = mod.trace(table, *planes, T_MIN, closest)
    counts = mod.visit_counts(table, *planes, T_MIN, closest)
    counts.pop("hits", None)
    last = mod.LAST_COUNTERS
    assert tuple(last) == mod.COUNTS == tuple(counts)
    for key in mod.COUNTS:
        assert last[key].dtype == torch.int32
        assert torch.equal(last[key].long(), counts[key]), key
    assert int(last["tests"].sum()) > 0
    if closest:
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    else:
        assert torch.equal(got, want)


def test_debug_switches_read_the_environment():
    """HRT_KERNEL_GUARDS=1 and HRT_DEBUG_COUNTERS=1 in the environment
    turn the port's switches on when it is imported (off otherwise)."""
    code = ("from hrt_tpu_torch.ops import intersect, traversal_wide8 as t; "
            "print(t.GUARDS, intersect.DEBUG_COUNTERS)")
    env = {k: v for k, v in os.environ.items()
           if k not in ("HRT_KERNEL_GUARDS", "HRT_DEBUG_COUNTERS")}
    outs = []
    for extra in ({}, {"HRT_KERNEL_GUARDS": "1", "HRT_DEBUG_COUNTERS": "1"}):
        run = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                             env={**env, **extra}, capture_output=True,
                             text=True, timeout=120)
        assert run.returncode == 0, run.stderr
        outs.append(run.stdout.split())
    assert outs == [["False", "False"], ["True", "True"]]


@pytest.mark.parametrize("violation", [False, True],
                         ids=["clean", "violation"])
def test_render_command_checks_the_guards(tmp_path, violation, monkeypatch):
    """`python -m hrt_tpu_torch.render` with HRT_KERNEL_GUARDS=1 checks
    the guards after every frame: silent on the demo scene, with PNGs
    equal to the unguarded run's; a violation raises."""
    argv = ["--scene", "demo", "--sky", "--width", "64", "--height", "48",
            "--frames", "2", "--device", "cpu"]
    cli.main(argv + ["--out", str(tmp_path / "plain.png")])
    monkeypatch.setattr(traversal_wide8, "GUARDS", True)
    checks, words = [], []
    check = traversal_wide8.check_pending_guards

    def spy():
        checks.append(len(traversal_wide8._pending_guards))
        words.extend(traversal_wide8._pending_guards)
        check()

    monkeypatch.setattr(traversal_wide8, "check_pending_guards", spy)
    if violation:
        walk = traversal_wide8.trace_plain

        def corrupt_walk(*args, **kw):
            out = walk(*args, **kw)
            traversal_wide8._pending_guards[-1][0] |= \
                traversal_wide8.LEAF_START
            return out

        monkeypatch.setattr(traversal_wide8, "trace_plain", corrupt_walk)
        with pytest.raises(RuntimeError, match="leaf-start"):
            cli.main(argv + ["--out", str(tmp_path / "g.png")])
        assert checks == [2]
        return
    cli.main(argv + ["--out", str(tmp_path / "g.png")])
    # Each frame: a closest and an any-hit walk, guarded and clean.
    assert checks == [2, 2] and not any(bool(w.any()) for w in words)
    for f in range(2):
        a = (tmp_path / f"plain_{f:04d}.png").read_bytes()
        assert a == (tmp_path / f"g_{f:04d}.png").read_bytes()
