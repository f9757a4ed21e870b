"""The comparison at a size the CPU holds: the program's plain path
passes, the bfloat16 control fails, and a run whose timed path is
broken underneath comes out not correct, for each fault a one-card
frame loop can have: an output that stays as it was, a state that
stays as it was (in the cells that carry state from frame to frame),
half of the frame left out, and rows altered where they are made."""
import json
import subprocess
import sys

import pytest
import torch

from hrt_tpu_torch.frameloop import FrameLoop
from rtbench import harness, manifest
from rtbench.check import Judge, verdict

CELLS = [c["name"] for c in manifest.load()["workloads"]]


def stateful(cell: str) -> bool:
    """Whether the cell's frame carries state to the next: accumulation,
    SVGF's history or the upscaler's."""
    r = manifest.traffic(manifest.cell(manifest.load(), cell)["traffic"]) \
        ["render"]
    return bool(r.get("accumulate") or r.get("denoise")
                or r.get("upscale_mode") == "temporal")


def small(cell: str) -> dict:
    """Overrides that bring a cell to a size the CPU holds: a 40 x 24
    frame, 3 checked frames of 256 pixels, the big mesh at 2
    subdivisions, instance grids of 3 x 3 with at most 2 of their
    instances moving."""
    w = manifest.cell(manifest.load(), cell)
    traffic = manifest.traffic(w["traffic"])
    ov = {"traffic": {"render": {"width": 40, "height": 24},
                      "check": {"frames": 3}}}
    if traffic["check"]["pixels"] != "all":
        ov["traffic"]["check"]["pixels"] = 256
    if "animate" in traffic:
        ov["traffic"]["animate"] = {
            "instances": min(int(traffic["animate"]["instances"]), 2)}
    if cell.startswith("bigmesh"):
        ov["config"] = {"meshes": {"big": {"kind": "icosphere",
                                           "subdivisions": 2}}}
    grids = manifest.config(w["config"]).get("instance_grids")
    if grids:
        ov.setdefault("config", {})["instance_grids"] = [
            dict(g, n=min(int(g["n"]), 3)) for g in grids]
    return ov


@pytest.mark.parametrize("cell", CELLS)
def test_the_plain_program_is_correct(cell):
    out = harness.run(cell, 3000000019, 0.3, False, device="cpu",
                      overrides=small(cell))
    assert out["correct"], out["check"]
    assert list(out)[-1] == "check"
    assert out["attempted"] >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    prep = harness.prepare(cell, torch.device("cpu"), small(cell))
    judge = Judge(prep.scene, prep.traffic, prep.limits, prep.device)
    win = harness.window(prep, 3000000023, 0.3)
    ok, table = verdict(judge.numbers(win.records, 3000000023,
                                      shade_dtype=torch.bfloat16),
                        prep.limits)
    assert not ok, table


def _unchanged(orig):
    def step(self, camera, plain=False):
        last = getattr(self, "_rtbench_last", None)
        if last is None:
            last = self._rtbench_last = orig(self, camera, plain)
        return last.clone()
    return step


def _state_kept(orig):
    """The frame is made from the state before it, and the new state is
    never written back: the loop hands the same state on every step."""
    def step(self, camera, plain=False):
        kept = (self.accum, self.dn_state, self.up_history)
        out = orig(self, camera, plain)
        self.accum, self.dn_state, self.up_history = kept
        return out
    return step


def _half(orig):
    def step(self, camera, plain=False):
        out = orig(self, camera, plain)
        out[out.shape[0] // 2:] = 0.0
        return out
    return step


def _altered(orig):
    def step(self, camera, plain=False):
        out = orig(self, camera, plain)
        rows = max(1, out.shape[0] // 10)
        out[:rows] += 0.05
        return out
    return step


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    monkeypatch.setattr(FrameLoop, "step", fault(FrameLoop.step))
    out = harness.run(cell, 3000000029, 0.3, False, device="cpu",
                      overrides=small(cell))
    assert not out["correct"], out["check"]


@pytest.mark.parametrize("cell", [c for c in CELLS if stateful(c)])
def test_a_state_kept_unchanged_is_not_correct(cell, monkeypatch):
    monkeypatch.setattr(FrameLoop, "step", _state_kept(FrameLoop.step))
    out = harness.run(cell, 3000000037, 0.3, False, device="cpu",
                      overrides=small(cell))
    assert not out["correct"], out["check"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(card):
    from rtbench.tests.conftest import ROOT
    out = subprocess.run(
        [sys.executable, "rtbench/run.py", "--workload", CELLS[0],
         "--seed", "3000000031", "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
