"""The readings that the comparison's limits are set from, on the card:
one process builds a cell once, then for each seed runs a measured
window, reads the program's numbers against the reference, and for the
control seeds also the control's (the reference one precision lower,
put in the program's place, from the same state).  The benchmark's own
runs never run this.

    python3 rtbench/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 1,2,3 --seconds 4 [--out <file>.jsonl]

Prints one JSON line per seed: `program` (number -> share), and for a
control seed `control` (the bfloat16 shading control) and, in a cell
with the upscaler, `control_fp8_upscaler`; with the reference's
seconds (`ref_s`) and the frames of the window.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from rtbench import harness  # noqa: E402
from rtbench.check import Judge  # noqa: E402


def readings(prep, seed: int, seconds: float, control: bool,
             judge: Judge) -> dict:
    win = harness.window(prep, seed, seconds)
    t0 = time.perf_counter()
    rec = {"seed": seed, "frames": win.frames,
           "frame_ms": win.seconds * 1e3 / win.frames,
           "program": judge.numbers(win.records, seed)}
    rec["ref_s"] = time.perf_counter() - t0
    if control:
        rec["control"] = judge.numbers(win.records, seed,
                                       shade_dtype=torch.bfloat16)
        if prep.traffic["render"].get("upscale") == 2:
            rec["control_fp8_upscaler"] = judge.numbers(
                win.records, seed, up_dtype=torch.float8_e4m3fn)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 rtbench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    dev = torch.device(args.device)
    prep = harness.prepare(args.workload, dev)
    judge = Judge(prep.scene, prep.traffic, prep.limits, dev)
    out = open(args.out, "a") if args.out else None
    try:
        for seed in sorted(set(seeds) | ctl):
            rec = {"cell": args.workload,
                   **readings(prep, seed, args.seconds, seed in ctl, judge)}
            line = json.dumps(rec)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
