"""The benchmark's command: one run of one cell on one card.

    python3 rtbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell (BENCHMARK.json, rtbench/configs/, rtbench/traffic/,
rtbench/limits/), builds and warms up the program's frame loop, measures
for `--seconds`, checks the window's frames against the reference, and
prints one JSON line last on standard output: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with `--trace 1`
its per-layer ones), `device`, with `--trace 1` `breakdown`, and
`check` (each compared number with its limit), which it also prints as
its last lines on standard error.

Exits with 2, printing no result, without a CUDA device; with 3 when
JAX, jaxlib, flax or the JAX package `hrt_tpu` is loaded at the start
or once the window has closed.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from rtbench import harness  # noqa: E402


def _guard(when: str) -> None:
    bad = harness.forbidden_modules()
    if bad:
        print(f"rtbench: {', '.join(bad)} loaded {when}; the benchmark runs "
              f"the PyTorch port alone", file=sys.stderr)
        sys.exit(3)


def main(argv=None) -> int:
    _guard("at the start")
    ap = argparse.ArgumentParser(prog="python3 rtbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    from rtbench import manifest

    chips = manifest.cell(manifest.load(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"rtbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" available", file=sys.stderr)
        return 2
    out = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), device="cuda")
    _guard("after the window")
    for name, t in out["check"].items():
        print(f"check {name} {t['value']!r} limit {t['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
