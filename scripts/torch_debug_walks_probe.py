#!/usr/bin/env python3
"""The walks' debug builds against the kernels they were added to: the
build's cost and the normal instantiations' code, on the machine with
the card's toolkit.

    python3 scripts/torch_debug_walks_probe.py --parent DIR [--out x.json]

DIR holds an earlier commit's `hrt_tpu_torch/csrc/` (every .cu and
.cuh), e.g. the parent of the debug builds':

    mkdir -p chip_scratch/parent_csrc
    for f in $(git ls-tree --name-only HEAD~1 hrt_tpu_torch/csrc/); do
      git show HEAD~1:$f > chip_scratch/parent_csrc/$(basename $f)
    done

Both source sets are compiled as kernels/build.py compiles them (one
nvcc per .cu, all started together, the same flags), in turns (parent,
current, current, parent), each into its own temporary directory; each
turn's wall time and each file's are printed.  Then every kernel
function's ptxas report (registers, spills, stack, shared memory) and
its SASS instruction count (cuobjdump) are set side by side: a kernel
that gained a debug flag (K1 `bvh8_packet_kernel` DEBUG, K3
`skip_trace_kernel` COUNT, K4 `tlas8_closest_kernel` /
`tlas8_any_hit_kernel` COUNT) is matched to the parent's by its other
template arguments, with the flag false; the debug instantiations (flag
true) are listed beside the normal ones.  Exits 1 if a normal
instantiation's report or instruction count differs from the
parent's.  No card is needed.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from hrt_tpu_torch.kernels import build  # noqa: E402

# Kernels with a debug flag as their last template argument.
FLAGGED = ("bvh8_packet_kernel", "skip_trace_kernel", "tlas8_closest_kernel",
           "tlas8_any_hit_kernel")


def compile_all(src_dir: str, out_dir: str) -> dict:
    """nvcc -c of every .cu in src_dir at once, as build.py does: wall
    seconds of the whole and of each file, the objects and the ptxas
    text of each."""
    nvcc = build.nvcc_path()
    cu = sorted(glob.glob(os.path.join(src_dir, "*.cu")))
    t0 = time.perf_counter()
    procs = []
    for src in cu:
        obj = os.path.join(out_dir, os.path.basename(src) + ".o")
        procs.append((src, obj, time.perf_counter(), subprocess.Popen(
            [nvcc, *build.compile_flags(src), "-c", "-o", obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    ends = {}
    while len(ends) < len(procs):   # each file's end, as it comes
        for src, _, _, p in procs:
            if src not in ends and p.poll() is not None:
                ends[src] = time.perf_counter()
        time.sleep(0.01)
    files = {}
    for src, obj, start, p in procs:
        _, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc {src} failed:\n{err}")
        files[os.path.basename(src)] = {
            "s": ends[src] - start, "obj": obj, "ptxas": err}
    return {"s": max(ends.values()) - t0, "files": files}


def demangle(names: list[str]) -> list[str]:
    tool = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    if not os.path.exists(tool):
        tool = shutil.which("c++filt")
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, check=True).stdout.splitlines()
    return out


def short(name: str) -> str:
    """`(anonymous namespace)::k<32, true>(...)` -> `k<32, true>`."""
    name = name.split("::", 1)[-1] if "::" in name else name
    depth = 0
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0:
            return name[:i]
    return name


def ptxas_report(text: str) -> dict:
    """Mangled function -> its ptxas numbers."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = m.group(1)
            out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[cur].update(stack=int(m.group(1)), spill_st=int(m.group(2)),
                            spill_ld=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["regs"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            out[cur]["smem"] = int(s.group(1)) if s else 0
    return out


def sass_counts(obj: str) -> dict:
    """Mangled function -> SASS instructions (cuobjdump -sass)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", obj], capture_output=True,
                          text=True, check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            out[cur] = 0
        elif cur and re.match(r"\s+/\*[0-9a-f]{4}\*/", line):
            out[cur] += 1
    return out


def kernels(result: dict) -> dict:
    """Short demangled name -> {ptxas numbers, sass}, over all files."""
    rows = {}
    for f in result["files"].values():
        rep = ptxas_report(f["ptxas"])
        sass = sass_counts(f["obj"])
        names = list(rep)
        for mangled, pretty in zip(names, demangle(names)):
            rows[short(pretty)] = dict(rep[mangled],
                                       sass=sass.get(mangled, -1))
    return rows


def as_parent(name: str):
    """A current kernel's name as the parent's, and whether it is a debug
    instantiation (its flag true)."""
    base = name.split("<")[0]
    if base not in FLAGGED:
        return name, False
    head, flag = name[:-1].rsplit(", ", 1)
    return head + ">", flag in ("true", "(bool)1")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="directory with the earlier commit's csrc files")
    ap.add_argument("--out", default=None, help="write the JSON here")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi or 'none'}; nvcc {build.nvcc_path()}", flush=True)
    turns = []
    for which in ("parent", "current", "current", "parent"):
        src = args.parent if which == "parent" else build.CSRC_DIR
        with tempfile.TemporaryDirectory() as tmp:
            res = compile_all(src, tmp)
            if not turns or len(turns) == 1:
                res["kernels"] = kernels(res)
            for f in res["files"].values():
                del f["obj"], f["ptxas"]
        turns.append((which, res))
        print(f"  {which}: {res['s']:.2f} s wall; "
              + ", ".join(f"{k} {v['s']:.2f}" for k, v in
                          sorted(res["files"].items())), flush=True)
    parent, current = turns[0][1]["kernels"], turns[1][1]["kernels"]
    walls = {w: [r["s"] for x, r in turns if x == w]
             for w in ("parent", "current")}
    print(f"nvcc wall (all files at once): parent "
          f"{', '.join(f'{s:.2f}' for s in walls['parent'])} s, current "
          f"{', '.join(f'{s:.2f}' for s in walls['current'])} s", flush=True)
    same, rows = True, []
    for name in sorted(current):
        pname, debug = as_parent(name)
        cur = current[name]
        par = None if debug else parent.get(pname)
        ok = debug or par == cur
        same &= ok
        rows.append({"kernel": name, "debug": debug, "current": cur,
                     "parent": par, "unchanged": None if debug else ok})
        print(f"  {'debug ' if debug else ''}{name}: {cur}"
              + ("" if debug else f"; parent {par}; "
                 f"{'unchanged' if ok else 'CHANGED'}"), flush=True)
    missing = sorted(set(parent) - {as_parent(n)[0] for n in current})
    if missing:
        same = False
        print(f"  parent kernels without a counterpart: {missing}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "walls": walls,
                       "files": {w: r["files"] for w, r in turns[:2]},
                       "kernels": rows}, f, indent=1)
    print(json.dumps({"normal_kernels_unchanged": bool(same)}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
