"""BENCHMARK.json and the files it names, found by name.

A cell is one entry of `workloads`: a configuration (`configs/<name>.json`)
under a traffic mix (`traffic/<name>.json`), judged by the limits in
`limits/<cell>.json`.  A per-layer metric is read by
`metrics/<name>.py`.  A later change adds a cell, a configuration, a
traffic mix or a metric by adding files and entries; nothing here names
one.
"""
from __future__ import annotations

import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(text, what: str, errors: list) -> None:
    if not (isinstance(text, str) and 1 <= len(text) <= 200
            and "\n" not in text and "\t" not in text):
        errors.append(f"{what}: 1 to 200 characters on one line")


def validate(m: dict) -> list[str]:
    """The contract's rules on the manifest's form; [] when it keeps
    them."""
    errors: list[str] = []
    if set(m) != TOP_KEYS:
        errors.append(f"top-level keys {sorted(m)}")
    cmd = m.get("command", [])
    if not (isinstance(cmd, list) and 1 <= len(cmd) <= 32):
        errors.append("command: 1 to 32 strings")
    for w in cmd:
        _line(w, "command word", errors)
        if isinstance(w, str) and (w.startswith("/") or ".." in w):
            errors.append(f"command word {w!r} leaves the checkout")
    if not (isinstance(m.get("run_seconds"), int)
            and 1 <= m["run_seconds"] <= 51):
        errors.append("run_seconds: a whole number from 1 to 51")
    names = set()
    for part, keys in _KEYS.items():
        for e in m.get(part, []):
            extra = set(e) - keys - ({"workloads"} if part in
                                     ("end_to_end", "per_layer") else set())
            if extra or not keys <= set(e):
                errors.append(f"{part} {e.get('name')}: keys {sorted(e)}")
            name = e.get("name", "")
            if not NAME_RE.match(str(name)):
                errors.append(f"{part}: bad name {name!r}")
            if (part, name) in names:
                errors.append(f"{part}: {name} twice")
            names.add((part, name))
            if "unit" in e and not UNIT_RE.match(str(e["unit"])):
                errors.append(f"{name}: bad unit {e['unit']!r}")
            if "better" in e and e["better"] not in ("lower", "higher"):
                errors.append(f"{name}: better is lower or higher")
            if "source" in e and part != "configs":
                allowed = SOURCES_E2E if part == "end_to_end" else SOURCES
                if e["source"] not in allowed:
                    errors.append(f"{name}: source {e['source']}")
            for k in ("why", "layer"):
                if k in e:
                    _line(e[k], f"{name}.{k}", errors)
    metric_names = [e["name"] for e in m.get("end_to_end", [])] + \
        [e["name"] for e in m.get("per_layer", [])]
    if len(metric_names) != len(set(metric_names)):
        errors.append("two metrics share a name")
    configs = {c["name"] for c in m.get("configs", [])}
    cells = {w["name"] for w in m.get("workloads", [])}
    pairs = set()
    for w in m.get("workloads", []):
        if w.get("config") not in configs:
            errors.append(f"{w['name']}: unknown config {w.get('config')}")
        for k in ("config", "traffic"):
            if not NAME_RE.match(str(w.get(k, ""))):
                errors.append(f"{w['name']}: bad {k}")
        if w.get("chips") not in (1, 4):
            errors.append(f"{w['name']}: chips is 1 or 4")
        pair = (w.get("config"), w.get("traffic"))
        if pair in pairs:
            errors.append(f"{w['name']}: config and traffic twice")
        pairs.add(pair)
    e2e = {e["name"] for e in m.get("end_to_end", [])}
    if "setup_s" not in e2e:
        errors.append("no setup_s")
    for e in m.get("end_to_end", []):
        b = e.get("bound")
        if not (isinstance(b, (int, float)) and 0.01 <= b <= 0.25):
            errors.append(f"{e['name']}: bound {b}")
    for e in m.get("per_layer", []):
        if e.get("moves") not in e2e:
            errors.append(f"{e['name']}: moves {e.get('moves')}")
        for c in e.get("workloads", []):
            if c not in cells:
                errors.append(f"{e['name']}: unknown cell {c}")
    return errors


def cell(m: dict, name: str) -> dict:
    for w in m["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def _json(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


def config(name: str) -> dict:
    return _json("configs", name)


def traffic(name: str) -> dict:
    return _json("traffic", name)


def limits(cell_name: str) -> dict:
    return _json("limits", cell_name)


def metrics_for(m: dict, cell_name: str, kind: str) -> list[dict]:
    """The `kind` ('end_to_end' or 'per_layer') metrics that the cell
    reports: those without a `workloads` list, and those whose list
    names it."""
    return [e for e in m[kind]
            if "workloads" not in e or cell_name in e["workloads"]]


def reader(name: str):
    """The `read(ctx)` function of metrics/<name>.py."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"rtbench_metric_{re.sub(r'[^A-Za-z0-9_]', '_', name)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
