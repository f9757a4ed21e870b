import json
import os
import shutil

import pytest

from rtbench import manifest


@pytest.fixture(scope="module")
def bench():
    return manifest.load()


def test_manifest_keeps_the_contract(bench):
    assert manifest.validate(bench) == []


def test_every_cell_resolves_by_name(bench):
    for cell in bench["workloads"]:
        cfg = manifest.config(cell["config"])
        assert cfg["name"] == cell["config"]
        tr = manifest.traffic(cell["traffic"])
        assert {"render", "camera", "check"} <= set(tr)
        lim = manifest.limits(cell["name"])
        assert lim["numbers"]
        for kind in ("end_to_end", "per_layer"):
            assert manifest.metrics_for(bench, cell["name"], kind)
        for m in manifest.metrics_for(bench, cell["name"], "per_layer"):
            assert callable(manifest.reader(m["name"]))


def test_config_files_are_the_ones_named(bench):
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(manifest.ROOT, c["file"]))
        assert c["file"] == f"rtbench/configs/{c['name']}.json"
        assert manifest.config(c["name"])["reduced"] == c["reduced"]


@pytest.mark.parametrize("name,ok", [
    ("frame_ms", True), ("dispatch_ms.train", True), ("_x-1", True),
    ("a b", False), ("a,b", False), ("a/b", False), ("", False),
    ("µs", False), ("x" * 65, False)])
def test_names_use_only_allowed_characters(name, ok):
    assert bool(manifest.NAME_RE.match(name)) is ok


@pytest.mark.parametrize("unit,ok", [
    ("ms", True), ("tokens/s", True), ("%", True), ("share", True),
    ("launches", True), ("per second", False), ("µs", False),
    ("x" * 17, False)])
def test_units_use_only_allowed_characters(unit, ok):
    assert bool(manifest.UNIT_RE.match(unit)) is ok


def test_validate_refuses_a_bad_manifest(bench):
    bad = json.loads(json.dumps(bench))
    bad["workloads"].append(dict(bad["workloads"][0]))
    bad["end_to_end"][0]["bound"] = 0.5
    bad["per_layer"][0]["moves"] = "nothing"
    errors = manifest.validate(bad)
    assert any("twice" in e for e in errors)
    assert any("bound" in e for e in errors)
    assert any("moves" in e for e in errors)


def test_new_cell_and_metric_are_found_from_added_files(tmp_path,
                                                         monkeypatch, bench):
    """A later change adds a traffic mix, a cell's limits and a metric
    reader as new files, and entries in BENCHMARK.json: no file of the
    harness changes."""
    here = tmp_path / "rtbench"
    shutil.copytree(manifest.HERE, here,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    monkeypatch.setattr(manifest, "HERE", str(here))
    tr = manifest.traffic("pt1080_still")
    tr["render"]["max_depth"] = 2
    (here / "traffic" / "pt1080_d2.json").write_text(json.dumps(tr))
    (here / "limits" / "bench_scene.pt1080_d2.json").write_text(
        json.dumps(manifest.limits("bench_scene.pt1080_still")))
    (here / "metrics" / "frames_traced.py").write_text(
        "def read(ctx):\n    return ctx['frames']\n")
    new = json.loads(json.dumps(bench))
    new["workloads"].append({"name": "bench_scene.pt1080_d2",
                             "config": "bench_scene", "traffic": "pt1080_d2",
                             "chips": 1, "why": "depth 2"})
    new["per_layer"].append({"name": "frames_traced", "unit": "frames",
                             "better": "higher", "source": "host_clock",
                             "layer": "frame loop, host step",
                             "moves": "frame_ms",
                             "workloads": ["bench_scene.pt1080_d2"]})
    assert manifest.validate(new) == []
    cell = manifest.cell(new, "bench_scene.pt1080_d2")
    assert manifest.traffic(cell["traffic"])["render"]["max_depth"] == 2
    assert manifest.limits(cell["name"])["numbers"]
    names = [m["name"] for m in
             manifest.metrics_for(new, cell["name"], "per_layer")]
    assert "frames_traced" in names
    assert "frames_traced" not in [
        m["name"] for m in
        manifest.metrics_for(new, "bench_scene.pt1080_still", "per_layer")]
    assert manifest.reader("frames_traced")({"frames": 7}) == 7
