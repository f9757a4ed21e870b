"""Instanced, animated scenes at a size the CPU holds: rotated instances
and instance grids in a configuration, the two-level frame loop, instance
motion in the traffic, and the reference that follows it.

The grid runs through an existing cell's code path with overrides: a
3 x 3 grid of rotated icospheres on a ground plane, two of them moving,
traced by the two-level loop.  The plain program passes, and the
bfloat16 control, a `set_instance_transform` that does nothing and a
scene whose rotations are dropped do not."""
import copy
import json
import math

import numpy as np
import pytest
import torch

from hrt_tpu_torch.frameloop import FrameLoop
from hrt_tpu_torch.models.scene import instance_grid_scene
from rtbench import devtrace, geometry, harness, manifest, workload
from rtbench.check import Judge, verdict
from rtbench.reference import pathtrace
from rtbench.tests.test_rtbench_check import small

CELL = "bigmesh_2m6.direct1080_orbit"
SEED = 3000000019


def grid_config(n: int) -> dict:
    """instance_grid_scene(n) as configuration keys."""
    return {
        "meshes": {"big": {"kind": "icosphere", "subdivisions": 2},
                   "ground": {"kind": "plane", "size": 30.0}},
        "lights": [{"position": [0.0, -6.0, -2.0], "color": [1.0, 1.0, 1.0],
                    "intensity": 60.0}],
        "instances": [{"mesh": "ground", "material": "white",
                       "position": [0.0, 1.0, 0.0]}],
        "instance_grids": [{"mesh": "big", "materials": ["white", "metal"],
                            "n": n, "spacing": 1.2, "height": 0.5,
                            "scale": [0.25, 0.15], "rotation_max": 3.14,
                            "seed": 7}],
    }


def animated() -> dict:
    """The cell's overrides at the CPU's size, with the 3 x 3 grid on
    the two-level loop and two instances moving."""
    ov = small(CELL)
    ov["config"] = harness._merge(ov.get("config", {}), {
        **grid_config(3), "accel": "two_level",
        "views": {"orbit": {"radius": 3.0, "height": -1.5,
                            "target": [-0.6, 0.5, -0.6]}}})
    ov["traffic"]["animate"] = {"instances": 2, "period": 16, "lift": 0.6,
                                "spin": 1}
    return ov


@pytest.mark.parametrize("n", [3, 16])
def test_grid_expansion_is_instance_grid_scene(n):
    cfg = {**grid_config(n), "materials": manifest.config("bigmesh_2m6")
           ["materials"]}
    ours = harness.program_scene(geometry.scene_arrays(cfg))
    port = instance_grid_scene(n)
    assert len(ours.instances) == len(port.instances) == 1 + n * n
    for a, b in zip(ours.instances, port.instances):
        assert (a.mesh_id, a.material_id) == (b.mesh_id, b.material_id)
        for f in ("position", "rotation", "scale"):
            assert np.array_equal(np.asarray(getattr(a, f), np.float64),
                                  np.asarray(getattr(b, f), np.float64)), f
        assert np.array_equal(a.transform, b.transform)
    for a, b in zip(ours.meshes, port.meshes):
        assert np.array_equal(a.vertices, b.vertices)
        assert np.array_equal(a.indices, b.indices)
    assert all(np.array_equal(a, b) for a, b in zip(ours.materials,
                                                    port.materials))
    assert all(np.array_equal(a, b) for a, b in zip(ours.lights,
                                                    port.lights))
    assert geometry.num_triangles(geometry.scene_arrays(cfg)) == \
        2 + 320 * n * n


def _flatten_unrotated(scene, device):
    """The placement as it was before instances took a rotation: one
    instance at a time, a diagonal scale and a translation."""
    mat_ids = {name: i for i, name in enumerate(scene.materials)}
    mats = np.stack([pathtrace.material_record(m)
                     for m in scene.materials.values()])
    parts = {k: [] for k in ("v0", "e1", "e2", "n0", "n1", "n2", "uv0",
                             "uv1", "uv2", "mat")}
    for inst in scene.instances:
        mesh = scene.meshes[inst["mesh"]]
        m = np.zeros((3, 4), np.float32)
        m[:, :3] = np.eye(3, dtype=np.float32) * np.asarray(
            inst.get("scale", (1.0, 1.0, 1.0)), np.float32)[None, :]
        m[:, 3] = inst.get("position", (0.0, 0.0, 0.0))
        nm = np.linalg.inv(m[:, :3]).T.astype(np.float32)
        pos = mesh.positions @ m[:, :3].T + m[:, 3]
        nrm = mesh.normals @ nm.T
        nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True),
                               1e-12)
        i0, i1, i2 = (mesh.indices[:, k] for k in range(3))
        parts["v0"].append(pos[i0])
        parts["e1"].append(pos[i1] - pos[i0])
        parts["e2"].append(pos[i2] - pos[i0])
        for k, ik in zip(("n0", "n1", "n2"), (i0, i1, i2)):
            parts[k].append(nrm[ik])
        for k, ik in zip(("uv0", "uv1", "uv2"), (i0, i1, i2)):
            parts[k].append(mesh.uvs[ik])
        parts["mat"].append(np.full(mesh.indices.shape[0],
                                    mat_ids[inst["material"]], np.int64))
    cat = {k: np.concatenate(v) for k, v in parts.items()}
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    v0, e1, e2 = f32(cat["v0"]), f32(cat["e1"]), f32(cat["e2"])
    attr = torch.cat([f32(cat[k]) for k in ("n0", "n1", "n2", "uv0", "uv1",
                                            "uv2")]
                     + [f32(cat["mat"][:, None]), f32(mats[cat["mat"]])],
                     dim=1)
    centre = v0 + (e1 + e2) * (1.0 / 3.0)
    r = torch.stack([torch.linalg.vector_norm(p - centre, dim=1)
                     for p in (v0, v0 + e1, v0 + e2)]).amax(0)
    return {"v0": v0, "e1": e1, "e2": e2, "attr": attr, "centre": centre,
            "reach2": (r * (1.0 + 1e-5) + 1e-4) ** 2}


@pytest.mark.parametrize("name", ["bench_scene", "bigmesh_2m6"])
def test_unrotated_scenes_flatten_bit_for_bit_as_before(name):
    cfg = manifest.config(name)
    if name == "bigmesh_2m6":
        cfg["meshes"]["big"]["subdivisions"] = 3
    zero = copy.deepcopy(cfg)
    for inst in zero["instances"]:
        inst["rotation"] = [0.0, 0.0, 0.0]
    before = _flatten_unrotated(geometry.scene_arrays(cfg), "cpu")
    for c in (cfg, zero):
        sc = pathtrace.flatten(geometry.scene_arrays(c), "cpu")
        for k, v in before.items():
            got = getattr(sc, k)
            assert torch.equal(got.view(torch.int32), v.view(torch.int32)), k


def test_posed_instances_over_a_base_flatten_as_a_whole():
    arrays = geometry.scene_arrays({**grid_config(4), "materials":
                                    manifest.config("bigmesh_2m6")
                                    ["materials"]})
    poses = {3: ((0.1, -0.3, 0.2), (0.5, 1.0, -0.7), (0.3, 0.3, 0.3)),
             11: ((2.0, 0.1, -1.0), (0.0, 4.0, 0.2), (0.2, 0.2, 0.2))}
    base = pathtrace.flatten(arrays, "cpu")
    whole = pathtrace.flatten(arrays, "cpu", poses)
    over = pathtrace.flatten(arrays, "cpu", poses, base=base)
    for k in ("v0", "e1", "e2", "attr", "centre", "reach2", "inst_centre",
              "inst_reach2"):
        assert torch.equal(getattr(whole, k).view(torch.int32),
                           getattr(over, k).view(torch.int32)), k
        assert not torch.equal(getattr(whole, k), getattr(base, k)), k
    assert torch.equal(whole.inst_tri, over.inst_tri)


def test_rotated_instances_place_as_the_program_does():
    """The reference's own Euler-YXZ matrices and placement against the
    program's world-space soup (`Scene.build_host`) of the same grid,
    moved by a pose."""
    arrays = geometry.scene_arrays({**grid_config(3), "materials":
                                    manifest.config("bigmesh_2m6")
                                    ["materials"]})
    pose = {4: ((0.1, -0.3, 0.2), (0.5, 1.0, -0.7), (0.3, 0.3, 0.3))}
    sc = pathtrace.flatten(arrays, "cpu", pose)
    prog = harness.program_scene(arrays)
    prog.instances[4].position, prog.instances[4].rotation, \
        prog.instances[4].scale = pose[4]
    host, _ = prog.build_host()
    for ours, theirs in ((sc.v0, "tri_v0"), (sc.e1, "tri_e1"),
                         (sc.e2, "tri_e2"), (sc.attr[:, 0:3], "nrm0")):
        assert torch.allclose(ours, torch.from_numpy(host[theirs]),
                              rtol=0, atol=2e-6), theirs


def test_culled_hits_equal_every_pair():
    """The instance-sphere cull keeps every hit: closest hits and
    occlusion equal Moller-Trumbore over every (ray, triangle) pair."""
    arrays = geometry.scene_arrays({**grid_config(3), "materials":
                                    manifest.config("bigmesh_2m6")
                                    ["materials"]})
    sc = pathtrace.flatten(arrays, "cpu", {2: ((-1.8, 0.0, -0.6),
                                               (0.3, 2.0, 0.1),
                                               (0.4, 0.4, 0.4))})
    g = torch.Generator().manual_seed(5)
    n = 1024
    o = torch.randn(n, 3, generator=g) * 2.0 + torch.tensor([-0.6, -1.5,
                                                             -0.6])
    d = torch.randn(n, 3, generator=g) * 0.8 + torch.tensor([-0.6, 0.5,
                                                             -0.6]) - o
    o3, d3 = pathtrace.V3(*o.T), pathtrace.V3(*d.T)
    t, tri, u, v = pathtrace.intersect(sc, o3, d3, 1e-3, pathtrace.INF,
                                       closest=True)
    occ = pathtrace.intersect(sc, o3, d3, 1e-3, 2.5, closest=False)
    nt = sc.v0.shape[0]
    ray = torch.arange(n).repeat_interleave(nt)
    tr = torch.arange(nt).repeat(n)
    hit, tt, _, _ = pathtrace._moller_trumbore(
        pathtrace._as_v3(o[ray]), pathtrace._as_v3(d[ray]),
        pathtrace._as_v3(sc.v0[tr]), pathtrace._as_v3(sc.e1[tr]),
        pathtrace._as_v3(sc.e2[tr]), 1e-3, pathtrace.INF)
    tt = torch.where(hit, tt, pathtrace.INF).reshape(n, nt)
    best = tt.amin(1)
    assert (tri >= 2).sum() > n // 10      # the spheres, past the ground
    assert torch.equal(t, best)
    first = torch.where(tt == best[:, None], torch.arange(nt), nt).amin(1)
    assert torch.equal(tri, torch.where(best < pathtrace.INF, first, -1))
    assert torch.equal(occ, (tt < 2.5).any(1))


def test_poses_are_a_function_of_the_seed_and_the_frame():
    cfg = {**grid_config(4), "materials": {}}
    tr = {"camera": {"path": "still"}, "animate": {
        "instances": 3, "period": 8, "lift": 0.5, "spin": 1,
        "near": [1.0, 0.5, -0.5]}}
    cfg["views"] = {"still": {"position": [0, 0, 0], "rotation": [0, 0, 0]}}
    a, b = workload.Plan(tr, cfg, SEED), workload.Plan(tr, cfg, SEED)
    assert a.poses(5) == b.poses(5) and len(a.poses(5)) == 3
    other = workload.Plan(tr, cfg, SEED + 1)
    assert set(other.poses(0)) == set(a.poses(0))
    assert other.poses(0) != a.poses(0)
    insts = geometry.instance_list(cfg)
    for i in (0, 3):
        for idx, (pos, rot, scale) in a.poses(i).items():
            base = insts[idx]
            up = base["position"][1] - pos[1]
            assert 0.0 <= up <= 0.5 and pos[0] == base["position"][0]
            assert scale == base["scale"] and rot[0] == base["rotation"][0]
        assert a.poses(i + 8) == a.poses(i)
    tr.pop("animate")
    assert workload.Plan(tr, cfg, SEED).poses(3) == {}
    with pytest.raises(ValueError):
        workload.Plan({**tr, "animate": {"instances": 17, "period": 8,
                                         "lift": 0.5, "spin": 1,
                                         "near": [0, 0, 0]}},
                      cfg, SEED)


def test_the_movers_are_the_grid_instances_nearest_the_view():
    """The movers depend on the configuration and the traffic, not the
    seed: the grid instances nearest `near`, by default the orbit's
    target, the lower index first at equal distance; never an explicit
    instance."""
    cfg = {**grid_config(4), "materials": {},
           "views": {"orbit": {"radius": 3.0, "height": -1.5,
                               "target": [0.6, 0.0, 0.6]}}}
    insts = geometry.instance_list(cfg)
    tr = {"camera": {"path": "orbit", "frames_per_orbit": 16},
          "animate": {"instances": 5, "period": 8, "lift": 0.5, "spin": 1}}
    # The grid runs -2.4 .. 1.2 in 1.2 steps: (0.0, 0.0) and (1.2, 1.2)
    # ... lie 0.6 * sqrt(2) from the target, indices 1 + 4i + j.
    want = [1 + 4 * 2 + 2, 1 + 4 * 2 + 3, 1 + 4 * 3 + 2, 1 + 4 * 3 + 3]
    for seed in (SEED, SEED + 1, 7):
        pick = workload.movers(tr["animate"], cfg, insts)
        assert pick[:4] == sorted(want) and len(pick) == 5
        assert list(workload.Plan(tr, cfg, seed).moving) == pick
    d = [math.dist(insts[i]["position"], (0.6, 0.5, 0.6)) for i in pick]
    assert d == sorted(d) and d[4] > d[3]
    assert workload.movers({**tr["animate"], "near": [-2.4, 0.5, -2.4]},
                           cfg, insts)[0] == 1
    cfg.pop("views")
    with pytest.raises(ValueError):
        workload.movers(tr["animate"], cfg, insts)


def test_the_animated_two_level_grid_is_correct():
    ov = animated()
    prep = harness.prepare(CELL, torch.device("cpu"), ov)
    assert prep.loop.two_level and not math.isnan(prep.accel_build_s)
    out = harness.run(CELL, SEED, 1.0, False, device="cpu", overrides=ov)
    assert out["correct"], out["check"]
    assert out["attempted"] >= 1


def _window(seed):
    prep = harness.prepare(CELL, torch.device("cpu"), animated())
    return prep, harness.window(prep, seed, 1.0)


def test_checked_frames_carry_the_poses_the_program_was_given():
    prep, win = _window(SEED + 4)
    plan = workload.Plan(prep.traffic, prep.config, SEED + 4)
    assert win.records
    for rec in win.records:
        assert rec["poses"] == plan.poses(rec["i"]) and len(rec["poses"]) == 2
    last = win.records[-1]
    for idx, (pos, rot, scale) in last["poses"].items():
        inst = prep.loop.scene_obj.instances[idx]
        assert (inst.position, inst.rotation, inst.scale) == (pos, rot,
                                                              scale)


def test_the_control_on_the_animated_grid_is_not_correct():
    prep, win = _window(SEED + 8)
    judge = Judge(prep.scene, prep.traffic, prep.limits, prep.device)
    ok, table = verdict(judge.numbers(win.records, SEED + 8,
                                      shade_dtype=torch.bfloat16),
                        prep.limits)
    assert not ok, table


def _no_motion(self, idx, position=None, rotation=None, scale=None):
    """An instance that never moves."""


def _rotation_dropped(orig):
    def program_scene(arrays):
        return orig(arrays._replace(instances=[
            {k: v for k, v in inst.items() if k != "rotation"}
            for inst in arrays.instances]))
    return program_scene


@pytest.mark.parametrize("fault", ["no_motion", "rotation_dropped"])
def test_a_broken_instanced_path_is_not_correct(fault, monkeypatch):
    if fault == "no_motion":
        monkeypatch.setattr(FrameLoop, "set_instance_transform", _no_motion)
    else:
        monkeypatch.setattr(harness, "program_scene",
                            _rotation_dropped(harness.program_scene))
    out = harness.run(CELL, SEED + 12, 1.0, False, device="cpu",
                      overrides=animated())
    assert not out["correct"], out["check"]


def test_small_shrinks_instance_grids_and_motion(monkeypatch):
    cfg = {**manifest.config("bigmesh_2m6"), **grid_config(182)}
    tr = {**manifest.traffic("direct1080_orbit"),
          "animate": {"instances": 16, "period": 64, "lift": 0.5,
                      "spin": 1}}
    monkeypatch.setattr(manifest, "config", lambda name: copy.deepcopy(cfg))
    monkeypatch.setattr(manifest, "traffic", lambda name: copy.deepcopy(tr))
    ov = small(CELL)
    assert [g["n"] for g in ov["config"]["instance_grids"]] == [3]
    assert ov["config"]["instance_grids"][0]["seed"] == 7
    assert ov["traffic"]["animate"] == {"instances": 2}
    merged = harness._merge(tr, ov["traffic"])
    assert json.dumps(merged["animate"], sort_keys=True) == json.dumps(
        {"instances": 2, "period": 64, "lift": 0.5, "spin": 1},
        sort_keys=True)


@pytest.mark.parametrize("symbol,entry", [
    ("tlas8_closest_kernel", "hrt_tlas8_trace"),
    ("tlas8_any_hit_kernel", "hrt_tlas8_trace"),
    ("tlas_skip_trace_kernel<true>", "hrt_tlas_skip_trace")])
def test_two_level_walks_count_as_walks_not_glue(symbol, entry):
    label = devtrace.op_label(f"void (anonymous namespace)::{symbol}(Args)")
    assert devtrace.entry_of(label) == entry
    st = devtrace.Stretch([devtrace.Op(label, 0.0, 0.003),
                           devtrace.Op("elementwise", 0.003, 0.004)], 1,
                          0.0, 0.005, [])
    ctx = {"stretch": st}
    assert manifest.reader("walk_ms")(ctx) == pytest.approx(3.0)
    assert manifest.reader("glue_ms")(ctx) == pytest.approx(1.0)
