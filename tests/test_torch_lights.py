"""Many-light next-event estimation of hrt_tpu_torch against the JAX
package on the CPU: the light tree (ops/lightbvh.py) built from the same
light tables, its descent's picks and pdfs on the same uniforms, the
vectorised and per-ray processLight, and sampled-NEE frames (the flat
CDF scan, the tree, "auto", and a path-traced frame whose bounces draw
after the light samples) against JAX's render on the same JAX-built SAH
accel (traversal="bvh", shade_pallas=False, as test_torch_path.py).

Tolerances: the tree's permutation and boxes bit-equal; energies and
the paired-children tables within rtol 1e-6 (XLA on the CPU may
contract the luminance into FMAs); picks equal on >= 0.999 of rays and
pdfs within rtol 1e-6 where they agree; frames at PSNR > 45 (peak 4)
with >= 0.99 of pixels within 1e-3 (the CDF's cumsum may round
differently in XLA and torch and move a few picks to a neighbouring
light).  The JAX frames are rendered once per module.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hrt_tpu.config import RenderConfig as JRenderConfig
from hrt_tpu.models import lights as jlights
from hrt_tpu.models.camera import Camera as JCamera
from hrt_tpu.ops import lbvh as jlbvh, lightbvh as jlightbvh
from hrt_tpu.ops.v3 import V3 as JV3
from hrt_tpu.renderer import render as jrender
from hrt_tpu.utils.image import psnr
from hrt_tpu_torch import renderer
from hrt_tpu_torch.config import RenderConfig
from hrt_tpu_torch.models import lights
from hrt_tpu_torch.models.camera import Camera
from hrt_tpu_torch.models.scene import many_lights_scene
from hrt_tpu_torch.ops import lbvh, lightbvh
from hrt_tpu_torch.ops.v3 import V3
from hrt_tpu_torch.utils.interop import (accel_from_numpy,
                                         light_tree_from_numpy)

from test_torch_build import jax_accel_dict
from test_torch_native import jax_native_lib


@pytest.fixture(scope="module", autouse=True)
def _jax_native_sah():
    """JAX's build_bvh_sah through its native builder, never the LBVH
    fallback (test_torch_native.jax_native_lib)."""
    jax_native_lib()


CAM = dict(position=(0.0, -1.0, -6.0), rotation=(-0.15, 0.0, 0.0))
SMALL = dict(width=48, height=32, sky=True)
# Sampled NEE frames held against JAX's: 2 samples per ray, direct only
# through each sampler, and depth 3 with bounces (the light samples draw
# from the seed before the bounce does).
CASES = {
    "cdf": dict(max_depth=1, light_samples=2, light_sampler="cdf"),
    "bvh": dict(max_depth=1, light_samples=2, light_sampler="bvh"),
    "bounces": dict(max_depth=3, indirect=True, light_samples=2,
                    light_sampler="bvh"),
}


def _jax_many_lights(n: int):
    import sys
    import os

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts"))
    from bench_full import _many_lights_scene

    return _many_lights_scene(n)


def _nine_lights() -> np.ndarray:
    """Nine lights of every type: points (two at one position, so their
    Morton codes tie), a spot, a directional, and a spot without a
    direction (the reference's fixed fallback)."""
    rs = np.random.RandomState(3)
    rows = []
    for k in range(6):
        pos = (2.0, -3.0, 1.0) if k < 2 else tuple(rs.uniform(-4, 4, 3))
        rows.append(lights.make_light(pos, tuple(rs.uniform(0.2, 1, 3)),
                                      float(rs.uniform(1, 20))))
    rows.append(lights.make_light((0.0, -5.0, 0.0), (1.0, 1.0, 1.0), 30.0,
                                  lights.SPOT, (0.0, 1.0, 0.0), 0.6))
    rows.append(lights.make_light((0.0, -50.0, 0.0), (1.0, 0.9, 0.8), 3.0,
                                  lights.DIRECTIONAL, (0.3, 1.0, 0.2)))
    rows.append(lights.make_light((1.0, -2.0, -1.0), (0.5, 0.5, 1.0), 5.0,
                                  lights.SPOT))
    return np.stack(rows)


def _light_table(name: str) -> np.ndarray:
    if name == "9":
        return _nine_lights()
    return np.stack(_jax_many_lights(int(name)).lights)


def _tree_dict(tree) -> dict:
    return {k: (np.asarray(v) if k == "perm"
                else [np.asarray(a) for a in v])
            for k, v in tree._asdict().items()}


@pytest.fixture(scope="module")
def trees():
    """(light table, JAX tree, port tree) per light set.  The JAX trees
    are built eagerly, as the JAX package's Scene.build builds them (a
    jitted build may contract the luminance into FMAs)."""
    out = {}
    for name in ("9", "40", "256"):
        table = _light_table(name)
        out[name] = (table, jlightbvh.build_light_tree(jnp.asarray(table)),
                     lightbvh.build_light_tree(torch.as_tensor(table)))
    return out


@pytest.mark.parametrize("name", ["9", "40", "256"])
def test_light_tree_matches_jax(trees, name):
    table, jt, pt = trees[name]
    assert pt.depth == jt.depth
    np.testing.assert_array_equal(pt.perm.numpy(), np.asarray(jt.perm))
    assert pt.perm.dtype == torch.int32
    for k in range(pt.depth + 1):
        np.testing.assert_array_equal(pt.bmin[k].numpy(),
                                      np.asarray(jt.bmin[k]))
        np.testing.assert_array_equal(pt.bmax[k].numpy(),
                                      np.asarray(jt.bmax[k]))
        for a, b in ((pt.energy[k], jt.energy[k]),
                     (pt.energy_dir[k], jt.energy_dir[k])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    for k in range(pt.depth):
        np.testing.assert_allclose(pt.pair[k].numpy(),
                                   np.asarray(jt.pair[k]), rtol=1e-6)
    # The directional light's energy rides the distance-free channel.
    if name == "9":
        assert float(pt.energy_dir[0][0]) > 0.0
        assert float(pt.energy[0][0]) > 0.0


def test_light_tree_sort_is_stable():
    """Lights that share a Morton code keep their table order."""
    table = np.stack([lights.make_light((1.0, 2.0, 3.0), (1, 1, 1), 1.0)
                      for _ in range(5)])
    tree = lightbvh.build_light_tree(torch.as_tensor(table))
    np.testing.assert_array_equal(tree.perm.numpy(), [0, 1, 2, 3, 4, 4, 4, 4])
    assert float(tree.energy[-1][5:].abs().sum()) == 0.0


@pytest.mark.parametrize("name", ["9", "40", "256"])
def test_sample_light_matches_jax(trees, name):
    table, jt, pt = trees[name]
    rs = np.random.RandomState(5)
    p = rs.uniform(-6, 6, (4096, 3)).astype(np.float32)
    u = rs.uniform(0, 1, 4096).astype(np.float32)
    jpick, jpdf = jlightbvh.sample_light(
        jt, JV3(*(jnp.asarray(p[:, i]) for i in range(3))), jnp.asarray(u))
    for tree in (pt, light_tree_from_numpy(_tree_dict(jt), "cpu")):
        pick, pdf = lightbvh.sample_light(
            tree, V3(*(torch.as_tensor(np.ascontiguousarray(p[:, i]))
                       for i in range(3))), torch.as_tensor(u))
        same = pick.numpy() == np.asarray(jpick)
        assert same.mean() >= 0.999
        np.testing.assert_allclose(pdf.numpy()[same],
                                   np.asarray(jpdf)[same], rtol=1e-6)
        assert pick.dtype == torch.int32
        assert 0 <= int(pick.min()) and int(pick.max()) < table.shape[0]


def test_sample_light_pdf_sums_to_one(trees):
    """Every light's probability at one point, summed over the lights,
    is 1: the descent from 8192 evenly spaced uniforms reaches every
    light, and each distinct pick's pdf is counted once."""
    table, _, pt = trees["40"]
    m = 8192
    p = V3(*(torch.full((m,), c) for c in (0.5, -1.0, 0.25)))
    u = (torch.arange(m, dtype=torch.float32) + 0.5) / m
    pick, pdf = lightbvh.sample_light(pt, p, u)
    first = {}
    for k, q in zip(pick.tolist(), pdf.tolist()):
        first.setdefault(k, q)
    assert len(first) == table.shape[0]
    assert abs(sum(first.values()) - 1.0) < 1e-4


def test_process_light_matches_jax():
    table = _nine_lights()
    rs = np.random.RandomState(7)
    wp = rs.uniform(-3, 3, (257, 3)).astype(np.float32)
    got = lights.process_light(torch.as_tensor(table), torch.as_tensor(wp))
    want = jlights.process_light(jnp.asarray(table), jnp.asarray(wp))
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.shape == b.shape
        if b.dtype == bool:
            np.testing.assert_array_equal(a.numpy(), b)
        else:
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-7)
    # One ray per light row, every light type.
    rows = table[rs.randint(0, table.shape[0], 257)]
    p = V3(*(torch.as_tensor(np.ascontiguousarray(wp[:, i]))
             for i in range(3)))
    jp = JV3(*(jnp.asarray(wp[:, i]) for i in range(3)))
    got = lightbvh.process_light_rows(torch.as_tensor(rows), p)
    want = jlightbvh.process_light_rows(jnp.asarray(rows), jp)
    for a, b in zip(got, want):
        a = a.to_array().numpy() if isinstance(a, V3) else a.numpy()
        b = (np.stack([np.asarray(c) for c in b], -1) if isinstance(b, JV3)
             else np.asarray(b))
        if b.dtype == bool:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def jax_frames():
    """The JAX many-light scene (40 lights), its SAH accel (32-triangle
    leaves) carried over, and JAX's frames of CASES."""
    js = _jax_many_lights(40).build()
    ja = jlbvh.build_bvh_sah(js, leaf_size=32)
    frames = {name: np.asarray(jrender(js, JCamera(**CAM), JRenderConfig(
        traversal="bvh", shade_pallas=False, **SMALL, **kw), accel=ja))
        for name, kw in CASES.items()}
    return accel_from_numpy(jax_accel_dict(ja), 32, "cpu"), frames


def _check(img, ref):
    assert img.shape == ref.shape
    assert np.isfinite(img).all()
    assert psnr(np.clip(img, 0, 4), np.clip(ref, 0, 4), peak=4.0) > 45.0
    assert (np.abs(img - ref).max(axis=-1) <= 1e-3).mean() >= 0.99


@pytest.mark.parametrize("case", list(CASES))
def test_sampled_nee_frame_matches_jax(jax_frames, case):
    acc, frames = jax_frames
    img = renderer.render(many_lights_scene(40), Camera(**CAM),
                          RenderConfig(**SMALL, **CASES[case]), acc)
    _check(img, frames[case])


def test_auto_sampler_crossover(jax_frames):
    """light_sampler="auto" scans up to 384 lights and descends the tree
    past them: its frames equal the "cdf" frame at 40 lights and the
    "bvh" frame at 400, value for value."""
    acc, _ = jax_frames
    for n_lights, same_as in ((40, "cdf"), (400, "bvh")):
        sc = many_lights_scene(n_lights)
        data = sc.build("cpu")
        if n_lights != 40:
            acc = lbvh.build_bvh_sah(data, leaf_size=32)
        frame = {s: renderer.render(data, Camera(**CAM), RenderConfig(
            **SMALL, max_depth=1, light_samples=2, light_sampler=s), acc)
            for s in ("auto", same_as)}
        np.testing.assert_array_equal(frame["auto"], frame[same_as])


def test_nee_light_batch_picks_and_seed():
    """The sampled batch's picks come from the light table, the seed
    advances by one draw per sample, and a scene with no more lights
    than samples takes one sample per light with the seed untouched."""
    from hrt_tpu_torch.ops import rng

    data = many_lights_scene(40).build("cpu")
    cfg = RenderConfig(**SMALL, max_depth=1, light_samples=3,
                       light_sampler="cdf")
    n = 64
    rs = np.random.RandomState(9)
    pos = V3(*(torch.as_tensor(rs.uniform(-3, 0.9, n).astype(np.float32))
               for _ in range(3)))
    nrm = V3(torch.zeros(n), -torch.ones(n), torch.zeros(n))
    seed = rng.pixel_seed(torch.arange(n), torch.zeros(n, dtype=torch.int64),
                          0)
    for sampler in ("cdf", "bvh"):
        lb, s2 = renderer.nee_light_batch(
            data, nrm, pos, dataclasses.replace(cfg, light_sampler=sampler),
            seed=seed)
        want = seed
        for _ in range(3):
            _, want = rng.rand(want)
        assert torch.equal(s2, want)
        assert len(lb.pick) == 3 and lb.l.x.shape == (3 * n,)
        assert all(int(p.max()) < 40 for p in lb.pick)
    lb, s2 = renderer.nee_light_batch(
        data, nrm, pos, RenderConfig(**SMALL, light_samples=40), seed=seed)
    assert lb.inv_pdf is None and len(lb.color) == 40 and s2 is seed
