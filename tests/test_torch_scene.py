"""hrt_tpu_torch scene side vs the JAX package on the same inputs: camera
rays, lights, sky, scene flattening; plus the package's import
boundary and its refusal of features outside the ported slice."""
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import bench
from hrt_tpu.models import camera as jcamera, lights as jlights
from hrt_tpu.models import scene as jscene, sky as jsky
from hrt_tpu.ops.v3 import V3 as JV3
from hrt_tpu_torch.config import RenderConfig, require_slice
from hrt_tpu_torch.models import camera, lights, scene, sky
from hrt_tpu_torch.ops.v3 import V3

CAMERAS = [dict(position=(0.0, -1.0, -6.0), rotation=(-0.15, 0.0, 0.0)),
           dict(position=(1.0, -2.0, 3.0), rotation=(0.3, 2.5, 0.1),
                fov_y=0.7)]


@pytest.mark.parametrize("cam", CAMERAS)
def test_camera_rays_match_jax(cam):
    w, h = 40, 24
    px = np.tile(np.arange(w, dtype=np.float32), h)
    py = np.repeat(np.arange(h, dtype=np.float32), w)
    jc = jcamera.Camera(**cam)
    jo, jd = jcamera.primary_rays_from_px_p(
        *jc.ray_params(w, h), w, h, jnp.asarray(px), jnp.asarray(py))
    c = camera.Camera(**cam).ray_params(w, h, "cpu")
    o, d = camera.primary_rays_from_px_p(*c, w, h, torch.as_tensor(px),
                                         torch.as_tensor(py))
    for a, b in zip(list(o) + list(d), list(jo) + list(jd)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


LIGHTS = [  # (position, color, intensity, type, direction, cone)
    ((0.0, -4.0, -2.0), (1.0, 1.0, 1.0), 30.0, 0, (0.0, 0.0, 0.0), 0.0),
    ((1.0, -2.0, 0.5), (1.0, 0.5, 0.2), 5.0, 1, (0.0, 1.0, 0.2), 0.6),
    ((0.0, 0.0, 0.0), (0.3, 0.3, 1.0), 2.0, 2, (0.2, 1.0, 0.1), 0.0),
    ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), 2.0, 2, (0.0, 0.0, 0.0), 0.0),
]


@pytest.mark.parametrize("args", LIGHTS)
def test_process_light_one_matches_jax(args):
    rec = lights.make_light(*args)
    np.testing.assert_array_equal(rec, jlights.make_light(*args))
    p = np.random.RandomState(3).uniform(-3, 3, (3, 512)).astype(np.float32)
    out = lights.process_light_one(torch.as_tensor(rec),
                                   V3(*map(torch.as_tensor, p)))
    jout = jlights.process_light_one(jnp.asarray(rec),
                                     JV3(*map(jnp.asarray, p)))
    for a, b in zip(list(out[0]) + list(out[1]) + [out[2], out[3]],
                    list(jout[0]) + list(jout[1]) + [jout[2], jout[3]]):
        a = a.numpy()
        b = np.broadcast_to(np.asarray(b), a.shape)
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("enabled", [True, False])
def test_eval_sky_matches_jax(enabled):
    d = np.random.RandomState(5).normal(size=(3, 1024))
    d = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    table = sky.default_sky()
    np.testing.assert_array_equal(table, jsky.default_sky())
    out = sky.eval_sky_p(torch.as_tensor(table),
                         V3(*map(torch.as_tensor, d)), enabled)
    jout = jsky.eval_sky_p(jnp.asarray(table), JV3(*map(jnp.asarray, d)),
                           enabled)
    for a, b in zip(out, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("name", ["bench", "demo"])
def test_scene_build_matches_jax(name):
    if name == "bench":
        js, ts = bench.build_bench_scene().build(), \
            scene.bench_scene().build("cpu")
    else:
        js, ts = jscene.reference_demo_scene().build(), \
            scene.reference_demo_scene().build("cpu")
    for field in scene.SceneData._fields:
        if field == "light_tree":
            continue
        a, b = getattr(ts, field).numpy(), np.asarray(getattr(js, field))
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert ts.textures.shape == (0, 256, 256, 3)
    np.testing.assert_array_equal(ts.light_tree.perm.numpy(),
                                  np.asarray(js.light_tree.perm))
    for a, b in zip(ts.light_tree.pair, js.light_tree.pair):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_package_imports_neither_jax_nor_hrt_tpu():
    code = (
        "import sys, importlib, pkgutil, hrt_tpu_torch\n"
        "for m in pkgutil.walk_packages(hrt_tpu_torch.__path__, "
        "'hrt_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith"
        "(('jax.', 'hrt_tpu.')) or k == 'hrt_tpu']\n"
        "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# The post stages (denoise, upscale), the path tracer (indirect,
# jitter, sort_bounces), sampled NEE (light_samples) and the pbr BSDF
# are in the slice: a config with them raises for the brute-force walk
# only.
@pytest.mark.parametrize("change", [
    dict(indirect=True, light_samples=2, traversal="bruteforce"),
    dict(jitter=True, brdf="pbr", traversal="bruteforce"),
    dict(light_samples=2, traversal="bruteforce"),
    dict(light_samples=1, denoise=True, traversal="bruteforce"),
    dict(indirect=True, max_depth=4, denoise=True, upscale=2,
         upscale_mode="temporal", light_samples=4, traversal="bruteforce"),
    dict(brdf="pbr", traversal="bruteforce"),
    dict(sort_bounces=True, traversal="bruteforce"),
    dict(traversal="bruteforce")])
def test_features_outside_the_slice_raise(change):
    require_slice(RenderConfig(max_depth=1, sky=True, denoise=True,
                               upscale=2, upscale_mode="temporal"))
    accepted = {k: v for k, v in change.items() if k != "traversal"}
    require_slice(RenderConfig(**{"max_depth": 1, **accepted}))
    with pytest.raises(NotImplementedError) as err:
        require_slice(RenderConfig(**{"max_depth": 1, **change}))
    for name in ("denoise", "upscale", "indirect", "jitter", "sort_bounces",
                 "light_samples", "pbr"):
        assert name not in str(err.value)


def test_path_tracing_configs_accepted():
    """The JAX package's named configs that the port renders pass
    require_slice, and CONFIGS is the JAX package's, field for field."""
    import dataclasses

    from hrt_tpu.config import CONFIGS as JCONFIGS
    from hrt_tpu_torch.config import CONFIGS

    assert CONFIGS.keys() == JCONFIGS.keys()
    for name, cfg in CONFIGS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(JCONFIGS[name])
        require_slice(cfg)
    require_slice(dataclasses.replace(CONFIGS["path_tracing"],
                                      sort_bounces=True))
