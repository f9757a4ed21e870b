"""Materials and scene files of hrt_tpu_torch against the JAX package on
the CPU: texture packing and bilinear wrap sampling
(models/textures.py), the pbr BSDF (ops/pbr.py) and the array math it
uses, the hit-attribute gather's material rows and UVs, the YAML scene
loader over the three shipped scenes (built arrays equal to JAX's), and
frames of the shipped scenes against JAX's render on JAX-built accels
(traversal="bvh", shade_pallas=False, as test_torch_path.py): studio
(its checkerboard floor, a spot light, glass and chrome) with the
Disney BRDF and with brdf='pbr', colonnade (a directional sun)
single-level and two-level (the port's FrameLoop(two_level=True), K4's
plain walk), once per light and once with one sampled light.  A
two-level frame is held against JAX's frame on its single-level accel:
the picture does not depend on the accel, and JAX's two-level build and
interpret-mode walk take a minute here.

Frames are held at PSNR > 45 (peak 4) with >= 0.99 of pixels within
1e-3; the JAX scenes and frames are built once per module.
"""
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import yaml

from hrt_tpu.config import RenderConfig as JRenderConfig
from hrt_tpu.models import textures as jtextures
from hrt_tpu.models.camera import Camera as JCamera
from hrt_tpu.models.scenefile import load_scene_yaml as jload_scene_yaml
from hrt_tpu.ops import lbvh as jlbvh, math3d as jmath3d, pbr as jpbr
from hrt_tpu.renderer import _shade_attrs_p as j_shade_attrs_p
from hrt_tpu.renderer import render as jrender
from hrt_tpu.utils.image import psnr
from hrt_tpu_torch import renderer
from hrt_tpu_torch.config import RenderConfig
from hrt_tpu_torch.frameloop import FrameLoop
from hrt_tpu_torch.models import textures
from hrt_tpu_torch.models.camera import Camera
from hrt_tpu_torch.models.materials import BASE_COLOR_TEX
from hrt_tpu_torch.models.scenefile import load_scene_yaml, scene_from_dict
from hrt_tpu_torch.ops import lbvh, math3d, pbr
from hrt_tpu_torch.utils.interop import accel_from_numpy, scene_from_numpy

from test_torch_build import jax_accel_dict
from test_torch_native import jax_native_lib


@pytest.fixture(scope="module", autouse=True)
def _jax_native_sah():
    """JAX's build_bvh_sah through its native builder, never the LBVH
    fallback (test_torch_native.jax_native_lib)."""
    jax_native_lib()


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = ("cornell", "studio", "colonnade")
CAM = dict(position=(0.0, -1.5, -6.0), rotation=(-0.15, 0.0, 0.0))
SMALL = dict(width=48, height=32, sky=True)
# (scene, two-level, config) of the frames held against JAX's.
FRAMES = {
    "studio": ("studio", False, dict(max_depth=2)),
    "studio_pbr": ("studio", False, dict(max_depth=2, brdf="pbr")),
    "colonnade": ("colonnade", False, dict(max_depth=1)),
    "colonnade_two_level": ("colonnade", True, dict(max_depth=1)),
    "colonnade_two_level_sampled": ("colonnade", True,
                                    dict(max_depth=1, light_samples=1)),
}


def _path(name: str) -> str:
    return os.path.join(ROOT, "scenes", f"{name}.yaml")


def _uniform(rs, shape, lo=-1.0, hi=1.0):
    return rs.uniform(lo, hi, shape).astype(np.float32)


def _unit(rs, n):
    a = _uniform(rs, (n, 3))
    return a / np.linalg.norm(a, axis=1, keepdims=True)


def test_pack_textures_matches_jax():
    rs = np.random.RandomState(0)
    images = [rs.randint(0, 256, (37, 53, 3)).astype(np.uint8),
              rs.randint(0, 65536, (20, 20)).astype(np.uint16),
              _uniform(rs, (16, 16, 1), 0.0, 3.0),
              _uniform(rs, (32, 32, 4), 0.0, 1.0),
              textures.checkerboard(n=12, res=256)]
    for res in (32, textures.TEX_RES):
        got = textures.pack_textures(images, res)
        np.testing.assert_array_equal(got,
                                      jtextures.pack_textures(images, res))
        assert got.dtype == np.float32 and got.shape == (5, res, res, 3)
    assert textures.pack_textures([]).shape == (0, 256, 256, 3)
    np.testing.assert_array_equal(textures.checkerboard(5, 40, (1, 0, 0)),
                                  jtextures.checkerboard(5, 40, (1, 0, 0)))


def test_sample_texture_matches_jax():
    """Wrap addressing over negative and > 1 UVs, three textures and
    untextured rays (id -1, sampled as 1)."""
    rs = np.random.RandomState(1)
    tex = textures.pack_textures(
        [_uniform(rs, (16, 16, 3), 0.0, 1.0) for _ in range(3)], 16)
    n = 4099
    ids = rs.randint(-1, 3, n).astype(np.int32)
    u, v = _uniform(rs, n, -3.0, 3.0), _uniform(rs, n, -3.0, 3.0)
    u[:8] = [0.0, 1.0, -1.0, 2.0, -1e-9, 1e-9, 0.5, -0.5]
    got = textures.sample_texture_p(torch.as_tensor(tex),
                                    torch.as_tensor(ids),
                                    torch.as_tensor(u), torch.as_tensor(v))
    want = jtextures.sample_texture_p(jnp.asarray(tex), jnp.asarray(ids),
                                      jnp.asarray(u), jnp.asarray(v))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
        assert (a.numpy()[ids < 0] == 1.0).all()
        assert ((a.numpy() >= 0.0) & (a.numpy() <= 1.0)).all()


def test_pbr_matches_jax():
    rs = np.random.RandomState(2)
    n = 2048
    mats = _uniform(rs, (n, 20), 0.0, 1.0)
    nrm, v, l = _unit(rs, n), _unit(rs, n), _unit(rs, n)
    a, b = _uniform(rs, (n, 3)), _uniform(rs, (n, 3))
    t = torch.as_tensor
    pairs = [
        (math3d.dot(t(a), t(b)), jmath3d.dot(a, b)),
        (math3d.normalize(t(a)), jmath3d.normalize(a)),
        (pbr.fresnel_schlick(t(a), t(mats[:, 0])),
         jpbr.fresnel_schlick(a, mats[:, 0])),
        (pbr.distribution_ggx(t(mats[:, 1]), t(mats[:, 2])),
         jpbr.distribution_ggx(mats[:, 1], mats[:, 2])),
        (pbr.geometry_smith(t(mats[:, 3]), t(mats[:, 4]), t(mats[:, 5])),
         jpbr.geometry_smith(mats[:, 3], mats[:, 4], mats[:, 5])),
        (pbr.bsdf_evaluate_simple(t(mats), t(nrm), t(v), t(l)),
         jpbr.bsdf_evaluate_simple(jnp.asarray(mats), jnp.asarray(nrm),
                                   jnp.asarray(v), jnp.asarray(l))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    f = pairs[-1][0].numpy()
    below = (np.sum(nrm * l, 1) <= 0) | (np.sum(nrm * v, 1) <= 0)
    assert (f[below] == 0).all() and (f[~below] > 0).any()


def test_shade_attrs_rows_and_uvs_match_jax():
    """The single-level gather returns the hits' material rows and
    interpolated UVs (JAX's full-row form)."""
    rs = np.random.RandomState(3)
    tab = _uniform(rs, (300, 36), -2.0, 2.0)
    tri = rs.randint(-1, 300, 1000).astype(np.int32)
    u, v = _uniform(rs, 1000, 0.0, 0.5), _uniform(rs, 1000, 0.0, 0.5)
    n, mat, rows, (tu, tv) = renderer._shade_attrs_p(
        torch.as_tensor(tab), torch.as_tensor(tri), torch.as_tensor(u),
        torch.as_tensor(v))
    jn, jmat, jrows, (jtu, jtv) = j_shade_attrs_p(
        jnp.asarray(tab), jnp.asarray(tri), jnp.asarray(u), jnp.asarray(v))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    np.testing.assert_array_equal(mat.color.x.numpy(),
                                  np.asarray(jmat.color.x))
    for a, b in ((tu, jtu), (tv, jtv), (n.x, jn.x), (n.z, jn.z)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


@pytest.fixture(scope="module")
def jax_scenes():
    """The JAX package's Scene and SceneData of each shipped scene."""
    out = {}
    for name in SCENES:
        sc = jload_scene_yaml(_path(name))
        out[name] = (sc, sc.build())
    return out


@pytest.mark.parametrize("name", SCENES)
def test_scene_file_builds_match_jax(jax_scenes, name):
    """load_scene_yaml and scene_from_dict build every array JAX's
    loader builds, the textures and the light tree's order included."""
    jdata = jax_scenes[name][1]
    with open(_path(name)) as f:
        spec = yaml.safe_load(f)
    for sc in (load_scene_yaml(_path(name)), scene_from_dict(spec)):
        data = sc.build("cpu")
        for field in data._fields:
            if field == "light_tree":
                continue
            a, b = getattr(data, field).numpy(), np.asarray(getattr(jdata,
                                                                    field))
            assert a.dtype == b.dtype, field
            np.testing.assert_array_equal(a, b, err_msg=field)
        np.testing.assert_array_equal(data.light_tree.perm.numpy(),
                                      np.asarray(jdata.light_tree.perm))
    if name == "studio":
        assert data.textures.shape == (1, 256, 256, 3)
        assert float(data.materials[0, BASE_COLOR_TEX]) == 0.0
    # A hand-built SceneData carries the table over.
    d = {k: np.asarray(v) for k, v in jdata._asdict().items()
         if k != "light_tree"}
    carried = scene_from_numpy(d, "cpu")
    np.testing.assert_array_equal(carried.textures.numpy(), d["textures"])


def test_chip_smoke_scene_specs_equal_the_files():
    """The smoke run holds the studio and colonnade scenes as dicts
    (the card's machine need not have pyyaml)."""
    import chip_smoke

    for name, spec in (("studio", chip_smoke.STUDIO_SPEC),
                       ("colonnade", chip_smoke.COLONNADE_SPEC)):
        with open(_path(name)) as f:
            assert spec == yaml.safe_load(f), name


OBJ_TEXT = """# a quad (fan-triangulated), a triangle with negative indices, and
# a face without texture coordinates
v -1 0 -1
v 1 0 -1
v 1 0 1
v -1 0 1
v 0 -1 0
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 -1 0
vn 0.6 -0.8 0
f 1/1/1 2/2/1 3/3/1 4/4/1
f -5/1/2 -4/2/2 -1/3/2
f 2//2 3//2 5//2
"""


def test_obj_scene_matches_jax(tmp_path):
    """An `obj:` mesh loads through the native loader as the JAX
    package's loader reads it (Y negated, vertices deduplicated, quads
    fanned), and the scene builds JAX's arrays."""
    from hrt_tpu.models.mesh import load_obj as jload_obj
    from hrt_tpu.models.scenefile import scene_from_dict as jscene_from_dict
    from hrt_tpu_torch.models.mesh import load_obj

    path = tmp_path / "shape.obj"
    path.write_text(OBJ_TEXT)
    mesh, jmesh = load_obj(str(path)), jload_obj(str(path))
    np.testing.assert_array_equal(mesh.vertices, jmesh.vertices)
    np.testing.assert_array_equal(mesh.indices, jmesh.indices)
    assert mesh.num_triangles == 4
    spec = {"meshes": [{"name": "m", "obj": str(path)}],
            "materials": [{"name": "w", "color": [0.5, 0.5, 0.5]}],
            "lights": [{"position": [0, -3, 0], "color": [1, 1, 1],
                        "intensity": 5}],
            "instances": [{"mesh": "m", "material": "w",
                           "rotation": [0.1, 0.2, 0.3]}]}
    data, jdata = scene_from_dict(spec).build("cpu"), jscene_from_dict(
        spec).build()
    for field in ("tri_v0", "tri_e1", "tri_e2", "nrm0", "uv2", "tri_mat"):
        np.testing.assert_array_equal(getattr(data, field).numpy(),
                                      np.asarray(getattr(jdata, field)),
                                      err_msg=field)
    with pytest.raises(FileNotFoundError):
        load_obj(str(tmp_path / "missing.obj"))


@pytest.fixture(scope="module")
def jax_frames(jax_scenes):
    """JAX's frames of FRAMES on each scene's single-level SAH accel
    (32-triangle leaves), which is carried over."""
    jaccels, accels, frames = {}, {}, {}
    for key, (name, _, kw) in FRAMES.items():
        data = jax_scenes[name][1]
        if name not in jaccels:
            jaccels[name] = jlbvh.build_bvh_sah(data, leaf_size=32)
            accels[name] = accel_from_numpy(jax_accel_dict(jaccels[name]),
                                            32, "cpu")
        frames[key] = np.asarray(jrender(data, JCamera(**CAM), JRenderConfig(
            traversal="bvh", shade_pallas=False, **SMALL, **kw),
            accel=jaccels[name]))
    return accels, frames


def _check(img, ref):
    assert img.shape == ref.shape
    assert np.isfinite(img).all()
    assert psnr(np.clip(img, 0, 4), np.clip(ref, 0, 4), peak=4.0) > 45.0
    assert (np.abs(img - ref).max(axis=-1) <= 1e-3).mean() >= 0.99


@pytest.mark.parametrize("key", list(FRAMES))
def test_scene_frame_matches_jax(jax_frames, key):
    accels, frames = jax_frames
    name, two_level, kw = FRAMES[key]
    sc = load_scene_yaml(_path(name))
    cfg = RenderConfig(**SMALL, **kw)
    if two_level:
        img = FrameLoop(sc, cfg, two_level=True,
                        device="cpu").step(Camera(**CAM)).numpy()
    else:
        img = renderer.render(sc, Camera(**CAM), cfg, accels[name])
    _check(img, frames[key])
    if key == "studio_pbr":
        # The pbr BSDF reads the material rows, not the textured color:
        # the frame differs from the Disney one.
        assert np.abs(img - frames["studio"]).max() > 1e-2


def test_texture_modulates_the_frame(jax_frames):
    """The studio floor's checkerboard shows: the textured frame against
    the same scene with the texture removed from the floor (on its own
    accel, whose attribute table carries the material rows)."""
    _, frames = jax_frames
    sc = load_scene_yaml(_path("studio"))
    sc.materials[0] = sc.materials[0].copy()
    sc.materials[0][BASE_COLOR_TEX] = -1.0
    data = sc.build("cpu")
    plain = renderer.render(data, Camera(**CAM),
                            RenderConfig(**SMALL, max_depth=2),
                            lbvh.build_bvh_sah(data, leaf_size=32))
    diff = np.abs(plain - frames["studio"]).max(-1)
    assert (diff > 1e-2).mean() > 0.05
