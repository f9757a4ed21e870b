"""The JAX package's array-form API in hrt_tpu_torch against JAX, on the
same seeded numpy inputs on the CPU: ops/math3d, intersect.ray_aabb and
pick_chunk, camera.primary_rays(_p), sky.eval_sky, disney.gtr2 and
brdf, the array samplers, wavefront.direction_order_key(_p),
traversal.closest_hit_bvh / any_hit_bvh, traversal_skip's scene-level
entry points (the JAX traversal_pallas ones, run here as the JAX
package's own tests run them), and renderer's trace dispatches,
interpolate_hit and render_frame.

Ids, masks, pick_chunk and the direction keys match exactly (walk ids
up to equal-t ties, as tests/test_torch_traversal.py holds them);
floats are within rtol 1e-5 / atol 1e-6 on all but at most 1 in 1000
elements and within rtol 1e-3 / atol 1e-5 on those (the tolerance of
tests/test_torch_sampling.py: XLA's and torch's sin, cos and FMA
contraction differ in the last ulp, which the samplers' ill-conditioned
rims amplify).  The traces run on the bench scene's 32x24 camera rays
over JAX's SAH + BVH8 accel, carried over (K1's plain walk), the same
accel without its BVH8 table (K3's), brute force, and the port's
TwoLevelFlat of test_tlas's four instances (K4's plain walk) against
JAX's brute force over the flattened instances (JAX's two-level build
compiles for ~20 s on the CPU).  render_frame is held to JAX's at PSNR
> 45 and to the port's render_frames(...)[0] bit for bit.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import bench
from hrt_tpu import renderer as jrenderer
from hrt_tpu.config import RenderConfig as JRenderConfig
from hrt_tpu.models import camera as jcamera, sky as jsky
from hrt_tpu.models.camera import Camera as JCamera
from hrt_tpu.ops import disney as jdisney, intersect as jintersect
from hrt_tpu.ops import lbvh as jlbvh, math3d as jm
from hrt_tpu.ops import sampling as jsampling, traversal as jtraversal
from hrt_tpu.ops import traversal_pallas as jtp, wavefront as jwavefront
from hrt_tpu.ops.v3 import V3 as JV3
from hrt_tpu.utils.image import psnr
from hrt_tpu_torch import renderer
from hrt_tpu_torch.config import RenderConfig
from hrt_tpu_torch.models import camera, sky
from hrt_tpu_torch.models.camera import Camera
from hrt_tpu_torch.models.materials import MAT_W, ROUGHNESS_MIN
from hrt_tpu_torch.models.scene import bench_scene
from hrt_tpu_torch.ops import disney, intersect, math3d, sampling
from hrt_tpu_torch.ops import tlas, traversal, traversal_skip, wavefront
from hrt_tpu_torch.ops.v3 import V3
from hrt_tpu_torch.utils.interop import accel_from_numpy

from test_tlas import _instanced_scene, _rays
from test_torch_build import jax_accel_dict
from test_torch_native import jax_native_lib
from test_torch_tlas import port_scene


@pytest.fixture(scope="module", autouse=True)
def _jax_native_sah():
    """JAX's build_bvh_sah through its native builder, never the LBVH
    fallback (test_torch_native.jax_native_lib)."""
    jax_native_lib()


TOL = dict(rtol=1e-5, atol=1e-6)
TOL_ILL = dict(rtol=1e-3, atol=1e-5)
ILL_SHARE = 1e-3
N = 2048
BENCH_CAM = dict(position=(0.0, -1.0, -6.0), rotation=(-0.15, 0.0, 0.0))
FRAME = dict(width=32, height=24, max_depth=1, sky=True)


def _close(t, j):
    """TOL on all but ILL_SHARE of the elements, TOL_ILL on those."""
    a, b = t.numpy(), np.asarray(j)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape)
    with np.errstate(invalid="ignore"):      # inf - inf where both are
        off = np.abs(a - b) > TOL["atol"] + TOL["rtol"] * np.abs(b)
    assert off.mean() <= ILL_SHARE, (off.sum(), a[off], b[off])
    np.testing.assert_allclose(a, b, **TOL_ILL)


def _unit(rs, n=N):
    a = rs.normal(size=(n, 3)).astype(np.float32)
    return a / np.linalg.norm(a, axis=-1, keepdims=True)


def _both(*arrays):
    """Each numpy array as (torch tensor, jax array)."""
    return [(torch.as_tensor(a), jnp.asarray(a)) for a in arrays]


def _mat_rows(rs, n=N):
    """(n, MAT_W) material rows: metals, roughness at and below
    ROUGHNESS_MIN, anisotropy, transmission, no texture."""
    f = lambda lo, hi: rs.uniform(lo, hi, n).astype(np.float32)
    m = rs.uniform(0, 1, (n, MAT_W)).astype(np.float32)
    m[:, 4] = np.where(rs.rand(n) < 0.3, 1.0, f(0, 1))
    m[:, 5] = f(0, 1)
    m[: n // 4, 5] = rs.choice([0.0, 1e-5, ROUGHNESS_MIN], n // 4)
    m[:, 8] = f(0, 0.9)
    m[:, 17] = f(1.0, 2.4)
    m[:, 18] = np.where(rs.rand(n) < 0.4, f(0.2, 1), 0.0)
    m[:, 19] = -1.0
    return m


def _views(rs, n):
    """Unit views facing the unit normals n, an eighth of them grazing."""
    v = _unit(rs, len(n))
    v = np.where((v * n).sum(-1, keepdims=True) < 0, -v, v)
    g = slice(0, len(n) // 8)
    t = v[g] - (v[g] * n[g]).sum(-1, keepdims=True) * n[g]
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    v[g] = t + 1e-3 * n[g]
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(
        np.float32)


# ---------------------------------------------------------------------------
# ops/math3d.py, ops/intersect.py
# ---------------------------------------------------------------------------

MATH3D = ["dotk", "cross", "length", "square", "reflect",
          "orthonormal_basis", "to_local", "to_world", "transform_point",
          "transform_dir"]


@pytest.mark.parametrize("name", MATH3D)
def test_math3d_matches_jax(name):
    rs = np.random.RandomState(MATH3D.index(name))
    nrm = _unit(rs, 7 * 64).reshape(7, 64, 3)
    # Normals at the Frisvad guard: straight down and just inside it.
    nrm[0, :2] = [[0.0, 0.0, -1.0], [0.0, 0.0, -0.9999]]
    (a, ja), (b, jb), (n, jn), (m, jmat) = _both(
        rs.normal(size=(7, 64, 3)).astype(np.float32),
        rs.normal(size=(7, 64, 3)).astype(np.float32), nrm,
        rs.normal(size=(7, 64, 3, 4)).astype(np.float32))
    calls = {
        "dotk": ((a, b), (ja, jb)), "cross": ((a, b), (ja, jb)),
        "length": ((a,), (ja,)), "square": ((a,), (ja,)),
        "reflect": ((a, n), (ja, jn)), "orthonormal_basis": ((n,), (jn,)),
        "to_local": ((a, n), (ja, jn)), "to_world": ((a, n), (ja, jn)),
        "transform_point": ((m, a), (jmat, ja)),
        "transform_dir": ((m, a), (jmat, ja))}
    targs, jargs = calls[name]
    got = getattr(math3d, name)(*targs)
    want = getattr(jm, name)(*jargs)
    for g, w in (zip(got, want) if isinstance(got, tuple)
                 else [(got, want)]):
        _close(g, w)
    if name == "to_local":
        frame = math3d.orthonormal_basis(n)
        _close(math3d.to_local(a, n, frame),
               jm.to_local(ja, jn, jm.orthonormal_basis(jn)))


def test_ray_aabb_matches_jax():
    rs = np.random.RandomState(20)
    o = rs.uniform(-4, 4, (N, 3)).astype(np.float32)
    lo = rs.uniform(-2, 0, (N, 3)).astype(np.float32)
    hi = lo + rs.uniform(0, 2, (N, 3)).astype(np.float32)
    # Toward a point near the box, so that about half the rays meet it.
    d = (lo + hi) / 2 + rs.normal(size=(N, 3)) - o
    d[:8, 0] = 0.0                               # +-inf inverse directions
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    with np.errstate(divide="ignore"):
        inv = (1.0 / d).astype(np.float32)
    tmax = rs.uniform(0.5, 10, N).astype(np.float32)
    (to, jo), (ti, ji), (tl, jl), (th, jh), (tt, jt) = _both(o, inv, lo, hi,
                                                             tmax)
    hit, entry = intersect.ray_aabb(to, ti, tl, th, 1e-3, tt)
    jhit, jentry = jintersect.ray_aabb(jo, ji, jl, jh, 1e-3, jt)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    assert 0.1 < hit.float().mean() < 0.9
    _close(entry, jentry)


@pytest.mark.parametrize("t_total,want", [(4096, 512), (3968, 512),
                                          (600, 1024), (1000, 300),
                                          (7, 4), (1, 512)])
def test_pick_chunk_matches_jax(t_total, want):
    assert intersect.pick_chunk(t_total, want) \
        == jintersect.pick_chunk(t_total, want)


# ---------------------------------------------------------------------------
# models/camera.py, models/sky.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form", ["array", "planar"])
@pytest.mark.parametrize("band", [None, (5, 7)])
@pytest.mark.parametrize("jittered", [False, True])
def test_primary_rays_match_jax(form, band, jittered):
    """Both forms against JAX's, whole frame or a band of rows, with and
    without jitter (an (rows, W, 2) array, or a pair of planes)."""
    cam = dict(position=(0.3, -1.0, -5.0), rotation=(-0.2, 0.3, 0.05))
    w, h = 32, 24
    jp = JCamera(**cam).ray_params(w, h)
    tp = Camera(**cam).ray_params(w, h, "cpu")
    y0, rows = band if band else (0, None)
    jit = None
    if jittered:
        jit = np.random.RandomState(30).uniform(
            0, 1, (rows or h, w, 2)).astype(np.float32)
    if form == "array":
        o, d = camera.primary_rays(*tp, w, h, None if jit is None
                                   else torch.as_tensor(jit), y0, rows)
        jo, jd = jcamera.primary_rays(*jp, w, h, None if jit is None
                                      else jnp.asarray(jit), y0, rows)
        assert o.shape == d.shape == ((rows or h), w, 3)
        pairs = [(o, jo), (d, jd)]
    else:
        pj = None if jit is None else (jit[..., 0], jit[..., 1])
        o, d = camera.primary_rays_p(
            *tp, w, h, None if pj is None else tuple(map(torch.as_tensor,
                                                         pj)), y0, rows)
        jo, jd = jcamera.primary_rays_p(
            *jp, w, h, None if pj is None else tuple(map(jnp.asarray, pj)),
            y0, rows)
        pairs = list(zip(o, jo)) + list(zip(d, jd))
    for a, b in pairs:
        _close(a, b)


@pytest.mark.parametrize("enabled", [True, False])
def test_eval_sky_matches_jax(enabled):
    rs = np.random.RandomState(31)
    dirs = _unit(rs, 6 * 40).reshape(6, 40, 3)
    sun = jsky.default_sky()[jsky.SUN_DIRECTION]
    dirs[0, :4] = sun / np.linalg.norm(sun)      # inside the disc
    got = sky.eval_sky(torch.as_tensor(sky.default_sky()),
                       torch.as_tensor(dirs), enabled=enabled)
    want = jsky.eval_sky(jnp.asarray(jsky.default_sky()), jnp.asarray(dirs),
                         enabled=enabled)
    _close(got, want)
    assert sky.SKY_W == jsky.SKY_W
    if not enabled:
        assert not got.any()


# ---------------------------------------------------------------------------
# ops/disney.py, ops/sampling.py, ops/wavefront.py
# ---------------------------------------------------------------------------

def test_gtr2_matches_jax():
    rs = np.random.RandomState(40)
    (c, jc), (a, ja) = _both(rs.uniform(-1, 1, N).astype(np.float32),
                             rs.uniform(1e-3, 1, N).astype(np.float32))
    _close(disney.gtr2(c, a), jdisney.gtr2(jc, ja))


@pytest.mark.parametrize("with_frame", [False, True])
def test_brdf_matches_jax(with_frame):
    rs = np.random.RandomState(41)
    n = _unit(rs)
    (m, jmat), (tn, jn), (v, jv), (l, jl) = _both(
        _mat_rows(rs), n, _views(rs, n), _views(rs, n))
    frame = jframe = None
    if with_frame:
        frame = math3d.orthonormal_basis(tn)
        jframe = jm.orthonormal_basis(jn)
    got = disney.brdf(m, tn, v, l, frame=frame)
    _close(got, jdisney.brdf(jmat, jn, jv, jl, frame=jframe))
    assert (got.numpy() > 0).any(axis=-1).mean() > 0.3


SAMPLERS = ["cosine_hemisphere", "anisotropic_from_material",
            "ggx_vndf_pdf_ratio", "ggx_vndf_spherical_cap"]


@pytest.mark.parametrize("name", SAMPLERS)
def test_sampler_matches_jax(name):
    rs = np.random.RandomState(50 + SAMPLERS.index(name))
    u = rs.uniform(0, 1, (2, N)).astype(np.float32)
    u[:, :4] = [[0, 1, 0, 1], [0, 0, 1, 1]]
    n = _unit(rs)
    (m, jmat), (tn, jn), (v, jv), (u0, ju0), (u1, ju1) = _both(
        _mat_rows(rs), n, _views(rs, n), u[0], u[1])
    wo = _views(rs, np.tile([[0.0, 0.0, 1.0]], (N, 1)).astype(np.float32))
    wi = _unit(rs)
    (two, jwo), (twi, jwi) = _both(wo, wi)
    args = {"cosine_hemisphere": ((u0, u1), (ju0, ju1)),
            "anisotropic_from_material": ((m,), (jmat,)),
            "ggx_vndf_pdf_ratio": ((m, two, twi), (jmat, jwo, jwi)),
            "ggx_vndf_spherical_cap": ((m, v, tn, u0, u1),
                                       (jmat, jv, jn, ju0, ju1))}
    targs, jargs = args[name]
    got = getattr(sampling, name)(*targs)
    want = getattr(jsampling, name)(*jargs)
    for g, w in (zip(got, want) if isinstance(got, tuple)
                 else [(got, want)]):
        _close(g, w)


@pytest.mark.parametrize("form", ["array", "planar"])
def test_direction_order_key_matches_jax_bits(form):
    rs = np.random.RandomState(60)
    d = _unit(rs)
    d[:6] = [[0, 0, 0], [1, 0, 0], [0, -1, 0], [0, 0, 1], [-0.0, 0, -1],
             [0.6, 0.8, 0]]
    d = d.astype(np.float32)
    if form == "array":
        got = wavefront.direction_order_key(torch.as_tensor(d))
        want = jwavefront.direction_order_key(jnp.asarray(d))
    else:
        got = wavefront.direction_order_key_p(V3(*torch.as_tensor(d.T)))
        want = jwavefront.direction_order_key_p(JV3(*jnp.asarray(d.T)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))


# ---------------------------------------------------------------------------
# Traces: ops/traversal.py, ops/traversal_skip.py, renderer's dispatches
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bench_pair():
    """The bench scene in both packages, JAX's SAH + BVH8 accel and its
    port with (K1) and without (K3) the BVH8 table, and the 32x24 camera
    rays with occlusion segments (the rays' reach 6, which ends inside
    the scene; every 17th dead)."""
    js = bench.build_bench_scene().build()
    ja = jlbvh.build_bvh_sah(js, leaf_size=32)
    d = jax_accel_dict(ja)
    cfg = JRenderConfig(traversal="bvh", **FRAME)
    cams = jrenderer.camera_arrays(JCamera(**BENCH_CAM), cfg)
    o, dd = (np.array(a).reshape(-1, 3)
             for a in jcamera.primary_rays(*cams, 32, 24))
    reach = np.full(o.shape[0], 6.0, np.float32)
    reach[::17] = -1.0
    return {"js": js, "ja": ja, "ts": bench_scene().build("cpu"),
            "bvh8": accel_from_numpy(d, 32, "cpu"),
            "no_w8": accel_from_numpy({**d, "w8": None}, 32, "cpu"),
            "o": o, "d": dd, "reach": reach}


@pytest.fixture(scope="module")
def two_level():
    """The port's TwoLevelFlat of test_tlas's four instances (BVH8
    route: K4) and JAX's flattened soup of the same scene."""
    return (tlas.build_two_level_flat(port_scene(_instanced_scene()), 32,
                                      device="cpu"),
            _instanced_scene().build(), _rays(768, seed=8))


def _hits_agree(got, want):
    """Closest hits (t, tri, u, v): ids equal up to equal-t ties, the
    floats close where the ids agree."""
    t, tri, u, v = [a.numpy() for a in got]
    jt, jtri, ju, jv = [np.asarray(a) for a in want]
    same = tri == jtri
    tie = ~same & (tri >= 0) & (jtri >= 0) & np.isclose(t, jt, rtol=1e-6)
    assert (same | tie).all()
    assert same.mean() >= 0.99 and 0.2 < (tri >= 0).mean() < 0.95
    # The card tests' tolerance of a walk's t against another's: the two
    # packages' triangle tests round apart on the large ground triangles.
    for a, b in ((t, jt), (u, ju), (v, jv)):
        np.testing.assert_allclose(a[same], b[same], rtol=1e-4, atol=1e-5)


def _rays_of(form: str, o, d):
    if form == "array":
        return torch.as_tensor(o), torch.as_tensor(d), jnp.asarray(o), \
            jnp.asarray(d)
    return (V3(*torch.as_tensor(o.T)), V3(*torch.as_tensor(d.T)),
            JV3(*jnp.asarray(o.T)), JV3(*jnp.asarray(d.T)))


@pytest.mark.parametrize("route", ["bvh8", "no_w8"])
@pytest.mark.parametrize("fn", ["closest_hit_bvh", "any_hit_bvh"])
def test_bvh_array_forms_match_jax(bench_pair, route, fn):
    """traversal.closest_hit_bvh / any_hit_bvh (K1 or K3 by the table)
    against JAX's on the same accel; t_min is the argument's."""
    p = bench_pair
    o, d, jo, jd = _rays_of("array", p["o"], p["d"])
    if fn == "closest_hit_bvh":
        got = traversal.closest_hit_bvh(p["ts"], p[route], o, d, 0.5, 1e32)
        want = jtraversal.closest_hit_bvh(p["js"], p["ja"], jo, jd, 0.5,
                                          1e32)
        _hits_agree(got, want)
    else:
        got = traversal.any_hit_bvh(p["ts"], p[route], o, d, 1e-3,
                                    torch.as_tensor(p["reach"]))
        want = jtraversal.any_hit_bvh(p["js"], p["ja"], jo, jd, 1e-3,
                                      jnp.asarray(p["reach"]))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert 0.05 < got.float().mean() < 0.95


@pytest.fixture(scope="module")
def jax_pallas_hits(bench_pair):
    """JAX's traversal_pallas.closest_hit (sorted and original ids) and
    any_hit over the bench rays, each run once in each of its forms."""
    p = bench_pair
    far = jnp.full((p["o"].shape[0],), 1e32, jnp.float32)
    out = {}
    for form in ("array", "planar"):
        _, _, jo, jd = _rays_of(form, p["o"], p["d"])
        sfx = "" if form == "array" else "_p"
        closest = getattr(jtp, "closest_hit" + sfx)
        out[form] = {
            "closest": closest(p["js"], p["ja"], jo, jd, 1e-3, far),
            "sorted": closest(p["js"], p["ja"], jo, jd, 1e-3, far,
                              sorted_ids=True),
            "any": getattr(jtp, "any_hit" + sfx)(
                p["js"], p["ja"], jo, jd, 1e-3, jnp.asarray(p["reach"]))}
    return out


@pytest.mark.parametrize("route", ["bvh8", "no_w8"])
@pytest.mark.parametrize("form", ["array", "planar"])
def test_traversal_skip_entry_points_match_jax(bench_pair, jax_pallas_hits,
                                               route, form):
    """traversal_skip.closest_hit / any_hit and their _p forms against
    the JAX traversal_pallas ones: K1 on the BVH8 accel, K3 without the
    table; both leaf-pool and original ids."""
    p = bench_pair
    want = jax_pallas_hits[form]
    o, d, _, _ = _rays_of(form, p["o"], p["d"])
    sfx = "" if form == "array" else "_p"
    closest = getattr(traversal_skip, "closest_hit" + sfx)
    _hits_agree(closest(p["ts"], p[route], o, d, 1e-3, 1e32), want["closest"])
    _hits_agree(closest(p["ts"], p[route], o, d, 1e-3, 1e32,
                        sorted_ids=True), want["sorted"])
    occ = getattr(traversal_skip, "any_hit" + sfx)(
        p["ts"], p[route], o, d, 1e-3, torch.as_tensor(p["reach"]))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(want["any"]))


DISPATCH = ["trace_closest", "trace_closest_p", "trace_any", "trace_any_p"]


@pytest.mark.parametrize("route", ["bruteforce", "bvh8", "no_w8",
                                   "two_level"])
@pytest.mark.parametrize("fn", DISPATCH)
def test_trace_dispatch_matches_jax(bench_pair, two_level, route, fn):
    """renderer's dispatches against JAX's, by config.traversal and the
    accel: brute force, the BVH8 accel (K1), the accel without it (K3),
    and a TwoLevelFlat (K4; JAX's brute force over the same instances is
    the reference, and its closest hits carry the instance id).  t_min
    is the argument's, not the config's."""
    p = bench_pair
    traversal_mode = "bruteforce" if route == "bruteforce" else "bvh"
    cfg = RenderConfig(traversal=traversal_mode, **FRAME)
    jcfg = JRenderConfig(traversal=traversal_mode, **FRAME)
    form = "planar" if fn.endswith("_p") else "array"
    if route == "two_level":
        tl, jsoup, (o_np, d_np) = two_level
        scene, accel, jscene, jaccel = None, tl, jsoup, None
        jcfg = dataclasses.replace(jcfg, traversal="bruteforce")
        reach = np.full(o_np.shape[0], 4.0, np.float32)
    else:
        scene, jscene, jaccel = p["ts"], p["js"], p["ja"]
        accel = None if route == "bruteforce" else p[route]
        o_np, d_np, reach = p["o"], p["d"], p["reach"]
    o, d, jo, jd = _rays_of(form, o_np, d_np)
    t_min = 0.5 if "closest" in fn else 1e-3
    if "closest" in fn:
        got = getattr(renderer, fn)(scene, accel, o, d, t_min, 1e32, cfg)
        want = getattr(jrenderer, fn)(jscene, jaccel, jo, jd, t_min,
                                      jnp.float32(1e32), jcfg)
        if route == "two_level":
            t, tri, inst, u, v = got
            jinst = np.asarray(jsoup.tri_inst)[np.maximum(
                np.asarray(want[1]), 0)]
            hit = np.asarray(want[1]) >= 0
            np.testing.assert_array_equal(tri.numpy() >= 0, hit)
            assert (inst.numpy()[hit] == jinst[hit]).mean() >= 0.99
            np.testing.assert_allclose(t.numpy()[hit],
                                       np.asarray(want[0])[hit], rtol=1e-4)
        else:
            _hits_agree(got, want)
    else:
        got = getattr(renderer, fn)(scene, accel, o, d, t_min,
                                    torch.as_tensor(reach), cfg)
        want = getattr(jrenderer, fn)(jscene, jaccel, jo, jd, t_min,
                                      jnp.asarray(reach), jcfg)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert 0.05 < got.float().mean() < 0.95


def test_interpolate_hit_matches_jax(bench_pair):
    p = bench_pair
    rs = np.random.RandomState(70)
    n = 1024
    tri = rs.randint(-1, p["js"].num_triangles, n).astype(np.int32)
    u = rs.uniform(0, 1, n).astype(np.float32)
    v = (rs.uniform(0, 1, n) * (1 - u)).astype(np.float32)
    (tt, jt), (tu, ju), (tv, jv) = _both(tri, u, v)
    nrm, uv, mat = renderer.interpolate_hit(p["ts"], tt, tu, tv)
    jnrm, juv, jmat = jrenderer.interpolate_hit(p["js"], jt, ju, jv)
    _close(nrm, jnrm)
    _close(uv, juv)
    np.testing.assert_array_equal(mat.numpy(), np.asarray(jmat))
    assert mat.dtype == torch.int32


def test_render_frame_matches_jax_and_render_frames(bench_pair):
    """render_frame on JAX's accel against JAX's render_frame (its plain
    references: traversal='bvh', shade_pallas=False), and bit for bit
    against the port's render_frames(..., frame, 1)[0]."""
    p = bench_pair
    jcfg = JRenderConfig(traversal="bvh", shade_pallas=False, **FRAME)
    jimg = np.asarray(jrenderer.render_frame(
        p["js"], p["ja"], jrenderer.camera_arrays(JCamera(**BENCH_CAM),
                                                  jcfg),
        jnp.uint32(2), jcfg))
    cfg = RenderConfig(**FRAME)
    cams = renderer.camera_arrays(Camera(**BENCH_CAM), cfg, "cpu")
    img = renderer.render_frame(p["ts"], p["bvh8"], cams, 2, cfg)
    assert img.shape == (24, 32, 3) and img.device.type == "cpu"
    assert psnr(np.clip(img.numpy(), 0, 4), np.clip(jimg, 0, 4),
                peak=4.0) > 45.0
    ref = renderer.render_frames(p["ts"], p["bvh8"], cams, 2, 1, cfg)[0]
    np.testing.assert_array_equal(img.numpy().view(np.int32),
                                  ref.numpy().view(np.int32))
