"""The bounce samplers of the port (ops/sampling.py, renderer's
_refract_p and _sample_bounce_p) and the new v3 functions against the
JAX package's, on the same seeded numpy planes on the CPU: RNG states
and masks equal; floats within rtol 1e-5 / atol 1e-6 on all but at most
1 in 1000 elements, and within rtol 1e-3 / atol 1e-5 on those.  XLA's and
torch's sin, cos and FMA contraction differ in the last ulp, and a few
samples amplify that: the cap's rim (u0 near 1, where 1 - p1^2 - p2^2
cancels) and G2/G1 near the horizon (grazing views at the smallest
roughness) reach a relative error of ~8e-5.  Random materials cover
metals, transmission > 0 and roughness at and below ROUGHNESS_MIN;
views include grazing ones and rays inside glass at total internal
reflection."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hrt_tpu import renderer as jrenderer
from hrt_tpu.models import materials as jmaterials
from hrt_tpu.ops import sampling as jsampling
from hrt_tpu.ops import v3 as jv3
from hrt_tpu_torch import renderer
from hrt_tpu_torch.models import materials
from hrt_tpu_torch.ops import sampling, v3

TOL = dict(rtol=1e-5, atol=1e-6)
# The ill-conditioned samples' bound, and their largest share.
TOL_ILL = dict(rtol=1e-3, atol=1e-5)
ILL_SHARE = 1e-3
N = 4096


def _unit(rs, n):
    a = rs.normal(size=(3, n)).astype(np.float32)
    return a / np.linalg.norm(a, axis=0)


def _planes(seed: int):
    """(normals, views facing them, materials as 14 numpy fields)."""
    rs = np.random.RandomState(seed)
    n = _unit(rs, N)
    v = _unit(rs, N)
    v = np.where((v * n).sum(0) < 0, -v, v)
    # Grazing views: a thousandth above the tangent plane.
    g = slice(0, N // 8)
    t = v[:, g] - (v[:, g] * n[:, g]).sum(0) * n[:, g]
    t /= np.linalg.norm(t, axis=0)
    v[:, g] = t + 1e-3 * n[:, g]
    v /= np.linalg.norm(v, axis=0)
    rough = rs.uniform(0, 1, N).astype(np.float32)
    rough[:N // 4] = rs.choice([0.0, 1e-5, materials.ROUGHNESS_MIN],
                               N // 4)
    f = lambda lo, hi: rs.uniform(lo, hi, N).astype(np.float32)
    metallic = np.where(rs.rand(N) < 0.3, 1.0, f(0, 1)).astype(np.float32)
    trans = np.where(rs.rand(N) < 0.4, f(0.2, 1), 0.0).astype(np.float32)
    mat = [f(0, 1), f(0, 1), f(0, 1),        # color
           f(0, 1), metallic, rough, f(0, 1), f(0, 1), f(0, 0.9), f(0, 1),
           f(0, 1), f(0, 1),
           f(0, 1), f(0, 1), f(0, 1),        # emissive
           f(0, 2), f(1.0, 2.4), trans]
    return n, v, mat


def _mats(mat):
    """(JAX MatP, port MatP) of the numpy fields."""
    out = []
    for mod, arr, V3 in ((jmaterials, jnp.asarray, jv3.V3),
                         (materials, torch.as_tensor, v3.V3)):
        a = [arr(x) for x in mat]
        out.append(mod.MatP(V3(*a[0:3]), *a[3:12], V3(*a[12:15]), *a[15:18]))
    return out


def _jv(a):
    return jv3.V3(*map(jnp.asarray, a))


def _tv(a):
    return v3.V3(*map(torch.as_tensor, a))


def _close(t, j):
    """TOL on all but ILL_SHARE of the elements, TOL_ILL on those."""
    pairs = zip(t, j) if isinstance(t, v3.V3) else [(t, j)]
    for a, b in pairs:
        a, b = a.numpy(), np.asarray(b)
        off = np.abs(a - b) > TOL["atol"] + TOL["rtol"] * np.abs(b)
        assert off.mean() <= ILL_SHARE, (off.sum(), a[off], b[off])
        np.testing.assert_allclose(a, b, **TOL_ILL)


def _u(seed):
    rs = np.random.RandomState(seed)
    u = rs.uniform(0, 1, (2, N)).astype(np.float32)
    u[:, :4] = [[0, 1, 0, 1], [0, 0, 1, 1]]
    return u


def test_v3_functions():
    rs = np.random.RandomState(0)
    a, b, n = rs.normal(size=(3, N)).astype(np.float32), \
        rs.normal(size=(3, N)).astype(np.float32), _unit(rs, N)
    _close(v3.cross(_tv(a), _tv(b)), jv3.cross(_jv(a), _jv(b)))
    _close(v3.reflect(_tv(a), _tv(n)), jv3.reflect(_jv(a), _jv(n)))
    _close(v3.max_component(_tv(a)), jv3.max_component(_jv(a)))
    _close(v3.to_world(_tv(a), _tv(n)), jv3.to_world(_jv(a), _jv(n)))
    frame = v3.orthonormal_basis(_tv(n))
    jframe = jv3.orthonormal_basis(_jv(n))
    _close(v3.to_world(_tv(a), _tv(n), frame),
           jv3.to_world(_jv(a), _jv(n), jframe))


def test_cosine_hemisphere():
    u0, u1 = _u(1)
    d, pdf = sampling.cosine_hemisphere_p(torch.as_tensor(u0),
                                          torch.as_tensor(u1))
    jd, jpdf = jsampling.cosine_hemisphere_p(jnp.asarray(u0),
                                             jnp.asarray(u1))
    _close(d, jd)
    _close(pdf, jpdf)


@pytest.mark.parametrize("seed", [2, 3])
def test_ggx_vndf_spherical_cap(seed):
    n, v, mat = _planes(seed)
    jm, tm = _mats(mat)
    u0, u1 = _u(seed)
    d, w = sampling.ggx_vndf_spherical_cap_p(tm, _tv(v), _tv(n),
                                             torch.as_tensor(u0),
                                             torch.as_tensor(u1))
    jd, jw = jsampling.ggx_vndf_spherical_cap_p(jm, _jv(v), _jv(n),
                                                jnp.asarray(u0),
                                                jnp.asarray(u1))
    _close(d, jd)
    _close(w, jw)
    assert (w.numpy() > 0).mean() > 0.5


def test_refract_and_tir():
    """Views from outside (eta = 1/ior) and from inside glass (eta =
    ior), the latter past the critical angle on most rays."""
    n, v, mat = _planes(4)
    ior = mat[16]
    for eta in (1.0 / ior, ior):
        d, tir = renderer._refract_p(_tv(v), _tv(n), torch.as_tensor(eta))
        jd, jtir = jrenderer._refract_p(_jv(v), _jv(n), jnp.asarray(eta))
        np.testing.assert_array_equal(tir.numpy(), np.asarray(jtir))
        _close(d, jd)
    assert 0.2 < tir.numpy().mean() < 0.95


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_sample_bounce(seed):
    """Direction, weight, the advanced RNG state and the transmitted
    mask, entering and leaving faces mixed."""
    n, v, mat = _planes(seed)
    jm, tm = _mats(mat)
    rs = np.random.RandomState(seed)
    words = rs.randint(0, 2**32, size=N, dtype=np.uint64).astype(np.uint32)
    entering = rs.rand(N) < 0.6
    frame = v3.orthonormal_basis(_tv(n))
    out = renderer._sample_bounce_p(tm, _tv(n), _tv(v),
                                    torch.as_tensor(words.astype(np.int64)),
                                    torch.as_tensor(entering), frame)
    jout = jrenderer._sample_bounce_p(jm, _jv(n), _jv(v),
                                      jnp.asarray(words),
                                      jnp.asarray(entering),
                                      jv3.orthonormal_basis(_jv(n)))
    _close(out[0], jout[0])
    _close(out[1], jout[1])
    np.testing.assert_array_equal(out[2].numpy().astype(np.uint32),
                                  np.asarray(jout[2]))
    np.testing.assert_array_equal(out[3].numpy(), np.asarray(jout[3]))
    assert 0.05 < out[3].numpy().mean() < 0.5
