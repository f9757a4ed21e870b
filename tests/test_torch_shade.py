"""K2 (the light-major Disney BRDF): the plain PyTorch version against
the JAX Pallas kernel (interpret mode) and the JAX BRDF on the same
numpy inputs (the CUDA kernel is held against it on a card in
test_torch_cuda.py)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hrt_tpu.models.materials import MatP as JMatP
from hrt_tpu.ops import disney as jdisney, shade_pallas
from hrt_tpu.ops.v3 import V3 as JV3
from hrt_tpu_torch.models.materials import MatP
from hrt_tpu_torch.ops import disney, shade_kernel
from hrt_tpu_torch.ops.v3 import V3

_FIELDS = ("subsurface", "metallic", "roughness", "specular",
           "specular_tint", "anisotropic", "sheen_tint", "clearcoat",
           "clearcoat_gloss")


def _unit(rs, n, hemi=None):
    v = rs.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    if hemi is not None:  # mostly in the hemisphere of `hemi`
        flip = np.sum(v * hemi, axis=1) < 0
        v[flip & (rs.rand(n) < 0.8)] *= -1
    return v.astype(np.float32)


def _inputs(seed, n, num_lights, min_roughness=0.0):
    rs = np.random.RandomState(seed)
    mat = {f: rs.rand(n).astype(np.float32) for f in _FIELDS}
    mat["roughness"] = (min_roughness + (1.0 - min_roughness)
                        * mat["roughness"]).astype(np.float32)
    mat["color"] = rs.rand(n, 3).astype(np.float32)
    nrm = _unit(rs, n)
    view = _unit(rs, n, nrm)
    light = _unit(rs, n * num_lights, np.tile(nrm, (num_lights, 1)))
    relevant = rs.rand(n * num_lights) < 0.7
    return mat, nrm, view, light, relevant


def _mat(lib, mat):
    v3c, arr = (V3, torch.as_tensor) if lib == "torch" else (JV3,
                                                           jnp.asarray)
    zero = arr(np.zeros_like(mat["metallic"]))
    cls = MatP if lib == "torch" else JMatP
    c = mat["color"]
    return cls(color=v3c(arr(c[:, 0]), arr(c[:, 1]), arr(c[:, 2])),
               emissive=v3c(zero, zero, zero), emission_strength=zero,
               ior=zero, transmission=zero,
               **{f: arr(mat[f]) for f in _FIELDS})


def _v(lib, a):
    if lib == "torch":
        return V3(*(torch.as_tensor(np.ascontiguousarray(a[:, i]))
                    for i in range(3)))
    return JV3(*(jnp.asarray(a[:, i]) for i in range(3)))


@pytest.mark.parametrize("seed", [0, 1])
def test_brdf_p_matches_jax(seed):
    mat, nrm, view, light, _ = _inputs(seed, 2048, 1)
    f = disney.brdf_p(_mat("torch", mat), _v("torch", nrm),
                      _v("torch", view), _v("torch", light))
    jf = jdisney.brdf_p(_mat("jax", mat), _v("jax", nrm), _v("jax", view),
                        _v("jax", light))
    assert (f.x > 0).float().mean() > 0.3
    for a, b in zip(f, jf):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


def test_plain_light_major_matches_shade_pallas():
    # Roughness from 0.1 up: below it the GGX lobe is so sharp that the
    # interpret-mode kernel and the JAX package's own brdf_p already
    # differ by ~3e-5 relative (test_brdf_p_matches_jax covers the full
    # range against brdf_p).
    mat, nrm, view, light, rel = _inputs(2, 1024, 2, min_roughness=0.1)
    f = shade_kernel.brdf_light_major_plain(
        _mat("torch", mat), _v("torch", nrm), _v("torch", view),
        _v("torch", light), torch.as_tensor(rel), 2)
    jf = shade_pallas.brdf_light_major(
        _mat("jax", mat), _v("jax", nrm), _v("jax", view),
        _v("jax", light), jnp.asarray(rel), 2)
    for a, b in zip(f, jf):
        a = a.numpy()
        np.testing.assert_allclose(a[rel], np.asarray(b)[rel], rtol=1e-5,
                                   atol=1e-6)
        assert (a[~rel] == 0).all()


def test_cpu_tensors_take_the_plain_version():
    mat, nrm, view, light, rel = _inputs(3, 256, 2)
    before = dict(shade_kernel.LAUNCHES)
    f = shade_kernel.brdf_light_major(
        _mat("torch", mat), _v("torch", nrm), _v("torch", view),
        _v("torch", light), torch.as_tensor(rel), 2)
    assert shade_kernel.LAUNCHES == before
    assert f.x.shape == (512,)
