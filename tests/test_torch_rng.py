"""The port's RNG (hrt_tpu_torch/ops/rng.py) and sort key
(ops/wavefront.py) against the JAX package's, bit for bit, on the CPU:
seeded numpy words with 0 and 0xFFFFFFFF among them, products that would
overflow int64, and the fixed vectors of tests/test_rng.py."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hrt_tpu.ops import rng as jrng
from hrt_tpu.ops import wavefront as jwavefront
from hrt_tpu.ops.v3 import V3 as JV3
from hrt_tpu_torch.ops import rng, wavefront
from hrt_tpu_torch.ops.v3 import V3

from test_rng import py_hash3, py_pcg

M32 = 0xFFFFFFFF
EDGES = np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0xFFFF, 0x10000,
                  0xFFFFFFFE, M32], np.uint32)


def _words(seed: int, n: int = 20000) -> np.ndarray:
    w = np.random.RandomState(seed).randint(0, 2**32, size=n,
                                            dtype=np.uint64).astype(np.uint32)
    w[:EDGES.size] = EDGES
    return w


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(a.astype(np.int64))


def _u32(a: torch.Tensor) -> np.ndarray:
    assert a.dtype == torch.int64
    a = a.numpy()
    assert ((a >= 0) & (a <= M32)).all()
    return a.astype(np.uint32)


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def test_mul32_low_word_exact():
    """Every constant product against Python's unbounded integers, on
    words whose full products pass 2^63."""
    x = _words(0, 4000)
    for c in (2246822519, 3266489917, 668265263, 374761393, 747796405,
              277803737, M32, 0x10000, 1):
        want = np.array([(int(v) * c) & M32 for v in x], np.uint32)
        np.testing.assert_array_equal(_u32(rng._mul32(_t(x), c)), want)


def test_hash3_bit_equal():
    x, y, z = _words(1), _words(2), _words(3)
    want = np.asarray(jrng.hash3(jnp.asarray(x), jnp.asarray(y),
                                 jnp.asarray(z)))
    np.testing.assert_array_equal(_u32(rng.hash3(_t(x), _t(y), _t(z))), want)


@pytest.mark.parametrize("fn", ["pcg", "rand", "rand2"])
def test_stream_bit_equal(fn):
    """Outputs and advanced states over four chained calls."""
    js, ts = jnp.asarray(_words(4)), _t(_words(4))
    for _ in range(4):
        jout = getattr(jrng, fn)(js)
        tout = getattr(rng, fn)(ts)
        js, ts = jout[-1], tout[-1]
        np.testing.assert_array_equal(_u32(ts), np.asarray(js))
        for a, b in zip(tout[:-1], jout[:-1]):
            if fn == "pcg":
                np.testing.assert_array_equal(_u32(a), np.asarray(b))
            else:
                assert a.dtype == torch.float32
                np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))


def _state_for_word(word: int) -> int:
    """The PCG state whose next word is `word`: pcg's steps inverted (the
    final xorshift by 22, the odd multiplier, the xorshift by at least 4
    that leaves the top 4 bits, and the LCG step)."""
    w = word ^ (word >> 22)
    x = (w * pow(277803737, -1, 2**32)) & M32
    k = (x >> 28) + 4
    prev, shifted = x, x >> k
    while shifted:
        prev ^= shifted
        shifted >>= k
    return ((prev - 2891336453) * pow(747796405, -1, 2**32)) & M32


def test_rand_reaches_one():
    """States whose word rounds to 2^32 in float32 give exactly 1.0, as
    in JAX: the float32 conversion comes before the product."""
    words = [M32, M32 - 127, M32 - 128, 0, 1]
    states = np.array([_state_for_word(w) for w in words], np.uint32)
    got, _ = rng.rand(_t(states))
    assert _u32(rng.pcg(_t(states))[0]).tolist() == words
    want, _ = jrng.rand(jnp.asarray(states))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    assert got.tolist()[:2] == [1.0, 1.0] and got.tolist()[3] == 0.0


@pytest.mark.parametrize("frame", [0, 1, 77, M32])
def test_pixel_seed_bit_equal(frame):
    px = np.tile(np.arange(96, dtype=np.uint32), 64)
    py = np.repeat(np.arange(64, dtype=np.uint32), 96) + 1000
    want = np.asarray(jrng.pixel_seed(jnp.asarray(px), jnp.asarray(py),
                                      frame))
    np.testing.assert_array_equal(_u32(rng.pixel_seed(_t(px), _t(py),
                                                      frame)), want)


def test_fixed_vectors():
    """tests/test_rng.py's vectors: the hash of six pixels and eight
    steps of the PCG stream from 12345, against its pure-Python
    reimplementation of shaders/random.slang."""
    xs = np.array([0, 1, 2, 123, 799, 2**31], np.uint32)
    ys = np.array([0, 5, 599, 7, 12, 99], np.uint32)
    zs = np.array([0, 0, 1, 2, 3, 1000], np.uint32)
    want = [py_hash3(int(x), int(y), int(z)) for x, y, z in zip(xs, ys, zs)]
    assert _u32(rng.hash3(_t(xs), _t(ys), _t(zs))).tolist() == want
    state, tstate = 12345, torch.tensor([12345])
    for _ in range(8):
        want_word, state = py_pcg(state)
        word, tstate = rng.pcg(tstate)
        assert int(word) == want_word and int(tstate) == state


def test_int32_and_uint32_inputs():
    """An int32 holding a uint32 bit pattern, and a torch.uint32 tensor,
    hash as their uint32 values."""
    x = _words(5, 512)
    want = _u32(rng.hash3(_t(x), _t(x), _t(x)))
    as_i32 = torch.as_tensor(x.view(np.int32))
    np.testing.assert_array_equal(_u32(rng.hash3(as_i32, as_i32, as_i32)),
                                  want)
    as_u32 = torch.as_tensor(x)
    np.testing.assert_array_equal(_u32(rng.hash3(as_u32, as_u32, as_u32)),
                                  want)


@pytest.mark.parametrize("case", ["random", "flat", "one_point"])
def test_bounce_sort_key_bit_equal(case):
    """The 30-bit key over origins spread in a box, on a flat slab (one
    axis of zero extent) and all at one point."""
    rs = np.random.RandomState(6)
    n = 5000
    o = rs.uniform(-3, 3, (3, n)).astype(np.float32)
    if case == "flat":
        o[1] = 1.0
    elif case == "one_point":
        o[:] = 0.25
    d = rs.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    d[:, :6] = [[1, -1, 0, 0, 0, 0], [0, 0, 1, -1, 0, 0],
                [0, 0, 0, 0, 1, -1]]
    want = np.asarray(jwavefront.bounce_sort_key_p(
        JV3(*map(jnp.asarray, o)), JV3(*map(jnp.asarray, d))))
    got = wavefront.bounce_sort_key_p(V3(*map(torch.as_tensor, o)),
                                      V3(*map(torch.as_tensor, d)))
    np.testing.assert_array_equal(_u32(got), want)
    assert int(got.max()) < 2**30
