"""Counter-based RNG, bit for bit as hrt_tpu/ops/rng.py (the reference
shaders' xxHash32-style pixel hash and PCG32 stream).

torch.uint32 lacks add, shifts and comparisons, so a 32-bit word is
carried as an int64 tensor holding its uint32 value, masked back to 32
bits after every step (as ops/morton.py does).  A product of two 32-bit
words can reach 2^64 and overflow int64, so every multiplication by a
constant goes through `_mul32`, which splits the constant into 16-bit
halves: each partial product stays below 2^48 and the low 32 bits of
the sum are exact.  The helpers return the advanced state functionally,
as the JAX package's do.
"""
from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
# xxHash32 primes (ref: shaders/random.slang:3).
_PRIME1 = 2246822519
_PRIME2 = 3266489917
_PRIME3 = 668265263
_PRIME4 = 374761393
# rand's scale, rounded to float32 as the JAX package's
# jnp.float32(1.0 / 4294967295.0); a 0-d CPU tensor so that the product
# is taken in float32 on any device.
_INV_U32 = torch.tensor(np.float32(1.0 / 4294967295.0))


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for words x in [0, 2^32) and a constant c in
    [0, 2^32), without an int64 overflow: x * c_lo < 2^48 and
    (x * c_hi) mod 2^16 shifted by 16 < 2^32."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & M32) | (x >> (32 - r))


def as_word(x) -> torch.Tensor:
    """An int64 tensor of uint32 words from any integer tensor (an
    int32 holding a uint32 bit pattern keeps its bits)."""
    return torch.as_tensor(x).to(torch.int64) & M32


def hash3(x, y, z) -> torch.Tensor:
    """xxHash32-style hash of a uint3 (ref: shaders/random.slang:2-12):
    `hash(uint3(p))` with p.x = x, p.y = y, p.z = z."""
    x, y, z = as_word(x), as_word(y), as_word(z)
    h = (z + _PRIME4 + _mul32(x, _PRIME2)) & M32
    h = _mul32(_rotl(h, 17), _PRIME3)
    h = (h + _mul32(y, _PRIME2)) & M32
    h = _mul32(_rotl(h, 17), _PRIME3)
    h = _mul32(h ^ (h >> 15), _PRIME1)
    h = _mul32(h ^ (h >> 13), _PRIME2)
    return h ^ (h >> 16)


def pcg(state: torch.Tensor):
    """One PCG32 step (ref: shaders/random.slang:14-19) -> (word,
    new_state), with the reference's quirk kept: the new state is
    `prev`, the word is `prev`'s output."""
    prev = (_mul32(as_word(state), 747796405) + 2891336453) & M32
    word = _mul32((prev >> ((prev >> 28) + 4)) ^ prev, 277803737)
    return (word >> 22) ^ word, prev


def rand(state: torch.Tensor):
    """Uniform float32 in [0, 1] + new state (ref: random.slang:21-24):
    the word converted to float32 first (rounded to nearest, so the
    largest words give exactly 1.0), then one float32 product."""
    word, state = pcg(state)
    return word.to(torch.float32) * _INV_U32, state


def rand2(state: torch.Tensor):
    """Two uniforms + new state."""
    u0, state = rand(state)
    u1, state = rand(state)
    return u0, u1, state


def as_frame(frame, device) -> torch.Tensor:
    """The frame index as a tensor on `device`: a tensor as it is (no
    copy where it already lies there), a Python int as a 0-d int64
    tensor made by a fill on the device, with no copy from the host (so
    that a captured frame program can take it)."""
    if isinstance(frame, torch.Tensor):
        return frame.to(device)
    return torch.full((), frame, dtype=torch.int64, device=device)


def pixel_seed(px, py, frame) -> torch.Tensor:
    """Per-pixel seed hash(uint3(pixel.xy, frame))
    (ref: shaders/raytracing.slang:96); `frame` an int or a 0-d integer
    tensor (as_frame), which give the same words."""
    px = torch.as_tensor(px)
    frame = as_frame(frame, px.device)
    return hash3(px, py, torch.broadcast_to(as_word(frame), px.shape))
