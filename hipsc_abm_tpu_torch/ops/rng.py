"""Layout-independent per-agent randomness (port of ``hipsc_abm_tpu/ops/rng.py``).

Every per-agent draw is a pure function of ``(step key, agent id, salt)``
through two keyed murmur3 ``fmix32`` rounds, bit-identical to the JAX
package. PyTorch has few uint32 operations, so the uint32 arithmetic runs in
int64 and is masked back to 32 bits after every step that can carry past
them; products are split into 16-bit halves so that no int64 product
overflows.

The step key is a raw threefry2x32 key, ``(2,)`` int64 holding two uint32
words, as ``jax.random.PRNGKey`` makes it. ``split`` follows JAX's
partitionable counter layout (``jax_threefry_partitionable = True``, the
default of the JAX release the reference is pinned to): key ``i`` of a split
is ``threefry2x32(key, (0, i))``.

Keys are read as tensors, never as host numbers: ``hash_bits`` and
``threefry2x32`` take the key's words by indexing, so a key on the card
stays there (no host read) and a captured CUDA graph reads it as an input
on every replay instead of baking one step's words in. ``threefry2x32``
also runs on plain Python ints (its arithmetic is operators only), which is
how ``split_words`` derives the engine's key schedule on the host: the
schedule does not depend on the colony.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

_MASK = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9  # 2^32 / golden ratio, the classic stream separator
_TWO_PI_F32 = float(torch.tensor(2.0 * math.pi, dtype=torch.float32))


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2^32`` for uint32 values held in int64, without an
    int64 overflow: the constant is applied in two 16-bit halves."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer: full-avalanche 32-bit mixer (bijective)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def _key_words(key) -> tuple:
    """The two uint32 words of a raw key: 0-d int64 tensors on the key's
    device for a tensor key (no host read), Python ints for a pair of
    ints."""
    if isinstance(key, torch.Tensor):
        key = key.to(torch.int64)
    return key[0] & _MASK, key[1] & _MASK


def hash_bits(key, ids: torch.Tensor, salt: int = 0) -> torch.Tensor:
    """uint32 random bits (as int64) per agent id, keyed by a raw key (a
    (2,) int64 tensor on the ids' device) and a small static ``salt``
    separating streams within one phase."""
    k0, k1 = _key_words(key)
    x = ids.to(torch.int64) & _MASK
    h = _fmix32(x ^ k0)
    return _fmix32(h ^ ((k1 + ((_GOLDEN * (salt + 1)) & _MASK)) & _MASK))


def uniform(key, ids: torch.Tensor, salt: int = 0) -> torch.Tensor:
    """U[0, 1) in float32 with 24-bit resolution."""
    return (hash_bits(key, ids, salt) >> 8).to(torch.float32) * (1.0 / (1 << 24))


def coin_flips(key, ids: torch.Tensor, salt: int = 0) -> torch.Tensor:
    """Per-agent randint(0, 1) increments (int32)."""
    return (hash_bits(key, ids, salt) & 1).to(torch.int32)


def f32_via_f64(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` of a float32 tensor, evaluated in float64 and rounded to
    float32. The card's and the CPU's float32 ``log``, ``cos`` and ``sin``
    differ by an ulp (none is correctly rounded); their float64 results
    round to the same float32 but where the exact value lies within a few
    float64 ulps of a float32 rounding boundary. A lone agent's motility
    move repeats every substep, so one ulp of its force that tips the
    rounding of its position makes one ulp of position per substep between
    the card and the CPU; the pathway's normal draw feeds ``floor``, where
    one ulp at a boundary would part integer state."""
    return fn(x.to(torch.float64)).to(torch.float32)


def normal(key, ids: torch.Tensor, salt: int = 0) -> torch.Tensor:
    """N(0, 1) in float32 via Box-Muller on two independent hash streams;
    ``log``, ``sqrt`` and ``cos`` through ``f32_via_f64``, so the card and
    the CPU agree bit for bit (PyTorch's float32 ``sqrt`` on the CPU is not
    correctly rounded either: it parts from numpy's at ~0.5% of inputs)."""
    u1 = uniform(key, ids, salt) + (1.0 / (1 << 25))  # (0, 1]
    u2 = uniform(key, ids, salt + 17)
    return (f32_via_f64(torch.sqrt, -2.0 * f32_via_f64(torch.log, u1))
            * f32_via_f64(torch.cos, _TWO_PI_F32 * u2))


def unit_vectors(key, ids: torch.Tensor, two_d: bool, salt: int = 0) -> torch.Tensor:
    """Id-keyed batch of the reference's ``random_vector``: a point on the
    unit circle in 2D, else its (non-uniform) sphere parameterization."""
    theta = uniform(key, ids, salt) * _TWO_PI_F32
    cos_t, sin_t = f32_via_f64(torch.cos, theta), f32_via_f64(torch.sin, theta)
    if two_d:
        return torch.stack([cos_t, sin_t, torch.zeros_like(theta)], dim=-1)
    phi = uniform(key, ids, salt + 29) * _TWO_PI_F32
    radius = f32_via_f64(torch.cos, phi)
    return torch.stack([radius * cos_t, radius * sin_t, f32_via_f64(torch.sin, phi)], dim=-1)


# ---------------------------------------------------------------------------
# threefry2x32 step keys
# ---------------------------------------------------------------------------

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl32(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) & _MASK) | (x >> (32 - d))


def threefry2x32(key, x0, x1):
    """The Threefry-2x32 block cipher (20 rounds) as JAX implements it, on
    uint32 words held in int64 tensors or in Python ints (the key and the
    counters alike). Returns the two output words."""
    k0, k1 = _key_words(key)
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for rot in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl32(x1, rot) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def prng_key(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with JAX's default 32-bit integers: the
    seed is taken mod 2^32 and padded with a zero high word."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64)


def split(key: torch.Tensor, num: int = 2) -> Sequence[torch.Tensor]:
    """``jax.random.split(key, num)`` in the partitionable layout: key ``i``
    is ``threefry2x32(key, (0, i))``. Returns ``num`` (2,) int64 keys on the
    key's device, computed there (no host read)."""
    counts = torch.arange(num, dtype=torch.int64, device=key.device)
    b0, b1 = threefry2x32(key, torch.zeros_like(counts), counts)
    return list(torch.stack([b0, b1], dim=1).unbind(0))


def split_words(words, num: int = 2) -> list:
    """``split`` on the host: a key as two Python ints in, ``num`` keys as
    pairs of Python ints out (bit-equal to ``split``)."""
    return [threefry2x32(words, 0, i) for i in range(num)]
