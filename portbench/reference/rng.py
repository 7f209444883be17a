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

The float draws (``normal``, ``unit_vectors``) equal the
JAX package's bit for bit as XLA:CPU computes them on an x86-64 machine with
FMA and glibc 2.36: ``log`` is XLA's own float32 polynomial
(``log_f32``), ``cos`` and ``sin`` are glibc's ``cosf`` and
``sinf``, which XLA:CPU calls (``cosf_glibc``, ``sinf_glibc``), and ``sqrt``
is correctly rounded. The mirrors are plain float32/float64 arithmetic, so
the card gives the same bits as the CPU; under another libm or without FMA,
XLA:CPU's own draws would differ from them. Here they run as these plain
mirrors on any device.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
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


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root of float32 ``x``, as XLA's
    ``sqrt`` (``llvm.sqrt``) and the card's ``__fsqrt_rn`` give it.
    PyTorch's own CPU ``sqrt`` is not correctly rounded on every machine,
    in float32 or float64 (on an AVX-512 machine it parted from numpy's at
    ~0.6% of inputs), so the float64 root rounded to float32 is corrected
    by exact tests: a float32 value's midpoints with its neighbours have 25
    bits, so their squares are exact in float64 and say on which side of
    each midpoint ``sqrt(x)`` lies. Two steps mend a start up to two ulps
    off. On the card PyTorch's ``sqrt`` is ``sqrtf``, correctly rounded
    (its kernels are built without fast-math), and is taken as it is."""
    if x.device.type == "cuda" and x.dtype == torch.float32:
        return torch.sqrt(x)
    x64 = x.to(torch.float64)
    r = torch.sqrt(x64).to(torch.float32)
    for _ in range(2):
        r64 = r.to(torch.float64)
        down = torch.nextafter(r, torch.zeros_like(r))
        up = torch.nextafter(r, torch.full_like(r, float("inf")))
        below = (r64 + down.to(torch.float64)) * 0.5
        above = (r64 + up.to(torch.float64)) * 0.5
        r = torch.where(below * below > x64, down, torch.where(above * above < x64, up, r))
    return r


# ---------------------------------------------------------------------------
# Mirrors of what XLA:CPU computes for the draws' float32 log, log1p, cos and
# sin. Each is written in float32 and float64 + - * /, integer and bit ops and
# ``where``; every eager op rounds once, so the CPU and the card give the same
# bits, and csrc/draws.cu repeats the same operations in CUDA C++.
# ---------------------------------------------------------------------------


def fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` in float32 (``b`` and ``c`` tensors or floats) rounded
    once, as a hardware fused multiply-add (``fmaf``, the card's
    ``__fmaf_rn``). The product of two float32 values is exact in float64;
    the float64 sum is made round-to-odd from its exact error (TwoSum), and
    a round-to-odd value with 53 bits rounds to float32 as the exact sum
    would."""
    a64 = a.to(torch.float64)
    b64 = b.to(torch.float64) if isinstance(b, torch.Tensor) else float(b)
    c64 = c.to(torch.float64) if isinstance(c, torch.Tensor) else float(c)
    prod = a64 * b64
    s = prod + c64
    t = s - prod
    err = (prod - (s - t)) + (c64 - t)
    # round to odd: step s toward zero where it lies beyond the exact sum,
    # then set its last bit where the sum was inexact
    beyond = (err * torch.sign(s) < 0).to(torch.int64)
    odd = (s.view(torch.int64) - beyond) | (err != 0).to(torch.int64)
    return odd.view(torch.float64).to(torch.float32)


def _hexf(*values: str) -> tuple:
    return tuple(float.fromhex(v) for v in values)


# XLA's float32 log (the Cephes polynomial that XLA:CPU inlines for ``log``
# and for ``log1p`` at |x| >= sqrt(2) - 1): p0..p8, then ln(2) split as
# q2 + q1, and sqrt(1/2)
_LOG_P = _hexf("0x1.204376p-4", "-0x1.d7a37p-4", "0x1.de4a34p-4", "-0x1.fcba9ep-4",
               "0x1.23d37ep-3", "-0x1.555ca0p-3", "0x1.999d58p-3", "-0x1.fffff8p-3",
               "0x1.555554p-2")
_LOG_Q1, _LOG_Q2 = _hexf("-0x1.bd0106p-13", "0x1.63p-1")
_SQRT_HALF_F32 = float.fromhex("0x1.6a09e6p-1")
_F32_MIN_NORMAL = float.fromhex("0x1p-126")
def _log_core(x: torch.Tensor) -> torch.Tensor:
    """The body of XLA's float32 ``log`` (no special values), with its
    fused multiply-adds where XLA:CPU's backend forms them on an FMA
    machine (the object code of ``jnp.log`` / ``jnp.log1p``). Inputs below
    the smallest normal (and NaN) are read as the smallest normal, as
    XLA's range reduction reads them. (XLA:CPU runs with subnormals flushed
    to zero, so there a subnormal input is 0; no draw reaches one.)"""
    x = torch.where(x > _F32_MIN_NORMAL, x, torch.full_like(x, _F32_MIN_NORMAL))
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    m = ((bits & -2139095041) | 0x3F000000).view(torch.float32)  # & 0x807FFFFF
    below = m < _SQRT_HALF_F32
    e = e - below.to(torch.float32)
    r = (m - 1.0) + torch.where(below, m, torch.zeros_like(m))
    r2 = r * r
    r3 = r2 * r
    p = _LOG_P
    y = fma_f32(fma_f32(r, p[0], p[1]), r, p[2])
    y1 = fma_f32(fma_f32(r, p[3], p[4]), r, p[5])
    y2 = fma_f32(fma_f32(r, p[6], p[7]), r, p[8])
    y = fma_f32(fma_f32(fma_f32(y, r3, y1), r3, y2), r3, e * _LOG_Q1)
    # r - r^2/2 is one fused negative multiply-add in XLA; r^2/2 is exact
    return fma_f32(e, _LOG_Q2, (r - r2 * 0.5) + y)


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log`` of float32 as XLA:CPU computes it (its own polynomial,
    not libm): bit-equal over every input of the draws, the 2^24 values
    ``u + 2^-25`` (``tests/test_torch_rng.py``)."""
    out = _log_core(x)
    out = torch.where(x > 0, out, torch.full_like(x, float("nan")))
    out = torch.where(x == 0, torch.full_like(x, -float("inf")), out)
    return torch.where(x == float("inf"), x, out)


_HPI_INV = float.fromhex("0x1.45f306dc9c883p+23")
_HPI = float.fromhex("0x1.921fb54442d18p+0")
# pi/2 as hi + lo, hi with 29 significant bits: n * hi and x - n * hi are
# exact for the quadrants n <= 4 of [0, 120), so (x - n hi) - n lo rounds
# once, as glibc's fused x - n * pi/2 does
_HPI_HI = float.fromhex("0x1.921fb54p+0")
_HPI_LO = _HPI - _HPI_HI
_COS_C = _hexf("0x1p0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5",
               "-0x1.6c087e89a359dp-10", "0x1.99343027bf8c3p-16")
_SIN_S = _hexf("-0x1.555545995a603p-3", "0x1.1107605230bc4p-7", "-0x1.994eb3774cf24p-13")


def _sin_poly(xs: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """glibc's ``sinf_poly`` for an even quadrant, in float64. The fused
    multiply-adds of ``__sinf_fma`` are separate multiplies and adds here;
    over the draws' inputs that never changes the float32 result."""
    s = _SIN_S
    x3 = x2 * xs
    x5 = x2 * x3
    return (xs + x3 * s[0]) + x5 * (s[1] + x2 * s[2])


def _cos_poly(x2: torch.Tensor, sign) -> torch.Tensor:
    """glibc's ``sinf_poly`` for an odd quadrant (the cosine polynomial),
    in float64; ``sign`` (+-1) picks the table with c0..c4 negated."""
    c = _COS_C
    x4 = x2 * x2
    x6 = x2 * x4
    c1 = (sign * c[0]) + x2 * (sign * c[1])
    c2 = (sign * c[3]) + x2 * (sign * c[4])
    return (c1 + x4 * (sign * c[2])) + x6 * c2


def _sincosf_glibc(y: torch.Tensor, sine: bool) -> torch.Tensor:
    """glibc 2.36's ``sinf`` (``sine``) or ``cosf`` of float32 ``y`` with
    |y| < 120, the fast path of sysdeps/ieee754/flt-32/s_sinf.c and
    s_cosf.c: below |y| = 0.75 the polynomial of ``y`` itself, else a
    reduction by pi/2 to quadrant ``n`` and the polynomial of the
    remainder. Larger |y| takes glibc's slow reduction, which is not
    mirrored (the draws take ``2 pi u``, u in [0, 1))."""
    x = y.to(torch.float64)
    top = (y.view(torch.int32) >> 20) & 0x7FF
    # the quadrant: glibc's (int32) truncation of x * 2/pi * 2^24, rounded
    # to the nearest multiple of 2^24
    n = ((x * _HPI_INV).to(torch.int32) + 0x800000) >> 24
    nf = n.to(torch.float64)
    xr = (x - nf * _HPI_HI) - nf * _HPI_LO
    # glibc's sign table (+ - - +) at n & 3 scales the sine polynomial's
    # argument; quadrants 2 and 3 take the cosine table with c0..c4 negated
    sin_sign = torch.where(((n & 3) == 1) | ((n & 3) == 2), -1.0, 1.0).to(torch.float64)
    cos_sign = 1.0 - 2.0 * ((n >> 1) & 1).to(torch.float64)
    # sinf takes the sine polynomial in an even quadrant, cosf in an odd one
    use_sin = ((n & 1) == 0) if sine else ((n & 1) == 1)
    x2r = xr * xr
    reduced = torch.where(use_sin, _sin_poly(xr * sin_sign, x2r), _cos_poly(x2r, cos_sign))
    x2 = x * x
    direct = _sin_poly(x, x2) if sine else _cos_poly(x2, 1.0)
    out = torch.where(top < 0x3F4, direct, reduced).to(torch.float32)
    tiny = y if sine else torch.ones_like(y)
    return torch.where(top < 0x398, tiny, out)


def cosf_glibc(y: torch.Tensor) -> torch.Tensor:
    """glibc 2.36's ``cosf`` (|y| < 120), which XLA:CPU calls for
    ``jnp.cos``. Bit-equal over the draws' 2^24 inputs ``2 pi u``."""
    return _sincosf_glibc(y, sine=False)


def sinf_glibc(y: torch.Tensor) -> torch.Tensor:
    """glibc 2.36's ``sinf`` (|y| < 120), which XLA:CPU calls for
    ``jnp.sin``. Bit-equal over the draws' 2^24 inputs ``2 pi u``."""
    return _sincosf_glibc(y, sine=True)


def normal_plain(key, ids: torch.Tensor, salt: int = 0) -> torch.Tensor:
    """``normal`` in PyTorch ops: the plain version of the draw kernel."""
    u1 = uniform(key, ids, salt) + (1.0 / (1 << 25))  # (0, 1]
    u2 = uniform(key, ids, salt + 17)
    return sqrt_f32(-2.0 * log_f32(u1)) * cosf_glibc(_TWO_PI_F32 * u2)


def unit_vectors_plain(key, ids: torch.Tensor, two_d: bool, salt: int = 0) -> torch.Tensor:
    """``unit_vectors`` in PyTorch ops: the plain version of the draw
    kernel."""
    theta = uniform(key, ids, salt) * _TWO_PI_F32
    cos_t, sin_t = cosf_glibc(theta), sinf_glibc(theta)
    if two_d:
        return torch.stack([cos_t, sin_t, torch.zeros_like(theta)], dim=-1)
    phi = uniform(key, ids, salt + 29) * _TWO_PI_F32
    radius = cosf_glibc(phi)
    return torch.stack([radius * cos_t, radius * sin_t, sinf_glibc(phi)], dim=-1)


def normal(key, ids: torch.Tensor, salt: int = 0) -> torch.Tensor:
    """N(0, 1) in float32 via Box-Muller on two independent hash streams,
    bit-equal to the JAX package's ``normal`` on XLA:CPU: its ``log`` is
    XLA's polynomial (``log_f32``), its ``cos`` glibc's (``cosf_glibc``),
    its ``sqrt`` correctly rounded. The plain version on any device."""
    return normal_plain(key, ids, salt)


def unit_vectors(key, ids: torch.Tensor, two_d: bool, salt: int = 0) -> torch.Tensor:
    """Id-keyed batch of the reference's ``random_vector``: a point on the
    unit circle in 2D, else its (non-uniform) sphere parameterization,
    (C, 3) float32, bit-equal to the JAX package's on XLA:CPU (glibc's
    ``cosf``/``sinf``, ``cosf_glibc``). The plain version on any device."""
    return unit_vectors_plain(key, ids, two_d, salt)


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

