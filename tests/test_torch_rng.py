"""PyTorch port: id-keyed hash RNG and threefry step keys vs the JAX package.

Everything is bit-identical: keys, hash bits, coin flips, the 24-bit
uniforms, and the float draws. The Box-Muller normals and unit vectors go
through float32 ``log``, ``cos`` and ``sin``; the port mirrors what XLA:CPU
computes for them (``ops.rng.log_f32``, XLA's own polynomial, and
``cosf_glibc``/``sinf_glibc``, glibc 2.36's ``cosf``/``sinf``, which XLA:CPU
calls). The tests assume what the mirrors were read from: XLA:CPU on an
x86-64 machine with FMA and glibc 2.36. The draws take their inputs from a
finite set, the 2^24 hash uniforms, so the mirrors and the draws are checked
over every input: ``hash_preimage`` gives the ids whose uniforms are all of
them. Each exhaustive case runs in chunks of 2^20 values, a few seconds.
"""

import ctypes
import ctypes.util
import math
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipsc_abm_tpu.ops import rng as jrng
from hipsc_abm_tpu_torch.ops import rng as trng

SEEDS = [0, 1, 2, 3, 7, 42, 99, 123, 1000, 4242, 65535, 65536, 99991, 123456,
         2**20 + 5, 2**24 - 1, 2**24, 2**30 + 17, 2**31 - 1, 2**32 - 1,
         2**32 + 3, 2**40 + 11, 31337, 8675309]


def _tkey(jkey):
    return torch.from_numpy(np.asarray(jkey).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_split_match_jax(seed):
    jkey = jax.random.PRNGKey(seed)
    tkey = trng.prng_key(seed)
    np.testing.assert_array_equal(tkey.numpy(), np.asarray(jkey).astype(np.int64))
    for num in (2, 6):
        np.testing.assert_array_equal(
            torch.stack(trng.split(tkey, num)).numpy(),
            np.asarray(jax.random.split(jkey, num)).astype(np.int64),
        )


def test_step_key_chain_matches_jax():
    """The engine's per-step derivation: 20 steps of ``split(key, 6)``,
    carrying the first child and using the others as phase keys."""
    jkey, tkey = jax.random.PRNGKey(5), trng.prng_key(5)
    for _ in range(20):
        jkeys = np.asarray(jax.random.split(jkey, 6)).astype(np.int64)
        tkeys = torch.stack(trng.split(tkey, 6)).numpy()
        np.testing.assert_array_equal(tkeys, jkeys)
        jkey, tkey = jnp.asarray(jkeys[0].astype(np.uint32)), torch.from_numpy(tkeys[0])


@pytest.mark.parametrize("salt", [0, 1, 17, 29])
def test_hash_uniform_coin_flips_match_jax(salt):
    ids = np.random.default_rng(salt).integers(0, 2**31 - 1, 4000).astype(np.int32)
    jkey = jax.random.split(jax.random.PRNGKey(11), 6)[salt % 6]
    tkey, tids = _tkey(jkey), torch.from_numpy(ids)
    np.testing.assert_array_equal(
        trng.hash_bits(tkey, tids, salt).numpy(),
        np.asarray(jrng.hash_bits(jkey, jnp.asarray(ids), salt)).astype(np.int64),
    )
    np.testing.assert_array_equal(
        trng.uniform(tkey, tids, salt).numpy(),
        np.asarray(jrng.uniform(jkey, jnp.asarray(ids), salt)),
    )
    np.testing.assert_array_equal(
        trng.coin_flips(tkey, tids, salt).numpy(),
        np.asarray(jrng.coin_flips(jkey, jnp.asarray(ids), salt)),
    )


def test_normal_and_unit_vectors_match_jax():
    ids = np.arange(0, 20000, 3, dtype=np.int32)
    jkey = jax.random.PRNGKey(3)
    tkey, tids = _tkey(jkey), torch.from_numpy(ids)
    np.testing.assert_array_equal(
        trng.normal(tkey, tids).numpy(), np.asarray(jrng.normal(jkey, jnp.asarray(ids))))
    for two_d in (True, False):
        np.testing.assert_array_equal(
            trng.unit_vectors(tkey, tids, two_d, salt=1).numpy(),
            np.asarray(jrng.unit_vectors(jkey, jnp.asarray(ids), two_d, salt=1)))


# ---------------------------------------------------------------------------
# every input: the 2^24 hash uniforms
# ---------------------------------------------------------------------------

CHUNK = 1 << 20
ALL_U24 = 1 << 24


def _assert_bits_equal(got: np.ndarray, want: np.ndarray, what: str):
    bad = got.view(np.int32) != want.view(np.int32)
    assert not bad.any(), (f"{what}: {int(bad.sum())} differ, first at "
                           f"{np.argwhere(bad)[0].tolist()}")


def _uniforms(lo: int, hi: int) -> torch.Tensor:
    """The hash uniforms ``k / 2^24`` for k in [lo, hi), as ``rng.uniform``
    makes them."""
    return torch.arange(lo, hi, dtype=torch.int64).to(torch.float32) * (1.0 / (1 << 24))


def test_log_f32_matches_xla_over_all_uniforms():
    """``log_f32`` equals XLA:CPU's ``jnp.log`` at every ``u + 2^-25``, the
    normal draw's radius input."""
    jlog = jax.jit(jnp.log)
    for lo in range(0, ALL_U24, CHUNK):
        u1 = _uniforms(lo, lo + CHUNK) + (1.0 / (1 << 25))
        _assert_bits_equal(trng.log_f32(u1).numpy(), np.asarray(jlog(u1.numpy())),
                           f"log at chunk {lo}")


@pytest.mark.parametrize("name", ["cos", "sin"])
def test_sincosf_match_xla_over_all_uniforms(name):
    """``cosf_glibc`` / ``sinf_glibc`` equal XLA:CPU's ``jnp.cos`` /
    ``jnp.sin`` at every angle ``2 pi u`` the draws take."""
    mirror = trng.cosf_glibc if name == "cos" else trng.sinf_glibc
    jfn = jax.jit(getattr(jnp, name))
    for lo in range(0, ALL_U24, CHUNK):
        theta = _uniforms(lo, lo + CHUNK) * trng._TWO_PI_F32
        _assert_bits_equal(mirror(theta).numpy(), np.asarray(jfn(theta.numpy())),
                           f"{name} at chunk {lo}")


@pytest.mark.parametrize("name", ["cosf", "sinf"])
def test_xla_sincos_are_the_host_glibc(name):
    """The assumption behind the mirrors: XLA:CPU's float32 ``cos``/``sin``
    are the host libm's ``cosf``/``sinf`` (glibc 2.36's, which the mirrors
    copy), called here through ctypes at 20,000 angles of the draws."""
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    fn = getattr(libm, name)
    fn.argtypes, fn.restype = (ctypes.c_float,), ctypes.c_float
    theta = _uniforms(0, ALL_U24)[::839] * trng._TWO_PI_F32
    want = np.array([fn(float(t)) for t in theta], dtype=np.float32)
    got = np.asarray(getattr(jnp, name[:3])(theta.numpy()))
    _assert_bits_equal(got, want, f"jnp.{name[:3]} vs libm {name}")


# (draw, the stream whose uniforms the ids cover, key seed, salt): together
# they reach every input of each function the draws call
DRAW_CASES = [("normal", 0, 3, 0), ("normal", 17, 11, 5), ("unit2d", 0, 7, 1),
              ("unit3d", 29, 42, 0)]


@pytest.mark.parametrize("draw,stream,seed,salt", DRAW_CASES)
def test_draws_match_jax_over_all_uniforms(draw, stream, seed, salt):
    """``rng.normal`` and ``rng.unit_vectors`` (2D, 3D) equal the JAX
    package's draws bit for bit on 2^24 ids whose uniforms in one of the
    draw's streams are every 24-bit uniform (``hash_preimage``)."""
    jkey = jax.random.split(jax.random.PRNGKey(seed), 6)[2]
    tkey = _tkey(jkey)
    for lo in range(0, ALL_U24, CHUNK):
        bits = torch.arange(lo, lo + CHUNK, dtype=torch.int64) << 8
        tids = trng.hash_preimage(tkey, bits, salt + stream)
        assert torch.equal(trng.hash_bits(tkey, tids, salt + stream) >> 8, bits >> 8)
        jids = jnp.asarray(tids.numpy())
        if draw == "normal":
            got, want = trng.normal(tkey, tids, salt), jrng.normal(jkey, jids, salt)
        else:
            two_d = draw == "unit2d"
            got = trng.unit_vectors(tkey, tids, two_d, salt)
            want = jrng.unit_vectors(jkey, jids, two_d, salt)
        _assert_bits_equal(got.numpy(), np.asarray(want), f"{draw} at chunk {lo}")


def test_fma_f32_rounds_once():
    """``fma_f32`` is a float32 fused multiply-add: at products that land on
    a float32 tie, a tiny addend decides the rounding (one rounding of the
    exact sum; a float64 sum rounded again would tie to even), and random
    operands round to the nearest float32 of the exact ``a * b + c``."""
    one = 1.0 + 2.0**-12  # one * one = 1 + 2^-11 + 2^-24, a float32 tie
    a = torch.tensor([one, one, -one, one], dtype=torch.float32)
    c = torch.tensor([2.0**-80, -(2.0**-80), -(2.0**-80), 0.0], dtype=torch.float32)
    got = trng.fma_f32(a, a.abs(), c).numpy()
    want = np.array([1 + 2.0**-11 + 2.0**-23, 1 + 2.0**-11, -(1 + 2.0**-11 + 2.0**-23),
                     1 + 2.0**-11], dtype=np.float32)
    np.testing.assert_array_equal(got, want)
    rs = np.random.default_rng(0)
    a, b = (rs.standard_normal(500).astype(np.float32) for _ in range(2))
    c = (rs.standard_normal(500) * 10.0 ** rs.integers(-9, 9, 500)).astype(np.float32)
    got = trng.fma_f32(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    for x, y, z, r in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        err = abs(Fraction(float(r)) - exact)
        for other in (np.nextafter(r, np.float32(-np.inf)), np.nextafter(r, np.float32(np.inf))):
            assert err <= abs(Fraction(float(other)) - exact)


def test_sqrt_f32_is_correctly_rounded():
    """``sqrt_f32`` equals numpy's float32 ``sqrt`` (correctly rounded) on
    2^22 consecutive floats from 1 and from the subnormals, on 10^6 floats
    of every magnitude, and at 0, -1, inf and NaN."""
    starts = (np.float32(1.0).view(np.int32), np.int32(1))
    runs = [np.arange(b, b + (1 << 22), dtype=np.int32).view(np.float32) for b in starts]
    spread = np.random.default_rng(3).integers(0, 0x7F800000, 1_000_000).astype(np.int32)
    special = np.array([0.0, -1.0, np.inf, np.nan], np.float32)
    with np.errstate(invalid="ignore"):  # the root of -1
        for x in runs + [spread.view(np.float32), special]:
            np.testing.assert_array_equal(trng.sqrt_f32(torch.from_numpy(x)).numpy(),
                                          np.sqrt(x))


def test_hash_preimage_inverts_hash_bits():
    key = trng.prng_key(2024)
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        -2**31, 2**31, 5000).astype(np.int32))
    for salt in (0, 17, 29):
        assert torch.equal(trng.hash_preimage(key, trng.hash_bits(key, ids, salt), salt), ids)


def test_special_values_of_log_mirrors():
    """``log_f32``/``log1p_f32`` at the special inputs, as XLA:CPU: -inf at
    0 (and at -1 for log1p), NaN below, inf at inf. (XLA:CPU also flushes
    subnormal inputs to zero; the mirrors do not, and no draw reaches one.)"""
    x = np.array([0.0, -1.0, np.inf, 1e-30, 1.0, 3.5], np.float32)
    np.testing.assert_array_equal(trng.log_f32(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax.jit(jnp.log)(x)))
    y = np.array([-1.0, -2.0, np.inf, 0.0, 1e-30, 0.3, -0.7, 5.0], np.float32)
    np.testing.assert_array_equal(trng.log1p_f32(torch.from_numpy(y)).numpy(),
                                  np.asarray(jax.jit(jnp.log1p)(y)))
