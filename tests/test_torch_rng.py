"""PyTorch port: id-keyed hash RNG and threefry step keys vs the JAX package.

Integer outputs (keys, hash bits, coin flips) and the 24-bit uniforms must
be bit-identical. The Box-Muller normals and unit vectors go through libm
``log``/``cos``/``sin``, which PyTorch and XLA:CPU implement separately:
they agree to a few float32 ulps (atol 1e-6 on values of order 1).
"""

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
    np.testing.assert_allclose(
        trng.normal(tkey, tids).numpy(), np.asarray(jrng.normal(jkey, jnp.asarray(ids))),
        rtol=0, atol=1e-6,
    )
    for two_d in (True, False):
        np.testing.assert_allclose(
            trng.unit_vectors(tkey, tids, two_d, salt=1).numpy(),
            np.asarray(jrng.unit_vectors(jkey, jnp.asarray(ids), two_d, salt=1)),
            rtol=0, atol=1e-6,
        )
