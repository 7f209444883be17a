"""PyTorch port: the mirror of glibc's ``powf`` (``ops.xla_f32.powf``), the
general pair law's cube root, against what the JAX package computes.

XLA:CPU lowers ``jnp.power(x, 1/3)`` (``hipsc_abm_tpu/ops/jkr.py``'s
``safe_r ** (1/3)`` and the Pallas kernels' ``jnp.power(r_hat, 1/3)``) to a
call of glibc's ``powf``; on an x86-64 machine with FMA, glibc 2.36 takes
its ``__powf_fma``. Held bit for bit, no tolerance:
- against ``jnp.power`` on XLA:CPU at every float32 ``x`` in ``[2^-25,
  2^-13)``, the reduced radii of equal radii from about 0.06 to 240 um, one
  binade per case;
- against libm's ``powf`` itself, called through ``ctypes``, on a seeded
  sample of 10^5 of those inputs and of inputs across every float32 binade
  (numpy's float32 ``power`` need not be glibc's);
- ``fma_f64``, the double fused multiply-add the mirror emulates, against
  libm's ``fma`` on products that cancel their addend to every depth;
- zero, infinite, negative and NaN inputs take IEEE ``pow``'s values, and
  the derivative is JAX's (``y pow(x, y - 1)``).
"""

import ctypes
import ctypes.util

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipsc_abm_tpu_torch.ops import xla_f32

THIRD = float(np.float32(1.0 / 3.0))
_LIBM = ctypes.CDLL(ctypes.util.find_library("m"))
_LIBM.powf.restype, _LIBM.powf.argtypes = ctypes.c_float, [ctypes.c_float] * 2
_LIBM.fma.restype, _LIBM.fma.argtypes = ctypes.c_double, [ctypes.c_double] * 3


def _binade(e: int) -> np.ndarray:
    """Every float32 in [2^e, 2^(e + 1))."""
    bits = np.arange(1 << 23, dtype=np.int64) + ((e + 127) << 23)
    return bits.astype(np.int32).view(np.float32)


@pytest.mark.parametrize("e", range(-25, -13))
def test_powf_matches_xla_at_every_input(e):
    x = _binade(e)
    want = np.asarray(jax.jit(lambda v: jnp.power(v, 1.0 / 3.0))(x))
    got = xla_f32.powf(torch.from_numpy(x), THIRD).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("span", ["reduced radii", "every binade"])
def test_powf_matches_libm_on_a_sample(span):
    rs = np.random.default_rng(18)
    lo, hi = ((-25 + 127) << 23, (-13 + 127) << 23) if span == "reduced radii" else (1, 0x7F800000)
    x = rs.integers(lo, hi, 100_000).astype(np.int32).view(np.float32)
    want = np.array([_LIBM.powf(float(v), THIRD) for v in x], np.float32)
    got = xla_f32.powf(torch.from_numpy(x), THIRD).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_fma_f64_matches_libm():
    rs = np.random.default_rng(3)
    n = 20_000
    a = rs.standard_normal(n) * 2.0 ** rs.integers(-30, 30, n)
    b = rs.standard_normal(n) * 2.0 ** rs.integers(-30, 30, n)
    # an addend near -a b, to every depth of cancellation
    c = -(a * b) * (1.0 + rs.standard_normal(n) * 2.0 ** rs.integers(-60, 0, n))
    c[: n // 4] = rs.standard_normal(n // 4)
    want = np.array([_LIBM.fma(*t) for t in zip(a, b, c)])
    got = xla_f32.fma_f64(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c))
    np.testing.assert_array_equal(got.numpy().view(np.int64), want.view(np.int64))


def test_powf_special_values_and_derivative():
    x = torch.tensor([0.0, -0.0, float("inf"), -2.0, float("nan"), 1.0, 2.0 ** -140],
                     dtype=torch.float32)
    got = xla_f32.powf(x, THIRD).numpy()
    want = np.array([_LIBM.powf(float(v), THIRD) for v in x.numpy()], np.float32)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~np.isnan(want)], want[~np.isnan(want)])
    r = torch.tensor([3.7e-6, 1.2e-7, 5e-5], dtype=torch.float32, requires_grad=True)
    xla_f32.powf(r, THIRD).sum().backward()
    jgrad = jax.grad(lambda v: jnp.sum(jnp.power(v, 1.0 / 3.0)))(jnp.asarray(r.detach().numpy()))
    np.testing.assert_array_equal(r.grad.numpy(), np.asarray(jgrad))
