"""PyTorch port: FTCS diffusion's plain version (the kernel itself is in
test_torch_cuda.py), the secretion deposit and the nearest-point sample vs
the JAX package.

The FTCS subcycle keeps the JAX scan's operand association and float32
coefficients, so the plain version agrees with ``ftcs_diffuse`` to float32
rounding (atol 1e-6 on concentrations <= 2); the Pallas kernel fuses the
stencil differently on its backend and is held to the same atol. The
deposit is a scatter-add whose accumulation order differs (atol 1e-7).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipsc_abm_tpu.ops import diffusion as jdiff
from hipsc_abm_tpu.ops.pallas_diffusion import ftcs_diffuse_pallas
from hipsc_abm_tpu_torch import kernels
from hipsc_abm_tpu_torch.ops import diffusion as tdiff
from hipsc_abm_tpu_torch.ops import ftcs as tftcs

ARGS = (2.0, 400.0, 2.0, 0.1)  # diffuse_const, spat_res2, max_concentration, degradation


def _lattice(seed=0, shape=(40, 37)):
    rs = np.random.default_rng(seed)
    g = rs.random(shape).astype(np.float32) * 2.4 - 0.2  # exercises both clips
    g[5:9, 10:14] = 2.0
    return g


@pytest.mark.parametrize("step_dt,diffuse_dt", [(1800.0, 6.0), (100.0, 7.0)])
def test_ftcs_plain_matches_jax_scan(step_dt, diffuse_dt):
    g = _lattice()
    dts = tdiff.diffusion_dts(step_dt, diffuse_dt)
    np.testing.assert_array_equal(dts, jdiff.diffusion_dts(step_dt, diffuse_dt))
    want = np.asarray(jdiff.ftcs_diffuse(jnp.asarray(g), jnp.asarray(dts), *ARGS))
    got = tdiff.ftcs_diffuse(torch.from_numpy(g), dts, *ARGS).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_ftcs_plain_matches_pallas_interpret():
    g = _lattice(seed=1)
    dts = tdiff.diffusion_dts(1800.0, 6.0)
    want = np.asarray(ftcs_diffuse_pallas(jnp.asarray(g), dts, *ARGS, interpret=True))
    got = tdiff.ftcs_diffuse(torch.from_numpy(g), dts, *ARGS).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_one_subcycle_is_the_clamped_stencil():
    """The kernel's formulation (neighbour indices clamped into the
    interior) equals the padded ghost-ring subcycle bit for bit."""
    g = torch.from_numpy(_lattice(seed=2))
    a, b = tdiff.ftcs_coefficients(6.0, 2.0, 400.0)
    padded = tdiff.ftcs_subcycle(torch.nn.functional.pad(g, (1, 1, 1, 1)), a, b)[1:-1, 1:-1]
    nx, ny = g.shape
    i = torch.arange(nx)
    j = torch.arange(ny)
    down = g[(i + 1).clamp(max=nx - 1)]
    up = g[(i - 1).clamp(min=0)]
    right = g[:, (j + 1).clamp(max=ny - 1)]
    left = g[:, (j - 1).clamp(min=0)]
    clamped = b * g + a * (((down + up) + right) + left)
    assert torch.equal(padded, clamped)


def test_coefficients_are_float32_like_the_scan():
    for dt in (6.0, 0.0, 3.7):
        a, b = tdiff.ftcs_coefficients(dt, 2.0, 400.0)
        ja = jnp.float32(dt) * 2.0 / 400.0
        assert np.float32(a) == np.asarray(ja) and np.float32(b) == np.asarray(1.0 - 4.0 * ja)


def test_deposit_and_sample_match_jax():
    rs = np.random.default_rng(3)
    g = _lattice(seed=3).clip(0, None)
    C = 300
    locs = np.zeros((C, 3), np.float32)
    locs[:, :2] = rs.random((C, 2)).astype(np.float32) * np.float32(20.0 * 40)
    locs[:4, :2] = [[0.0, 0.0], [799.9, 719.9], [20.0, 40.0], [10.0, 10.0]]
    amounts = np.where(rs.random(C) < 0.7, 0.01, 0.0).astype(np.float32) - 0.002
    want = np.asarray(jdiff.deposit_morphogen(jnp.asarray(g), jnp.asarray(locs),
                                              jnp.asarray(amounts), 20.0))
    got = tdiff.deposit_morphogen(torch.from_numpy(g), torch.from_numpy(locs),
                                  torch.from_numpy(amounts), 20.0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    np.testing.assert_array_equal(
        tdiff.sample_concentration(torch.from_numpy(g), torch.from_numpy(locs), 20.0).numpy(),
        np.asarray(jdiff.sample_concentration(jnp.asarray(g), jnp.asarray(locs), 20.0)),
    )


def test_cpu_wrapper_runs_plain_and_counts_no_launch():
    g = torch.from_numpy(_lattice(seed=4))
    dts = tdiff.diffusion_dts(60.0, 6.0)
    before = kernels.launch_counts["ftcs_diffuse"]
    assert torch.equal(tftcs.ftcs_diffuse_cuda(g, dts, *ARGS),
                       tdiff.ftcs_diffuse(g, dts, *ARGS))
    assert kernels.launch_counts["ftcs_diffuse"] == before
