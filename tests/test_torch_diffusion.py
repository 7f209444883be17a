"""PyTorch port: FTCS diffusion's plain version (the kernel itself is in
test_torch_cuda.py), the secretion deposit and the nearest-point sample vs
the JAX package.

The FTCS subcycle keeps the JAX scan's operand association and float32
coefficients, so the plain version agrees with ``ftcs_diffuse`` to float32
rounding (atol 1e-6 on concentrations <= 2); the Pallas kernel fuses the
stencil differently on its backend and is held to the same atol. The
deposit is a scatter-add whose accumulation order differs (atol 1e-7).

On the card the deposit's sum runs a kernel that adds in a fixed order:
its schedule (a stable sort, then each point's terms left to right) is
emulated here in plain PyTorch and must equal the CPU's sequential
``index_add`` bit for bit. The pathway's normal draw is XLA:CPU's
float32 ``log``, glibc's ``cosf`` and a correctly rounded ``sqrt``
(``ops.rng``), its ``sqrt`` bit-equal to numpy's.
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
from hipsc_abm_tpu_torch.ops import rng as trng
from hipsc_abm_tpu_torch.ops import xla_f32

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
    np.testing.assert_array_equal(got, want)


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
    clamped = xla_f32.fma(g, b, a * (((down + up) + right) + left))
    assert torch.equal(padded, clamped)


def test_coefficients_are_float32_like_the_scan():
    """The coefficients are the TPU kernel's (``ftcs_diffuse_pallas``: a
    and b in float64, each rounded to float32); for the schedules the
    engine runs they equal the XLA scan's float32 ones."""
    for dt in (6.0, 0.0, 3.7):
        a, b = tdiff.ftcs_coefficients(np.float32(dt), 2.0, 400.0)
        a64 = float(np.float32(dt)) * 2.0 / 400.0
        assert (a, b) == (float(np.float32(a64)), float(np.float32(1.0 - 4.0 * a64)))
    for dt in (6.0, 0.0):
        a, b = tdiff.ftcs_coefficients(np.float32(dt), 2.0, 400.0)
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
    np.testing.assert_array_equal(got, want)
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


def _crowded_deposit(n=100_000, shape=(200, 180), spat_res=20.0, seed=5):
    """~100k agents over a 200 x 180 lattice (several terms per point),
    some outside it, with release and uptake (negative) amounts."""
    rs = np.random.default_rng(seed)
    g = _lattice(seed=seed, shape=shape)
    locs = np.zeros((n, 3), np.float32)
    box = np.asarray(shape, np.float32) * np.float32(spat_res)
    locs[:, :2] = (rs.random((n, 2)) * 1.1 - 0.05).astype(np.float32) * box
    amounts = np.where(rs.random(n) < 0.6, 0.01, 0.0).astype(np.float32)
    amounts -= np.where(rs.random(n) < 0.8, 0.0035, 0.0).astype(np.float32)
    return (torch.from_numpy(g), *tdiff.deposit_terms(
        shape, torch.from_numpy(locs), torch.from_numpy(amounts), spat_res))


def test_fixed_order_deposit_equals_index_add():
    """The card kernel's schedule, emulated (``scatter_add_sorted``), is
    bit-equal to the CPU's ``index_add`` on ~100k agents with agents out of
    bounds and uptake; the CPU wrapper runs ``index_add`` and counts no
    launch."""
    g, idx, contrib = _crowded_deposit()
    P = g.numel()
    per_point = torch.bincount(idx[idx < P], minlength=P)
    assert int(per_point.max()) >= 8 and int((idx == P).sum()) > 0
    assert float(contrib.min()) < 0 < float(contrib.max())
    flat = g.reshape(-1)
    want = flat.clone().index_add(0, idx.clamp(max=P - 1),
                                  torch.where(idx < P, contrib, 0.0))
    plain = tdiff.scatter_add_plain(flat, idx, contrib)
    assert torch.equal(plain.view(torch.int32), want.view(torch.int32))
    sorted_sum = tdiff.scatter_add_sorted(flat, idx, contrib)
    assert torch.equal(sorted_sum.view(torch.int32), plain.view(torch.int32))
    # the order matters: the same terms summed in reverse part some points
    rev = tdiff.scatter_add_plain(flat, idx.flip(0), contrib.flip(0))
    assert not torch.equal(rev, plain)
    before = kernels.launch_counts["deposit"]
    assert torch.equal(tdiff.scatter_add_cuda(flat, idx, contrib), plain)
    assert kernels.launch_counts["deposit"] == before


def test_normal_is_float64_log_cos_rounded():
    """``rng.normal`` over 10^6 ids is ``sqrt(-2 log u1) cos(2 pi u2)`` with
    XLA:CPU's float32 ``log`` and glibc's ``cosf`` (``rng.log_f32``,
    ``rng.cosf_glibc``, as the JAX package draws it) and numpy's float64
    ``sqrt`` rounded to float32, bit for bit; and those ``log`` and ``cos``
    lie within 1 ulp of numpy's float64 ``log`` and ``cos`` rounded."""
    key = trng.prng_key(17)
    ids = torch.arange(1_000_000, dtype=torch.int32)
    u1 = trng.uniform(key, ids, 0) + (1.0 / (1 << 25))
    theta = trng._TWO_PI_F32 * trng.uniform(key, ids, 17)
    log_u1, cos_u2 = trng.log_f32(u1).numpy(), trng.cosf_glibc(theta).numpy()
    for got, exact in ((log_u1, np.log(u1.numpy().astype(np.float64))),
                       (cos_u2, np.cos(theta.numpy().astype(np.float64)))):
        rounded = exact.astype(np.float32)
        assert (np.abs(got.view(np.int32) - rounded.view(np.int32)) <= 1).all()
    want = np.sqrt((np.float32(-2.0) * log_u1).astype(np.float64)).astype(np.float32) * cos_u2
    assert want.dtype == np.float32
    x = (np.float32(-2.0) * log_u1)
    np.testing.assert_array_equal(trng.sqrt_f32(torch.from_numpy(x)).numpy(), np.sqrt(x))
    np.testing.assert_array_equal(trng.normal(key, ids).numpy().view(np.int32),
                                  want.view(np.int32))
