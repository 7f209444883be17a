"""PyTorch port: the plan of the persistent FTCS kernel (``ops.ftcs``) and
a CPU emulation of its tiled schedule (the kernel itself runs only on the
card, ``tests/test_torch_cuda.py``).

The emulation does what each CTA of ``csrc/ftcs.cu`` does: load its tile
plus a halo of T cells, advance T subcycles on a region that shrinks by one
cell per subcycle on every side inside the lattice (neighbour indices
clamped into the lattice), write its tile back, and reload after a grid
barrier. Every cell outside the region a subcycle computes is NaN before the
next subcycle reads, so any read of a cell the kernel would hold stale shows
as NaN. The result must equal ``diffusion.ftcs_diffuse`` bit for bit: the
halo cells repeat the same float32 operations.
"""

import numpy as np
import pytest
import torch

from hipsc_abm_tpu_torch.ops import diffusion as tdiff
from hipsc_abm_tpu_torch.ops import ftcs as tftcs
from hipsc_abm_tpu_torch.ops import xla_f32

H100_SMS = 132
H100_SMEM = 232448  # 227 KB of dynamic shared memory per block
ARGS = (2.0, 400.0, 2.0, 0.1)  # diffuse_const, spat_res2, max_concentration, degradation


def _coverage(plan):
    hits = np.zeros((plan.nx, plan.ny), np.int64)
    for r0, r1, c0, c1 in plan.tiles():
        assert r0 < r1 and c0 < c1, "empty tile"
        hits[r0:r1, c0:c1] += 1
    return hits


@pytest.mark.parametrize("shape", [(449, 449), (1001, 1001), (1415, 1415), (37, 53),
                                   (53, 37), (1, 1), (200, 7)])
def test_plan_covers_every_cell_once_and_fits(shape):
    plan = tftcs.ftcs_plan(*shape, H100_SMS, H100_SMEM)
    assert (plan.nx, plan.ny) == shape
    assert np.all(_coverage(plan) == 1)
    assert plan.ctas <= H100_SMS and len(plan.tiles()) == plan.ctas
    assert plan.smem_bytes <= H100_SMEM and 1 <= plan.halo <= tftcs.MAX_HALO
    if shape[0] >= 449:  # the bench lattices fill the card
        assert plan.ctas >= H100_SMS - 12


@pytest.mark.parametrize("halo", [1, 3, 8])
def test_plan_with_fixed_halo(halo):
    plan = tftcs.ftcs_plan(1001, 1001, H100_SMS, H100_SMEM, halo)
    assert plan.halo == halo and np.all(_coverage(plan) == 1)


def test_plan_that_does_not_fit_raises():
    with pytest.raises(ValueError, match="no tiling"):
        tftcs.ftcs_plan(6000, 6000, H100_SMS, H100_SMEM)


def test_schedule_of_diffusion_dts():
    dts = tdiff.diffusion_dts(1800.0, 6.0)
    steps, a_main, b_main, a_last, b_last = tftcs.ftcs_schedule(dts, 2.0, 400.0)
    assert steps == len(dts) == 301
    assert (a_main, b_main) == tdiff.ftcs_coefficients(6.0, 2.0, 400.0)
    assert (a_last, b_last) == tdiff.ftcs_coefficients(0.0, 2.0, 400.0)
    with pytest.raises(ValueError):
        tftcs.ftcs_schedule(np.array([6.0, 5.0, 6.0, 1.0], np.float32), 2.0, 400.0)


def emulate_kernel(lattice, plan, dts, diffuse_const, spat_res2, max_concentration,
                   degradation):
    """``ftcs_diffuse_cuda`` as the kernel computes it, CTA by CTA."""
    nx, ny, h = plan.nx, plan.ny, plan.halo
    steps, a_main, b_main, a_last, b_last = tftcs.ftcs_schedule(dts, diffuse_const, spat_res2)
    bufs = [lattice.clamp(0.0, max_concentration), torch.empty_like(lattice)]
    n_blocks = -(-steps // h)
    for blk in range(n_blocks):
        src, dst = bufs[blk % 2], bufs[(blk + 1) % 2]
        first = blk * h
        for r0, r1, c0, c1 in plan.tiles():
            R0, R1 = max(r0 - h, 0), min(r1 + h, nx)
            Q0, Q1 = max(c0 - h, 0), min(c1 + h, ny)
            assert (R1 - R0, Q1 - Q0) <= plan.region
            cur = src[R0:R1, Q0:Q1].clone()
            for k in range(1, min(h, steps - first) + 1):
                last = first + k == steps
                a, b = (a_last, b_last) if last else (a_main, b_main)
                lo_r, hi_r = (R0 + k if R0 > 0 else 0), (R1 - k if R1 < nx else nx)
                lo_c, hi_c = (Q0 + k if Q0 > 0 else 0), (Q1 - k if Q1 < ny else ny)
                nxt = torch.full_like(cur, float("nan"))
                if lo_r < hi_r and lo_c < hi_c:
                    r = torch.arange(lo_r, hi_r)
                    c = torch.arange(lo_c, hi_c)
                    mid, cc = (r - R0)[:, None], (c - Q0)[None, :]
                    up = ((r - 1).clamp(min=0) - R0)[:, None]
                    down = ((r + 1).clamp(max=nx - 1) - R0)[:, None]
                    left = ((c - 1).clamp(min=0) - Q0)[None, :]
                    right = ((c + 1).clamp(max=ny - 1) - Q0)[None, :]
                    total = ((cur[down, cc] + cur[up, cc]) + cur[mid, right]) + cur[mid, left]
                    nxt[mid, cc] = xla_f32.fma(cur[mid, cc], b, a * total)
                cur = nxt
            dst[r0:r1, c0:c1] = cur[r0 - R0:r1 - R0, c0 - Q0:c1 - Q0]
    return bufs[n_blocks % 2] * (1.0 - degradation)


def _lattice(seed, shape):
    rs = np.random.default_rng(seed)
    g = rs.random(shape).astype(np.float32) * 2.4 - 0.2  # exercises both clips
    g[5:9, 10:14] = 2.0
    return torch.from_numpy(g)


# a 3 x 3 tiling puts tiles on every border, on every corner and one in the
# middle; (100, 7) is 14 full subcycles and one remainder, (20, 7) fewer
# subcycles than the halo
@pytest.mark.parametrize("halo", [1, 3, 8])
@pytest.mark.parametrize("step_dt,diffuse_dt", [(100.0, 7.0), (20.0, 7.0)])
def test_tiled_schedule_is_bit_equal_to_plain(halo, step_dt, diffuse_dt):
    g = _lattice(halo, (37, 53))
    dts = tdiff.diffusion_dts(step_dt, diffuse_dt)
    plan = tftcs.FtcsPlan(37, 53, 13, 18, 3, 3, halo)
    assert np.all(_coverage(plan) == 1)
    got = emulate_kernel(g, plan, dts, *ARGS)
    want = tdiff.ftcs_diffuse(g, dts, *ARGS)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


@pytest.mark.parametrize("halo", [1, 3, 8])
def test_planned_tiling_is_bit_equal_to_plain(halo):
    """The tiling ``ftcs_plan`` chooses for 12 CTAs on an odd lattice."""
    g = _lattice(10 + halo, (37, 53))
    dts = tdiff.diffusion_dts(60.0, 7.0)
    plan = tftcs.ftcs_plan(37, 53, 12, H100_SMEM, halo)
    assert plan.grid_rows > 1 and plan.grid_cols > 1
    assert torch.equal(emulate_kernel(g, plan, dts, *ARGS), tdiff.ftcs_diffuse(g, dts, *ARGS))
