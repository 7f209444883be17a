"""PyTorch port: the sorted-grid neighbour search vs the JAX package.

Everything here is integer bookkeeping (sort order, bin table, run bounds,
candidate windows), so the port must agree exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipsc_abm_tpu.ops import neighbors as jnbr
from hipsc_abm_tpu_torch.ops import neighbors as tnbr

BOX = (240.0, 180.0, 0.0)


def _colony(seed, C=320, n=260, radius=15.0):
    rs = np.random.default_rng(seed)
    locs = np.zeros((C, 3), np.float32)
    locs[:n] = rs.random((n, 3)).astype(np.float32) * np.asarray(BOX, np.float32)
    # a few agents stacked in one bin and a few on the box edge
    locs[:6] = locs[6]
    locs[6:9, 0] = BOX[0]
    alive = np.zeros(C, bool)
    alive[:n] = True
    alive[rs.choice(n, 20, replace=False)] = False
    ids = rs.permutation(C).astype(np.int32)  # unique, layout-scrambled
    jspec = jnbr.GridSpec.from_box(BOX, radius, run_cap=16)
    tspec = tnbr.GridSpec(**dataclasses.asdict(jspec))
    return locs, ids, alive, jspec, tspec


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_grid_matches_jax(seed):
    locs, ids, alive, jspec, tspec = _colony(seed)
    jg = jnbr.build_grid(jspec, jnp.asarray(locs), jnp.asarray(ids), jnp.asarray(alive))
    tg = tnbr.build_grid(tspec, torch.from_numpy(locs), torch.from_numpy(ids),
                         torch.from_numpy(alive))
    np.testing.assert_array_equal(tg.order.numpy(), np.asarray(jg.order))
    np.testing.assert_array_equal(tg.sorted_flat.numpy(), np.asarray(jg.sorted_flat))
    np.testing.assert_array_equal(tg.coords.numpy(), np.asarray(jg.coords))
    assert tnbr.dead_sentinel(tspec) == jnbr.dead_sentinel(jspec)
    assert tspec.flat_run_offsets == jspec.flat_run_offsets
    assert tspec.num_bins == jspec.num_bins and tspec.window == jspec.window


@pytest.mark.parametrize("seed", [0, 1])
def test_bin_table_and_run_bounds_match_jax(seed):
    locs, ids, alive, jspec, tspec = _colony(seed)
    jg = jnbr.build_grid(jspec, jnp.asarray(locs), jnp.asarray(ids), jnp.asarray(alive))
    flat = torch.from_numpy(np.asarray(jg.sorted_flat).astype(np.int64))
    np.testing.assert_array_equal(
        tnbr._bin_table(tspec, flat).numpy(),
        np.asarray(jnbr._bin_table(jspec, jg.sorted_flat)),
    )
    np.testing.assert_array_equal(
        tnbr.sorted_run_bounds_from_flat(tspec, flat).numpy(),
        np.asarray(jnbr.sorted_run_bounds_from_flat(jspec, jg.sorted_flat)),
    )


def test_run_windows_match_jax_and_bounds_window():
    locs, ids, alive, jspec, tspec = _colony(3)
    jg = jnbr.build_grid(jspec, jnp.asarray(locs), jnp.asarray(ids), jnp.asarray(alive))
    tg = tnbr.build_grid(tspec, torch.from_numpy(locs), torch.from_numpy(ids),
                         torch.from_numpy(alive))
    jpos, jvalid, jmax = jnbr.window_from_grid(jspec, jg)
    tpos, tvalid, tmax = tnbr.window_from_grid(tspec, tg)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    assert int(tmax) == int(jmax) and int(tmax) <= tspec.run_cap

    # the bounds window (what the plain kernels walk) holds, for every row
    # alive at build, exactly the run window's positions of that row's agent
    bounds = tnbr.run_bounds(tspec, tg.sorted_flat)
    bpos, bvalid = tnbr.bounds_window(bounds)
    order = tg.order.numpy()
    for row in range(len(order)):
        slot = order[row]
        want = set(tpos[slot][tvalid[slot]].tolist()) if alive[slot] else set()
        assert set(bpos[row][bvalid[row]].tolist()) == want, row
