"""PyTorch port: the neighbourhood-moment reduction's plain version (the
kernel itself is in test_torch_cuda.py) vs the JAX package's
``bio_reduce_pallas`` (interpret mode) and its XLA twin
``make_bio_moments_xla``.

The port reads current liveness and the engine's columns (build-time
positions once per step, current positions, int32 features) where the JAX
package re-sentinels the build-time bin ids and packs the rows per call; the
inputs here hold agents killed since the build and daughters born after it,
so the two formulations are held equal on both.

Count lanes (0, 3, 7) and the FGF4 moments (lanes 1, 2: sums of small
integers) are exact in float32 and must be equal. Against the interpreted
TPU kernel the displacement sums are equal bit for bit as well: the port
forms the squared distance as XLA:CPU compiles the TPU kernel
(``ops.xla_f32.sq_sum``) and adds the terms in the kernel's grouping
(``neighbors.grouped_sum``: per chunk and run, 32-lane windows of the
sorted rows). The XLA twin sums each row's padded window of runs x
run_cap lanes in its own 32-lane partials, which the port does not follow:
its displacement sums agree to rtol 1e-6, atol 1e-5 um.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipsc_abm_tpu.engine import make_bio_moments_xla
from hipsc_abm_tpu.ops import neighbors as jnbr
from hipsc_abm_tpu.ops.pallas_bio import bio_reduce_pallas
from hipsc_abm_tpu_torch import kernels
from hipsc_abm_tpu_torch.ops import bio_moments as tbio
from hipsc_abm_tpu_torch.ops import neighbors as tnbr
from test_torch_contact import assert_live_starts

MODES = ["count", "pathway", "motility", "full"]
# lanes each mode defines (the others are zero in the kernel layout)
LANES = {"count": [0], "pathway": [0, 1, 2], "motility": [0, 3, 4, 5, 7, 8, 9],
         "full": [0, 1, 2, 3, 4, 5, 7, 8, 9]}
BOX = (140.0, 120.0, 0.0)
RADIUS = 15.0


def _setup(seed=0, C=256, n=240):
    """Sorted rows of a dense colony: build-time positions, moved current
    positions, three integer features, and a current liveness that kills a
    few build-time agents and adds daughters in slots dead at the build."""
    rs = np.random.default_rng(seed)
    loc0 = np.zeros((C, 3), np.float32)
    loc0[:n, :2] = rs.random((n, 2)).astype(np.float32) * np.asarray(BOX[:2], np.float32)
    alive = np.zeros(C, bool)
    alive[:n] = True
    ids = rs.permutation(C).astype(np.int32)
    jspec = jnbr.GridSpec.from_box(BOX, RADIUS, run_cap=48)
    g = jnbr.build_grid(jspec, jnp.asarray(loc0), jnp.asarray(ids), jnp.asarray(alive))
    o = np.asarray(g.order)
    loc0, ids, alive = loc0[o], ids[o], alive[o]
    curr = loc0.copy()
    curr[:, :2] += rs.normal(0.0, 0.7, (C, 2)).astype(np.float32)
    alive_now = alive.copy()
    alive_now[rs.choice(n, 15, replace=False)] = False
    daughters = n + rs.choice(C - n, 8, replace=False)  # dead at the build (sorted last)
    alive_now[daughters] = True
    curr[daughters, :2] = curr[rs.choice(n, 8), :2] + 0.5
    feats = [rs.integers(0, 3, C).astype(np.int32) for _ in range(3)]
    feats[2][rs.random(C) < 0.6] = 0
    return dict(loc0=loc0, curr=curr, ids=ids, alive=alive, alive_now=alive_now,
                f=feats, flat=np.asarray(g.sorted_flat), jspec=jspec)


def _port_inputs(s):
    """The port's inputs: ``(pos0, alive, bounds, loc1, f0, f1, f2)``."""
    tspec = tnbr.GridSpec(**dataclasses.asdict(s["jspec"]))
    bounds = tnbr.run_bounds(tspec, torch.from_numpy(s["flat"].astype(np.int64)))
    return (tbio.positions(torch.from_numpy(s["loc0"])), torch.from_numpy(s["alive_now"]),
            bounds, torch.from_numpy(s["curr"]), *(torch.from_numpy(f) for f in s["f"]))


def _assert_moments(got, want, lanes, rows=slice(None)):
    np.testing.assert_array_equal(got[rows][:, lanes], want[rows][:, lanes])


@pytest.mark.parametrize("mode", MODES)
def test_plain_matches_pallas_interpret(mode):
    s = _setup(seed=0)
    C = len(s["ids"])
    jspec = s["jspec"]
    sentinel = np.float32(jnbr.dead_sentinel(jspec))
    flat_lane = np.where(s["alive_now"], s["flat"].astype(np.float32), sentinel)
    jpack = np.stack([s["loc0"][:, 0], s["loc0"][:, 1], s["curr"][:, 0], s["curr"][:, 1],
                      *[f.astype(np.float32) for f in s["f"]], flat_lane], axis=1)
    sflat = jnp.asarray(s["flat"])
    _, _, span_needed, _ = jnbr.block_span_plan(jspec, sflat, 128, span=C, capacity=C,
                                                chunk=C)
    span = min(-(-int(span_needed) // 128) * 128, C)
    starts, needs, _, _ = jnbr.block_span_plan(jspec, sflat, 128, span=span, capacity=C,
                                               chunk=128)
    want = np.asarray(bio_reduce_pallas(
        jnp.asarray(jpack), starts, needs, block=128, span=span, ny=jspec.ny,
        num_bins=jspec.num_bins, radius=RADIUS, chunk=128, mode=mode, interpret=True))
    args = _port_inputs(s)
    grouping = tnbr.grouping_of_bounds(args[2], span, C, 128)
    assert_live_starts(grouping, starts, args[2])
    got = tbio.bio_moments_plain(*args, radius=RADIUS, mode=mode, grouping=grouping).numpy()
    assert got[:, 0].sum() > C  # a real neighbourhood, not an empty one
    _assert_moments(got, want, list(range(16)))
    born = s["alive_now"] & ~s["alive"]
    assert born.sum() == 8 and not got[born].any() and not want[born].any()


@pytest.mark.parametrize("mode", MODES)
def test_plain_matches_xla_twin(mode):
    """``make_bio_moments_xla`` masks rows by build-time liveness, the kernel
    by current liveness: they agree on every row alive now (the only rows
    the biology phases read), daughters born since the build included."""
    s = _setup(seed=1)
    C = len(s["ids"])
    jspec = s["jspec"]
    ident = jnbr.Grid(order=jnp.arange(C, dtype=jnp.int32),
                      sorted_flat=jnp.asarray(s["flat"]),
                      coords=jnbr._bin_coords(jspec, jnp.asarray(s["loc0"])))
    pos, valid, max_run = jnbr.window_from_grid(jspec, ident)
    assert int(max_run) <= jspec.run_cap
    fn = make_bio_moments_xla(ident, pos, valid, jnp.asarray(s["loc0"]),
                              jnp.asarray(s["ids"]), jnp.asarray(s["alive"]), RADIUS)
    want = np.asarray(fn(jnp.asarray(s["curr"]), *[jnp.asarray(f) for f in s["f"]],
                         jnp.asarray(s["alive_now"]), mode=mode))
    got = tbio.bio_moments_plain(*_port_inputs(s), radius=RADIUS, mode=mode).numpy()
    assert (s["alive_now"] & ~s["alive"]).sum() == 8
    exact = [lane for lane in LANES[mode] if lane in (0, 1, 2, 3, 7)]
    _assert_moments(got, want, exact, rows=s["alive_now"])
    rows = s["alive_now"]
    np.testing.assert_allclose(got[rows][:, LANES[mode]], want[rows][:, LANES[mode]],
                               rtol=1e-6, atol=1e-5)


def test_cpu_wrapper_runs_plain_and_counts_no_launch():
    args = _port_inputs(_setup(seed=2))
    before = kernels.launch_counts["bio_moments"]
    got = tbio.bio_moments_cuda(*args, radius=RADIUS, mode="full")
    want = tbio.bio_moments_plain(*args, radius=RADIUS, mode="full")
    assert torch.equal(got, want)
    assert kernels.launch_counts["bio_moments"] == before
    with pytest.raises(ValueError):
        tbio.bio_moments_cuda(*args, radius=RADIUS, mode="bogus")


@pytest.mark.parametrize("mode", MODES)
def test_modes_read_only_their_inputs(mode):
    """Each mode runs with only the inputs it reads (the engine's calls) and
    gives the lanes of the same mode with every input given; a mode missing
    an input it reads raises."""
    args = _port_inputs(_setup(seed=3))
    reads = {"count": 3, "pathway": 5, "motility": 7, "full": 7}[mode]
    trimmed = list(args[:3]) + [None] * 4
    if reads == 5:
        trimmed[4] = args[4]
    elif reads == 7:
        trimmed = list(args)
    want = tbio.bio_moments_plain(*args, radius=RADIUS, mode=mode)
    assert torch.equal(tbio.bio_moments_cuda(*trimmed, radius=RADIUS, mode=mode), want)
    if mode != "count":
        with pytest.raises(ValueError, match="reads"):
            tbio.bio_moments_cuda(*args[:3], radius=RADIUS, mode=mode)
