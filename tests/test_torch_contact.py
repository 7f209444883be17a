"""PyTorch port: the contact substep's plain version (the CPU path of the
CUDA kernel's wrapper; the kernel itself is in test_torch_cuda.py) vs the
JAX package's ``contact_substep_pallas`` (interpret mode) and ``jkr_substep``.

Tolerances:
- against the interpreted TPU kernel, on the uniform and the general law:
  bit for bit (``assert_array_equal``). Each kept pair's force term is
  XLA:CPU's (``ops.jkr._pair_uniform`` and ``_pair_general`` mirror the
  compiled body, the general law's cube root glibc's ``powf``,
  ``ops.xla_f32.powf``), and the plain version adds them as the
  interpreted kernel does (``neighbors.grouped_sum``: per chunk of lanes,
  run and 32-lane window of the sorted rows, from where the block's span
  starts). ``tpu_grouping_sum``, written from the kernel independently of
  the port, sums the port's terms in that grouping and must give the same
  bits. The states include runs that straddle a 32-lane window and a chunk
  (``dense``) and spans whose starts the capacity clips (``clip``);
- against ``jkr_substep`` (the XLA path, the general law, which the port
  does not follow): its pair law takes a square root and divides by it
  where the TPU kernels multiply by XLA's ``rsqrt``, and XLA sums each
  window in 32-wide partial sums of the padded window: rtol 1e-5, atol
  1e-6 x max|F|;
- bond sets and degrees are integer bookkeeping and must be equal; the
  new partner lists follow the TPU kernel's chunk-major order entry for
  entry.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipsc_abm_tpu.models.params import BiologyParams
from hipsc_abm_tpu.ops import jkr as jjkr
from hipsc_abm_tpu.ops import neighbors as jnbr
from hipsc_abm_tpu.ops.pallas_contact import contact_substep_pallas
from hipsc_abm_tpu_torch import kernels
from hipsc_abm_tpu_torch.ops import contact as tcontact
from hipsc_abm_tpu_torch.ops import jkr as tjkr
from hipsc_abm_tpu_torch.ops import neighbors as tnbr

BIO = BiologyParams()
BOX = (150.0, 150.0, 0.0)
CELL = BIO.jkr_radius + 2 * BIO.jkr_break_band + 2.0
LAW = dict(radius=BIO.jkr_radius, adhesion_const=BIO.adhesion_const,
           poisson=BIO.poisson, youngs=BIO.youngs, break_d=BIO.jkr_break_d)


def _setup(K, C=256, n=230, seed=0, box=BOX):
    """A packed colony (slot == id) with bonds from one JAX substep at
    slightly different positions, so some bonds lie beyond the search radius
    and some break."""
    rs = np.random.default_rng(seed)
    locs = np.zeros((C, 3), np.float32)
    locs[:n] = rs.random((n, 3)).astype(np.float32) * np.asarray(box, np.float32)
    locs[:, 2] = 0.0
    alive = np.zeros(C, bool)
    alive[:n] = True
    alive[rs.choice(n, 10, replace=False)] = False
    ids = np.arange(C, dtype=np.int32)
    jspec = jnbr.GridSpec.from_box(BOX, CELL, run_cap=64)
    radii = np.full(C, BIO.max_radius, np.float32)

    earlier = locs.copy()
    earlier[:n, :2] -= rs.normal(0.0, 1.2, (n, 2)).astype(np.float32)
    g0, pos0, valid0, _ = jnbr.sorted_window(
        jspec, jnp.asarray(earlier), jnp.asarray(ids), jnp.asarray(alive))
    packed0 = jjkr.pack_physics(jnp.asarray(earlier), jnp.asarray(radii),
                                jnp.asarray(ids), jnp.asarray(alive))
    _, bonds, _ = jjkr.jkr_substep(jjkr.BondState.empty(C, K), packed0, g0.order,
                                   pos0, valid0, **LAW)
    partner_ids = np.where(np.asarray(bonds.mask), np.asarray(bonds.partners), -1)
    return locs, radii, ids, alive, partner_ids.astype(np.int32), jspec


def _sorted_inputs(locs, radii, ids, alive, partner_ids, jspec):
    tspec = tnbr.GridSpec(**dataclasses.asdict(jspec))
    grid = tnbr.build_grid(tspec, torch.from_numpy(locs), torch.from_numpy(ids),
                           torch.from_numpy(alive))
    o = grid.order
    args = (tjkr.pack_physics(torch.from_numpy(locs)[o], torch.from_numpy(radii)[o]),
            torch.from_numpy(ids)[o].contiguous(), torch.from_numpy(alive)[o].contiguous(),
            tnbr.run_bounds(tspec, grid.sorted_flat),
            torch.from_numpy(partner_ids)[o].contiguous())
    return grid, args


def _unsort(order, *tensors):
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel())
    return [t[inv].numpy() for t in tensors]


def tpu_grouping_sum(terms, keep, pos, n_runs, starts, block=128, chunk=128):
    """(C, 3) float32: each row's kept ``terms`` (C, W, 3) summed as the
    interpreted TPU contact kernels sum them: for each chunk of ``chunk``
    lanes (chunk-major) and each run, the run's lanes in 32-lane windows of
    the sorted rows, each window from +0 in lane order, the windows from +0,
    that sum added to the row's total. ``pos`` (C, W) are the candidates'
    sorted positions (run-major), ``starts`` (n_runs + 1, nblocks) the
    blocks' span starts (``neighbors.block_span_plan``)."""
    terms, keep, pos = terms.numpy(), keep.numpy(), pos.numpy()
    C, W = keep.shape
    width = W // n_runs
    st = np.asarray(starts)
    out = np.zeros((C, 3), np.float32)
    for i, cols in enumerate(keep):
        groups = {}
        for j in np.nonzero(cols)[0]:
            r = j // width
            lane = pos[i, j] - st[r, i // block]
            win = groups.setdefault((lane // chunk, r), {}).setdefault(pos[i, j] // 32, [])
            win.append(terms[i, j])
        acc = np.zeros(3, np.float32)
        for key in sorted(groups):
            total = np.zeros(3, np.float32)
            for w in sorted(groups[key]):
                part = np.zeros(3, np.float32)
                for t in groups[key][w]:
                    part = (part + t).astype(np.float32)
                total = (total + part).astype(np.float32)
            acc = (acc + total).astype(np.float32)
        out[i] = acc
    return out


def one_window_rows(keep, pos, n_runs) -> np.ndarray:
    """(C,) bool: rows whose kept candidates of each run lie in one 32-lane
    window of the sorted rows, where the port's grouping is the TPU
    kernels'."""
    keep, pos = keep.numpy(), pos.numpy()
    width = keep.shape[1] // n_runs
    out = np.ones(keep.shape[0], bool)
    for r in range(n_runs):
        k = keep[:, r * width:(r + 1) * width]
        w = np.where(k, pos[:, r * width:(r + 1) * width] // 32, -1)
        lo = np.where(k, w, np.iinfo(np.int64).max).min(axis=1)
        out &= (w == -1).all(axis=1) | (np.where(k, w, lo[:, None]) == lo[:, None]).all(axis=1)
    return out


def _assert_sets_equal(got, want):
    for i in range(got.shape[0]):
        assert set(got[i][got[i] >= 0].tolist()) == set(want[i][want[i] >= 0].tolist()), i


# the states of the interpreted-kernel comparisons: (capacity, live agents,
# box, chunk, span cap or None for the smallest that holds every block)
STATES = {
    "sparse": (256, 230, (150.0, 150.0, 0.0), 128, None),
    # ~44 agents per contact bin: runs straddle 32-lane windows and chunks
    "dense": (1024, 1000, (150.0, 150.0, 0.0), 256, None),
    # the last blocks' span starts clipped to capacity - span
    "clip": (1024, 1000, (150.0, 150.0, 0.0), 256, 512),
}


def pallas_plan(jspec, sorted_flat, C, chunk, span=None):
    """``(starts, needs, span)`` of the interpreted kernels' span plan
    (``block_span_plan``, block 128) at the span cap ``span`` (default: the
    smallest chunk multiple that holds every block's candidates)."""
    if span is None:
        _, _, needed, _ = jnbr.block_span_plan(jspec, sorted_flat, 128, span=C, capacity=C,
                                               chunk=C)
        span = min(-(-int(needed) // chunk) * chunk, C)
    starts, needs, needed, _ = jnbr.block_span_plan(jspec, sorted_flat, 128, span=span,
                                                    capacity=C, chunk=chunk)
    assert int(needed) <= span
    return starts, needs, span


def assert_live_starts(grouping, starts, bounds, block=128):
    """The port's span starts equal the JAX plan's (whose last row is
    padding) on every block whose first row is alive at the build: a block
    of dead rows starts where no row reads its start."""
    b = bounds.view(bounds.shape[0], -1, 2)
    live = (b[::block, b.shape[1] // 2, 1] > 0).numpy()
    assert live.any()
    np.testing.assert_array_equal(grouping.starts.numpy()[:, live],
                                  np.asarray(starts)[:-1][:, live])


def port_grouping(bounds, starts, span, C, chunk):
    """The port's grouping of sorted rows, checked against the JAX plan's
    span starts."""
    grouping = tnbr.grouping_of_bounds(bounds, span, C, chunk)
    assert_live_starts(grouping, starts, bounds)
    return grouping


@pytest.mark.parametrize("state", sorted(STATES))
@pytest.mark.parametrize("law", ["uniform", "general"])
@pytest.mark.parametrize("K", [8, 40])
def test_plain_matches_pallas_interpret(K, law, state):
    C, n, box, chunk, span = STATES[state]
    locs, radii, ids, alive, partner_ids, jspec = _setup(K, C=C, n=n, box=box)
    uniform = BIO.max_radius if law == "uniform" else None
    if uniform is None:
        radii = np.random.default_rng(5).uniform(BIO.min_radius, BIO.max_radius,
                                                 C).astype(np.float32)
    jgrid = jnbr.build_grid(jspec, jnp.asarray(locs), jnp.asarray(ids), jnp.asarray(alive))
    packed = jjkr.pack_physics(jnp.asarray(locs), jnp.asarray(radii), jnp.asarray(ids),
                               jnp.asarray(alive))
    srt_pack = packed[jgrid.order].at[:, 6].set(jgrid.sorted_flat.astype(jnp.float32))
    srt_bonds = jnp.asarray(partner_ids.astype(np.float32))[jgrid.order]
    starts, needs, span = pallas_plan(jspec, jgrid.sorted_flat, C, chunk, span)
    force_deg, new_bonds = contact_substep_pallas(
        srt_pack, srt_bonds, starts, needs, block=128, span=span,
        run_offs=jspec.flat_run_offsets, chunk=chunk,
        uniform_radius=uniform, interpret=True, **LAW)

    grid, args = _sorted_inputs(locs, radii, ids, alive, partner_ids, jspec)
    np.testing.assert_array_equal(grid.order.numpy(), np.asarray(jgrid.order))
    grouping = port_grouping(args[3], starts, span, C, chunk)
    force, degree, new_partners = tcontact.contact_substep_plain(
        *args, uniform_radius=uniform, grouping=grouping, **LAW)

    want_f = np.asarray(force_deg[:, :3])
    assert np.abs(want_f).max() > 0 and int((new_partners >= 0).sum()) > C
    np.testing.assert_array_equal(force.numpy(), want_f)
    np.testing.assert_array_equal(degree.numpy(), np.asarray(force_deg[:, 3]).astype(np.int32))
    np.testing.assert_array_equal(new_partners.numpy(), np.asarray(new_bonds).astype(np.int32))
    # the pair terms summed by the test's own reading of the kernel
    xyzr, t_ids, t_alive, bounds, partners = args
    pos, valid = tnbr.bounds_window(bounds)
    bonded = tjkr._is_bonded(partners, t_ids[pos])
    terms, keep = tjkr.pair_terms(bonded, xyzr, t_ids, t_alive, None, pos, valid,
                                  uniform_radius=uniform, **LAW)
    np.testing.assert_array_equal(tpu_grouping_sum(terms, keep, pos, 3, starts, chunk=chunk),
                                  want_f)
    if state != "sparse":  # the grouping differs from walk order on these rows
        assert (~one_window_rows(keep, pos, 3)).sum() > C // 4


@pytest.mark.parametrize("state", ["dense", "clip"])
def test_grouped_sum_matches_tpu_grouping_sum(state):
    """``neighbors.grouped_sum`` against the test's own reading of the TPU
    kernels' grouping, on random terms and keep sets over a dense window
    (runs across 32-lane windows and 256-lane chunks) and over the clipped
    starts, at chunks of 128 and 256 lanes."""
    C, n, box, chunk, span = STATES[state]
    locs, radii, ids, alive, partner_ids, jspec = _setup(8, C=C, n=n, box=box)
    grid, args = _sorted_inputs(locs, radii, ids, alive, partner_ids, jspec)
    bounds = args[3]
    pos, valid = tnbr.bounds_window(bounds)
    rs = np.random.default_rng(7)
    terms = torch.from_numpy(rs.normal(0, 1, pos.shape + (3,)).astype(np.float32))
    keep = valid & torch.from_numpy(rs.random(pos.shape) < 0.5)
    for c in (128, chunk):
        starts, _, sp = pallas_plan(jspec, jnp.asarray(grid.sorted_flat.numpy()), C, c, span)
        grouping = port_grouping(bounds, starts, sp, C, c)
        lanes = tnbr.plain_lanes(bounds, pos, grouping)
        got = tnbr.grouped_sum(terms, keep, lanes).numpy()
        np.testing.assert_array_equal(got, tpu_grouping_sum(terms, keep, pos, 3, starts,
                                                            chunk=c))
        assert not np.array_equal(got, tnbr.grouped_sum(terms, keep).numpy())
    if state == "clip":
        assert int(starts[0].max()) == C - span


@pytest.mark.parametrize("K", [8, 40])
def test_plain_matches_jkr_substep(K):
    locs, radii, ids, alive, partner_ids, jspec = _setup(K, seed=1)
    C = locs.shape[0]
    g, pos, valid, _ = jnbr.sorted_window(jspec, jnp.asarray(locs), jnp.asarray(ids),
                                          jnp.asarray(alive))
    packed = jjkr.pack_physics(jnp.asarray(locs), jnp.asarray(radii), jnp.asarray(ids),
                               jnp.asarray(alive))
    jbonds = jjkr.BondState(partners=jnp.asarray(np.maximum(partner_ids, 0)),
                            mask=jnp.asarray(partner_ids >= 0))
    jf, jb, jdeg = jjkr.jkr_substep(jbonds, packed, g.order, pos, valid, **LAW)

    grid, args = _sorted_inputs(locs, radii, ids, alive, partner_ids, jspec)
    force, degree, new_partners = tcontact.contact_substep_plain(*args, **LAW)
    force, degree, new_partners = _unsort(grid.order, force, degree, new_partners)

    want_f = np.asarray(jf)
    np.testing.assert_allclose(force, want_f, rtol=1e-5, atol=1e-6 * np.abs(want_f).max())
    want = np.where(np.asarray(jb.mask), np.asarray(jb.partners), -1)
    _assert_sets_equal(new_partners, want)
    np.testing.assert_array_equal(np.minimum(degree, K), np.asarray(jb.mask).sum(1))
    assert int(degree.max()) == int(jdeg)
    assert new_partners.shape == (C, K)


def test_port_jkr_substep_matches_jax_on_one_window():
    """The port's slot-space ``jkr_substep`` on the JAX window itself."""
    locs, radii, ids, alive, partner_ids, jspec = _setup(8, seed=2)
    g, pos, valid, _ = jnbr.sorted_window(jspec, jnp.asarray(locs), jnp.asarray(ids),
                                          jnp.asarray(alive))
    packed = jjkr.pack_physics(jnp.asarray(locs), jnp.asarray(radii), jnp.asarray(ids),
                               jnp.asarray(alive))
    jbonds = jjkr.BondState(partners=jnp.asarray(np.maximum(partner_ids, 0)),
                            mask=jnp.asarray(partner_ids >= 0))
    jf, jb, _ = jjkr.jkr_substep(jbonds, packed, g.order, pos, valid, **LAW)
    tf, tp, tdeg = tjkr.jkr_substep(
        torch.from_numpy(partner_ids), tjkr.pack_physics(torch.from_numpy(locs),
                                                         torch.from_numpy(radii)),
        torch.from_numpy(ids), torch.from_numpy(alive),
        torch.from_numpy(np.asarray(g.order).astype(np.int64)),
        torch.from_numpy(np.asarray(pos).astype(np.int64)),
        torch.from_numpy(np.array(valid)), **LAW)
    want_f = np.asarray(jf)
    np.testing.assert_allclose(tf.numpy(), want_f, rtol=1e-5, atol=1e-6 * np.abs(want_f).max())
    # same window, same compaction order: the lists are equal entry by entry
    want = np.where(np.asarray(jb.mask), np.asarray(jb.partners), -1)
    np.testing.assert_array_equal(tp.numpy(), want)


def test_bond_persists_beyond_search_radius():
    """A bonded pair outside the fresh-contact radius but inside the break
    distance still pulls; unbonded, the same pair feels nothing."""
    C = 8
    locs = np.zeros((C, 3), np.float32)
    locs[0] = [50.0, 50.0, 0.0]
    locs[1] = [60.2, 50.0, 0.0]
    radii = np.full(C, BIO.max_radius, np.float32)
    alive = np.zeros(C, bool)
    alive[:2] = True
    ids = np.arange(C, dtype=np.int32)
    jspec = jnbr.GridSpec.from_box(BOX, CELL, run_cap=16)
    empty = np.full((C, 8), -1, np.int32)
    _, args = _sorted_inputs(locs, radii, ids, alive, empty, jspec)
    f0, d0, _ = tcontact.contact_substep_cuda(*args, **LAW)
    assert float(f0.abs().max()) == 0.0 and int(d0.sum()) == 0
    bonded = empty.copy()
    bonded[0, 0], bonded[1, 0] = 1, 0
    grid, args = _sorted_inputs(locs, radii, ids, alive, bonded, jspec)
    f1, d1, p1 = _unsort(grid.order, *tcontact.contact_substep_cuda(*args, **LAW))
    assert f1[0, 0] > 0 > f1[1, 0]
    assert p1[0, 0] == 1 and p1[1, 0] == 0 and d1[0] == 1


def test_cpu_wrapper_runs_plain_and_counts_no_launch():
    locs, radii, ids, alive, partner_ids, jspec = _setup(8, seed=3)
    _, args = _sorted_inputs(locs, radii, ids, alive, partner_ids, jspec)
    before = kernels.launch_counts["contact_substep"]
    got = tcontact.contact_substep_cuda(*args, uniform_radius=5.0, **LAW)
    want = tcontact.contact_substep_plain(*args, uniform_radius=5.0, **LAW)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert kernels.launch_counts["contact_substep"] == before


@pytest.mark.parametrize("change", [None, "force", "partners", "in4", "span_mask",
                                    "span_mask:seed_force", "span_mask:seed_mask",
                                    "span_mask:mask", "span_mask:degree", "span_mask:compact",
                                    "span_mask:moved"])
def test_contact_ab_compare_is_bit_for_bit(tmp_path, change):
    """``tools/contact_ab.py compare`` passes two dumps only when inputs and
    every output are equal: on the id-list path forces, degrees and partner
    lists; on the span-mask path both substeps' forces, degrees and mask
    words, the compacted ids and the moved positions. A force one ulp away
    fails, and so does one flipped mask bit."""
    from hipsc_abm_tpu_torch.ops import span_mask
    from hipsc_abm_tpu_torch.tools import contact_ab

    locs, radii, ids, alive, partner_ids, jspec = _setup(8, seed=4)
    _, args = _sorted_inputs(locs, radii, ids, alive, partner_ids, jspec)
    a = {f"in{i}": t.numpy() for i, t in enumerate(args)}
    path, _, field = (change or "").partition(":")
    if path == "span_mask":
        law = dict(uniform_radius=BIO.max_radius, **LAW)
        f1, d1, m1 = span_mask.contact_seed_cuda(*args, **law)
        moved = args[0].clone()
        noise = np.random.default_rng(5).normal(0.0, 0.4, (moved.shape[0], 2))
        moved[:, :2] += torch.from_numpy(noise.astype(np.float32))
        a.update(path=np.array(path), seed_force=f1.numpy(), seed_degree=d1.numpy(),
                 seed_mask=m1.numpy().copy(), moved=moved.numpy())
        f2, d2, m2 = span_mask.contact_masked_cuda(moved, *args[1:4], m1, **law)
        a.update(force=f2.numpy(), degree=d2.numpy(), mask=m2.numpy(),
                 compact=span_mask.mask_compact_cuda(args[1], args[3], m2, 8).numpy(),
                 seed_ms=np.float64(0.01), ms=np.float64(0.02))
        assert a["mask"].any() and not np.array_equal(a["mask"], a["seed_mask"])
    else:
        force, degree, partners = tcontact.contact_substep_plain(*args, **LAW)
        a.update(force=force.numpy(), degree=degree.numpy(), partners=partners.numpy())
    b = {k: v.copy() for k, v in a.items()}
    if change in ("force", "span_mask:seed_force"):
        key = "force" if change == "force" else "seed_force"
        b[key].flat[0] = np.nextafter(b[key].flat[0], np.float32(1.0))
    elif change == "partners":
        b["partners"][0, -1] = 12345
    elif change == "in4":
        b["in4"][0, 0] = 12345
    elif field in ("seed_mask", "mask"):
        b[field][-1, 3] ^= 1 << 5  # one bit of one word
    elif field == "degree":
        b["degree"][7] += 1
    elif field == "compact":
        b["compact"][2, 0] = -1
    elif field == "moved":
        b["moved"][1, 1] = np.nextafter(b["moved"][1, 1], np.float32(0.0))
    np.savez(tmp_path / "a.npz", **a)
    np.savez(tmp_path / "b.npz", **b)
    assert contact_ab.main(["compare", str(tmp_path / "a.npz"), str(tmp_path / "b.npz")]) \
        == (0 if change in (None, "span_mask") else 1)


@pytest.mark.parametrize("change", [None, "motility_call_full", "count_call",
                                    "pathway_call", "in_bounds", "in_alive"])
def test_contact_ab_bio_compare_is_bit_for_bit(tmp_path, change):
    """The ``bio`` dump: one step of a small 2D colony with the engine's three
    bio-moments calls recorded (count, pathway, motility, in that order);
    ``compare`` passes two dumps only when the step's inputs and every
    replayed output are equal, a moment one ulp away failing."""
    from hipsc_abm_tpu_torch.engine import HipscEngine
    from hipsc_abm_tpu_torch.params import ExperimentalParams, GeneralParams
    from hipsc_abm_tpu_torch.tools import contact_ab

    eng = HipscEngine(GeneralParams(num_to_start=300, size=(420.0, 420.0, 0.0)),
                      ExperimentalParams(num_gata6=30, dox_step=1), device="cpu")
    state, _ = eng.safe_step(eng.init_state(seed=3))
    saved, calls = contact_ab.bio_outputs(eng, state)
    assert [k["mode"] for _, k in calls] == ["count", "pathway", "motility"]
    assert set(saved) == set(contact_ab.BIO_INPUTS + contact_ab.BIO_OUTPUTS)
    a = {k: v.numpy() for k, v in saved.items()}
    a.update(path=np.array("bio"), bio_full_ms=np.float64(0.01))
    assert a["motility_call_full"][:, 0].sum() > 300
    b = {k: v.copy() for k, v in a.items()}
    if change in ("motility_call_full", "count_call", "pathway_call"):
        lane = 4 if change == "motility_call_full" else 0
        row = int(np.flatnonzero(b[change][:, lane])[0])
        b[change][row, lane] = np.nextafter(b[change][row, lane], np.float32(1e9))
    elif change == "in_bounds":
        b["in_bounds"][0, 0] += 1
    elif change == "in_alive":
        b["in_alive"][0] = not b["in_alive"][0]
    np.savez(tmp_path / "a.npz", **a)
    np.savez(tmp_path / "b.npz", **b)
    assert contact_ab.main(["compare", str(tmp_path / "a.npz"), str(tmp_path / "b.npz")]) \
        == (0 if change is None else 1)
