"""PyTorch port: the span-mask contact path (``ops.span_mask``, the plain
versions of ``csrc/contact_mask.cu``; the kernels themselves are held to them
in test_torch_cuda.py) vs the JAX package's span-mask Pallas kernels
(``contact_substep_ids_to_mask`` -> ``contact_substep_masked`` ->
``compact_mask_bonds``, interpret mode), its ``_physics_scan_pallas`` and its
engine with ``use_pallas=True``.

Tolerances: against the Pallas kernels in interpret mode, forces are equal
bit for bit on the uniform and the general law: the port's pair terms are
XLA:CPU's and it adds them in the kernels' (chunk, run, 32-lane window)
grouping (``neighbors.grouped_sum``); positions after a scan or a step to
1e-4 um (``tests/test_pallas.py``'s engine tolerance); degrees, bond sets
and all integer state are exact.
"""

import dataclasses
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipsc_abm_tpu import engine as jeng_mod
from hipsc_abm_tpu.engine import HipscEngine as JaxEngine
from hipsc_abm_tpu.models.params import BiologyParams, ExperimentalParams, GeneralParams
from hipsc_abm_tpu.ops import jkr as jjkr
from hipsc_abm_tpu.ops import neighbors as jnbr
from hipsc_abm_tpu.ops.pallas_contact import (
    NO_BOND,
    compact_mask_bonds,
    contact_substep_ids_to_mask,
    contact_substep_masked,
)
from hipsc_abm_tpu_torch import convert, kernels
from hipsc_abm_tpu_torch import engine as teng_mod
from hipsc_abm_tpu_torch.engine import HipscEngine
from hipsc_abm_tpu_torch.ops import jkr as tjkr
from hipsc_abm_tpu_torch.ops import neighbors as tnbr
from hipsc_abm_tpu_torch.ops import span_mask
from test_torch_contact import assert_live_starts
from test_torch_step import _assert_same_colony

BIO = BiologyParams()
TBIO = convert.params_from_jax(BIO)
BOX = (150.0, 150.0, 0.0)
CELL = BIO.jkr_radius + 2 * BIO.jkr_break_band + 2.0
LAW = dict(radius=BIO.jkr_radius, adhesion_const=BIO.adhesion_const,
           poisson=BIO.poisson, youngs=BIO.youngs, break_d=BIO.jkr_break_d)


def _colony(K, seed=0, C=256, n=230, general=False):
    """Scrambled ids, a few dead slots, and bonds from one JAX substep at
    earlier positions, so some bonds lie beyond the search radius and some
    break; ``general``: radii drawn between the smallest and the largest."""
    rs = np.random.default_rng(seed)
    locs = np.zeros((C, 3), np.float32)
    locs[:n, :2] = rs.random((n, 2)).astype(np.float32) * np.float32(BOX[0])
    alive = np.zeros(C, bool)
    alive[:n] = True
    alive[rs.choice(n, 10, replace=False)] = False
    ids = rs.permutation(4 * C)[:C].astype(np.int32)
    radii = np.full(C, BIO.max_radius, np.float32)
    if general:
        radii = rs.uniform(BIO.min_radius, BIO.max_radius, C).astype(np.float32)
    jspec = jnbr.GridSpec.from_box(BOX, CELL, run_cap=64)
    earlier = locs.copy()
    earlier[:n, :2] -= rs.normal(0.0, 1.2, (n, 2)).astype(np.float32)
    g0, pos0, valid0, _ = jnbr.sorted_window(
        jspec, jnp.asarray(earlier), jnp.asarray(ids), jnp.asarray(alive))
    packed0 = jjkr.pack_physics(jnp.asarray(earlier), jnp.asarray(radii),
                                jnp.asarray(ids), jnp.asarray(alive))
    _, bonds, _ = jjkr.jkr_substep(jjkr.BondState.empty(C, K), packed0, g0.order,
                                   pos0, valid0, **LAW)
    partner_ids = np.where(np.asarray(bonds.mask), np.asarray(bonds.partners), -1)
    # positions one substep later (the window stays frozen)
    moved = locs.copy()
    moved[:n, :2] += rs.normal(0.0, 0.4, (n, 2)).astype(np.float32)
    return locs, moved, radii, ids, alive, partner_ids.astype(np.int32), jspec


def _sets(rows):
    return [frozenset(r[r >= 0].tolist()) for r in np.asarray(rows).astype(np.int64)]


@pytest.mark.parametrize("law", ["uniform", "general"])
@pytest.mark.parametrize("K", [8, 40])
def test_seed_masked_compact_match_pallas_interpret(K, law):
    """seed -> masked (positions moved, window frozen) -> compact, against
    the three Pallas kernels on the same sorted rows."""
    uniform = BIO.max_radius if law == "uniform" else None
    locs, moved, radii, ids, alive, partner_ids, jspec = _colony(K, general=uniform is None)
    C = locs.shape[0]
    jgrid = jnbr.build_grid(jspec, jnp.asarray(locs), jnp.asarray(ids), jnp.asarray(alive))
    order = np.asarray(jgrid.order)

    def srt_pack(xyz):
        packed = jjkr.pack_physics(jnp.asarray(xyz), jnp.asarray(radii), jnp.asarray(ids),
                                   jnp.asarray(alive))
        return packed[order].at[:, 6].set(jgrid.sorted_flat.astype(jnp.float32))

    block, chunk = 128, 128
    _, _, span_needed, _ = jnbr.block_span_plan(jspec, jgrid.sorted_flat, block, span=C,
                                                capacity=C, chunk=C)
    span = min(-(-int(span_needed) // 128) * 128, C)
    starts, needs, _, _ = jnbr.block_span_plan(jspec, jgrid.sorted_flat, block, span=span,
                                               capacity=C, chunk=chunk)
    pkw = dict(block=block, span=span, run_offs=jspec.flat_run_offsets, chunk=chunk,
               uniform_radius=uniform, interpret=True, **LAW)
    fd1, m1 = contact_substep_ids_to_mask(
        srt_pack(locs), jnp.asarray(partner_ids.astype(np.float32))[order], starts,
        needs, **pkw)
    fd2, m2 = contact_substep_masked(srt_pack(moved), m1, starts, needs, **pkw)
    jbonds = compact_mask_bonds(srt_pack(moved), m2, starts, needs, block=block, span=span,
                                run_offs=jspec.flat_run_offsets, bond_cap=K, chunk=chunk,
                                interpret=True)

    tspec = tnbr.GridSpec(**dataclasses.asdict(jspec))
    grid = tnbr.build_grid(tspec, torch.from_numpy(locs), torch.from_numpy(ids),
                           torch.from_numpy(alive))
    np.testing.assert_array_equal(grid.order.numpy(), order)
    o = grid.order
    bounds = tnbr.run_bounds(tspec, grid.sorted_flat)
    rows = (torch.from_numpy(ids)[o].contiguous(), torch.from_numpy(alive)[o].contiguous(),
            bounds)

    def xyzr(xyz):
        return tjkr.pack_physics(torch.from_numpy(xyz)[o], torch.from_numpy(radii)[o])

    grouping = tnbr.grouping_of_bounds(bounds, span, C, chunk)
    assert_live_starts(grouping, starts, bounds)
    before = dict(kernels.launch_counts)
    f1, d1, mask = span_mask.contact_seed_cuda(
        xyzr(locs), *rows, torch.from_numpy(partner_ids)[o].contiguous(),
        uniform_radius=uniform, grouping=grouping, **LAW)
    assert mask.shape == (span_mask.mask_words(bounds), C) and mask.dtype == torch.int32
    f2, d2, mask2 = span_mask.contact_masked_cuda(xyzr(moved), *rows, mask,
                                                  uniform_radius=uniform, grouping=grouping,
                                                  **LAW)
    assert mask2 is mask  # updated in place
    bonds = span_mask.mask_compact_cuda(rows[0], bounds, mask, K)
    assert dict(kernels.launch_counts) == before  # CPU tensors: plain versions

    for f, d, fd in ((f1, d1, fd1), (f2, d2, fd2)):
        want = np.asarray(fd[:, :3])
        assert np.abs(want).max() > 0
        np.testing.assert_array_equal(f.numpy(), want)
        np.testing.assert_array_equal(d.numpy(), np.asarray(fd[:, 3]).astype(np.int32))
    assert int(d2.sum()) > C
    # rows within K hold the same set; past K the two truncate in their own
    # orders (test_compact_truncates_in_walk_order)
    within = (d2 <= K).numpy()
    assert within.sum() > C - 8
    got, want = _sets(bonds.numpy()), _sets(jbonds)
    assert [g for g, w in zip(got, within) if w] == [g for g, w in zip(want, within) if w]
    assert all(len(g) == K for g, w in zip(got, within) if not w)
    # the masked substep kept bonds that only membership can explain (at
    # the largest radius, whose bonds outlast the search radius)
    loc1 = xyzr(moved)[:, :2]
    beyond = 0
    for i, s in enumerate(_sets(bonds.numpy())):
        for pid in s:
            pj = int(np.flatnonzero(rows[0].numpy() == pid)[0])
            beyond += float(((loc1[i] - loc1[pj]) ** 2).sum()) > BIO.jkr_radius ** 2
    assert beyond > 0 or uniform is None


def _one_row_mask(n_bits):
    """Sorted ids and bounds of a small colony, and a mask with ``n_bits``
    set bits (every candidate but each third) on its row with the most
    candidates, which must have more than that: ``(sids, bounds, mask, row,
    ids of the set bits in the port's walk order)``."""
    locs, _, radii, ids, alive, _, jspec = _colony(8, seed=3)
    tspec = tnbr.GridSpec(**dataclasses.asdict(jspec))
    grid = tnbr.build_grid(tspec, torch.from_numpy(locs), torch.from_numpy(ids),
                           torch.from_numpy(alive))
    bounds = tnbr.run_bounds(tspec, grid.sorted_flat)
    sids = torch.from_numpy(ids)[grid.order].contiguous()
    counts = span_mask.candidate_counts(bounds)
    row = int(torch.argmax(counts))
    n = int(counts[row])
    cand = [j for j in range(n) if j % 3 != 1][:n_bits]  # every set bit but a gap
    assert len(cand) == n_bits
    W = span_mask.mask_words(bounds)
    words = np.zeros((W, len(ids)), np.int64)
    for j in cand:
        words[j >> 5, row] |= 1 << (j & 31)
    mask = torch.from_numpy(np.where(words >= 1 << 31, words - (1 << 32), words).astype(np.int32))
    b = bounds[row].numpy()
    walk = [p for r in range(3) for p in range(b[2 * r], b[2 * r + 1])]
    return sids, bounds, mask, row, sids.numpy()[[walk[j] for j in cand]]


def test_compact_truncates_in_walk_order():
    """More set bits than K: the compaction keeps the first K candidates in
    candidate order (run, then sorted position). The Pallas compaction, and
    the id-list substep's list (the TPU kernel's chunk-major walk), truncate
    in (chunk, run, lane) order instead (``tests/test_pallas.py``), a layout
    artifact. Either way the substeps' degree probe exceeds K, so
    ``safe_step`` grows K and re-executes before any accepted step depends
    on which K were kept."""
    K = 8
    sids, bounds, mask, row, kept = _one_row_mask(K + 4)
    got = span_mask.mask_compact_cuda(sids, bounds, mask, K).numpy()
    np.testing.assert_array_equal(got[row], kept[:K])
    assert np.all(np.delete(got, row, axis=0) == NO_BOND)


@pytest.mark.parametrize("K", [0, 1, 8, 24, 96, 97, 128, 129])
def test_compact_bond_capacity_up_to_the_engine_cap(K):
    """The compaction takes a bond capacity from 1 to the engine's largest
    (``MAX_BOND_CAP``, 128, where the kernel's output tile is 64 KB per
    block) and refuses any other; within it a row keeps its first K set
    bits in walk order, padded with ``NO_BOND``."""
    sids, bounds, mask, row, kept = _one_row_mask(12)
    if not 1 <= K <= teng_mod.MAX_BOND_CAP:
        with pytest.raises(ValueError, match="bond capacity"):
            span_mask.mask_compact_cuda(sids, bounds, mask, K)
        return
    got = span_mask.mask_compact_cuda(sids, bounds, mask, K).numpy()
    assert got.shape == (len(sids), K)
    want = np.full(K, NO_BOND, np.int32)
    want[:min(K, len(kept))] = kept[:K]
    np.testing.assert_array_equal(got[row], want)
    assert np.all(np.delete(got, row, axis=0) == NO_BOND)


def _scan_inputs(skin, seed=2):
    """One JAX step in (bonds formed), then random motility forces so agents
    drift during the scan."""
    gen = GeneralParams(num_to_start=180, end_step=5, size=(220.0, 220.0, 0.0))
    xp = ExperimentalParams(num_gata6=18, dox_step=1)
    js, _ = JaxEngine(gen, xp, use_pallas=False).safe_step(
        JaxEngine(gen, xp, use_pallas=False).init_state(seed=seed))
    d = convert.numpy_from_jax_state(js)
    rs = np.random.default_rng(seed)
    C = d["alive"].shape[0]
    mot = rs.normal(0.0, 1e-9, (C, 3)).astype(np.float32)
    mot[:, 2] = 0.0
    d["arrays"]["motility_forces"] = mot
    jcfg = jeng_mod.EngineConfig.create(
        gen.size, capacity=C, bio=BIO, verlet_skin=skin, use_pallas=True,
        pallas_interpret=True, jkr_span=C, nbr_span=C, uniform_radius=BIO.max_radius,
        bond_cap=d["partners"].shape[1])
    tcfg = teng_mod.EngineConfig.create(
        gen.size, capacity=C, bio=TBIO, verlet_skin=skin, uniform_radius=BIO.max_radius,
        bond_cap=d["partners"].shape[1], contact_path="span_mask", mask_bits=C,
        jkr_span=C, nbr_span=C)
    assert jcfg.capacity == tcfg.capacity
    assert dataclasses.asdict(jcfg.jkr_spec) | {"run_cap": 0} == dataclasses.asdict(tcfg.jkr_spec)
    return gen, d, jcfg, tcfg


@pytest.mark.parametrize("skin", [14.0, 2.0])
def test_scan_matches_physics_scan_pallas(skin):
    """``_physics_scan_span_mask`` vs JAX ``_physics_scan_pallas`` on one
    converted state; at skin 2 um the drift test fires mid-scan and the
    rebuild branch (compact, re-sort, re-seed) runs."""
    gen, d, jcfg, tcfg = _scan_inputs(skin)
    dts = teng_mod._physics_dts(TBIO)
    ja = {k: jnp.asarray(v) for k, v in d["arrays"].items()}
    jb = jjkr.BondState(partners=jnp.asarray(d["partners"]), mask=jnp.asarray(d["bond_mask"]))
    jout = jeng_mod._physics_scan_pallas(jcfg, BIO, ja, jnp.asarray(d["alive"]), jb,
                                         jnp.asarray(gen.size, jnp.float32), dts)
    ts = convert.state_from_numpy(d, "cpu")
    tout = teng_mod._physics_scan_span_mask(
        tcfg, TBIO, ts.arrays, ts.alive, ts.bonds, torch.tensor(gen.size), dts)
    loc, bonds, _, deg, move, rebuilds, _, _ = tout
    assert (rebuilds > 0) == (skin < 14.0)
    alive = d["alive"]
    np.testing.assert_allclose(loc.numpy()[alive], np.asarray(jout[0])[alive], rtol=0,
                               atol=1e-4)
    jids = np.where(np.asarray(jout[1].mask), np.asarray(jout[1].partners), -1)
    assert _sets(bonds.ids().numpy()[alive]) == _sets(jids[alive])
    assert int(deg) == int(np.max(np.asarray(jout[3])))
    assert sum(map(len, _sets(jids[alive]))) > alive.sum()
    np.testing.assert_allclose(float(move), float(jout[5]), rtol=1e-4)


def test_slice_matches_jax_pallas_engine():
    """Two ``safe_step``s of the port on the span-mask path against the JAX
    engine's TPU path (``use_pallas=True``: span-mask contact, Pallas bio
    moments, all in interpret mode), from the same initial state."""
    gen = GeneralParams(num_to_start=150, end_step=5, size=(300.0, 300.0, 0.0))
    xp = ExperimentalParams(num_gata6=16, dox_step=1)
    jeng = JaxEngine(gen, xp, use_pallas=True)
    jeng.cfg = dataclasses.replace(jeng.cfg, pallas_interpret=True)
    teng = HipscEngine(convert.params_from_jax(gen), convert.params_from_jax(xp),
                       device="cpu", contact_path="span_mask")
    assert teng.cfg.capacity == jeng.cfg.capacity
    js, ts = jeng.init_state(seed=3), teng.init_state(seed=3)
    for step in range(2):
        js, jinfo = jeng.safe_step(js)
        ts, tinfo = teng.safe_step(ts)
        assert tinfo.jkr_max_degree == int(jinfo.jkr_max_degree)
        assert tinfo.num_added == int(jinfo.num_added)
        _assert_same_colony(js, ts, f"span-mask step {step}", atol=1e-4)
    assert int(ts.bonds.mask.sum()) > 0


def test_span_mask_matches_id_list_in_port():
    """Both contact paths of the port on one state: the kernels walk the
    same candidates in the same order, so the colonies agree."""
    gen = GeneralParams(num_to_start=400, end_step=5, size=(560.0, 560.0, 0.0))
    xp = ExperimentalParams(num_gata6=40, dox_step=1)
    out = {}
    for path in ("id_list", "span_mask"):
        eng = HipscEngine(convert.params_from_jax(gen), convert.params_from_jax(xp),
                          device="cpu", contact_path=path)
        assert eng.cfg.contact_path == path
        s = eng.init_state(seed=5)
        for _ in range(2):
            s, info = eng.safe_step(s)
        out[path] = convert.state_to_numpy(s)
    a, b = out["id_list"], out["span_mask"]
    np.testing.assert_array_equal(a["alive"], b["alive"])
    for k in a["arrays"]:
        if k == "locations":
            np.testing.assert_allclose(b["arrays"][k], a["arrays"][k], rtol=0, atol=1e-5)
        else:
            np.testing.assert_array_equal(b["arrays"][k], a["arrays"][k], err_msg=k)
    sa = _sets(np.where(a["bond_mask"], a["partners"], -1))
    assert sa == _sets(np.where(b["bond_mask"], b["partners"], -1))
    assert sum(map(len, sa)) > 0


def test_contact_path_is_checked():
    gen = GeneralParams(num_to_start=50, size=(200.0, 200.0, 0.0))
    xp = ExperimentalParams(num_gata6=5, dox_step=2)
    args = (convert.params_from_jax(gen), convert.params_from_jax(xp))
    assert HipscEngine(*args, device="cpu").cfg.contact_path == "id_list"
    with pytest.raises(ValueError):
        HipscEngine(*args, device="cpu", contact_path="dense")


def test_library_path_hashes_headers(tmp_path, monkeypatch):
    """An edit to a shared header must key a new library."""
    src = tmp_path / "csrc"
    shutil.copytree(kernels.SRC_DIR, src)
    monkeypatch.setattr(kernels, "SRC_DIR", src)
    headers = sorted(src.glob("*.cuh"))
    assert headers and [p.name for p in kernels.sources()] == sorted(
        p.name for p in src.glob("*.cu"))
    before = kernels.library_path()
    assert kernels.library_path() == before
    headers[0].write_bytes(headers[0].read_bytes() + b"\n// edited\n")
    assert kernels.library_path() != before


def assert_self_is_row(eng, state) -> int:
    """On the contact window the engine builds from ``state``: every live
    row's runs hold exactly one candidate with the row's id, at sorted
    position ``row``, and every row dead at the build has no candidates.
    The kernels' self test (``p == row``, ``csrc/contact_mask.cu``) rests on
    this. Returns the number of dead rows checked."""
    spec, a, alive = eng.cfg.jkr_spec, state.arrays, state.alive
    grid = tnbr.build_grid(spec, a["locations"], a["ids"], alive)
    sids, salive = a["ids"][grid.order], alive[grid.order]
    pos, valid = tnbr.bounds_window(tnbr.run_bounds(spec, grid.sorted_flat))
    same = valid & (sids[pos] == sids[:, None])
    live = salive.nonzero().squeeze(1)
    assert torch.equal(same[live].sum(dim=1), torch.ones_like(live))
    at = pos[live][same[live]]
    assert torch.equal(at, live)
    assert int(valid[~salive].sum()) == 0
    return int((~salive).sum())


def test_self_is_the_only_candidate_with_the_row_id():
    """The 2D bench configuration (reference colony density, diffusion on)
    at 1,500 cells, after one ``safe_step``."""
    n = 1500
    side = 2000.0 * (n / 5000.0) ** 0.5
    gen = GeneralParams(num_to_start=n, end_step=5, size=(side, side, 0.0))
    xp = ExperimentalParams(num_gata6=n // 10, dox_step=1)
    eng = HipscEngine(convert.params_from_jax(gen), convert.params_from_jax(xp),
                      device="cpu", contact_path="span_mask")
    state, _ = eng.safe_step(eng.init_state(seed=0))
    assert int(state.alive.sum()) > n and assert_self_is_row(eng, state) > 0


def _pallas_seed(locs, radii, ids, alive, partner_ids, jspec):
    """The JAX seed (``contact_substep_ids_to_mask``, interpret mode) on the
    sorted rows: ``(order, force and degree (C, 4))``."""
    C = locs.shape[0]
    jgrid = jnbr.build_grid(jspec, jnp.asarray(locs), jnp.asarray(ids), jnp.asarray(alive))
    order = np.asarray(jgrid.order)
    packed = jjkr.pack_physics(jnp.asarray(locs), jnp.asarray(radii), jnp.asarray(ids),
                               jnp.asarray(alive))
    packed = packed[order].at[:, 6].set(jgrid.sorted_flat.astype(jnp.float32))
    _, _, span_needed, _ = jnbr.block_span_plan(jspec, jgrid.sorted_flat, 128, span=C,
                                                capacity=C, chunk=C)
    span = min(-(-int(span_needed) // 128) * 128, C)
    starts, needs, _, _ = jnbr.block_span_plan(jspec, jgrid.sorted_flat, 128, span=span,
                                               capacity=C, chunk=128)
    fd, _ = contact_substep_ids_to_mask(
        packed, jnp.asarray(partner_ids.astype(np.float32))[order], starts, needs,
        block=128, span=span, run_offs=jspec.flat_run_offsets, chunk=128,
        uniform_radius=BIO.max_radius, interpret=True, **LAW)
    return order, np.asarray(fd)


@pytest.mark.parametrize("dims", [2, 3])
def test_seed_keeps_a_bond_beyond_the_search_radius(dims):
    """Four pairs, far apart: bonded beyond the search radius inside the
    break distance (kept only through the partner ids), the same distance
    unbonded (dropped), bonded beyond the break distance (breaks), and
    unbonded within the radius (a fresh contact). The plain seed, which the
    wrapper runs for CPU tensors, against the JAX seed on the same rows; the
    kernel's membership scan is held to the plain seed on this state in
    ``test_torch_cuda.py``."""
    C, K = 128, 8
    r, band = BIO.jkr_radius, BIO.jkr_break_band
    gaps = (r + 0.6 * band, r + 0.6 * band, r + 1.5 * band, 0.9 * r)
    box = (150.0, 150.0, 150.0 if dims == 3 else 0.0)
    locs = np.zeros((C, 3), np.float32)
    for k, gap in enumerate(gaps):
        base = np.array([30.0 + 40.0 * (k % 2), 30.0 + 40.0 * (k // 2),
                         60.0 if dims == 3 else 0.0], np.float32)
        step = np.array([0.6, 0.0, 0.8] if dims == 3 else [0.6, 0.8, 0.0], np.float32)
        locs[2 * k], locs[2 * k + 1] = base, base + np.float32(gap) * step
    alive = np.zeros(C, bool)
    alive[:8] = True
    ids = np.random.default_rng(7).permutation(4 * C)[:C].astype(np.int32)
    radii = np.full(C, BIO.max_radius, np.float32)
    partner_ids = np.full((C, K), -1, np.int32)
    for a, b in ((0, 1), (4, 5)):  # the bonded pairs
        partner_ids[a, 0], partner_ids[b, 0] = ids[b], ids[a]
    jspec = jnbr.GridSpec.from_box(box, CELL, run_cap=64)
    order, fd = _pallas_seed(locs, radii, ids, alive, partner_ids, jspec)

    tspec = tnbr.GridSpec(**dataclasses.asdict(jspec))
    grid = tnbr.build_grid(tspec, torch.from_numpy(locs), torch.from_numpy(ids),
                           torch.from_numpy(alive))
    o = grid.order
    np.testing.assert_array_equal(o.numpy(), order)
    bounds = tnbr.run_bounds(tspec, grid.sorted_flat)
    sids = torch.from_numpy(ids)[o].contiguous()
    f, d, mask = span_mask.contact_seed_cuda(
        tjkr.pack_physics(torch.from_numpy(locs)[o], torch.from_numpy(radii)[o]), sids,
        torch.from_numpy(alive)[o].contiguous(), bounds,
        torch.from_numpy(partner_ids)[o].contiguous(), uniform_radius=BIO.max_radius, **LAW)
    np.testing.assert_array_equal(f.numpy(), fd[:, :3])
    np.testing.assert_array_equal(d.numpy(), fd[:, 3].astype(np.int32))
    inv = np.argsort(order)
    np.testing.assert_array_equal(d.numpy()[inv][:8], [1, 1, 0, 0, 0, 0, 1, 1])
    kept = span_mask.mask_compact_cuda(sids, bounds, mask, K).numpy()[inv]
    assert kept[0, 0] == ids[1] and kept[1, 0] == ids[0]
    assert float(np.abs(f.numpy()[inv][0]).max()) > 0  # the kept bond pulls
