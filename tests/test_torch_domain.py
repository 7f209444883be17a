"""PyTorch port: the domain-decomposed engine (``parallel.domain_engine``) on
the CPU, every tile on the CPU.

- against the port's single engine over 5 steps: integers, floats and bond
  sets bit-equal by agent id, for 4 stripes and the tile grids (2, 2),
  (2, 4) and (1, 4), in 3D, in a dense colony (sums across the TPU
  kernels' lane windows and chunks, also with every span start clipped),
  and with diffusion and the optional phases (the lattice within 1e-5: the
  tiles' deposits are summed in tile order, the single engine deposits
  straight onto the lattice). A tile sums in the single engine's grouping:
  its rows' positions in the colony's sorted order and the blocks' span
  starts come from the tiles' summed per-bin counts;
- the id-list and span-mask contact paths give the same decomposed colony;
- against the JAX ``DomainHipscEngine(use_pallas=False)`` on the 8-device
  CPU mesh of ``tests/conftest.py``, one step from the same state (the
  convention of ``test_torch_step.py``), the port on the general law:
  integers and bond sets equal by id, lattices within 1e-5, and positions
  bit-equal to the port's single engine stepping the same flat state.
  Against the JAX package the positions are held to one float32 spacing of
  the largest coordinate: the port follows the TPU kernels' general law
  (``rsqrt``, ``ops.jkr._pair_general``) and their sums' grouping, where
  the XLA path takes a square root and divides by it and sums each row's
  padded window in 32-wide partial sums (ROADMAP A11). The decomposed
  state converts between the packages (``convert.domain_state_from_numpy``);
- migration re-homes agents (along y and diagonally too) and keeps every
  agent in the tile that owns its bin column and row;
- undersized halo, migration, per-tile and mask capacities grow and
  re-execute to the colony of an engine built with large ones;
- ``run_steps`` equals a sequence of ``safe_step``s, ``rebalance`` keeps the
  trajectory, a checkpoint resumes bit-exact on the same and (elastic) on
  other tile grids, and in either package;
- the bytes a step's exchanges hand between tiles do not grow with the
  per-tile slots;
- without CUDA, ``device="cuda"`` raises.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from hipsc_abm_tpu.models.params import DiffusionParams as JaxDiffusionParams
from hipsc_abm_tpu.models.params import ExperimentalParams as JaxExperimentalParams
from hipsc_abm_tpu.models.params import GeneralParams as JaxGeneralParams
from hipsc_abm_tpu.parallel.domain_engine import DomainHipscEngine as JaxDomainEngine
from hipsc_abm_tpu.parallel.domain_engine import domain_config_from_meta as jax_cfg_from_meta
from hipsc_abm_tpu_torch import convert
from hipsc_abm_tpu_torch.engine import HipscEngine
from hipsc_abm_tpu_torch.params import DiffusionParams, ExperimentalParams, GeneralParams
from hipsc_abm_tpu_torch.parallel import DomainHipscEngine
from hipsc_abm_tpu_torch.parallel.domain_engine import (
    domain_config_from_meta,
    domain_config_to_meta,
)

DIFF = dict(spat_res=25.0, diffuse_dt=6.0, diffuse_const=2.0, max_concentration=2.0,
            degradation=0.05, release_amount=0.02, uptake_amount=0.004)


# one thread: the small ops of a tile step are slower on a thread pool that
# other test workers share (as in test_torch_calibrate.py)
torch.set_num_threads(1)


def by_id(d: dict) -> dict:
    """{field: values} of the alive agents in id order, with the bond sets,
    from a flat numpy state dict."""
    alive = d["alive"]
    order = np.argsort(d["arrays"]["ids"][alive])
    out = {k: v[alive][order] for k, v in d["arrays"].items()}
    partners = np.where(d["bond_mask"], d["partners"], -1)[alive][order]
    out["bonds"] = [frozenset(r[r >= 0].tolist()) for r in partners]
    return out


def flat(dom, dstate) -> dict:
    return by_id(convert.state_to_numpy(dom.to_cell_state(dstate)))


def assert_bit_equal(a: dict, b: dict):
    np.testing.assert_array_equal(a["ids"], b["ids"])
    for k in a:
        if k == "bonds":
            assert a[k] == b[k], "bond sets"
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def make_engines(n=1200, gata6=120, box=1600.0, size=None, diff=None, flags=None, **dom_kw):
    gen = GeneralParams(num_to_start=n, end_step=8, size=size or (box, box, 0.0))
    xp = ExperimentalParams(num_gata6=gata6, dox_step=2 if diff is None else 1)
    dom = DomainHipscEngine(gen, xp, diff=diff, device="cpu", **(flags or {}), **dom_kw)
    single = HipscEngine(gen, xp, diff=diff, cfg=dom.cfg.base, device="cpu")
    return dom, single


def run_both(dom, single, seed, steps):
    ds, ss = dom.init_state(seed=seed), single.init_state(seed=seed)
    single.cfg = dom.cfg.base
    for _ in range(steps):
        ds, di = dom.safe_step(ds)
        ss, si = single.safe_step(ss)
        assert (di.num_agents, di.num_added, di.num_removed) == (
            si.num_agents, si.num_added, si.num_removed)
    return ds, ss


def tile_of(dom, dstate) -> dict:
    """{agent id: tile} of every alive agent."""
    return {int(i): s for s, (a, alive) in enumerate(zip(dstate.arrays, dstate.alive))
            for i in a["ids"][alive].tolist()}


def assert_resident(dom, dstate):
    """Every agent's bin column and row lie in its tile's ranges."""
    cfg = dom.cfg
    cell = cfg.base.nbr_spec.cell_size
    for s, (a, alive) in enumerate(zip(dstate.arrays, dstate.alive)):
        tx, ty = divmod(s, cfg.n_ty)
        loc = a["locations"][alive].numpy()
        col = np.floor(loc[:, 0] / cell).astype(int) + 1
        assert ((col >= cfg.col_bounds[tx]) & (col < cfg.col_bounds[tx + 1])).all(), s
        if cfg.n_ty > 1:
            row = np.floor(loc[:, 1] / cell).astype(int) + 1
            assert ((row >= cfg.row_bounds[ty]) & (row < cfg.row_bounds[ty + 1])).all(), s


@pytest.mark.parametrize("grid", [{"n_stripes": 4}, {"tiles": (2, 2)}, {"tiles": (2, 4)},
                                  {"tiles": (1, 4)}], ids=["stripes4", "2x2", "2x4", "1x4"])
def test_domain_matches_single_engine(grid):
    dom, single = make_engines(**grid)
    ds, ss = run_both(dom, single, seed=11, steps=5)
    assert_bit_equal(flat(dom, ds), by_id(convert.state_to_numpy(ss)))
    assert sum(len(b) for b in flat(dom, ds)["bonds"]) > 0
    assert_resident(dom, ds)


@pytest.mark.parametrize("grid,size", [({"n_stripes": 4}, (900.0, 300.0, 300.0)),
                                       ({"tiles": (2, 2)}, (700.0, 700.0, 250.0))],
                         ids=["stripes", "2x2"])
def test_domain_matches_single_engine_3d(grid, size):
    dom, single = make_engines(n=900, gata6=90, size=size, **grid)
    ds, ss = run_both(dom, single, seed=17, steps=3)
    assert_bit_equal(flat(dom, ds), by_id(convert.state_to_numpy(ss)))


@pytest.mark.parametrize("spans", ["default", "capacity"])
def test_dense_domain_matches_single_engine(spans):
    """A dense colony, whose rows' candidates cross the TPU kernels' 32-lane
    windows and chunks, so that the sums' grouping matters; with spans as
    wide as the capacity every block's span start is clipped to 0. Tiles
    equal the single engine bit for bit."""
    dom, single = make_engines(n=1500, gata6=150, box=900.0, tiles=(2, 2))
    if spans == "capacity":
        cap = dom.cfg.base.capacity
        dom.cfg = dataclasses.replace(dom.cfg, base=dataclasses.replace(
            dom.cfg.base, jkr_span=cap, nbr_span=cap))
    ds, ss = run_both(dom, single, seed=5, steps=2)
    assert_bit_equal(flat(dom, ds), by_id(convert.state_to_numpy(ss)))


@pytest.mark.parametrize("grid,size", [({"n_stripes": 4}, None), ({"tiles": (2, 2)}, None),
                                       ({"tiles": (2, 2)}, (700.0, 700.0, 250.0))],
                         ids=["stripes4", "2x2", "3d-2x2"])
def test_tile_positions_are_the_single_engines(grid, size):
    """The order of a tile's float sums (``domain_engine._tile_grouping``):
    from the tiles' summed per-bin counts, every own row's position in the
    colony's sorted order equals its position in the single engine's sorted
    order, by agent id, on the contact and the radius-15 lattices, and the
    blocks' span starts are the single engine's (``window_grouping``). A
    tile's rows here are its own and every agent its local lattice holds."""
    from hipsc_abm_tpu_torch.ops import neighbors as nbr_ops
    from hipsc_abm_tpu_torch.parallel.domain_engine import _bin_counts, _tile_grouping

    dom, _ = make_engines(n=900 if size else 1200, gata6=90 if size else 120, size=size,
                          **grid)
    ds = dom.init_state(seed=11)
    cfg, base = dom.cfg, dom.cfg.base
    colony = dom.to_cell_state(ds)
    loc, ids, alive = colony.arrays["locations"], colony.arrays["ids"], colony.alive
    consts = dom._stripe_consts(cfg)
    for spec, spec_l, offs, span in (
            (base.jkr_spec, cfg.jkr_spec_local, ("col_off_jkr", "row_off_jkr"), base.jkr_span),
            (base.nbr_spec, cfg.nbr_spec_local, ("col_off_nbr", "row_off_nbr"), base.nbr_span)):
        whole = nbr_ops.build_grid(spec, loc, ids, alive)
        n_live = int(alive.sum())
        position = {int(i): p for p, i in enumerate(ids[whole.order][:n_live].tolist())}
        # the single engine's grouping at its capacity (window_grouping)
        span_c = nbr_ops.span_cap(span, base.capacity)
        want = nbr_ops.grouping_of_bounds(nbr_ops.run_bounds(spec, whole.sorted_flat), span_c,
                                          base.capacity, nbr_ops.effective_chunk(span_c))
        counts = sum(_bin_counts(spec, a["locations"], live)
                     for a, live in zip(ds.arrays, ds.alive))
        checked = 0
        for s, c in enumerate(consts):
            own_ids = ds.arrays[s]["ids"][ds.alive[s]]
            others = ~torch.isin(ids, own_ids) & alive
            rows_loc = torch.cat([ds.arrays[s]["locations"][ds.alive[s]], loc[others]])
            rows_ids = torch.cat([own_ids, ids[others]])
            n_own = own_ids.shape[0]
            flat, coords = nbr_ops.local_flat(
                spec_l, nbr_ops._bin_coords(spec, rows_loc), getattr(c, offs[0]),
                getattr(c, offs[1]), torch.ones_like(rows_ids, dtype=torch.bool))
            g = nbr_ops.grid_from_flat_coords(flat, coords, rows_ids)
            grouping = _tile_grouping(spec, counts, rows_loc[g.order], g.sorted_flat, spec_l,
                                      span, base.capacity, cfg.n_stripes * cfg.per_stripe)
            own = g.order < n_own
            got = grouping.gpos[own].tolist()
            assert got == [position[int(i)] for i in rows_ids[g.order][own].tolist()], s
            live_blocks = -(-n_live // nbr_ops.GROUP_BLOCK)
            assert torch.equal(grouping.starts[:, :live_blocks], want.starts[:, :live_blocks])
            assert grouping.chunk == want.chunk
            checked += len(got)
        assert checked == n_live


def test_domain_diffusion_and_optional_phases_match_single():
    diff = DiffusionParams(**DIFF, field_coupling=True)
    flags = dict(enable_diffusion=True, enable_growth=True, enable_stochastic=True,
                 enable_diff_surround=True)
    dom, single = make_engines(n=700, gata6=70, box=1400.0, diff=diff, flags=flags,
                               tiles=(2, 2))
    ds, ss = run_both(dom, single, seed=23, steps=3)
    assert_bit_equal(flat(dom, ds), by_id(convert.state_to_numpy(ss)))
    got, want = ds.gradients[0]["fgf4_values"], ss.gradients["fgf4_values"]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    assert float(want.max()) > 0


def test_domain_id_list_equals_span_mask():
    a, _ = make_engines(tiles=(2, 2), contact_path="id_list")
    b, _ = make_engines(tiles=(2, 2))
    sa, sb = a.init_state(seed=5), b.init_state(seed=5)
    for _ in range(3):
        sa, ia = a.safe_step(sa)
        sb, ib = b.safe_step(sb)
    assert ia.jkr_rebuilds == ib.jkr_rebuilds
    assert_bit_equal(flat(a, sa), flat(b, sb))


def _jax_params(n, gata6, box, with_diff):
    gen = JaxGeneralParams(num_to_start=n, end_step=8, size=(box, box, 0.0))
    xp = JaxExperimentalParams(num_gata6=gata6, dox_step=1 if with_diff else 2)
    diff = JaxDiffusionParams(**DIFF) if with_diff else None
    return gen, xp, diff


@pytest.mark.skipif(jax.device_count() < 8, reason="needs the 8-device CPU mesh")
@pytest.mark.parametrize("grid,with_diff", [({"n_stripes": 4}, False),
                                            ({"tiles": (2, 2)}, True)],
                         ids=["stripes4", "2x2-diffusion"])
def test_domain_matches_jax_domain_engine(grid, with_diff):
    n, gata6, box = (700, 70, 1400.0) if with_diff else (1200, 120, 1600.0)
    gen, xp, diff = _jax_params(n, gata6, box, with_diff)
    flags = dict(enable_diffusion=True) if with_diff else {}
    jdom = JaxDomainEngine(gen, xp, diff=diff, use_pallas=False, **grid, **flags)
    tdom = DomainHipscEngine(*(convert.params_from_jax(p) for p in (gen, xp)),
                             diff=diff and convert.params_from_jax(diff), device="cpu",
                             **grid, **flags)
    # the law of the JAX engine's XLA path, the general one
    tdom.cfg = dataclasses.replace(tdom.cfg, base=dataclasses.replace(tdom.cfg.base,
                                                                      uniform_radius=None))
    js = jdom.init_state(seed=11)
    for _ in range(2 if with_diff else 1):  # a lattice and bonds to carry over
        js, _ = jdom.safe_step(js)
    host = convert.numpy_from_jax_state(js)
    ts = convert.domain_state_from_numpy(host, tdom.devices)
    assert tdom.cfg.per_stripe == host["alive"].shape[1]
    assert_bit_equal(by_id(convert.state_to_numpy(tdom.to_cell_state(ts))),
                     by_id(convert.numpy_from_jax_state(jdom.to_cell_state(js))))
    js2, jinfo = jdom.safe_step(js)
    ts2, tinfo = tdom.safe_step(ts)
    assert (tinfo.num_added, tinfo.num_removed) == (int(jinfo.num_added),
                                                      int(jinfo.num_removed))
    single = HipscEngine(tdom.gen, tdom.xp, diff=tdom.diff, cfg=tdom.cfg.base, device="cpu")
    ss2, _ = single.safe_step(tdom.to_cell_state(ts))
    a = by_id(convert.numpy_from_jax_state(jdom.to_cell_state(js2)))
    b = flat(tdom, ts2)
    assert_bit_equal(b, by_id(convert.state_to_numpy(ss2)))
    np.testing.assert_array_equal(b["ids"], a["ids"])
    for k in ("FGF4", "FGFR", "ERK", "GATA6", "NANOG", "states", "death_counters",
              "diff_counters", "div_counters", "fds_counters"):
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    assert b["bonds"] == a["bonds"]
    spacing = float(np.spacing(np.abs(a["locations"]).max().astype(np.float32)))
    np.testing.assert_allclose(b["locations"], a["locations"], rtol=0, atol=spacing)
    for g in js2.gradients:
        np.testing.assert_allclose(ts2.gradients[0][g].numpy(), np.asarray(js2.gradients[g]),
                                   rtol=0, atol=1e-5)
    # the decomposed layouts agree tile by tile: same owners, same counts
    back = convert.domain_state_to_numpy(ts2)
    jhost = convert.numpy_from_jax_state(js2)
    for s in range(tdom.cfg.n_stripes):
        got = np.sort(back["arrays"]["ids"][s][back["alive"][s]])
        want = np.sort(jhost["arrays"]["ids"][s][jhost["alive"][s]])
        np.testing.assert_array_equal(got, want, err_msg=f"tile {s}")


@pytest.mark.parametrize("grid,box", [({"n_stripes": 4}, 1200.0), ({"tiles": (2, 4)}, 1200.0)],
                         ids=["stripes", "2x4"])
def test_migration_rehomes_agents(grid, box):
    dom, _ = make_engines(n=1000, gata6=100, box=box, **grid)
    ds = dom.init_state(seed=7)
    before = tile_of(dom, ds)
    n0 = len(before)
    added = removed = 0
    for _ in range(6):
        ds, info = dom.safe_step(ds)
        added += info.num_added
        removed += info.num_removed
    after = tile_of(dom, ds)
    assert len(after) == n0 + added - removed
    moved = [i for i in after if i in before and after[i] != before[i]]
    assert moved, "no agent changed tile in 6 steps"
    if dom.cfg.n_ty > 1:
        n_ty = dom.cfg.n_ty
        assert any(after[i] // n_ty == before[i] // n_ty for i in moved), "no y move"
    assert_resident(dom, ds)


def test_diagonal_migration_is_delivered_in_one_step():
    dom, _ = make_engines(n=800, gata6=0, box=1200.0, tiles=(2, 4))
    ds = dom.init_state(seed=3)
    cfg = dom.cfg
    cell = cfg.base.nbr_spec.cell_size
    src = 0 * 4 + 1  # tile (0, 1); the target corner is tile (1, 2)
    row = int(torch.nonzero(ds.alive[src])[0])
    moved_id = int(ds.arrays[src]["ids"][row])
    loc = ds.arrays[src]["locations"].clone()
    loc[row] = torch.tensor([(cfg.col_bounds[1] - 1) * cell + 30.0,
                             (cfg.row_bounds[2] - 1) * cell + 30.0, 0.0])
    arrays = list(ds.arrays)
    arrays[src] = {**arrays[src], "locations": loc}
    ds, info = dom.safe_step(ds._replace(arrays=tuple(arrays)))
    assert info.mig_too_far == 0
    assert tile_of(dom, ds)[moved_id] == 1 * 4 + 2
    assert_resident(dom, ds)


def test_agent_crossing_a_whole_stripe_raises():
    dom, _ = make_engines(n=800, gata6=0, n_stripes=4)
    ds = dom.init_state(seed=3)
    row = int(torch.nonzero(ds.alive[0])[0])
    loc = ds.arrays[0]["locations"].clone()
    loc[row, 0] = 0.9 * 1600.0
    arrays = list(ds.arrays)
    arrays[0] = {**arrays[0], "locations": loc}
    with pytest.raises(RuntimeError, match="crossed an entire stripe"):
        dom.safe_step(ds._replace(arrays=tuple(arrays)))


def test_capacity_growth_reexecutes_to_the_large_caps_colony():
    """Halo rows, migration rows, per-tile slots, the drift allowance and
    the span-mask width all start undersized and grow by re-execution; the
    colony equals that of an engine whose capacities never overflow."""
    small, _ = make_engines(n=1000, gata6=100, box=1500.0, tiles=(2, 2), halo_cap=8,
                            mig_cap=2, drift_allowance=4.0, per_stripe=256)
    large, _ = make_engines(n=1000, gata6=100, box=1500.0, tiles=(2, 2), halo_cap=512,
                            mig_cap=256, per_stripe=1536)
    s_small, s_large = small.init_state(seed=5), large.init_state(seed=5)
    small.cfg = dataclasses.replace(small.cfg, base=dataclasses.replace(
        small.cfg.base, mask_bits=8))
    cfg0 = small.cfg

    def all_due(state):  # every division clock at its threshold: the tiles fill up
        due = small.bio.pluri_div_thresh
        return state._replace(arrays=tuple(
            {**a, "div_counters": torch.full_like(a["div_counters"], due)}
            for a in state.arrays))

    s_small, s_large = all_due(s_small), all_due(s_large)
    for _ in range(5):
        s_small, _ = small.safe_step(s_small)
        s_large, _ = large.safe_step(s_large)
    cfg = small.cfg
    assert cfg.per_stripe > cfg0.per_stripe and cfg.mig_cap > cfg0.mig_cap
    assert cfg.drift_allowance > cfg0.drift_allowance and cfg.halo_cap > cfg0.halo_cap
    assert cfg.base.mask_bits > cfg0.base.mask_bits
    assert large.cfg.per_stripe == 1536 and large.cfg.halo_cap == 512
    assert_bit_equal(flat(small, s_small), flat(large, s_large))


def test_run_steps_equals_safe_steps():
    dom, _ = make_engines(n=900, gata6=90, box=1400.0, tiles=(2, 2))
    s0 = dom.init_state(seed=9)
    block, infos = dom.run_steps(s0, 3)
    step = s0
    rows = []
    for _ in range(3):
        step, info = dom.safe_step(step)
        rows.append(info)
    assert_bit_equal(flat(dom, block), flat(dom, step))
    assert block.step == step.step and torch.equal(block.key, step.key)
    assert int(block.next_id) == int(step.next_id)
    np.testing.assert_array_equal(infos.num_agents, [r.num_agents for r in rows])
    np.testing.assert_array_equal(infos.jkr_rebuilds, [r.jkr_rebuilds for r in rows])


def test_rebalance_keeps_the_trajectory():
    dom, _ = make_engines(n=1000, gata6=100, box=1500.0, tiles=(4, 2))
    ref, _ = make_engines(n=1000, gata6=100, box=1500.0, tiles=(4, 2))
    a, b = dom.init_state(seed=3), ref.init_state(seed=3)
    a, _ = dom.safe_step(a)
    b, _ = ref.safe_step(b)
    bounds = (dom.cfg.col_bounds, dom.cfg.row_bounds)
    a = dom.rebalance(a)
    assert (dom.cfg.col_bounds, dom.cfg.row_bounds) != bounds
    for _ in range(2):
        a, _ = dom.safe_step(a)
        b, _ = ref.safe_step(b)
    assert_bit_equal(flat(dom, a), flat(ref, b))


def test_checkpoint_resumes_bit_exact_on_same_and_other_tile_grids(tmp_path):
    gen = GeneralParams(num_to_start=900, end_step=8, size=(1500.0, 1500.0, 0.0))
    xp = ExperimentalParams(num_gata6=90, dox_step=2)
    dom = DomainHipscEngine(gen, xp, tiles=(2, 2), device="cpu")
    state = dom.init_state(seed=13)
    for _ in range(2):
        state, _ = dom.safe_step(state)
    path = str(tmp_path / "domain.npz")
    dom.save_checkpoint(path, state)
    for _ in range(2):
        state, _ = dom.safe_step(state)
    want = flat(dom, state)

    same = DomainHipscEngine(gen, xp, tiles=(2, 2), device="cpu")
    restored = same.load_checkpoint(path)
    assert same.cfg == dataclasses.replace(dom.cfg, base=dataclasses.replace(
        dom.cfg.base, mask_bits=0))  # the mask width is derived again
    for grid in ({"n_stripes": 2}, {"tiles": (1, 4)}):
        other = DomainHipscEngine(gen, xp, device="cpu", **grid)
        with pytest.raises(ValueError, match="elastic"):
            other.load_checkpoint(path)
        resumed = other.load_checkpoint(path, elastic=True)
        assert other.cfg.base.bond_cap == dom.cfg.base.bond_cap
        for _ in range(2):
            resumed, _ = other.safe_step(resumed)
        assert_bit_equal(flat(other, resumed), want)
    for _ in range(2):
        restored, _ = same.safe_step(restored)
    assert_bit_equal(flat(same, restored), want)


def test_domain_config_meta_in_both_packages():
    dom, _ = make_engines(tiles=(2, 2))
    meta = domain_config_to_meta(dom.cfg)
    assert domain_config_from_meta(meta) == dataclasses.replace(
        dom.cfg, base=dataclasses.replace(dom.cfg.base, contact_path="id_list"))
    jcfg = jax_cfg_from_meta(meta)  # the JAX package reads the port's layout
    assert (jcfg.n_stripes, jcfg.n_ty, jcfg.col_bounds, jcfg.per_stripe) == (
        4, 2, dom.cfg.col_bounds, dom.cfg.per_stripe)
    gen, xp, _ = _jax_params(1200, 120, 1600.0, False)
    jdom = JaxDomainEngine(gen, xp, tiles=(2, 2), use_pallas=False)
    from hipsc_abm_tpu.parallel.domain_engine import domain_config_to_meta as jax_to_meta

    port = domain_config_from_meta(jax_to_meta(jdom.cfg))
    assert (port.n_stripes, port.n_ty, port.col_bounds, port.row_bounds) == (
        4, 2, jdom.cfg.col_bounds, jdom.cfg.row_bounds)
    assert port.base.bond_cap == jdom.cfg.base.bond_cap


def test_exchange_bytes_do_not_grow_with_the_slots():
    """The counterpart of ``test_domain_collectives_are_boundary_sized``:
    the packs a step hands between tiles are sized by the halo and
    migration capacities, not by the per-tile slots."""
    totals = []
    for per_stripe in (768, 4 * 768):
        dom, _ = make_engines(tiles=(2, 2), per_stripe=per_stripe)
        state = dom.init_state(seed=1)
        assert dom.cfg.per_stripe == per_stripe
        dom.safe_step(state)
        assert dom.attempts == 1 and len(dom.exchange_bytes) == 1
        totals.append(dom.exchange_bytes[0])
    assert totals[0] == totals[1] > 0


def test_cuda_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    gen = GeneralParams(num_to_start=100, end_step=2, size=(600.0, 600.0, 0.0))
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        DomainHipscEngine(gen, ExperimentalParams(num_gata6=0), n_stripes=2)
