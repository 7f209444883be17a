"""PyTorch port: the optional biology phases (growth, stochastic GATA6 bumps,
diff_surround) and the contact kernels' general-radius pair law, against the
JAX package on identical inputs.

- the three phases of ``models.biology`` against ``hipsc_abm_tpu``'s, on
  the same arrays and keys: bit-equal (the same float32 and integer
  operations, the same id-keyed draws);
- the plain general-law contact substeps (B6 id-list, B2 seed, B1 masked,
  B3 compaction; the CUDA kernels are held to them in test_torch_cuda.py)
  against the JAX Pallas kernels in interpret mode with ``uniform_radius=None``,
  radii drawn uniform in [min_radius, max_radius] and a few one growth
  increment past it, in 2D and 3D, also for bonded pairs from 4e-3 um inside
  to 4e-3 um past their own break distance;
- one ``hipsc_step`` with the three flags and diffusion on, on both contact
  paths, and two 3D spheroid ``safe_step``s, against the JAX engine (its XLA
  path): integer state and radii exact by agent id (see
  ``_assert_same_radii``).

Tolerances: the substeps' forces equal the Pallas kernels' bit for bit
(the general law as XLA:CPU compiles the kernels' body, ``ops.jkr.
_pair_general``, with glibc's ``powf``, summed in the kernels' grouping,
``neighbors.grouped_sum``); positions after a step against the JAX
engine's XLA path (its own pair law and window sums) 1e-3 um in 2D, 1e-4
um in 3D (``test_torch_step.py``, ``test_torch_3d.py``); the lattice
1e-6; degrees, bond sets and every integer field exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipsc_abm_tpu.engine import HipscEngine as JaxEngine
from hipsc_abm_tpu.models import biology as jbio
from hipsc_abm_tpu.models.params import BiologyParams
from hipsc_abm_tpu.ops import jkr as jjkr
from hipsc_abm_tpu.ops import neighbors as jnbr
from hipsc_abm_tpu.ops.pallas_contact import (
    compact_mask_bonds,
    contact_substep_ids_to_mask,
    contact_substep_masked,
    contact_substep_pallas,
)
from hipsc_abm_tpu_torch import convert
from hipsc_abm_tpu_torch.engine import HipscEngine
from hipsc_abm_tpu_torch.models import biology as tbio
from hipsc_abm_tpu_torch.ops import contact as tcontact
from hipsc_abm_tpu_torch.ops import jkr as tjkr
from hipsc_abm_tpu_torch.ops import neighbors as tnbr
from hipsc_abm_tpu_torch.ops import span_mask
from test_torch_3d import _spheroid
from test_torch_contact import assert_live_starts
from test_torch_step import _agents, _assert_same_colony, _bench_like, _j, _key, _t

BIO = BiologyParams()
TBIO = convert.params_from_jax(BIO)
CELL = BIO.jkr_radius + 2 * BIO.jkr_break_band + 2.0
LAW = dict(radius=BIO.jkr_radius, adhesion_const=BIO.adhesion_const,
           poisson=BIO.poisson, youngs=BIO.youngs, break_d=BIO.jkr_break_d)
FLAGS = dict(enable_growth=True, enable_stochastic=True, enable_diff_surround=True)


def seeded_radii(n: int, seed: int) -> np.ndarray:
    """Radii uniform in [min_radius, max_radius], as growth spreads them
    (all radii start at max_radius and daughters copy their mother's)."""
    rs = np.random.default_rng(seed)
    return rs.uniform(BIO.min_radius, BIO.max_radius, n).astype(np.float32)


# ---------------------------------------------------------------------------
# the three phases
# ---------------------------------------------------------------------------


def test_cell_growth_matches_jax():
    """Bit-equal to the JAX function compiled as the engine compiles it
    (under ``jax.jit``, which fuses ``growth * dc + min_radius``), with radii
    below, at and past max_radius (no clamp: a radius passes max_radius by
    up to one increment, as in the reference)."""
    a, alive, _ = _agents(6)
    rs = np.random.default_rng(6)
    radii = seeded_radii(300, 6)
    radii[rs.choice(300, 40, replace=False)] = BIO.max_radius
    a["div_counters"] = rs.integers(0, BIO.diff_div_thresh + 1, 300).astype(np.int32)
    want = jax.jit(lambda *x: jbio.cell_growth(*x, BIO))(
        _j(radii), _j(a["states"]), _j(a["div_counters"]), _j(alive))
    got = tbio.cell_growth(_t(radii), _t(a["states"]), _t(a["div_counters"]), _t(alive), TBIO)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    grown = got.numpy()
    assert (grown != radii).sum() > 100 and grown.max() > BIO.max_radius


@pytest.mark.parametrize("nanog_too", [False, True])
def test_cell_stochastic_update_matches_jax(nanog_too):
    """Exact, at the default bump probability and at 0.3 (so that many
    agents bump), on a 3-valued field where a bump can meet the top value."""
    a, alive, _ = _agents(7)
    rs = np.random.default_rng(7)
    jkey, tkey = _key(7)
    for prob in (BIO.GATA6_prob, 0.3):
        bio = dataclasses.replace(BIO, field=3, GATA6_prob=prob, NANOG_prob=prob)
        g6, ng = (rs.integers(0, 3, 300).astype(np.int32) for _ in range(2))
        want = jbio.cell_stochastic_update(_j(g6), _j(ng), _j(a["ids"]), _j(alive), jkey, bio,
                                           nanog_too=nanog_too)
        got = tbio.cell_stochastic_update(_t(g6), _t(ng), _t(a["ids"]), _t(alive), tkey,
                                          convert.params_from_jax(bio), nanog_too=nanog_too)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0].numpy() != g6).sum() > 30
    assert ((got[1].numpy() != ng).sum() > 30) == nanog_too


def test_cell_diff_surround_matches_jax():
    a, alive, _ = _agents(8)
    rs = np.random.default_rng(8)
    n_diff = rs.integers(0, 10, 300).astype(np.int32)
    names = ("GATA6", "NANOG", "states")
    want = jbio.cell_diff_surround(*[_j(a[k]) for k in names], _j(alive), _j(n_diff), BIO)
    got = tbio.cell_diff_surround(*[_t(a[k]) for k in names], _t(alive), _t(n_diff), TBIO)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0].numpy() != a["GATA6"]).sum() > 5


# ---------------------------------------------------------------------------
# the general-radius pair law: plain substeps vs the Pallas kernels
# ---------------------------------------------------------------------------


def _specs(box, run_cap=64):
    jspec = jnbr.GridSpec.from_box(box, CELL, run_cap=run_cap)
    return jspec, tnbr.GridSpec(**dataclasses.asdict(jspec))


def _colony(dims, K, seed):
    """A colony with unequal radii (a few one growth increment past
    max_radius), scrambled ids, a few dead slots, bonds from one JAX
    general-law substep at earlier positions, and positions one substep
    later: ``(locs, moved, radii, ids, alive, partner_ids, box)``."""
    rs = np.random.default_rng(seed)
    C, n, box = (256, 230, (150.0, 150.0, 0.0)) if dims == 2 else (128, 118, (48.0,) * 3)
    locs = np.zeros((C, 3), np.float32)
    locs[:n, :dims] = rs.random((n, dims)).astype(np.float32) * np.float32(box[0])
    alive = np.zeros(C, bool)
    alive[:n] = True
    alive[rs.choice(n, 8, replace=False)] = False
    ids = rs.permutation(4 * C)[:C].astype(np.int32)
    radii = seeded_radii(C, seed)
    radii[rs.choice(n, 6, replace=False)] = BIO.max_radius + np.float32(BIO.pluri_growth)
    jspec, _ = _specs(box)
    earlier = locs.copy()
    earlier[:n, :dims] -= rs.normal(0.0, 1.2, (n, dims)).astype(np.float32)
    g0, pos0, valid0, _ = jnbr.sorted_window(jspec, jnp.asarray(earlier), jnp.asarray(ids),
                                             jnp.asarray(alive))
    packed0 = jjkr.pack_physics(jnp.asarray(earlier), jnp.asarray(radii), jnp.asarray(ids),
                                jnp.asarray(alive))
    _, bonds, _ = jjkr.jkr_substep(jjkr.BondState.empty(C, K), packed0, g0.order, pos0,
                                   valid0, **LAW)
    partner_ids = np.where(np.asarray(bonds.mask), np.asarray(bonds.partners), -1)
    moved = locs.copy()
    moved[:n, :dims] += rs.normal(0.0, 0.4, (n, dims)).astype(np.float32)
    return locs, moved, radii, ids, alive, partner_ids.astype(np.int32), box


def _break_pairs(dims, seed=11, K=8):
    """Bonded pairs far apart, each with its own radii, at offsets from 4e-3
    um inside to 4e-3 um past the pair's own break distance (offsets within
    1e-4 um left out: there the rsqrt of the Pallas kernels and the sqrt of
    the plain law may round apart). Returns the ``_colony`` tuple (moved =
    locs) and the offsets."""
    off = np.linspace(-4e-3, 4e-3, 60)
    off = off[np.abs(off) > 1e-4]
    n = len(off)
    rs = np.random.default_rng(seed)
    side = int(np.ceil(n ** (1.0 / dims)))
    box = (40.0 * (side + 1),) * dims + (0.0,) * (3 - dims)
    C = -(-(2 * n + 64) // 128) * 128  # the Pallas kernels' row blocks
    radii = np.full(C, BIO.max_radius, np.float32)
    radii[:2 * n] = seeded_radii(2 * n, seed)
    e_hat = 1.0 / (2.0 * (1.0 - BIO.poisson ** 2) / BIO.youngs)
    scale_c = ((np.pi * BIO.adhesion_const) / e_hat) ** (2.0 / 3.0)
    locs = np.zeros((C, 3), np.float32)
    for k in range(n):
        ri, rj = float(radii[2 * k]), float(radii[2 * k + 1])
        r_hat = ri * rj / (1e6 * (ri + rj))
        reach = ri + rj - BIO.jkr_break_d * scale_c * r_hat ** (1.0 / 3.0) * 1e6
        base = np.zeros(3)
        base[:dims] = 40.0 * (np.asarray(np.unravel_index(k, (side,) * dims)) + 1)
        u = np.zeros(3)
        u[:dims] = rs.normal(size=dims)
        locs[2 * k] = base
        locs[2 * k + 1] = base + (reach + off[k]) * u / np.linalg.norm(u)
    alive = np.zeros(C, bool)
    alive[:2 * n] = True
    ids = rs.permutation(10 * C)[:C].astype(np.int32)
    partners = np.full((C, K), -1, np.int32)
    first = 2 * np.arange(n)
    partners[first, 0], partners[first + 1, 0] = ids[first + 1], ids[first]
    return (locs, locs.copy(), radii, ids, alive, partners, box), off


def _pallas(colony, K):
    """The JAX Pallas kernels (interpret mode, general law) on the sorted
    rows: B6 at ``locs``; B2 at ``locs``, then B1 at ``moved`` with B2's
    mask, then B3. Returns ``(order, {name: (force and degree, bonds)})``."""
    locs, moved, radii, ids, alive, partner_ids, box = colony
    C = locs.shape[0]
    jspec, _ = _specs(box)
    jgrid = jnbr.build_grid(jspec, jnp.asarray(locs), jnp.asarray(ids), jnp.asarray(alive))
    order = np.asarray(jgrid.order)

    def srt_pack(xyz):
        packed = jjkr.pack_physics(jnp.asarray(xyz), jnp.asarray(radii), jnp.asarray(ids),
                                   jnp.asarray(alive))
        return packed[order].at[:, 6].set(jgrid.sorted_flat.astype(jnp.float32))

    _, _, span_needed, _ = jnbr.block_span_plan(jspec, jgrid.sorted_flat, 128, span=C,
                                                capacity=C, chunk=C)
    span = min(-(-int(span_needed) // 128) * 128, C)
    starts, needs, _, _ = jnbr.block_span_plan(jspec, jgrid.sorted_flat, 128, span=span,
                                               capacity=C, chunk=128)
    plan = dict(block=128, span=span, chunk=128, run_offs=jspec.flat_run_offsets)
    pkw = dict(plan, uniform_radius=None, interpret=True, **LAW)
    srt_bonds = jnp.asarray(partner_ids.astype(np.float32))[order]
    out = {"B6": contact_substep_pallas(srt_pack(locs), srt_bonds, starts, needs, **pkw)}
    fd2, m1 = contact_substep_ids_to_mask(srt_pack(locs), srt_bonds, starts, needs, **pkw)
    fd1, m2 = contact_substep_masked(srt_pack(moved), m1, starts, needs, **pkw)
    out["B2"] = (fd2, None)
    out["B1"] = (fd1, compact_mask_bonds(srt_pack(moved), m2, starts, needs, bond_cap=K,
                                         interpret=True, **plan))
    out["plan"] = (np.asarray(starts), span)
    return order, out


def _port(colony, K, plan):
    """The port's wrappers on CPU tensors (their plain versions), general
    law, on the same sorted rows, summing in the grouping of the Pallas
    ``plan`` (its span starts and span, chunk 128): ``(order, {name:
    (force, degree, bonds)})``."""
    locs, moved, radii, ids, alive, partner_ids, box = colony
    _, tspec = _specs(box)
    grid = tnbr.build_grid(tspec, torch.from_numpy(locs), torch.from_numpy(ids),
                           torch.from_numpy(alive))
    o = grid.order
    bounds = tnbr.run_bounds(tspec, grid.sorted_flat)
    rows = (torch.from_numpy(ids)[o].contiguous(), torch.from_numpy(alive)[o].contiguous(),
            bounds)
    partners = torch.from_numpy(partner_ids)[o].contiguous()

    def xyzr(xyz):
        return tjkr.pack_physics(torch.from_numpy(xyz)[o], torch.from_numpy(radii)[o])

    starts, span = plan
    grouping = tnbr.grouping_of_bounds(bounds, span, locs.shape[0], 128)
    assert_live_starts(grouping, starts, bounds)
    law = dict(uniform_radius=None, grouping=grouping, **LAW)
    out = {"B6": tcontact.contact_substep_cuda(xyzr(locs), *rows, partners, **law)}
    f2, d2, mask = span_mask.contact_seed_cuda(xyzr(locs), *rows, partners, **law)
    f1, d1, _ = span_mask.contact_masked_cuda(xyzr(moved), *rows, mask, **law)
    out["B2"] = (f2, d2, None)
    out["B1"] = (f1, d1, span_mask.mask_compact_cuda(rows[0], bounds, mask, K))
    return o.numpy(), out


def _sets(rows):
    return [frozenset(r[r >= 0].tolist()) for r in np.asarray(rows).astype(np.int64)]


def _assert_matches_pallas(colony, K):
    """Each substep's forces and degrees exact, and the bond sets of rows
    within K exact; returns the port's outputs."""
    order, want = _pallas(colony, K)
    t_order, got = _port(colony, K, want["plan"])
    np.testing.assert_array_equal(t_order, order)
    for name in ("B6", "B2", "B1"):
        (fd, jbonds), (f, d, bonds) = want[name], got[name]
        np.testing.assert_array_equal(f.numpy(), np.asarray(fd[:, :3]), err_msg=name)
        np.testing.assert_array_equal(d.numpy(), np.asarray(fd[:, 3]).astype(np.int32),
                                      err_msg=name)
        if jbonds is not None:
            within = (d <= K).numpy()
            g, w = _sets(bonds.numpy()), _sets(jbonds)
            assert [x for x, k in zip(g, within) if k] == [x for x, k in zip(w, within) if k]
    return got


@pytest.mark.parametrize("dims", [2, 3])
def test_general_law_substeps_match_pallas_interpret(dims):
    """B6, then B2 -> B1 (positions moved, window frozen) -> B3, with
    unequal radii, against the Pallas kernels with ``uniform_radius=None``."""
    K = 8
    colony = _colony(dims, K, seed=dims)
    got = _assert_matches_pallas(colony, K)
    f, d, _ = got["B6"]
    radii, alive = colony[2], colony[4]
    assert np.ptp(radii[alive]) > 1.0 and radii.max() > BIO.max_radius
    assert int(d.sum()) > alive.sum() and float(f.abs().max()) > 0
    if dims == 3:
        assert float(f[:, 2].abs().max()) > 0


@pytest.mark.parametrize("dims", [2, 3])
def test_general_law_at_the_break_distance_matches_pallas_interpret(dims):
    """Bonded pairs of unequal radii from 4e-3 um inside to 4e-3 um past
    their own break distance: the pairs inside keep their bond and pull,
    those past it break, on all three substeps and in the JAX kernels."""
    K = 8
    colony, off = _break_pairs(dims)
    got = _assert_matches_pallas(colony, K)
    n_in = int((off < 0).sum())
    assert n_in > 10 and int((off > 0).sum()) > 10
    for name in ("B6", "B2", "B1"):
        f, d, _ = got[name]
        assert int(d.sum()) == 2 * n_in, name
        assert int((f.abs().sum(dim=1) > 0).sum()) == 2 * n_in, name


# ---------------------------------------------------------------------------
# whole steps
# ---------------------------------------------------------------------------


def _with(state, arrays):
    """A JAX state with some arrays replaced (numpy)."""
    return state._replace(arrays={**state.arrays, **{k: jnp.asarray(v) for k, v in
                                                     arrays.items()}})


def _assert_same_radii(jstate, tstate, label):
    """Radii by agent id, bit for bit: growth's ``pluri_growth * dc +
    min_radius`` is one FMA in the port, as XLA:CPU fuses it inside the
    JAX engine's jitted step."""
    a, b = convert.numpy_from_jax_state(jstate), convert.state_to_numpy(tstate)
    ia, ib = (np.argsort(x["arrays"]["ids"][x["alive"]]) for x in (a, b))
    got, want = b["arrays"]["radii"][b["alive"]][ib], a["arrays"]["radii"][a["alive"]][ia]
    assert got.shape == want.shape, label
    np.testing.assert_array_equal(got, want, err_msg=label)


def _flagged_state():
    """One JAX step of the 2D bench-like colony at 500 cells, packed into a
    250 um box (~10 radius-15 neighbours a cell, where the bench's density
    gives ~1), with the three flags and diffusion on (bonds and a lattice),
    then radii drawn uniform in [min_radius, max_radius], 60% of the cells
    differentiated and the rest NANOG-high, so that diff_surround finds
    cells with 6 differentiated neighbours to induce."""
    gen, xp, diff = _bench_like(500)
    gen = dataclasses.replace(gen, size=(250.0, 250.0, 0.0))
    jeng = JaxEngine(gen, xp, diff=diff, enable_diffusion=True, use_pallas=False, **FLAGS)
    assert jeng.cfg.uniform_radius is None
    js, _ = jeng.safe_step(jeng.init_state(seed=0))
    C = js.alive.shape[0]
    rs = np.random.default_rng(9)
    states = (rs.random(C) < 0.6).astype(np.int32)
    js = _with(js, {"radii": seeded_radii(C, 9), "states": states,
                    "GATA6": np.where(states == 0, 0, np.asarray(js.arrays["GATA6"])),
                    "NANOG": np.where(states == 0, 1, np.asarray(js.arrays["NANOG"]))})
    return gen, xp, diff, jeng, js


def _port_engine(jeng, gen, xp, diff, path, **flags):
    teng = HipscEngine(*(convert.params_from_jax(p) for p in (gen, xp)),
                       diff=convert.params_from_jax(diff), enable_diffusion=True,
                       device="cpu", contact_path=path, **flags)
    teng.cfg = dataclasses.replace(teng.cfg, capacity=jeng.cfg.capacity,
                                   bond_cap=jeng.cfg.bond_cap, div_cap=jeng.cfg.div_cap)
    return teng


@pytest.mark.parametrize("contact_path", ["id_list", "span_mask"])
def test_hipsc_step_with_optional_phases_matches_jax(contact_path):
    """One step with growth, stochastic bumps, diff_surround, FGF4 release
    and diffusion on, from one converted state: every phase changed the
    colony (against the same step with its flag off, on the JAX side), and
    the port's step equals the JAX engine's by agent id."""
    gen, xp, diff, jeng, js = _flagged_state()
    teng = _port_engine(jeng, gen, xp, diff, contact_path, **FLAGS)
    assert teng.cfg.uniform_radius is None and teng.cfg.enable_diff_surround
    d = convert.numpy_from_jax_state(js)
    js2, jinfo = jeng.safe_step(js)
    ts2, tinfo = teng.safe_step(convert.state_from_numpy(d, "cpu"))
    assert tinfo.num_added == int(jinfo.num_added) > 0
    assert tinfo.jkr_max_degree == int(jinfo.jkr_max_degree)
    _assert_same_colony(js2, ts2, f"flagged step [{contact_path}]")
    _assert_same_radii(js2, ts2, f"flagged step [{contact_path}] radii")
    if contact_path == "id_list":
        after = convert.numpy_from_jax_state(js2)
        for flag, field in (("enable_growth", "radii"), ("enable_stochastic", "GATA6"),
                            ("enable_diff_surround", "GATA6")):
            off = JaxEngine(gen, xp, diff=diff, enable_diffusion=True, use_pallas=False,
                            **dict(FLAGS, **{flag: False}))
            off.cfg = dataclasses.replace(jeng.cfg, **{flag: False})
            other = convert.numpy_from_jax_state(off.safe_step(js)[0])
            assert not np.array_equal(other["arrays"][field], after["arrays"][field]), flag


@pytest.mark.parametrize("contact_path", ["id_list", "span_mask"])
def test_spheroid_steps_with_optional_phases_match_jax(contact_path):
    """Two ``safe_step``s of the 3D spheroid (the example's configuration at
    440 cells, packed tighter so that K grows) with the three flags and
    seeded radii: the 9-run forms on the general law and the fourth moments
    pass in 3D."""
    gen, xp, ball = _spheroid(440, squeeze=0.8)
    jeng = JaxEngine(gen, xp, use_pallas=False, **FLAGS)
    teng = HipscEngine(convert.params_from_jax(gen), convert.params_from_jax(xp),
                       device="cpu", contact_path=contact_path, **FLAGS)
    assert teng.cfg.capacity == jeng.cfg.capacity and teng.cfg.uniform_radius is None
    js, ts = jeng.init_state(seed=0, locations=ball), teng.init_state(seed=0, locations=ball)
    radii = seeded_radii(ts.capacity, 4)
    js = _with(js, {"radii": radii})
    ts = ts._replace(arrays={**ts.arrays, "radii": torch.from_numpy(radii)})
    for step in range(2):
        js, jinfo = jeng.safe_step(js)
        ts, tinfo = teng.safe_step(ts)
        assert tinfo.jkr_max_degree == int(jinfo.jkr_max_degree)
        assert tinfo.num_added == int(jinfo.num_added)
        _assert_same_colony(js, ts, f"3D flagged {contact_path} step {step}", atol=1e-4)
        _assert_same_radii(js, ts, f"3D flagged {contact_path} step {step} radii")
    assert ts.bonds.partners.shape[1] > 8


def test_diff_surround_reads_states_as_the_fourth_moments_call():
    """The engine makes a fourth bio-moments call with diff_surround on, in
    motility mode, with ``states`` (not GATA6) as ``f2``: its lane 7 is
    each cell's count of differentiated neighbours."""
    from hipsc_abm_tpu_torch.tools import record_bio_calls

    gen, xp, diff, jeng, js = _flagged_state()
    teng = _port_engine(jeng, gen, xp, diff, "id_list", **FLAGS)
    calls = record_bio_calls(teng, convert.state_from_numpy(
        convert.numpy_from_jax_state(js), "cpu"))
    assert [k["mode"] for _, k in calls] == ["count", "pathway", "motility", "motility"]
    # diff_surround runs before motility
    (pos0, alive, bounds, loc1, f0, f1, f2), _ = calls[2]
    assert int(f0.abs().sum()) == 0 and int(f1.abs().sum()) == 0
    assert set(f2.unique().tolist()) == {0, 1} and not torch.equal(f2, calls[3][0][4])
    # the same call by brute force: live neighbours within the radius at the
    # build-time positions with f2 != 0
    from hipsc_abm_tpu_torch.ops.bio_moments import bio_moments_cuda

    m = bio_moments_cuda(*calls[2][0], **calls[2][1])
    xy = pos0[:, :3]
    near = ((xy[:, None] - xy[None]) ** 2).sum(-1) <= BIO.neighbor_radius ** 2
    near &= alive[:, None] & alive[None] & ~torch.eye(len(alive), dtype=torch.bool)
    want = (near & (f2 != 0)[None]).sum(1)
    live = alive & (span_mask.candidate_counts(bounds) > 0)
    assert torch.equal(m[live, 7].to(torch.int64), want[live]) and int(want.sum()) > 0
