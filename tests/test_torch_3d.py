"""PyTorch port in 3D boxes: the 9-run stencil bounds, the 3D forms of the
kernels' plain versions (B4's 3D pack, B6, and the span-mask B2 seed, B1
masked substep and B3 compaction; the kernels themselves are held to them in
test_torch_cuda.py), the Stokes step's clamp to a 3D box and whole 3D
steps, vs the JAX package on identical inputs: its 3D candidate windows, its
Pallas kernels with 9 runs and the 16-lane bio pack in interpret mode, its
``stokes_integrate`` and its 3D engine.

Tolerances are those of the 2D tests: bounds, counts, degrees, bond sets and
integer state are exact, and so are the force and moment sums against the
Pallas kernels in interpret mode, on the uniform and the general law: the
port adds them in the kernels' grouping (``neighbors.grouped_sum``: per
chunk and run, the run's lanes in 32-lane windows of the sorted rows), and
``test_torch_contact.tpu_grouping_sum`` gives the same bits from the port's
pair terms. Positions after a step against the JAX engine's XLA path to
1e-4 um (that path's pair law and window sums, which the port does not
follow).
The contact colonies have degrees up to 10: K = 8 truncates some rows, K =
16 none (the Pallas kernels in interpret mode take seconds per unit of K).
The whole-step reference is the JAX engine's XLA path (``use_pallas=False``),
against the port's engine on that path's law, the general one,
which ``tests/test_pallas.py`` holds equal to its 3D Pallas path: the Pallas
path in interpret mode took 133 s on a CPU for the two steps of
``test_spheroid_steps_match_jax_engine`` (132 s of it in the first step,
which builds the 9-run kernels at K = 8 and again at the grown K), past this
file's budget of about a minute. The kernels themselves are held to the
Pallas kernels above.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipsc_abm_tpu.engine import HipscEngine as JaxEngine
from hipsc_abm_tpu.models.params import (
    BiologyParams, DiffusionParams, ExperimentalParams, GeneralParams)
from hipsc_abm_tpu.ops import jkr as jjkr
from hipsc_abm_tpu.ops import neighbors as jnbr
from hipsc_abm_tpu.ops.integrate import stokes_integrate as jstokes
from hipsc_abm_tpu.ops.pallas_bio import bio_reduce_pallas
from hipsc_abm_tpu.ops.pallas_contact import (
    compact_mask_bonds,
    contact_substep_ids_to_mask,
    contact_substep_masked,
    contact_substep_pallas,
)
from hipsc_abm_tpu_torch import convert
from hipsc_abm_tpu_torch.engine import HipscEngine
from hipsc_abm_tpu_torch.ops import bio_moments as tbio
from hipsc_abm_tpu_torch.ops import contact as tcontact
from hipsc_abm_tpu_torch.ops import jkr as tjkr
from hipsc_abm_tpu_torch.ops import neighbors as tnbr
from hipsc_abm_tpu_torch.ops import span_mask
from test_torch_contact import assert_live_starts, tpu_grouping_sum
from hipsc_abm_tpu_torch.ops.integrate import stokes_integrate as tstokes
from test_torch_span_mask import assert_self_is_row
from test_torch_step import _assert_same_colony

BIO = BiologyParams()
CELL = BIO.jkr_radius + 2 * BIO.jkr_break_band + 2.0
LAW = dict(radius=BIO.jkr_radius, adhesion_const=BIO.adhesion_const,
           poisson=BIO.poisson, youngs=BIO.youngs, break_d=BIO.jkr_break_d)


def _sets(rows):
    return [frozenset(r[r >= 0].tolist()) for r in np.asarray(rows).astype(np.int64)]


def _specs(box, radius, run_cap=64):
    jspec = jnbr.GridSpec.from_box(box, radius, run_cap=run_cap)
    return jspec, tnbr.GridSpec(**dataclasses.asdict(jspec))


def _span_plan(jspec, sorted_flat, C, block=128, chunk=128):
    _, _, span_needed, _ = jnbr.block_span_plan(jspec, sorted_flat, block, span=C,
                                                capacity=C, chunk=C)
    span = min(-(-int(span_needed) // 128) * 128, C)
    starts, needs, _, _ = jnbr.block_span_plan(jspec, sorted_flat, block, span=span,
                                               capacity=C, chunk=chunk)
    return dict(block=block, span=span, chunk=chunk), starts, needs


def _grouping(bounds, plan, starts, C):
    """The port's sum order of sorted rows under the plan, its span starts
    checked against the JAX plan's (whose last row is padding)."""
    grouping = tnbr.grouping_of_bounds(bounds, plan["span"], C, plan["chunk"])
    assert_live_starts(grouping, starts, bounds)
    return grouping


@pytest.mark.parametrize("box", [(120.0, 120.0, 120.0), (150.0, 150.0, 150.0)])
def test_nine_run_bounds_match_jax_windows(box):
    """Each sorted row's walk over its 9 run bounds visits exactly the
    sorted positions of the JAX package's 3D candidate window, in order."""
    rs = np.random.default_rng(0)
    C, n = 512, 460
    locs = np.zeros((C, 3), np.float32)
    locs[:n] = rs.random((n, 3)).astype(np.float32) * np.asarray(box, np.float32)
    locs[:5] = locs[5]  # a stacked bin
    locs[6:9, 2] = box[2]  # agents on the top face
    alive = np.zeros(C, bool)
    alive[:n] = True
    alive[rs.choice(n, 30, replace=False)] = False
    ids = rs.permutation(C).astype(np.int32)
    jspec, tspec = _specs(box, 15.0)
    assert len(tspec.flat_run_offsets) == 9 and tspec.flat_run_offsets == jspec.flat_run_offsets
    jg = jnbr.build_grid(jspec, jnp.asarray(locs), jnp.asarray(ids), jnp.asarray(alive))
    jpos, jvalid, jmax = jnbr.window_from_grid(jspec, jg)
    assert int(jmax) <= jspec.run_cap
    tg = tnbr.build_grid(tspec, torch.from_numpy(locs), torch.from_numpy(ids),
                         torch.from_numpy(alive))
    np.testing.assert_array_equal(tg.order.numpy(), np.asarray(jg.order))
    bounds = tnbr.run_bounds(tspec, tg.sorted_flat)
    assert bounds.shape == (C, 18) and bounds.dtype == torch.int32
    assert tnbr.sorted_run_bounds_from_flat(tspec, tg.sorted_flat).shape == (C, 18)
    bpos, bvalid = tnbr.bounds_window(bounds)
    jpos, jvalid = np.asarray(jpos), np.asarray(jvalid)
    order = tg.order.numpy()
    walked = 0
    for row in range(C):
        slot = order[row]
        got = bpos[row][bvalid[row]].tolist()
        want = jpos[slot][jvalid[slot]].tolist() if alive[slot] else []
        assert got == want, row
        walked += len(got)
    assert walked > 9 * n


def _bio_setup(seed=0, C=384, n=360, box=(90.0, 90.0, 75.0)):
    rs = np.random.default_rng(seed)
    loc0 = np.zeros((C, 3), np.float32)
    loc0[:n] = rs.random((n, 3)).astype(np.float32) * np.asarray(box, np.float32)
    alive = np.zeros(C, bool)
    alive[:n] = True
    ids = rs.permutation(C).astype(np.int32)
    jspec, tspec = _specs(box, 15.0, run_cap=48)
    g = jnbr.build_grid(jspec, jnp.asarray(loc0), jnp.asarray(ids), jnp.asarray(alive))
    o = np.asarray(g.order)
    loc0, ids, alive = loc0[o], ids[o], alive[o]
    curr = loc0 + rs.normal(0.0, 0.7, (C, 3)).astype(np.float32)
    alive_now = alive.copy()
    alive_now[rs.choice(n, 15, replace=False)] = False
    # daughters: slots dead at the build (sorted last), alive now
    alive_now[n + rs.choice(C - n, 6, replace=False)] = True
    feats = [rs.integers(0, 3, C).astype(np.int32) for _ in range(3)]
    feats[2][rs.random(C) < 0.6] = 0
    return dict(loc0=loc0, curr=curr, alive_now=alive_now, f=feats,
                flat=np.asarray(g.sorted_flat), jspec=jspec, tspec=tspec)


@pytest.mark.parametrize("mode", ["count", "pathway", "motility", "full"])
def test_bio_plain_3d_matches_pallas_interpret(mode):
    """The port's moments (build-time float4 positions, current liveness,
    int32 feature columns) against ``bio_reduce_pallas`` with its 16-lane
    pack (9 runs), every mode; the z displacement lanes 6 and 10 included,
    with agents killed since the build and daughters born after it."""
    s = _bio_setup()
    jspec, tspec = s["jspec"], s["tspec"]
    C = len(s["flat"])
    feats = [f.astype(np.float32) for f in s["f"]]
    flat_lane = np.where(s["alive_now"], s["flat"].astype(np.float32),
                         np.float32(jnbr.dead_sentinel(jspec)))
    jpack = np.concatenate([s["loc0"], s["curr"], np.stack(feats, 1), flat_lane[:, None],
                            np.zeros((C, 6), np.float32)], axis=1)
    plan, starts, needs = _span_plan(jspec, jnp.asarray(s["flat"]), C)
    want = np.asarray(bio_reduce_pallas(
        jnp.asarray(jpack), starts, needs, ny=jspec.ny, nz=jspec.nz,
        num_bins=jspec.num_bins, radius=15.0, mode=mode, interpret=True, **plan))
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    pos0 = tbio.positions(t(s["loc0"]))
    assert pos0.shape == (C, 4)
    bounds = tnbr.run_bounds(tspec, t(s["flat"].astype(np.int64)))
    got = tbio.bio_moments_cuda(pos0, t(s["alive_now"]), bounds, t(s["curr"]),
                                *(t(f) for f in s["f"]), radius=15.0, mode=mode,
                                grouping=_grouping(bounds, plan, starts, C)).numpy()
    assert got[:, 0].sum() > C
    np.testing.assert_array_equal(got, want)
    if mode in ("motility", "full"):
        assert np.abs(got[:, [6, 10]]).max() > 0.1  # the z sums are live


def _contact_colony(K, seed=0, C=128, n=118, box=(48.0, 48.0, 48.0), general=False):
    """A dense 3D colony with scrambled ids, a few dead slots, bonds from one
    JAX substep at earlier positions, and positions one substep later;
    ``general``: radii drawn between the smallest and largest (the general
    law's inputs)."""
    rs = np.random.default_rng(seed)
    locs = np.zeros((C, 3), np.float32)
    locs[:n] = rs.random((n, 3)).astype(np.float32) * np.asarray(box, np.float32)
    alive = np.zeros(C, bool)
    alive[:n] = True
    alive[rs.choice(n, 8, replace=False)] = False
    ids = rs.permutation(4 * C)[:C].astype(np.int32)
    radii = np.full(C, BIO.max_radius, np.float32)
    if general:
        radii = rs.uniform(BIO.min_radius, BIO.max_radius, C).astype(np.float32)
    jspec, tspec = _specs(box, CELL)
    earlier = locs.copy()
    earlier[:n] -= rs.normal(0.0, 1.2, (n, 3)).astype(np.float32)
    g0, pos0, valid0, _ = jnbr.sorted_window(jspec, jnp.asarray(earlier), jnp.asarray(ids),
                                             jnp.asarray(alive))
    packed0 = jjkr.pack_physics(jnp.asarray(earlier), jnp.asarray(radii), jnp.asarray(ids),
                                jnp.asarray(alive))
    _, bonds, _ = jjkr.jkr_substep(jjkr.BondState.empty(C, K), packed0, g0.order, pos0,
                                   valid0, **LAW)
    partner_ids = np.where(np.asarray(bonds.mask), np.asarray(bonds.partners), -1)
    moved = locs.copy()
    moved[:n] += rs.normal(0.0, 0.4, (n, 3)).astype(np.float32)
    return locs, moved, radii, ids, alive, partner_ids.astype(np.int32), jspec, tspec


def _jax_sorted(jspec, locs, radii, ids, alive):
    jgrid = jnbr.build_grid(jspec, jnp.asarray(locs), jnp.asarray(ids), jnp.asarray(alive))
    order = np.asarray(jgrid.order)

    def srt_pack(xyz):
        packed = jjkr.pack_physics(jnp.asarray(xyz), jnp.asarray(radii), jnp.asarray(ids),
                                   jnp.asarray(alive))
        return packed[order].at[:, 6].set(jgrid.sorted_flat.astype(jnp.float32))

    return jgrid, order, srt_pack


def _port_sorted(tspec, locs, radii, ids, alive):
    grid = tnbr.build_grid(tspec, torch.from_numpy(locs), torch.from_numpy(ids),
                           torch.from_numpy(alive))
    o = grid.order
    bounds = tnbr.run_bounds(tspec, grid.sorted_flat)

    def xyzr(xyz):
        return tjkr.pack_physics(torch.from_numpy(xyz)[o], torch.from_numpy(radii)[o])

    rows = (torch.from_numpy(ids)[o].contiguous(), torch.from_numpy(alive)[o].contiguous(),
            bounds)
    return o, xyzr, rows


def _assert_forces(f, d, fd):
    want = np.asarray(fd[:, :3])
    assert np.abs(want).max() > 0 and np.abs(want[:, 2]).max() > 0
    np.testing.assert_array_equal(f.numpy(), want)
    np.testing.assert_array_equal(d.numpy(), np.asarray(fd[:, 3]).astype(np.int32))


@pytest.mark.parametrize("law", ["uniform", "general"])
@pytest.mark.parametrize("K", [8, 16])
def test_contact_plain_3d_matches_pallas_interpret(K, law):
    uniform = BIO.max_radius if law == "uniform" else None
    locs, _, radii, ids, alive, partner_ids, jspec, tspec = _contact_colony(
        K, general=uniform is None)
    C = locs.shape[0]
    jgrid, order, srt_pack = _jax_sorted(jspec, locs, radii, ids, alive)
    plan, starts, needs = _span_plan(jspec, jgrid.sorted_flat, C)
    fd, jbonds = contact_substep_pallas(
        srt_pack(locs), jnp.asarray(partner_ids.astype(np.float32))[order], starts, needs,
        run_offs=jspec.flat_run_offsets, uniform_radius=uniform, interpret=True,
        **plan, **LAW)
    o, xyzr, rows = _port_sorted(tspec, locs, radii, ids, alive)
    np.testing.assert_array_equal(o.numpy(), order)
    partners_in = torch.from_numpy(partner_ids)[o].contiguous()
    f, d, partners = tcontact.contact_substep_cuda(
        xyzr(locs), *rows, partners_in, uniform_radius=uniform,
        grouping=_grouping(rows[2], plan, starts, C), **LAW)
    _assert_forces(f, d, fd)
    # the pair terms, summed by the test's own reading of the kernel
    pos, valid = tnbr.bounds_window(rows[2])
    bonded = tjkr._is_bonded(partners_in, rows[0][pos])
    terms, keep = tjkr.pair_terms(bonded, xyzr(locs), rows[0], rows[1], None, pos, valid,
                                  uniform_radius=uniform, **LAW)
    np.testing.assert_array_equal(
        tpu_grouping_sum(terms, keep, pos, 9, starts, plan["block"], plan["chunk"]),
        np.asarray(fd[:, :3]))
    # 3D packing: more than 8 contacts at the largest radius
    assert int(d.sum()) > C and (uniform is None or int(d.max()) > 8)
    within = (d <= K).numpy()
    got, want = _sets(partners.numpy()), _sets(jbonds)
    assert [g for g, w in zip(got, within) if w] == [g for g, w in zip(want, within) if w]


@pytest.mark.parametrize("law", ["uniform", "general"])
@pytest.mark.parametrize("K", [8, 16])
def test_span_mask_plain_3d_matches_pallas_interpret(K, law):
    """seed -> masked (positions moved, window frozen) -> compact over nine
    runs, against the three Pallas kernels on the same sorted rows."""
    uniform = BIO.max_radius if law == "uniform" else None
    locs, moved, radii, ids, alive, partner_ids, jspec, tspec = _contact_colony(
        K, seed=1, general=uniform is None)
    C = locs.shape[0]
    jgrid, order, srt_pack = _jax_sorted(jspec, locs, radii, ids, alive)
    plan, starts, needs = _span_plan(jspec, jgrid.sorted_flat, C)
    pkw = dict(run_offs=jspec.flat_run_offsets, uniform_radius=uniform,
               interpret=True, **plan, **LAW)
    fd1, m1 = contact_substep_ids_to_mask(
        srt_pack(locs), jnp.asarray(partner_ids.astype(np.float32))[order], starts, needs,
        **pkw)
    fd2, m2 = contact_substep_masked(srt_pack(moved), m1, starts, needs, **pkw)
    jbonds = compact_mask_bonds(srt_pack(moved), m2, starts, needs,
                                run_offs=jspec.flat_run_offsets, bond_cap=K,
                                interpret=True, **plan)

    o, xyzr, rows = _port_sorted(tspec, locs, radii, ids, alive)
    grouping = _grouping(rows[2], plan, starts, C)
    f1, d1, mask = span_mask.contact_seed_cuda(
        xyzr(locs), *rows, torch.from_numpy(partner_ids)[o].contiguous(),
        uniform_radius=uniform, grouping=grouping, **LAW)
    W = span_mask.mask_words(rows[2])
    assert mask.shape == (W, C) and W >= 2  # nine runs: more than 32 candidates
    f2, d2, _ = span_mask.contact_masked_cuda(xyzr(moved), *rows, mask,
                                              uniform_radius=uniform, grouping=grouping,
                                              **LAW)
    bonds = span_mask.mask_compact_cuda(rows[0], rows[2], mask, K)
    _assert_forces(f1, d1, fd1)
    _assert_forces(f2, d2, fd2)
    within = (d2 <= K).numpy()
    got, want = _sets(bonds.numpy()), _sets(jbonds)
    assert [g for g, w in zip(got, within) if w] == [g for g, w in zip(want, within) if w]
    assert all(len(g) == K for g, w in zip(got, within) if not w)
    # the id-list substep at the moved positions, from the compacted bonds of
    # the seed's mask, keeps the same sets as the masked substep
    _, _, seed_mask = span_mask.contact_seed_cuda(
        xyzr(locs), *rows, torch.from_numpy(partner_ids)[o].contiguous(),
        uniform_radius=uniform, **LAW)
    seed_ids = span_mask.mask_compact_cuda(rows[0], rows[2], seed_mask, 64)
    _, d3, p3 = tcontact.contact_substep_cuda(xyzr(moved), *rows, seed_ids,
                                              uniform_radius=uniform, **LAW)
    np.testing.assert_array_equal(d3.numpy(), d2.numpy())
    assert _sets(p3.numpy()) == _sets(span_mask.mask_compact_cuda(rows[0], rows[2], mask,
                                                                  64).numpy())


def test_stokes_integrate_clamps_to_the_3d_box():
    """The Stokes step in a 3D box: displacements of up to +-60 um push
    agents past every face, z included; port against JAX, dead rows kept."""
    rs = np.random.default_rng(4)
    C, box = 256, np.asarray([100.0, 90.0, 80.0], np.float32)
    locs = (rs.random((C, 3)) * box).astype(np.float32)
    radii = np.full(C, BIO.max_radius, np.float32)
    alive = rs.random(C) > 0.1
    friction = 6.0 * np.pi * BIO.stokes * BIO.max_radius / 1e6
    forces = (rs.uniform(-60.0, 60.0, (C, 3)) / 1e6 / BIO.move_dt * friction).astype(np.float32)
    motility = (0.1 * forces[::-1]).astype(np.float32)
    # compiled, as the JAX engine runs it (the step's dt a traced value)
    want = np.asarray(jax.jit(jstokes, static_argnums=5)(
        *(jnp.asarray(a) for a in (locs, radii, forces, motility, alive)), BIO.stokes,
        jnp.asarray(box), jnp.float32(BIO.move_dt)))
    got = tstokes(*(torch.from_numpy(np.ascontiguousarray(a))
                    for a in (locs, radii, forces, motility, alive)),
                  BIO.stokes, torch.from_numpy(box), float(np.float32(BIO.move_dt))).numpy()
    np.testing.assert_array_equal(got, want)
    live = got[alive]
    assert (live[:, 2] == 0).any() and (live[:, 2] == box[2]).any()  # both z faces hit
    np.testing.assert_array_equal(got[~alive], locs[~alive])


def _spheroid(n, seed=0, squeeze=1.0):
    """The 3D spheroid example's configuration at n cells (10:1 GATA6), box
    and seeding ball scaled by the cube root of n / 3,300; ``squeeze`` < 1
    packs the ball tighter."""
    scale = (n / 3300.0) ** (1.0 / 3.0)
    box, radius = 600.0 * scale, 110.0 * scale * squeeze
    n_gata6 = n // 11
    gen = GeneralParams(num_to_start=n - n_gata6, end_step=5, size=(box, box, box))
    xp = ExperimentalParams(num_gata6=n_gata6, dox_step=2, guye_move=False)
    rng = np.random.default_rng(seed)
    direction = rng.normal(size=(n, 3))
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    r = radius * rng.random(n) ** (1.0 / 3.0)
    return gen, xp, (box / 2.0 + direction * r[:, None]).astype(np.float32)


def _general(teng):
    """The port's engine on the general pair law, the law of the JAX
    engine's XLA path."""
    teng.cfg = dataclasses.replace(teng.cfg, uniform_radius=None)
    return teng


@pytest.mark.parametrize("contact_path", ["id_list", "span_mask"])
def test_spheroid_steps_match_jax_engine(contact_path):
    """Two ``safe_step``s of the port's 3D engine against the JAX engine's
    3D step from the same seeded ball. The ball is packed 1/0.8^3 = 2x
    tighter than the example's, so the contact degree passes the initial
    bond capacity of 8 (13 in the first step) and the bond-cap growth and
    its re-execution run in 3D; cells divide in both steps (the 3D division
    displacement)."""
    gen, xp, ball = _spheroid(440, squeeze=0.8)
    jeng = JaxEngine(gen, xp, use_pallas=False)
    teng = _general(HipscEngine(convert.params_from_jax(gen), convert.params_from_jax(xp),
                                device="cpu", contact_path=contact_path))
    assert not teng.cfg.two_d and teng.cfg.capacity == jeng.cfg.capacity
    js, ts = jeng.init_state(seed=0, locations=ball), teng.init_state(seed=0, locations=ball)
    k0 = ts.bonds.partners.shape[1]
    for step in range(2):
        js, jinfo = jeng.safe_step(js)
        ts, tinfo = teng.safe_step(ts)
        assert tinfo.jkr_max_degree == int(jinfo.jkr_max_degree)
        assert tinfo.num_added == int(jinfo.num_added) > 0
        assert tinfo.nbr_max_in_bin > 0
        _assert_same_colony(js, ts, f"3D {contact_path} step {step}", atol=1e-4)
    assert ts.bonds.partners.shape[1] > k0 == 8
    loc = ts.arrays["locations"][ts.alive]
    assert float(loc[:, 2].max() - loc[:, 2].min()) > 20.0  # a ball, not a slab


def test_spheroid_step_with_diffusion_matches_jax_engine():
    """A 3D box with FGF4 release and diffusion: the lattice stays 2D and
    the deposit projects by (x, y), as in the JAX engine."""
    gen, xp, ball = _spheroid(330)
    diff = DiffusionParams(spat_res=20.0, diffuse_dt=6.0, diffuse_const=2.0,
                           max_concentration=2.0, degradation=0.1, release_amount=0.01)
    jeng = JaxEngine(gen, xp, diff=diff, enable_diffusion=True, use_pallas=False)
    teng = _general(HipscEngine(*(convert.params_from_jax(p) for p in (gen, xp)),
                                diff=convert.params_from_jax(diff), enable_diffusion=True,
                                device="cpu"))
    js, ts = jeng.init_state(seed=0, locations=ball), teng.init_state(seed=0, locations=ball)
    assert ts.gradients["fgf4_values"].dim() == 2
    js, _ = jeng.safe_step(js)
    ts, _ = teng.safe_step(ts)
    _assert_same_colony(js, ts, "3D with diffusion", atol=1e-4)
    assert float(ts.gradients["fgf4_values"].max()) > 0


def test_spheroid_self_is_the_only_candidate_with_the_row_id():
    """The 3D spheroid example's configuration at 1,100 cells after one
    ``safe_step``: over nine runs, the only candidate of a live row with the
    row's id is the row itself (``test_torch_span_mask.assert_self_is_row``)."""
    gen, xp, ball = _spheroid(1100)
    eng = HipscEngine(convert.params_from_jax(gen), convert.params_from_jax(xp),
                      device="cpu", contact_path="span_mask")
    state, _ = eng.safe_step(eng.init_state(seed=0, locations=ball))
    assert not eng.cfg.two_d and int(state.alive.sum()) > 1100
    assert assert_self_is_row(eng, state) > 0
