"""PyTorch port on the card: each CUDA kernel against its plain version (the
2D and 3D forms of the run-bounds kernels, and every mode of the window
probes), and one engine step on the card against the same step on the CPU,
in 2D and 3D.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU. The file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: the contact kernels' scalar-radius pair law rounds differently
from the plain versions' general law, and on the general law the card's
``powf`` from the CPU's ``pow`` (forces rtol 1e-5, atol 1e-6 x max|F|);
moment counts, bond sets, degrees and span-mask words are exact; FTCS keeps the plain version's
association without FMA contraction and is held bit-equal;
the probes sum their lanes in another order than the plain versions (P1
rtol 1e-5, atol 1e-5; P2, with the card's rsqrtf against torch.rsqrt, rtol
1e-4, atol 1e-4 x max|out|). The deposit's fixed-order sum, the pathway's
normal draw and an ensemble's replicates (against their solo runs) are
held bit-equal.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from hipsc_abm_tpu_torch import convert, kernels
from hipsc_abm_tpu_torch.engine import HipscEngine
from hipsc_abm_tpu_torch.ops import bio_moments, contact, diffusion, ftcs, span_mask
from hipsc_abm_tpu_torch.ops import neighbors as nbr
from hipsc_abm_tpu_torch.ops.jkr import pack_physics
from hipsc_abm_tpu_torch.params import (
    BiologyParams, DiffusionParams, ExperimentalParams, GeneralParams)
from hipsc_abm_tpu_torch.tools import dynslice_probe, dynslice_probe2

pytestmark = pytest.mark.cuda
BIO = BiologyParams()
LAW = dict(radius=BIO.jkr_radius, adhesion_const=BIO.adhesion_const,
           poisson=BIO.poisson, youngs=BIO.youngs, break_d=BIO.jkr_break_d)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run on the card)")
    return torch.device("cuda")


def _radii(C, seed, unequal):
    """max_radius everywhere, or (``unequal``) radii drawn uniform in
    [min_radius, max_radius], as growth spreads them."""
    if not unequal:
        return torch.full((C,), BIO.max_radius)
    rs = np.random.default_rng(seed + 100)
    return torch.from_numpy(rs.uniform(BIO.min_radius, BIO.max_radius, C).astype(np.float32))


def _contact_inputs(K, seed=0, C=2048, n=1900, box=(420.0, 420.0, 0.0), skin=2.0,
                    unequal=False):
    """Sorted contact inputs with bonds from one plain substep at earlier
    positions (some bonds now beyond the search radius, some breaking). The
    engine's default Verlet skin (14 um) widens the bins so that rows have
    more than 32 candidates and the span masks more than one word.
    ``unequal`` draws the radii (``_radii``)."""
    rs = np.random.default_rng(seed)
    dims = 2 if box[2] == 0 else 3
    locs = np.zeros((C, 3), np.float32)
    locs[:n, :dims] = rs.random((n, dims)).astype(np.float32) * np.float32(box[0])
    alive = np.zeros(C, bool)
    alive[:n] = True
    alive[rs.choice(n, 40, replace=False)] = False
    ids = rs.permutation(10 * C)[:C].astype(np.int32)
    spec = nbr.GridSpec.from_box(box, BIO.jkr_radius + 2 * BIO.jkr_break_band + skin, 0)
    radii = _radii(C, seed, unequal)

    def sorted_args(xy, partners):
        t_loc = torch.from_numpy(xy)
        g = nbr.build_grid(spec, t_loc, torch.from_numpy(ids), torch.from_numpy(alive))
        o = g.order
        return g, [pack_physics(t_loc[o], radii[o]), torch.from_numpy(ids)[o].contiguous(),
                   torch.from_numpy(alive)[o].contiguous(),
                   nbr.run_bounds(spec, g.sorted_flat), partners[o].contiguous()]

    earlier = locs.copy()
    earlier[:n, :dims] -= rs.normal(0.0, 1.2, (n, dims)).astype(np.float32)
    g0, args0 = sorted_args(earlier, torch.full((C, K), -1, dtype=torch.int32))
    _, _, p0 = contact.contact_substep_plain(*args0, **LAW)
    partners = torch.empty_like(p0)
    partners[g0.order] = p0
    return sorted_args(locs, partners)[1]


def _bond_shells(args):
    """Bonded partners of live rows by distance: within the search radius,
    in the break shell (radius < dist <= radius + jkr_break_band), beyond
    it. The kernel tests the pair law before bond membership, so both outer
    classes must be present for the tests to hold it to the plain order."""
    xyzr, ids, alive, _, partners = (a.cpu() for a in args)
    slot = torch.full((int(ids.max()) + 1,), -1, dtype=torch.int64)
    slot[ids.long()] = torch.arange(ids.shape[0])
    bonded = (partners >= 0) & alive[:, None]
    rows, k = torch.nonzero(bonded, as_tuple=True)
    other = slot[partners[rows, k].long()]
    dist = torch.linalg.norm(xyzr[rows, :3] - xyzr[other, :3], dim=1)
    r, band = BIO.jkr_radius, BIO.jkr_break_band
    return (int((dist <= r).sum()), int(((dist > r) & (dist <= r + band)).sum()),
            int((dist > r + band).sum()))


@pytest.mark.parametrize("K", [8, 40])
@pytest.mark.parametrize("uniform", [None, BIO.max_radius])
def test_contact_kernel_matches_plain(dev, K, uniform):
    args = [a.to(dev) for a in _contact_inputs(K)]
    _, shell, beyond = _bond_shells(args)
    assert shell > 0 and beyond > 0
    before = kernels.launch_counts["contact_substep"]
    fk, dk, pk = contact.contact_substep_cuda(*args, uniform_radius=uniform, **LAW)
    fp, dp, pp = contact.contact_substep_plain(*args, uniform_radius=uniform, **LAW)
    torch.cuda.synchronize()
    assert kernels.launch_counts["contact_substep"] == before + 1
    scale = float(fp.abs().max())
    assert scale > 0 and int((pp >= 0).sum()) > args[0].shape[0]
    torch.testing.assert_close(fk, fp, rtol=1e-5, atol=1e-6 * scale)
    assert torch.equal(dk, dp)
    for a, b in zip(pk.cpu().numpy(), pp.cpu().numpy()):
        assert set(a[a >= 0].tolist()) == set(b[b >= 0].tolist())


def test_contact_kernel_rejects_a_partner_block_past_shared_memory(dev):
    limit = kernels.device_limits()["smem_optin"]
    K = limit // (2 * 4 * contact.ROWS_PER_CTA) + 1
    assert contact.contact_layout(K)["smem_bytes"] > limit
    args = [a.to(dev) for a in _contact_inputs(8, C=256, n=200, box=(150.0, 150.0, 0.0))]
    args[4] = torch.full((256, K), -1, dtype=torch.int32, device=dev)
    before = kernels.launch_counts["contact_substep"]
    with pytest.raises(ValueError, match="shared memory"):
        contact.contact_substep_cuda(*args, **LAW)
    assert kernels.launch_counts["contact_substep"] == before


def _moved(args, seed=5):
    """The same sorted rows one substep later (the window stays frozen)."""
    rs = np.random.default_rng(seed)
    xyzr = args[0].clone()
    dims = 2 if bool((xyzr[:, 2] == 0).all()) else 3
    noise = rs.normal(0.0, 0.4, (xyzr.shape[0], dims)).astype(np.float32)
    xyzr[:, :dims] += torch.from_numpy(noise).to(xyzr.device)
    return xyzr


def _check_contact(f_k, d_k, f_p, d_p):
    scale = float(f_p.abs().max())
    assert scale > 0
    torch.testing.assert_close(f_k, f_p, rtol=1e-5, atol=1e-6 * scale)
    assert torch.equal(d_k, d_p)


@pytest.mark.parametrize("K", [8, 24, 40])
@pytest.mark.parametrize("uniform", [None, BIO.max_radius])
def test_contact_seed_kernel_matches_plain(dev, K, uniform):
    args = [a.to(dev) for a in _contact_inputs(K, skin=14.0)]
    law = dict(uniform_radius=uniform, **LAW)
    before = kernels.launch_counts["contact_seed"]
    f_k, d_k, m_k = span_mask.contact_seed_cuda(*args, **law)
    f_p, d_p, m_p = span_mask.contact_seed_plain(*args, **law)
    torch.cuda.synchronize()
    assert kernels.launch_counts["contact_seed"] == before + 1
    _check_contact(f_k, d_k, f_p, d_p)
    assert m_k.shape == m_p.shape and m_p.shape[0] >= 2 and torch.equal(m_k, m_p)
    assert int(d_p.sum()) > args[0].shape[0]


@pytest.mark.parametrize("K", [8, 24, 40])
def test_contact_masked_kernel_matches_plain(dev, K):
    args = [a.to(dev) for a in _contact_inputs(K, skin=14.0)]
    law = dict(uniform_radius=BIO.max_radius, **LAW)
    _, _, mask = span_mask.contact_seed_plain(*args, **law)
    rows = (_moved(args), *args[1:4])
    m_k, m_p = mask.clone(), mask.clone()
    before = kernels.launch_counts["contact_masked"]
    f_k, d_k, out = span_mask.contact_masked_cuda(*rows, m_k, **law)
    f_p, d_p, _ = span_mask.contact_masked_plain(*rows, m_p, **law)
    torch.cuda.synchronize()
    assert kernels.launch_counts["contact_masked"] == before + 1
    assert out is m_k  # in place
    _check_contact(f_k, d_k, f_p, d_p)
    assert torch.equal(m_k, m_p) and not torch.equal(m_k, mask)


def _pair_rows(gaps, bonded, dims, K=24, radii=None):
    """Seed inputs, sorted, for pairs far apart: pair k at distance
    ``gaps[k]`` along a random direction, bonded where ``bonded[k]``, and 64
    dead slots after them; ``radii`` (C,) float32 or max_radius for all."""
    n = len(gaps)
    side = int(math.ceil(n ** (1.0 / dims)))
    box = (40.0 * (side + 1),) * dims + (0.0,) * (3 - dims)
    rs = np.random.default_rng(11)
    C = 2 * n + 64
    locs = np.zeros((C, 3), np.float32)
    for k in range(n):
        cell = np.unravel_index(k, (side,) * dims)
        base = np.zeros(3)
        base[:dims] = 40.0 * (np.asarray(cell) + 1)
        u = np.zeros(3)
        u[:dims] = rs.normal(size=dims)
        locs[2 * k] = base
        locs[2 * k + 1] = base + gaps[k] * u / np.linalg.norm(u)
    alive = np.zeros(C, bool)
    alive[:2 * n] = True
    ids = rs.permutation(10 * C)[:C].astype(np.int32)
    partners = np.full((C, K), -1, np.int32)
    first = 2 * np.flatnonzero(bonded)
    partners[first, 0], partners[first + 1, 0] = ids[first + 1], ids[first]
    spec = nbr.GridSpec.from_box(box, BIO.jkr_radius + 2 * BIO.jkr_break_band + 2.0, 0)
    t_loc = torch.from_numpy(locs)
    g = nbr.build_grid(spec, t_loc, torch.from_numpy(ids), torch.from_numpy(alive))
    o = g.order
    radii = torch.full((C,), BIO.max_radius) if radii is None else torch.from_numpy(radii)
    return [pack_physics(t_loc[o], radii[o]),
            torch.from_numpy(ids)[o].contiguous(), torch.from_numpy(alive)[o].contiguous(),
            nbr.run_bounds(spec, g.sorted_flat), torch.from_numpy(partners)[o].contiguous()]


def _seed_against_plain(dev, args):
    """The seed kernel against its plain version, masks word for word;
    returns the plain degrees."""
    law = dict(uniform_radius=BIO.max_radius, **LAW)
    args = [a.to(dev) for a in args]
    f_k, d_k, m_k = span_mask.contact_seed_cuda(*args, **law)
    f_p, d_p, m_p = span_mask.contact_seed_plain(*args, **law)
    torch.cuda.synchronize()
    _check_contact(f_k, d_k, f_p, d_p)
    assert torch.equal(m_k, m_p)
    return d_p


@pytest.mark.parametrize("dims", [2, 3])
def test_contact_seed_kernel_at_the_break_distance(dev, dims):
    """Bonded pairs from just inside to just past the break distance, beyond
    the search radius: the seed's break test decides each, and only the
    survivors reach its membership scan. Offsets within 1e-4 um of the
    break distance are left out: there the kernel's uniform-radius law and
    the plain general law may round apart."""
    law_args = contact.pair_law_args(uniform_radius=BIO.max_radius, **LAW)
    reach = law_args[3] - law_args[1] / law_args[4]
    assert reach - 4e-3 > BIO.jkr_radius
    off = np.linspace(-4e-3, 4e-3, 240)
    off = off[np.abs(off) > 1e-4]
    assert (off > 0).sum() > 10 and (off < 0).sum() > 10
    d_p = _seed_against_plain(dev, _pair_rows(reach + off, np.ones(len(off), bool), dims))
    assert int(d_p.sum()) == 2 * int((off < 0).sum())


@pytest.mark.parametrize("dims", [2, 3])
def test_contact_seed_kernel_keeps_a_bond_beyond_the_search_radius(dev, dims):
    """The four pairs of ``test_torch_span_mask``'s bonded-pair test: bonded
    beyond the search radius inside the break distance (kept only through
    the kernel's membership scan), the same unbonded (dropped), bonded
    beyond the break distance (breaks), unbonded within the radius (kept)."""
    r, band = BIO.jkr_radius, BIO.jkr_break_band
    gaps = (r + 0.6 * band, r + 0.6 * band, r + 1.5 * band, 0.9 * r)
    args = _pair_rows(gaps, np.array([True, False, True, False]), dims)
    d_p = _seed_against_plain(dev, args)
    assert int(d_p.sum()) == 4 and int(d_p.max()) == 1


# ---------------------------------------------------------------------------
# the general-radius pair law (growth on: uniform_radius=None, unequal radii)
# ---------------------------------------------------------------------------

GENERAL = dict(uniform_radius=None, **LAW)


def _sets_equal(a, b):
    return all(set(x[x >= 0].tolist()) == set(y[y >= 0].tolist())
               for x, y in zip(a.cpu().numpy(), b.cpu().numpy()))


@pytest.mark.parametrize("K", [8, 40])
@pytest.mark.parametrize("dims", [2, 3])
def test_general_law_kernels_match_plain(dev, dims, K):
    """B6, then B2 (seed) -> B1 (masked, positions moved) -> B3 on unequal
    radii, each against its plain version: forces to the file's tolerance,
    degrees, partner sets, mask words and compacted ids exact."""
    box = (420.0, 420.0, 0.0) if dims == 2 else BOX3D
    C, n = (2048, 1900) if dims == 2 else (768, 700)
    args = [a.to(dev) for a in _contact_inputs(K, C=C, n=n, box=box, skin=14.0,
                                               unequal=True)]
    assert float(args[0][:, 3].max() - args[0][:, 3].min()) > 1.0
    _, shell, _ = _bond_shells(args)
    assert shell > 0
    suffix = "" if dims == 2 else "_3d"
    before = dict(kernels.launch_counts)
    fk, dk, pk = contact.contact_substep_cuda(*args, **GENERAL)
    fp, dp, pp = contact.contact_substep_plain(*args, **GENERAL)
    torch.cuda.synchronize()
    _check_contact(fk, dk, fp, dp)
    assert _sets_equal(pk, pp) and int(dp.sum()) > n
    f_k, d_k, m_k = span_mask.contact_seed_cuda(*args, **GENERAL)
    f_p, d_p, m_p = span_mask.contact_seed_plain(*args, **GENERAL)
    torch.cuda.synchronize()
    _check_contact(f_k, d_k, f_p, d_p)
    assert torch.equal(m_k, m_p)
    rows = (_moved(args), *args[1:4])
    m_k, m_p = m_p.clone(), m_p.clone()
    f_k, d_k, _ = span_mask.contact_masked_cuda(*rows, m_k, **GENERAL)
    f_p, d_p, _ = span_mask.contact_masked_plain(*rows, m_p, **GENERAL)
    torch.cuda.synchronize()
    _check_contact(f_k, d_k, f_p, d_p)
    assert torch.equal(m_k, m_p)
    assert torch.equal(span_mask.mask_compact_cuda(args[1], args[3], m_p, K),
                       span_mask.mask_compact_plain(args[1], args[3], m_p, K))
    for name in ("contact_substep", "contact_seed", "contact_masked", "mask_compact"):
        key = name + suffix
        assert kernels.launch_counts[key] == before.get(key, 0) + 1, key


def _break_reach(ri, rj):
    """The distance at which a pair of radii ri, rj breaks (float64)."""
    e_hat = 1.0 / (2.0 * (1.0 - BIO.poisson ** 2) / BIO.youngs)
    scale_c = ((math.pi * BIO.adhesion_const) / e_hat) ** (2.0 / 3.0)
    r_hat = ri * rj / (1e6 * (ri + rj))
    return ri + rj - BIO.jkr_break_d * scale_c * r_hat ** (1.0 / 3.0) * 1e6


@pytest.mark.parametrize("dims", [2, 3])
def test_general_law_kernels_at_the_break_distance(dev, dims):
    """Bonded pairs of unequal radii from 4e-3 um inside to 4e-3 um past
    their own break distance (offsets within 1e-4 um left out: there the
    card's powf and the CPU's pow may round apart): B6, the seed (B2) and
    the masked substep (B1, from the seed's mask) against their plain
    versions, and only the pairs inside keep their bond."""
    off = np.linspace(-4e-3, 4e-3, 240)
    off = off[np.abs(off) > 1e-4]
    n = len(off)
    rs = np.random.default_rng(12)
    radii = np.full(2 * n + 64, BIO.max_radius, np.float32)
    radii[:2 * n] = rs.uniform(BIO.min_radius, BIO.max_radius, 2 * n).astype(np.float32)
    gaps = [_break_reach(float(radii[2 * k]), float(radii[2 * k + 1])) + off[k]
            for k in range(n)]
    args = [a.to(dev) for a in _pair_rows(np.asarray(gaps), np.ones(n, bool), dims,
                                          radii=radii)]
    want = 2 * int((off < 0).sum())
    fk, dk, pk = contact.contact_substep_cuda(*args, **GENERAL)
    fp, dp, pp = contact.contact_substep_plain(*args, **GENERAL)
    f_k, d_k, m_k = span_mask.contact_seed_cuda(*args, **GENERAL)
    f_p, d_p, m_p = span_mask.contact_seed_plain(*args, **GENERAL)
    torch.cuda.synchronize()
    for got, plain in (((fk, dk), (fp, dp)), ((f_k, d_k), (f_p, d_p))):
        _check_contact(*got, *plain)
        assert int(plain[1].sum()) == want
    assert _sets_equal(pk, pp) and torch.equal(m_k, m_p)
    m_k, m_p = m_p.clone(), m_p.clone()
    f_k, d_k, _ = span_mask.contact_masked_cuda(*args[:4], m_k, **GENERAL)
    f_p, d_p, _ = span_mask.contact_masked_plain(*args[:4], m_p, **GENERAL)
    torch.cuda.synchronize()
    _check_contact(f_k, d_k, f_p, d_p)
    assert torch.equal(m_k, m_p) and int(d_p.sum()) == want


@pytest.mark.parametrize("dims", [2, 3])
def test_diff_surround_moments_call_matches_plain(dev, dims):
    """With diff_surround on, the engine's fourth bio-moments call (motility
    mode, ``states`` as ``f2``, before the motility call): the kernel's
    lanes against the plain version on the recorded inputs, lane 7 (the
    differentiated-neighbour count diff_surround reads) exactly."""
    from hipsc_abm_tpu_torch.tools import record_bio_calls

    if dims == 2:
        gen = GeneralParams(num_to_start=2000, size=(300.0, 300.0, 0.0))
    else:
        gen = GeneralParams(num_to_start=2000, size=(120.0, 120.0, 120.0))
    eng = HipscEngine(gen, ExperimentalParams(num_gata6=200, dox_step=1), device=dev,
                      enable_growth=True, enable_stochastic=True, enable_diff_surround=True)
    state, _ = eng.safe_step(eng.init_state(seed=2))
    states = (torch.arange(state.capacity, device=dev) % 3 == 0).to(torch.int32)
    state = state._replace(arrays={**state.arrays, "states": states})
    calls = record_bio_calls(eng, state)
    assert [k["mode"] for _, k in calls] == ["count", "pathway", "motility", "motility"]
    a, k = calls[2]
    assert int(a[4].abs().sum()) == 0 and int(a[5].abs().sum()) == 0
    assert int(a[6].sum()) > 0
    got = bio_moments.bio_moments_cuda(*a, **k)
    want = bio_moments.bio_moments_plain(*a, **k)
    assert torch.equal(got[:, [0, 3, 7]], want[:, [0, 3, 7]]) and float(want[:, 7].sum()) > 0
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("K", [5, 8, 40])
def test_mask_compact_kernel_matches_plain(dev, K):
    """K = 5: rows of an odd width (a row's ids are not 16-byte aligned in
    the block's tile), and rows with more set bits than K (truncated to the
    first K)."""
    args = [a.to(dev) for a in _contact_inputs(K, skin=14.0)]
    _, degree, mask = span_mask.contact_seed_plain(*args, **LAW)
    before = kernels.launch_counts["mask_compact"]
    got = span_mask.mask_compact_cuda(args[1], args[3], mask, K)
    want = span_mask.mask_compact_plain(args[1], args[3], mask, K)
    torch.cuda.synchronize()
    assert kernels.launch_counts["mask_compact"] == before + 1
    assert torch.equal(got, want)  # same first-K walk order, entry by entry
    assert torch.equal((got >= 0).sum(dim=1, dtype=torch.int32), degree.clamp(max=K))
    assert K > 5 or int(degree.max()) > K


@pytest.mark.parametrize("K", [5, 97, 128])
@pytest.mark.parametrize("dims", [2, 3])
def test_mask_compact_kernel_edge_cases(dev, K, dims):
    """Rows past the last full block (C = 2045, not a multiple of the 128
    rows a block takes), rows dead at the build (empty runs: no mask word
    read) and dead since (all-zero words), rows with more set bits than K,
    and K whose output tile passes the 48 KB a block gets without opting in
    (97; 128, the engine's largest bond capacity, a 64 KB tile)."""
    box = (420.0, 420.0, 0.0) if dims == 2 else (120.0, 120.0, 120.0)
    args = [a.to(dev) for a in _contact_inputs(8, C=2045, n=1900, box=box, skin=14.0)]
    _, degree, mask = span_mask.contact_seed_plain(*args, **LAW)
    assert args[0].shape[0] % 128 != 0
    dead = ~args[2]
    assert bool(dead.any()) and bool((span_mask.candidate_counts(args[3])[dead] == 0).any())
    got = span_mask.mask_compact_cuda(args[1], args[3], mask, K)
    want = span_mask.mask_compact_plain(args[1], args[3], mask, K)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert not bool((got[dead] >= 0).any())
    assert K > 5 or int(degree.max()) > K


def test_mask_compact_kernel_rejects_a_bond_capacity_past_the_engine_cap(dev):
    from hipsc_abm_tpu_torch.engine import MAX_BOND_CAP

    args = [a.to(dev) for a in _contact_inputs(8, C=256, n=200, box=(150.0, 150.0, 0.0))]
    _, _, mask = span_mask.contact_seed_plain(*args, **LAW)
    K = MAX_BOND_CAP + 1
    before = kernels.launch_counts["mask_compact"]
    with pytest.raises(ValueError, match="bond capacity"):
        span_mask.mask_compact_cuda(args[1], args[3], mask, K)
    assert kernels.launch_counts["mask_compact"] == before


def test_contact_kernel_rejects_bad_operands(dev):
    args = [a.to(dev) for a in _contact_inputs(8, C=256, n=200, box=(150.0, 150.0, 0.0))]
    bad = list(args)
    bad[1] = bad[1].to(torch.int64)
    with pytest.raises(TypeError):
        contact.contact_substep_cuda(*bad, **LAW)
    bad = list(args)
    bad[3] = bad[3][:, :4]
    with pytest.raises(ValueError):
        contact.contact_substep_cuda(*bad, **LAW)


def _bio_inputs(dims, seed):
    """Sorted bio-moment inputs ``(pos0, alive, bounds, loc1, f0, f1, f2)``
    of a dense colony: 5% of the agents killed since the build, and
    daughters alive now in slots dead at the build (sorted last, empty
    runs)."""
    rs = np.random.default_rng(seed)
    C, n, box = ((4096, 3800, (520.0, 460.0, 0.0)) if dims == 2 else
                 (4096, 3900, (150.0, 140.0, 130.0)))
    loc = np.zeros((C, 3), np.float32)
    loc[:n, :dims] = rs.random((n, dims)).astype(np.float32) * np.asarray(box[:dims], np.float32)
    alive = np.zeros(C, bool)
    alive[:n] = True
    spec = nbr.GridSpec.from_box(box, BIO.neighbor_radius, 0)
    g = nbr.build_grid(spec, torch.from_numpy(loc), torch.arange(C, dtype=torch.int32),
                       torch.from_numpy(alive))
    o = g.order
    l0 = torch.from_numpy(loc)[o]
    noise = np.zeros((C, 3), np.float32)
    noise[:, :dims] = rs.normal(0, 0.7, (C, dims))
    l1 = l0 + torch.from_numpy(noise)
    feats = [torch.from_numpy(rs.integers(0, 3, C).astype(np.int32)) for _ in range(3)]
    now = alive[o.numpy()] & (rs.random(C) > 0.05)
    now[n:] = rs.random(C - n) < 0.3
    return [bio_moments.positions(l0), torch.from_numpy(now), nbr.run_bounds(spec, g.sorted_flat),
            l1.contiguous(), *feats]


@pytest.mark.parametrize("mode", ["count", "pathway", "motility", "full"])
def test_bio_kernel_matches_plain(dev, mode):
    args = [t.to(dev) for t in _bio_inputs(2, seed=1)]
    kw = dict(radius=BIO.neighbor_radius, mode=mode)
    before = kernels.launch_counts["bio_moments"]
    got = bio_moments.bio_moments_cuda(*args, **kw)
    want = bio_moments.bio_moments_plain(*args, **kw)
    assert kernels.launch_counts["bio_moments"] == before + 1
    assert float(want[:, 0].sum()) > args[0].shape[0]
    assert torch.equal(got[:, [0, 1, 2, 3, 7]], want[:, [0, 1, 2, 3, 7]])
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-5)


def test_bio_kernel_reads_only_the_inputs_of_its_mode(dev):
    """The engine's calls pass only what their mode reads: count none,
    pathway ``f0``; the lanes equal those of the call with every input."""
    args = [t.to(dev) for t in _bio_inputs(2, seed=4)]
    kw = dict(radius=BIO.neighbor_radius)
    full = {m: bio_moments.bio_moments_cuda(*args, mode=m, **kw) for m in ("count", "pathway")}
    assert torch.equal(bio_moments.bio_moments_cuda(*args[:3], mode="count", **kw),
                       full["count"])
    assert torch.equal(bio_moments.bio_moments_cuda(*args[:3], f0=args[4], mode="pathway",
                                                    **kw), full["pathway"])
    bad = list(args)
    bad[4] = bad[4].to(torch.int64)
    with pytest.raises(TypeError):
        bio_moments.bio_moments_cuda(*bad, mode="full", **kw)


def test_engine_bio_call_launches_only_the_kernel(dev):
    """Each of the engine's three bio-moments calls of a step is one device
    launch, the kernel's: no re-sentineled copy or pack per call."""
    from hipsc_abm_tpu_torch.tools import device_kernels, record_bio_calls

    gen = GeneralParams(num_to_start=2000, size=(1200.0, 1200.0, 0.0))
    eng = HipscEngine(gen, ExperimentalParams(num_gata6=200, dox_step=1), device=dev)
    state, _ = eng.safe_step(eng.init_state(seed=2))
    calls = record_bio_calls(eng, state)
    assert [k["mode"] for _, k in calls] == ["count", "pathway", "motility"]
    for a, k in calls:
        _, launches, names = device_kernels(lambda: bio_moments.bio_moments_cuda(*a, **k), 5)
        assert launches == 1 and all("bio_moments_kernel" in name for name in names), names


@pytest.mark.parametrize("two_d", [True, False])
def test_unit_vectors_are_bit_equal_on_card_and_cpu(dev, two_d):
    """The id-keyed unit vectors of the motility phase (their trigonometry in
    float64, rounded to float32) on the card equal the CPU's bit for bit at
    a million ids: a lone cell's motility move, the same every substep, then
    rounds its position the same way on both."""
    from hipsc_abm_tpu_torch.ops import rng

    key = rng.prng_key(7)
    ids = torch.arange(0, 3_000_000, 3, dtype=torch.int32)
    got = rng.unit_vectors(key, ids.to(dev), two_d, salt=1).cpu()
    assert torch.equal(got, rng.unit_vectors(key, ids, two_d, salt=1))


@pytest.mark.parametrize("shape", [(97, 131), (449, 449), (1001, 1001)])
@pytest.mark.parametrize("halo", [0, 1, 5])
def test_ftcs_kernel_matches_plain(dev, shape, halo):
    """Bit-equal to the plain version, one launch per call, on the planned
    tiling (halo 0) and on fixed halos."""
    rs = np.random.default_rng(2)
    g = torch.from_numpy(rs.random(shape).astype(np.float32) * 2.4 - 0.2).to(dev)
    dts = diffusion.diffusion_dts(1800.0, 6.0)
    args = (dts, 2.0, 400.0, 2.0, 0.1)
    before = kernels.launch_counts["ftcs_diffuse"]
    got = ftcs.ftcs_diffuse_cuda(g, *args, halo=halo)
    want = diffusion.ftcs_diffuse(g, *args)
    assert kernels.launch_counts["ftcs_diffuse"] == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("contact_path", ["id_list", "span_mask"])
def test_engine_step_on_card_matches_cpu(dev, contact_path):
    n = 3000
    side = 2000.0 * (n / 5000.0) ** 0.5
    gen = GeneralParams(num_to_start=n, end_step=20, size=(side, side, 0.0))
    xp = ExperimentalParams(num_gata6=n // 10, dox_step=1)
    diff = DiffusionParams(spat_res=20.0, diffuse_dt=6.0, diffuse_const=2.0,
                           max_concentration=2.0, degradation=0.1, release_amount=0.01)
    cpu = HipscEngine(gen, xp, diff=diff, enable_diffusion=True, device="cpu",
                      contact_path=contact_path)
    gpu = HipscEngine(gen, xp, diff=diff, enable_diffusion=True, device=dev,
                      contact_path=contact_path)
    s, _ = cpu.safe_step(cpu.init_state(seed=1))
    d = convert.state_to_numpy(s)
    a = convert.state_to_numpy(cpu.step(convert.state_from_numpy(d, "cpu"))[0])
    b = convert.state_to_numpy(gpu.step(convert.state_from_numpy(d))[0])

    def by_id(x):
        ids = x["arrays"]["ids"][x["alive"]]
        o = np.argsort(ids)
        return {k: v[x["alive"]][o] for k, v in x["arrays"].items()}

    a, b = by_id(a), by_id(b)
    np.testing.assert_array_equal(b["ids"], a["ids"])
    for k in ("FGF4", "FGFR", "ERK", "GATA6", "NANOG", "states", "death_counters",
              "diff_counters", "div_counters", "fds_counters"):
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    np.testing.assert_allclose(b["locations"], a["locations"], rtol=0, atol=1e-3)


# ---------------------------------------------------------------------------
# 3D: the 9-run forms
# ---------------------------------------------------------------------------

BOX3D = (80.0, 80.0, 80.0)


def _contact_inputs_3d(K):
    """A dense 3D colony (degrees past 8, more than 32 candidates a row)."""
    return _contact_inputs(K, C=768, n=700, box=BOX3D, skin=14.0)


@pytest.mark.parametrize("K", [8, 40])
def test_contact_kernel_3d_matches_plain(dev, K):
    args = [a.to(dev) for a in _contact_inputs_3d(K)]
    assert args[3].shape[1] == 18
    _, shell, beyond = _bond_shells(args)
    assert shell > 0 and beyond > 0
    law = dict(uniform_radius=BIO.max_radius, **LAW)
    before = dict(kernels.launch_counts)
    fk, dk, pk = contact.contact_substep_cuda(*args, **law)
    fp, dp, pp = contact.contact_substep_plain(*args, **law)
    torch.cuda.synchronize()
    assert kernels.launch_counts["contact_substep_3d"] == before.get("contact_substep_3d", 0) + 1
    assert kernels.launch_counts["contact_substep"] == before.get("contact_substep", 0)
    _check_contact(fk, dk, fp, dp)
    assert int(dp.max()) > 8 and float(fp[:, 2].abs().max()) > 0
    for a, b in zip(pk.cpu().numpy(), pp.cpu().numpy()):
        assert set(a[a >= 0].tolist()) == set(b[b >= 0].tolist())


@pytest.mark.parametrize("K", [8, 24, 40])
def test_span_mask_kernels_3d_match_plain(dev, K):
    """Seed, masked substep and compaction over nine runs, each against its
    plain version on the same inputs."""
    args = [a.to(dev) for a in _contact_inputs_3d(K)]
    law = dict(uniform_radius=BIO.max_radius, **LAW)
    before = dict(kernels.launch_counts)
    f_k, d_k, m_k = span_mask.contact_seed_cuda(*args, **law)
    f_p, d_p, m_p = span_mask.contact_seed_plain(*args, **law)
    torch.cuda.synchronize()
    _check_contact(f_k, d_k, f_p, d_p)
    assert m_p.shape[0] >= 2 and torch.equal(m_k, m_p)
    rows = (_moved(args), *args[1:4])
    m_k, m_p = m_p.clone(), m_p.clone()
    f_k, d_k, _ = span_mask.contact_masked_cuda(*rows, m_k, **law)
    f_p, d_p, _ = span_mask.contact_masked_plain(*rows, m_p, **law)
    torch.cuda.synchronize()
    _check_contact(f_k, d_k, f_p, d_p)
    assert torch.equal(m_k, m_p)
    got = span_mask.mask_compact_cuda(args[1], args[3], m_p, K)
    want = span_mask.mask_compact_plain(args[1], args[3], m_p, K)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    for name in ("contact_seed_3d", "contact_masked_3d", "mask_compact_3d"):
        assert kernels.launch_counts[name] == before.get(name, 0) + 1, name


@pytest.mark.parametrize("mode", ["count", "pathway", "motility", "full"])
def test_bio_kernel_3d_matches_plain(dev, mode):
    args = [t.to(dev) for t in _bio_inputs(3, seed=3)]
    assert args[2].shape[1] == 18
    kw = dict(radius=BIO.neighbor_radius, mode=mode)
    before = kernels.launch_counts["bio_moments_3d"]
    got = bio_moments.bio_moments_cuda(*args, **kw)
    want = bio_moments.bio_moments_plain(*args, **kw)
    assert kernels.launch_counts["bio_moments_3d"] == before + 1
    assert float(want[:, 0].sum()) > args[0].shape[0]
    assert torch.equal(got[:, [0, 1, 2, 3, 7]], want[:, [0, 1, 2, 3, 7]])
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-5)


def test_kernels_reject_other_run_counts(dev):
    args = [a.to(dev) for a in _contact_inputs_3d(8)]
    bad = list(args)
    bad[3] = bad[3][:, :12].contiguous()
    with pytest.raises(ValueError):
        contact.contact_substep_cuda(*bad, **LAW)
    with pytest.raises(ValueError):
        span_mask.contact_seed_cuda(*bad, **LAW)


def _probe_matches_plain(probe, inputs, mode):
    """One launch of the probe's kernel against its plain version."""
    name = probe.__name__.rsplit(".", 1)[1]
    before = kernels.launch_counts[name]
    got = probe.probe_cuda(*inputs, mode)
    want = probe.probe_plain(*inputs, mode)
    assert kernels.launch_counts[name] == before + 1
    if probe is dynslice_probe:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.parametrize("mode", dynslice_probe.MODES)
def test_probe1_kernel_matches_plain(dev, mode):
    _probe_matches_plain(dynslice_probe, dynslice_probe.make_inputs(64, dev), mode)


@pytest.mark.parametrize("mode", dynslice_probe2.MODES)
def test_probe2_kernel_matches_plain(dev, mode):
    _probe_matches_plain(dynslice_probe2, dynslice_probe2.make_inputs(64, dev), mode)


# program counts: a part of one block, one program past 132 SMs' warps,
# and more than two programs for some warps on 132 SMs
PROBE_NBLK = (1, 3, 133, 2117)


@pytest.mark.parametrize("nblk", PROBE_NBLK)
@pytest.mark.parametrize("mode", dynslice_probe.MODES)
def test_probe1_kernel_at_program_counts(dev, mode, nblk):
    _probe_matches_plain(dynslice_probe, dynslice_probe.make_inputs(nblk, dev), mode)


@pytest.mark.parametrize("nblk", PROBE_NBLK)
@pytest.mark.parametrize("mode", dynslice_probe2.MODES)
def test_probe2_kernel_at_program_counts(dev, mode, nblk):
    _probe_matches_plain(dynslice_probe2, dynslice_probe2.make_inputs(nblk, dev), mode)


@pytest.mark.parametrize("offset", [0, 1, 895, 896])
def test_probe1_kernel_at_edge_offsets(dev, offset):
    """Unaligned windows at the span block's first lanes and its last
    window (SPAN - W = 896)."""
    _probe_matches_plain(dynslice_probe, dynslice_probe.make_inputs(37, dev, offset=offset),
                         "dyn_unaligned")


@pytest.mark.parametrize("offset", [0, 383, 511])
@pytest.mark.parametrize("mode", ["quarters", "octets"])
def test_probe2_kernel_at_edge_offsets(dev, mode, offset):
    """Windows from aligned starts 0, 256 and 384 (= SPAN - W, the clamp)."""
    _probe_matches_plain(dynslice_probe2, dynslice_probe2.make_inputs(37, dev, offset=offset),
                         mode)


@pytest.mark.parametrize("shape", [(1, 32, 2), (1, 128, 2), (3, 96, 2), (10, 128, 1)])
def test_probe_kernels_on_other_grids(dev, monkeypatch, shape):
    """Every mode of both probes at 37 programs on grids other than the
    wrapper's: one warp walking all, a part-filled last pass, one program
    per warp with idle warps."""
    monkeypatch.setattr(dynslice_probe, "launch_shape", lambda nblk, n_sm, warps_per_sm: shape)
    for probe in (dynslice_probe, dynslice_probe2):
        inputs = probe.make_inputs(37, dev)
        for mode in probe.MODES:
            _probe_matches_plain(probe, inputs, mode)


@pytest.mark.parametrize("shape", [(1, 32, 1), (1, 48, 1), (1, 32, 3), (0, 32, 1)])
def test_probe_kernels_refuse_other_shapes(dev, monkeypatch, shape):
    """One buffer per warp needs a warp per program; threads a multiple of
    32, one or two buffers, at least one block."""
    monkeypatch.setattr(dynslice_probe, "launch_shape", lambda nblk, n_sm, warps_per_sm: shape)
    for probe, mode in ((dynslice_probe, "static"), (dynslice_probe2, "full")):
        with pytest.raises(RuntimeError, match="CUDA error"):
            probe.probe_cuda(*probe.make_inputs(2, dev), mode)


@pytest.mark.parametrize("contact_path", ["id_list", "span_mask"])
def test_engine_3d_step_on_card_matches_cpu(dev, contact_path):
    """One 3D spheroid step (the example's configuration at 1,100 cells,
    ball packed tighter so K grows) on the card against the CPU."""
    n, scale = 1100, (1100 / 3300.0) ** (1.0 / 3.0)
    box, radius = 600.0 * scale, 0.8 * 110.0 * scale
    gen = GeneralParams(num_to_start=1000, end_step=20, size=(box, box, box))
    xp = ExperimentalParams(num_gata6=100, dox_step=1, guye_move=False)
    rs = np.random.default_rng(0)
    direction = rs.normal(size=(n, 3))
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    ball = (box / 2 + direction * (radius * rs.random(n) ** (1 / 3))[:, None]).astype(np.float32)
    cpu = HipscEngine(gen, xp, device="cpu", contact_path=contact_path)
    gpu = HipscEngine(gen, xp, device=dev, contact_path=contact_path)
    s, _ = cpu.safe_step(cpu.init_state(seed=0, locations=ball))
    assert s.bonds.partners.shape[1] > 8
    gpu.cfg = cpu.cfg
    d = convert.state_to_numpy(s)
    before = dict(kernels.launch_counts)
    a = convert.state_to_numpy(cpu.step(convert.state_from_numpy(d, "cpu"))[0])
    b = convert.state_to_numpy(gpu.step(convert.state_from_numpy(d))[0])
    assert kernels.launch_counts["bio_moments_3d"] == before.get("bio_moments_3d", 0) + 3

    def by_id(x):
        ids = x["arrays"]["ids"][x["alive"]]
        o = np.argsort(ids)
        return {k: v[x["alive"]][o] for k, v in x["arrays"].items()}

    a, b = by_id(a), by_id(b)
    np.testing.assert_array_equal(b["ids"], a["ids"])
    for k in ("FGF4", "FGFR", "ERK", "GATA6", "NANOG", "states", "death_counters",
              "diff_counters", "div_counters", "fds_counters"):
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    np.testing.assert_allclose(b["locations"], a["locations"], rtol=0, atol=1e-3)


# ---------------------------------------------------------------------------
# run_steps blocks: the step without host reads, the predicated span-mask
# kernels and their static mask width, the captured block
# ---------------------------------------------------------------------------


def _bench_engine(dev, contact_path, n=3000, **flags):
    side = 2000.0 * (n / 5000.0) ** 0.5
    gen = GeneralParams(num_to_start=n, end_step=20, size=(side, side, 0.0))
    xp = ExperimentalParams(num_gata6=n // 10, dox_step=1)
    diff = DiffusionParams(spat_res=20.0, diffuse_dt=6.0, diffuse_const=2.0,
                           max_concentration=2.0, degradation=0.1, release_amount=0.01)
    return HipscEngine(gen, xp, diff=diff, enable_diffusion=True, device=dev,
                       contact_path=contact_path, **flags)


def _spheroid_engine(dev, contact_path, n=1500):
    from hipsc_abm_tpu_torch.engine import HipscEngine as Engine

    gen = GeneralParams(num_to_start=n - n // 11, end_step=20, size=(300.0, 300.0, 300.0))
    xp = ExperimentalParams(num_gata6=n // 11, dox_step=1, guye_move=False)
    rs = np.random.default_rng(3)
    u = rs.normal(size=(n, 3))
    ball = 150.0 + u / np.linalg.norm(u, axis=1, keepdims=True) * (
        70.0 * rs.random(n) ** (1 / 3))[:, None]
    eng = Engine(gen, xp, device=dev, contact_path=contact_path)
    return eng, eng.init_state(seed=2, locations=ball.astype(np.float32))


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("contact_path", ["id_list", "span_mask"])
def test_engine_step_makes_no_host_read(dev, contact_path, dims):
    """After one warm-up step, a step of either contact path, in 2D (with
    diffusion) and 3D, runs under ``set_sync_debug_mode("error")``: nothing
    in it waits for the card."""
    if dims == 2:
        eng = _bench_engine(dev, contact_path)
        state = eng.init_state(seed=1)
    else:
        eng, state = _spheroid_engine(dev, contact_path)
    state, _ = eng.safe_step(state)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, info = eng.step(state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(info.num_agents) > 0


def test_step_keys_on_card_match_cpu(dev):
    """``split`` and ``hash_bits`` on key tensors on the card, bit-equal to
    the CPU's."""
    from hipsc_abm_tpu_torch.ops import rng

    key = rng.prng_key(77)
    keys_cpu = torch.stack(rng.split(key, 4096))
    keys_dev = torch.stack(rng.split(key.to(dev), 4096))
    assert torch.equal(keys_dev.cpu(), keys_cpu)
    ids = torch.arange(0, 2**31 - 1, 2**31 // 100_000, dtype=torch.int32)
    assert torch.equal(rng.hash_bits(keys_dev[9], ids.to(dev), 3).cpu(),
                       rng.hash_bits(keys_cpu[9], ids, 3))


def _pred(dev, on):
    return torch.full((1,), int(on), dtype=torch.int32, device=dev)


@pytest.mark.parametrize("on", [True, False], ids=["taken", "skipped"])
@pytest.mark.parametrize("dims", [2, 3])
def test_predicated_span_mask_kernels_match_plain(dev, dims, on):
    """The seed, the masked substep and the compaction under a device
    predicate, into given buffers, against their plain versions under the
    same predicate: taken, the results are those of an unpredicated call;
    skipped, every buffer keeps what it held."""
    K = 24
    args = [a.to(dev) for a in (_contact_inputs(K, skin=14.0) if dims == 2
                                else _contact_inputs_3d(K))]
    law = dict(uniform_radius=BIO.max_radius, **LAW)
    _, _, seed_mask = span_mask.contact_seed_plain(*args, **law)
    W, C = seed_mask.shape
    rows = (_moved(args), *args[1:4])

    def buffers():
        return (torch.full((C, 3), 7.0, device=dev),
                torch.full((C,), -3, dtype=torch.int32, device=dev),
                torch.full((W, C), 0x5A5A5A5A, dtype=torch.int32, device=dev),
                torch.full((C, K), -7, dtype=torch.int32, device=dev))

    outs = {}
    for name, seed, masked, compact in (
            ("kernel", span_mask.contact_seed_cuda, span_mask.contact_masked_cuda,
             span_mask.mask_compact_cuda),
            ("plain", span_mask.contact_seed_plain, span_mask.contact_masked_plain,
             span_mask.mask_compact_plain)):
        force, degree, mask, ids = buffers()
        seed(*args, out=(force, degree, mask), pred=_pred(dev, on), **law)
        m2 = seed_mask.clone()
        f2, d2 = torch.zeros_like(force), torch.zeros_like(degree)
        masked(*rows, m2, out=(f2, d2), pred=_pred(dev, on), **law)
        compact(args[1], args[3], seed_mask, K, pred=_pred(dev, on), out=ids)
        outs[name] = (force, degree, mask, f2, d2, m2, ids)
    torch.cuda.synchronize()
    k, p = outs["kernel"], outs["plain"]
    fresh = buffers()
    if on:
        _check_contact(k[0], k[1], p[0], p[1])
        _check_contact(k[3], k[4], p[3], p[4])
        assert torch.equal(k[2], p[2]) and torch.equal(k[2], seed_mask)
        assert torch.equal(k[5], p[5]) and not torch.equal(k[5], seed_mask)
        assert torch.equal(k[6], p[6])
        assert torch.equal(k[6], span_mask.mask_compact_plain(args[1], args[3], seed_mask, K))
    else:
        for got in (k, p):
            for a, b in zip((got[0], got[1], got[2], got[6]), (fresh[0], fresh[1], fresh[2],
                                                               fresh[3])):
                assert torch.equal(a, b)
            assert torch.equal(got[5], seed_mask) and not bool(got[4].any())


@pytest.mark.parametrize("dims", [2, 3])
def test_mask_kernels_never_write_past_the_capacity(dev, dims):
    """A mask of one word (32 candidates) over rows that hold more: the
    seed, the masked substep and the compaction read and write only that
    word, whose guard rows before and after stay as they were; force and
    degree are those of the whole walk (the plain version at the same
    capacity), and the widest row reports the need."""
    K = 24
    args = [a.to(dev) for a in (_contact_inputs(K, skin=14.0) if dims == 2
                                else _contact_inputs_3d(K))]
    C = args[0].shape[0]
    assert span_mask.widest_row(args[3]) > 32
    law = dict(uniform_radius=BIO.max_radius, **LAW)
    guard = 0x5A5A5A5A
    buf = torch.full((3, C), guard, dtype=torch.int32, device=dev)
    mask = buf[1:2]  # one word per row between two guard rows
    force = torch.empty((C, 3), device=dev)
    degree = torch.empty((C,), dtype=torch.int32, device=dev)
    span_mask.contact_seed_cuda(*args, out=(force, degree, mask), **law)
    plain = [torch.zeros_like(force), torch.zeros_like(degree),
             torch.zeros((1, C), dtype=torch.int32, device=dev)]
    span_mask.contact_seed_plain(*args, out=plain, **law)
    torch.cuda.synchronize()
    _check_contact(force, degree, plain[0], plain[1])
    assert torch.equal(mask, plain[2])
    rows = (_moved(args), *args[1:4])
    span_mask.contact_masked_cuda(*rows, mask, out=(force, degree), **law)
    span_mask.contact_masked_plain(*rows, plain[2], out=plain[:2], **law)
    ids = span_mask.mask_compact_cuda(args[1], args[3], mask, K)
    torch.cuda.synchronize()
    _check_contact(force, degree, plain[0], plain[1])
    assert torch.equal(mask, plain[2])
    assert torch.equal(ids, span_mask.mask_compact_plain(args[1], args[3], plain[2], K))
    assert bool((buf[0] == guard).all()) and bool((buf[2] == guard).all())


@pytest.mark.parametrize("contact_path", ["id_list", "span_mask"])
def test_run_steps_graph_replays_match_eager_blocks(dev, contact_path):
    """Two consecutive 3-step blocks of ``run_steps`` (one captured CUDA
    graph, replayed twice) against the same block function run eagerly on
    the card: positions and integer state bit-equal by slot, the lattice
    within its deposit's atomics (float32 sums in no fixed order), the
    probes equal; each replay counts the graph's launches."""
    from hipsc_abm_tpu_torch import engine as engine_mod

    eng = _bench_engine(dev, contact_path)
    state, _ = eng.safe_step(eng.init_state(seed=4))
    cfg = eng._cfg_for_state(state)
    eager, probes = state, []
    for _ in range(2):
        table, keys = engine_mod.step_inputs(eager.key, eager.step, 3)
        eager, p = engine_mod._run_block(eng, cfg, eager, table.to(dev))
        eager = eager._replace(key=keys[-1])
        probes.append(p.cpu())
    graphed, info = eng.run_steps(state, 3)  # the capture, then a replay
    infos = [info]
    kernels.launch_counts.clear()
    graphed, info = eng.run_steps(graphed, 3)
    infos.append(info)
    graphs = {g["k"]: g for g in eng.block_graphs()}  # safe_step's and the block's
    assert eng.block_attempts == 1 and sorted(graphs) == [1, 3]
    per_replay = graphs[3]["launches"]
    assert per_replay and dict(kernels.launch_counts) == per_replay
    a, b = convert.state_to_numpy(eager), convert.state_to_numpy(graphed)
    for k in a["arrays"]:
        np.testing.assert_array_equal(b["arrays"][k].view(np.int32)
                                      if b["arrays"][k].dtype == np.float32
                                      else b["arrays"][k],
                                      a["arrays"][k].view(np.int32)
                                      if a["arrays"][k].dtype == np.float32
                                      else a["arrays"][k], err_msg=k)
    for k in ("alive", "partners", "bond_mask", "key", "step", "next_id"):
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    np.testing.assert_allclose(b["gradients"]["fgf4_values"], a["gradients"]["fgf4_values"],
                               rtol=0, atol=1e-6)
    for p, info in zip(probes, infos):
        np.testing.assert_array_equal(np.asarray(info.num_agents), p[:, 0].numpy())
        np.testing.assert_array_equal(np.asarray(info.jkr_rebuilds), p[:, -1].numpy())


@pytest.mark.parametrize("contact_path", ["id_list", "span_mask"])
def test_run_steps_follows_replaced_parameters(dev, contact_path):
    """A block captured under one ``xp`` (doxycycline never in) and run again
    after the caller replaces ``eng.xp`` (doxycycline in from step 1), with
    the config unchanged: the second run is captured anew and equals the
    same steps run eagerly under the new parameters, and differs from the
    first."""
    eng = _bench_engine(dev, contact_path)
    eng.xp = dataclasses.replace(eng.xp, dox_step=1000)
    state = eng.init_state(seed=5)
    before, _ = eng.run_steps(state, 2)
    eng.xp = dataclasses.replace(eng.xp, dox_step=1)
    after, _ = eng.run_steps(state, 2)
    assert eng.block_attempts == 1 and len(eng.block_graphs()) == 1
    eager = state
    for _ in range(2):
        eager, _ = eng.step(eager)
    a, b, c = (convert.state_to_numpy(s) for s in (after, eager, before))
    for k in a["arrays"]:
        x, y = a["arrays"][k], b["arrays"][k]
        if x.dtype == np.float32:
            x, y = x.view(np.int32), y.view(np.int32)
        np.testing.assert_array_equal(x, y, err_msg=k)
    for k in ("alive", "partners", "bond_mask", "next_id"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert any(not np.array_equal(a["arrays"][k], c["arrays"][k])
               for k in ("FGFR", "ERK", "GATA6", "NANOG"))


def test_deposit_card_equals_cpu_index_add_at_500k(dev):
    """The deposit's fixed-order sum (a stable sort and the ``deposit``
    kernel) on the card at the 2D 500k bench state, one eager step in: bit
    for bit the CPU's sequential ``index_add`` and the same on a second
    call, one launch per call."""
    eng = _bench_engine(dev, "id_list", n=500_000)
    state, _ = eng.step(eng.init_state(seed=0))
    a, alive = state.arrays, state.alive
    amounts = torch.where(alive & (a["NANOG"] > a["GATA6"]), 0.01, 0.0).to(torch.float32)
    lattice = state.gradients["fgf4_values"]
    idx, contrib = diffusion.deposit_terms(lattice.shape, a["locations"], amounts, 20.0)
    flat = lattice.reshape(-1)
    before = kernels.launch_counts["deposit"]
    got = diffusion.scatter_add_cuda(flat, idx, contrib)
    assert kernels.launch_counts["deposit"] == before + 1
    want = diffusion.scatter_add_plain(flat.cpu(), idx.cpu(), contrib.cpu())
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    again = diffusion.scatter_add_cuda(flat, idx, contrib)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


def test_normal_is_bit_equal_on_card_and_cpu(dev):
    """The pathway's normal draw (log, sqrt and cos in float64, rounded to
    float32) on the card equals the CPU's bit for bit at a million ids."""
    from hipsc_abm_tpu_torch.ops import rng

    key = rng.prng_key(9)
    ids = torch.arange(0, 3_000_000, 3, dtype=torch.int32)
    got = rng.normal(key, ids.to(dev)).cpu()
    assert torch.equal(got.view(torch.int32), rng.normal(key, ids).view(torch.int32))


def test_ensemble_replicates_equal_solo_runs_on_card(dev):
    """Three replicates (one a sweep point of ``adhesion_const``) of a
    3,000-cell bench colony with the FGF4 field coupled to the pathway, as
    one captured graph of three branches: after 3 ``safe_step``s each
    equals its solo card run bit for bit, lattice, key and next_id
    included."""
    from hipsc_abm_tpu_torch.parallel.ensemble import EnsembleEngine

    def make():
        eng = _bench_engine(dev, "id_list")
        eng.diff = dataclasses.replace(eng.diff, field_coupling=True, degradation=0.0)
        return eng

    def seeded(state, seed):
        g = state.gradients["fgf4_values"]
        lat = np.random.default_rng(seed).random(tuple(g.shape[-2:]), dtype=np.float32) * 2
        return torch.from_numpy(lat).to(g.device)

    seeds = [0, 1, 2]
    base = make().bio.adhesion_const
    sweep = {"adhesion_const": [base, base, 1.2 * base]}
    ens = EnsembleEngine(make(), sweep=sweep)
    states = ens.init_states(seeds)
    states = states._replace(gradients={"fgf4_values": torch.stack(
        [seeded(states, s) for s in seeds])})
    cfg0 = ens.engine.cfg
    for _ in range(3):
        states, infos = ens.safe_step(states)
    assert infos.num_agents.shape == (3,) and len(ens.graphs()) == 1
    assert kernels.launch_counts["deposit"] > 0
    for i, seed in enumerate(seeds):
        eng = make()
        eng.bio = dataclasses.replace(eng.bio, adhesion_const=sweep["adhesion_const"][i])
        eng.cfg = cfg0
        solo = eng.init_state(seed=seed)
        solo = solo._replace(gradients={"fgf4_values": seeded(solo, seed)})
        for _ in range(3):
            solo, _ = eng.safe_step(solo)
        a = convert.state_to_numpy(EnsembleEngine.replicate(states, i))
        b = convert.state_to_numpy(solo)
        for k in a["arrays"]:
            x, y = a["arrays"][k], b["arrays"][k]
            if x.dtype == np.float32:
                x, y = x.view(np.int32), y.view(np.int32)
            np.testing.assert_array_equal(x, y, err_msg=f"replicate {i}: {k}")
        for k in ("alive", "partners", "bond_mask", "key", "step", "next_id"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"replicate {i}: {k}")
        np.testing.assert_array_equal(a["gradients"]["fgf4_values"].view(np.int32),
                                      b["gradients"]["fgf4_values"].view(np.int32))
