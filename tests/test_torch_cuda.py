"""PyTorch port on the card: each CUDA kernel against its plain version (the
2D and 3D forms of the run-bounds kernels, and every mode of the window
probes), and one engine step on the card against the same step on the CPU,
in 2D and 3D.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU. The file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: the contact kernels on both pair laws, the bio moments in every
mode, the update, FTCS, the deposit's fixed-order sum, the draws, the
device twin of glibc's ``powf`` and an ensemble's replicates (against
their solo runs) are held bit-equal to their plain versions, and an engine
step on the card to the CPU's: both run the same float32 operations in the
same order (``ops.xla_f32``, the general law's cube root glibc's ``powf``
on both sides, the sums in the TPU kernels' grouping of
``neighbors.grouped_sum``); partner lists, degrees and span-mask words are
equal entry for entry. The probes sum their lanes in another order than
the plain versions (P1 rtol 1e-5, atol 1e-5; P2, with the card's rsqrtf
against torch.rsqrt, rtol 1e-4, atol 1e-4 x max|out|).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from hipsc_abm_tpu_torch import colonies, convert, kernels
from hipsc_abm_tpu_torch.engine import HipscEngine
from hipsc_abm_tpu_torch.ops import bio_moments, contact, diffusion, ftcs, span_mask, xla_f32
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
    _check_contact(fk, dk, fp, dp)
    assert torch.equal(pk, pp)  # the lists, entry for entry


def test_powf_kernel_matches_the_mirror(dev):
    """The device twin of glibc's ``powf`` (``xla_f32.powf_cuda``, the
    contact kernels' ``powf_glibc``) at y = float32(1/3), against the plain
    mirror's float64 operations (``xla_f32._powf``) at every float32 in
    [2^-25, 2^-13), run on the card (each rounded once, as on the CPU) and,
    on a sample, on the CPU; and at special values. ``powf`` of a CUDA
    tensor launches the twin."""
    third = float(np.float32(1.0 / 3.0))
    for e in range(-25, -13):
        bits = torch.arange(1 << 23, dtype=torch.int64, device=dev) + ((e + 127) << 23)
        x = bits.to(torch.int32).view(torch.float32)
        got = xla_f32.powf_cuda(x, third)
        assert torch.equal(got, xla_f32._powf(x, third)), e
        pick = torch.randint(0, 1 << 23, (4096,), generator=torch.Generator().manual_seed(e))
        assert torch.equal(got.cpu()[pick], xla_f32.powf(x.cpu()[pick], third)), e
    special = torch.tensor([0.0, -0.0, float("inf"), -2.0, 1.0, 2.0 ** -140, 3.0e38],
                           device=dev)
    got, want = xla_f32.powf_cuda(special, third).cpu(), xla_f32.powf(special.cpu(), third)
    assert torch.equal(xla_f32.powf(special[4:], third), xla_f32.powf_cuda(special[4:], third))
    nan = torch.isnan(want)
    assert int(nan.sum()) == 1 and torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan], want[~nan])
    assert bool(torch.isnan(xla_f32.powf_cuda(torch.tensor([float("nan")], device=dev),
                                              third)).all())


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("uniform", [None, BIO.max_radius])
def test_kernels_follow_the_grouping(dev, dims, uniform):
    """B6, the seed (B2), the masked substep (B1) and the moments (B4)
    against their plain versions under groupings that the default does not
    give: the JAX engine's span caps clipping the blocks' starts, chunks of
    128 lanes, and rows placed at other positions of a larger colony
    (``gpos``, as a domain engine's tile passes them). A dense colony, so
    that runs cross 32-lane windows and chunks."""
    box = (300.0, 300.0, 0.0) if dims == 2 else BOX3D
    C, n = (2048, 1900) if dims == 2 else (768, 700)
    args = [a.to(dev) for a in _contact_inputs(24, C=C, n=n, box=box, skin=14.0,
                                               unequal=uniform is None)]
    law = dict(uniform_radius=uniform, **LAW)
    bounds = args[3]
    shifted = torch.arange(C, dtype=torch.int32, device=dev) + 200
    wide = nbr.grouping_of_bounds(torch.cat([bounds[:256], bounds]), None, C + 256, 256)
    groupings = [nbr.grouping_of_bounds(bounds, 256, C, 256),
                 nbr.grouping_of_bounds(bounds, 512, C, 128),
                 wide._replace(gpos=shifted)]
    pos0 = bio_moments.positions(args[0][:, :3])
    feats = [(torch.arange(C, device=dev, dtype=torch.int32) * k) % 3 for k in (1, 2, 5)]
    for g in groupings:
        fk, dk, pk = contact.contact_substep_cuda(*args, grouping=g, **law)
        fp, dp, pp = contact.contact_substep_plain(*args, grouping=g, **law)
        torch.cuda.synchronize()
        _check_contact(fk, dk, fp, dp)
        assert torch.equal(pk, pp)
        f_k, d_k, m_k = span_mask.contact_seed_cuda(*args, grouping=g, **law)
        f_p, d_p, m_p = span_mask.contact_seed_plain(*args, grouping=g, **law)
        _check_contact(f_k, d_k, f_p, d_p)
        assert torch.equal(m_k, m_p)
        rows = (_moved(args), *args[1:4])
        m_k, m_p = m_p.clone(), m_p.clone()
        f_k, d_k, _ = span_mask.contact_masked_cuda(*rows, m_k, grouping=g, **law)
        f_p, d_p, _ = span_mask.contact_masked_plain(*rows, m_p, grouping=g, **law)
        _check_contact(f_k, d_k, f_p, d_p)
        assert torch.equal(m_k, m_p)
        a = (pos0, args[2], bounds, rows[0][:, :3].contiguous(), *feats)
        got = bio_moments.bio_moments_cuda(*a, radius=15.0, mode="full", grouping=g)
        want = bio_moments.bio_moments_plain(*a, radius=15.0, mode="full", grouping=g)
        assert torch.equal(got, want) and float(want[:, 4:7].abs().max()) > 0


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
    """Forces bit-equal (on either law) and degrees equal."""
    assert float(f_p.abs().max()) > 0
    assert torch.equal(f_k, f_p), float((f_k - f_p).abs().max())
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
@pytest.mark.parametrize("uniform", [None, BIO.max_radius])
def test_contact_masked_kernel_matches_plain(dev, K, uniform):
    args = [a.to(dev) for a in _contact_inputs(K, skin=14.0, unequal=uniform is None)]
    law = dict(uniform_radius=uniform, **LAW)
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


@pytest.mark.parametrize("K", [8, 40])
@pytest.mark.parametrize("dims", [2, 3])
def test_general_law_kernels_match_plain(dev, dims, K):
    """B6, then B2 (seed) -> B1 (masked, positions moved) -> B3 on unequal
    radii, each against its plain version: forces, degrees, partner lists,
    mask words and compacted ids exact."""
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
    assert torch.equal(pk, pp) and int(dp.sum()) > n
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
    float32 law may decide otherwise than the float64 break distance that
    places the pairs): B6, the seed (B2) and
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
    assert torch.equal(pk, pp) and torch.equal(m_k, m_p)
    m_k, m_p = m_p.clone(), m_p.clone()
    f_k, d_k, _ = span_mask.contact_masked_cuda(*args[:4], m_k, **GENERAL)
    f_p, d_p, _ = span_mask.contact_masked_plain(*args[:4], m_p, **GENERAL)
    torch.cuda.synchronize()
    _check_contact(f_k, d_k, f_p, d_p)
    assert torch.equal(m_k, m_p) and int(d_p.sum()) == want


@pytest.mark.parametrize("K", [8, 40])
@pytest.mark.parametrize("dims", [2, 3])
def test_general_law_kernels_at_the_cull_distance(dev, dims, K):
    """Bonded and fresh pairs from 1e-2 um inside to 1e-2 um outside one
    row's cull distance (``contact.cull_reach``, ``certainly_breaks``), where
    B6 and the seed (B2) drop a pair before the general law: against their
    plain versions, which ask the law of every pair. Radii as growth spreads
    them, and every fourth pair a row of 0.01-0.1 um beside a grown one, for
    which r_hat nears its bound ri / 1e6 and the law's break lies within the
    window; offsets within 1e-4 um of a pair's own break distance are left
    out (the float32 law may decide them otherwise than the float64 break
    distance). Plus 32
    bonded pairs well inside their break distance."""
    off = np.linspace(-1e-2, 1e-2, 240)
    n = len(off)
    rs = np.random.default_rng(13)
    radii = rs.uniform(BIO.min_radius, BIO.max_radius, 2 * n + 64).astype(np.float32)
    tight = np.arange(n) % 4 == 3
    radii[2 * np.flatnonzero(tight)] = rs.uniform(0.01, 0.1, int(tight.sum()))
    # the row whose cut places the pair: the small one of a tight pair, else
    # either in turn
    row = 2 * np.arange(n) + ((np.arange(n) % 2 == 1) & ~tight)
    law_args = contact.pair_law_args(**GENERAL)
    ri, rj = torch.from_numpy(radii[row]), torch.from_numpy(radii[row ^ 1])
    cut = ((contact.cull_reach(ri, law_args) + rj) * torch.tensor(contact.CULL_SLACK)).double()
    gaps = cut.numpy() + off
    reach = np.array([_break_reach(float(radii[2 * k]), float(radii[2 * k + 1]))
                      for k in range(n)])
    keep = np.abs(gaps - reach) > 1e-4
    gaps, reach, tight = gaps[keep], reach[keep], tight[keep]
    m = len(gaps)
    pair_radii = np.concatenate([radii[:2 * n].reshape(n, 2)[keep].ravel(),
                                 radii[2 * n:2 * n + 64]])
    inside = np.array([_break_reach(float(pair_radii[2 * m + 2 * k]),
                                    float(pair_radii[2 * m + 2 * k + 1])) - 0.05
                       for k in range(32)])
    bonded = np.concatenate([np.arange(m) % 2 == 0, np.ones(32, bool)])
    args = [a.to(dev) for a in _pair_rows(np.concatenate([gaps, inside]), bonded, dims, K=K,
                                          radii=np.concatenate([pair_radii, radii[-64:]]))]
    # what the law keeps: the 32, and pairs inside their break distance that
    # are bonded or within the search radius (every one of them: tight)
    survive = gaps < reach
    assert survive.sum() > 5 and not (survive & ~tight).any()
    assert (gaps - cut.numpy()[keep] > 1e-4).sum() > m // 3
    want = 2 * (int(survive.sum()) + 32)
    suffix = "" if dims == 2 else "_3d"
    before = dict(kernels.launch_counts)
    fk, dk, pk = contact.contact_substep_cuda(*args, **GENERAL)
    fp, dp, pp = contact.contact_substep_plain(*args, **GENERAL)
    f_k, d_k, m_k = span_mask.contact_seed_cuda(*args, **GENERAL)
    f_p, d_p, m_p = span_mask.contact_seed_plain(*args, **GENERAL)
    torch.cuda.synchronize()
    for got, plain in (((fk, dk), (fp, dp)), ((f_k, d_k), (f_p, d_p))):
        _check_contact(*got, *plain)
        assert int(plain[1].sum()) == want
    assert torch.equal(pk, pp) and torch.equal(m_k, m_p)
    for name in ("contact_substep", "contact_seed"):
        key = name + suffix
        assert kernels.launch_counts[key] == before.get(key, 0) + 1, key


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
    assert torch.equal(got, want) and float(want[:, 7].sum()) > 0


@pytest.mark.parametrize("folded", [True, False])
@pytest.mark.parametrize("counted", [False, True])
def test_update_kernel_matches_plain(dev, folded, counted):
    """The substep's update (``csrc/update.cu``): new locations (some
    clamped at the box, dead rows kept), the largest squared move and drift
    and the drift flag bit-equal to ``update_plain``, in one launch, on the
    first substep's folded form and a later substep's, over the alive rows
    or a given row set; the flag both ways."""
    from hipsc_abm_tpu_torch.engine import drift_threshold
    from hipsc_abm_tpu_torch.ops import integrate

    rs = np.random.default_rng(21 + 2 * folded + counted)
    C = 70_000  # several CTAs, a partial last one
    box = torch.tensor([300.0, 300.0, 0.0], device=dev)
    loc = torch.from_numpy((rs.random((C, 3)) * [300.0, 300.0, 0.0]).astype(np.float32)).to(dev)
    loc[:50, 0] = 0.0
    rad = torch.from_numpy(rs.uniform(3.0, 5.0, C).astype(np.float32)).to(dev)
    alive = torch.from_numpy(rs.random(C) < 0.9).to(dev)
    rad[~alive] = 0.0
    force = torch.from_numpy(rs.normal(0, 3e-9, (C, 3)).astype(np.float32)).to(dev)
    force[:50, 0] = -1e-6  # pushed past the wall: clamped to 0
    mot = torch.from_numpy(rs.normal(0, 1e-9, (C, 3)).astype(np.float32)).to(dev)
    rows = torch.from_numpy(rs.random(C) < 0.5).to(dev) if counted else None
    for shift, want_stale in ((0.25, False), (9.0, True)):
        ref = loc + shift
        kw = dict(stokes=BIO.stokes, dt=float(BIO.move_dt), folded=folded,
                  threshold=drift_threshold(14.0), counted=rows)
        scratch = integrate.update_scratch(2, dev)
        before = kernels.launch_counts["update"]
        got = integrate.update_cuda(loc, rad, force, mot, alive, ref, box,
                                    scratch=scratch[1], **kw)
        want = integrate.update_plain(loc, rad, force, mot, alive, ref, box, **kw)
        torch.cuda.synchronize()
        assert kernels.launch_counts["update"] == before + 1
        for name, g, w in zip(("locations", "move2", "drift2", "stale"), got, want):
            assert torch.equal(g, w), name
        assert bool(want[3]) == want_stale and float(want[1]) > 0
        assert bool((got[0][~alive] == loc[~alive]).all()) and float(got[0][:50, 0].max()) == 0
        assert int(scratch[0].sum()) == 0  # the other substep's row untouched


@pytest.mark.parametrize("operands", ["arrays", "scalars", "broadcast"])
def test_fma_kernel_equals_the_plain_mirror(dev, operands):
    """The glue FMA (``csrc/fma.cu``) against ``rng.fma_f32`` on the CPU,
    bit for bit, with products and addends over many exponents (sums that
    cancel included), scalar operands and broadcast ones; one launch."""
    from hipsc_abm_tpu_torch.ops import rng, xla_f32

    gen = np.random.default_rng(5)
    n = 1 << 20
    a, b, c = ((gen.standard_normal(n) * 2.0 ** gen.integers(-30, 30, n)).astype(np.float32)
               for _ in range(3))
    c[: n // 4] = -(a[: n // 4] * b[: n // 4])  # near-cancelling sums
    if operands == "scalars":
        b, c = float(np.float32(-0.0204)), float(np.float32(0.4942))
    elif operands == "broadcast":
        a, b = a.reshape(-1, 4), b[:4]
        c = c.reshape(-1, 4)
    t = [torch.from_numpy(x) if isinstance(x, np.ndarray) else x for x in (a, b, c)]
    want = rng.fma_f32(*t)
    before = kernels.launch_counts["fma"]
    got = xla_f32.fma(*[x.to(dev) if isinstance(x, torch.Tensor) else x for x in t])
    torch.cuda.synchronize()
    assert kernels.launch_counts["fma"] == before + 1
    assert torch.equal(got.cpu(), want)


def test_update_kernel_in_a_captured_graph(dev):
    """The update needs no host read and no zeroing launch of its own: it
    replays in a CUDA graph, reading the scratch row the caller zeroed."""
    from hipsc_abm_tpu_torch.ops import integrate

    C = 5000
    rs = np.random.default_rng(3)
    loc = torch.from_numpy((rs.random((C, 3)) * 100).astype(np.float32)).to(dev)
    rad = torch.full((C,), 5.0, device=dev)
    alive = torch.ones(C, dtype=torch.bool, device=dev)
    force = torch.from_numpy(rs.normal(0, 1e-9, (C, 3)).astype(np.float32)).to(dev)
    mot = torch.zeros_like(force)
    box = torch.tensor([100.0, 100.0, 100.0], device=dev)
    kw = dict(stokes=BIO.stokes, dt=float(BIO.move_dt), folded=False, threshold=49.0)
    want = integrate.update_plain(loc, rad, force, mot, alive, loc, box, **kw)
    scratch = integrate.update_scratch(1, dev)
    integrate.update_cuda(loc, rad, force, mot, alive, loc, box, scratch=scratch[0], **kw)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        scratch.zero_()
        out = integrate.update_cuda(loc, rad, force, mot, alive, loc, box, scratch=scratch[0],
                                    **kw)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        for name, g, w in zip(("locations", "move2", "drift2", "stale"), out, want):
            assert torch.equal(g, w), name


@pytest.mark.parametrize("state", ["2d", "2d_sparse", "3d", "break"])
def test_uniform_law_kernels_are_bit_equal_to_plain(dev, state):
    """B6, the seed (B2), the masked substep (B1) and the compaction (B3)
    on the uniform law at four states (a dense and a sparse 2D colony, a
    dense 3D one, pairs at their break distance): forces, degrees, partner
    sets, mask words and compacted ids bit-equal to the plain versions."""
    K = 24
    if state == "2d":
        args = _contact_inputs(K, skin=14.0)
    elif state == "2d_sparse":
        args = _contact_inputs(K, C=2048, n=1200, box=(900.0, 900.0, 0.0), skin=14.0)
    elif state == "3d":
        args = _contact_inputs_3d(K)
    else:
        off = np.linspace(-4e-3, 4e-3, 240)
        args = _pair_rows(2 * BIO.max_radius + _uniform_break() + off,
                          np.ones(len(off), bool), 2, K=K)
    args = [a.to(dev) for a in args]
    law = dict(uniform_radius=BIO.max_radius, **LAW)
    fk, dk, pk = contact.contact_substep_cuda(*args, **law)
    fp, dp, pp = contact.contact_substep_plain(*args, **law)
    torch.cuda.synchronize()
    _check_contact(fk, dk, fp, dp)
    assert torch.equal(pk, pp)
    f_k, d_k, m_k = span_mask.contact_seed_cuda(*args, **law)
    f_p, d_p, m_p = span_mask.contact_seed_plain(*args, **law)
    torch.cuda.synchronize()
    _check_contact(f_k, d_k, f_p, d_p)
    assert torch.equal(m_k, m_p)
    rows = (_moved(args), *args[1:4])
    m_k, m_p = m_p.clone(), m_p.clone()
    f_k, d_k, _ = span_mask.contact_masked_cuda(*rows, m_k, **law)
    f_p, d_p, _ = span_mask.contact_masked_plain(*rows, m_p, **law)
    torch.cuda.synchronize()
    _check_contact(f_k, d_k, f_p, d_p)
    assert torch.equal(m_k, m_p)
    assert torch.equal(span_mask.mask_compact_cuda(args[1], args[3], m_p, K),
                       span_mask.mask_compact_plain(args[1], args[3], m_p, K))


def _uniform_break() -> float:
    """How far past touching (2 max_radius) a pair of equal radii breaks
    (um, float64): -break_d times the uniform law's overlap scale."""
    e_hat = 1.0 / (2.0 * (1.0 - BIO.poisson ** 2) / BIO.youngs)
    scale_c = ((math.pi * BIO.adhesion_const) / e_hat) ** (2.0 / 3.0)
    r_hat = BIO.max_radius / 2.0 / 1e6
    return -BIO.jkr_break_d * scale_c * r_hat ** (1.0 / 3.0) * 1e6


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
    assert torch.equal(got, want)


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
    """The id-keyed unit vectors of the motility phase (glibc's sinf/cosf
    mirrored, ``csrc/draws.cu``, one launch per call) on the card equal the
    CPU's plain version bit for bit at a million ids: a lone cell's
    motility move, the same every substep, then rounds its position the
    same way on both."""
    from hipsc_abm_tpu_torch.ops import rng

    key = rng.prng_key(7)
    ids = torch.arange(0, 3_000_000, 3, dtype=torch.int32)
    name = "unit_vectors" if two_d else "unit_vectors_3d"
    before = kernels.launch_counts[name]
    got = rng.unit_vectors(key, ids.to(dev), two_d, salt=1).cpu()
    assert kernels.launch_counts[name] == before + 1
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
              "diff_counters", "div_counters", "fds_counters", "locations"):
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


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
    assert torch.equal(got, want)


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
              "diff_counters", "div_counters", "fds_counters", "locations"):
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


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
        rebuilds = engine_mod.StepInfo._fields.index("jkr_rebuilds")
        np.testing.assert_array_equal(np.asarray(info.jkr_rebuilds), p[:, rebuilds].numpy())


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
    """The pathway's normal draw (XLA's float32 log, a correctly rounded
    sqrt, glibc's cosf; ``csrc/draws.cu``, one launch per call) on the card
    equals the CPU's plain version bit for bit at a million ids."""
    from hipsc_abm_tpu_torch.ops import rng

    key = rng.prng_key(9)
    ids = torch.arange(0, 3_000_000, 3, dtype=torch.int32)
    before = kernels.launch_counts["normal"]
    got = rng.normal(key, ids.to(dev)).cpu()
    assert kernels.launch_counts["normal"] == before + 1
    assert torch.equal(got.view(torch.int32), rng.normal(key, ids).view(torch.int32))


@pytest.mark.parametrize("draw,stream", [("normal", 0), ("normal", 17), ("unit2d", 0),
                                         ("unit3d", 29)])
def test_draw_kernels_equal_plain_over_all_uniforms(dev, draw, stream):
    """Each draw kernel on 2^24 ids whose uniforms in one stream are every
    24-bit uniform (``rng.hash_preimage``) equals its plain version on the
    CPU bit for bit; the key read from the card; empty ids launch nothing."""
    from hipsc_abm_tpu_torch.ops import rng

    key = torch.stack(rng.split(rng.prng_key(5), 6))[4]
    salt = 2
    for lo in range(0, 1 << 24, 1 << 22):
        bits = torch.arange(lo, lo + (1 << 22), dtype=torch.int64) << 8
        ids = rng.hash_preimage(key, bits, salt + stream)
        if draw == "normal":
            got, want = rng.normal(key.to(dev), ids.to(dev), salt), rng.normal(key, ids, salt)
        else:
            two_d = draw == "unit2d"
            got = rng.unit_vectors(key.to(dev), ids.to(dev), two_d, salt)
            want = rng.unit_vectors(key, ids, two_d, salt)
        assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32)), lo
    before = dict(kernels.launch_counts)
    assert rng.normal(key.to(dev), ids[:0].to(dev)).shape == (0,)
    assert dict(kernels.launch_counts) == before
    with pytest.raises(TypeError):
        rng.normal(key.to(dev), ids.to(dev, torch.int64))


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


def _calibration_engine(dev, n=150, diffusion=False):
    """``tests/test_calibrate.py``'s colony (150 + 15 cells in a 300 um
    box), with FGF4 secretion and FTCS diffusion when ``diffusion``."""
    gen = GeneralParams(num_to_start=n, end_step=5, size=(300.0, 300.0, 0.0))
    xp = ExperimentalParams(num_gata6=n // 10, dox_step=1)
    diff = DiffusionParams(spat_res=20.0, diffuse_dt=6.0, diffuse_const=2.0,
                           max_concentration=2.0, degradation=0.1, release_amount=0.01)
    return HipscEngine(gen, xp, diff=diff if diffusion else None,
                       enable_diffusion=diffusion, device=dev)


def test_deposit_backward_on_card_equals_cpu(dev):
    """The deposit's ``autograd.Function``: forward the fixed-order kernel
    (one launch), backward the lattice cotangent passed through and
    gathered at each term's index (the sentinel's terms 0), bit-equal to
    autograd of ``scatter_add_plain`` on the CPU."""
    g = torch.Generator().manual_seed(3)
    P, n = 5000, 40000
    flat = torch.rand(P, generator=g)
    idx = torch.randint(0, P + 1, (n,), generator=g)
    contrib = torch.rand(n, generator=g)
    weight = torch.rand(P, generator=g)

    def grads(device, fn):
        f = flat.to(device).requires_grad_(True)
        c = contrib.to(device).requires_grad_(True)
        out = fn(f, idx.to(device), c)
        (out * weight.to(device)).sum().backward()
        return out.detach().cpu(), f.grad.cpu(), c.grad.cpu()

    before = kernels.launch_counts["deposit"]
    got = grads(dev, diffusion.scatter_add_cuda)
    assert kernels.launch_counts["deposit"] == before + 1
    want = grads("cpu", diffusion.scatter_add_plain)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_plain_selector_launches_no_kernel(dev):
    """``hipsc_step(plain=True)`` on the card, with diffusion on: the contact,
    bio-moments and FTCS kernels are not launched (their counts unchanged),
    the deposit's fixed-order kernel is; the same step without the selector
    launches all four."""
    from hipsc_abm_tpu_torch.engine import hipsc_step

    eng = _calibration_engine(dev, diffusion=True)
    state = eng.init_state(seed=0)
    names = ("contact_substep", "bio_moments", "ftcs_diffuse", "deposit")
    for plain in (True, False):
        before = {k: kernels.launch_counts[k] for k in names}
        hipsc_step(state, eng.cfg, eng.gen, eng.xp, eng.bio, eng.diff, plain=plain)
        moved = {k: kernels.launch_counts[k] - before[k] for k in names}
        if plain:
            assert moved == {"contact_substep": 0, "bio_moments": 0, "ftcs_diffuse": 0,
                             "deposit": 1}, moved
        else:
            assert all(v > 0 for v in moved.values()), moved


def test_calibration_gradient_on_card_matches_cpu(dev):
    """A 2-step gradient evaluation (adhesion and motility, squared Rg
    error, diffusion on) on the card against the same on the CPU from one
    state: loss rtol 1e-5, gradient rtol 1e-3 (float32 reductions and libm
    functions of two devices)."""
    from hipsc_abm_tpu_torch import calibrate as cal_mod

    out = {}
    cpu_eng = _calibration_engine("cpu", diffusion=True)
    start = convert.state_to_numpy(cpu_eng.safe_step(cpu_eng.init_state(seed=0))[0])
    for device in (dev, "cpu"):
        cal = cal_mod.Calibrator(
            _calibration_engine(device, diffusion=True), ["adhesion_const", "motility_force"],
            cal_mod.squared_error(cal_mod.radius_of_gyration, 100.0), horizon=2)
        state = cal._reconcile(convert.state_from_numpy(start, device))
        (loss, _), grad = cal._value_and_grad(cal.theta0(), state,
                                              cal._grad_cfg(cal.engine.cfg))
        out[str(device)] = (float(loss), grad.numpy())
    (loss_c, grad_c), (loss_p, grad_p) = out[str(dev)], out["cpu"]
    assert np.all(np.isfinite(grad_c)) and np.abs(grad_c).max() > 0
    np.testing.assert_allclose(loss_c, loss_p, rtol=1e-5)
    np.testing.assert_allclose(grad_c, grad_p, rtol=1e-3)


@pytest.mark.parametrize("dense", [True, False])
def test_population_losses_equal_solo_rollouts_on_card(dev, dense):
    """An ES population (3 candidates of adhesion and motility over R = 2
    replicates: one captured ensemble of 6 branches) on the card: each
    candidate's loss equals its solo rollout's (``Calibrator.evaluate``,
    eager steps) bit for bit, on the dense and the windowed path; the bio
    moments kernel launched in both, the contact kernel in the windowed
    one only."""
    from hipsc_abm_tpu_torch import calibrate as cal_mod
    from hipsc_abm_tpu_torch.parallel.ensemble import EnsembleEngine

    eng = _calibration_engine(dev)
    cal = cal_mod.Calibrator(
        eng, ["adhesion_const", "motility_force"],
        cal_mod.ensemble_trajectory(cal_mod.trajectory_squared_error(
            cal_mod.radius_of_gyration, [95.0, 94.5, 94.0])),
        horizon=3, dense_pairs=dense)
    states = cal.prepare(EnsembleEngine(eng).init_states(seeds=[0, 1]))
    theta = cal.theta0()
    cands = theta[None, :] + torch.tensor([[0.0, 0.0], [0.3, -0.2], [-0.3, 0.2]])
    kernels.launch_counts.clear()
    losses, _ = cal._population(cands, states)
    assert kernels.launch_counts["bio_moments"] > 0
    assert (kernels.launch_counts["contact_substep"] > 0) != dense
    assert len(set(losses.tolist())) == 3
    for i in range(3):
        assert float(losses[i]) == cal.evaluate(cands[i], states), i


# ---------------------------------------------------------------------------
# the domain-decomposed engine: tiles on one card
# ---------------------------------------------------------------------------


def _domain_engines(device, tiles=(2, 2), n=3000):
    from hipsc_abm_tpu_torch.parallel import DomainHipscEngine

    side = 2000.0 * (n / 5000.0) ** 0.5
    gen = GeneralParams(num_to_start=n, end_step=20, size=(side, side, 0.0))
    xp = ExperimentalParams(num_gata6=n // 10, dox_step=1)
    diff = DiffusionParams(spat_res=20.0, diffuse_dt=6.0, diffuse_const=2.0,
                           max_concentration=2.0, degradation=0.1, release_amount=0.01)
    dom = DomainHipscEngine(gen, xp, diff=diff, enable_diffusion=True, tiles=tiles,
                            device=device)
    single = HipscEngine(gen, xp, diff=diff, cfg=dom.cfg.base, device=device)
    return dom, single


def test_domain_tiles_on_card_equal_single_engine_on_card(dev):
    """Tiles (2, 2) on one card against the single engine on the card, 4
    safe_steps: integer state, bond sets and positions bit-equal by agent
    id (the same kernels walk the same candidates in the same order); the
    lattice within 1e-5 (the tiles' deposits are summed in tile order)."""
    dom, single = _domain_engines(dev)
    ds, ss = dom.init_state(seed=2), single.init_state(seed=2)
    single.cfg = dom.cfg.base
    for _ in range(4):
        ds, _ = dom.safe_step(ds)
        ss, _ = single.safe_step(ss)
    a = convert.state_to_numpy(dom.to_cell_state(ds))
    b = convert.state_to_numpy(ss)
    x, y = colonies.by_id(a), colonies.by_id(b)
    for k in x:
        if k == "bonds":
            assert colonies.bond_rows_apart(x[k], y[k]) == 0
        else:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    np.testing.assert_allclose(a["gradients"]["fgf4_values"], b["gradients"]["fgf4_values"],
                               rtol=0, atol=1e-5)


def test_domain_on_card_matches_domain_on_cpu(dev):
    """One domain step from the same decomposed state on the card and on
    the CPU (kernels against plain versions): integers, positions and the
    lattice bit-equal (the mirrored pair law and update, the runs' sums,
    the fixed-order deposit, the tile-order sum, FTCS)."""
    cpu, _ = _domain_engines("cpu")
    gpu, _ = _domain_engines(dev)
    s, _ = cpu.safe_step(cpu.init_state(seed=4))
    gpu.cfg = cpu.cfg
    d = convert.domain_state_to_numpy(s)
    a, _ = cpu.step(convert.domain_state_from_numpy(d, cpu.devices))
    b, _ = gpu.step(convert.domain_state_from_numpy(d, gpu.devices))
    x = convert.state_to_numpy(cpu.to_cell_state(a))
    y = convert.state_to_numpy(gpu.to_cell_state(b))
    p, q = colonies.by_id(x), colonies.by_id(y)
    np.testing.assert_array_equal(q["ids"], p["ids"])
    for k in ("FGF4", "FGFR", "ERK", "GATA6", "NANOG", "states", "death_counters",
              "diff_counters", "div_counters", "fds_counters"):
        np.testing.assert_array_equal(q[k], p[k], err_msg=k)
    np.testing.assert_array_equal(q["locations"], p["locations"])
    np.testing.assert_array_equal(y["gradients"]["fgf4_values"].view(np.int32),
                                  x["gradients"]["fgf4_values"].view(np.int32))


# ---------------------------------------------------------------------------
# the domain engine over processes, and shard_states, on the card
# ---------------------------------------------------------------------------

_SPAN_MASK_ROUTE = ("contact_seed", "contact_masked", "mask_compact", "bio_moments",
                    "deposit", "ftcs_diffuse")


def _route_launches(outs):
    from hipsc_abm_tpu_torch.tools import multihost_domain

    launches = {}
    for r in multihost_domain.results(outs):
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return launches


def test_multiprocess_gloo_route_on_card_equals_single_engine(dev, tmp_path):
    """Two ranks sharing the card over gloo, 2 x 2 tiles of a 20k colony:
    the payload holds every step, the sharded resume, growth and rebalance
    bit-equal by agent id to the single engine and to one controller on the
    card (rank 0), and every span-mask kernel launched on the route."""
    from hipsc_abm_tpu_torch.tools import multihost_domain

    outs = multihost_domain.run_ranks(
        2, str(tmp_path), ["--device", "cuda", "--cells", "20000", "--tiles", "2", "2",
                           "--steps", "2", "--timed", "2"], timeout_s=600)
    assert "MULTIHOST OK" in outs[0], outs[0][-3000:]
    launches = _route_launches(outs)
    assert all(launches.get(k, 0) > 0 for k in _SPAN_MASK_ROUTE), launches
    assert all(r["staged_bytes"][-1] > 0 for r in multihost_domain.results(outs))


def test_multiprocess_nccl_route_with_a_card_per_rank(dev, tmp_path):
    if torch.cuda.device_count() < 2:
        pytest.skip("NCCL needs a card per rank; this machine has one card")
    from hipsc_abm_tpu_torch.tools import multihost_domain

    outs = multihost_domain.run_ranks(
        2, str(tmp_path), ["--device", "cuda", "--backend", "nccl", "--cells", "20000",
                           "--tiles", "2", "2", "--steps", "2", "--timed", "2"], timeout_s=600)
    assert "MULTIHOST OK" in outs[0], outs[0][-3000:]
    assert all(r["staged_bytes"][-1] == 0 for r in multihost_domain.results(outs))


def test_nccl_with_more_ranks_than_cards_raises(dev):
    from hipsc_abm_tpu_torch.parallel import distributed

    with pytest.raises(RuntimeError, match="one card per rank"):
        distributed.init_process_group("nccl", "tcp://127.0.0.1:1", 0,
                                       torch.cuda.device_count() + 1, device="cuda:0")
    assert not torch.distributed.is_initialized()


def test_shard_states_on_card_equal_unsharded_and_solo(dev):
    """4 replicates in 2 groups on the card, each group one captured graph:
    every replicate bit-equal to the unsharded ensemble's and to its solo
    run, the lattice, key and next_id included."""
    from hipsc_abm_tpu_torch.parallel.ensemble import EnsembleEngine

    def engine():
        gen = GeneralParams(num_to_start=2000, end_step=5, size=(1265.0, 1265.0, 0.0))
        diff = DiffusionParams(spat_res=20.0, diffuse_dt=6.0, diffuse_const=2.0,
                               max_concentration=2.0, degradation=0.1, release_amount=0.01)
        return HipscEngine(gen, ExperimentalParams(num_gata6=200, dox_step=1), diff=diff,
                           enable_diffusion=True, device=dev, contact_path="id_list")

    seeds = [0, 1, 2, 3]
    ens, plain = EnsembleEngine(engine()), EnsembleEngine(engine())
    sharded = EnsembleEngine.shard_states(ens.init_states(seeds), [dev, dev])
    unsharded = plain.init_states(seeds)
    solos = []
    for seed in seeds:
        eng = engine()
        state = eng.init_state(seed=seed)
        eng.cfg = ens.engine.cfg
        solos.append((eng, state))
    for _ in range(3):
        sharded, _ = ens.safe_step(sharded)
        unsharded, _ = plain.safe_step(unsharded)
        solos = [(e, e.safe_step(s)[0]) for e, s in solos]
    assert len(ens.graphs()) == 2
    for i, (_, solo) in enumerate(solos):
        got = convert.state_to_numpy(EnsembleEngine.replicate(sharded, i))
        for want in (convert.state_to_numpy(EnsembleEngine.replicate(unsharded, i)),
                     convert.state_to_numpy(solo)):
            x, y = colonies.by_id(got), colonies.by_id(want)
            for k in x:
                if k == "bonds":
                    assert colonies.bond_rows_apart(x[k], y[k]) == 0
                else:
                    np.testing.assert_array_equal(x[k], y[k], err_msg=k)
            np.testing.assert_array_equal(got["gradients"]["fgf4_values"],
                                          want["gradients"]["fgf4_values"])
            np.testing.assert_array_equal(got["key"], want["key"])
            assert int(got["next_id"]) == int(want["next_id"])
