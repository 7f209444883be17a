"""PyTorch port: the general pair law's cut (``csrc/jkr_pair.cuh``
``cull_reach`` and ``certainly_breaks``, mirrored in ``ops.contact``).

B6 and the seed (B2) drop, on the general law, every candidate beyond its
row's reach before they evaluate the law, and are bit-equal to the law asked
of every candidate only if each dropped pair is one the law breaks. Here the
plain mirror of the cut runs on pairs placed from 1e-2 um inside to 1e-2 um
outside the cut (or within 1e-3 of it, relatively, at the extreme radii),
over radii from min_radius / 2 to 2 * max_radius, equal, very unequal, zero,
and from 1e-12 to 1e12 um: every pair it drops must break under the law
the kernels run, the TPU kernels' (``ops.jkr._pair_general``), and under
the XLA path's, the port's and the JAX package's (``ops.jkr._pair_jkr``,
``hipsc_abm_tpu.ops.jkr._pair_jkr``), on the same numpy inputs, and the cut
must drop the pairs beyond it (more than 1e-4 um, or 1e-6 relatively, away)
and keep those inside. Exact comparisons: the cut and the law decide each
pair, no tolerance.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipsc_abm_tpu.ops import jkr as jjkr
from hipsc_abm_tpu_torch.ops import contact
from hipsc_abm_tpu_torch.ops.jkr import _pair_general, _pair_jkr
from hipsc_abm_tpu_torch.params import BiologyParams

BIO = BiologyParams()
LAW_ARGS = contact.pair_law_args(BIO.jkr_radius, BIO.adhesion_const, BIO.poisson,
                                 BIO.youngs, BIO.jkr_break_d, None)
PAIRS = 4000
HEADER = Path(contact.__file__).resolve().parents[1] / "csrc" / "jkr_pair.cuh"


def _radii(family, rs):
    """(ri, rj) float32 of ``PAIRS`` pairs: row and candidate radii (um)."""
    lo, hi = BIO.min_radius / 2, 2 * BIO.max_radius
    u = lambda a, b: rs.uniform(a, b, PAIRS)  # noqa: E731
    if family == "spread":
        ri, rj = u(lo, hi), u(lo, hi)
    elif family == "equal":
        ri = u(lo, hi)
        rj = ri.copy()
    elif family == "unequal":  # a small row beside a large candidate, and back
        small, large = u(lo, BIO.min_radius), u(1.5 * BIO.max_radius, hi)
        flip = rs.random(PAIRS) < 0.5
        ri, rj = np.where(flip, small, large), np.where(flip, large, small)
    elif family == "tight":  # rj >> ri: r_hat within 1e-2 of the bound ri / 1e6
        ri, rj = u(1e-3, 1e-1), u(lo, hi)
    elif family == "zero":  # a zero row radius, or a zero candidate radius
        ri, rj = u(lo, hi), u(lo, hi)
        zero_i = rs.random(PAIRS) < 0.5
        ri, rj = np.where(zero_i, 0.0, ri), np.where(zero_i, rj, 0.0)
    elif family == "extreme":  # across the radii the cut's argument covers
        ri, rj = 10.0 ** u(-12, 12), 10.0 ** u(-12, 12)
    return ri.astype(np.float32), rj.astype(np.float32)


def _pairs(family, dims, seed):
    """Pairs around their cut: the row at a point of a 400 um box (at the
    origin for the extreme radii), the candidate at the cut's distance plus
    an offset along a random direction. Returns float32 numpy positions,
    radii, the offsets (um, or relative for the extreme radii) and the
    kernels' squared distance (float32, rounded after each operation)."""
    rs = np.random.default_rng(seed)
    ri, rj = _radii(family, rs)
    reach = contact.cull_reach(torch.from_numpy(ri), LAW_ARGS)
    cut = ((reach + torch.from_numpy(rj)) * torch.tensor(contact.CULL_SLACK)).double().numpy()
    cut = np.where(np.isfinite(cut), cut, ri.astype(np.float64) + rj + 0.4)
    relative = family == "extreme"
    off = rs.uniform(-1e-3, 1e-3, PAIRS) if relative else rs.uniform(-1e-2, 1e-2, PAIRS)
    dist = cut * (1.0 + off) if relative else cut + off
    me = np.zeros((PAIRS, 3))
    if not relative:
        me[:, :dims] = rs.uniform(0.0, 400.0, (PAIRS, dims))
    u = np.zeros((PAIRS, 3))
    u[:, :dims] = rs.normal(size=(PAIRS, dims))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    me = me.astype(np.float32)
    other = (me + dist[:, None] * u).astype(np.float32)
    d = torch.from_numpy(me - other)
    dist2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    return me, other, ri, rj, off, dist2


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("family", ["spread", "equal", "unequal", "tight", "zero",
                                    "extreme"])
def test_cull_drops_only_pairs_the_law_breaks(family, dims):
    me, other, ri, rj, off, dist2 = _pairs(family, dims, seed=dims * 100 + len(family))
    t_ri, t_rj = torch.from_numpy(ri), torch.from_numpy(rj)
    culled = contact.certainly_breaks(contact.cull_reach(t_ri, LAW_ARGS), t_rj, dist2)

    law = dict(adhesion_const=BIO.adhesion_const, poisson=BIO.poisson, youngs=BIO.youngs,
               break_d=BIO.jkr_break_d)
    _, survive = _pair_jkr(torch.from_numpy(me), torch.from_numpy(other), t_ri, t_rj, **law)
    assert not bool((culled & survive).any()), "a pair the cut drops survives the law"
    d = torch.from_numpy(me - other)
    _, d_tpu, _ = _pair_general(d[:, 0], d[:, 1], d[:, 2], t_ri, t_rj, BIO.adhesion_const,
                                BIO.poisson, BIO.youngs)
    assert not bool((culled & (d_tpu > BIO.jkr_break_d)).any()), (
        "a pair the cut drops survives the kernels' law")
    _, j_survive = jjkr._pair_jkr(jnp.asarray(me), jnp.asarray(other), jnp.asarray(ri),
                                  jnp.asarray(rj), **law)
    assert not bool((culled.numpy() & np.asarray(j_survive)).any()), (
        "a pair the cut drops survives the JAX package's law")

    # the cut drops what lies beyond it and keeps what lies inside, where
    # the pair's radii are ones its argument covers
    covered = ((ri >= contact.CULL_RADII[0]) & (ri <= contact.CULL_RADII[1]) & (rj > 0))
    edge = 1e-6 if family == "extreme" else 1e-4
    if family == "zero":
        assert not covered.any() and not bool(culled.any())
        return
    assert covered.all()
    assert bool(culled[torch.from_numpy(off > edge)].all())
    assert not bool(culled[torch.from_numpy(off < -edge)].any())
    assert (off > edge).sum() > PAIRS // 3 and (off < -edge).sum() > PAIRS // 3
    # where r_hat nears its bound ri / 1e6, the law's break lies within the
    # window: pairs survive a few thousandths of a um inside the cut
    if family == "tight":
        assert int(survive.sum()) > PAIRS // 10


def test_cull_mirror_matches_the_kernel_header():
    """The mirror's constants are the kernels' (``jkr_pair.cuh``), and its
    reach is the float64 formula's within float32 rounding."""
    src = HEADER.read_text()
    assert re.search(r"kCullSlack = 1\.0f \+ 1\.0f / 4096\.0f;", src)
    assert re.search(r"kCullMinRadius = 1e-12f;", src)
    assert re.search(r"kCullMaxRadius = 1e12f;", src)
    assert contact.CULL_SLACK == np.float32(1.0 + 1.0 / 4096.0)
    assert contact.CULL_RADII == (np.float32(1e-12), np.float32(1e12))
    ri = np.linspace(BIO.min_radius / 2, 2 * BIO.max_radius, 101).astype(np.float32)
    got = contact.cull_reach(torch.from_numpy(ri), LAW_ARGS).double().numpy()
    e_hat = 1.0 / (2.0 * (1.0 - BIO.poisson ** 2) / BIO.youngs)
    scale_c = ((np.pi * BIO.adhesion_const) / e_hat) ** (2.0 / 3.0)
    r = ri.astype(np.float64)
    want = r + abs(BIO.jkr_break_d) * scale_c * np.cbrt(r / 1e6) * 1e6
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # the reach of a max-radius row beside a max-radius candidate is past
    # the pair's break distance (the search radius plus jkr_break_band)
    assert float(got[-1]) > 2 * BIO.max_radius
    reach_max = contact.cull_reach(torch.tensor([BIO.max_radius]), LAW_ARGS)
    assert float(reach_max) + BIO.max_radius > BIO.jkr_radius + BIO.jkr_break_band
    bad = torch.tensor([0.0, -1.0, float("nan"), float("inf"), 2e12])
    assert bool(torch.isinf(contact.cull_reach(bad, LAW_ARGS)).all())
