"""Johnson-Kendall-Roberts contact mechanics with persistent bonds (port of
``hipsc_abm_tpu/ops/jkr.py``).

Each substep a pair is force-eligible when it is a fresh contact within the
search radius OR already bonded; eligible pairs whose nondimensional overlap
stays above the break threshold exert force and form the next bond set. The
bond graph is a per-agent ``(C, K)`` list of partner **ids** (never slots):
ids are not recycled, so a dead partner's entry never matches a candidate
again and drops at the next compaction.

The functions here are the plain windowed form of the contact substep. They
are the reference the CUDA contact kernel (``ops.contact``) is held to, and
the CPU engine runs them through ``ops.contact``'s wrapper.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import xla_f32
from .neighbors import Lanes, grouped_sum

NO_BOND = -1  # empty entry of a partner-id list


class BondState(NamedTuple):
    """Persistent bonded-partner matrix: partner agent ids and a mask."""

    partners: torch.Tensor  # (C, K) int32 partner agent ids
    mask: torch.Tensor  # (C, K) bool

    @classmethod
    def empty(cls, capacity: int, bond_cap: int, device="cpu") -> "BondState":
        return cls(
            partners=torch.zeros((capacity, bond_cap), dtype=torch.int32, device=device),
            mask=torch.zeros((capacity, bond_cap), dtype=torch.bool, device=device),
        )

    @classmethod
    def from_ids(cls, ids: torch.Tensor) -> "BondState":
        """From a ``NO_BOND``-padded partner-id list."""
        return cls(partners=ids.clamp(min=0).to(torch.int32), mask=ids >= 0)

    def ids(self) -> torch.Tensor:
        """The ``NO_BOND``-padded partner-id list (int32)."""
        return torch.where(self.mask, self.partners,
                           torch.full_like(self.partners, NO_BOND))

    def degree(self) -> torch.Tensor:
        return self.mask.sum(dim=1, dtype=torch.int32)


def pack_physics(locations: torch.Tensor, radii: torch.Tensor) -> torch.Tensor:
    """(C, 4) float32 ``[x, y, z, radius]`` rows: what the contact substep
    reads per agent besides its id and liveness."""
    return torch.cat([locations.to(torch.float32),
                      radii.to(torch.float32)[:, None]], dim=1).contiguous()


def _cube_root(x: torch.Tensor) -> torch.Tensor:
    """``x ** float32(1/3)`` as XLA:CPU takes ``jnp.power(x, 1/3)``: a call
    of glibc's ``powf``, mirrored bit for bit (``xla_f32.powf``) for
    positive finite ``x``."""
    return xla_f32.powf(x, float(np.float32(1.0 / 3.0)))


def uniform_law(uniform_radius: float, adhesion_const: float, poisson: float,
                youngs: float) -> dict:
    """The uniform law's float32 constants, as the TPU kernels fold them
    (``hipsc_abm_tpu/ops/pallas_contact.py`` ``_pair_consts``) and XLA:CPU
    folds them again: ``two_r`` (r_i + r_j), ``inv_scale`` (1 / (1e6
    scale)), ``fpre`` (pi adhesion r_hat) and ``c3``, the cubic's leading
    coefficient times ``inv_scale``."""
    e_hat = 1.0 / (2.0 * (1.0 - poisson**2) / youngs)
    u_r_hat = (uniform_radius * uniform_radius) / (1e6 * 2.0 * uniform_radius)
    u_scale = ((math.pi * adhesion_const) / e_hat) ** (2.0 / 3.0) * u_r_hat ** (1.0 / 3.0)
    inv_scale = xla_f32.f32(1.0 / (1e6 * u_scale))
    return dict(two_r=xla_f32.f32(2.0 * uniform_radius), inv_scale=inv_scale,
                fpre=xla_f32.f32(math.pi * adhesion_const * u_r_hat),
                c3=xla_f32.fold(-0.0204, inv_scale))


def _pair_uniform(dx, dy, dz, law: dict) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The uniform law of the TPU kernels' pair evaluation (``_pair_keep``)
    as XLA:CPU compiles their interpreted bodies, for ``(dx, dy, dz)`` = row
    minus candidate: ``inv`` is XLA's ``rsqrt``, ``mag = dist2 inv`` is
    fused into ``d0 = 10 - dist2 inv``, ``d = d0 inv_scale``, the cubic's
    first step reads ``d0`` through the folded ``c3``, and the pair force
    is ``w (dx, dy, dz)`` with ``w = (f fpre) inv``. Returns ``(dist2, d,
    w)``."""
    dist2 = xla_f32.sq_sum(dx, dy, dz)
    pos = dist2 > 0
    inv = torch.where(pos, xla_f32.rsqrt(torch.where(pos, dist2, torch.ones_like(dist2))),
                      torch.zeros_like(dist2))
    d0 = xla_f32.fma(-dist2, inv, law["two_r"])
    d = d0 * law["inv_scale"]
    f = xla_f32.fma(d, xla_f32.fma(d, xla_f32.fma(d0, law["c3"], 0.4942), 1.0801), -1.324)
    return dist2, d, (f * law["fpre"]) * inv


def _pair_general(dx, dy, dz, ri, rj, adhesion_const, poisson: float,
                  youngs: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The general law of the TPU kernels' pair evaluation (``_pair_keep``
    and ``_contact_kernel`` with per-pair radii) as XLA:CPU compiles their
    interpreted bodies, for ``(dx, dy, dz)`` = row minus candidate and the
    radii ``ri``, ``rj``: ``inv`` is XLA's ``rsqrt``, ``mag = dist2 inv``
    is fused into the overlap ``fma(-dist2, inv, ri + rj)``, times the
    float32 reciprocal of 1e6, the reduced radius ``r_hat`` by a division,
    the overlap scale its cube root (glibc's ``powf``, ``_cube_root``)
    times the folded constant, ``d`` the overlap over it, the cubic fused
    (no clamp of ``d``), and the pair force ``w (dx, dy, dz)`` with ``w =
    ((f (pi adhesion)) r_hat) inv``. This is not ``_pair_jkr``, the JAX
    package's XLA path, which takes a square root and divides by it.
    Returns ``(dist2, d, w)``; an adhesion constant given as a tensor is
    not folded."""
    dist2 = xla_f32.sq_sum(dx, dy, dz)
    pos = dist2 > 0
    inv = torch.where(pos, xla_f32.rsqrt(torch.where(pos, dist2, torch.ones_like(dist2))),
                      torch.zeros_like(dist2))
    e_hat = 1.0 / (2.0 * (1.0 - poisson**2) / youngs)
    radii = ri + rj
    overlap = xla_f32.fma(-dist2, inv, radii) * xla_f32.recip(1e6)
    r_hat = (ri * rj) / (torch.clamp(radii, min=1e-12) * xla_f32.f32(1e6))
    scale_c = xla_f32.f32(((math.pi * adhesion_const) / e_hat) ** (2.0 / 3.0))
    d = overlap / torch.clamp(_cube_root(r_hat) * scale_c, min=1e-30)
    f = xla_f32.fma(d, xla_f32.fma(d, xla_f32.fma(d, -0.0204, 0.4942), 1.0801), -1.324)
    return dist2, d, ((f * xla_f32.f32(math.pi * adhesion_const)) * r_hat) * inv


def _is_bonded(partner_ids: torch.Tensor, cand_id: torch.Tensor) -> torch.Tensor:
    """(C, W) membership of each window candidate id in the row's
    ``NO_BOND``-padded partner list."""
    return torch.any(
        (cand_id[:, :, None] == partner_ids[:, None, :])
        & (partner_ids[:, None, :] >= 0),
        dim=2,
    )


def _compact_bonds(
    cand_id: torch.Tensor,  # (C, T) candidate partner ids
    keep: torch.Tensor,  # (C, T) bool
    bond_cap: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """First ``bond_cap`` kept entries per row, in window order. Returns the
    ``NO_BOND``-padded (C, K) int32 list and the untruncated (C,) int32 row
    degree (the bond-capacity overflow probe)."""
    capacity = cand_id.shape[0]
    dest = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    slot = torch.where(keep & (dest < bond_cap), dest,
                       torch.full_like(dest, bond_cap))
    out = torch.full((capacity, bond_cap + 1), NO_BOND, dtype=torch.int32,
                     device=cand_id.device)
    out.scatter_(1, slot, cand_id.to(torch.int32))
    return out[:, :bond_cap].contiguous(), keep.sum(dim=1, dtype=torch.int32)


def pair_terms(
    bond_mask: torch.Tensor,  # (C, W) bond set aligned to the window
    xyzr: torch.Tensor,  # (C, 4) [x, y, z, r] rows, slot order
    ids: torch.Tensor,  # (C,) agent ids
    alive: torch.Tensor,  # (C,) bool
    order: Optional[torch.Tensor],  # (C,) grid sort order; None = rows sorted
    pos: torch.Tensor,  # (C, W) candidate sorted positions
    valid: torch.Tensor,  # (C, W) window validity
    radius: float,
    adhesion_const: float,
    poisson: float,
    youngs: float,
    break_d: float,
    uniform_radius: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pair law over a window: ``(terms (C, W, 3), keep (C, W))``, each
    kept pair's force on the row agent (zero elsewhere) and the surviving
    eligible set (the next bonds). ``uniform_radius`` selects the uniform
    law (``_pair_uniform``: every radius equal, as the contact kernels' fast
    path), None the general law (``_pair_general``); both are the TPU
    kernels'."""
    if order is not None:
        s_xyzr, s_ids = xyzr[order], ids[order]
    else:
        s_xyzr, s_ids = xyzr, ids
    cand = s_xyzr[pos]  # (C, W, 4)
    cand_id = s_ids[pos]
    delta = xyzr[:, None, :3] - cand[..., :3]  # row minus candidate
    r = np.float32(radius)
    radius2 = float(r * r)
    pair_ok = valid & (cand_id != ids[:, None]) & alive[:, None]
    # the law runs only where a pair can be eligible: the float64 squared
    # distance is within 2^-20 of the float32 one, so every pair within the
    # radius by the law's squared distance is among these
    with torch.no_grad():
        near = pair_ok & (((delta.double() ** 2).sum(dim=-1) <= radius2 * (1 + 2.0**-20))
                          | bond_mask)
    at = near.nonzero(as_tuple=True)
    d_at, c_at = delta[at], cand[at]
    if uniform_radius is not None:
        dist2, d, w = _pair_uniform(d_at[:, 0], d_at[:, 1], d_at[:, 2],
                                    uniform_law(uniform_radius, adhesion_const, poisson,
                                                youngs))
        survive = d > break_d
        terms = w[:, None] * d_at
    else:
        dist2, d, w = _pair_general(d_at[:, 0], d_at[:, 1], d_at[:, 2], xyzr[at[0], 3],
                                    c_at[:, 3], adhesion_const, poisson, youngs)
        survive = d > break_d
        terms = w[:, None] * d_at
    keep = torch.zeros_like(near)
    keep[at] = ((dist2 <= radius2) | bond_mask[at]) & survive
    return torch.zeros_like(delta).index_put(at, terms), keep


def jkr_substep_aligned(
    bond_mask: torch.Tensor,
    xyzr: torch.Tensor,
    ids: torch.Tensor,
    alive: torch.Tensor,
    order: Optional[torch.Tensor],
    pos: torch.Tensor,
    valid: torch.Tensor,
    radius: float,
    adhesion_const: float,
    poisson: float,
    youngs: float,
    break_d: float,
    uniform_radius: Optional[float] = None,
    lanes: Optional[Lanes] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One substep over a window (``pair_terms``'s arguments). Returns
    ``(forces (C, 3), keep (C, W))``: the summed pair forces and the
    surviving eligible set (the next bonds). A row's forces are summed in
    the TPU kernels' grouping of the window's ``lanes``
    (``neighbors.grouped_sum``; without them, in window order)."""
    terms, keep = pair_terms(bond_mask, xyzr, ids, alive, order, pos, valid, radius,
                             adhesion_const, poisson, youngs, break_d, uniform_radius)
    return grouped_sum(terms, keep, lanes), keep


def jkr_substep(
    partner_ids: torch.Tensor,  # (C, K) NO_BOND-padded partner ids
    xyzr: torch.Tensor,
    ids: torch.Tensor,
    alive: torch.Tensor,
    order: Optional[torch.Tensor],
    pos: torch.Tensor,
    valid: torch.Tensor,
    radius: float,
    adhesion_const: float,
    poisson: float,
    youngs: float,
    break_d: float,
    uniform_radius: Optional[float] = None,
    lanes: Optional[Lanes] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Id-list substep: partner lists -> window mask, one substep, first-K
    compaction back. Returns ``(forces (C, 3), new partner ids (C, K),
    degree (C,))``. The survivors are listed in the order the kernels
    visit them: with ``lanes``, the TPU kernels' chunk-major order (chunk,
    then run, then position), else window order."""
    s_ids = ids[order] if order is not None else ids
    cand_id = s_ids[pos]
    bond_mask = _is_bonded(partner_ids, cand_id)
    forces, keep = jkr_substep_aligned(
        bond_mask, xyzr, ids, alive, order, pos, valid, radius,
        adhesion_const, poisson, youngs, break_d, uniform_radius, lanes,
    )
    if lanes is not None:
        visit = torch.sort(lanes.group, dim=1, stable=True).indices
        cand_id, keep = torch.gather(cand_id, 1, visit), torch.gather(keep, 1, visit)
    new_ids, degree = _compact_bonds(cand_id, keep, partner_ids.shape[1])
    return forces, new_ids, degree


def clear_bond_rows(bonds: BondState, rows_to_clear: torch.Tensor) -> BondState:
    """Empty the bond rows of given slots (daughters get fresh graph vertices
    with no edges). Dead partners need no cleanup: their ids never appear in
    a candidate window again."""
    return BondState(partners=bonds.partners,
                     mask=bonds.mask & ~rows_to_clear[:, None])
