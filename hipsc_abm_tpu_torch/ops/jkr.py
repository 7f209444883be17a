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

import torch

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


def _pair_jkr(
    loc_i: torch.Tensor,  # (..., 3) row agent locations
    loc_j: torch.Tensor,  # (..., 3) partner locations
    rad_i: torch.Tensor,  # (...,)
    rad_j: torch.Tensor,  # (...,)
    adhesion_const: float,
    poisson: float,
    youngs: float,
    break_d: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pair JKR force on the row agent and bond-survival flag (the
    per-edge math of ``jkr_forces_cpu``, ``cell_backend.py:73-113``)."""
    vector = loc_i - loc_j
    mag2 = torch.sum(vector * vector, dim=-1)
    mag_pos = mag2 > 0
    one = torch.ones_like(mag2)
    mag = torch.where(mag_pos, torch.sqrt(torch.where(mag_pos, mag2, one)),
                      torch.zeros_like(mag2))
    overlap = (rad_i + rad_j - mag) / 1e6  # um -> m

    e_hat = 1.0 / (2.0 * (1.0 - poisson**2) / youngs)
    r_hat = (rad_i * rad_j) / (1e6 * torch.clamp(rad_i + rad_j, min=1e-12))
    r_pos = r_hat > 0
    safe_r = torch.where(r_pos, r_hat, torch.ones_like(r_hat))
    overlap_ = torch.where(
        r_pos,
        ((math.pi * adhesion_const) / e_hat) ** (2.0 / 3.0) * safe_r ** (1.0 / 3.0),
        torch.zeros_like(r_hat),
    )
    d = overlap / torch.clamp(overlap_, min=1e-30)

    alive_bond = d > break_d
    d_f = torch.clamp(d, -1e8, 1e8)
    f = ((-0.0204 * d_f + 0.4942) * d_f + 1.0801) * d_f - 1.324
    jkr_force = f * math.pi * adhesion_const * r_hat  # N

    safe_mag = torch.where(mag_pos, mag, one)
    normal = torch.where(mag_pos[..., None], vector / safe_mag[..., None],
                         torch.zeros_like(vector))
    force = torch.where(alive_bond[..., None], jkr_force[..., None] * normal,
                        torch.zeros_like(vector))
    return force, alive_bond


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


def jkr_substep_aligned(
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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One substep over a window. Returns ``(forces (C, 3), keep (C, W))``:
    the summed pair forces and the surviving eligible set (the next bonds)."""
    if order is not None:
        s_xyzr, s_ids = xyzr[order], ids[order]
    else:
        s_xyzr, s_ids = xyzr, ids
    cand = s_xyzr[pos]  # (C, W, 4)
    cand_id = s_ids[pos]
    self_xyz = xyzr[:, :3]

    delta = cand[..., :3] - self_xyz[:, None, :]
    dist2 = torch.sum(delta * delta, dim=-1)
    r = torch.tensor(radius, dtype=torch.float32)
    pair_ok = valid & (cand_id != ids[:, None]) & alive[:, None]
    eligible = pair_ok & ((dist2 <= r * r) | bond_mask)

    force, survive = _pair_jkr(
        self_xyz[:, None, :], cand[..., :3], xyzr[:, None, 3], cand[..., 3],
        adhesion_const, poisson, youngs, break_d,
    )
    keep = eligible & survive
    forces = torch.sum(torch.where(keep[..., None], force, torch.zeros_like(force)),
                       dim=1)
    return forces, keep


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
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Id-list substep: partner lists -> window mask, one substep, first-K
    compaction back. Returns ``(forces (C, 3), new partner ids (C, K),
    degree (C,))``."""
    s_ids = ids[order] if order is not None else ids
    cand_id = s_ids[pos]
    bond_mask = _is_bonded(partner_ids, cand_id)
    forces, keep = jkr_substep_aligned(
        bond_mask, xyzr, ids, alive, order, pos, valid, radius,
        adhesion_const, poisson, youngs, break_d,
    )
    new_ids, degree = _compact_bonds(cand_id, keep, partner_ids.shape[1])
    return forces, new_ids, degree


def clear_bond_rows(bonds: BondState, rows_to_clear: torch.Tensor) -> BondState:
    """Empty the bond rows of given slots (daughters get fresh graph vertices
    with no edges). Dead partners need no cleanup: their ids never appear in
    a candidate window again."""
    return BondState(partners=bonds.partners,
                     mask=bonds.mask & ~rows_to_clear[:, None])
