"""Spatial domain decomposition of the contact forces with a halo exchange
(port of ``hipsc_abm_tpu/parallel/domain.py``).

The box is split into x-stripes, one per device; each stripe owns the
agents resident in it and computes their contact forces over its own agents
and a one-interaction-reach halo of its neighbours' boundary agents, which
each neighbour sends it (the JAX module's ``ppermute`` ring shifts, here
device copies between the stripes' tensors):

- ``stripe_of`` / ``partition_by_stripe``: stripe assignment and the
  stripe-major ``(n_stripes, per_stripe)`` slot layout (host);
- ``domain_forces``: per stripe, the boundary bands sent to the neighbours
  and the masked all-pairs JKR force (``ops.jkr._pair_jkr``) summed over own
  + halo candidates; a stripe narrower than the reach raises.

This is the decomposition the domain engine grew from
(``parallel.domain_engine``, which adds migration, the full step and the
kernels). The JAX body is XLA, not Pallas, and so is this one: plain
PyTorch on each stripe's device.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from hipsc_abm_tpu_torch.ops.jkr import _pair_jkr
from hipsc_abm_tpu_torch.params import BiologyParams
from hipsc_abm_tpu_torch.parallel.mesh import make_mesh

# the JAX name: a stripe mesh is a list of devices here
make_stripe_mesh = make_mesh


def stripe_of(x: torch.Tensor, box_x: float, n_stripes: int) -> torch.Tensor:
    """Stripe index per agent from its x coordinate."""
    width = box_x / n_stripes
    return torch.clamp((x / width).to(torch.int32), 0, n_stripes - 1)


def partition_by_stripe(
    locations: np.ndarray,
    alive: np.ndarray,
    box_x: float,
    n_stripes: int,
    per_stripe: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side layout: pack agents into (n_stripes, per_stripe) slot blocks
    by stripe (padded; global slot ids retained for validation, -1 in the
    padding)."""
    stripes = np.clip((locations[:, 0] / (box_x / n_stripes)).astype(int), 0, n_stripes - 1)
    out_loc = np.zeros((n_stripes, per_stripe, 3), np.float32)
    out_alive = np.zeros((n_stripes, per_stripe), bool)
    out_gid = np.full((n_stripes, per_stripe), -1, np.int32)
    for s in range(n_stripes):
        idx = np.where(alive & (stripes == s))[0]
        if len(idx) > per_stripe:
            raise ValueError(f"stripe {s} overflow: {len(idx)} > {per_stripe}")
        out_loc[s, : len(idx)] = locations[idx]
        out_alive[s, : len(idx)] = True
        out_gid[s, : len(idx)] = idx
    return out_loc, out_alive, out_gid


def domain_forces(
    locations: Sequence[torch.Tensor],  # per stripe (per_stripe, 3), on its device
    alive: Sequence[torch.Tensor],  # per stripe (per_stripe,)
    radii: Sequence[torch.Tensor],  # per stripe (per_stripe,)
    box_x: float,
    bio: BiologyParams,
) -> List[torch.Tensor]:
    """JKR contact forces under spatial decomposition: per stripe (a list in
    stripe order, each on its stripe's device) the (per_stripe, 3) force
    summed over its own agents and the halos its neighbours send it (agents
    within the interaction reach of the shared edge). The box is not a
    torus: the first and last stripes receive empty halos."""
    n_stripes = len(locations)
    width = box_x / n_stripes
    reach = bio.jkr_radius + 2.0 * bio.jkr_break_band
    if width < reach:
        raise ValueError(
            f"stripe width {width:.1f} um < interaction reach {reach:.1f} um: "
            "pairs spanning a whole stripe would be missed; use fewer stripes "
            "or a larger box")

    def pack(loc, rad, mask):
        """(per_stripe, 5) float32 lanes: xyz, radius, valid."""
        return torch.cat([loc, rad[:, None], mask.to(torch.float32)[:, None]], dim=1)

    bands = []  # (to the left neighbour, to the right neighbour) per stripe
    for s in range(n_stripes):
        loc, alv, rad = locations[s], alive[s], radii[s]
        lo = torch.tensor(s, dtype=torch.float32) * width
        hi = lo + width
        x = loc[:, 0]
        bands.append((pack(loc, rad, alv & (x < (lo + reach).to(x.device))),
                      pack(loc, rad, alv & (x >= (hi - reach).to(x.device)))))

    forces = []
    for s in range(n_stripes):
        loc, alv, rad = locations[s], alive[s], radii[s]
        dev, P = loc.device, loc.shape[0]
        zeros = torch.zeros((P, 5), dtype=torch.float32, device=dev)
        from_left = bands[s - 1][1].to(dev) if s > 0 else zeros
        from_right = bands[s + 1][0].to(dev) if s < n_stripes - 1 else zeros
        cand = torch.cat([pack(loc, rad, alv), from_left, from_right], dim=0)
        cand_loc, cand_rad, cand_valid = cand[:, :3], cand[:, 3], cand[:, 4] > 0.0

        delta = loc[:, None, :] - cand_loc[None, :, :]
        dist2 = torch.sum(delta * delta, dim=-1)
        same = (torch.arange(P, device=dev)[:, None]
                == torch.arange(cand.shape[0], device=dev)[None, :])
        in_radius = dist2 <= np.float32(bio.jkr_radius ** 2)
        pair_ok = alv[:, None] & cand_valid[None, :] & ~same & in_radius
        force, _ = _pair_jkr(loc[:, None, :], cand_loc[None, :, :], rad[:, None],
                             cand_rad[None, :], bio.adhesion_const, bio.poisson, bio.youngs,
                             bio.jkr_break_d)
        forces.append(torch.sum(torch.where(pair_ok[..., None], force, 0.0), dim=1))
    return forces
