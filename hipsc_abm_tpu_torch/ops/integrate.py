"""Overdamped (Stokes) force integration with box clamping (port of
``hipsc_abm_tpu/ops/integrate.py``). Locations in um, forces in N, dt in s."""

from __future__ import annotations

import math

import torch


def stokes_integrate(
    locations: torch.Tensor,  # (C, 3) um
    radii: torch.Tensor,  # (C,) um
    jkr_forces: torch.Tensor,  # (C, 3) N
    motility_forces: torch.Tensor,  # (C, 3) N
    alive: torch.Tensor,  # (C,) bool
    stokes: float,
    size: torch.Tensor,  # (3,) um box
    dt: float,  # seconds (a float32 value)
) -> torch.Tensor:
    """velocity = F_total / (6 pi mu r); new_loc = loc + dt * v, clamped to
    the box (reference ``cell_backend.py:153-170``). Dead slots carry radius
    0; their friction is replaced by 1 so the masked branch never divides by
    zero."""
    stokes_friction = 6.0 * math.pi * stokes * (radii / 1e6)  # um -> m
    safe_friction = torch.where(radii > 0, stokes_friction,
                                torch.ones_like(stokes_friction))
    velocity = (jkr_forces + motility_forces) / safe_friction[:, None]  # m/s
    new_locations = locations + float(dt) * velocity * 1e6  # m -> um
    new_locations = torch.minimum(new_locations.clamp(min=0.0), size[None, :])
    return torch.where(alive[:, None], new_locations, locations)
