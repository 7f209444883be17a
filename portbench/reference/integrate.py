"""Overdamped (Stokes) force integration with box clamping (port of
``hipsc_abm_tpu/ops/integrate.py``), and the substep's update: the plain
version (of the port's kernel ``csrc/update.cu``). Locations in um, forces
in N, dt in s.

The arithmetic is the JAX package's as XLA:CPU compiles its step
(``ops.xla_f32``): the friction ``6 pi stokes (r / 1e6)`` is ``r`` times one
folded float32 constant, and the update ``loc + (dt v) 1e6`` is one fused
multiply-add, ``fma(dt v, 1e6, loc)``. Where dt is a constant of the
compiled program (the first substep of the TPU path's scan, whose dt
XLA sees as a literal) XLA folds ``dt 1e6`` too: ``fma(v, dt 1e6, loc)``
(``folded``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import xla_f32


def friction_const(stokes: float) -> float:
    """float32 ``6 pi stokes * 1e-6``: the friction per um of radius, as
    XLA folds ``6 pi stokes (r / 1e6)``."""
    return xla_f32.fold(6.0 * math.pi * stokes, 1e-6)


def friction(radii: torch.Tensor, stokes) -> torch.Tensor:
    """``6 pi stokes (radii / 1e6)`` as XLA:CPU computes it: ``radii``
    times one folded constant, or, for a ``stokes`` tensor (a traced value,
    which XLA does not fold), ``(6 pi stokes) (radii * 1e-6)``."""
    if isinstance(stokes, torch.Tensor):
        return (stokes * xla_f32.f32(6.0 * math.pi)) * (radii * xla_f32.f32(1e-6))
    return radii * friction_const(stokes)


def stokes_integrate(
    locations: torch.Tensor,  # (C, 3) um
    radii: torch.Tensor,  # (C,) um
    jkr_forces: torch.Tensor,  # (C, 3) N
    motility_forces: torch.Tensor,  # (C, 3) N
    alive: torch.Tensor,  # (C,) bool
    stokes: float,
    size: torch.Tensor,  # (3,) um box
    dt: float,  # seconds (a float32 value)
    folded: bool = False,
) -> torch.Tensor:
    """velocity = F_total / (6 pi mu r); new_loc = loc + dt * v, clamped to
    the box (reference ``cell_backend.py:153-170``). Dead slots carry radius
    0; their friction is replaced by 1 so the masked branch never divides by
    zero. ``folded``: dt was a literal of the JAX program (module
    docstring)."""
    stokes_friction = friction(radii, stokes)
    safe_friction = torch.where(radii > 0, stokes_friction,
                                torch.ones_like(stokes_friction))
    velocity = (jkr_forces + motility_forces) / safe_friction[:, None]  # m/s
    if folded:
        new_locations = xla_f32.fma(velocity, xla_f32.fold(dt, 1e6), locations)
    else:
        new_locations = xla_f32.fma(velocity * xla_f32.f32(dt), 1e6, locations)
    zero = torch.zeros((), dtype=new_locations.dtype, device=new_locations.device)
    new_locations = torch.minimum(torch.where(new_locations > 0, new_locations, zero),
                                  size[None, :])
    return torch.where(alive[:, None], new_locations, locations)


def update_plain(loc, rad, force, mot, alive, ref, size, *, stokes: float, dt: float,
                 folded: bool, threshold: float, counted: Optional[torch.Tensor] = None,
                 scratch=None) -> Tuple[torch.Tensor, ...]:
    """One substep's update: ``(new locations (C, 3), largest squared move
    (), largest squared drift (), stale ())`` over the ``alive`` rows, or
    the rows ``counted``. The drift is from ``ref``, where the window was
    built, and ``stale`` the next substep's drift test, ``drift^2 >
    threshold``. The squared norms are ``xla_f32.row_sq_sum``'s, as the JAX
    engine's probes compute them. ``scratch`` is the kernel's and is not
    read here."""
    del scratch
    new = stokes_integrate(loc, rad, force, mot, alive, stokes, size, dt, folded)
    zero = torch.zeros((), dtype=torch.float32, device=loc.device)
    rows = alive if counted is None else counted
    move2 = torch.where(rows, xla_f32.row_sq_sum(new - loc), zero).max()
    drift2 = torch.where(rows, xla_f32.row_sq_sum(new - ref), zero).max()
    return new, move2, drift2, drift2 > threshold

