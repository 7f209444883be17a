"""Colony statistics for calibration and replicate studies (port of
``hipsc_abm_tpu/calibrate.py``'s built-in statistics; the fitting itself is
not ported yet).

Each statistic takes a solo port ``CellState`` (a replicate of an
ensemble: ``EnsembleEngine.replicate``) and returns a 0-d float32 tensor
on the state's device.
"""

from __future__ import annotations

import torch

from hipsc_abm_tpu_torch.engine import CellState


def radius_of_gyration(state: CellState) -> torch.Tensor:
    """RMS distance of alive cells from the colony's center of mass (um) —
    the standard compaction statistic for adhesion/motility calibration."""
    locs = state.arrays["locations"]
    alive = state.alive
    n = torch.clamp(alive.sum(), min=1)
    com = torch.where(alive[:, None], locs, 0.0).sum(dim=0) / n
    r2 = torch.where(alive, ((locs - com) ** 2).sum(dim=-1), 0.0).sum() / n
    return torch.sqrt(r2)


def gata6_high_fraction(state: CellState) -> torch.Tensor:
    """Fraction of alive cells with GATA6 > NANOG — the fate statistic the
    FDS probabilities control."""
    high = state.alive & (state.arrays["GATA6"] > state.arrays["NANOG"])
    return (high.sum() / torch.clamp(state.alive.sum(), min=1)).to(torch.float32)
