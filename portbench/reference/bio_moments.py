"""Neighbourhood moments for the biology phases: the plain version (of the
port's kernel ``csrc/bio_moments.cu``).

Port of ``hipsc_abm_tpu/ops/pallas_bio.py`` ``bio_reduce_pallas`` (B4); the
plain version is the twin of ``hipsc_abm_tpu/engine.py``
``make_bio_moments_xla``. The step builds its radius-15 neighbour graph once,
from pre-division positions, and every biology phase reads moments of it,
re-masked by current liveness.

Inputs are in sorted-row order, as the step holds them:

- ``pos0``: (C, 4) float32 build-time positions ``[x, y, z, 0]``
  (``positions``, made once per step);
- ``alive``: (C,) bool current liveness;
- ``bounds``: per-row run bounds of the build-time grid, (C, 6) int32 in 2D
  (3 runs) or (C, 18) in 3D (9 runs);
- ``loc1``: (C, 3) float32 current positions, read in modes motility and
  full;
- ``f0``, ``f1``, ``f2``: (C,) int32 features; pathway reads ``f0``,
  motility and full all three.

Inputs a mode does not read may be ``None``. A candidate of a row's runs
counts when both it and the row are alive now: ``neighbors.run_bounds``
gives rows dead at the build empty runs, so every candidate inside a run
was alive at the build, agents killed since drop out through ``alive``, and
daughters born since (alive, empty runs) neither count nor are counted.
Output: (C, 16) float32, lanes as in ``csrc/bio_moments.cu``; the z
displacement lanes 6 and 10 are 0 in 2D.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import xla_f32
from .neighbors import Grouping, bounds_window, grouped_sum, plain_lanes, run_count

OUT_LANES = 16
MODES = {"count": 0, "pathway": 1, "motility": 2, "full": 3}
# the optional inputs each mode reads
_READS = {"count": (), "pathway": ("f0",), "motility": ("loc1", "f0", "f1", "f2"),
          "full": ("loc1", "f0", "f1", "f2")}


def positions(loc0: torch.Tensor) -> torch.Tensor:
    """The kernel's (C, 4) float32 build-time position rows ``[x, y, z, 0]``
    from (C, 3) positions."""
    return torch.nn.functional.pad(loc0.to(torch.float32), (0, 1))


def _inputs(mode, loc1, f0, f1, f2) -> dict:
    """The optional inputs ``mode`` reads; raises on an unknown mode or a
    missing input."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    given = dict(loc1=loc1, f0=f0, f1=f1, f2=f2)
    missing = [k for k in _READS[mode] if given[k] is None]
    if missing:
        raise ValueError(f"mode {mode!r} reads {', '.join(missing)}")
    return {k: given[k] for k in _READS[mode]}


def _within(dd: torch.Tensor, radius2: float, dims: int, mask: torch.Tensor) -> torch.Tensor:
    """Whether each (row minus candidate) offset ``dd`` lies within the
    radius, its squared distance summed as the kernel (and XLA:CPU's build
    of the TPU kernel) sums it, ``xla_f32.sq_sum``. That sum is formed only
    for the offsets of ``mask`` whose float64 squared distance lies within
    2^-20 of the radius; elsewhere the float64 one decides, as the float32
    one would."""
    d64 = (dd[..., :dims].double() ** 2).sum(dim=-1)
    out = d64 <= radius2
    at = (mask & ((d64 - radius2).abs() <= radius2 * 2.0**-20)).nonzero(as_tuple=True)
    if at[0].numel():
        e = dd[at]
        out[at] = xla_f32.sq_sum(e[:, 0], e[:, 1], e[:, 2] if dims == 3 else None) <= radius2
    return out


def bio_moments_plain(pos0, alive, bounds, loc1=None, f0=None, f1=None, f2=None, *,
                      radius: float, mode: str = "full", width=None,
                      grouping: Optional[Grouping] = None) -> torch.Tensor:
    """Plain PyTorch moments over the padded window of the run bounds
    (``width``: ``neighbors.bounds_window``'s). The displacement sums add
    each row's neighbours in the TPU kernel's grouping
    (``neighbors.grouped_sum`` under ``grouping``, as in
    ``ops.contact``), as the kernel does; the counts and feature sums are
    integers, exact in any order."""
    given = _inputs(mode, loc1, f0, f1, f2)
    dims = 3 if run_count(bounds) == 9 else 2
    C = pos0.shape[0]
    pos, valid = bounds_window(bounds, width)
    own = torch.arange(C, device=pos0.device)[:, None]
    cand = pos0[pos]  # (C, W, 4)
    r = np.float32(radius)
    m = valid & (pos != own) & alive[pos] & alive[:, None]
    m &= _within(pos0[:, None, :3] - cand[..., :3], float(r * r), dims, m)
    mf = m.to(torch.float32)
    out = torch.zeros((C, OUT_LANES), dtype=torch.float32, device=pos0.device)
    out[:, 0] = mf.sum(dim=1)
    if "f0" in given:
        cf0 = f0.to(torch.float32)[pos]
        if mode in ("pathway", "full"):
            out[:, 1] = (mf * cf0).sum(dim=1)
            out[:, 2] = (mf * cf0 * cf0).sum(dim=1)
    if "loc1" in given:
        cf1, cf2 = (f.to(torch.float32)[pos] for f in (f1, f2))
        disp = loc1[pos][..., :dims] - loc1[:, None, :dims]
        a = mf * (cf1 > cf0).to(torch.float32)
        b = mf * (cf2 != 0).to(torch.float32)
        out[:, 3] = a.sum(dim=1)
        lanes = plain_lanes(bounds, pos, grouping)
        out[:, 4:4 + dims] = grouped_sum(disp, a > 0, lanes)
        out[:, 7] = b.sum(dim=1)
        out[:, 8:8 + dims] = grouped_sum(disp, b > 0, lanes)
    return out

