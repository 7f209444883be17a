"""The contact substep's plain version (of the port's kernel
``csrc/contact.cu``).

Port of ``hipsc_abm_tpu/ops/pallas_contact.py`` ``contact_substep_pallas``
(B6), the id-list contact substep: per sorted row, walk the stencil runs of
the build-time window (3 in 2D, 9 in 3D), test each candidate (fresh
contact within the search radius or already bonded), apply the JKR pair
law, and emit the force summed in the TPU kernel's grouping
(``neighbors.Grouping``), the untruncated degree and the first K survivors
in the TPU kernel's chunk-major walk order as the new partner list. The
plain version is the windowed ``ops.jkr.jkr_substep`` over the same runs.

Inputs are in sorted-row order: ``xyzr`` (C, 4) float32 ``[x, y, z, r]``,
``ids`` (C,) int32, ``alive`` (C,) bool, ``bounds`` (C, 6) or (C, 18) int32
per-row run bounds (``neighbors.run_bounds``) and ``partners`` (C, K) int32
partner ids, ``NO_BOND`` empty.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import jkr as jkr_ops
from .neighbors import Grouping, bounds_window, plain_lanes


def contact_substep_plain(
    xyzr, ids, alive, bounds, partners, *, radius, adhesion_const, poisson,
    youngs, break_d, uniform_radius: Optional[float] = None, width=None,
    grouping: Optional[Grouping] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch contact substep: returns ``(force (C, 3) float32,
    degree (C,) int32, new partners (C, K) int32)``. ``uniform_radius``
    selects the uniform law, None the general law, as in the kernel.
    ``width``: ``neighbors.bounds_window``'s. The forces are summed in the
    TPU kernels' grouping (``neighbors.Grouping``; default: the rows are
    the colony's sorted order, ``grouping_of_bounds``)."""
    pos, valid = bounds_window(bounds, width)
    force, new_partners, degree = jkr_ops.jkr_substep(
        partners, xyzr, ids, alive, None, pos, valid, radius,
        adhesion_const, poisson, youngs, break_d, uniform_radius,
        plain_lanes(bounds, pos, grouping),
    )
    return force, degree, new_partners

