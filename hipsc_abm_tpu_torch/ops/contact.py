"""The contact substep: CUDA kernel (``csrc/contact.cu``) and its plain
version.

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

import math
from typing import Optional, Tuple

import numpy as np
import torch

from hipsc_abm_tpu_torch import kernels
from hipsc_abm_tpu_torch.ops import jkr as jkr_ops
from hipsc_abm_tpu_torch.ops import xla_f32
from hipsc_abm_tpu_torch.ops.neighbors import (Grouping, bounds_window, grouping_args,
                                                plain_lanes)


def contact_substep_plain(
    xyzr, ids, alive, bounds, partners, *, radius, adhesion_const, poisson,
    youngs, break_d, uniform_radius: Optional[float] = None, width=None,
    grouping: Optional[Grouping] = None, probes: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch contact substep: returns ``(force (C, 3) float32,
    degree (C,) int32, new partners (C, K) int32)``. ``uniform_radius``
    selects the uniform law, None the general law, as in the kernel.
    ``width``: ``neighbors.bounds_window``'s. The forces are summed in the
    TPU kernels' grouping (``neighbors.Grouping``; default: the rows are
    the colony's sorted order, ``grouping_of_bounds``). Given ``probes``
    ((3,) int32), the widest run, widest row and largest degree are
    max-reduced into it (``fold_probes``), as the kernel reduces them."""
    pos, valid = bounds_window(bounds, width)
    force, new_partners, degree = jkr_ops.jkr_substep(
        partners, xyzr, ids, alive, None, pos, valid, radius,
        adhesion_const, poisson, youngs, break_d, uniform_radius,
        plain_lanes(bounds, pos, grouping),
    )
    if probes is not None:
        fold_probes(probes, bounds, degree)
    return force, degree, new_partners


def pair_law_args(radius, adhesion_const, poisson, youngs, break_d,
                  uniform_radius):
    """The contact kernels' pair-law constants (``csrc/jkr_pair.cuh``
    ``PairLaw``, the table pointer aside), rounded to float32 as the plain
    versions round them (``ops.jkr.uniform_law``, ``ops.jkr._pair_general``):
    ``(radius2, break_d, uniform, two_r, inv_scale, fpre, scale_c)``."""
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    r = np.float32(radius)
    radius2 = float(r * r)
    e_hat = 1.0 / (2.0 * (1.0 - poisson**2) / youngs)
    scale_c = ((math.pi * adhesion_const) / e_hat) ** (2.0 / 3.0)
    if uniform_radius is not None:
        law = jkr_ops.uniform_law(uniform_radius, adhesion_const, poisson, youngs)
        uni = (1, law["two_r"], law["inv_scale"], law["fpre"])
    else:
        uni = (0, 0.0, 0.0, f32(math.pi * adhesion_const))
    return (radius2, f32(break_d), *uni, f32(scale_c))


# the general law's cut (csrc/jkr_pair.cuh kCullSlack, kCullMinRadius,
# kCullMaxRadius): the relative slack of the cut and the row radii (um) for
# which its margin argument is made
CULL_SLACK = np.float32(1.0 + 1.0 / 4096.0)
CULL_RADII = (np.float32(1e-12), np.float32(1e12))


def cull_reach(ri: torch.Tensor, law_args: tuple) -> torch.Tensor:
    """Plain mirror of the general-law kernels' per-row reach
    (``csrc/jkr_pair.cuh`` ``cull_reach``), in float32 with the kernel's
    operations in its order: ``ri + |break_d| scale_c cbrt(ri / 1e6) 1e6``
    (um), +inf where ``ri`` lies outside ``CULL_RADII`` or is NaN.
    ``law_args``: ``pair_law_args``'s tuple. The cube root is the CPU's
    ``pow``, the kernel's CUDA ``powf``; each is within 2 ulp, which the
    cut's margin allows (``csrc/jkr_pair.cuh``): the law itself takes
    glibc's."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    break_d, scale_c = law_args[1], law_args[6]
    ri = ri.to(torch.float32)
    coeff = f32(np.float32(abs(np.float32(break_d))) * np.float32(scale_c))
    band = coeff * torch.pow(ri / f32(1e6), float(np.float32(1.0) / np.float32(3.0))) * f32(1e6)
    inside = (ri >= f32(CULL_RADII[0])) & (ri <= f32(CULL_RADII[1]))
    return torch.where(inside, ri + band, f32(np.inf))


def certainly_breaks(reach: torch.Tensor, rj: torch.Tensor,
                     dist2: torch.Tensor) -> torch.Tensor:
    """Plain mirror of ``csrc/jkr_pair.cuh`` ``certainly_breaks``: whether
    the general law certainly breaks the pair of a row of reach ``reach``
    (``cull_reach``) and a candidate of radius ``rj`` at squared distance
    ``dist2`` (float32, ``dx*dx + dy*dy + dz*dz`` rounded after each
    operation). The kernels skip such a pair before the law."""
    cut = (reach + rj.to(torch.float32)) * torch.tensor(CULL_SLACK)
    return (rj > 0) & (dist2 > cut * cut)


def fold_probes(probes: torch.Tensor, bounds: torch.Tensor, degree: torch.Tensor) -> None:
    """Plain mirror of the contact kernels' probe reduction
    (``csrc/probes.cuh``): ``probes``, a (3,) int32 tensor, takes in place
    its maximum with the widest run and the widest row of ``bounds`` (dead
    rows' runs are empty) and the largest ``degree``."""
    widths = torch.clamp(bounds[:, 1::2] - bounds[:, 0::2], min=0)
    got = torch.stack([widths.max(), widths.sum(dim=1).max(), degree.max()])
    torch.maximum(probes, got.to(torch.int32), out=probes)


def check_probes(probes: Optional[torch.Tensor]):
    """The kernels' probe pointer: null without ``probes``, else the (3,)
    int32 tensor's, checked."""
    if probes is None:
        return None
    kernels.check_cuda("probes", probes, torch.int32, (3,))
    return probes.data_ptr()


# rows per CTA of the kernel (csrc/contact.cu kThreads)
ROWS_PER_CTA = 128


def contact_layout(K: int) -> dict:
    """The kernel's dynamic shared memory: the CTA's partner block read in
    and the new lists written out, ``ROWS_PER_CTA`` rows of an odd ``pitch``
    each. Returns ``pitch`` and ``smem_bytes``."""
    pitch = K | 1
    return dict(pitch=pitch, smem_bytes=2 * ROWS_PER_CTA * pitch * 4)


def contact_substep_cuda(
    xyzr, ids, alive, bounds, partners, *, radius, adhesion_const, poisson,
    youngs, break_d, uniform_radius: Optional[float] = None, width=None,
    grouping: Optional[Grouping] = None, probes: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The contact substep. A CPU tensor runs the plain version (``width``
    is the plain version's); a CUDA tensor launches the kernel (or raises,
    also when the CTA's partner block does not fit in the card's shared
    memory). ``grouping`` as in the plain version. Given ``probes`` ((3,)
    int32), the widest run, widest row and largest degree are max-reduced
    into it. The launch counts as ``contact_substep`` in 2D and
    ``contact_substep_3d`` in 3D."""
    kw = dict(radius=radius, adhesion_const=adhesion_const, poisson=poisson,
              youngs=youngs, break_d=break_d, uniform_radius=uniform_radius,
              grouping=grouping)
    if xyzr.device.type == "cpu":
        return contact_substep_plain(xyzr, ids, alive, bounds, partners, **kw, width=width,
                                     probes=probes)
    C, K = partners.shape
    kernels.check_cuda("xyzr", xyzr, torch.float32, (C, 4))
    kernels.check_cuda("ids", ids, torch.int32, (C,))
    kernels.check_cuda("alive", alive, torch.bool, (C,))
    n_runs = kernels.run_count(bounds)
    kernels.check_cuda("bounds", bounds, torch.int32, (C, 2 * n_runs))
    kernels.check_cuda("partners", partners, torch.int32, (C, K))
    if K < 1:
        raise ValueError("contact_substep_cuda: bond capacity must be >= 1")
    layout = contact_layout(K)
    smem_limit = kernels.device_limits()["smem_optin"]
    if layout["smem_bytes"] > smem_limit:
        raise ValueError(
            f"contact_substep_cuda: bond capacity K={K} needs {layout['smem_bytes']} bytes "
            f"of shared memory per {ROWS_PER_CTA} rows, the card allows {smem_limit}")
    force = torch.empty((C, 3), dtype=torch.float32, device=xyzr.device)
    degree = torch.empty((C,), dtype=torch.int32, device=xyzr.device)
    new_partners = torch.empty((C, K), dtype=torch.int32, device=xyzr.device)
    kernels.launch(
        "hipsc_contact_substep",
        xyzr.data_ptr(), ids.data_ptr(), alive.data_ptr(), bounds.data_ptr(),
        partners.data_ptr(), force.data_ptr(), degree.data_ptr(),
        new_partners.data_ptr(), C, K, n_runs, layout["pitch"], layout["smem_bytes"],
        *pair_law_args(radius, adhesion_const, poisson, youngs, break_d,
                       uniform_radius),
        xla_f32.rsqrt_table(xyzr.device).data_ptr(), *grouping_args(bounds, grouping),
        check_probes(probes),
    )
    kernels.count_launch(kernels.counted_name("contact_substep", n_runs))
    return force, degree, new_partners
