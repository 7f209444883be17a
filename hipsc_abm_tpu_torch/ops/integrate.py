"""Overdamped (Stokes) force integration with box clamping (port of
``hipsc_abm_tpu/ops/integrate.py``), and the substep's update: CUDA kernel
(``csrc/update.cu``) and its plain version. Locations in um, forces in N,
dt in s.

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

import numpy as np
import torch

from hipsc_abm_tpu_torch import kernels
from hipsc_abm_tpu_torch.ops import xla_f32


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


def stokes_integrate_unfused(locations, radii, jkr_forces, motility_forces, alive, stokes,
                             size, dt) -> torch.Tensor:
    """``stokes_integrate`` with each operation rounded on its own, as the
    port computed it before it mirrored XLA:CPU: the all-pairs (dense)
    contact path's update (``engine._physics_scan_dense``). That path is
    the calibrator's and is held to the windowed paths and to the JAX
    package only to rounding; its gradient checks' finite differences were
    set against this rounding (``tests/test_torch_calibrate.py``)."""
    stokes_friction = 6.0 * math.pi * stokes * (radii / 1e6)  # um -> m
    safe_friction = torch.where(radii > 0, stokes_friction,
                                torch.ones_like(stokes_friction))
    velocity = (jkr_forces + motility_forces) / safe_friction[:, None]  # m/s
    new_locations = locations + float(dt) * velocity * 1e6  # m -> um
    new_locations = torch.minimum(new_locations.clamp(min=0.0), size[None, :])
    return torch.where(alive[:, None], new_locations, locations)


def update_plain(loc, rad, force, mot, alive, ref, size, *, stokes: float, dt: float,
                 folded: bool, threshold: float, counted: Optional[torch.Tensor] = None,
                 scratch: Optional[torch.Tensor] = None,
                 xyzr: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
    """One substep's update: ``(new locations (C, 3), largest squared move
    (), largest squared drift (), stale ())`` over the ``alive`` rows, or
    the rows ``counted``. The drift is from ``ref``, where the window was
    built, and ``stale`` the next substep's drift test, ``drift^2 >
    threshold``. The squared norms are ``xla_f32.row_sq_sum``'s, as the JAX
    engine's probes compute them. Given ``scratch`` (a (32,) uint8 row of
    ``update_scratch``), the kernel's words are written into it, detached:
    the move's and the drift's float32 bits by max, and the flag. The
    values come back as computed, not as views of the scratch (as
    ``update_cuda`` returns them): autograd saves the flag (a checkpointed
    substep's input, ``torch.where``'s condition), and the later substeps'
    writes to the scratch would change a view under it. Given ``xyzr``
    ((C, 4) float32), the new locations beside the radii are written into
    it (``ops.jkr.pack_physics``'s rows)."""
    new = stokes_integrate(loc, rad, force, mot, alive, stokes, size, dt, folded)
    if xyzr is not None:
        xyzr.copy_(torch.cat([new, rad[:, None]], dim=1))
    zero = torch.zeros((), dtype=torch.float32, device=loc.device)
    rows = alive if counted is None else counted
    move2 = torch.where(rows, xla_f32.row_sq_sum(new - loc), zero).max()
    drift2 = torch.where(rows, xla_f32.row_sq_sum(new - ref), zero).max()
    stale = drift2 > threshold
    if scratch is not None:
        words = scratch[:16].view(torch.int32)
        maxima = torch.stack([move2, drift2]).detach().view(torch.int32)
        torch.maximum(words[:2], maxima, out=words[:2])
        words[3] = stale.to(torch.int32)
    return new, move2, drift2, stale


# bytes of one substep's row of the scan's scratch: the update's largest
# squared move and drift (float32 bits, atomicMax), the CTAs' ticket and the
# stale flag (bytes 0-15), then the contact kernels' probes (bytes 16-27,
# ``contact_probes``) and 4 bytes of padding
SCRATCH_BYTES = 32


def update_scratch(n_substeps: int, device) -> torch.Tensor:
    """The kernels' zeroed scratch for ``n_substeps`` substeps, (n, 32)
    uint8: one row per substep, zeroed once (one memset) where the scan
    starts."""
    return torch.zeros((n_substeps, SCRATCH_BYTES), dtype=torch.uint8, device=device)


def contact_probes(scratch: torch.Tensor) -> torch.Tensor:
    """The contact kernels' probes in one scratch row (a (32,) uint8 row of
    ``update_scratch``): a (3,) int32 view of the substep's widest run,
    widest row and largest degree, which the contact kernels reduce into
    (``csrc/probes.cuh``)."""
    return scratch[16:28].view(torch.int32)


def update_cuda(loc, rad, force, mot, alive, ref, size, *, stokes: float, dt: float,
                folded: bool, threshold: float, counted: Optional[torch.Tensor] = None,
                scratch: Optional[torch.Tensor] = None,
                xyzr: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
    """The substep's update (``update_plain``'s outputs). A CPU tensor runs
    the plain version; a CUDA tensor launches the kernel (or raises), which
    writes the new locations, the packed rows into ``xyzr`` where given,
    and, in ``scratch`` (one (32,) uint8 row of ``update_scratch``, zero
    before the launch), the maxima and the flag; the move and the flag come
    back as views of it, so nothing is read on the host. Counted as
    ``update``."""
    if loc.device.type == "cpu":
        return update_plain(loc, rad, force, mot, alive, ref, size, stokes=stokes, dt=dt,
                            folded=folded, threshold=threshold, counted=counted,
                            scratch=scratch, xyzr=xyzr)
    C = loc.shape[0]
    for name, t in (("loc", loc), ("force", force), ("mot", mot), ("ref", ref)):
        kernels.check_cuda(name, t, torch.float32, (C, 3))
    kernels.check_cuda("rad", rad, torch.float32, (C,))
    kernels.check_cuda("alive", alive, torch.bool, (C,))
    kernels.check_cuda("size", size, torch.float32, (3,))
    if counted is not None:
        kernels.check_cuda("counted", counted, torch.bool, (C,))
    if scratch is None:
        raise ValueError("update_cuda: a zeroed scratch row (update_scratch) is needed")
    kernels.check_cuda("scratch", scratch, torch.uint8, (SCRATCH_BYTES,))
    if xyzr is not None:
        kernels.check_cuda("xyzr", xyzr, torch.float32, (C, 4))
    new = torch.empty_like(loc)
    step = xla_f32.fold(dt, 1e6) if folded else xla_f32.f32(dt)
    kernels.launch("hipsc_update", loc.data_ptr(), rad.data_ptr(), force.data_ptr(),
                   mot.data_ptr(), alive.data_ptr(),
                   None if counted is None else counted.data_ptr(), ref.data_ptr(),
                   size.data_ptr(), new.data_ptr(), None if xyzr is None else xyzr.data_ptr(),
                   scratch.data_ptr(), C,
                   friction_const(stokes), step, int(folded), float(np.float32(threshold)))
    kernels.count_launch("update")
    maxima = scratch[:8].view(torch.float32)
    return new, maxima[0], maxima[1], scratch[12:13].view(torch.bool)[0]
