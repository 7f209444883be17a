"""Neighbourhood moments for the biology phases: CUDA kernel
(``csrc/bio_moments.cu``) and its plain version.

Port of ``hipsc_abm_tpu/ops/pallas_bio.py`` ``bio_reduce_pallas`` (B4); the
plain version is the twin of ``hipsc_abm_tpu/engine.py``
``make_bio_moments_xla``. The step builds its radius-15 neighbour graph once,
from pre-division positions, and every biology phase reads moments of it,
re-masked by current liveness.

Inputs are in sorted-row order: ``pack`` (C, 8) float32
``[x0, y0, x1, y1, f0, f1, f2, 0]`` (build-time and current positions and
three per-agent features), ``flat`` (C,) int32 build-time flat bin ids with
agents dead *now* set to the sentinel, and ``bounds`` (C, 6) int32 per-row
run bounds of the build-time grid. Output: (C, 16) float32, lanes as in
``csrc/bio_moments.cu``.
"""

from __future__ import annotations

import numpy as np
import torch

from hipsc_abm_tpu_torch import kernels
from hipsc_abm_tpu_torch.ops.neighbors import bounds_window

OUT_LANES = 16
MODES = {"count": 0, "pathway": 1, "motility": 2, "full": 3}


def bio_moments_plain(pack, flat, bounds, *, num_bins: int, radius: float,
                      mode: str = "full") -> torch.Tensor:
    """Plain PyTorch moments over the padded window of the run bounds."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    C = pack.shape[0]
    pos, valid = bounds_window(bounds)
    own = torch.arange(C, device=pack.device)[:, None]
    cand = pack[pos]  # (C, W, 8)
    d0 = cand[..., :2] - pack[:, None, :2]
    dist2 = torch.sum(d0 * d0, dim=-1)
    r = torch.tensor(radius, dtype=torch.float32)
    m = (valid & (pos != own) & (flat[pos] < num_bins) & (dist2 <= r * r)
         & (flat < num_bins)[:, None])
    mf = m.to(torch.float32)
    out = torch.zeros((C, OUT_LANES), dtype=torch.float32, device=pack.device)
    out[:, 0] = mf.sum(dim=1)
    cf0, cf1, cf2 = cand[..., 4], cand[..., 5], cand[..., 6]
    if mode in ("pathway", "full"):
        out[:, 1] = (mf * cf0).sum(dim=1)
        out[:, 2] = (mf * cf0 * cf0).sum(dim=1)
    if mode in ("motility", "full"):
        disp = cand[..., 2:4] - pack[:, None, 2:4]
        a = mf * (cf1 > cf0).to(torch.float32)
        b = mf * (cf2 != 0).to(torch.float32)
        out[:, 3] = a.sum(dim=1)
        out[:, 4:6] = (a[..., None] * disp).sum(dim=1)
        out[:, 7] = b.sum(dim=1)
        out[:, 8:10] = (b[..., None] * disp).sum(dim=1)
    return out


def bio_moments_cuda(pack, flat, bounds, *, num_bins: int, radius: float,
                     mode: str = "full") -> torch.Tensor:
    """The moments. A CPU tensor runs the plain version; a CUDA tensor
    launches the kernel (or raises)."""
    if pack.device.type == "cpu":
        return bio_moments_plain(pack, flat, bounds, num_bins=num_bins,
                                 radius=radius, mode=mode)
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    C = pack.shape[0]
    kernels.check_cuda("pack", pack, torch.float32, (C, 8))
    kernels.check_cuda("flat", flat, torch.int32, (C,))
    kernels.check_cuda("bounds", bounds, torch.int32, (C, 6))
    out = torch.empty((C, OUT_LANES), dtype=torch.float32, device=pack.device)
    r = np.float32(radius)
    kernels.launch("hipsc_bio_moments", pack.data_ptr(), flat.data_ptr(),
                   bounds.data_ptr(), out.data_ptr(), C, int(num_bins),
                   float(r * r), MODES[mode])
    kernels.launch_counts["bio_moments"] += 1
    return out
