"""Neighbourhood moments for the biology phases: CUDA kernel
(``csrc/bio_moments.cu``) and its plain version.

Port of ``hipsc_abm_tpu/ops/pallas_bio.py`` ``bio_reduce_pallas`` (B4); the
plain version is the twin of ``hipsc_abm_tpu/engine.py``
``make_bio_moments_xla``. The step builds its radius-15 neighbour graph once,
from pre-division positions, and every biology phase reads moments of it,
re-masked by current liveness.

Inputs are in sorted-row order: ``pack`` (``make_pack``: build-time and
current positions and three per-agent features), ``flat`` (C,) int32
build-time flat bin ids with agents dead *now* set to the sentinel, and
``bounds`` per-row run bounds of the build-time grid, (C, 6) int32 in 2D
(3 runs) or (C, 18) in 3D (9 runs). The pack is (C, 8) float32
``[x0, y0, x1, y1, f0, f1, f2, 0]`` in 2D and (C, 12)
``[x0, y0, z0, f0, x1, y1, z1, f1, f2, 0, 0, 0]`` in 3D (the layout and its
reason are in ``csrc/bio_moments.cu``). Output: (C, 16) float32, lanes as in
``csrc/bio_moments.cu``; the z displacement lanes 6 and 10 are 0 in 2D.
"""

from __future__ import annotations

import numpy as np
import torch

from hipsc_abm_tpu_torch import kernels
from hipsc_abm_tpu_torch.ops.neighbors import bounds_window

OUT_LANES = 16
MODES = {"count": 0, "pathway": 1, "motility": 2, "full": 3}
# pack lanes of (build-time position, current position, features) per
# dimensionality, keyed by the run count of the bounds
_PACK_LANES = {
    3: dict(width=8, loc0=(0, 1), loc1=(2, 3), f=(4, 5, 6)),
    9: dict(width=12, loc0=(0, 1, 2), loc1=(4, 5, 6), f=(3, 7, 8)),
}


def make_pack(loc0, loc1, f0, f1, f2, two_d: bool) -> torch.Tensor:
    """The kernel's pack from build-time positions ``loc0`` and current
    positions ``loc1`` (both (C, 3)) and three (C,) features."""
    lanes = _PACK_LANES[3 if two_d else 9]
    dims = len(lanes["loc0"])
    pack = torch.zeros((loc0.shape[0], lanes["width"]), dtype=torch.float32,
                       device=loc0.device)
    pack[:, list(lanes["loc0"])] = loc0[:, :dims]
    pack[:, list(lanes["loc1"])] = loc1[:, :dims]
    pack[:, list(lanes["f"])] = torch.stack([f0, f1, f2], dim=1).to(torch.float32)
    return pack


def bio_moments_plain(pack, flat, bounds, *, num_bins: int, radius: float,
                      mode: str = "full") -> torch.Tensor:
    """Plain PyTorch moments over the padded window of the run bounds."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    lanes = _PACK_LANES[kernels.run_count(bounds)]
    C = pack.shape[0]
    pos, valid = bounds_window(bounds)
    own = torch.arange(C, device=pack.device)[:, None]
    cand = pack[pos]  # (C, W, width)
    dist2 = None
    for lane in lanes["loc0"]:  # summed in axis order, as the kernel sums
        d = cand[..., lane] - pack[:, None, lane]
        dist2 = d * d if dist2 is None else dist2 + d * d
    r = torch.tensor(radius, dtype=torch.float32)
    m = (valid & (pos != own) & (flat[pos] < num_bins) & (dist2 <= r * r)
         & (flat < num_bins)[:, None])
    mf = m.to(torch.float32)
    out = torch.zeros((C, OUT_LANES), dtype=torch.float32, device=pack.device)
    out[:, 0] = mf.sum(dim=1)
    cf0, cf1, cf2 = (cand[..., lane] for lane in lanes["f"])
    if mode in ("pathway", "full"):
        out[:, 1] = (mf * cf0).sum(dim=1)
        out[:, 2] = (mf * cf0 * cf0).sum(dim=1)
    if mode in ("motility", "full"):
        loc1 = list(lanes["loc1"])
        disp = cand[..., loc1] - pack[:, None, loc1]
        a = mf * (cf1 > cf0).to(torch.float32)
        b = mf * (cf2 != 0).to(torch.float32)
        dims = len(loc1)
        out[:, 3] = a.sum(dim=1)
        out[:, 4:4 + dims] = (a[..., None] * disp).sum(dim=1)
        out[:, 7] = b.sum(dim=1)
        out[:, 8:8 + dims] = (b[..., None] * disp).sum(dim=1)
    return out


def bio_moments_cuda(pack, flat, bounds, *, num_bins: int, radius: float,
                     mode: str = "full") -> torch.Tensor:
    """The moments. A CPU tensor runs the plain version; a CUDA tensor
    launches the kernel (or raises). The launch counts as ``bio_moments``
    in 2D and ``bio_moments_3d`` in 3D."""
    if pack.device.type == "cpu":
        return bio_moments_plain(pack, flat, bounds, num_bins=num_bins,
                                 radius=radius, mode=mode)
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    n_runs = kernels.run_count(bounds)
    C = pack.shape[0]
    kernels.check_cuda("pack", pack, torch.float32, (C, _PACK_LANES[n_runs]["width"]))
    kernels.check_cuda("flat", flat, torch.int32, (C,))
    kernels.check_cuda("bounds", bounds, torch.int32, (C, 2 * n_runs))
    out = torch.empty((C, OUT_LANES), dtype=torch.float32, device=pack.device)
    r = np.float32(radius)
    kernels.launch("hipsc_bio_moments", pack.data_ptr(), flat.data_ptr(),
                   bounds.data_ptr(), out.data_ptr(), C, int(num_bins),
                   float(r * r), MODES[mode], n_runs)
    kernels.launch_counts[kernels.counted_name("bio_moments", n_runs)] += 1
    return out
