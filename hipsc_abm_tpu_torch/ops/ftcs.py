"""FTCS diffusion on the card: the subcycle kernel (``csrc/ftcs.cu``)
driven over the whole subcycle schedule.

Port of ``hipsc_abm_tpu/ops/pallas_diffusion.py`` ``ftcs_diffuse_pallas``
(B5). The plain version is ``ops.diffusion.ftcs_diffuse``. The kernel reads
the unpadded (nx, ny) lattice and clamps each neighbour index into it, which
is exactly the reference's ghost-ring reflection for the five-point stencil;
two buffers ping-pong, one launch per subcycle. The clip on entry and the
degradation on exit are plain elementwise ops around the launches.
"""

from __future__ import annotations

import numpy as np
import torch

from hipsc_abm_tpu_torch import kernels
from hipsc_abm_tpu_torch.ops import diffusion as diffusion_ops


def ftcs_subcycle_cuda(src: torch.Tensor, dst: torch.Tensor, a: float,
                       b: float) -> None:
    """One subcycle ``src -> dst`` on (nx, ny) float32 CUDA lattices."""
    nx, ny = src.shape
    kernels.check_cuda("src", src, torch.float32, (nx, ny))
    kernels.check_cuda("dst", dst, torch.float32, (nx, ny))
    kernels.launch("hipsc_ftcs_subcycle", src.data_ptr(), dst.data_ptr(),
                   nx, ny, a, b)
    kernels.launch_counts["ftcs_subcycle"] += 1


def ftcs_diffuse_cuda(
    gradient: torch.Tensor,  # (nx, ny)
    dts: np.ndarray,  # (S,) subcycle dt schedule
    diffuse_const: float,
    spat_res2: float,
    max_concentration: float,
    degradation: float,
) -> torch.Tensor:
    """One step of subcycled FTCS diffusion + degradation. A CPU tensor runs
    the plain version; a CUDA tensor launches one kernel per subcycle (or
    raises)."""
    if gradient.device.type == "cpu":
        return diffusion_ops.ftcs_diffuse(gradient, dts, diffuse_const, spat_res2,
                                          max_concentration, degradation)
    src = gradient.clamp(0.0, max_concentration).contiguous()
    dst = torch.empty_like(src)
    for dt in np.asarray(dts, dtype=np.float32):
        a, b = diffusion_ops.ftcs_coefficients(dt, diffuse_const, spat_res2)
        ftcs_subcycle_cuda(src, dst, a, b)
        src, dst = dst, src
    return src * (1.0 - degradation)
