"""FTCS diffusion on the card: one persistent kernel (``csrc/ftcs.cu``) runs
the whole subcycle schedule of a step.

Port of ``hipsc_abm_tpu/ops/pallas_diffusion.py`` ``ftcs_diffuse_pallas``
(B5). The plain version is ``ops.diffusion.ftcs_diffuse``. The kernel is
launched cooperatively, one CTA per tile of the lattice; each CTA advances
its tile plus a halo of ``T`` cells by ``T`` subcycles in shared memory,
writes the tile back, and waits at a grid barrier before the next ``T``
(temporal blocking). ``ftcs_plan`` chooses the tiles and ``T``. The clip on
entry and the degradation on exit are plain elementwise ops around the
launch.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from hipsc_abm_tpu_torch import kernels
from hipsc_abm_tpu_torch.ops import diffusion as diffusion_ops

# threads of a CTA as (columns, rows) (csrc/ftcs.cu kCols, kRows)
FTCS_THREADS = (32, 16)
# the largest halo (subcycles between grid barriers) a plan considers
MAX_HALO = 16
# the cost of one reload (grid barrier, global write and read of the tile),
# in lane-slots of stencil work
BLOCK_COST_SLOTS = 16384


@dataclasses.dataclass(frozen=True)
class FtcsPlan:
    """An (nx, ny) lattice cut into ``grid_rows`` x ``grid_cols`` tiles of
    ``tile_rows`` x ``tile_cols`` cells (the last of a row or column may be
    short), one CTA each, with a halo of ``halo`` cells: ``halo`` subcycles
    per grid barrier."""

    nx: int
    ny: int
    tile_rows: int
    tile_cols: int
    grid_rows: int
    grid_cols: int
    halo: int

    @property
    def ctas(self) -> int:
        return self.grid_rows * self.grid_cols

    @property
    def region(self) -> tuple:
        """Rows and columns of the largest tile plus halo, clipped to the
        lattice (the kernel's shared buffers)."""
        return (min(self.tile_rows + 2 * self.halo, self.nx),
                min(self.tile_cols + 2 * self.halo, self.ny))

    @property
    def smem_bytes(self) -> int:
        """Two float32 buffers of the region."""
        rows, cols = self.region
        return 2 * 4 * rows * cols

    def tiles(self):
        """Each tile's ``(r0, r1, c0, c1)``, in CTA order."""
        return [(i * self.tile_rows, min((i + 1) * self.tile_rows, self.nx),
                 j * self.tile_cols, min((j + 1) * self.tile_cols, self.ny))
                for i in range(self.grid_rows) for j in range(self.grid_cols)]

    def cost_per_subcycle(self) -> float:
        """Modelled time of one subcycle, in lane-slots: the shrinking
        regions of ``halo`` subcycles, the reload of tile plus halo and one
        reload's fixed cost, spread over the ``halo`` subcycles."""
        def slots(grow):
            return _lane_slots(min(self.tile_rows + 2 * grow, self.nx),
                               min(self.tile_cols + 2 * grow, self.ny))
        h = self.halo
        work = sum(slots(h - k) for k in range(1, h + 1))
        return (work + slots(h) + BLOCK_COST_SLOTS) / h


def _lane_slots(rows: int, cols: int) -> int:
    """Thread-slots one pass over a rows x cols rectangle takes: each CTA
    pass covers FTCS_THREADS[1] rows of FTCS_THREADS[0] columns."""
    tc, tr = FTCS_THREADS
    return -(-rows // tr) * tr * -(-cols // tc) * tc


@functools.lru_cache(maxsize=64)
def ftcs_plan(nx: int, ny: int, n_sm: int, smem_bytes: int, halo: int = 0) -> FtcsPlan:
    """The tiling of an (nx, ny) lattice for at most ``n_sm`` CTAs of at
    most ``smem_bytes`` of shared memory each that minimises the modelled
    time per subcycle (``halo`` > 0 fixes the halo). Raises when no tiling
    fits."""
    best = None
    halos = [halo] if halo > 0 else range(1, MAX_HALO + 1)
    for n_rows in range(1, min(nx, n_sm) + 1):
        th = -(-nx // n_rows)
        gx = -(-nx // th)  # no empty row of tiles
        tw = -(-ny // min(ny, n_sm // gx))
        gy = -(-ny // tw)
        for h in halos:
            plan = FtcsPlan(nx, ny, th, tw, gx, gy, h)
            if plan.smem_bytes > smem_bytes:
                continue
            key = (plan.cost_per_subcycle(), plan.ctas, h)
            if best is None or key < best[0]:
                best = (key, plan)
    if best is None:
        raise ValueError(f"ftcs_plan: no tiling of a {nx} x {ny} lattice over {n_sm} CTAs "
                         f"fits {smem_bytes} bytes of shared memory per CTA")
    return best[1]


def ftcs_schedule(dts: np.ndarray, diffuse_const: float, spat_res2: float):
    """``(steps, a_main, b_main, a_last, b_last)`` of a ``diffusion_dts``
    schedule: every subcycle but the last takes ``dts[0]``; raises on any
    other schedule."""
    dts = np.asarray(dts, dtype=np.float32)
    if dts.ndim != 1 or (dts.shape[0] > 1 and not np.all(dts[:-1] == dts[0])):
        raise ValueError(f"ftcs_schedule: expected uniform subcycles and one remainder, "
                         f"got {dts!r}")
    if dts.shape[0] == 0:
        return 0, 0.0, 1.0, 0.0, 1.0
    return (dts.shape[0], *diffusion_ops.ftcs_coefficients(dts[0], diffuse_const, spat_res2),
            *diffusion_ops.ftcs_coefficients(dts[-1], diffuse_const, spat_res2))


def ftcs_diffuse_cuda(
    gradient: torch.Tensor,  # (nx, ny)
    dts: np.ndarray,  # (S,) subcycle dt schedule
    diffuse_const: float,
    spat_res2: float,
    max_concentration: float,
    degradation: float,
    halo: int = 0,
) -> torch.Tensor:
    """One step of subcycled FTCS diffusion + degradation. A CPU tensor runs
    the plain version; a CUDA tensor launches the kernel once for all
    subcycles (or raises). ``halo`` > 0 fixes the plan's halo."""
    if gradient.device.type == "cpu":
        return diffusion_ops.ftcs_diffuse(gradient, dts, diffuse_const, spat_res2,
                                          max_concentration, degradation)
    nx, ny = gradient.shape
    kernels.check_cuda("gradient", gradient, torch.float32, (nx, ny))
    steps, a_main, b_main, a_last, b_last = ftcs_schedule(dts, diffuse_const, spat_res2)
    buf0 = gradient.clamp(0.0, max_concentration)
    if steps == 0:
        return buf0 * (1.0 - degradation)
    limits = kernels.device_limits()
    plan = ftcs_plan(nx, ny, limits["n_sm"], limits["smem_optin"], halo)
    buf1 = torch.empty_like(buf0)
    arrived = torch.zeros((1,), dtype=torch.int32, device=gradient.device)
    kernels.launch("hipsc_ftcs_diffuse", buf0.data_ptr(), buf1.data_ptr(),
                   arrived.data_ptr(), nx, ny, plan.tile_rows, plan.tile_cols,
                   plan.grid_rows, plan.grid_cols, plan.halo, steps,
                   a_main, b_main, a_last, b_last)
    kernels.count_launch("ftcs_diffuse")
    out = buf1 if -(-steps // plan.halo) % 2 else buf0
    return out * (1.0 - degradation)
