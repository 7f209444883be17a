"""FTCS morphogen diffusion on a 2D lattice, with cell coupling (port of
``hipsc_abm_tpu/ops/diffusion.py``).

Clamp to [0, max_concentration], subcycled 5-point Laplacian with reflecting
(Neumann) borders and a short final subcycle, then uniform degradation; plus
the nearest-point sample and the 4-point deposit that couple cells to the
lattice. ``ftcs_diffuse`` here is the plain version of the CUDA FTCS kernel
(``ops.ftcs``).
"""

from __future__ import annotations

import numpy as np
import torch


def diffusion_dts(step_dt: float, diffuse_dt: float) -> np.ndarray:
    """Static subcycle schedule: divmod(step_dt, diffuse_dt) full steps plus
    one remainder step (which runs even when the remainder is zero)."""
    steps, last_dt = divmod(step_dt, diffuse_dt)
    return np.array([diffuse_dt] * int(steps) + [last_dt], dtype=np.float32)


def ftcs_coefficients(dt, diffuse_const: float, spat_res2: float):
    """``(a, b)`` of one subcycle, rounded in float32 as the JAX scan
    computes them: ``a = dt * D / h^2``, ``b = 1 - 4a``."""
    a = np.float32(np.float32(dt) * np.float32(diffuse_const)) / np.float32(spat_res2)
    b = np.float32(1.0) - np.float32(4.0) * a
    return float(a), float(b)


def ftcs_subcycle(base: torch.Tensor, a: float, b: float) -> torch.Tensor:
    """One subcycle on the padded lattice: reflect the ghost columns, then
    the ghost rows (corners take already-reflected values), then
    ``b * interior + a * (((down + up) + right) + left)``."""
    base = torch.cat([base[:, 1:2], base[:, 1:-1], base[:, -2:-1]], dim=1)
    base = torch.cat([base[1:2, :], base[1:-1, :], base[-2:-1, :]], dim=0)
    interior = base[1:-1, 1:-1]
    temp = a * (base[2:, 1:-1] + base[:-2, 1:-1] + base[1:-1, 2:] + base[1:-1, :-2])
    new = b * interior + temp
    mid = torch.cat([base[1:-1, :1], new, base[1:-1, -1:]], dim=1)
    return torch.cat([base[:1, :], mid, base[-1:, :]], dim=0)


def ftcs_diffuse(
    gradient: torch.Tensor,  # (nx, ny)
    dts: np.ndarray,  # (S,) subcycle dt schedule
    diffuse_const: float,
    spat_res2: float,
    max_concentration: float,
    degradation: float,
) -> torch.Tensor:
    """One simulation step of subcycled FTCS diffusion + degradation."""
    base = torch.nn.functional.pad(gradient.clamp(0.0, max_concentration), (1, 1, 1, 1))
    for dt in np.asarray(dts, dtype=np.float32):
        base = ftcs_subcycle(base, *ftcs_coefficients(dt, diffuse_const, spat_res2))
    return base[1:-1, 1:-1] * (1.0 - degradation)


def sample_concentration(gradient: torch.Tensor, locations: torch.Tensor,
                         spat_res: float) -> torch.Tensor:
    """Nearest-gridpoint concentration per agent (``get_concentration``,
    reference ``cell_methods.py:470-483``): idx = ceil(floor(2 x / h) / 2)."""
    half = torch.floor(2.0 * locations[:, :2] / spat_res).to(torch.int64)
    idx = -torch.div(-half, 2, rounding_mode="floor")  # integer ceil(half / 2)
    nx, ny = gradient.shape
    x = idx[:, 0].clamp(0, nx - 1)
    y = idx[:, 1].clamp(0, ny - 1)
    return gradient[x, y]


def deposit_morphogen(
    gradient: torch.Tensor,  # (nx, ny)
    locations: torch.Tensor,  # (C, 3) um
    amounts: torch.Tensor,  # (C,) amount per agent (0 for inactive/dead)
    spat_res: float,
) -> torch.Tensor:
    """4-point deposit (``adjust_morphogens``, reference
    ``cell_methods.py:485-521``): each agent splits its amount equally over
    the surrounding lattice points within ``spat_res`` of it. The scatter-add
    writes out-of-range points to one extra sentinel entry, then drops it."""
    nx, ny = gradient.shape
    base = torch.floor(locations[:, :2] / spat_res).to(torch.int64)  # (C, 2)
    # [[0, 0], [1, 0], [0, 1], [1, 1]], made on the device (no host copy)
    corner = torch.arange(4, dtype=torch.int64, device=locations.device)
    corner_offsets = torch.stack([corner % 2, corner // 2], dim=1)
    points = base[:, None, :] + corner_offsets[None, :, :]  # (C, 4, 2)
    in_bounds = ((points[..., 0] < nx) & (points[..., 1] < ny)
                 & (points >= 0).all(-1))

    point_loc = points.to(locations.dtype) * spat_res
    delta = locations[:, None, :2] - point_loc
    dist = torch.sqrt(torch.sum(delta * delta, dim=-1))
    nearby = in_bounds & (dist < spat_res)  # (C, 4)

    total_nearby = nearby.sum(dim=1)
    share = torch.where(total_nearby > 0,
                        amounts / torch.clamp(total_nearby, min=1).to(amounts.dtype),
                        torch.zeros_like(amounts))
    contrib = torch.where(nearby, share[:, None], torch.zeros_like(delta[..., 0]))

    flat_idx = points[..., 0] * ny + points[..., 1]
    flat_idx = torch.where(nearby, flat_idx, torch.full_like(flat_idx, nx * ny))
    flat = torch.cat([gradient.reshape(-1),
                      torch.zeros(1, dtype=gradient.dtype, device=gradient.device)])
    flat = flat.index_add(0, flat_idx.reshape(-1), contrib.reshape(-1))
    return flat[:-1].reshape(nx, ny)
