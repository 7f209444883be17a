"""FTCS morphogen diffusion on a 2D lattice, with cell coupling (port of
``hipsc_abm_tpu/ops/diffusion.py``).

Clamp to [0, max_concentration], subcycled 5-point Laplacian with reflecting
(Neumann) borders and a short final subcycle, then uniform degradation; plus
the nearest-point sample and the 4-point deposit that couple cells to the
lattice. The deposit's sum onto the lattice adds each point's terms in a
fixed order (``scatter_add_sorted``), so it gives the same bits on the CPU
and on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from . import xla_f32


def diffusion_dts(step_dt: float, diffuse_dt: float) -> np.ndarray:
    """Static subcycle schedule: divmod(step_dt, diffuse_dt) full steps plus
    one remainder step (which runs even when the remainder is zero)."""
    steps, last_dt = divmod(step_dt, diffuse_dt)
    return np.array([diffuse_dt] * int(steps) + [last_dt], dtype=np.float32)


def ftcs_coefficients(dt, diffuse_const: float, spat_res2: float):
    """``(a, b)`` of one subcycle as the TPU kernel takes them
    (``ftcs_diffuse_pallas``): ``a = dt * D / h^2`` and ``b = 1 - 4a``
    in float64, each rounded to float32."""
    a = float(dt) * float(diffuse_const) / float(spat_res2)
    return xla_f32.f32(a), xla_f32.f32(1.0 - 4.0 * a)


def ftcs_subcycle(base: torch.Tensor, a: float, b: float) -> torch.Tensor:
    """One subcycle on the padded lattice: reflect the ghost columns, then
    the ghost rows (corners take already-reflected values), then
    ``b * interior + a * (((down + up) + right) + left)``, the first
    product fused into the sum as XLA:CPU compiles the TPU kernel:
    ``fma(b, interior, a * sum)``."""
    base = torch.cat([base[:, 1:2], base[:, 1:-1], base[:, -2:-1]], dim=1)
    base = torch.cat([base[1:2, :], base[1:-1, :], base[-2:-1, :]], dim=0)
    interior = base[1:-1, 1:-1]
    temp = a * (base[2:, 1:-1] + base[:-2, 1:-1] + base[1:-1, 2:] + base[1:-1, :-2])
    new = xla_f32.fma(interior, b, temp)
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


def deposit_terms(shape, locations: torch.Tensor, amounts: torch.Tensor,
                  spat_res: float):
    """The 4-point deposit's terms (``adjust_morphogens``, reference
    ``cell_methods.py:485-521``): each agent splits its amount equally over
    the surrounding lattice points within ``spat_res`` of it. Returns the
    (4C,) int64 flat point indices, in (slot, corner) order, with
    out-of-range or distant corners at the sentinel ``nx * ny``, and the
    (4C,) contributions. Terms of zero amount go to the sentinel too: they
    add nothing, and the dead slots, which lie at the origin, would
    otherwise pile thousands of zeros onto point 0 (one serial run of the
    card's fixed-order sum)."""
    nx, ny = shape
    # XLA:CPU divides by the constant as a product with its float32 reciprocal
    base = torch.floor(locations[:, :2] * xla_f32.recip(spat_res)).to(torch.int64)  # (C, 2)
    # [[0, 0], [1, 0], [0, 1], [1, 1]], made on the device (no host copy)
    corner = torch.arange(4, dtype=torch.int64, device=locations.device)
    corner_offsets = torch.stack([corner % 2, corner // 2], dim=1)
    points = base[:, None, :] + corner_offsets[None, :, :]  # (C, 4, 2)
    in_bounds = ((points[..., 0] < nx) & (points[..., 1] < ny)
                 & (points >= 0).all(-1))

    point_loc = points.to(locations.dtype) * spat_res
    delta = locations[:, None, :2] - point_loc
    dist = xla_f32.sqrt(xla_f32.fma(delta[..., 1], delta[..., 1],
                                    delta[..., 0] * delta[..., 0]))
    nearby = in_bounds & (dist < spat_res)  # (C, 4)

    total_nearby = nearby.sum(dim=1)
    share = torch.where(total_nearby > 0,
                        amounts / torch.clamp(total_nearby, min=1).to(amounts.dtype),
                        torch.zeros_like(amounts))
    contrib = torch.where(nearby, share[:, None], torch.zeros_like(delta[..., 0]))

    flat_idx = points[..., 0] * ny + points[..., 1]
    flat_idx = torch.where(nearby & (contrib != 0), flat_idx, torch.full_like(flat_idx, nx * ny))
    return flat_idx.reshape(-1), contrib.reshape(-1)


def deposit_morphogen(
    gradient: torch.Tensor,  # (nx, ny)
    locations: torch.Tensor,  # (C, 3) um
    amounts: torch.Tensor,  # (C,) amount per agent (0 for inactive/dead)
    spat_res: float,
) -> torch.Tensor:
    """The 4-point deposit (``deposit_terms``) summed onto the lattice in a
    fixed order (``scatter_add_sorted``: each point's terms added one after
    another in slot order, as the CPU's sequential ``index_add`` adds them),
    on any device."""
    flat_idx, contrib = deposit_terms(gradient.shape, locations, amounts, spat_res)
    return scatter_add_sorted(gradient.reshape(-1), flat_idx, contrib).reshape(gradient.shape)


def scatter_add_sorted(flat: torch.Tensor, idx: torch.Tensor,
                       contrib: torch.Tensor) -> torch.Tensor:
    """The kernel's schedule in plain PyTorch: a stable sort of the point
    indices, then each point's contributions added to it left to right in
    sorted order, one round per position within a point's run (every add
    one float32 add). Equals PyTorch's CPU ``index_add`` bit for bit."""
    P = flat.shape[0]
    sorted_idx, order = torch.sort(idx, stable=True)
    values = contrib[order]
    n = sorted_idx.shape[0]
    pos = torch.arange(n, device=idx.device)
    head = torch.ones(n, dtype=torch.bool, device=idx.device)
    head[1:] = sorted_idx[1:] != sorted_idx[:-1]
    rank = pos - torch.cummax(torch.where(head, pos, 0), dim=0).values
    rank = torch.where(sorted_idx < P, rank, -1)  # the sentinel's terms are dropped
    out = flat.clone()
    for r in range(int(rank.max()) + 1 if n else 0):
        sel = rank == r
        at = sorted_idx[sel]
        out[at] = out[at] + values[sel]
    return out

