"""FTCS morphogen diffusion on a 2D lattice, with cell coupling (port of
``hipsc_abm_tpu/ops/diffusion.py``).

Clamp to [0, max_concentration], subcycled 5-point Laplacian with reflecting
(Neumann) borders and a short final subcycle, then uniform degradation; plus
the nearest-point sample and the 4-point deposit that couple cells to the
lattice. ``ftcs_diffuse`` here is the plain version of the CUDA FTCS kernel
(``ops.ftcs``). The deposit's sum onto the lattice runs, on the card, a
kernel that adds in a fixed order (``csrc/deposit.cu``,
``scatter_add_cuda``), so the card's lattice is bit-equal to the CPU's.
"""

from __future__ import annotations

import numpy as np
import torch

from hipsc_abm_tpu_torch import kernels


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
    flat_idx = torch.where(nearby & (contrib != 0), flat_idx, torch.full_like(flat_idx, nx * ny))
    return flat_idx.reshape(-1), contrib.reshape(-1)


def deposit_morphogen(
    gradient: torch.Tensor,  # (nx, ny)
    locations: torch.Tensor,  # (C, 3) um
    amounts: torch.Tensor,  # (C,) amount per agent (0 for inactive/dead)
    spat_res: float,
) -> torch.Tensor:
    """The 4-point deposit (``deposit_terms``) summed onto the lattice by
    ``scatter_add_cuda``: on the CPU PyTorch's sequential ``index_add``, on
    the card the fixed-order kernel, bit-equal to it."""
    flat_idx, contrib = deposit_terms(gradient.shape, locations, amounts, spat_res)
    return scatter_add_cuda(gradient.reshape(-1), flat_idx, contrib).reshape(gradient.shape)


def scatter_add_plain(flat: torch.Tensor, idx: torch.Tensor,
                      contrib: torch.Tensor) -> torch.Tensor:
    """``flat`` (P,) plus each ``contrib[i]`` at ``idx[i]``, entries at
    ``idx == P`` (the sentinel) dropped: PyTorch's ``index_add``, which on
    the CPU adds the sources one after another in the order of ``idx``."""
    ext = torch.cat([flat, torch.zeros(1, dtype=flat.dtype, device=flat.device)])
    return ext.index_add(0, idx, contrib)[:-1]


def scatter_add_sorted(flat: torch.Tensor, idx: torch.Tensor,
                       contrib: torch.Tensor) -> torch.Tensor:
    """The kernel's schedule in plain PyTorch: a stable sort of the point
    indices, then each point's contributions added to it left to right in
    sorted order, one round per position within a point's run (every add
    one float32 add, as the kernel's). Equals ``scatter_add_plain`` bit for
    bit on the CPU."""
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


def scatter_add_cuda(flat: torch.Tensor, idx: torch.Tensor,
                     contrib: torch.Tensor) -> torch.Tensor:
    """The deposit's sum: ``flat`` (P,) float32 plus each ``contrib[i]``
    (float32) at ``idx[i]`` (int64 in [0, P], P the dropped sentinel). A CPU
    tensor runs the plain version (``index_add``); a CUDA tensor sorts the
    indices stably and launches the fixed-order kernel (or raises), whose
    result is bit-equal to the CPU's. Counts as ``deposit``."""
    if flat.device.type == "cpu":
        return scatter_add_plain(flat, idx, contrib)
    (P,), (n,) = flat.shape, idx.shape
    if P >= 2**31 - 1:
        raise ValueError(f"scatter_add_cuda: {P} lattice points exceed int32")
    kernels.check_cuda("flat", flat, torch.float32, (P,))
    kernels.check_cuda("idx", idx, torch.int64, (n,))
    kernels.check_cuda("contrib", contrib, torch.float32, (n,))
    sorted_idx, order = torch.sort(idx.to(torch.int32), stable=True)
    out = flat.clone()
    kernels.launch("hipsc_deposit", sorted_idx.data_ptr(), order.data_ptr(),
                   contrib.data_ptr(), out.data_ptr(), n, P)
    kernels.count_launch("deposit")
    return out
