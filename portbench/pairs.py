"""The benchmark's own count of the pairs a step must look at: ordered pairs
of live agents within a radius, by a uniform grid of cells one radius wide
(a pair lies in the 3^dims cells around an agent's own). It reads only the
agents' positions, never the port's bins, capacities or skin, so a state
and any re-padding of it give the same count.
"""

from __future__ import annotations

import itertools

import torch


def ordered_pairs_within(locations: torch.Tensor, alive: torch.Tensor, radius: float,
                         dims: int) -> int:
    """The number of ordered pairs (i, j), i != j, of live agents whose
    float64 distance is at most ``radius``."""
    loc = locations[alive][:, :dims].to(torch.float64)
    n = loc.shape[0]
    if n < 2:
        return 0
    cell = torch.floor(loc / radius).to(torch.int64)
    cell = cell - cell.min(dim=0).values + 1
    extent = cell.max(dim=0).values + 2
    stride = torch.ones(dims, dtype=torch.int64, device=loc.device)
    for d in range(dims - 2, -1, -1):
        stride[d] = stride[d + 1] * extent[d + 1]
    key = (cell * stride).sum(dim=1)
    key_sorted, order = torch.sort(key)
    loc_sorted = loc[order]
    width = int(torch.unique_consecutive(key_sorted, return_counts=True)[1].max())
    r2 = float(radius) ** 2
    total = torch.zeros((), dtype=torch.int64, device=loc.device)
    for offset in itertools.product((-1, 0, 1), repeat=dims):
        shift = (torch.tensor(offset, dtype=torch.int64, device=loc.device) * stride).sum()
        lo = torch.searchsorted(key_sorted, key_sorted + shift, right=False)
        hi = torch.searchsorted(key_sorted, key_sorted + shift, right=True)
        own = torch.arange(n, device=loc.device)
        for j in range(width):
            idx = lo + j
            ok = idx < hi
            idx = torch.where(ok, idx, own)
            d2 = ((loc_sorted[idx] - loc_sorted) ** 2).sum(dim=1)
            total += (ok & (idx != own) & (d2 <= r2)).sum()
    return int(total)
