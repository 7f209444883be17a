"""Sorted-uniform-grid fixed-radius neighbour search (port of
``hipsc_abm_tpu/ops/neighbors.py``).

Agents are sorted by row-major flat bin id with the agent id as tie-break
(the canonical ``(flat bin, id)`` order; dead slots carry a sentinel bin id
and sort last). With the last spatial axis minor in the flat id, the 3x3
stencil around a bin is three runs of consecutive flat ids in 2D (the 3x3x3
stencil nine runs in 3D), so each run's members are one contiguous slice
``[lo, hi)`` of the sorted order. The per-row run bounds
(``sorted_run_bounds_from_flat``) are what the CUDA kernels walk; the
padded candidate windows (``_run_windows``) serve the plain versions and
the parity tests.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Static description of a uniform bin lattice for one search radius:
    bin edge = search radius, a +1 index offset and padded border bins so
    the stencil never wraps for in-box agents. ``run_cap`` is the padded
    width of one stencil run in a candidate window (``_run_windows``)."""

    cell_size: float
    nx: int
    ny: int
    nz: int
    two_d: bool
    run_cap: int

    @classmethod
    def from_box(
        cls,
        size: Tuple[float, float, float],
        radius: float,
        run_cap: int,
    ) -> "GridSpec":
        nx = int(math.ceil(size[0] / radius)) + 3
        ny = int(math.ceil(size[1] / radius)) + 3
        two_d = size[2] == 0
        nz = 1 if two_d else int(math.ceil(size[2] / radius)) + 3
        return cls(cell_size=float(radius), nx=nx, ny=ny, nz=nz, two_d=two_d,
                   run_cap=int(run_cap))

    @property
    def num_bins(self) -> int:
        return self.nx * self.ny * self.nz

    @property
    def run_offsets(self) -> Tuple[Tuple[int, ...], ...]:
        """Stencil decomposition into contiguous 3-bin runs: offsets in the
        major axes; the minor axis spans -1..+1 within each run."""
        if self.two_d:
            return tuple((dx,) for dx in (-1, 0, 1))
        return tuple((dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1))

    @property
    def flat_run_offsets(self) -> Tuple[int, ...]:
        """Flat-bin-id offset of each run's centre: a run covers
        ``[flat + off - 1, flat + off + 2)``."""
        if self.two_d:
            return tuple(dx * self.ny for (dx,) in self.run_offsets)
        return tuple(
            (dx * self.ny + dy) * self.nz for (dx, dy) in self.run_offsets
        )

    @property
    def window(self) -> int:
        """Static candidate-window width W = n_runs * run_cap."""
        return len(self.run_offsets) * self.run_cap


class Grid(NamedTuple):
    """Built spatial index over one snapshot of agent locations."""

    order: torch.Tensor  # (C,) int64 slots sorted by (flat bin, id), dead last
    sorted_flat: torch.Tensor  # (C,) int64 flat bin id per sorted position
    coords: torch.Tensor  # (C, 3) int64 per-slot bin coordinates


def _bin_coords(spec: GridSpec, locations: torch.Tensor) -> torch.Tensor:
    coords = torch.floor(locations / spec.cell_size).to(torch.int64) + 1
    dims = torch.tensor([spec.nx, spec.ny, spec.nz], dtype=torch.int64,
                        device=locations.device)
    return torch.minimum(coords.clamp(min=0), dims - 1)


def dead_sentinel(spec: GridSpec) -> int:
    """Flat id of dead slots: beyond every live id and every stencil probe a
    live row can make, so run-interval tests never match dead candidates."""
    reach = spec.ny if spec.two_d else (spec.ny + 1) * spec.nz
    return spec.num_bins + reach + 3


def flat_bin_ids(spec: GridSpec, locations: torch.Tensor,
                 alive: torch.Tensor) -> torch.Tensor:
    """Row-major flat bin id per agent (int64); dead slots get the sentinel."""
    coords = _bin_coords(spec, locations)
    if spec.two_d:
        flat = coords[:, 0] * spec.ny + coords[:, 1]
    else:
        flat = (coords[:, 0] * spec.ny + coords[:, 1]) * spec.nz + coords[:, 2]
    return torch.where(alive, flat, torch.full_like(flat, dead_sentinel(spec)))


def build_grid(spec: GridSpec, locations: torch.Tensor, ids: torch.Tensor,
               alive: torch.Tensor) -> Grid:
    """Sort agents into the canonical ``(flat bin, agent id)`` order.

    JAX's 2-key ``lax.sort`` becomes one ``torch.sort`` of the int64 key
    ``flat << 32 | id`` (both fit 31 bits). The sort is stable, so dead
    slots that share a stale id keep slot order."""
    flat = flat_bin_ids(spec, locations, alive)
    key = (flat << 32) | (ids.to(torch.int64) & 0xFFFFFFFF)
    order = torch.sort(key, stable=True).indices
    return Grid(order=order, sorted_flat=flat[order],
                coords=_bin_coords(spec, locations))


def _bin_table(spec: GridSpec, sorted_flat: torch.Tensor) -> torch.Tensor:
    """``table[b]`` = number of live agents in bins < b = the sorted position
    where bin b starts (histogram + exclusive cumsum; sentinel ids drop)."""
    nb1 = spec.num_bins + 1
    counts = torch.bincount(sorted_flat[sorted_flat < nb1], minlength=nb1)
    return torch.cumsum(counts, 0) - counts


def sorted_run_bounds_from_flat(spec: GridSpec,
                                sorted_flat: torch.Tensor) -> torch.Tensor:
    """Absolute run bounds ``[s0, e0, s1, e1, ...]`` per sorted row, int32:
    run r covers the flat bins ``[f + flat_run_offsets[r] - 1, +3)``. In 2D
    (3 runs) the table is (C, 8), two zero columns padding it to the JAX
    package's layout; in 3D (9 runs) it is (C, 18). Rows dead at build time
    get the empty interval ``[capacity, 0)`` in every run."""
    table = _bin_table(spec, sorted_flat)
    f = sorted_flat
    cols = []
    for off in spec.flat_run_offsets:
        lo = torch.clamp(f + off - 1, 0, spec.num_bins - 3)
        cols.append(table[lo])
        cols.append(table[lo + 3])
    capacity = sorted_flat.shape[0]
    empty = [capacity, 0] * len(cols[::2])
    if spec.two_d:
        zero = torch.zeros_like(cols[0])
        cols += [zero, zero]
        empty += [0, 0]
    bounds = torch.stack(cols, dim=1).to(torch.int32)
    empty = torch.tensor(empty, dtype=torch.int32, device=bounds.device)
    dead = (f >= spec.num_bins)[:, None]
    return torch.where(dead, empty, bounds)


def run_bounds(spec: GridSpec, sorted_flat: torch.Tensor) -> torch.Tensor:
    """The kernels' (C, 2 * n_runs) int32 view of
    ``sorted_run_bounds_from_flat``: ``[lo_r, hi_r)`` for runs r = 0..2 in
    2D, 0..8 in 3D."""
    n = 2 * len(spec.flat_run_offsets)
    return sorted_run_bounds_from_flat(spec, sorted_flat)[:, :n].contiguous()


def bounds_window(bounds: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Padded candidate window from per-row run bounds: ``(pos (C, W) int64
    sorted positions, valid (C, W) bool)``, runs in order and ascending
    position within a run — the kernels' walk order. ``W`` is the run count
    times the widest run, so no candidate is ever cut (one host read of the
    widest run)."""
    capacity = bounds.shape[0]
    b = bounds.to(torch.int64).view(capacity, -1, 2)
    lo, hi = b[..., 0], b[..., 1]
    width = int(torch.clamp(hi - lo, min=0).max()) if capacity else 0
    k = torch.arange(max(width, 1), dtype=torch.int64, device=bounds.device)
    pos = lo[:, :, None] + k
    valid = pos < hi[:, :, None]
    pos = torch.clamp(pos, 0, max(capacity - 1, 0))
    return pos.reshape(capacity, -1), valid.reshape(capacity, -1)


def window_from_grid(spec: GridSpec, grid: Grid):
    """Candidate window over an existing Grid: ``(pos, valid,
    max_run_count)`` of sorted positions."""
    return _run_windows(spec, grid)


def _run_windows(spec: GridSpec, grid: Grid):
    """Per-agent sorted-position windows of ``run_cap`` entries per run."""
    capacity = grid.order.shape[0]
    device = grid.order.device
    k = torch.arange(spec.run_cap, dtype=torch.int64, device=device)
    coords = grid.coords
    table = _bin_table(spec, grid.sorted_flat)

    starts = []
    counts = []
    for off in spec.run_offsets:
        if spec.two_d:
            lo = (coords[:, 0] + off[0]) * spec.ny + (coords[:, 1] - 1)
        else:
            lo = ((coords[:, 0] + off[0]) * spec.ny + (coords[:, 1] + off[1])) * spec.nz + (
                coords[:, 2] - 1
            )
        lo = torch.clamp(lo, 0, spec.num_bins - 3)
        start = table[lo]
        starts.append(start)
        counts.append(table[lo + 3] - start)

    start = torch.stack(starts, dim=1)  # (C, n_runs)
    count = torch.stack(counts, dim=1)
    pos = start[:, :, None] + k[None, None, :]
    valid = k[None, None, :] < count[:, :, None]
    W = spec.window
    return (
        torch.clamp(pos, 0, capacity - 1).reshape(capacity, W),
        valid.reshape(capacity, W),
        count.max(),
    )


# ---------------------------------------------------------------------------
# the framework's host search (``Simulation.get_neighbors``)
# ---------------------------------------------------------------------------


def candidate_window(spec: GridSpec, grid: Grid):
    """The padded candidate window of every slot: ``(cand_idx (C, W) slots,
    cand_valid (C, W), max_run_count)``. Rows of dead slots hold garbage and
    are masked by the consumer."""
    pos, valid, max_run = _run_windows(spec, grid)
    return grid.order[pos], valid, max_run


def neighbor_mask(locations: torch.Tensor, alive: torch.Tensor, cand_idx: torch.Tensor,
                  cand_valid: torch.Tensor, radius: float) -> torch.Tensor:
    """Candidates within ``radius`` (inclusive, float32), self excluded;
    each undirected edge appears in both endpoints' rows."""
    capacity = locations.shape[0]
    self_idx = torch.arange(capacity, dtype=cand_idx.dtype, device=cand_idx.device)[:, None]
    delta = locations[cand_idx] - locations[:, None, :]
    dist2 = (delta * delta).sum(dim=-1)
    r = torch.tensor(radius, dtype=locations.dtype, device=locations.device)
    mask = cand_valid & (cand_idx != self_idx) & (dist2 <= r * r)
    return mask & alive[:, None]


def neighbor_search(spec: GridSpec, locations: torch.Tensor, alive: torch.Tensor,
                    radius: float):
    """``(cand_idx, mask, max_run_count)`` of a fixed-radius search in which
    slot = agent id; ``spec.run_cap`` must cover the widest run."""
    ids = torch.arange(locations.shape[0], dtype=torch.int32, device=locations.device)
    grid = build_grid(spec, locations, ids, alive)
    cand_idx, cand_valid, max_run = candidate_window(spec, grid)
    return cand_idx, neighbor_mask(locations, alive, cand_idx, cand_valid, radius), max_run


def brute_force_mask(locations: torch.Tensor, alive: torch.Tensor, radius: float) -> torch.Tensor:
    """O(n^2) dense adjacency, the oracle of the grid search."""
    delta = locations[:, None, :] - locations[None, :, :]
    dist2 = (delta * delta).sum(dim=-1)
    n = locations.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=locations.device)
    r = torch.tensor(radius, dtype=locations.dtype, device=locations.device)
    return (dist2 <= r * r) & ~eye & alive[:, None] & alive[None, :]
