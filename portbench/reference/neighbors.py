"""Sorted-uniform-grid fixed-radius neighbour search (port of
``hipsc_abm_tpu/ops/neighbors.py``).

Agents are sorted by row-major flat bin id with the agent id as tie-break
(the canonical ``(flat bin, id)`` order; dead slots carry a sentinel bin id
and sort last). With the last spatial axis minor in the flat id, the 3x3
stencil around a bin is three runs of consecutive flat ids in 2D (the 3x3x3
stencil nine runs in 3D), so each run's members are one contiguous slice
``[lo, hi)`` of the sorted order. The plain versions walk the per-row run
bounds (``run_bounds``) as padded windows (``bounds_window``) and add a
row's float sums in the TPU kernels' grouping (``Grouping``,
``grouped_sum``), which depends on where the rows lie in the whole
colony's sorted order.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch

from . import xla_f32


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Static description of a uniform bin lattice for one search radius:
    bin edge = search radius, a +1 index offset and padded border bins so
    the stencil never wraps for in-box agents. ``run_cap`` is the padded
    width of one stencil run in a candidate window (0 here: the windows
    take their width from the data)."""

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
    # the division by the bin size as XLA:CPU compiles it: a product with
    # the float32 reciprocal
    coords = torch.floor(locations * xla_f32.recip(spec.cell_size)).to(torch.int64) + 1
    for axis, n in enumerate((spec.nx, spec.ny, spec.nz)):
        coords[:, axis].clamp_(0, n - 1)
    return coords


def dead_sentinel(spec: GridSpec) -> int:
    """Flat id of dead slots: beyond every live id and every stencil probe a
    live row can make, so run-interval tests never match dead candidates."""
    reach = spec.ny if spec.two_d else (spec.ny + 1) * spec.nz
    return spec.num_bins + reach + 3


def _flat_from_coords(spec: GridSpec, coords: torch.Tensor,
                      alive: torch.Tensor) -> torch.Tensor:
    """Row-major flat bin id of bin coordinates; dead slots get the
    sentinel."""
    if spec.two_d:
        flat = coords[:, 0] * spec.ny + coords[:, 1]
    else:
        flat = (coords[:, 0] * spec.ny + coords[:, 1]) * spec.nz + coords[:, 2]
    return torch.where(alive, flat, dead_sentinel(spec))


def build_grid(spec: GridSpec, locations: torch.Tensor, ids: torch.Tensor,
               alive: torch.Tensor) -> Grid:
    """Sort agents into the canonical ``(flat bin, agent id)`` order."""
    coords = _bin_coords(spec, locations)
    return grid_from_flat_coords(_flat_from_coords(spec, coords, alive), coords, ids)


def grid_from_flat_coords(flat: torch.Tensor, coords: torch.Tensor,
                          ids: torch.Tensor) -> Grid:
    """The Grid of precomputed flat bin ids (dead slots at a sentinel) and
    bin coordinates, sorted canonically. JAX's 2-key ``lax.sort`` becomes
    one ``torch.sort`` of the int64 key ``flat << 32 | id`` (both fit 31
    bits). The sort is stable, so dead slots that share a stale id keep
    slot order."""
    key = (flat << 32) | (ids.to(torch.int64) & 0xFFFFFFFF)
    order = torch.sort(key, stable=True).indices
    return Grid(order=order, sorted_flat=flat[order], coords=coords)


def _bin_table(spec: GridSpec, sorted_flat: torch.Tensor) -> torch.Tensor:
    """``table[b]``, for b in ``[0, num_bins]``: the number of agents in bins
    < b, the sorted position where bin b starts (a binary search of the
    sorted flat ids; dead slots' sentinel lies beyond every b). No host read,
    unlike a histogram (``bincount`` on the card reads its largest bin)."""
    bins = torch.arange(spec.num_bins + 1, dtype=torch.int64, device=sorted_flat.device)
    return torch.searchsorted(sorted_flat, bins)


def _run_index(spec: GridSpec, device) -> Tuple[torch.Tensor, ...]:
    """Over the columns ``[lo_0, hi_0, lo_1, ...]`` of the bounds, (2 *
    n_runs,) int64 each: the run's first flat bin relative to the row's
    (``flat_run_offsets`` less 1), the offset of the column's bin-table
    entry from it (0 for lo, 3 for hi), and 1 where a dead row holds the
    capacity (the lo columns). Made on the device from an ``arange``."""
    col = torch.arange(2 * len(spec.run_offsets), dtype=torch.int64, device=device)
    r = col // 2
    if spec.two_d:
        first = (r - 1) * spec.ny - 1
    else:
        first = ((r // 3 - 1) * spec.ny + (r % 3 - 1)) * spec.nz - 1
    return first, (col % 2) * 3, 1 - col % 2


def run_bounds(spec: GridSpec, sorted_flat: torch.Tensor) -> torch.Tensor:
    """Absolute run bounds ``[lo_0, hi_0, lo_1, hi_1, ...]`` per sorted row,
    (C, 2 * n_runs) int32 (3 runs in 2D, 9 in 3D), what the kernels walk:
    run r covers the flat bins ``[f + flat_run_offsets[r] - 1, +3)``. Rows
    dead at build time get the empty interval ``[capacity, 0)`` in every
    run. Both bounds of every run come from one gather of the bin table."""
    table = _bin_table(spec, sorted_flat)
    first, plus, lo_col = _run_index(spec, sorted_flat.device)
    capacity = sorted_flat.shape[0]
    index = torch.clamp(sorted_flat[:, None] + first, 0, spec.num_bins - 3) + plus
    dead = (sorted_flat >= spec.num_bins)[:, None]
    return torch.where(dead, lo_col * capacity, table[index]).to(torch.int32)


def bounds_window(bounds: torch.Tensor, width: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Padded candidate window from per-row run bounds: ``(pos (C, W) int64
    sorted positions, valid (C, W) bool)``, runs in order and ascending
    position within a run — the kernels' walk order. ``W`` is the run count
    times the widest run (one host read), so no candidate is ever cut.

    ``width``, at least the widest run, pads every run to it instead: the
    plain versions' sums over a row then see the same padded row whatever
    the other rows hold, which keeps a tile's rows bit-equal to the same
    rows of the whole colony (the domain engine passes the widest run over
    all tiles)."""
    capacity = bounds.shape[0]
    b = bounds.to(torch.int64).view(capacity, -1, 2)
    lo, hi = b[..., 0], b[..., 1]
    widest = int(torch.clamp(hi - lo, min=0).max()) if capacity else 0
    if width is not None and width < widest:
        raise ValueError(f"bounds_window: width {width} is below the widest run {widest}")
    width = widest if width is None else width
    k = torch.arange(max(width, 1), dtype=torch.int64, device=bounds.device)
    pos = lo[:, :, None] + k
    valid = pos < hi[:, :, None]
    pos = torch.clamp(pos, 0, max(capacity - 1, 0))
    return pos.reshape(capacity, -1), valid.reshape(capacity, -1)


# The TPU kernels' blocks of sorted rows, chunks of span lanes and the
# alignment of span starts (the JAX engine's ``pallas_block``,
# ``pallas_chunk`` and ``_ALIGN``), and the lane width of XLA:CPU's partial
# sums in their interpreted bodies
GROUP_BLOCK = 128
# stencil runs per row: 3 in 2D, 9 in 3D
RUN_COUNTS = (3, 9)
GROUP_CHUNK = 256
_ALIGN = 128
_WINDOW_SHIFT = 5  # 32-lane windows


def run_count(bounds: torch.Tensor) -> int:
    """Stencil runs of a (C, 2 * n_runs) run-bounds table; raises unless
    n_runs is 3 (2D) or 9 (3D)."""
    n_runs = bounds.shape[1] // 2 if bounds.dim() == 2 else 0
    if n_runs not in RUN_COUNTS or bounds.shape[1] != 2 * n_runs:
        raise ValueError(f"bounds: expected (C, 6) or (C, 18), got {tuple(bounds.shape)}")
    return n_runs


def effective_chunk(span: int, chunk: int = GROUP_CHUNK) -> int:
    """The chunk the TPU kernels use for a span cap (the JAX package's
    ``effective_chunk``): never wider than the span, the whole span where
    the chunk does not divide it."""
    chunk = min(chunk, span)
    return span if span % chunk else chunk


def span_cap(span: int, capacity: int, chunk: int = GROUP_CHUNK) -> int:
    """A DMA span cap as the JAX engine's ``EngineConfig.create`` clamps it:
    at most the capacity, else rounded up to a chunk multiple."""
    span = min(int(span), capacity)
    return span if span == capacity else min(-(-span // chunk) * chunk, capacity)


class Grouping(NamedTuple):
    """Where a window's rows and candidates lie in the sorted order of the
    whole colony, which sets how the TPU kernels group a row's float sums
    (``grouped_sum``). ``starts`` (n_runs, nblocks) int32 is each block of
    ``block`` sorted rows' span start per run (``block_starts``); ``gpos``
    (C,) int32 is each row's position in the colony's sorted order, None
    when the rows are that order (the single engine); ``chunk`` is the
    kernels' chunk of span lanes (``effective_chunk``). ``needed``, where
    an engine computes it, is the JAX engine's span probe of the window
    (``block_span_needed``), which the kernels do not read."""

    starts: torch.Tensor
    gpos: Optional[torch.Tensor] = None
    chunk: int = GROUP_CHUNK
    block: int = GROUP_BLOCK
    needed: Optional[torch.Tensor] = None


def block_starts(lo_first: torch.Tensor, span: Optional[int], capacity: int,
                 align: int = _ALIGN) -> torch.Tensor:
    """The TPU kernels' span starts (``block_span_plan``'s ``starts``
    without its pad row): each block's first row's run start ``lo_first``
    (nblocks, n_runs), non-negative, rounded down to ``align`` (a power of
    two) and clipped to ``max_start = (capacity - span) // align * align``;
    no clip where ``span`` is None. Returns (n_runs, nblocks) int32."""
    lo = lo_first.to(torch.int32) & -align
    if span is not None:
        lo = torch.clamp(lo, max=max(capacity - span, 0) // align * align)
    return lo.t().contiguous()


def grouping_of_bounds(bounds: torch.Tensor, span: Optional[int] = None,
                       capacity: Optional[int] = None, chunk: int = GROUP_CHUNK,
                       block: int = GROUP_BLOCK) -> Grouping:
    """The grouping of a window whose rows are the colony's sorted order
    (the single engine): the blocks' run starts are their first rows'
    bounds. ``span`` and ``capacity`` (default: the rows) are the JAX
    engine's span cap and capacity, which clip the starts near the end of
    the sorted order; ``chunk`` is already ``effective_chunk``'s. A block
    of rows dead at the build (sorted last, empty runs ``[C, 0)``) starts
    where no live row reads its start."""
    capacity = bounds.shape[0] if capacity is None else capacity
    first = bounds.view(bounds.shape[0], -1, 2)[::block, :, 0]
    return Grouping(block_starts(first, span, capacity), None, chunk, block)


def block_span_needed(bounds: torch.Tensor, grouping: Grouping) -> torch.Tensor:
    """The JAX engine's span probe of a window whose rows are the colony's
    sorted order (``block_span_plan``'s ``span_needed``): the most sorted
    positions a block's run reaches from its span start, over the blocks
    with live rows and their runs (0-d int32). A block's last live row
    reaches furthest; rows dead at the build reach 0, so a block of them
    adds nothing. The engine grows its span cap past it as the JAX engine
    does."""
    C, block = bounds.shape[0], grouping.block
    nblocks = grouping.starts.shape[1]
    hi = bounds.view(C, -1, 2)[:, :, 1]
    if nblocks * block != C:
        hi = torch.nn.functional.pad(hi, (0, 0, 0, nblocks * block - C))
    need = hi.reshape(nblocks, block, -1).amax(dim=1) - grouping.starts.t()
    return need.max().clamp(min=0)


class Lanes(NamedTuple):
    """Each entry of a run-major window's place in the TPU kernels' sum
    (``window_lanes``): ``group`` (C, W) int64, chunk * n_runs + run, and
    ``window`` (C, W) int64, the 32-lane window of the colony's sorted
    order."""

    group: torch.Tensor
    window: torch.Tensor


def window_lanes(bounds: torch.Tensor, width: int, grouping: Grouping) -> Lanes:
    """The ``Lanes`` of the window of ``bounds`` padded to ``width`` per run
    (``bounds_window``): candidate k of run r of a row lies at ``g = g_lo +
    k`` in the colony's order (``g_lo`` that of the run's first candidate;
    a run's bins are consecutive there too), its chunk is ``(g - s) //
    chunk`` from the span start ``s`` of the row's block for that run, and
    its window ``g // 32``."""
    C = bounds.shape[0]
    b = bounds.to(torch.int64).view(C, -1, 2)
    lo, n_runs = b[..., 0], b.shape[1]
    dev = bounds.device
    if grouping.gpos is None:
        row_g, lo_g = torch.arange(C, device=dev), lo
    else:
        gpos = grouping.gpos.to(torch.int64)
        row_g, lo_g = gpos, gpos[torch.clamp(lo, 0, max(C - 1, 0))]
    starts = grouping.starts.to(torch.int64)
    blk = torch.clamp(row_g // grouping.block, 0, starts.shape[1] - 1)
    runs = torch.arange(n_runs, device=dev)
    base = starts[runs[None, :], blk[:, None]]  # (C, n_runs)
    g = lo_g[:, :, None] + torch.arange(width, device=dev)
    chunk = torch.clamp(g - base[:, :, None], min=0) // grouping.chunk
    return Lanes((chunk * n_runs + runs[:, None]).reshape(C, -1),
                 (g >> _WINDOW_SHIFT).reshape(C, -1))


def plain_lanes(bounds, pos, grouping: Optional[Grouping]):
    """The ``neighbors.Lanes`` of a plain version's window ``pos`` over
    ``bounds`` under ``grouping`` (default: ``grouping_of_bounds``)."""
    grouping = grouping_of_bounds(bounds) if grouping is None else grouping
    return window_lanes(bounds, pos.shape[1] // run_count(bounds), grouping)


def grouped_sum(terms: torch.Tensor, keep: torch.Tensor,
                lanes: Optional[Lanes] = None) -> torch.Tensor:
    """(C, D) sums of the kept (C, W, D) ``terms`` of each row as the
    interpreted TPU kernels add them: per (chunk, run) in chunk-major
    order, the run's lanes of the chunk in 32-lane windows of the colony's
    sorted order, each window's terms added in lane order from +0, the
    windows added from +0, and that total added to the row's sum
    (``Lanes``). Without ``lanes`` the kept terms are added in window
    order. The kept entries move to the front in that order (a stable
    sort) and a loop over the most any row keeps (one host read) adds them;
    padding and the entries not kept add nothing, so the sums do not depend
    on the window's width."""
    C, D = terms.shape[0], terms.shape[-1]
    acc = torch.zeros((C, D), dtype=terms.dtype, device=terms.device)
    if C == 0 or keep.shape[1] == 0:
        return acc
    big = torch.iinfo(torch.int64).max
    if lanes is None:
        group = window = torch.zeros_like(keep, dtype=torch.int64)
    else:
        group, window = lanes
    first = torch.sort(torch.where(keep, group, big), dim=1, stable=True).indices
    n = int(keep.sum(dim=1).max())
    first = first[:, :n]
    kept = torch.gather(keep, 1, first)
    group, window = torch.gather(group, 1, first), torch.gather(window, 1, first)
    zero = torch.zeros((), dtype=terms.dtype, device=terms.device)
    vals = torch.where(kept[..., None],
                       torch.gather(terms, 1, first[..., None].expand(-1, -1, D)), zero)
    # the kept entries lead each row, so entry k opens a group (a window)
    # where it differs from entry k - 1
    opens = torch.ones((C, 1), dtype=torch.bool, device=terms.device)
    new_group = kept & torch.cat([opens, group[:, 1:] != group[:, :-1]], dim=1)
    new_window = new_group | (kept & torch.cat([opens, window[:, 1:] != window[:, :-1]],
                                                 dim=1))
    new_group, new_window = new_group[..., None], new_window[..., None]
    total = torch.zeros_like(acc)
    part = torch.zeros_like(acc)
    # adding +0 leaves a sum as it is (no partial sum is -0), so a closed
    # window or group adds its sum and the others add +0
    for k in range(n):
        total = total + torch.where(new_window[:, k], part, zero)
        acc = acc + torch.where(new_group[:, k], total, zero)
        total = torch.where(new_group[:, k], zero, total)
        part = torch.where(new_window[:, k], zero, part) + vals[:, k]
    return acc + (total + part)

