"""The contact window's rebuild inside a scan, in place and under the
device drift flag (``csrc/window.cu``): the card's form of
``engine._rebuild_where``, whose values it writes bit for bit.

``engine._rebuild_where`` computes a whole new window on every later
substep (the sort of every capacity row, the bin table, the gathers) and
selects it with ``torch.where``, since a CUDA graph cannot branch. Here
the kernels read the flag ``stale`` from device memory and return at once
when it is false; when it is true they write the rebuilt rows, run bounds,
drift reference, span starts and span probe into the scan's own buffers.

They rest on two facts of a scan, which ``tests/test_torch_window.py``
holds at every rebuild of real scans: ``alive`` does not change, and the
entry build (``engine._build_window``) left the rows dead there as the
tail ``[n_live, C)`` in their key order, which a stable re-sort keeps,
and dead rows do not move (``ref``'s tail is theirs). So a rebuild permutes
only the live prefix into ``build_grid``'s ``(flat bin,
id)`` order: each live row's place is its bin's start in the exclusive
prefix of the bin counts plus the number of its bin's rows of smaller key
``(id, row)``. ``rebuild_plain`` is that algorithm in PyTorch: the CPU
form of the wrapper, which the CPU's single-colony scans run, and the
tests' mirror of the kernels' placement.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from hipsc_abm_tpu_torch import kernels
from hipsc_abm_tpu_torch.ops import neighbors as nbr_ops
from hipsc_abm_tpu_torch.ops import xla_f32

# the rows a scan carries and a rebuild moves; "alive" stays (true on the
# whole live prefix). A single-colony scan also carries "xyzr", the rows'
# packed (x, y, z, r), which the rebuild writes from the moved "loc" and
# "rad" (``PACKED``)
MOVED = ("loc", "rad", "mot", "ids", "partners", "perm")
PACKED = "xyzr"
# the kernels of one rebuild, in launch order (``kernels.launch_counts`` keys)
LAUNCHES = ("window_count", "window_tile_sums", "window_scan", "window_scatter",
            "window_place", "window_write_back")
# grid-stride launches over this many waves of 256-thread blocks per SM
_WAVES = 4
_THREADS = 256


class Buffers(NamedTuple):
    """A scan's rebuild scratch (``buffers``): ``counts`` (num_bins,) int32,
    zero between rebuilds; ``table`` (num_bins + 1,) int32, the bin table;
    ``tile_sums``; ``bin``, ``arrival`` (C,) int32; ``slot_key`` (C,) int64;
    ``rows``, the moved rows' like-shaped scratch; ``needed`` (n_substeps,)
    int32, one span-probe slot per substep."""

    counts: torch.Tensor
    table: torch.Tensor
    tile_sums: torch.Tensor
    bin: torch.Tensor
    arrival: torch.Tensor
    slot_key: torch.Tensor
    rows: Dict[str, torch.Tensor]
    needed: torch.Tensor


def buffers(spec: nbr_ops.GridSpec, rows, n_substeps: int) -> Buffers:
    """The rebuild scratch of a scan over ``rows`` (made once at its entry:
    one memset, the counts)."""
    C, device = rows["ids"].shape[0], rows["ids"].device
    i32 = dict(dtype=torch.int32, device=device)
    # the kernels' scan tiles (the plain version scans in one piece)
    tile = kernels.library().hipsc_window_tile_bins() if device.type == "cuda" else spec.num_bins
    return Buffers(
        counts=torch.zeros((spec.num_bins,), **i32),
        table=torch.empty((spec.num_bins + 1,), **i32),
        tile_sums=torch.empty((-(-spec.num_bins // tile),), **i32),
        bin=torch.empty((C,), **i32), arrival=torch.empty((C,), **i32),
        slot_key=torch.empty((C,), dtype=torch.int64, device=device),
        rows={k: torch.empty_like(rows[k]) for k in MOVED},
        needed=torch.empty((n_substeps,), **i32))


def max_start(span: int, capacity: int, align: int = nbr_ops._ALIGN) -> int:
    """The clip of the blocks' span starts (``block_starts``) under the
    span cap ``span`` (``EngineConfig.jkr_span``), as ``window_grouping``
    caps it at the capacity."""
    return max(capacity - nbr_ops.span_cap(span, capacity), 0) // align * align


def _check(stale, spec: nbr_ops.GridSpec, rows, bounds, ref, grouping: nbr_ops.Grouping,
           needed, buf: Buffers):
    """Raise on operands the kernels do not take; returns ``(C, K,
    n_runs)``."""
    C = rows["ids"].shape[0]
    K = rows["partners"].shape[1]
    n_runs = kernels.run_count(bounds)
    if (n_runs == 3) != spec.two_d:
        raise ValueError(f"rebuild: {n_runs} runs a row in a {'2D' if spec.two_d else '3D'} grid")
    kernels.check_cuda("stale", stale, torch.bool, ())
    for name, dtype, shape in (("loc", torch.float32, (C, 3)), ("rad", torch.float32, (C,)),
                               ("mot", torch.float32, (C, 3)), ("ids", torch.int32, (C,)),
                               ("alive", torch.bool, (C,)), ("partners", torch.int32, (C, K)),
                               ("perm", torch.int64, (C,))):
        kernels.check_cuda(name, rows[name], dtype, shape)
        if name in MOVED:
            kernels.check_cuda(f"scratch {name}", buf.rows[name], dtype, shape)
    packed = [rows[PACKED]] if PACKED in rows else []
    for t in packed:
        kernels.check_cuda(PACKED, t, torch.float32, (C, 4))
    kernels.check_cuda("ref", ref, torch.float32, (C, 3))
    kernels.check_cuda("bounds", bounds, torch.int32, (C, 2 * n_runs))
    nblocks = -(-C // grouping.block)
    kernels.check_cuda("grouping.starts", grouping.starts, torch.int32, (n_runs, nblocks))
    kernels.check_cuda("grouping.needed", grouping.needed, torch.int32, ())
    kernels.check_cuda("needed", needed, torch.int32, ())
    tile = kernels.library().hipsc_window_tile_bins()
    for name, t, n in (("counts", buf.counts, spec.num_bins),
                       ("table", buf.table, spec.num_bins + 1),
                       ("tile_sums", buf.tile_sums, -(-spec.num_bins // tile)),
                       ("bin", buf.bin, C), ("arrival", buf.arrival, C)):
        kernels.check_cuda(name, t, torch.int32, (n,))
    kernels.check_cuda("slot_key", buf.slot_key, torch.int64, (C,))
    if grouping.gpos is not None:
        raise ValueError("rebuild: the window must be the whole colony's sorted order "
                         "(grouping.gpos None)")
    block = grouping.block
    if block < 1 or block & (block - 1):
        raise ValueError(f"rebuild: the grouping's block must be a power of two, not {block}")
    outputs = [rows[k] for k in MOVED] + packed + [ref, bounds, grouping.starts, needed]
    if (len({t.data_ptr() for t in outputs + list(buf.rows.values())})
            != 2 * len(MOVED) + len(packed) + 4):
        raise ValueError("rebuild: the rows, their scratch, the packed rows, ref, bounds, the "
                         "starts and the probe slot must be separate buffers")
    if needed.data_ptr() == grouping.needed.data_ptr():
        raise ValueError("rebuild: the probe slot must not be the held window's")
    return C, K, n_runs


def rebuild_cuda(stale, spec: nbr_ops.GridSpec, span: int, rows, bounds, ref,
                 grouping: nbr_ops.Grouping, needed, buf: Buffers) -> None:
    """The rebuild under the 0-d bool device flag ``stale``, in place: when
    it is true, ``rows`` (``MOVED``, and ``PACKED`` where the rows carry
    it), ``bounds``, ``ref``, ``grouping.starts`` and the probe slot
    ``needed`` (0-d int32) become what ``engine._rebuild_where`` gives with
    the flag true; when it is false, they keep their values and ``needed``
    takes ``grouping.needed``'s. ``span`` is ``EngineConfig.jkr_span``. Six
    launches; a CPU tensor runs ``rebuild_plain``."""
    if rows["ids"].device.type == "cpu":
        rebuild_plain(stale, spec, span, rows, bounds, ref, grouping, needed)
        return
    C, K, n_runs = _check(stale, spec, rows, bounds, ref, grouping, needed, buf)
    grid = min(-(-C // _THREADS), _WAVES * kernels.device_limits()["n_sm"])
    kernels.launch(
        "hipsc_window_rebuild", stale.data_ptr(), rows["alive"].data_ptr(),
        *(rows[k].data_ptr() for k in MOVED), *(buf.rows[k].data_ptr() for k in MOVED),
        ref.data_ptr(), rows[PACKED].data_ptr() if PACKED in rows else None,
        bounds.data_ptr(), grouping.starts.data_ptr(),
        grouping.needed.data_ptr(), needed.data_ptr(), buf.counts.data_ptr(),
        buf.table.data_ptr(), buf.tile_sums.data_ptr(), buf.bin.data_ptr(),
        buf.arrival.data_ptr(), buf.slot_key.data_ptr(), C, K, n_runs,
        xla_f32.recip(spec.cell_size), spec.nx, spec.ny, spec.nz, grouping.starts.shape[1],
        grouping.block.bit_length() - 1, nbr_ops._ALIGN, max_start(span, C), grid)
    for name in LAUNCHES:
        kernels.count_launch(kernels.counted_name(name, n_runs))


def rebuild_plain(stale, spec: nbr_ops.GridSpec, span: int, rows, bounds, ref,
                  grouping: nbr_ops.Grouping, needed,
                  arrival_seed: Optional[int] = None) -> None:
    """``rebuild_cuda``'s algorithm in PyTorch, in place (reads the flag on
    the host): bins counted in an arrival order (the rows' order, or
    shuffled from ``arrival_seed``, as the kernel's atomics may give any),
    their exclusive prefix, each live row's key ``(id, row)`` scattered into
    its bin's slots at its arrival, its place its bin's start plus the keys
    there below its own; then the moved rows (and their packed rows, where
    the rows carry ``PACKED``), ``ref``, the run bounds, the span starts of
    the blocks whose first row moved, and the span probe."""
    if not bool(stale):
        needed.copy_(grouping.needed)
        return
    alive, device = rows["alive"], rows["ids"].device
    live = torch.nonzero(alive).reshape(-1)
    coords = nbr_ops._bin_coords(spec, rows["loc"][live])
    b = nbr_ops._flat_from_coords(spec, coords, torch.ones_like(live, dtype=torch.bool))
    n = live.shape[0]
    seq = torch.arange(n, device=device)
    if arrival_seed is not None:
        gen = torch.Generator().manual_seed(arrival_seed)
        seq = torch.randperm(n, generator=gen).to(device)
    # arrival: the rows of a bin before this one in the arrival sequence
    by_bin = torch.sort(b[seq] * n + torch.arange(n, device=device)).indices
    arrival = torch.empty_like(seq)
    counts = torch.bincount(b, minlength=spec.num_bins)
    table = torch.cat([torch.zeros(1, dtype=torch.int64, device=device), torch.cumsum(counts, 0)])
    rank_in_run = torch.arange(n, device=device) - table[b[seq][by_bin]]
    arrival[seq[by_bin]] = rank_in_run
    key = (rows["ids"][live].to(torch.int64) & 0xFFFFFFFF) << 32 | live
    slot_key = torch.empty(n, dtype=torch.int64, device=device)
    slot_key[table[b] + arrival] = key
    width = int(counts.max()) if n else 0
    k = table[b][:, None] + torch.arange(width, device=device)
    inside = k < table[b + 1][:, None]
    below = inside & (slot_key[torch.clamp(k, max=max(n - 1, 0))] < key[:, None])
    p = table[b] + below.sum(dim=1)
    ref[p] = rows["loc"][live]
    for name in MOVED:
        rows[name][p] = rows[name][live].clone()
    if PACKED in rows:
        rows[PACKED][p] = torch.cat([rows["loc"][p], rows["rad"][p, None]], dim=1)
    first, plus, _ = nbr_ops._run_index(spec, device)
    at = torch.clamp(b[:, None] + first, 0, spec.num_bins - 3) + plus
    bounds[p] = table[at].to(torch.int32)
    heads = p % grouping.block == 0
    lo = bounds[p[heads]].view(-1, bounds.shape[1] // 2, 2)[:, :, 0]
    starts = nbr_ops.block_starts(lo, None, 0, nbr_ops._ALIGN).clamp(
        max=max_start(span, alive.shape[0]))
    grouping.starts[:, p[heads] // grouping.block] = starts
    hi = bounds[:n].view(n, bounds.shape[1] // 2, 2)[:, :, 1]
    need = hi - grouping.starts[:, torch.arange(n, device=device) // grouping.block].t()
    needed.copy_(need.max().clamp(min=0) if n else torch.zeros((), dtype=torch.int32,
                                                                device=device))
