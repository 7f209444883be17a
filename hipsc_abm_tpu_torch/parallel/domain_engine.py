"""The domain-decomposed engine: the box cut into tiles, each tile's agents
stepped on their own device, halos exchanged and agents migrated (port of
``hipsc_abm_tpu/parallel/domain_engine.py``).

Decomposition
-------------
The box is split into an ``(n_tx, n_ty)`` tile grid over the radius-15
lattice's columns and rows (``n_ty == 1``, the default, is x-stripes; in 3D
a tile owns full-z pencils). Tile ``s = tx * n_ty + ty`` owns every agent
whose bin column lies in ``[col_bounds[tx], col_bounds[tx + 1])`` and whose
bin row lies in ``[row_bounds[ty], row_bounds[ty + 1])``. Each tile holds
``per_stripe`` own slots plus ``n_halo_blocks`` blocks of ``halo_cap`` halo
rows, in the order ``[y-down, y-up,] x-left, x-right``, mirroring the
boundary agents of the adjacent tiles.

Bit-exactness rests on the canonical agent order (row-major flat bin, id):
tile-local flat bins are the global bins shifted by the tile's static
offsets, a lexicographically monotone map, so a tile's canonical order is
the global order restricted to its rows. Whenever the halo covers what a
row can reach, its windows hold the same candidates in the same order as
the single engine's, so every moment, force and bond of an own row equals
``HipscEngine``'s bit for bit; daughter ids equal the single engine's
through the dividers counted in lower stripes (for tiles, per column).

One controller
--------------
One process owns every tile: tile ``s`` keeps its tensors on
``engine.devices[s]`` (by default ``cuda:{s % device_count}``, so a tile
grid runs on one card; ``device="cpu"`` puts every tile on the CPU). The
JAX engine runs its step body once per device under ``shard_map``, with its
collectives inline. Here the per-tile body (``_tile_step``) is a generator
that yields at each collective; the engine advances every tile to its next
yield, performs the collective (``_Exchange``, ``_Reduce``, ``_Diffuse``),
and sends each tile its part of the result, so the step runs phase by
phase: each phase runs every tile's local work, then its exchange.

- An exchange hands each tile's static-size packs to its axis neighbours
  (a copy when the tiles lie on different devices); the receiver copies
  them into its halo block. Boundary tiles receive zeros (the box is not a
  torus).
- A reduction gathers the per-tile values in tile order on the first tile's
  device and hands the result back. The global drift predicate that
  schedules the contact-window rebuilds is such a device tensor: the
  span-mask kernels read it through their predicate pointer, and the step
  reads nothing on the host. The plain versions (on the CPU) also reduce
  the widest run of every window, so that a tile's padded windows equal the
  single engine's (``neighbors.bounds_window``).
- The morphogen lattice is replicated, one copy per distinct device. Each
  tile deposits its own secreting agents onto a zero lattice (the
  fixed-order deposit, ``scatter_add_cuda``); the deltas are summed in tile
  order on the first device and the sum added to every replica, and FTCS
  runs once per distinct device. Every replica, on the card and on the CPU,
  holds the same lattice bit for bit; against the single engine, whose
  deposit goes straight onto the lattice, it differs by rounding.

Several processes
-----------------
Given a process group (``process_group=``, or ``rank`` and ``world``), the
tiles are spread over its ranks, a contiguous block each (the JAX mesh's
order), and each rank is the controller of its own block: it advances only
its tiles' generators, which are the same. Only the collectives change,
through ``parallel.distributed.Transport``: an exchange copies between
local tiles and sends the rest in one ``batch_isend_irecv`` per axis; a
reduction and the deposit deltas gather every tile's value in tile order on
every rank, which then sums or maxes them in the order above, so every rank
holds the lattice of the single controller bit for bit; the probe row is
all-reduced (integer sums and maxima, exact in any order) before the
attempt's one host read, so every rank makes the same growth decision.
Before each collective the ranks check that they are at the same one. The
state holds only the local tiles; ``from_cell_state`` keeps them from a
colony every rank holds alike, and ``to_cell_state``, the flat checkpoint,
``rebalance`` and the drift recovery gather every tile (every rank calls
them). ``save_checkpoint_sharded`` and ``write_values_sharded`` write each
rank's own tiles only.

Communication per step is O(boundary): the bio halo exchange at step start
and its two value refreshes, one contact-band exchange per physics substep
and decomposed axis (positions of the frozen band; whole packs at a window
rebuild), one migration exchange per axis at step end, and the reductions.
``DomainHipscEngine.exchange_bytes`` counts the bytes each step hands over.

Every static capacity (per-tile slots, halo rows, migration rows, bond
degree, mask width, drift allowance) has an overflow probe;
``DomainHipscEngine.safe_step`` re-executes the step from its unmodified
input after growing whichever capacity tripped. Each step attempt fetches
its probes to the host once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from hipsc_abm_tpu_torch import convert
from hipsc_abm_tpu_torch.engine import (
    _BOND_CAP_GUARD_MSG,
    MAX_BOND_CAP,
    CellState,
    EngineConfig,
    HipscEngine,
    _RebuildWhere,
    _Update,
    _build_window,
    _contact_law,
    _masked_max,
    _physics_dts,
    _round_up,
    _window_widths,
    config_from_meta,
    config_to_meta,
    contact_substep_rows,
    drift_threshold,
    initial_mask_bits,
    mask_words_of,
    neighbor_moments,
    span_mask_substep,
    step_inputs,
)
from hipsc_abm_tpu_torch.models import biology
from hipsc_abm_tpu_torch.ops import diffusion as diffusion_ops
from hipsc_abm_tpu_torch.ops import neighbors as nbr_ops
from hipsc_abm_tpu_torch.ops import span_mask, xla_f32
from hipsc_abm_tpu_torch.ops.bio_moments import positions as bio_positions
from hipsc_abm_tpu_torch.ops.contact import contact_substep_cuda
from hipsc_abm_tpu_torch.ops.ftcs import ftcs_diffuse_cuda
from hipsc_abm_tpu_torch.ops.jkr import BondState, clear_bond_rows
from hipsc_abm_tpu_torch.params import (
    BiologyParams,
    DiffusionParams,
    ExperimentalParams,
    GeneralParams,
)

# the per-agent arrays a migrating agent takes along (the motility and
# contact forces are zero at step end and stay behind)
_MIG_FIELDS = (
    "ids", "locations", "radii", "FGF4", "FGFR", "ERK", "GATA6", "NANOG",
    "states", "death_counters", "diff_counters", "div_counters", "fds_counters",
)
# the lanes a bio halo row carries (the moments read these, and liveness)
_BIO_LANES = ("locations", "radii", "ids", "FGF4", "GATA6", "NANOG", "states")
# ids are exact in the packs (int32 lanes), but the JAX engine carries them
# in float32 lanes and stops at 2^24; the port stops where it does
_ID_LIMIT = (1 << 24) - 1


@dataclasses.dataclass(frozen=True)
class DomainConfig:
    """Static configuration of the decomposed engine (the JAX engine's
    fields and meaning)."""

    base: EngineConfig  # global lattice specs, bond_cap, skin, phase flags, contact path
    n_stripes: int  # TOTAL tile count S = n_tx * n_ty
    per_stripe: int  # own agent slots per tile
    halo_cap: int  # halo rows per block
    mig_cap: int  # migration rows per side per step
    div_cap: int  # per-tile daughter-table size
    # how far (um) an agent may drift outside its tile within one step
    # before it is re-homed; sizes the contact bands. Grown on drift_exceed.
    drift_allowance: float
    col_bounds: Tuple[int, ...]  # (n_tx + 1,) radius-15 lattice column partition
    nbr_nx_local: int  # local lattice column counts, the same for every tile
    jkr_nx_local: int
    n_ty: int = 1  # y-tiles per x-stripe (tile s = tx * n_ty + ty)
    row_bounds: Tuple[int, ...] = ()  # (n_ty + 1,) row partition
    nbr_ny_local: int = 0  # local lattice row counts (n_ty > 1)
    jkr_ny_local: int = 0

    @property
    def n_tx(self) -> int:
        return self.n_stripes // self.n_ty

    @property
    def n_halo_blocks(self) -> int:
        """Halo blocks per tile, in the local slot layout ``[y-down, y-up,]
        x-left, x-right``: the y blocks exist when the y axis is cut."""
        return 2 if self.n_ty == 1 else 4

    @property
    def local_capacity(self) -> int:
        return self.per_stripe + self.n_halo_blocks * self.halo_cap

    @property
    def nbr_spec_local(self) -> nbr_ops.GridSpec:
        ny = self.base.nbr_spec.ny if self.n_ty == 1 else self.nbr_ny_local
        return dataclasses.replace(self.base.nbr_spec, nx=self.nbr_nx_local, ny=ny)

    @property
    def jkr_spec_local(self) -> nbr_ops.GridSpec:
        ny = self.base.jkr_spec.ny if self.n_ty == 1 else self.jkr_ny_local
        return dataclasses.replace(self.base.jkr_spec, nx=self.jkr_nx_local, ny=ny)


class DomainState(NamedTuple):
    """The decomposed state. Per tile ``s`` of this process, at its place
    ``i`` in ``engine.tiles`` (every tile for one controller, the rank's
    block across ranks), on ``engine.devices[i]``: ``arrays[i]`` (the
    per-agent arrays, ``(per_stripe, ...)``), ``alive[i]`` and ``bonds[i]``;
    agents live in the tile that owns their bin column and row. ``gradients`` holds the replicated lattices, one
    dict per distinct device (``engine.replica_devices``). ``key`` is the
    (2,) int64 step key on the host, ``next_id`` a () int32 tensor on the
    first tile's device."""

    arrays: Tuple[Dict[str, torch.Tensor], ...]
    alive: Tuple[torch.Tensor, ...]
    bonds: Tuple[BondState, ...]
    gradients: Tuple[Dict[str, torch.Tensor], ...]
    key: torch.Tensor
    step: int
    next_id: torch.Tensor


class DomainStepInfo(NamedTuple):
    """Step diagnostics and overflow probes, summed or maxed over the tiles
    (Python numbers from ``safe_step``, (k,) numpy arrays from
    ``run_steps``). The JAX engine's fields, plus ``jkr_rebuilds``;
    ``jkr_span_needed`` is the widest contact-window row (the span-mask
    path's ``mask_bits`` probe)."""

    num_agents: object
    num_added: object
    num_removed: object
    num_deferred: object
    num_dividing: object  # max per-tile dividing count (div_cap probe)
    nbr_max_in_bin: object
    jkr_max_in_bin: object
    jkr_max_degree: object
    max_id: object
    bio_band_max: object  # bio boundary-column occupancy (halo_cap probe)
    phys_band_max: object  # contact band occupancy (halo_cap probe)
    mig_out_max: object  # emigrants per side (mig_cap probe)
    mig_shortfall: object  # immigrants without a free slot (per_stripe probe)
    mig_too_far: object  # emigrants skipping a tile (the decomposition's limit)
    halo_miss: object  # frozen halo members absent from a fresh pack (0 by construction)
    drift_exceed: object  # max um outside the own tile (drift_allowance probe)
    jkr_span_needed: object
    max_substep_move: object
    jkr_rebuilds: object  # contact-window rebuilds after the physics entry build
    jkr_block_span: object  # the JAX span probes of the colony's windows
    nbr_block_span: object  # (HipscEngine's StepInfo; jkr_span / nbr_span growth)


_SUM_FIELDS = frozenset(("num_agents", "num_added", "num_removed", "num_deferred",
                         "mig_shortfall", "mig_too_far", "halo_miss"))
_FLOAT_FIELDS = frozenset(("drift_exceed", "max_substep_move"))
_SUM_IDX = [i for i, n in enumerate(DomainStepInfo._fields) if n in _SUM_FIELDS]
_MAX_IDX = [i for i, n in enumerate(DomainStepInfo._fields) if n not in _SUM_FIELDS]


def _info_from_host(rows, stacked: bool) -> DomainStepInfo:
    """DomainStepInfo of fetched probe rows: Python numbers from one row,
    (k,) numpy arrays from k."""
    cols = np.asarray(rows, dtype=np.float64).reshape(len(rows), -1).T
    fields = [c if name in _FLOAT_FIELDS else c.astype(np.int64)
              for name, c in zip(DomainStepInfo._fields, cols)]
    if stacked:
        return DomainStepInfo(*fields)
    return DomainStepInfo(*(float(f[0]) if name in _FLOAT_FIELDS else int(f[0])
                            for name, f in zip(DomainStepInfo._fields, fields)))


# ---------------------------------------------------------------------------
# the collectives a tile's body yields
# ---------------------------------------------------------------------------


class _Exchange(NamedTuple):
    """Send ``lo`` to the axis- neighbour and ``hi`` to the axis+ neighbour
    (axis 0: x, stride n_ty; axis 1: y, stride 1); the tile receives
    ``(from_lo, from_hi)``, zeros at the box's edges."""

    axis: int
    lo: torch.Tensor
    hi: torch.Tensor


class _Reduce(NamedTuple):
    """``op`` over the tiles' values, in tile order: "sum", "max",
    "gather" (stacked), or "isum", the sum of integer tensors (one
    all-reduce across ranks); every tile receives the result."""

    op: str
    value: torch.Tensor


class _Diffuse(NamedTuple):
    """The lattice ``name``'s step: the tiles' deposit deltas (or None)
    summed in tile order and added to the lattice, then FTCS once per
    device; every tile receives its device's replica."""

    name: str
    delta: Optional[torch.Tensor]


# ---------------------------------------------------------------------------
# small device-side helpers
# ---------------------------------------------------------------------------


def _compact_idx(mask: torch.Tensor, cap: int):
    """First-``cap`` compaction of a row mask: ``(idx (cap,), valid (cap,),
    count)``, ``idx[r]`` the r-th masked row; ``count``, the true total, is
    the overflow probe."""
    n = mask.shape[0]
    rank = torch.cumsum(mask.to(torch.int64), 0) - 1
    dest = torch.where(mask & (rank < cap), rank, cap)
    rows = torch.arange(n, dtype=torch.int64, device=mask.device)
    idx = torch.zeros((cap + 1,), dtype=torch.int64, device=mask.device)
    idx[dest] = rows
    valid = torch.zeros((cap + 1,), dtype=torch.bool, device=mask.device)
    valid[dest] = True
    return idx[:cap], valid[:cap], mask.sum()


def _as_lanes(x: torch.Tensor) -> torch.Tensor:
    """A 1-D or 2-D row array as (n, w) int32 lanes (float32 bits viewed,
    bools as 0/1): packs carry every value exactly."""
    x = x if x.dim() == 2 else x[:, None]
    if x.dtype == torch.float32:
        return x.contiguous().view(torch.int32)
    return x.to(torch.int32)


def _pack(lanes: Sequence[torch.Tensor], idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(cap, L) int32 pack of the lanes at rows ``idx``; invalid rows are
    all-zero (their liveness lane reads dead)."""
    pack = torch.cat([_as_lanes(lane[idx]) for lane in lanes], dim=1)
    return torch.where(valid[:, None], pack, 0)


def _unpack(pack: torch.Tensor, likes: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The lanes of a pack back in the dtypes and widths of ``likes``."""
    out, c = [], 0
    for like in likes:
        w = like.shape[1] if like.dim() == 2 else 1
        lanes = pack[:, c:c + w].contiguous()
        if like.dtype == torch.float32:
            v = lanes.view(torch.float32)
        elif like.dtype == torch.bool:
            v = lanes != 0
        else:
            v = lanes.to(like.dtype)
        out.append(v if like.dim() == 2 else v[:, 0])
        c += w
    return out


def _scatter_rows(arr: torch.Tensor, dest: torch.Tensor, values) -> torch.Tensor:
    """``arr`` with ``values`` written at rows ``dest`` in ``[0, len]``,
    ``len`` the dropped sentinel (JAX's ``mode="drop"``)."""
    ext = torch.cat([arr, arr[:1]], dim=0)
    ext[dest] = values
    return ext[:arr.shape[0]]


def _pad_rows(a: torch.Tensor, n: int) -> torch.Tensor:
    """A new tensor of ``n`` rows: ``a``'s, then zeros."""
    pad = torch.zeros((n - a.shape[0],) + tuple(a.shape[1:]), dtype=a.dtype, device=a.device)
    return torch.cat([a, pad], dim=0)


def _inverse(perm: torch.Tensor) -> torch.Tensor:
    """The inverse permutation: ``inv[perm[i]] = i``."""
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], dtype=perm.dtype, device=perm.device)
    return inv


def _sel(pred, fresh, frozen):
    """``fresh`` where the (device or Python) predicate holds, else
    ``frozen``, leaf by leaf."""
    if pred is True:
        return fresh
    return tuple(torch.where(pred, f, o) for f, o in zip(fresh, frozen))


def _process_group(group, rank: Optional[int], world: Optional[int]):
    """The process group a domain engine spreads its tiles over, or None for
    one controller: ``group`` itself, or the default group when ``rank`` and
    ``world`` name it (checked against it)."""
    if group is None and rank is None and world is None:
        return None
    if group is None:
        if rank is None or world is None:
            raise ValueError("pass process_group, or both rank and world")
        if not dist.is_initialized():
            raise RuntimeError("rank and world name the default process group, which is "
                               "not initialised (parallel.distributed.init_process_group)")
        group = dist.group.WORLD
    if rank is not None and rank != dist.get_rank(group) or \
            world is not None and world != dist.get_world_size(group):
        raise ValueError(f"rank {rank} of {world} is not this process's place in the group "
                         f"({dist.get_rank(group)} of {dist.get_world_size(group)})")
    return group


class _TileConsts(NamedTuple):
    """A tile's static constants (``DomainHipscEngine._stripe_consts``)."""

    ncl: int  # own radius-15 columns [ncl, nch), rows [nrl, nrh)
    nch: int
    nrl: int
    nrh: int
    col_off_nbr: int  # local lattice offsets
    row_off_nbr: int
    col_off_jkr: int
    row_off_jkr: int
    sl_fresh: int  # fresh contact send bands (contact lattice columns / rows)
    sr_fresh: int
    sd_fresh: int
    su_fresh: int
    recv_l_col: int  # contact receive bins
    recv_r_col: int
    recv_d_row: int
    recv_u_row: int
    prev_ncl: int  # an emigrant past these skipped a tile
    next_nch: int
    prev_nrl: int
    next_nrh: int
    x_lo: float  # the tile's extent (um), float32 values
    x_hi: float
    y_lo: float
    y_hi: float


class _Tile(NamedTuple):
    """What a tile's body needs besides its state."""

    index: int
    cfg: DomainConfig
    consts: _TileConsts
    gen: GeneralParams
    xp: ExperimentalParams
    bio: BiologyParams
    diff: Optional[DiffusionParams]


# ---------------------------------------------------------------------------
# the per-tile step body
# ---------------------------------------------------------------------------


def _collective_code(msg) -> int:
    """A collective's kind as one integer, which the ranks compare before
    they issue it (``Transport.agree``); 0 is the end of the step."""
    if isinstance(msg, _Exchange):
        return 1 + msg.axis
    if isinstance(msg, _Reduce):
        return 7 if msg.op == "isum" else 3 + ("sum", "max", "gather").index(msg.op)
    return 6


def _bin_counts(spec: nbr_ops.GridSpec, loc: torch.Tensor, own: torch.Tensor) -> torch.Tensor:
    """(num_bins + 1,) int32 count of the ``own`` rows per bin of the
    global lattice ``spec`` (the last entry unused): a tile's part of the
    colony's bin table."""
    flat = nbr_ops._flat_from_coords(spec, nbr_ops._bin_coords(spec, loc), own)
    counts = torch.zeros((spec.num_bins + 1,), dtype=torch.int32, device=loc.device)
    return counts.index_add_(0, torch.clamp(flat, max=spec.num_bins), own.to(torch.int32))


def _tile_grouping(spec: nbr_ops.GridSpec, counts: torch.Tensor, loc_sorted: torch.Tensor,
                   sorted_flat: torch.Tensor, spec_local: nbr_ops.GridSpec, span: int,
                   capacity: int, n_slots: int) -> nbr_ops.Grouping:
    """The sum order of a tile's window (its rows in the tile's sorted
    order ``sorted_flat``, at ``loc_sorted``) within the colony whose
    per-bin ``counts`` (``_bin_counts``, summed over the tiles) give its
    sorted order: each row's position in it and the blocks' span starts,
    under the single engine's span cap and ``capacity``; ``n_slots`` (the
    tiles' slots) bounds the blocks a live row can lie in. These are the
    single engine's, so a tile's sums equal its bit for bit; so is the
    JAX span probe of the window, ``needed``."""
    span = nbr_ops.span_cap(span, capacity)
    nblocks = -(-max(capacity, n_slots) // nbr_ops.GROUP_BLOCK)
    gflat = nbr_ops._flat_from_coords(spec, nbr_ops._bin_coords(spec, loc_sorted),
                                      sorted_flat < spec_local.num_bins)
    gpos = nbr_ops.global_positions(counts.to(torch.int64), gflat, sorted_flat,
                                    nbr_ops._bin_table(spec_local, sorted_flat))
    starts, needed = nbr_ops.global_block_starts(spec, counts.to(torch.int64), nblocks, span,
                                                 capacity)
    return nbr_ops.Grouping(starts, gpos, nbr_ops.effective_chunk(span), needed=needed)


def _tile_step(t: _Tile, arrays, alive, bonds, lattice, words, next_id):
    """One full step of one tile, a generator that yields its collectives
    (the JAX engine's ``_domain_step_body``, phase for phase: the single
    engine's ``hipsc_step`` with every value a phase reads about another
    tile's agent taken from a halo exchange). Returns the tile's own rows
    and its diagnostics; the new lattice replicas are the engine's
    (``_Diffuse``)."""
    cfg, c, bio, xp, diff = t.cfg, t.consts, t.bio, t.xp, t.diff
    base = cfg.base
    Tx, Ty = cfg.n_tx, cfg.n_ty
    P, H, C = cfg.per_stripe, cfg.halo_cap, cfg.local_capacity
    dev = alive.device
    plain = dev.type == "cpu"

    arrays = {k: _pad_rows(v, C) for k, v in arrays.items()}
    alive = _pad_rows(alive, C)
    bonds = BondState(_pad_rows(bonds.partners, C), _pad_rows(bonds.mask, C))
    owned = torch.arange(C, device=dev) < P
    k_div, k_path, k_diff, k_stoch, k_mot = words[2:12].view(5, 2).unbind(0)
    step_number = words[12]
    size = torch.stack([torch.full((), float(v), dtype=torch.float32, device=dev)
                        for v in t.gen.size])

    # --- bio halo exchange A: the membership is the boundary bin column /
    # row, frozen for the step. An own row in bin (c, r) probes bins
    # (c +- 1, r +- 1), so the only other tiles' candidates are the adjacent
    # tiles' boundary columns and rows and the diagonal tiles' corner bins.
    # The exchange is dimension-ordered (y, then x forwarding the y halo
    # rows just received), so the corners arrive in two hops.
    gco0 = nbr_ops._bin_coords(base.nbr_spec, arrays["locations"][:P])
    col0, row0 = gco0[:, 0], gco0[:, 1]
    alive_own = alive[:P]
    x_src = P + (2 * H if Ty > 1 else 0)  # own rows, then the y halo blocks

    def bio_band(idx, val, n_src):
        return _pack([arrays[k][:n_src] for k in _BIO_LANES] + [alive[:n_src]], idx, val)

    def bio_apply_block(pack, start):
        likes = [arrays[k] for k in _BIO_LANES] + [alive]
        for k, v in zip(_BIO_LANES + ("alive",), _unpack(pack, likes)):
            (alive if k == "alive" else arrays[k])[start:start + H].copy_(v)

    if Ty > 1:
        idxD, valD, cntD = _compact_idx(alive_own & (row0 == c.nrl), H)
        idxU, valU, cntU = _compact_idx(alive_own & (row0 == c.nrh - 1), H)

        def bio_exchange_y():
            fD, fU = yield _Exchange(1, bio_band(idxD, valD, P), bio_band(idxU, valU, P))
            bio_apply_block(fD, P)
            bio_apply_block(fU, P + H)

        # the x membership freezes after the first y apply: it reads the y
        # halo rows to pick the corner rows it forwards
        yield from bio_exchange_y()
        colx = nbr_ops._bin_coords(base.nbr_spec, arrays["locations"][:x_src])[:, 0]
        alive_x = alive[:x_src]
        idxL, valL, cntL = _compact_idx(alive_x & (colx == c.ncl), H)
        idxR, valR, cntR = _compact_idx(alive_x & (colx == c.nch - 1), H)
        bio_band_max = torch.stack([cntL, cntR, cntD, cntU]).max()
    else:
        idxL, valL, cntL = _compact_idx(alive_own & (col0 == c.ncl), H)
        idxR, valR, cntR = _compact_idx(alive_own & (col0 == c.nch - 1), H)
        bio_band_max = torch.maximum(cntL, cntR)

    def bio_exchange_x():
        fL, fR = yield _Exchange(0, bio_band(idxL, valL, x_src), bio_band(idxR, valR, x_src))
        bio_apply_block(fL, x_src)
        bio_apply_block(fR, x_src + H)

    def bio_refresh():
        """Re-send every frozen bio band with current values, y before x so
        forwarded corner rows carry this round's values."""
        if Ty > 1:
            yield from bio_exchange_y()
        yield from bio_exchange_x()

    yield from bio_exchange_x()  # completes exchange A

    # --- the step's neighbour graph: frozen, built over own + halo rows,
    # which stay in slot order; the moments gather through its order ---
    loc0 = arrays["locations"]
    nflat, ncoords = nbr_ops.local_flat(cfg.nbr_spec_local,
                                        nbr_ops._bin_coords(base.nbr_spec, loc0),
                                        c.col_off_nbr, c.row_off_nbr, alive)
    nbr_grid = nbr_ops.grid_from_flat_coords(nflat, ncoords, arrays["ids"])
    nbr_bounds = nbr_ops.run_bounds(cfg.nbr_spec_local, nbr_grid.sorted_flat)
    nbr_pos0 = bio_positions(loc0[nbr_grid.order])
    # the colony's sorted order: every tile's own rows per global bin
    nbr_counts = yield _Reduce("isum", _bin_counts(base.nbr_spec, loc0, alive & owned))
    nbr_grouping = _tile_grouping(base.nbr_spec, nbr_counts, loc0[nbr_grid.order],
                                  nbr_grid.sorted_flat, cfg.nbr_spec_local, base.nbr_span,
                                  base.capacity, cfg.n_stripes * P)
    nbr_run, _ = _window_widths(nbr_bounds)
    nbr_width = int((yield _Reduce("max", nbr_run))) if plain else None

    def moments(alive_now, mode, loc1=None, f0=None, f1=None, f2=None):
        return neighbor_moments(nbr_pos0, nbr_bounds, alive_now, mode, loc1, f0, f1, f2,
                                radius=bio.neighbor_radius, order=nbr_grid.order,
                                width=nbr_width, grouping=nbr_grouping)

    m1 = moments(alive, "count")
    nbr_count = m1[:, 0].to(torch.int32)

    # --- cell_division: daughter ids by the mothers' global canonical rank ---
    div_counters, dividing = biology.division_clock(arrays, alive, nbr_count, k_div, bio)
    dividing = dividing & owned
    nd_local = dividing.sum()
    if Ty == 1:
        # stripes are contiguous ranges of the global canonical order: the
        # global rank is the dividers of the lower stripes plus the local one
        counts = yield _Reduce("gather", nd_local)
        rank_offset = counts[:t.index].sum().to(torch.int32)
    else:
        # tiles interleave in the global (cx, cy, cz, id) order: every agent
        # of column cx' < cx first, then, within column cx, the tiles of the
        # x-range in ty order. Per-column divider counts are gathered and
        # turned into an offset per local rank.
        nxc = cfg.nbr_nx_local
        cxl0 = (col0 - c.ncl).clamp(0, nxc - 1)
        counts_col = torch.zeros((nxc + 1,), dtype=torch.int64, device=dev)
        counts_col.index_add_(0, torch.where(dividing[:P], cxl0, nxc),
                              torch.ones_like(cxl0))
        counts_col = counts_col[:nxc]
        gathered = (yield _Reduce("gather", counts_col)).reshape(Tx, Ty, nxc)
        tx_i, ty_i = divmod(t.index, Ty)
        total_before_tx = gathered[:tx_i].sum()
        mygroup = gathered[tx_i]  # (Ty, nxc): my x-range's column counts by ty
        colsum = mygroup.sum(dim=0)
        prefix_cols = torch.cumsum(colsum, 0) - colsum
        ty_prefix = mygroup[:ty_i].sum(dim=0)
        own_prefix = torch.cumsum(counts_col, 0) - counts_col
        off_col = (total_before_tx + prefix_cols + ty_prefix - own_prefix).to(torch.int32)
        rank_own = biology.canonical_rank(dividing, nbr_grid.order)[:P]
        dest = torch.where(dividing[:P] & (rank_own < cfg.div_cap), rank_own, cfg.div_cap)
        rank_offset = _scatter_rows(torch.zeros((cfg.div_cap,), dtype=torch.int32, device=dev),
                                    dest, off_col[cxl0])
    arrays, alive, daughter_mask, num_added, num_deferred = biology.division_apply(
        arrays, alive, div_counters, dividing, k_div, bio, base.two_d,
        canon_order=nbr_grid.order, next_id=next_id, div_cap=cfg.div_cap,
        allocatable=owned, rank_offset=rank_offset,
    )
    bonds = clear_bond_rows(bonds, daughter_mask)
    nbr_count = torch.where(daughter_mask, torch.zeros_like(nbr_count), nbr_count)

    # --- cell_death ---
    arrays["death_counters"], removed, _ = biology.cell_death(
        arrays["states"], arrays["death_counters"], alive, nbr_count,
        xp.lonely_thresh, bio.death_thresh,
    )
    removed = removed & owned
    alive = alive & ~removed
    num_removed = removed.sum()

    # --- exchange B: the halo values after division and death ---
    yield from bio_refresh()

    # --- cell_pathway ---
    m2 = moments(alive, "pathway", f0=arrays["FGF4"])
    count2 = m2[:, 0].to(torch.int32)
    field_fgf4 = None
    if (base.enable_diffusion and diff is not None and diff.field_coupling
            and "fgf4_values" in lattice):
        # the lattice is replicated and locations are global: the sample is
        # the single engine's on every tile
        field_fgf4 = diffusion_ops.sample_concentration(
            lattice["fgf4_values"], arrays["locations"], diff.spat_res)
    (
        arrays["FGF4"], arrays["FGFR"], arrays["ERK"],
        arrays["GATA6"], arrays["NANOG"], arrays["fds_counters"],
    ) = biology.cell_pathway(
        arrays["FGF4"], arrays["FGFR"], arrays["ERK"], arrays["GATA6"],
        arrays["NANOG"], arrays["fds_counters"], arrays["ids"], alive, count2,
        m2[:, 1], m2[:, 2], k_path, step_number, xp, bio, field_fgf4=field_fgf4,
    )

    # --- cell_differentiate ---
    arrays["NANOG"], arrays["states"], arrays["diff_counters"] = biology.cell_differentiate(
        arrays["GATA6"], arrays["NANOG"], arrays["states"], arrays["diff_counters"],
        arrays["ids"], alive, k_diff, bio,
    )

    # --- the phases the reference ships disabled ---
    if base.enable_growth:
        arrays["radii"] = biology.cell_growth(
            arrays["radii"], arrays["states"], arrays["div_counters"], alive, bio)
    if base.enable_stochastic:
        arrays["GATA6"], arrays["NANOG"] = biology.cell_stochastic_update(
            arrays["GATA6"], arrays["NANOG"], arrays["ids"], alive, k_stoch, bio)
    # exchange C: the fate updates reach the neighbours before the moments
    yield from bio_refresh()
    if base.enable_diff_surround:
        zero_i = torch.zeros_like(arrays["states"])
        m_ds = moments(alive, "motility", arrays["locations"], zero_i, zero_i,
                       arrays["states"])
        arrays["GATA6"], arrays["NANOG"] = biology.cell_diff_surround(
            arrays["GATA6"], arrays["NANOG"], arrays["states"], alive,
            m_ds[:, 7].to(torch.int32), bio)
        yield from bio_refresh()

    # --- FGF4 secretion and FTCS diffusion on the replicated lattice ---
    if base.enable_diffusion and diff is not None:
        for gname in sorted(lattice):
            delta = None
            if gname == "fgf4_values" and (diff.release_amount > 0.0
                                           or diff.uptake_amount > 0.0):
                secreting = alive & owned & (arrays["NANOG"] > arrays["GATA6"])
                amounts = torch.where(secreting, diff.release_amount, 0.0)
                amounts = amounts - torch.where(alive & owned, diff.uptake_amount, 0.0)
                delta = diffusion_ops.deposit_morphogen(
                    torch.zeros_like(lattice[gname]), arrays["locations"],
                    amounts.to(torch.float32), diff.spat_res)
            yield _Diffuse(gname, delta)

    # --- cell_motility ---
    m3 = moments(alive, "motility", arrays["locations"], arrays["GATA6"], arrays["NANOG"],
                 arrays["states"])
    arrays["motility_forces"] = biology.cell_motility(
        arrays["locations"], arrays["GATA6"], arrays["NANOG"], arrays["states"],
        arrays["motility_forces"], arrays["ids"], alive, count2,
        m3[:, 3].to(torch.int32), m3[:, 4:7], m3[:, 7].to(torch.int32), m3[:, 8:11],
        k_mot, xp, bio, base.two_d,
    )

    # --- the contact substeps with per-substep band exchanges ---
    locations, bonds, phys = yield from _tile_physics(t, arrays, alive, bonds, size, plain)
    arrays["locations"] = locations
    arrays["jkr_forces"] = torch.zeros_like(arrays["jkr_forces"])
    arrays["motility_forces"] = torch.zeros_like(arrays["motility_forces"])

    # --- migration: agents whose bin column / row left the tile are
    # re-homed, x first, then y (a diagonal crossing takes both hops) ---
    arrays, alive, bonds, mig_out, mig_short, too_far = yield from _migrate(
        t, arrays, alive, bonds, c.ncl, c.nch, c.prev_ncl, c.next_nch, axis=0)
    if Ty > 1:
        arrays, alive, bonds, out_y, short_y, far_y = yield from _migrate(
            t, arrays, alive, bonds, c.nrl, c.nrh, c.prev_nrl, c.next_nrh, axis=1)
        mig_out = torch.maximum(mig_out, out_y)
        mig_short = mig_short + short_y
        too_far = too_far + far_y

    alive_own = alive[:P]
    diag = dict(
        num_agents=alive_own.sum(), num_added=num_added, num_removed=num_removed,
        num_deferred=num_deferred, num_dividing=nd_local, nbr_max_in_bin=nbr_run,
        jkr_max_in_bin=phys["runs"], jkr_max_degree=phys["degs"],
        max_id=torch.where(alive_own, arrays["ids"][:P], 0).max(),
        bio_band_max=bio_band_max, phys_band_max=phys["bands"], mig_out_max=mig_out,
        mig_shortfall=mig_short, mig_too_far=too_far,
        halo_miss=torch.zeros((), dtype=torch.int64, device=dev),
        drift_exceed=phys["exceeds"], jkr_span_needed=phys["cands"],
        max_substep_move=phys["move"], jkr_rebuilds=phys["rebuilds"],
        jkr_block_span=phys["spans"], nbr_block_span=nbr_grouping.needed,
    )
    own = ({k: v[:P] for k, v in arrays.items()}, alive_own,
           BondState(bonds.partners[:P], bonds.mask[:P]))
    return own, diag


def _tile_physics(t: _Tile, arrays, alive, bonds, size, plain: bool):
    """The physics substeps of one tile (the JAX engine's
    ``_domain_physics`` and ``_domain_physics_pallas_scan``), a generator.

    The contact window and the halo membership are frozen together at each
    rebuild; between rebuilds every substep re-sends the positions of the
    same frozen band rows, so every candidate of an own row carries its
    owner's current position, and the rebuilds follow the global drift
    predicate: the single engine's schedule. The rows stay in the window's
    sorted order across substeps, as in the single engine's scan; the halo
    rows' slots are reached through the inverse permutation (``inv``), so a
    band lands at its fixed slot positions without unsorting the rows. A
    rebuild re-sorts the rows after the exchange has replaced the halo
    blocks; on the span-mask path the mask is compacted to partner ids
    before the exchange, over the rows it was built against.

    Returns the slot-order locations (C, 3), the slot-order bonds and the
    probes."""
    cfg, c, bio = t.cfg, t.consts, t.bio
    base = cfg.base
    Ty = cfg.n_ty
    P, H, C = cfg.per_stripe, cfg.halo_cap, cfg.local_capacity
    spec_l, gspec = cfg.jkr_spec_local, base.jkr_spec
    dev = alive.device
    dts = _physics_dts(bio)
    law = _contact_law(base, bio)
    span = base.contact_path == "span_mask"
    x_src = P + (2 * H if Ty > 1 else 0)
    threshold = drift_threshold(base.verlet_skin)

    def jbin(v, n):
        return (torch.floor(v * xla_f32.recip(gspec.cell_size)).to(torch.int64)
                + 1).clamp(0, n - 1)

    counts = None  # the colony's contact-bin counts at the window's build

    def window(_cfg, rows):
        gc = nbr_ops._bin_coords(gspec, rows["loc"])
        flat, coords = nbr_ops.local_flat(spec_l, gc, c.col_off_jkr, c.row_off_jkr,
                                          rows["alive"])
        grid = nbr_ops.grid_from_flat_coords(flat, coords, rows["ids"])
        grouping = _tile_grouping(gspec, counts, rows["loc"][grid.order], grid.sorted_flat,
                                  spec_l, base.jkr_span, base.capacity, cfg.n_stripes * P)
        return grid.order, nbr_ops.run_bounds(spec_l, grid.sorted_flat), grouping

    def own_counts():
        return _Reduce("isum", _bin_counts(gspec, rows["loc"],
                                           rows["alive"] & (rows["perm"] < P)))

    rows = {"loc": arrays["locations"].clone(), "rad": arrays["radii"].clone(),
            "mot": arrays["motility_forces"], "ids": arrays["ids"].clone(),
            "alive": alive.clone(), "partners": bonds.ids(),
            "perm": torch.arange(C, dtype=torch.int64, device=dev)}
    inv = rows["perm"]
    band_lanes = ("loc", "rad", "ids", "alive")

    def slot_rows(k, n):
        return rows[k][inv[:n]]

    def fresh_y():
        own_alive, rj = slot_rows("alive", P), jbin(slot_rows("loc", P)[:, 1], gspec.ny)
        idxD, valD, cntD = _compact_idx(own_alive & (rj <= c.sd_fresh), H)
        idxU, valU, cntU = _compact_idx(own_alive & (rj >= c.su_fresh), H)
        return (idxD, valD, idxU, valU), torch.maximum(cntD, cntU)

    def fresh_x():
        src_alive, cj = slot_rows("alive", x_src), jbin(slot_rows("loc", x_src)[:, 0], gspec.nx)
        idxL, valL, cntL = _compact_idx(src_alive & (cj <= c.sl_fresh), H)
        idxR, valR, cntR = _compact_idx(src_alive & (cj >= c.sr_fresh), H)
        return (idxL, valL, idxR, valR), torch.maximum(cntL, cntR)

    def band_pack(idx, val):
        return _pack([rows[k] for k in band_lanes], inv[idx], val)

    def apply_block(start, recv, stale, keep):
        """Update one halo block: at a rebuild the kept received rows
        replace it (the others are zeroed in place, keeping the sender's
        positional order that the refreshes rely on); between rebuilds the
        received rows refresh the frozen rows' positions."""
        pos = inv[start:start + H]
        r_loc, r_rad, r_ids, r_alive = _unpack(recv, [rows[k] for k in band_lanes])
        blk_alive = rows["alive"][pos]
        refreshed = torch.where(blk_alive[:, None], r_loc, rows["loc"][pos])
        fresh = (torch.where(keep[:, None], r_loc, 0.0), torch.where(keep, r_rad, 0.0),
                 torch.where(keep, r_ids, 0), keep & r_alive)
        frozen = (refreshed, rows["rad"][pos], rows["ids"][pos], blk_alive)
        for k, v in zip(band_lanes, _sel(stale, fresh, frozen)):
            rows[k][pos] = v

    def loc_bins(pack):
        loc = _unpack(pack, [rows["loc"]])[0]
        return jbin(loc[:, 0], gspec.nx), jbin(loc[:, 1], gspec.ny)

    def exchange_and_update(frz, stale):
        """The band exchange and halo update of one substep, y (tiles only)
        then x: returns the (possibly re-frozen) membership and the band
        occupancy probe (counted at rebuilds only). For stripes the row
        tests are vacuous (full-range receive rows)."""
        frz_y, frz_x = frz
        counts = []
        if Ty > 1:
            fresh, cnt = fresh_y()
            counts.append(cnt)
            frz_y = _sel(stale, fresh, frz_y)
            fD, fU = yield _Exchange(1, band_pack(*frz_y[:2]), band_pack(*frz_y[2:]))
            apply_block(P, fD, stale, loc_bins(fD)[1] >= c.recv_d_row)
            apply_block(P + H, fU, stale, loc_bins(fU)[1] <= c.recv_u_row)
        # the x membership reads the y halo rows just updated
        fresh, cnt = fresh_x()
        counts.append(cnt)
        frz_x = _sel(stale, fresh, frz_x)
        fL, fR = yield _Exchange(0, band_pack(*frz_x[:2]), band_pack(*frz_x[2:]))
        (cL, rL), (cR, rR) = loc_bins(fL), loc_bins(fR)
        apply_block(x_src, fL, stale,
                    (cL >= c.recv_l_col) & (rL >= c.recv_d_row) & (rL <= c.recv_u_row))
        apply_block(x_src + H, fR, stale,
                    (cR <= c.recv_r_col) & (rR >= c.recv_d_row) & (rR <= c.recv_u_row))
        cnt = torch.stack(counts).max()
        return (frz_y, frz_x), (cnt if stale is True else torch.where(stale, cnt, 0))

    z_i = torch.zeros((H,), dtype=torch.int64, device=dev)
    z_b = torch.zeros((H,), dtype=torch.bool, device=dev)

    # --- entry: the fresh bands, then the window over own + halo rows ---
    frz, band0 = yield from exchange_and_update(((z_i, z_b) * 2, (z_i, z_b) * 2), True)
    counts = yield own_counts()
    rows, bounds, grouping = _build_window(base, rows, window)
    inv = _inverse(rows["perm"])
    ref = rows["loc"]
    rebuild = _RebuildWhere(base, torch.arange(C, device=dev), window)
    K = rows["partners"].shape[1]
    mask = None
    if span:
        mask = torch.empty((mask_words_of(base), C), dtype=torch.int32, device=dev)
    runs, cands, degs, moves2, bands, exceeds, spans = [], [], [], [], [band0], [], []
    rebuilds = torch.zeros((), dtype=torch.int64, device=dev)
    update = _Update.of(base, bio, len(dts), dev, plain)
    drift2 = None
    for s, dt in enumerate(dts):
        own_alive = rows["alive"] & (rows["perm"] < P)
        x, y = rows["loc"][:, 0], rows["loc"][:, 1]
        out = torch.maximum(c.x_lo - x, x - c.x_hi)
        if Ty > 1:
            out = torch.maximum(out, torch.maximum(c.y_lo - y, y - c.y_hi))
        exceeds.append(_masked_max(out, own_alive))
        pred = None
        if s > 0:
            # the previous substep's update measured its own rows' drift
            stale = (yield _Reduce("max", drift2)) > threshold
            if span:
                pred = stale.to(torch.int32).reshape(1)
                span_mask.mask_compact_cuda(rows["ids"], bounds, mask, K, pred=pred,
                                            out=rows["partners"])
            frz, band = yield from exchange_and_update(frz, stale)
            bands.append(band)
            counts = yield own_counts()
            rows, bounds, ref, grouping = rebuild(s, stale, rows, bounds, ref, grouping)
            inv = _inverse(rows["perm"])
            rebuilds = rebuilds + stale
        run, widest_row = _window_widths(bounds)
        runs.append(run)
        cands.append(widest_row)
        spans.append(grouping.needed)
        width = int((yield _Reduce("max", run))) if plain else None
        counted = rows["alive"] & (rows["perm"] < P)
        if span:
            degree, move2, drift2, _ = span_mask_substep(law, update, s, size, dt, rows, bounds,
                                                         ref, mask, pred, width=width,
                                                         counted=counted, grouping=grouping)
        else:
            rows, degree, move2, drift2, _ = contact_substep_rows(
                law, contact_substep_cuda, update, s, size, dt, rows, bounds, ref,
                width=width, counted=counted, grouping=grouping)
        degs.append(torch.where(counted, degree, 0).max())
        moves2.append(move2)
    if span:
        rows["partners"] = span_mask.mask_compact_cuda(rows["ids"], bounds, mask, K)
    perm = rows["perm"]
    locations = torch.empty_like(rows["loc"])
    locations[perm] = rows["loc"]
    partners = torch.empty_like(rows["partners"])
    partners[perm] = rows["partners"]
    probes = dict(runs=torch.stack(runs).max(), cands=torch.stack(cands).max(),
                  degs=torch.stack(degs).max(), bands=torch.stack(bands).max(),
                  exceeds=torch.stack(exceeds).max(),
                  move=torch.sqrt(torch.stack(moves2).max()), rebuilds=rebuilds,
                  spans=torch.stack(spans).max())
    return locations, BondState.from_ids(partners), probes


def _migrate(t: _Tile, arrays, alive, bonds, lo, hi, prev_lo, next_hi, axis: int):
    """Re-home the own agents whose radius-15 column (``axis=0``) or row
    (``axis=1``) left the tile, a generator: whole-state packs go to the
    adjacent tile along that axis and land in its free own slots (slot
    order). Called once per cut axis, x first. Slot choice is local and
    identity rides the id, so the dynamics do not see it."""
    cfg = t.cfg
    P, M, C = cfg.per_stripe, cfg.mig_cap, cfg.local_capacity
    col = nbr_ops._bin_coords(cfg.base.nbr_spec, arrays["locations"][:P])[:, axis]
    alive_own = alive[:P]
    out_left = alive_own & (col < lo)
    out_right = alive_own & (col >= hi)
    # an emigrant skipping a tile cannot be delivered by one hop: safe_step
    # raises on this probe
    too_far = (out_left & (col < prev_lo)).sum() + (out_right & (col >= next_hi)).sum()
    idxL, valL, cntL = _compact_idx(out_left, M)
    idxR, valR, cntR = _compact_idx(out_right, M)

    partner_ids = bonds.ids()
    lanes = [arrays[k][:P] for k in _MIG_FIELDS] + [partner_ids[:P]]
    valid_lane = torch.ones((P,), dtype=torch.bool, device=alive.device)
    from_left, from_right = yield _Exchange(axis, _pack(lanes + [valid_lane], idxL, valL),
                                            _pack(lanes + [valid_lane], idxR, valR))

    # free the emigrants' slots, then place the immigrants in free own slots
    alive_own = alive_own & ~(out_left | out_right)
    imm = torch.cat([from_left, from_right], dim=0)  # (2M, L)
    imm_vals = _unpack(imm, lanes + [valid_lane])
    imm_valid = imm_vals[-1]
    free = ~alive_own
    num_free = free.sum()
    free_rank = torch.cumsum(free.to(torch.int64), 0) - 1
    cap2 = 2 * M
    slot_of_rank = _scatter_rows(
        torch.full((cap2,), C, dtype=torch.int64, device=alive.device),
        torch.where(free & (free_rank < cap2), free_rank, cap2),
        torch.arange(P, dtype=torch.int64, device=alive.device))
    imm_rank = torch.cumsum(imm_valid.to(torch.int64), 0) - 1
    placeable = imm_valid & (imm_rank < num_free)
    dest = torch.where(placeable, slot_of_rank[imm_rank.clamp(0, cap2 - 1)], C)
    shortfall = imm_valid.sum() - placeable.sum()

    arrays = dict(arrays)
    for k, v in zip(_MIG_FIELDS, imm_vals):
        arrays[k] = _scatter_rows(arrays[k], dest, v)
    partner_ids = _scatter_rows(partner_ids, dest, imm_vals[len(_MIG_FIELDS)])
    alive_new = torch.cat([alive_own, torch.zeros((C - P,), dtype=torch.bool,
                                                  device=alive.device)])
    alive_new = _scatter_rows(alive_new, dest, True)
    return (arrays, alive_new, BondState.from_ids(partner_ids), torch.maximum(cntL, cntR),
            shortfall, too_far)


# ---------------------------------------------------------------------------
# checkpoint metadata
# ---------------------------------------------------------------------------

# the port's config keys the JAX EngineConfig does not have: left out of
# the domain metadata, so that the JAX package resumes the port's checkpoints
_PORT_ONLY_KEYS = ("contact_path", "mask_bits")


def domain_config_to_meta(cfg: DomainConfig) -> dict:
    """DomainConfig as a JSON-able dict (checkpoint metadata) in the JAX
    package's layout: the base config without the port's own keys (the
    contact path is a kernel choice of the engine that resumes, and the
    mask width is derived again at its first step)."""
    d = dataclasses.asdict(cfg)
    d["base"] = {k: v for k, v in config_to_meta(cfg.base).items() if k not in _PORT_ONLY_KEYS}
    d["col_bounds"] = list(cfg.col_bounds)
    d["row_bounds"] = list(cfg.row_bounds)
    return d


def domain_config_from_meta(meta: dict) -> DomainConfig:
    """The DomainConfig of a checkpoint's metadata, written by either
    package (``engine.config_from_meta`` reads the base)."""
    meta = dict(meta)
    meta["base"] = config_from_meta(meta["base"])
    meta["col_bounds"] = tuple(meta["col_bounds"])
    meta.setdefault("n_ty", 1)
    meta["row_bounds"] = tuple(meta.get("row_bounds", ()))
    meta.setdefault("nbr_ny_local", 0)
    meta.setdefault("jkr_ny_local", 0)
    return DomainConfig(**meta)


# ---------------------------------------------------------------------------
# the host-side driver
# ---------------------------------------------------------------------------


class DomainHipscEngine:
    """Host driver of the decomposed engine: the tile partition, the
    phase-by-phase step over the tiles, and probe-driven capacity growth.
    Gives the colony of ``HipscEngine`` (compared by agent id) for any
    partition.

    ``device`` is never inferred: ``"cuda"`` (the default) runs the kernels
    and raises when CUDA is absent; ``"cpu"`` runs the plain versions.
    ``devices`` places the tiles explicitly (one device per tile); by
    default tile ``s`` lies on ``cuda:{s % device_count}``. ``tiles=(n_tx,
    n_ty)`` or ``n_stripes`` sets the grid (default: one stripe per device
    given, else per card). ``contact_path`` defaults to ``"span_mask"``, the
    JAX domain engine's path on the chip, on every device.

    ``process_group`` (a ``torch.distributed`` group), or ``rank`` and
    ``world`` of the default group, spread the tiles over the group's ranks
    (``parallel.distributed``): this rank steps only its own block of tiles,
    by default all on ``cuda:{rank % device_count}`` (``devices`` then lists
    the local tiles' devices), and every method is called by every rank
    with the same arguments."""

    def __init__(
        self,
        gen: GeneralParams,
        xp: ExperimentalParams,
        bio: Optional[BiologyParams] = None,
        diff: Optional[DiffusionParams] = None,
        n_stripes: Optional[int] = None,
        tiles: Optional[Tuple[int, int]] = None,
        per_stripe: Optional[int] = None,
        halo_cap: int = 256,
        mig_cap: int = 128,
        drift_allowance: float = 15.0,
        enable_diffusion: bool = False,
        enable_growth: bool = False,
        enable_stochastic: bool = False,
        enable_diff_surround: bool = False,
        device="cuda",
        devices: Optional[Sequence] = None,
        contact_path: str = "span_mask",
        process_group=None,
        rank: Optional[int] = None,
        world: Optional[int] = None,
    ):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("DomainHipscEngine(device='cuda') needs a CUDA device")
        if tiles is not None and n_stripes is not None:
            raise ValueError("pass either tiles=(n_tx, n_ty) or n_stripes")
        group = _process_group(process_group, rank, world)
        if tiles is not None:
            S = int(tiles[0]) * int(tiles[1])
        elif n_stripes is not None:
            S = int(n_stripes)
        elif devices is not None and group is None:
            S = len(devices)
        else:
            S = torch.cuda.device_count() if device.type == "cuda" else 1
        n_ty = int(tiles[1]) if tiles is not None else 1
        # the tiles this process steps: all of them, or its rank's block
        self.transport = None
        self.tiles = list(range(S))
        if group is not None:
            from hipsc_abm_tpu_torch.parallel.distributed import Transport

            if device.type == "cuda" and device.index is None:
                device = torch.device("cuda", dist.get_rank(group) % torch.cuda.device_count())
            self.transport = Transport(group, S, device)
            self.tiles = self.transport.local_tiles
            if devices is None:
                devices = [device] * len(self.tiles)
        if devices is None:
            devices = ([torch.device("cuda", s % torch.cuda.device_count()) for s in range(S)]
                       if device.type == "cuda" else [device] * S)
        self.devices = [torch.device(d) for d in devices]
        if len(self.devices) != len(self.tiles):
            raise ValueError(f"{len(self.devices)} devices for {len(self.tiles)} tiles")
        if any(d.type == "cuda" and d.index is None for d in self.devices):
            self.devices = [torch.device("cuda", torch.cuda.current_device())
                            if d.type == "cuda" and d.index is None else d
                            for d in self.devices]
        self.device = self.devices[0]
        # one lattice replica per distinct device, in order of first use
        self.replica_devices = list(dict.fromkeys(self.devices))
        self._replica_of = [self.replica_devices.index(d) for d in self.devices]
        self.gen = gen
        self.xp = xp
        self.bio = bio or BiologyParams()
        self.diff = diff

        n0 = gen.num_to_start + xp.num_gata6
        capacity = max(_round_up(int(n0 * 1.3), 256), 256)
        base = EngineConfig.create(
            gen.size, capacity=capacity, bio=self.bio,
            enable_diffusion=enable_diffusion, enable_growth=enable_growth,
            enable_stochastic=enable_stochastic, enable_diff_surround=enable_diff_surround,
            uniform_radius=None if enable_growth else self.bio.max_radius,
            contact_path=contact_path,
        )
        if per_stripe is None:
            per_stripe = max(_round_up(int(n0 / S * 2.0), 256), 256)
        self.cfg = self._make_cfg(base, S, per_stripe, halo_cap, mig_cap, drift_allowance,
                                  n_ty=n_ty)
        # the attempts of the last safe_step / run_steps call; by each step
        # of the last attempt, the bytes handed between this process's tiles
        # (copies on one rank) and those its tiles received from other ranks
        self.attempts = 0
        self.exchange_bytes: List[int] = []
        self.rank_bytes: List[int] = []

    # -- partition --------------------------------------------------------

    def _axis_partition(self, base, n_parts, axis_i, drift, kind, bounds=None):
        """Bin-boundary partition of one box axis with its sizing checks:
        ``(bounds, nbr_n_local, jkr_n_local)``. ``bounds=None`` splits the
        axis uniformly; explicit (n_parts + 1,) bounds (``rebalance``'s
        quantiles) are checked against the same width rules."""
        cell = base.nbr_spec.cell_size
        jcell = base.jkr_spec.cell_size
        size_a = self.gen.size[axis_i]
        lo, hi = 1, int(math.ceil(size_a / cell)) + 2
        if bounds is None:
            bounds = tuple(lo + round(i * (hi - lo) / n_parts) for i in range(n_parts + 1))
        else:
            bounds = tuple(int(b) for b in bounds)
            if len(bounds) != n_parts + 1 or bounds[0] != lo or bounds[-1] != hi:
                raise ValueError(f"explicit {kind} bounds must span [{lo}, {hi}]: {bounds}")
        widths = [bounds[i + 1] - bounds[i] for i in range(n_parts)]
        if min(widths) < 3:
            raise ValueError(
                f"{kind} need >= 3 neighbor-bin {'columns' if axis_i == 0 else 'rows'}; "
                f"box {size_a} um / {n_parts} {kind} gives widths {widths}")
        min_width_um = min(widths) * cell
        need = 2 * drift + 2 * jcell + cell
        if min_width_um <= need:
            raise ValueError(f"{kind} width {min_width_um:.0f} um must exceed "
                             f"2*drift + 2*contact bins = {need:.0f} um; use fewer {kind}")
        nbr_n_local = max(widths) + 4
        # the local contact lattice covers [lo - drift, hi + drift], the two
        # receive bands and the clip pads
        jkr_n_local = 0
        for s in range(n_parts):
            a_lo = (bounds[s] - 1) * cell
            a_hi = (bounds[s + 1] - 1) * cell
            lo_col = math.floor((a_lo - drift) / jcell) + 1 - 4
            hi_col = math.floor((a_hi + drift) / jcell) + 1 + 4
            jkr_n_local = max(jkr_n_local, hi_col - lo_col + 1)
        return bounds, int(nbr_n_local), int(jkr_n_local)

    def _make_cfg(self, base, S, per_stripe, halo_cap, mig_cap, drift, n_ty=1,
                  col_bounds=None, row_bounds=None) -> DomainConfig:
        n_tx = S // n_ty
        if n_tx * n_ty != S:
            raise ValueError(f"{S} tiles do not form a grid of {n_ty} rows")
        xb, nbr_nx_local, jkr_nx_local = self._axis_partition(
            base, n_tx, 0, drift, "stripes", bounds=col_bounds)
        if n_ty > 1:
            yb, nbr_ny_local, jkr_ny_local = self._axis_partition(
                base, n_ty, 1, drift, "y-tiles", bounds=row_bounds)
        else:
            yb, nbr_ny_local, jkr_ny_local = (), 0, 0
        return DomainConfig(
            base=base, n_stripes=S, per_stripe=int(per_stripe),
            halo_cap=_round_up(int(halo_cap), 128), mig_cap=int(mig_cap),
            div_cap=max(128, _round_up(int(per_stripe) // 32, 128)),
            drift_allowance=float(drift), col_bounds=xb, nbr_nx_local=nbr_nx_local,
            jkr_nx_local=jkr_nx_local, n_ty=int(n_ty), row_bounds=yb,
            nbr_ny_local=nbr_ny_local, jkr_ny_local=jkr_ny_local,
        )

    def _stripe_consts(self, cfg: DomainConfig) -> List[_TileConsts]:
        """Each tile's static constants (the JAX engine's, one set per cut
        axis; for x-stripes the y entries are full-range dummies)."""
        base = cfg.base
        cell = base.nbr_spec.cell_size
        jcell = base.jkr_spec.cell_size
        D = cfg.drift_allowance
        Tx, Ty = cfg.n_tx, cfg.n_ty
        xb, yb = cfg.col_bounds, cfg.row_bounds
        consts = []

        def cjk(x):
            return math.floor(x / jcell) + 1

        def axis_consts(lo_b, hi_b, prev_b, next_b):
            a_lo = (lo_b - 1) * cell
            a_hi = (hi_b - 1) * cell
            off_nbr = lo_b - 2
            off_jkr = cjk(a_lo - D) - 4
            # receive bins: everything an own row can probe given up to D of
            # drift out of the tile, one bin of safety
            recv_lo = cjk(a_lo - D) - 2
            recv_hi = cjk(a_hi + D) + 2
            # fresh send bands: one bin wider than the neighbour's receive
            # bins, so a frozen member stays covered while it drifts
            s_lo = cjk(a_lo + D) + 3
            s_hi = cjk(a_hi - D) - 3
            return (lo_b, hi_b, off_nbr, off_jkr, s_lo, s_hi, recv_lo, recv_hi,
                    prev_b, next_b, a_lo, a_hi)

        for tx in range(Tx):
            xc = axis_consts(xb[tx], xb[tx + 1], xb[tx - 1] if tx > 0 else 0,
                             xb[tx + 2] if tx + 2 <= Tx else xb[Tx])
            for ty in range(Ty):
                if Ty > 1:
                    yc = axis_consts(yb[ty], yb[ty + 1], yb[ty - 1] if ty > 0 else 0,
                                     yb[ty + 2] if ty + 2 <= Ty else yb[Ty])
                else:
                    big = 1 << 20
                    yc = (0, big, 0, 0, 0, big, 0, big, 0, big, -1e30, 1e30)
                consts.append(_TileConsts(
                    xc[0], xc[1], yc[0], yc[1], xc[2], yc[2], xc[3], yc[3],
                    xc[4], xc[5], yc[4], yc[5], xc[6], xc[7], yc[6], yc[7],
                    xc[8], xc[9], yc[8], yc[9],
                    *(float(np.float32(v)) for v in (xc[10], xc[11], yc[10], yc[11]))))
        return consts  # tile s = tx * n_ty + ty

    # -- load balancing -----------------------------------------------------

    def _balanced_axis_bounds(self, vals_um, n_parts, axis_i, drift):
        """Equal-agent-count quantile bounds for one axis (bin-boundary
        integers), nudged to satisfy the minimum-width rules."""
        base = self.cfg.base
        cell = base.nbr_spec.cell_size
        jcell = base.jkr_spec.cell_size
        lo = 1
        hi = int(math.ceil(self.gen.size[axis_i] / cell)) + 2
        cols = np.clip(np.floor(np.asarray(vals_um) / cell).astype(np.int64) + 1, lo, hi - 1)
        qs = np.quantile(cols, np.linspace(0.0, 1.0, n_parts + 1)[1:-1])
        bounds = [lo] + [int(round(q)) + 1 for q in qs] + [hi]
        min_bins = max(3, int(math.floor((2 * drift + 2 * jcell + cell) / cell)) + 1)
        if (hi - lo) < n_parts * min_bins:
            raise ValueError(f"axis {axis_i} has {hi - lo} bins; {n_parts} parts need "
                             f">= {n_parts * min_bins}")
        for i in range(1, n_parts):  # push up
            bounds[i] = max(bounds[i], bounds[i - 1] + min_bins)
        for i in range(n_parts - 1, 0, -1):  # pull back from the top
            bounds[i] = min(bounds[i], bounds[i + 1] - min_bins)
        return tuple(bounds)

    def rebalance(self, dstate: DomainState) -> DomainState:
        """Re-partition the tile grid at equal-agent-count quantiles of the
        current colony (x bounds by x quantiles, the shared y bounds by y
        quantiles) and re-home every agent. The dynamics do not depend on
        the partition, so the trajectory is unchanged. Host-side."""
        cfg = self.cfg
        flat = self.to_cell_state(dstate)
        alive = flat.alive.cpu().numpy()
        pts = flat.arrays["locations"].cpu().numpy()[alive]
        if pts.shape[0] == 0:
            return dstate
        xb = self._balanced_axis_bounds(pts[:, 0], cfg.n_tx, 0, cfg.drift_allowance)
        yb = (self._balanced_axis_bounds(pts[:, 1], cfg.n_ty, 1, cfg.drift_allowance)
              if cfg.n_ty > 1 else None)
        new = self._make_cfg(cfg.base, cfg.n_stripes, cfg.per_stripe, cfg.halo_cap,
                             cfg.mig_cap, cfg.drift_allowance, n_ty=cfg.n_ty,
                             col_bounds=xb, row_bounds=yb)
        self.cfg = dataclasses.replace(new, div_cap=cfg.div_cap)
        return self.from_cell_state(flat)

    # -- state construction -------------------------------------------------

    def init_state(self, seed: int = 0, locations: Optional[np.ndarray] = None) -> DomainState:
        """The colony of ``HipscEngine.init_state`` (the same draws), laid
        out tile-major."""
        helper = HipscEngine(self.gen, self.xp, self.bio, self.diff, cfg=self.cfg.base,
                             device="cpu")
        return self.from_cell_state(helper.init_state(seed=seed, locations=locations))

    def _tile_of(self, cfg: DomainConfig, locs: np.ndarray) -> np.ndarray:
        """The owning tile of each location (host)."""
        cell = cfg.base.nbr_spec.cell_size

        def part(axis, n, bounds):
            b = np.clip(np.floor(locs[:, axis] / cell).astype(np.int64) + 1, 0, n - 1)
            return np.clip(np.searchsorted(np.asarray(bounds[1:]), b, side="right"),
                           0, len(bounds) - 2)

        tx = part(0, cfg.base.nbr_spec.nx, cfg.col_bounds)
        if cfg.n_ty == 1:
            return tx
        return tx * cfg.n_ty + part(1, cfg.base.nbr_spec.ny, cfg.row_bounds)

    def from_cell_state(self, state: CellState) -> DomainState:
        """Partition a flat ``CellState`` (any device) into the tile-major
        layout on the engine's devices. A partition denser than the per-tile
        slots grows them first. Across ranks every rank passes the same
        colony and keeps its own tiles (the JAX engine's
        ``make_array_from_callback`` contract)."""
        host = convert.state_to_numpy(state)
        cfg = self.cfg
        S = cfg.n_stripes
        alive = host["alive"]
        tile = self._tile_of(cfg, host["arrays"]["locations"])
        need = int(np.bincount(tile[alive], minlength=S).max()) if alive.any() else 0
        if need > cfg.per_stripe:
            self.cfg = cfg = dataclasses.replace(cfg, per_stripe=_round_up(int(need * 1.5), 256))
        tiles = [np.where(alive & (tile == s))[0] for s in self.tiles]
        stacked = {
            "arrays": {k: np.stack([self._fill(v, idx, cfg.per_stripe) for idx in tiles])
                       for k, v in host["arrays"].items()},
            "alive": np.stack([self._fill(alive, idx, cfg.per_stripe) for idx in tiles]),
            "partners": np.stack([self._fill(host["partners"], idx, cfg.per_stripe)
                                  for idx in tiles]),
            "bond_mask": np.stack([self._fill(host["bond_mask"], idx, cfg.per_stripe)
                                   for idx in tiles]),
            "gradients": host["gradients"], "key": host["key"], "step": host["step"],
            "next_id": host["next_id"],
        }
        return convert.domain_state_from_numpy(stacked, self.devices)

    @staticmethod
    def _fill(values: np.ndarray, idx: np.ndarray, n: int) -> np.ndarray:
        out = np.zeros((n,) + values.shape[1:], dtype=values.dtype)
        out[:len(idx)] = values[idx]
        return out

    def to_cell_state(self, dstate: DomainState, capacity: Optional[int] = None) -> CellState:
        """Flatten to a ``CellState`` on the first tile's device, tile-major
        slot order (agents are identified by id, not slot). Across ranks
        every tile is gathered (O(colony), every rank calls it) and every
        rank gets the whole colony."""
        dev = self.device

        def cat(parts):
            parts = [p.to(dev) for p in parts]
            if self.transport is not None:
                parts = self.transport.gather_tiles(parts)
            out = torch.cat(parts, dim=0)
            return out if capacity is None else out[:capacity]

        return CellState(
            arrays={k: cat([a[k] for a in dstate.arrays]) for k in dstate.arrays[0]},
            alive=cat(dstate.alive),
            bonds=BondState(cat([b.partners for b in dstate.bonds]),
                            cat([b.mask for b in dstate.bonds])),
            gradients=dict(dstate.gradients[0]),
            key=dstate.key, step=dstate.step, next_id=dstate.next_id.to(dev),
        )

    # -- checkpoints ----------------------------------------------------------

    def save_checkpoint(self, path: str, dstate: DomainState) -> None:
        """The flat ``CellState`` npz (``utils.checkpoint``) with the
        DomainConfig as metadata; either package resumes it."""
        from hipsc_abm_tpu_torch.utils.checkpoint import save_state

        flat = self.to_cell_state(dstate)
        if self.rank == 0:
            save_state(path, flat, meta={"domain_config": domain_config_to_meta(self.cfg)})
        if self.transport is not None:
            self.transport.barrier()  # returned means written, on every rank

    def load_checkpoint(self, path: str, elastic: bool = False) -> DomainState:
        """Restore a DomainState, adopting the checkpoint's static
        configuration so the resume is bit-exact. ``elastic=True`` resumes
        onto this engine's tiling instead (any tile count): the checkpoint's
        base dynamics configuration is adopted, the decomposition is this
        engine's, and the result is still bit-exact because the dynamics do
        not depend on the layout."""
        from hipsc_abm_tpu_torch.utils.checkpoint import load_state

        state, meta = load_state(path, device=self.device)
        return self._adopt_and_partition(state, meta, elastic=elastic)

    def save_checkpoint_sharded(self, path: str, dstate: DomainState) -> None:
        """The sharded checkpoint (``utils.checkpoint.save_domain_sharded``):
        ``path/shard_{s}.npz`` per tile, each written by the rank that holds
        it, with no O(colony) gather; shard 0 carries the replicated leaves
        and rank 0 the manifest. Every rank calls it. Either package resumes
        it (``load_checkpoint_sharded``), bit-exactly."""
        from hipsc_abm_tpu_torch.utils import checkpoint as ckpt

        host = convert.domain_state_to_numpy(dstate)
        tiles = {s: {"arrays": {k: v[i] for k, v in host["arrays"].items()},
                     "alive": host["alive"][i], "partners": host["partners"][i],
                     "bond_mask": host["bond_mask"][i]}
                 for i, s in enumerate(self.tiles)}
        shared = ({k: host[k] for k in ("gradients", "key", "step", "next_id")}
                  if 0 in self.tiles else None)
        ckpt.save_domain_sharded(
            path, tiles, self.cfg.n_stripes, shared,
            meta={"domain_config": domain_config_to_meta(self.cfg)}, rank=self.rank,
            barrier=None if self.transport is None else self.transport.barrier)

    def load_checkpoint_sharded(self, path: str, elastic: bool = False) -> DomainState:
        """Resume from a sharded checkpoint (either package's), adopting its
        configuration. On the same tile grid each rank reads its own shards
        (and shard 0's replicated leaves) and places every slot block back
        as it was saved, so the resume is bit-exact, the lattice included:
        a re-partition compacts the slots, and the deposit's float sums
        follow slot order. ``elastic=True`` re-partitions the reassembled
        colony onto this engine's grid, as ``load_checkpoint`` does."""
        from hipsc_abm_tpu_torch.utils import checkpoint as ckpt

        meta = ckpt.read_manifest(path)
        if not elastic and "domain_config" in meta:
            cfg = domain_config_from_meta(meta["domain_config"])
            if (cfg.n_stripes, cfg.n_ty) == (self.cfg.n_stripes, self.cfg.n_ty):
                blocks, shared, _ = ckpt.load_domain_tiles(path, self.tiles)
                self.cfg = dataclasses.replace(cfg, base=dataclasses.replace(
                    cfg.base, contact_path=self.cfg.base.contact_path))
                stacked = {k: [blocks[s][k] for s in self.tiles]
                           for k in ("alive", "partners", "bond_mask")}
                stacked["arrays"] = {k: [blocks[s]["arrays"][k] for s in self.tiles]
                                     for k in blocks[self.tiles[0]]["arrays"]}
                return convert.domain_state_from_numpy({**stacked, **shared}, self.devices)
        state, meta = ckpt.load_domain_sharded(path, device="cpu")
        return self._adopt_and_partition(state, meta, elastic=elastic)

    def write_values_sharded(self, dir_path: str, name: str, step: int, dstate: DomainState,
                             order: Optional[Sequence[str]] = None) -> list:
        """One value CSV per tile, ``{name}_values_{step}.shard{s}.csv``,
        written by the rank that holds the tile (alive rows in slot order,
        the JAX package's headers and bytes), each published atomically.
        ``utils.io.merge_sharded_values`` joins them into the one-file
        format. Returns the paths this rank wrote."""
        from hipsc_abm_tpu_torch.utils import io as io_utils

        os.makedirs(dir_path, exist_ok=True)
        order = list(order) if order is not None else sorted(dstate.arrays[0])
        written = []
        for i, s in enumerate(self.tiles):
            mask = dstate.alive[i].cpu().numpy()
            rows = {k: dstate.arrays[i][k].cpu().numpy()[mask] for k in order}
            path = os.path.join(dir_path, f"{name}_values_{step}.shard{s}.csv")
            io_utils.write_values_csv(path + ".tmp", rows, order)
            os.replace(path + ".tmp", path)
            written.append(path)
        return written

    def _adopt_and_partition(self, state: CellState, meta: dict,
                             elastic: bool = False) -> DomainState:
        path = self.cfg.base.contact_path
        if elastic:
            if "domain_config" in meta:
                base = domain_config_from_meta(meta["domain_config"]).base
            elif "engine_config" in meta:
                base = config_from_meta(meta["engine_config"])
            else:
                base = None
            if base is not None:
                base = dataclasses.replace(base, contact_path=path)
                self.cfg = self._make_cfg(base, self.cfg.n_stripes, self.cfg.per_stripe,
                                          self.cfg.halo_cap, self.cfg.mig_cap,
                                          self.cfg.drift_allowance, n_ty=self.cfg.n_ty)
        elif "domain_config" in meta:
            cfg = domain_config_from_meta(meta["domain_config"])
            if (cfg.n_stripes, cfg.n_ty) != (self.cfg.n_stripes, self.cfg.n_ty):
                raise ValueError(
                    f"checkpoint has {cfg.n_tx}x{cfg.n_ty} tiles; this engine has "
                    f"{self.cfg.n_tx}x{self.cfg.n_ty} (pass elastic=True to re-partition)")
            self.cfg = dataclasses.replace(
                cfg, base=dataclasses.replace(cfg.base, contact_path=path))
        return self.from_cell_state(state)

    # -- stepping ---------------------------------------------------------------

    def _on(self, dev: torch.device):
        return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()

    def _cfg_for_state(self, state: DomainState) -> DomainConfig:
        """The config whose static shapes match the state; the span-mask
        path's first step derives ``mask_bits`` from the state (a set-up
        read: the widest contact-window row of the colony, which is the
        widest of every tile's window)."""
        cfg = self.cfg
        if cfg.base.contact_path == "span_mask" and cfg.base.mask_bits == 0:
            bits = initial_mask_bits(cfg.base, self.to_cell_state(state))
            cfg = self.cfg = dataclasses.replace(
                cfg, base=dataclasses.replace(cfg.base, mask_bits=bits))
        P = state.alive[0].shape[0]
        K = state.bonds[0].partners.shape[1]
        if cfg.per_stripe != P or cfg.base.bond_cap != K:
            cfg = dataclasses.replace(cfg, per_stripe=P,
                                      base=dataclasses.replace(cfg.base, bond_cap=K))
        return cfg

    @property
    def rank(self) -> int:
        """This process's rank in the engine's group (0 for one controller)."""
        return 0 if self.transport is None else self.transport.rank

    def _lockstep(self, cfg: DomainConfig, bodies, collective):
        """Advance every local tile's body to its next collective, perform
        it, and hand each tile its result, until the bodies return (together:
        their control flow is the config's). Across ranks every rank first
        states the collective it is at (``Transport.agree``), so that ranks
        that disagree raise instead of exchanging the wrong bytes. Returns
        the bodies' results."""
        msgs, replies, done = [None] * len(bodies), None, [None] * len(bodies)
        while True:
            for i, body in enumerate(bodies):
                with self._on(self.devices[i]):
                    try:
                        msgs[i] = next(body) if replies is None else body.send(replies[i])
                    except StopIteration as stop:
                        done[i] = stop.value
            finished = all(d is not None for d in done)
            if not finished and (any(d is not None for d in done)
                                 or len({_collective_code(m) for m in msgs}) != 1):
                raise RuntimeError("domain tiles diverged at a collective")
            if self.transport is not None:
                code = 0 if finished else _collective_code(msgs[0])
                self.transport.agree(code, "the end of the step" if finished
                                     else type(msgs[0]).__name__)
            if finished:
                return done
            replies = collective(msgs)

    def _deliver(self, x: torch.Tensor, i: int) -> torch.Tensor:
        """``x`` on local tile ``i``'s device, counted in ``exchange_bytes``."""
        self.exchange_bytes[-1] += x.numel() * x.element_size()
        return x.to(self.devices[i], non_blocking=True)

    def _exchange(self, cfg: DomainConfig, msgs) -> list:
        """Tile ``s`` sends ``lo`` to ``s - stride``, where it arrives as
        ``from_hi``, and ``hi`` to ``s + stride`` (``from_lo``). Pairs of
        local tiles copy; the messages between ranks go in one batch, listed
        in tile order with tag ``2 s`` (lo) or ``2 s + 1`` (hi) on every
        rank."""
        axis = msgs[0].axis
        Tx, Ty = cfg.n_tx, cfg.n_ty
        stride, length = (Ty, Tx) if axis == 0 else (1, Ty)
        local = {s: i for i, s in enumerate(self.tiles)}
        replies = [[None, None] for _ in msgs]
        ops, slots = [], []
        for s in range(cfg.n_stripes):
            coord = s // Ty if axis == 0 else s % Ty
            for side, dst, slot, ok in ((0, s - stride, 1, coord > 0),
                                        (1, s + stride, 0, coord < length - 1)):
                src_i, dst_i = local.get(s), local.get(dst)
                if not ok or (src_i is None and dst_i is None):
                    continue
                if src_i is not None and dst_i is not None:
                    replies[dst_i][slot] = self._deliver(msgs[src_i][1 + side], dst_i)
                elif src_i is not None:
                    ops.append(("send", msgs[src_i][1 + side], self.transport.owner(dst),
                                2 * s + side))
                else:
                    ops.append(("recv", msgs[dst_i][2 - slot], self.transport.owner(s),
                                2 * s + side))
                    slots.append((dst_i, slot))
        if ops:
            before = self.transport.rank_bytes
            for (i, slot), got in zip(slots, self.transport.exchange(ops)):
                replies[i][slot] = got
            self.rank_bytes[-1] += self.transport.rank_bytes - before
        for m, r in zip(msgs, replies):
            r[0] = torch.zeros_like(m.hi) if r[0] is None else r[0]
            r[1] = torch.zeros_like(m.lo) if r[1] is None else r[1]
        return [tuple(r) for r in replies]

    def _gathered(self, values: list) -> list:
        """Every tile's value in tile order on the first local device: the
        local values (already there), with the other ranks' gathered."""
        if self.transport is None:
            return values
        before = self.transport.rank_bytes
        out = self.transport.gather_tiles(values)
        self.rank_bytes[-1] += self.transport.rank_bytes - before
        return out

    def _reduce(self, msgs) -> list:
        op = msgs[0].op
        if op == "isum":
            out = msgs[0].value.to(self.devices[0])
            for m in msgs[1:]:
                out = out + self._deliver(m.value, 0)
            if self.transport is not None:
                before = self.transport.rank_bytes
                out = self.transport.all_reduce_sum_int(out)
                self.rank_bytes[-1] += self.transport.rank_bytes - before
            by_dev = {d: out.to(d, non_blocking=True) for d in self.replica_devices}
            return [by_dev[d] for d in self.devices]
        vals = self._gathered([self._deliver(m.value, 0) for m in msgs])
        if op == "sum":
            out = vals[0]
            for v in vals[1:]:
                out = out + v
        elif op == "max":
            out = torch.stack(vals).max(dim=0).values
        else:
            out = torch.stack(vals)
        by_dev = {d: out.to(d, non_blocking=True) for d in self.replica_devices}
        return [by_dev[d] for d in self.devices]

    def _diffuse(self, msgs, gradients, new_gradients) -> list:
        """Sum the deposit deltas in tile order, add the sum to every
        replica, and run FTCS once per device."""
        name, diff = msgs[0].name, self.diff
        total = None
        if msgs[0].delta is not None:
            for d in self._gathered([self._deliver(m.delta, 0) for m in msgs]):
                total = d if total is None else total + d
        dts = diffusion_ops.diffusion_dts(self.bio.step_dt, diff.diffuse_dt)
        by_dev = {}
        for r, dev in enumerate(self.replica_devices):
            grid = gradients[r][name]
            if total is not None:
                grid = grid + total.to(dev, non_blocking=True)
            with self._on(dev):
                by_dev[dev] = ftcs_diffuse_cuda(grid, dts, diff.diffuse_const, diff.spat_res2,
                                                diff.max_concentration, diff.degradation)
            new_gradients[r][name] = by_dev[dev]
        return [by_dev[d] for d in self.devices]

    def _step_once(self, cfg: DomainConfig, state: DomainState, words: list):
        """One decomposed step with the step inputs ``words`` (a (13,)
        int64 row on each replica device): the new state and the (19,)
        float64 probe row, over every tile of every rank, on the first
        tile's device."""
        consts = self._stripe_consts(cfg)
        next_ids = {d: state.next_id.to(d, non_blocking=True) for d in self.replica_devices}
        new_gradients = [dict(g) for g in state.gradients]
        bodies = []
        for i, s in enumerate(self.tiles):
            tile = _Tile(s, cfg, consts[s], self.gen, self.xp, self.bio, self.diff)
            dev, r = self.devices[i], self._replica_of[i]
            with self._on(dev):
                bodies.append(_tile_step(tile, state.arrays[i], state.alive[i],
                                         state.bonds[i], state.gradients[r], words[r],
                                         next_ids[dev]))

        def collective(msgs):
            if isinstance(msgs[0], _Exchange):
                return self._exchange(cfg, msgs)
            if isinstance(msgs[0], _Reduce):
                return self._reduce(msgs)
            return self._diffuse(msgs, state.gradients, new_gradients)

        self.exchange_bytes.append(0)
        self.rank_bytes.append(0)
        results = self._lockstep(cfg, bodies, collective)
        diags = [r[1] for r in results]
        dev0 = self.device
        row = []
        for name in DomainStepInfo._fields:
            vals = torch.stack([d[name].to(dev0).to(torch.float64).reshape(())
                                for d in diags])
            row.append(vals.sum() if name in _SUM_FIELDS else vals.max())
        row = torch.stack(row)
        if self.transport is not None:
            # across ranks: the sums are of integers (exact in any order),
            # the rest are maxima
            row = row.clone()
            row[_SUM_IDX] = self.transport.all_reduce_sum_int(
                row[_SUM_IDX].to(torch.int64)).to(row)
            row[_MAX_IDX] = self.transport.all_reduce_max(row[_MAX_IDX])
        num_added = row[DomainStepInfo._fields.index("num_added")].to(torch.int64)
        new_state = DomainState(
            arrays=tuple(r[0][0] for r in results), alive=tuple(r[0][1] for r in results),
            bonds=tuple(r[0][2] for r in results), gradients=tuple(new_gradients),
            key=state.key, step=state.step + 1,
            next_id=(state.next_id + num_added).to(torch.int32),
        )
        return new_state, row

    def step(self, state: DomainState) -> Tuple[DomainState, DomainStepInfo]:
        """Raw step (no overflow handling); the probes as 0-d tensors."""
        cfg = self._cfg_for_state(state)
        table, keys = step_inputs(state.key, state.step)
        words = [table[0].to(d) for d in self.replica_devices]
        self.exchange_bytes, self.rank_bytes = [], []
        new_state, row = self._step_once(cfg, state, words)
        return new_state._replace(key=keys[0]), DomainStepInfo(*row.unbind(0))

    def safe_step(self, state: DomainState) -> Tuple[DomainState, DomainStepInfo]:
        """Step with exact overflow recovery: any tripped probe grows its
        static capacity and re-executes from the unmodified input state;
        the probes are Python numbers."""
        new_state, rows = self._run_attempts(state, 1)
        return new_state, _info_from_host(rows, stacked=False)

    def run_steps(self, state: DomainState, k: int) -> Tuple[DomainState, DomainStepInfo]:
        """``k`` steps with exact overflow recovery, the result of ``k``
        ``safe_step`` calls: one probe fetch per attempt, and on overflow
        the whole block re-executes from its input with the config grown by
        the block's worst probes. The fields are (k,) numpy arrays."""
        if k < 1:
            raise ValueError(f"run_steps needs k >= 1, got {k}")
        new_state, rows = self._run_attempts(state, k)
        return new_state, _info_from_host(rows, stacked=True)

    def _run_attempts(self, state: DomainState, k: int):
        for attempt in range(1, 17):
            self.attempts = attempt
            cfg = self._cfg_for_state(state)
            table, keys = step_inputs(state.key, state.step, k)
            if self.device.type == "cuda":
                table = table.pin_memory()
            tables = [table.to(d, non_blocking=True) for d in self.replica_devices]
            self.exchange_bytes, self.rank_bytes = [], []
            new_state, rows = state, []
            for j in range(k):
                new_state, row = self._step_once(cfg, new_state, [t[j] for t in tables])
                rows.append(row)
            rows = torch.stack(rows).cpu().tolist()  # the attempt's one host read
            worst = _info_from_host(rows, stacked=True)
            worst = DomainStepInfo(*(np.max(f) for f in worst))
            if int(worst.max_id) >= _ID_LIMIT:
                raise RuntimeError("agent id space exhausted (2^24)")
            if int(worst.mig_too_far) > 0:
                raise RuntimeError("an agent crossed an entire stripe in one step; the "
                                   "decomposition cannot deliver it — use fewer stripes")
            try:
                grown = self._grown_cfg(cfg, worst)
            except ValueError:
                # a grown drift allowance can push the minimum tile width past
                # a tight (rebalanced) partition: re-derive the partition,
                # uniform first, then rebalanced, and re-home the colony
                self.cfg = cfg
                flat = self.to_cell_state(state)
                self.cfg = self._grown_cfg(cfg, worst, drop_bounds=True)
                state = self.from_cell_state(flat)
                try:
                    state = self.rebalance(state)
                except ValueError:
                    pass  # keep the uniform partition
                continue
            if grown is None:
                return new_state._replace(key=keys[-1], step=state.step + k), rows
            self.cfg = grown
            state = self.repad_state(state, grown)
        raise RuntimeError("capacity growth failed to converge")

    def _grown_cfg(self, cfg: DomainConfig, info: DomainStepInfo,
                   drop_bounds: bool = False) -> Optional[DomainConfig]:
        """The config the probes demand, or None. The JAX engine's rules,
        with the span-mask width grown as ``HipscEngine`` grows it (x1.25,
        rounded to a word) from the widest row over the tiles."""
        changed = False
        base = cfg.base
        if int(info.jkr_max_degree) > base.bond_cap:
            need = _round_up(int(info.jkr_max_degree) * 2, 8)
            if need > MAX_BOND_CAP:
                raise RuntimeError(_BOND_CAP_GUARD_MSG.format(
                    deg=int(info.jkr_max_degree), need=need, limit=MAX_BOND_CAP))
            base = dataclasses.replace(base, bond_cap=need)
            changed = True
        per_stripe, div_cap = cfg.per_stripe, cfg.div_cap
        if int(info.num_dividing) > div_cap:
            div_cap = min(_round_up(int(info.num_dividing) * 2, 128), per_stripe)
            changed = True
        elif int(info.num_deferred) > 0 or int(info.mig_shortfall) > 0:
            per_stripe = _round_up(per_stripe * 2, 256)
            changed = True
        halo_cap = cfg.halo_cap
        band_need = max(int(info.bio_band_max), int(info.phys_band_max))
        if band_need > halo_cap:
            halo_cap = _round_up(band_need * 2, 128)
            changed = True
        mig_cap = cfg.mig_cap
        if int(info.mig_out_max) > mig_cap:
            mig_cap = _round_up(int(info.mig_out_max) * 2, 8)
            changed = True
        drift = cfg.drift_allowance
        if float(info.drift_exceed) > drift or int(info.halo_miss) > 0:
            drift = drift * 2.0
            changed = True
        if base.contact_path == "span_mask" and int(info.jkr_span_needed) > base.mask_bits:
            base = dataclasses.replace(
                base, mask_bits=_round_up(int(info.jkr_span_needed) * 1.25, 32))
            changed = True
        for key, probe in (("jkr_span", info.jkr_block_span), ("nbr_span", info.nbr_block_span)):
            # HipscEngine's span rule, up to the capacity of the base config,
            # which the tiles' colony may outgrow (the tiles grow their own)
            if int(probe) > getattr(base, key) and getattr(base, key) < base.capacity:
                base = dataclasses.replace(base, **{key: min(
                    _round_up(int(probe) * 1.25, nbr_ops.GROUP_CHUNK), base.capacity)})
                changed = True
        if not changed:
            return None
        # the partition-dependent statics follow (the bands depend on the
        # drift); the existing, possibly rebalanced, bounds stay unless the
        # caller asks for a fresh uniform partition
        new = self._make_cfg(
            base, cfg.n_stripes, per_stripe, halo_cap, mig_cap, drift, n_ty=cfg.n_ty,
            col_bounds=None if drop_bounds else cfg.col_bounds,
            row_bounds=None if (drop_bounds or cfg.n_ty == 1) else cfg.row_bounds)
        return dataclasses.replace(new, div_cap=div_cap)

    @staticmethod
    def repad_state(state: DomainState, cfg: DomainConfig) -> DomainState:
        """Pad a state to grown per-tile slot and bond capacities."""
        P, K = cfg.per_stripe, cfg.base.bond_cap

        def rows(a):
            return a if a.shape[0] == P else _pad_rows(a, P)

        def bond_cols(a):
            if a.shape[1] > K:
                raise ValueError("bond capacity cannot shrink")
            return a if a.shape[1] == K else torch.cat(
                [a, a.new_zeros((a.shape[0], K - a.shape[1]))], dim=1)

        return state._replace(
            arrays=tuple({k: rows(v) for k, v in a.items()} for a in state.arrays),
            alive=tuple(rows(a) for a in state.alive),
            bonds=tuple(BondState(bond_cols(rows(b.partners)), bond_cols(rows(b.mask)))
                        for b in state.bonds),
        )
