"""hiPSC biology phases on tensors (port of ``hipsc_abm_tpu/models/biology.py``).

Synchronous-update, id-keyed versions of the reference's ``CellMethods``
(``cell_methods.py``): every agent reads the pre-update state, and every
random draw is a pure function of (step key, agent id, salt), so results
are bit-identical to the JAX package on the same input. Besides the phases
of the flagship step, the three the reference ships disabled
(``cell_simulation.py:98-104``) and the engine runs when their flag is set:
``cell_growth``, ``cell_stochastic_update`` and ``cell_diff_surround``.

JAX's out-of-range ``mode="drop"`` scatters become writes into one extra
sentinel row that is sliced away.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from hipsc_abm_tpu_torch.ops import rng
from hipsc_abm_tpu_torch.params import BiologyParams, ExperimentalParams


def normalize_rows(v: torch.Tensor) -> torch.Tensor:
    """Safe row normalization (``normal_vector``, ``backend.py:186-196``):
    ``v / ||v||`` with zero rows left zero."""
    mag2 = torch.sum(v * v, dim=-1, keepdim=True)
    pos = mag2 > 0
    mag = torch.sqrt(torch.where(pos, mag2, torch.ones_like(mag2)))
    return torch.where(pos, v / mag, torch.zeros_like(v))


def _set_drop(arr: torch.Tensor, index: torch.Tensor, values) -> torch.Tensor:
    """``arr.at[index].set(values, mode="drop")`` for indices in
    ``[0, len(arr)]``: index ``len(arr)`` is the drop sentinel."""
    n = arr.shape[0]
    ext = torch.cat([arr, arr[:1]], dim=0)
    if isinstance(values, torch.Tensor):
        ext[index] = values
    else:  # a scalar rides the launch (a tensor of it would be a copy to the card)
        ext.index_fill_(0, index, values)
    return ext[:n]


# ---------------------------------------------------------------------------
# death / division
# ---------------------------------------------------------------------------


def cell_death(
    states: torch.Tensor,
    death_counters: torch.Tensor,
    alive: torch.Tensor,
    nbr_count: torch.Tensor,
    lonely_thresh: int,
    death_thresh: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``cell_death`` (``cell_methods.py:11-52``): lonely pluripotent cells
    age a death counter; at threshold the slot is freed. Returns (counters,
    removal_mask, num_removed)."""
    pluri = alive & (states == 0)
    lonely = nbr_count < lonely_thresh
    counters = torch.where(
        pluri,
        torch.where(lonely, death_counters + 1, torch.zeros_like(death_counters)),
        death_counters,
    )
    remove = pluri & (counters >= death_thresh)
    return counters, remove, remove.sum()


def canonical_rank(mask: torch.Tensor, canon_order: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-slot rank of the masked agents in the canonical (bin, id) order.
    ``None`` means the slots already are in canonical order (the
    sorted-resident engine): the rank is then a plain cumsum."""
    if canon_order is None:
        return torch.cumsum(mask.to(torch.int64), 0) - 1
    rank_srt = torch.cumsum(mask[canon_order].to(torch.int64), 0) - 1
    rank = torch.zeros_like(rank_srt)
    rank[canon_order] = rank_srt
    return rank


def allocate_daughter_slots(
    dividing: torch.Tensor,
    alive: torch.Tensor,
    canon_order: Optional[torch.Tensor],
    div_cap: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rank-compressed daughter-slot allocation: the r-th mother (canonical
    order) claims the r-th free slot (slot order). Mothers beyond the free
    supply or ``div_cap`` defer. Returns ``(can_divide, rank,
    mother_of_rank, free_slot_of_rank, num_deferred)``; unused table rows
    hold the sentinel ``capacity``."""
    capacity = alive.shape[0]
    device = alive.device
    rank = canonical_rank(dividing, canon_order)
    free = ~alive
    limit = torch.clamp(free.sum(), max=div_cap)
    can_divide = dividing & (rank < limit)

    slots = torch.arange(capacity, dtype=torch.int64, device=device)
    sentinel = torch.full((div_cap,), capacity, dtype=torch.int64, device=device)
    mother_of_rank = _set_drop(
        sentinel, torch.where(can_divide, rank, torch.full_like(rank, div_cap)), slots)
    free_rank = torch.cumsum(free.to(torch.int64), 0) - 1
    free_slot_of_rank = _set_drop(
        sentinel,
        torch.where(free & (free_rank < div_cap), free_rank,
                    torch.full_like(free_rank, div_cap)),
        slots,
    )
    num_can = can_divide.sum()
    r = torch.arange(div_cap, dtype=torch.int64, device=device)
    free_slot_of_rank = torch.where(r < num_can, free_slot_of_rank,
                                    torch.full_like(free_slot_of_rank, capacity))
    num_deferred = dividing.sum() - num_can
    return can_divide, rank, mother_of_rank, free_slot_of_rank, num_deferred


def division_clock(
    arrays: Dict[str, torch.Tensor],
    alive: torch.Tensor,
    nbr_count: torch.Tensor,
    key,
    p: BiologyParams,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Division decision (``cell_methods.py:54-83``): advance the stochastic
    clocks and decide who divides. Returns ``(div_counters, dividing)``."""
    flips = rng.coin_flips(key, arrays["ids"], salt=0)
    div_counters = arrays["div_counters"] + torch.where(alive, flips,
                                                        torch.zeros_like(flips))
    states = arrays["states"]
    pluri_div = (states == 0) & (div_counters >= p.pluri_div_thresh)
    diff_div = (
        (states != 0)
        & (div_counters >= p.diff_div_thresh)
        & (nbr_count < p.div_inhibit_neighbors)
    )
    return div_counters, alive & (pluri_div | diff_div)


def division_apply(
    arrays: Dict[str, torch.Tensor],
    alive: torch.Tensor,
    div_counters: torch.Tensor,
    dividing: torch.Tensor,
    key,
    p: BiologyParams,
    two_d: bool,
    canon_order: Optional[torch.Tensor],
    next_id: torch.Tensor,
    div_cap: int,
):
    """Daughter creation (``cell_methods.py:86-117``): a daughter copies the
    mother's slot values into a free slot and gets id ``next_id + mother's
    canonical rank``; the pair is displaced by +/- a random vector of length
    (max_radius - min_radius) and both division counters reset. Returns
    (arrays, alive, daughter_mask, num_added, num_deferred)."""
    capacity = alive.shape[0]
    ids = arrays["ids"]
    can_divide, _, mother_of_rank, write_slot, num_deferred = (
        allocate_daughter_slots(dividing, alive, canon_order, div_cap)
    )
    disp = rng.unit_vectors(key, ids, two_d, salt=1).to(arrays["locations"].dtype) * (
        p.max_radius - p.min_radius
    )
    # unused ranks gather a clamped row; their write goes to the sentinel
    mother = mother_of_rank.clamp(max=capacity - 1)

    new_arrays = {}
    for name, arr in arrays.items():
        if name == "locations":
            arr = _set_drop(arr, write_slot, (arr - disp)[mother])
            arr = torch.where(can_divide[:, None], arr + disp, arr)
        elif name == "div_counters":
            arr = _set_drop(div_counters, write_slot, 0)
            arr = torch.where(can_divide, torch.zeros_like(arr), arr)
        elif name == "ids":
            daughter_ids = (next_id + torch.arange(div_cap, dtype=torch.int32,
                                                   device=alive.device)).to(arr.dtype)
            arr = _set_drop(arr, write_slot, daughter_ids)
        else:
            arr = _set_drop(arr, write_slot, arr[mother])
        new_arrays[name] = arr

    daughter_mask = _set_drop(torch.zeros_like(alive), write_slot, True)
    return new_arrays, alive | daughter_mask, daughter_mask, can_divide.sum(), num_deferred


def cell_division(
    arrays: Dict[str, torch.Tensor],
    alive: torch.Tensor,
    nbr_count: torch.Tensor,
    key,
    p: BiologyParams,
    two_d: bool,
    canon_order: Optional[torch.Tensor] = None,
    next_id: Optional[torch.Tensor] = None,
    div_cap: Optional[int] = None,
):
    """``cell_division`` (``cell_methods.py:54-117``): the clock, then the
    daughters. Returns (arrays, alive, daughter_mask, num_added,
    num_deferred, num_dividing)."""
    if next_id is None:
        next_id = arrays["ids"].max() + 1
    if div_cap is None:
        div_cap = alive.shape[0]
    div_counters, dividing = division_clock(arrays, alive, nbr_count, key, p)
    new_arrays, new_alive, daughter_mask, num_added, num_deferred = division_apply(
        arrays, alive, div_counters, dividing, key, p, two_d,
        canon_order, next_id, div_cap,
    )
    return (new_arrays, new_alive, daughter_mask, num_added, num_deferred,
            dividing.sum())


# ---------------------------------------------------------------------------
# intracellular pathway / fate
# ---------------------------------------------------------------------------


def cell_pathway(
    FGF4, FGFR, ERK, GATA6, NANOG, fds_counters, ids, alive,
    nbr_count: torch.Tensor,  # (C,) neighbours in the post-death graph
    nbr_FGF4_sum: torch.Tensor,  # (C,) float32 sum of neighbours' FGF4
    nbr_FGF4_sq_sum: torch.Tensor,  # (C,) float32 sum of neighbours' FGF4^2
    key,
    current_step,  # the step number: an int, or a 0-d tensor on the state's device
    xp: ExperimentalParams,
    p: BiologyParams,
    field_fgf4: Optional[torch.Tensor] = None,
):
    """``cell_pathway`` (``cell_methods.py:176-228``): perceived FGF4 is the
    noisy mean over the closed neighbourhood, ``(sum F + g sqrt(sum F^2)) /
    n`` with one N(0, 1) draw per agent (equal in distribution to the
    reference's per-neighbour noise); the finite dynamical system advances
    every ``fds_thresh`` steps once doxycycline is in. The engine passes the
    step number as a device tensor, so that the dox gate is read on the
    device (a captured CUDA graph replays it with each step's number)."""
    active = alive & (current_step >= xp.dox_step)

    g = rng.normal(key, ids, salt=0)
    if field_fgf4 is not None:
        perceived = (1.0 + g) * field_fgf4.to(torch.float32)
    else:
        f_self = FGF4.to(torch.float32)
        n_closed = (nbr_count + 1).to(torch.float32)
        sum_f = nbr_FGF4_sum + f_self
        sum_f2 = nbr_FGF4_sq_sum + f_self * f_self
        # sqrt correctly rounded on the card and the CPU alike (rng.f32_via_f64)
        perceived = (sum_f + g * rng.f32_via_f64(torch.sqrt, sum_f2)) / n_closed
    perceived = torch.clamp(torch.floor(perceived), 0, p.field - 1).to(torch.int32)

    update = active & (fds_counters % p.fds_thresh == 0)

    x1, x2, x3, x4, x5 = perceived, FGFR, ERK, GATA6, NANOG
    if p.field == 2:
        # Boolean network BN_9 (cell_methods.py:212-216)
        nFGF4 = x5
        nFGFR = (1 + x5 + x4 * x5) % 2
        nERK = (x1 * x2) % 2
        nGATA6 = (x3 + x4 + x3 * x4 + x3 * x5 + x4 * x5 + x3 * x4 * x5) % 2
        nNANOG = (x5 + x3 * x5 + x4 * x5 + x3 * x4 * x5) % 2
    else:
        # ternary variant (cell_methods.py:219-225)
        nFGF4 = x5
        nFGFR = (x1 * x4 * ((2 * x1 + 1) * (2 * x4 + 1) + x1 * x4)) % 3
        nERK = x2 % 3
        nGATA6 = ((x4**2) * (x5 + 1) + (x5**2) * (x4 + 1) + 2 * x5 + 1) % 3
        nNANOG = (
            x5**2
            + x5 * (x5 + 1) * (x3 * (2 * x4**2 + 2 * x3 + 1) + x4 * (2 * x3**2 + 2 * x4 + 1))
            + (2 * x3**2 + 1) * (2 * x4**2 + 1)
        ) % 3

    def upd(new, old):
        return torch.where(update, new.to(old.dtype), old)

    return (upd(nFGF4, FGF4), upd(nFGFR, FGFR), upd(nERK, ERK),
            upd(nGATA6, GATA6), upd(nNANOG, NANOG),
            torch.where(active, fds_counters + 1, fds_counters))


def cell_differentiate(GATA6, NANOG, states, diff_counters, ids, alive, key,
                       p: BiologyParams):
    """``cell_differentiate`` (``cell_methods.py:230-244``). Returns
    (NANOG, states, diff_counters)."""
    eligible = alive & (GATA6 > NANOG) & (states == 0)
    flips = rng.coin_flips(key, ids)
    counters = diff_counters + torch.where(eligible, flips, torch.zeros_like(flips))
    trigger = eligible & (counters >= p.pluri_to_diff)
    states = torch.where(trigger, torch.ones_like(states), states)
    NANOG = torch.where(trigger, torch.zeros_like(NANOG), NANOG)
    return NANOG, states, counters


def cell_diff_surround(GATA6, NANOG, states, alive,
                       num_diff_neighbors: torch.Tensor,  # (C,) differentiated neighbours
                       p: BiologyParams):
    """``cell_diff_surround`` (``cell_methods.py:119-141``): >= 6
    differentiated neighbours force a GATA6-low pluripotent cell to GATA6
    high. Returns (GATA6, NANOG)."""
    eligible = alive & (states == 0) & (GATA6 < NANOG)
    induce = eligible & (num_diff_neighbors >= p.diff_surround_neighbors)
    return (torch.where(induce, torch.full_like(GATA6, p.field - 1), GATA6),
            torch.where(induce, torch.zeros_like(NANOG), NANOG))


def cell_growth(radii, states, div_counters, alive, p: BiologyParams) -> torch.Tensor:
    """``cell_growth`` (``cell_methods.py:143-158``): linear radius growth by
    state, re-derived from the division clock. No clamp, as in the
    reference: a radius can pass ``max_radius`` by one increment."""
    growing = alive & (radii < p.max_radius)
    dc = div_counters.to(radii.dtype)
    target = torch.where(states == 0, p.pluri_growth * dc + p.min_radius,
                         p.diff_growth * dc + p.min_radius)
    return torch.where(growing, target, radii)


def cell_stochastic_update(GATA6, NANOG, ids, alive, key, p: BiologyParams,
                           nanog_too: bool = False):
    """``cell_stochastic_update`` (``cell_methods.py:160-174``): a random
    GATA6 bump with probability ``GATA6_prob`` (draw salt 0). The NANOG
    branch is commented out in the reference; ``nanog_too=True`` runs it
    (salt 1). Returns (GATA6, NANOG)."""
    top = p.field - 1
    bump_g = rng.uniform(key, ids, salt=0) < p.GATA6_prob
    GATA6 = torch.where(alive & bump_g & (GATA6 != top), GATA6 + 1, GATA6)
    if nanog_too:
        bump_n = rng.uniform(key, ids, salt=1) < p.NANOG_prob
        NANOG = torch.where(alive & bump_n & (NANOG != top), NANOG + 1, NANOG)
    return GATA6, NANOG


# ---------------------------------------------------------------------------
# motility
# ---------------------------------------------------------------------------


def cell_motility(
    locations, GATA6, NANOG, states, motility_forces, ids, alive,
    nbr_count: torch.Tensor,  # (C,) neighbours in the post-death graph
    cnt_nanog: torch.Tensor,  # (C,) NANOG-high neighbour count
    sum_nanog_disp: torch.Tensor,  # (C, 3) sum of (loc_j - loc_i), NANOG-high j
    cnt_diff: torch.Tensor,  # (C,) differentiated neighbour count
    sum_diff_disp: torch.Tensor,  # (C, 3) sum of (loc_j - loc_i), diff j
    key,
    xp: ExperimentalParams,
    p: BiologyParams,
    two_d: bool,
) -> torch.Tensor:
    """``cell_motility`` (``cell_methods.py:246-340``): cells with fewer than
    6 neighbours get a motive force by type (see the JAX docstring for the
    branches, including the reference's guye self-state test)."""
    free_to_move = alive & (nbr_count < p.motility_crowd_neighbors)

    rand = rng.unit_vectors(key, ids, two_d).to(locations.dtype)
    away_nanog = torch.where(
        (cnt_nanog > 0)[:, None],
        normalize_rows(sum_nanog_disp) * -0.8 + rand * 0.2,
        rand,
    )
    toward_nanog = torch.where(
        (cnt_nanog > 0)[:, None],
        normalize_rows(sum_nanog_disp) * 0.8 + rand * 0.2,
        rand,
    )
    toward_diff = torch.where(
        (cnt_diff > 0)[:, None],
        normalize_rows(sum_diff_disp) * 0.8 + rand * 0.2,
        rand,
    )

    is_diff = states != 0
    gata6_high = GATA6 > NANOG
    nanog_high = GATA6 < NANOG

    if xp.guye_move:
        guye_dir = rand if p.guye_bug_compat else toward_diff
    else:
        guye_dir = away_nanog

    direction = torch.where(
        is_diff[:, None],
        away_nanog,
        torch.where(
            gata6_high[:, None],
            guye_dir,
            torch.where(nanog_high[:, None], toward_nanog, rand),
        ),
    )
    force = torch.where(free_to_move[:, None], direction * p.motility_force,
                        torch.zeros_like(direction))
    return motility_forces + force
