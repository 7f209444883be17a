"""The plain hiPSC step and the loop that steps it: a frozen copy of the port's
``engine.hipsc_step(plain=True)`` on the id-list contact path, with the
state construction, the key schedule and the capacity growth it needs.

The step runs the reference's per-step loop body (``cell_simulation.py``)
in the port's phase order: the canonical ``(flat bin, id)`` sort, the
radius-15 neighbour moments, division and death, the pathway and
differentiation phases, the optional growth, stochastic-bump and
diff_surround phases, FGF4 secretion and FTCS diffusion, motility, and 11
JKR-contact + Stokes substeps over Verlet-cached stencil runs. Every part is
plain PyTorch (``reference.contact``, ``reference.bio_moments``,
``reference.diffusion``, ``reference.integrate``), run as it is on the CPU
or the card: nothing here launches a hand-written kernel or reads a table
another program made.

``Reference.run`` steps a state as the port's ``safe_step`` does: a step
whose static capacity overflowed (bond degree, daughter table, free slots,
the sums' span caps) is run again from its input with that capacity grown
by the same rule, so the result does not depend on where the capacities
started.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import biology
from . import diffusion as diffusion_ops
from . import neighbors as nbr_ops
from . import rng
from .bio_moments import bio_moments_plain
from .bio_moments import positions as bio_positions
from .contact import contact_substep_plain
from .integrate import update_plain
from .jkr import BondState, clear_bond_rows, pack_physics
from .neighbors import GridSpec
from .params import BiologyParams, DiffusionParams, ExperimentalParams, GeneralParams


class CellState(NamedTuple):
    """A colony: per-agent slot arrays, the slot occupancy, the bond graph
    as (C, K) partner ids, the morphogen lattices, the (2,) host step key,
    the step counter and the next agent id."""

    arrays: Dict[str, torch.Tensor]
    alive: torch.Tensor
    bonds: BondState
    gradients: Dict[str, torch.Tensor]
    key: torch.Tensor
    step: int
    next_id: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.alive.shape[0]


# per-agent arrays: dtype and vector width
ARRAY_SPECS: Dict[str, Tuple[torch.dtype, Optional[int]]] = {
    "ids": (torch.int32, None),
    "locations": (torch.float32, 3),
    "radii": (torch.float32, None),
    "FGF4": (torch.int32, None),
    "FGFR": (torch.int32, None),
    "ERK": (torch.int32, None),
    "GATA6": (torch.int32, None),
    "NANOG": (torch.int32, None),
    "states": (torch.int32, None),
    "death_counters": (torch.int32, None),
    "diff_counters": (torch.int32, None),
    "div_counters": (torch.int32, None),
    "fds_counters": (torch.int32, None),
    "motility_forces": (torch.float32, 3),
    "jkr_forces": (torch.float32, 3),
}

CAPACITY_QUANTUM = 256
MAX_BOND_CAP = 128


def _round_up(x, m: int) -> int:
    return ((int(x) + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class Config:
    """Static capacities and phase switches of one step."""

    capacity: int
    nbr_spec: GridSpec
    jkr_spec: GridSpec
    bond_cap: int
    two_d: bool
    div_cap: int
    verlet_skin: float
    enable_growth: bool
    enable_stochastic: bool
    enable_diff_surround: bool
    enable_diffusion: bool
    uniform_radius: Optional[float]
    jkr_span: int
    nbr_span: int

    @classmethod
    def create(cls, size, capacity: int, bio: BiologyParams, enable_diffusion: bool,
               enable_growth: bool, enable_stochastic: bool, enable_diff_surround: bool,
               bond_cap: int = 8, verlet_skin: float = 14.0) -> "Config":
        capacity = _round_up(capacity, CAPACITY_QUANTUM)
        return cls(
            capacity=capacity,
            nbr_spec=GridSpec.from_box(size, bio.neighbor_radius, 0),
            jkr_spec=GridSpec.from_box(size, bio.jkr_radius + 2.0 * bio.jkr_break_band
                                       + verlet_skin, 0),
            bond_cap=int(bond_cap),
            two_d=size[2] == 0,
            div_cap=min(max(128, _round_up(capacity // 32, 128)), capacity),
            verlet_skin=float(verlet_skin),
            enable_growth=enable_growth,
            enable_stochastic=enable_stochastic,
            enable_diff_surround=enable_diff_surround,
            enable_diffusion=enable_diffusion,
            # all radii are max_radius at init and only growth changes them
            uniform_radius=None if enable_growth else bio.max_radius,
            jkr_span=nbr_ops.span_cap(512, capacity),
            nbr_span=nbr_ops.span_cap(512, capacity),
        )


class StepInfo(NamedTuple):
    """A step's overflow probes and counts (0-d tensors)."""

    num_agents: object
    num_added: object
    num_removed: object
    num_deferred: object
    num_dividing: object
    jkr_max_degree: object
    jkr_block_span: object
    nbr_block_span: object
    max_id: object


def step_words(key: torch.Tensor, step: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step's inputs from ``(key, step)`` on the host: the (13,) int64
    row of ``split(key, 6)``'s twelve uint32 words (the next key, then the
    division, pathway, differentiation, stochastic and motility keys) and
    the step number, and the next step's (2,) key."""
    words = (int(key[0]) & 0xFFFFFFFF, int(key[1]) & 0xFFFFFFFF)
    split = rng.split_words(words, 6)
    row = [w for pair in split for w in pair] + [step]
    return torch.tensor(row, dtype=torch.int64), torch.tensor(split[0], dtype=torch.int64)


def _physics_dts(bio: BiologyParams) -> np.ndarray:
    """Substep schedule: divmod(step_dt, move_dt) full substeps and the
    remainder substep, which runs even when the remainder is zero."""
    steps, last_dt = divmod(bio.step_dt, bio.move_dt)
    return np.array([bio.move_dt] * int(steps) + [last_dt], dtype=np.float32)


def _sort_state_rows(arrays, alive, bonds, order):
    out = {k: v[order] for k, v in arrays.items()}
    return out, alive[order], BondState(bonds.partners[order], bonds.mask[order])


def window_grouping(bounds: torch.Tensor, span: int) -> nbr_ops.Grouping:
    """The sum order of a window over the whole sorted colony: the blocks'
    span starts under the span cap ``span``, their chunk, and the window's
    span probe."""
    span = nbr_ops.span_cap(span, bounds.shape[0])
    grouping = nbr_ops.grouping_of_bounds(bounds, span, bounds.shape[0],
                                          nbr_ops.effective_chunk(span))
    return grouping._replace(needed=nbr_ops.block_span_needed(bounds, grouping))


def contact_window(cfg: Config, rows):
    """The contact grid of the rows: ``(order, bounds, grouping)``."""
    grid = nbr_ops.build_grid(cfg.jkr_spec, rows["loc"], rows["ids"], rows["alive"])
    bounds = nbr_ops.run_bounds(cfg.jkr_spec, grid.sorted_flat)
    return grid.order, bounds, window_grouping(bounds, cfg.jkr_span)


def drift_threshold(verlet_skin: float) -> float:
    """``(skin / 2)^2`` rounded to float32."""
    return float(np.float32((verlet_skin * 0.5) ** 2))


def physics_scan(cfg: Config, bio: BiologyParams, arrays, alive, bonds, size,
                 stored=torch.float32):
    """The 11 contact substeps on the id-list path: the rows sorted into the
    contact grid's canonical order at entry, and before every later substep
    re-sorted (new run bounds and sum order) where some agent drifted more
    than half the Verlet skin from where the runs were built; each substep
    the plain contact law and the Stokes update, the new positions held in
    the dtype ``stored`` (float32; bfloat16 makes the lower-precision
    control). Returns the new locations and bonds in slot order, the
    largest degree and the widest span probe."""
    capacity = alive.shape[0]
    rows = {"loc": arrays["locations"], "rad": arrays["radii"],
            "mot": arrays["motility_forces"], "ids": arrays["ids"], "alive": alive,
            "partners": bonds.ids(),
            "perm": torch.arange(capacity, dtype=torch.int64, device=alive.device)}
    law = dict(radius=bio.jkr_radius, adhesion_const=bio.adhesion_const,
               poisson=bio.poisson, youngs=bio.youngs, break_d=bio.jkr_break_d,
               uniform_radius=cfg.uniform_radius)
    threshold = drift_threshold(cfg.verlet_skin)
    order, bounds, grouping = contact_window(cfg, rows)
    rows = {k: v[order] for k, v in rows.items()}
    ref = rows["loc"]
    stale = False
    degs, spans = [], []
    for s, dt in enumerate(_physics_dts(bio)):
        if stale:
            order, bounds, grouping = contact_window(cfg, rows)
            rows = {k: v[order] for k, v in rows.items()}
            ref = rows["loc"]
        spans.append(grouping.needed)
        force, degree, partners = contact_substep_plain(
            pack_physics(rows["loc"], rows["rad"]), rows["ids"], rows["alive"], bounds,
            rows["partners"], **law, grouping=grouping)
        new_loc, _, _, stale_t = update_plain(
            rows["loc"], rows["rad"], force, rows["mot"], rows["alive"], ref, size,
            stokes=bio.stokes, dt=float(dt), folded=s == 0, threshold=threshold)
        if stored != torch.float32:
            new_loc = new_loc.to(stored).to(torch.float32)
        rows = dict(rows, loc=new_loc, partners=partners)
        degs.append(degree.max())
        stale = bool(stale_t)
    perm = rows["perm"]
    locations = torch.empty_like(rows["loc"])
    locations[perm] = rows["loc"]
    partners = torch.empty_like(rows["partners"])
    partners[perm] = rows["partners"]
    return (locations, BondState.from_ids(partners), torch.stack(degs).max(),
            torch.stack(spans).max())


def plain_step(state: CellState, cfg: Config, gen: GeneralParams, xp: ExperimentalParams,
               bio: BiologyParams, diff: Optional[DiffusionParams], stored=torch.float32):
    """One full step from ``state``: ``(new state, StepInfo)``; ``stored``
    as in ``physics_scan``."""
    arrays = dict(state.arrays)
    alive, bonds = state.alive, state.bonds
    gradients = dict(state.gradients)
    device = alive.device
    words, next_key = step_words(state.key, state.step)
    words = words.to(device)
    k_div, k_path, k_diff, k_stoch, k_mot = words[2:12].view(5, 2).unbind(0)
    step_number = words[12]
    size = torch.stack([torch.full((), float(v), dtype=torch.float32, device=device)
                        for v in gen.size])

    nbr_grid = nbr_ops.build_grid(cfg.nbr_spec, arrays["locations"], arrays["ids"], alive)
    arrays, alive, bonds = _sort_state_rows(arrays, alive, bonds, nbr_grid.order)
    nbr_bounds = nbr_ops.run_bounds(cfg.nbr_spec, nbr_grid.sorted_flat)
    nbr_grouping = window_grouping(nbr_bounds, cfg.nbr_span)
    nbr_pos0 = bio_positions(arrays["locations"])

    def bio_moments(alive_now, mode, loc1=None, f0=None, f1=None, f2=None):
        return bio_moments_plain(nbr_pos0, alive_now, nbr_bounds, loc1, f0, f1, f2,
                                 radius=bio.neighbor_radius, mode=mode, grouping=nbr_grouping)

    m1 = bio_moments(alive, "count")
    nbr_count = m1[:, 0].to(torch.int32)

    (arrays, alive, daughter_mask, num_added, num_deferred,
     num_dividing) = biology.cell_division(
        arrays, alive, nbr_count, k_div, bio, cfg.two_d, canon_order=None,
        next_id=state.next_id, div_cap=cfg.div_cap or cfg.capacity)
    bonds = clear_bond_rows(bonds, daughter_mask)
    nbr_count = torch.where(daughter_mask, torch.zeros_like(nbr_count), nbr_count)

    arrays["death_counters"], removed, num_removed = biology.cell_death(
        arrays["states"], arrays["death_counters"], alive, nbr_count,
        xp.lonely_thresh, bio.death_thresh)
    alive = alive & ~removed

    m2 = bio_moments(alive, "pathway", f0=arrays["FGF4"])
    count2 = m2[:, 0].to(torch.int32)
    field_fgf4 = None
    if (cfg.enable_diffusion and diff is not None and diff.field_coupling
            and "fgf4_values" in gradients):
        field_fgf4 = diffusion_ops.sample_concentration(
            gradients["fgf4_values"], arrays["locations"], diff.spat_res)
    (arrays["FGF4"], arrays["FGFR"], arrays["ERK"], arrays["GATA6"], arrays["NANOG"],
     arrays["fds_counters"]) = biology.cell_pathway(
        arrays["FGF4"], arrays["FGFR"], arrays["ERK"], arrays["GATA6"],
        arrays["NANOG"], arrays["fds_counters"], arrays["ids"], alive, count2,
        m2[:, 1], m2[:, 2], k_path, step_number, xp, bio, field_fgf4=field_fgf4)

    arrays["NANOG"], arrays["states"], arrays["diff_counters"] = biology.cell_differentiate(
        arrays["GATA6"], arrays["NANOG"], arrays["states"], arrays["diff_counters"],
        arrays["ids"], alive, k_diff, bio)

    if cfg.enable_growth:
        arrays["radii"] = biology.cell_growth(
            arrays["radii"], arrays["states"], arrays["div_counters"], alive, bio)
    if cfg.enable_stochastic:
        arrays["GATA6"], arrays["NANOG"] = biology.cell_stochastic_update(
            arrays["GATA6"], arrays["NANOG"], arrays["ids"], alive, k_stoch, bio)
    if cfg.enable_diff_surround:
        zero_i = torch.zeros_like(arrays["states"])
        m_ds = bio_moments(alive, "motility", arrays["locations"], zero_i, zero_i,
                           arrays["states"])
        arrays["GATA6"], arrays["NANOG"] = biology.cell_diff_surround(
            arrays["GATA6"], arrays["NANOG"], arrays["states"], alive,
            m_ds[:, 7].to(torch.int32), bio)

    if cfg.enable_diffusion and diff is not None:
        np_dts = diffusion_ops.diffusion_dts(bio.step_dt, diff.diffuse_dt)
        for gname in sorted(gradients):
            grid = gradients[gname]
            if gname == "fgf4_values" and (
                    diff.release_amount > 0.0 or diff.uptake_amount > 0.0):
                secreting = alive & (arrays["NANOG"] > arrays["GATA6"])
                amounts = torch.where(secreting, diff.release_amount, 0.0)
                amounts = amounts - torch.where(alive, diff.uptake_amount, 0.0)
                grid = diffusion_ops.deposit_morphogen(
                    grid, arrays["locations"], amounts.to(torch.float32), diff.spat_res)
            gradients[gname] = diffusion_ops.ftcs_diffuse(
                grid, np_dts, diff.diffuse_const, diff.spat_res2,
                diff.max_concentration, diff.degradation)

    m3 = bio_moments(alive, "motility", arrays["locations"], arrays["GATA6"],
                     arrays["NANOG"], arrays["states"])
    arrays["motility_forces"] = biology.cell_motility(
        arrays["locations"], arrays["GATA6"], arrays["NANOG"], arrays["states"],
        arrays["motility_forces"], arrays["ids"], alive, count2,
        m3[:, 3].to(torch.int32), m3[:, 4:7], m3[:, 7].to(torch.int32), m3[:, 8:11],
        k_mot, xp, bio, cfg.two_d)

    locations, bonds, j_deg, j_span = physics_scan(cfg, bio, arrays, alive, bonds, size,
                                                   stored)
    arrays["locations"] = locations
    arrays["jkr_forces"] = torch.zeros_like(arrays["jkr_forces"])
    arrays["motility_forces"] = torch.zeros_like(arrays["motility_forces"])

    info = StepInfo(
        num_agents=alive.sum(), num_added=num_added, num_removed=num_removed,
        num_deferred=num_deferred, num_dividing=num_dividing, jkr_max_degree=j_deg,
        jkr_block_span=j_span, nbr_block_span=nbr_grouping.needed,
        max_id=torch.where(alive, arrays["ids"], torch.zeros_like(arrays["ids"])).max())
    new_state = CellState(arrays=arrays, alive=alive, bonds=bonds, gradients=gradients,
                          key=next_key, step=state.step + 1,
                          next_id=(state.next_id + num_added).to(torch.int32))
    return new_state, info


def grown_config(cfg: Config, info: StepInfo) -> Optional[Config]:
    """The config a step's overflow probes demand, or None: the bond cap
    twice the largest degree (to a multiple of 8), the daughter table twice
    the divisions attempted (to a multiple of 128), the capacity doubled
    where a division was deferred, each span cap 1.25 times its probe (to a
    chunk), never past the capacity."""
    changed = False
    bond_cap, capacity, div_cap = cfg.bond_cap, cfg.capacity, cfg.div_cap
    if int(info.jkr_max_degree) > bond_cap:
        bond_cap = _round_up(int(info.jkr_max_degree) * 2, 8)
        if bond_cap > MAX_BOND_CAP:
            raise RuntimeError(f"contact degree {int(info.jkr_max_degree)} needs a bond cap "
                               f"past {MAX_BOND_CAP}")
        changed = True
    if int(info.num_dividing) > div_cap:
        div_cap = min(_round_up(int(info.num_dividing) * 2, 128), capacity)
        changed = True
    elif int(info.num_deferred) > 0:
        capacity = _round_up(capacity * 2, CAPACITY_QUANTUM)
        changed = True
    spans = {}
    for key, probe in (("jkr_span", info.jkr_block_span), ("nbr_span", info.nbr_block_span)):
        span = getattr(cfg, key)
        if int(probe) > span:
            span = min(_round_up(int(probe) * 1.25, nbr_ops.GROUP_CHUNK), capacity)
            changed = True
        spans[key] = min(span, capacity)
    if not changed:
        return None
    return dataclasses.replace(cfg, bond_cap=bond_cap, capacity=capacity,
                               div_cap=min(div_cap, capacity), **spans)


def repad(state: CellState, cfg: Config) -> CellState:
    """The state padded to ``cfg``'s (larger) capacity and bond cap."""
    C, K = cfg.capacity, cfg.bond_cap

    def pad_rows(a):
        if a.shape[0] == C:
            return a
        pad = torch.zeros((C - a.shape[0],) + tuple(a.shape[1:]), dtype=a.dtype,
                          device=a.device)
        return torch.cat([a, pad], dim=0)

    partners, mask = pad_rows(state.bonds.partners), pad_rows(state.bonds.mask)
    if K > partners.shape[1]:
        extra = (C, K - partners.shape[1])
        partners = torch.cat([partners, partners.new_zeros(extra)], dim=1)
        mask = torch.cat([mask, mask.new_zeros(extra)], dim=1)
    return state._replace(arrays={k: pad_rows(v) for k, v in state.arrays.items()},
                          alive=pad_rows(state.alive), bonds=BondState(partners, mask))


class Reference:
    """The plain model of one colony configuration on ``device``: its
    initial colony from a seed (``init_state``) and ``run``, whole steps
    with capacity growth. ``stored`` is the dtype the contact substeps hold
    positions in: float32 as the configuration states, bfloat16 for the
    lower-precision control."""

    def __init__(self, gen: GeneralParams, xp: ExperimentalParams,
                 bio: Optional[BiologyParams] = None, diff: Optional[DiffusionParams] = None,
                 enable_diffusion: bool = False, enable_growth: bool = False,
                 enable_stochastic: bool = False, enable_diff_surround: bool = False,
                 device="cpu", stored=torch.float32):
        self.gen, self.xp = gen, xp
        self.bio = bio or BiologyParams()
        self.diff = diff
        self.device = torch.device(device)
        self.stored = stored
        n0 = gen.num_to_start + xp.num_gata6
        capacity = max(_round_up(int(n0 * 1.3), CAPACITY_QUANTUM), CAPACITY_QUANTUM)
        self.cfg = Config.create(gen.size, capacity, self.bio, enable_diffusion,
                                 enable_growth, enable_stochastic, enable_diff_surround)

    def init_state(self, seed: int, locations: Optional[np.ndarray] = None) -> CellState:
        """The initial colony (reference ``agent_initials``), drawn with
        ``numpy.random.default_rng(seed)``: uniform positions in the box
        unless ``locations`` are given, every radius ``max_radius``, the
        FDS fields, counters and GATA6-high cells' fields drawn in the
        reference's order."""
        gen, xp, bio, cfg = self.gen, self.xp, self.bio, self.cfg
        n = gen.num_to_start + xp.num_gata6
        C = cfg.capacity
        rs = np.random.default_rng(seed)
        arrays = {}
        for name, (dtype, vec) in ARRAY_SPECS.items():
            shape = (C,) if vec is None else (C, vec)
            arrays[name] = np.zeros(shape, dtype=np.int32 if dtype == torch.int32
                                    else np.float32)
        if locations is None:
            locations = rs.random((n, 3)) * np.asarray(gen.size)
        arrays["ids"][:n] = np.arange(n, dtype=np.int32)
        arrays["locations"][:n] = locations
        arrays["radii"][:n] = bio.max_radius
        for fds in ("FGF4", "FGFR", "ERK", "NANOG"):
            arrays[fds][:n] = rs.integers(0, bio.field, n)
        arrays["death_counters"][:n] = rs.integers(0, bio.death_thresh, n)
        arrays["diff_counters"][:n] = rs.integers(0, bio.pluri_to_diff, n)
        arrays["div_counters"][:n] = rs.integers(0, bio.pluri_div_thresh, n)
        if bio.fds_thresh > 1:
            arrays["fds_counters"][:n] = rs.integers(0, bio.fds_thresh, n)
        g0 = gen.num_to_start
        if xp.num_gata6 > 0:
            arrays["GATA6"][g0:n] = rs.integers(1, max(bio.field, 2), xp.num_gata6)
            arrays["NANOG"][g0:n] = 0
        alive = np.zeros((C,), dtype=bool)
        alive[:n] = True
        gradients = {}
        if cfg.enable_diffusion and self.diff is not None:
            gradients["fgf4_values"] = np.zeros(self.diff.grid_size(gen.size), np.float32)
        dev = self.device
        return CellState(
            arrays={k: torch.from_numpy(v).to(dev) for k, v in arrays.items()},
            alive=torch.from_numpy(alive).to(dev),
            bonds=BondState.empty(C, cfg.bond_cap, device=dev),
            gradients={k: torch.from_numpy(v).to(dev) for k, v in gradients.items()},
            key=rng.prng_key(seed), step=1,
            next_id=torch.tensor(n, dtype=torch.int32, device=dev))

    def run(self, state: CellState, steps: int) -> CellState:
        """``steps`` whole steps from ``state``; a step whose capacities
        overflowed runs again from its input under the grown config."""
        with torch.no_grad():
            for _ in range(steps):
                for _attempt in range(16):
                    cfg = dataclasses.replace(self.cfg, capacity=state.capacity,
                                              bond_cap=state.bonds.partners.shape[1])
                    new_state, info = plain_step(state, cfg, self.gen, self.xp, self.bio,
                                                 self.diff, self.stored)
                    grown = grown_config(cfg, info)
                    if grown is None:
                        break
                    self.cfg = grown
                    state = repad(state, grown)
                else:
                    raise RuntimeError("capacity growth failed to converge")
                state = new_state
        return state
