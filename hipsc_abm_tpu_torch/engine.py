"""The fused hiPSC step over a fixed-capacity struct-of-arrays state, in
PyTorch (port of ``hipsc_abm_tpu/engine.py``'s single-device path, in 2D
and 3D boxes).

``hipsc_step`` runs the reference's per-step loop body
(``cell_simulation.py:85-123``) in the same phase order as the JAX engine:
the canonical ``(flat bin, id)`` sort that makes the state sorted-resident,
the neighbour-moment pass for division and death, the pathway and
differentiation phases, the optional growth, stochastic-bump and
diff_surround phases (``EngineConfig.enable_*``), FGF4 secretion and FTCS
diffusion, motility, and 11 JKR-contact + Stokes substeps. Dynamic
population lives in an ``alive`` mask over preallocated slots;
``HipscEngine.safe_step`` re-executes a step from its unmodified input after
growing whichever capacity overflowed, so results are never silently
truncated; ``HipscEngine.run_steps`` does the same for a block of k steps.

A step reads nothing back to the host: the Verlet drift test and the window
rebuild it decides are taken on the device (the JAX engine's ``lax.cond``),
the span-mask path's mask has a static width (``EngineConfig.mask_bits``),
and the step's keys and number come in as a device tensor (``StepInputs``).
On the card ``run_steps`` therefore captures its k steps once per config as
one CUDA graph and replays it, with one probe fetch per block; ``safe_step``
is its block of one step. ``HipscEngine.step`` runs a step eagerly.

The contact substeps have two designs, chosen by ``EngineConfig.contact_path``
(the counterpart of the JAX engine's ``use_pallas`` physics choice):
``"id_list"`` (``_physics_scan``, the JAX ``_physics_scan_xla`` design: bonds
as (C, K) partner ids, one ``ops.contact`` launch per substep) and
``"span_mask"`` (``_physics_scan_span_mask``, the JAX ``_physics_scan_pallas``
design: bonds as a keep mask over the frozen window, ``ops.span_mask``).
Both give the same physics.

The engine has an explicit ``device``. On a CUDA device the neighbour
moments, the contact substeps and the FTCS subcycles run the hand-written
kernels of ``ops.bio_moments``, ``ops.contact`` or ``ops.span_mask`` and
``ops.ftcs``; on the CPU the same wrappers run their plain versions.

A box with ``size[2] > 0`` runs the same step in 3D: nine stencil runs per
row instead of three (``neighbors.run_bounds``), the z lanes of the
neighbour moments, and the kernels' 9-run forms. The morphogen
lattice stays 2D (x, y), as in the JAX engine.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from hipsc_abm_tpu_torch import kernels
from hipsc_abm_tpu_torch.models import biology
from hipsc_abm_tpu_torch.ops import diffusion as diffusion_ops
from hipsc_abm_tpu_torch.ops import neighbors as nbr_ops
from hipsc_abm_tpu_torch.ops import rng, span_mask
from hipsc_abm_tpu_torch.ops.bio_moments import bio_moments_cuda
from hipsc_abm_tpu_torch.ops.bio_moments import positions as bio_positions
from hipsc_abm_tpu_torch.ops.contact import contact_substep_cuda
from hipsc_abm_tpu_torch.ops.ftcs import ftcs_diffuse_cuda
from hipsc_abm_tpu_torch.ops.integrate import stokes_integrate
from hipsc_abm_tpu_torch.ops.jkr import BondState, clear_bond_rows, pack_physics
from hipsc_abm_tpu_torch.ops.neighbors import GridSpec
from hipsc_abm_tpu_torch.params import (
    BiologyParams,
    DiffusionParams,
    ExperimentalParams,
    GeneralParams,
)


class CellState(NamedTuple):
    """Complete simulation state.

    ``arrays["ids"]`` holds stable, never-recycled agent ids: all randomness
    is id-keyed and bonds store partner ids, so dynamics do not depend on
    slot layout. ``key`` is the raw threefry step key, (2,) int64 on the
    host: the key schedule does not depend on the colony, so it is derived
    there (``step_inputs``) and reaches the step as a device tensor.
    ``next_id`` is the id the next daughter born will receive."""

    arrays: Dict[str, torch.Tensor]  # per-agent slot arrays (SoA)
    alive: torch.Tensor  # (C,) bool slot occupancy
    bonds: BondState  # persistent JKR bond graph
    gradients: Dict[str, torch.Tensor]  # morphogen lattices
    key: torch.Tensor  # (2,) int64 uint32 words, host
    step: int  # current step counter
    next_id: torch.Tensor  # () int32, first unassigned agent id

    @property
    def capacity(self) -> int:
        return self.alive.shape[0]

    def num_agents(self) -> int:
        return int(self.alive.sum())


# per-agent arrays of the hiPSC model: dtype and vector width (reference
# ``cell_simulation.py:136-149``; "ids" is the stable agent identity). Every
# integer lane is int32 — none rides a float lane, so ids are exact to 2^31.
HIPSC_ARRAY_SPECS: Dict[str, Tuple[torch.dtype, Optional[int]]] = {
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

# capacities are multiples of this: the JAX engine's quantum, so both
# engines hold the same free slots and defer the same divisions
_CAPACITY_QUANTUM = 256

# Largest bond capacity growth may reach. ~160 bonds per agent is ~21x the
# reference colony's contact degree; no physical hiPSC packing comes near,
# so reaching it means broken force constants or box size, and the engine
# stops with an error instead of growing without bound.
MAX_BOND_CAP = 128

_BOND_CAP_GUARD_MSG = (
    "contact degree {deg} requires bond_cap {need}, past the guarded limit "
    "of {limit}: that is ~21x the reference colony's contact degree, far "
    "outside any physical hiPSC workload — check force constants / box size."
)


def _round_up(x, m: int) -> int:
    return ((int(x) + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static capacities and phase switches of one step."""

    capacity: int
    nbr_spec: GridSpec  # biology neighbour graph, radius 15
    jkr_spec: GridSpec  # contact graph, bin = contact reach + Verlet skin
    bond_cap: int
    two_d: bool
    # static cap on divisions per step (sizes the daughter tables; grown on
    # the num_dividing probe)
    div_cap: int = 0
    # Verlet skin (um): the contact runs are built over bins of (search
    # radius + 2 break bands + skin) and reused across substeps until an
    # agent drifts more than skin/2; contacts are re-tested at the true
    # radius every substep, so the skin only decides how often to re-sort
    verlet_skin: float = 14.0
    # the phases the reference ships disabled (cell_simulation.py:98-104)
    enable_growth: bool = False
    enable_stochastic: bool = False
    enable_diff_surround: bool = False
    enable_diffusion: bool = False
    # equal radii for every agent (growth off): the contact kernels'
    # scalar-radius pair law; None selects the general (per-pair) law
    uniform_radius: Optional[float] = None
    # contact-substep design: "id_list" or "span_mask" (see the module
    # docstring); the default is to be settled by a benchmark
    contact_path: str = "id_list"
    # span-mask path: the most candidates one row's keep mask is sized for
    # (the mask has ceil(mask_bits / 32) words per row); grown by
    # re-execution, to a multiple of 32, when a window build's widest row
    # passes it. 0 until HipscEngine derives it from the state at its first
    # step (a set-up read). Not the JAX engine's jkr_span, a window span of
    # rows.
    mask_bits: int = 0

    def __post_init__(self):
        if self.contact_path not in _PHYSICS_SCANS:
            raise ValueError(f"contact_path must be one of {sorted(_PHYSICS_SCANS)}, "
                             f"got {self.contact_path!r}")

    @classmethod
    def create(
        cls,
        size: Tuple[float, float, float],
        capacity: int,
        bio: BiologyParams,
        bond_cap: int = 8,
        verlet_skin: float = 14.0,
        **flags,
    ) -> "EngineConfig":
        capacity = _round_up(capacity, _CAPACITY_QUANTUM)
        # run_cap is 0: the kernels walk exact run bounds and the plain
        # versions size their windows from the data, so nothing overflows
        nbr_spec = GridSpec.from_box(size, bio.neighbor_radius, 0)
        jkr_spec = GridSpec.from_box(
            size, bio.jkr_radius + 2.0 * bio.jkr_break_band + verlet_skin, 0
        )
        flags.setdefault("div_cap", max(128, _round_up(capacity // 32, 128)))
        flags["div_cap"] = min(int(flags["div_cap"]), capacity)
        return cls(
            capacity=capacity,
            nbr_spec=nbr_spec,
            jkr_spec=jkr_spec,
            bond_cap=int(bond_cap),
            two_d=size[2] == 0,
            verlet_skin=float(verlet_skin),
            **flags,
        )


def config_to_meta(cfg: EngineConfig) -> dict:
    """EngineConfig as a plain JSON-able dict (checkpoint metadata). A
    resume must restore the exact configuration (capacities decide which
    divisions are deferred), not re-derive it from data."""
    return dataclasses.asdict(cfg)


def config_from_meta(meta: dict) -> EngineConfig:
    """The EngineConfig of a checkpoint's metadata, written by either
    package: keys the port's config does not have (the JAX engine's kernel
    choices and spans) are dropped, and missing ones take their defaults
    (``mask_bits`` 0: derived from the state at the first step)."""
    fields = {f.name for f in dataclasses.fields(EngineConfig)}
    spec_fields = {f.name for f in dataclasses.fields(GridSpec)}
    kept = {k: v for k, v in meta.items() if k in fields}
    for spec in ("nbr_spec", "jkr_spec"):
        kept[spec] = GridSpec(**{k: v for k, v in meta[spec].items() if k in spec_fields})
    return EngineConfig(**kept)


class StepInfo(NamedTuple):
    """Per-step diagnostics and overflow probes (0-d tensors from
    ``hipsc_step``; Python numbers from ``safe_step``; (k,) numpy arrays
    from ``run_steps``). The span probes report the widest row's candidate
    count (the summed widths of its stencil runs) of the step's windows:
    ``jkr_span_needed`` over every contact-window build, the span-mask
    path's mask-capacity probe (``EngineConfig.mask_bits``), and
    ``nbr_span_needed`` over the radius-15 window of the bio moments. The
    JAX engine's fields of these names probe its kernels' DMA spans."""

    num_agents: object
    num_added: object
    num_removed: object
    num_deferred: object  # divisions deferred for lack of free slots
    num_dividing: object  # division attempts (div_cap growth probe)
    nbr_max_in_bin: object  # widest radius-15 stencil run
    jkr_max_in_bin: object  # widest contact stencil run
    jkr_max_degree: object  # bond_cap growth probe
    jkr_span_needed: object  # widest contact-window row (mask_bits growth probe)
    nbr_span_needed: object  # widest radius-15 window row
    max_id: object
    max_substep_move: object  # max per-agent move per physics substep (um)
    max_window_drift: object
    jkr_rebuilds: object  # contact-window rebuilds after the scan's entry build


_FLOAT_PROBES = ("max_substep_move", "max_window_drift")


def _probe_row(info: StepInfo) -> torch.Tensor:
    """A step's probes as one (14,) float64 tensor on their device (exact
    for the integer probes), so that one transfer fetches them."""
    return torch.stack([torch.as_tensor(v).to(torch.float64).reshape(()) for v in info])


def _probes_from_host(values, stacked: bool = False) -> StepInfo:
    """StepInfo of fetched probe values: Python numbers from one row, (k,)
    numpy arrays (int64, or float64 for the float probes) from k rows."""
    if not stacked:
        return StepInfo(*(v if name in _FLOAT_PROBES else int(v)
                          for name, v in zip(StepInfo._fields, values)))
    cols = np.asarray(values, dtype=np.float64).T
    return StepInfo(*(c if name in _FLOAT_PROBES else c.astype(np.int64)
                      for name, c in zip(StepInfo._fields, cols)))


class StepInputs(NamedTuple):
    """What one step takes besides the state: ``words``, (13,) int64 on the
    state's device, holds the six keys of ``split(key, 6)`` (12 uint32
    words: the next step's key, then the division, pathway,
    differentiation, stochastic and motility keys) and the step number;
    ``key`` is the next step's key on the host (the new state's)."""

    words: torch.Tensor
    key: torch.Tensor


def step_inputs(key: torch.Tensor, step: int, k: int = 1):
    """The inputs of ``k`` steps from ``(key, step)``, derived on the host
    (the key schedule does not depend on the colony): a (k, 13) int64 table
    of ``StepInputs.words`` rows and the (2,) key after each step."""
    words = (int(key[0]) & 0xFFFFFFFF, int(key[1]) & 0xFFFFFFFF)
    rows, keys = [], []
    for t in range(k):
        split = rng.split_words(words, 6)
        rows.append([w for pair in split for w in pair] + [step + t])
        words = split[0]
        keys.append(torch.tensor(words, dtype=torch.int64))
    return torch.tensor(rows, dtype=torch.int64), keys


def _physics_dts(bio: BiologyParams) -> np.ndarray:
    """Substep schedule: divmod(step_dt, move_dt) full substeps + remainder
    substep, which runs even when the remainder is zero and still updates the
    bond graph (reference ``cell_methods.py:394-399``)."""
    steps, last_dt = divmod(bio.step_dt, bio.move_dt)
    return np.array([bio.move_dt] * int(steps) + [last_dt], dtype=np.float32)


def _window_widths(bounds: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Of a (C, 2 * n_runs) bounds table (dead rows are empty): the widest
    stencil run and the widest row's candidate count, 0-d tensors."""
    widths = torch.clamp(bounds[:, 1::2] - bounds[:, 0::2], min=0)
    return widths.max(), widths.sum(dim=1).max()


def take_rows(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``x[index]`` along the rows; an integer or bool (C, K) table (the bond
    lists, K >= 2) goes through a gather of its flat elements: on the card
    PyTorch gathers rows of such tables with a kernel of its own
    (``vectorized_gather_kernel``) that is several times slower than the
    gather of their flat elements (``tools/step_profile.py`` shows both).
    The values are the same."""
    if x.dim() != 2 or x.shape[1] < 2 or x.dtype == torch.float32:
        return x[index]
    k = x.shape[1]
    cols = torch.arange(k, dtype=index.dtype, device=index.device)
    return x.reshape(-1)[(index[:, None] * k + cols).reshape(-1)].view(index.shape[0], k)


def _sort_state_rows(arrays, alive, bonds, order):
    """Move the whole per-agent state into ``order``."""
    out = {k: v[order] for k, v in arrays.items()}
    return out, alive[order], BondState(take_rows(bonds.partners, order),
                                        take_rows(bonds.mask, order))


def hipsc_step(
    state: CellState,
    cfg: EngineConfig,
    gen: GeneralParams,
    xp: ExperimentalParams,
    bio: BiologyParams,
    diff: Optional[DiffusionParams],
    inputs: Optional[StepInputs] = None,
) -> Tuple[CellState, StepInfo]:
    """One full simulation step, in the phase order of the JAX engine's
    ``hipsc_step``. The output state is in this step's canonical sorted
    layout; agent identity rides the stable ids. ``inputs`` (the step's keys
    and number on the device) default to those of ``state.key`` and
    ``state.step``. Nothing in the step reads a device value on the host."""
    arrays = dict(state.arrays)
    alive = state.alive
    bonds = state.bonds
    gradients = dict(state.gradients)
    device = alive.device
    if inputs is None:
        table, keys = step_inputs(state.key, state.step)
        # on the card an asynchronous copy from pinned memory: no host read
        words = table[0] if device.type == "cpu" else table[0].pin_memory().to(
            device, non_blocking=True)
        inputs = StepInputs(words, keys[0])
    k_div, k_path, k_diff, k_stoch, k_mot = inputs.words[2:12].view(5, 2).unbind(0)
    step_number = inputs.words[12]
    # the box made by fills: a tensor built from host data would be a copy,
    # which synchronises and which a CUDA graph cannot capture
    size = torch.stack([torch.full((), float(v), dtype=torch.float32, device=device)
                        for v in gen.size])

    # --- get_neighbors("neighbor_graph", 15) and the sorted-resident state ---
    nbr_grid = nbr_ops.build_grid(cfg.nbr_spec, arrays["locations"], arrays["ids"], alive)
    arrays, alive, bonds = _sort_state_rows(arrays, alive, bonds, nbr_grid.order)
    nbr_bounds = nbr_ops.run_bounds(cfg.nbr_spec, nbr_grid.sorted_flat)
    # the graph stays the build window, re-masked by the liveness of each
    # call: agents killed earlier in the step stop contributing
    # (cell_methods.py:47); the build-time positions are packed once
    nbr_pos0 = bio_positions(arrays["locations"])

    def bio_moments(alive_now, mode, loc1=None, f0=None, f1=None, f2=None):
        return bio_moments_cuda(nbr_pos0, alive_now, nbr_bounds, loc1, f0, f1, f2,
                                radius=bio.neighbor_radius, mode=mode)

    m1 = bio_moments(alive, "count")
    nbr_count = m1[:, 0].to(torch.int32)

    # --- cell_division (daughter ids by the mothers' canonical rank) ---
    (arrays, alive, daughter_mask, num_added, num_deferred,
     num_dividing) = biology.cell_division(
        arrays, alive, nbr_count, k_div, bio, cfg.two_d, canon_order=None,
        next_id=state.next_id, div_cap=cfg.div_cap or cfg.capacity,
    )
    bonds = clear_bond_rows(bonds, daughter_mask)  # fresh vertices, no edges
    nbr_count = torch.where(daughter_mask, torch.zeros_like(nbr_count), nbr_count)

    # --- cell_death (dead partners' bond entries drop at compaction) ---
    arrays["death_counters"], removed, num_removed = biology.cell_death(
        arrays["states"], arrays["death_counters"], alive, nbr_count,
        xp.lonely_thresh, bio.death_thresh,
    )
    alive = alive & ~removed

    # --- cell_pathway (post-death liveness, post-division locations) ---
    m2 = bio_moments(alive, "pathway", f0=arrays["FGF4"])
    count2 = m2[:, 0].to(torch.int32)
    field_fgf4 = None
    if (cfg.enable_diffusion and diff is not None and diff.field_coupling
            and "fgf4_values" in gradients):
        field_fgf4 = diffusion_ops.sample_concentration(
            gradients["fgf4_values"], arrays["locations"], diff.spat_res)
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

    # --- the phases the reference ships disabled (cell_simulation.py:98-104) ---
    if cfg.enable_growth:
        arrays["radii"] = biology.cell_growth(
            arrays["radii"], arrays["states"], arrays["div_counters"], alive, bio)
    if cfg.enable_stochastic:
        arrays["GATA6"], arrays["NANOG"] = biology.cell_stochastic_update(
            arrays["GATA6"], arrays["NANOG"], arrays["ids"], alive, k_stoch, bio)
    if cfg.enable_diff_surround:
        # a fourth moments pass: differentiated neighbours (lane 7) with the
        # post-fate states, post-division locations, post-death liveness
        zero_i = torch.zeros_like(arrays["states"])
        m_ds = bio_moments(alive, "motility", arrays["locations"], zero_i, zero_i,
                           arrays["states"])
        arrays["GATA6"], arrays["NANOG"] = biology.cell_diff_surround(
            arrays["GATA6"], arrays["NANOG"], arrays["states"], alive,
            m_ds[:, 7].to(torch.int32), bio)

    # --- FGF4 secretion and FTCS diffusion ---
    if cfg.enable_diffusion and diff is not None:
        np_dts = diffusion_ops.diffusion_dts(bio.step_dt, diff.diffuse_dt)
        for gname in sorted(gradients):
            grid = gradients[gname]
            if gname == "fgf4_values" and (
                diff.release_amount > 0.0 or diff.uptake_amount > 0.0
            ):
                secreting = alive & (arrays["NANOG"] > arrays["GATA6"])
                amounts = torch.where(secreting, diff.release_amount, 0.0)
                amounts = amounts - torch.where(alive, diff.uptake_amount, 0.0)
                grid = diffusion_ops.deposit_morphogen(
                    grid, arrays["locations"], amounts.to(torch.float32), diff.spat_res
                )
            gradients[gname] = ftcs_diffuse_cuda(
                grid, np_dts, diff.diffuse_const, diff.spat_res2,
                diff.max_concentration, diff.degradation,
            )

    # --- cell_motility (post-fate moments, post-division locations) ---
    m3 = bio_moments(alive, "motility", arrays["locations"], arrays["GATA6"],
                     arrays["NANOG"], arrays["states"])
    arrays["motility_forces"] = biology.cell_motility(
        arrays["locations"], arrays["GATA6"], arrays["NANOG"], arrays["states"],
        arrays["motility_forces"], arrays["ids"], alive, count2,
        m3[:, 3].to(torch.int32), m3[:, 4:7], m3[:, 7].to(torch.int32), m3[:, 8:11],
        k_mot, xp, bio, cfg.two_d,
    )

    # --- apply_forces: 11 physics substeps (cell_methods.py:386-439) ---
    locations, bonds, j_bins, j_deg, max_move, rebuilds, j_cands = _PHYSICS_SCANS[
        cfg.contact_path](cfg, bio, arrays, alive, bonds, size, _physics_dts(bio))
    arrays["locations"] = locations
    # the reference leaves both force arrays zeroed after the step
    arrays["jkr_forces"] = torch.zeros_like(arrays["jkr_forces"])
    arrays["motility_forces"] = torch.zeros_like(arrays["motility_forces"])

    nbr_run, nbr_cands = _window_widths(nbr_bounds)
    info = StepInfo(
        num_agents=alive.sum(),
        num_added=num_added,
        num_removed=num_removed,
        num_deferred=num_deferred,
        num_dividing=num_dividing,
        nbr_max_in_bin=nbr_run,
        jkr_max_in_bin=j_bins,
        jkr_max_degree=j_deg,
        jkr_span_needed=j_cands,
        nbr_span_needed=nbr_cands,
        max_id=torch.where(alive, arrays["ids"], torch.zeros_like(arrays["ids"])).max(),
        max_substep_move=max_move,
        max_window_drift=torch.zeros((), dtype=torch.float32, device=device),
        jkr_rebuilds=rebuilds,
    )
    new_state = CellState(
        arrays=arrays,
        alive=alive,
        bonds=bonds,
        gradients=gradients,
        key=inputs.key,
        step=state.step + 1,
        next_id=(state.next_id + num_added).to(torch.int32),
    )
    return new_state, info


def _scan_rows(arrays, alive, bonds):
    """The per-agent rows the contact scan carries and re-sorts; ``perm``
    maps each row back to its slot."""
    capacity = alive.shape[0]
    return {
        "loc": arrays["locations"], "rad": arrays["radii"],
        "mot": arrays["motility_forces"], "ids": arrays["ids"], "alive": alive,
        "partners": bonds.ids(),
        "perm": torch.arange(capacity, dtype=torch.int64, device=alive.device),
    }


def _contact_law(cfg, bio):
    return dict(radius=bio.jkr_radius, adhesion_const=bio.adhesion_const,
                poisson=bio.poisson, youngs=bio.youngs, break_d=bio.jkr_break_d,
                uniform_radius=cfg.uniform_radius)


def drift_threshold(verlet_skin: float) -> float:
    """``(skin / 2)^2`` rounded to float32. The JAX engine compares the
    float32 drift with the weak-typed Python scalar, that is in float32;
    against a float32 value the comparison gives the same answer in float32
    and in float64."""
    return float(np.float32((verlet_skin * 0.5) ** 2))


def _window_stale(cfg, rows, ref) -> torch.Tensor:
    """The drift test on the device, () bool: has an agent moved more than
    skin/2 since the window was built?"""
    drift2 = _masked_max(((rows["loc"] - ref) ** 2).sum(dim=1), rows["alive"])
    return drift2 > drift_threshold(cfg.verlet_skin)


def _build_window(cfg, rows):
    """Re-sort the rows into the contact grid's canonical order and build
    their run bounds."""
    grid = nbr_ops.build_grid(cfg.jkr_spec, rows["loc"], rows["ids"], rows["alive"])
    rows = {k: take_rows(v, grid.order) for k, v in rows.items()}
    return rows, nbr_ops.run_bounds(cfg.jkr_spec, grid.sorted_flat)


def _rebuild_where(stale, cfg, rows, bounds, ref, identity):
    """The window rebuild under the device predicate ``stale`` (the JAX
    engine's ``lax.cond``): the grid order of the current rows is always
    computed, the rows are gathered through it where ``stale`` and through
    the identity elsewhere, and the bounds and the drift reference are
    selected. The values are those of a rebuild taken or skipped on the
    host."""
    grid = nbr_ops.build_grid(cfg.jkr_spec, rows["loc"], rows["ids"], rows["alive"])
    order = torch.where(stale, grid.order, identity)
    rows = {k: take_rows(v, order) for k, v in rows.items()}
    bounds = torch.where(stale, nbr_ops.run_bounds(cfg.jkr_spec, grid.sorted_flat), bounds)
    return rows, bounds, torch.where(stale, rows["loc"], ref)


class _ScanProbes:
    """The scan's probes, gathered on the device: the widest run and row of
    each substep's window, the largest degree and move, the rebuilds."""

    def __init__(self, device):
        self.bins, self.cands, self.degs, self.moves2 = [], [], [], []
        self.rebuilds = torch.zeros((), dtype=torch.int64, device=device)

    def window(self, bounds):
        run, cands = _window_widths(bounds)
        self.bins.append(run)
        self.cands.append(cands)


def _move(bio, rows, force, size, dt, probes):
    """The Stokes update of the rows' locations; records the largest move."""
    new_loc = stokes_integrate(rows["loc"], rows["rad"], force, rows["mot"],
                               rows["alive"], bio.stokes, size, float(dt))
    probes.moves2.append(
        _masked_max(((new_loc - rows["loc"]) ** 2).sum(dim=1), rows["alive"]))
    rows["loc"] = new_loc


def _scan_result(rows, probes):
    """The rows back in slot order: ``(locations, bonds, widest run, max
    degree, max substep move, rebuilds after the entry build, widest
    row)``."""
    perm = rows["perm"]
    locations = torch.empty_like(rows["loc"])
    locations[perm] = rows["loc"]
    partners = torch.empty_like(rows["partners"])
    partners[perm] = rows["partners"]
    return (locations, BondState.from_ids(partners), torch.stack(probes.bins).max(),
            torch.stack(probes.degs).max(), torch.sqrt(torch.stack(probes.moves2).max()),
            probes.rebuilds, torch.stack(probes.cands).max())


def _physics_scan(cfg, bio, arrays, alive, bonds, size, dts):
    """The contact substeps over Verlet-cached stencil runs, bonds as (C, K)
    partner-id lists (``contact_path="id_list"``).

    At entry the physics rows are sorted into the contact grid's canonical
    order and the per-row run bounds built. Before every later substep the
    drift test runs on the device, and the rebuild (re-sort, new bounds)
    takes effect where an agent has drifted more than skin/2 from where the
    runs were built: it is computed on every substep and selected
    (``_rebuild_where``). Each substep is one contact-kernel
    launch (forces, degrees and the new partner lists) and one Stokes
    update; the rows go back to the state's layout at the end. Returns
    ``_scan_result``'s tuple."""
    rows = _scan_rows(arrays, alive, bonds)
    law = _contact_law(cfg, bio)
    probes = _ScanProbes(alive.device)
    rows, bounds = _build_window(cfg, rows)
    ref = rows["loc"]
    identity = torch.arange(alive.shape[0], device=alive.device)
    for s, dt in enumerate(dts):
        if s > 0:
            stale = _window_stale(cfg, rows, ref)
            rows, bounds, ref = _rebuild_where(stale, cfg, rows, bounds, ref, identity)
            probes.rebuilds = probes.rebuilds + stale
        probes.window(bounds)
        force, degree, rows["partners"] = contact_substep_cuda(
            pack_physics(rows["loc"], rows["rad"]), rows["ids"], rows["alive"],
            bounds, rows["partners"], **law,
        )
        probes.degs.append(degree.max())
        _move(bio, rows, force, size, dt, probes)
    return _scan_result(rows, probes)


def mask_words_of(cfg: EngineConfig) -> int:
    """The span-mask path's words per row, ``ceil(cfg.mask_bits / 32)``;
    raises while the capacity is unset (``HipscEngine`` derives it)."""
    if cfg.mask_bits < 1:
        raise ValueError("EngineConfig.mask_bits is unset: HipscEngine derives it from the "
                         "state (HipscEngine.step/safe_step/run_steps)")
    return -(-cfg.mask_bits // 32)


def _physics_scan_span_mask(cfg, bio, arrays, alive, bonds, size, dts):
    """The contact substeps with the bond set as a keep mask over the frozen
    window (``contact_path="span_mask"``; the JAX engine's
    ``_physics_scan_pallas`` design).

    At entry the rows are sorted, the run bounds built and the mask seeded
    from the (C, K) partner ids (``span_mask.contact_seed``, which also
    evaluates substep 0). The mask is one (W, C) buffer of the static width
    ``cfg.mask_bits / 32``. Before each later substep the drift test of
    ``_physics_scan`` runs on the device, and its flag predicates the
    launches: when the window is stale, the compaction writes the mask back
    to partner ids (the only bond form that survives a re-sort), the rows
    (ids riding along) are re-sorted and the new window is seeded; when it
    holds, the masked substep reads and rewrites the mask in place. The seed
    and the masked substep are both launched into the same force, degree and
    mask buffers, each returning at once unless its branch is taken (the
    re-sort is computed and selected, as in ``_physics_scan``). At exit the
    mask is compacted once more and the rows go back to slot order. Returns
    ``_scan_result``'s tuple."""
    rows = _scan_rows(arrays, alive, bonds)
    law = _contact_law(cfg, bio)
    K = rows["partners"].shape[1]
    C, device = alive.shape[0], alive.device
    mask = torch.empty((mask_words_of(cfg), C), dtype=torch.int32, device=device)
    probes = _ScanProbes(device)
    rows, bounds = _build_window(cfg, rows)
    ref = rows["loc"]
    identity = torch.arange(C, device=device)
    for s, dt in enumerate(dts):
        force = torch.empty((C, 3), dtype=torch.float32, device=device)
        degree = torch.empty((C,), dtype=torch.int32, device=device)
        if s == 0:
            probes.window(bounds)
            span_mask.contact_seed_cuda(
                pack_physics(rows["loc"], rows["rad"]), rows["ids"], rows["alive"],
                bounds, rows["partners"], out=(force, degree, mask), **law)
        else:
            stale = _window_stale(cfg, rows, ref)
            rebuild = stale.to(torch.int32).reshape(1)
            span_mask.mask_compact_cuda(rows["ids"], bounds, mask, K, pred=rebuild,
                                        out=rows["partners"])
            rows, bounds, ref = _rebuild_where(stale, cfg, rows, bounds, ref, identity)
            probes.rebuilds = probes.rebuilds + stale
            probes.window(bounds)
            xyzr = pack_physics(rows["loc"], rows["rad"])
            span_mask.contact_seed_cuda(xyzr, rows["ids"], rows["alive"], bounds,
                                        rows["partners"], pred=rebuild,
                                        out=(force, degree, mask), **law)
            span_mask.contact_masked_cuda(xyzr, rows["ids"], rows["alive"], bounds, mask,
                                          pred=1 - rebuild, out=(force, degree), **law)
        probes.degs.append(degree.max())
        _move(bio, rows, force, size, dt, probes)
    rows["partners"] = span_mask.mask_compact_cuda(rows["ids"], bounds, mask, K)
    return _scan_result(rows, probes)


_PHYSICS_SCANS = {"id_list": _physics_scan, "span_mask": _physics_scan_span_mask}


def _masked_max(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, values, 0.0).max()


class HipscEngine:
    """Host side of the engine: state construction, stepping and capacity growth.

    ``device`` is never inferred: ``"cuda"`` (the default) runs the kernels
    and raises when CUDA is absent; ``"cpu"`` runs the plain versions.
    ``contact_path`` picks the contact-substep design (``EngineConfig``);
    when a ``cfg`` is given as well, it overrides that config's choice.
    A box with ``size[2] > 0`` is 3D. ``enable_growth``,
    ``enable_stochastic`` and ``enable_diff_surround`` turn on the phases
    the reference ships disabled; growth makes radii unequal, so it selects
    the contact kernels' general pair law (``uniform_radius=None``)."""

    def __init__(
        self,
        gen: GeneralParams,
        xp: ExperimentalParams,
        bio: Optional[BiologyParams] = None,
        diff: Optional[DiffusionParams] = None,
        cfg: Optional[EngineConfig] = None,
        enable_diffusion: bool = False,
        enable_growth: bool = False,
        enable_stochastic: bool = False,
        enable_diff_surround: bool = False,
        device="cuda",
        contact_path: Optional[str] = None,
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("HipscEngine(device='cuda') needs a CUDA device")
        self.gen = gen
        self.xp = xp
        self.bio = bio or BiologyParams()
        self.diff = diff
        if cfg is None:
            n0 = gen.num_to_start + xp.num_gata6
            capacity = max(_round_up(int(n0 * 1.3), _CAPACITY_QUANTUM), _CAPACITY_QUANTUM)
            cfg = EngineConfig.create(
                gen.size, capacity=capacity, bio=self.bio,
                enable_diffusion=enable_diffusion,
                enable_growth=enable_growth,
                enable_stochastic=enable_stochastic,
                enable_diff_surround=enable_diff_surround,
                # all radii are max_radius at init and only growth changes them
                uniform_radius=None if enable_growth else self.bio.max_radius,
                contact_path=contact_path or "id_list",
            )
        elif contact_path is not None:
            cfg = dataclasses.replace(cfg, contact_path=contact_path)
        self.cfg = cfg
        # the captured blocks on the card, by (k, config, parameters); the
        # attempts (re-executions + 1) of the last safe_step or run_steps
        # call; the contact-window rebuilds of every step attempt run by
        # them (with the launch counts, the predicated kernels' taken
        # launches)
        self._graphs: Dict[tuple, "_BlockGraph"] = {}
        self.block_attempts = 0
        self.window_rebuilds = 0

    # -- state construction -------------------------------------------------

    def init_state(self, seed: int = 0, locations: Optional[np.ndarray] = None) -> CellState:
        """The initial colony (reference ``agent_initials``,
        ``cell_simulation.py:128-157``), drawn with numpy exactly as the JAX
        engine draws it, so both start from identical states."""
        gen, xp, bio, cfg = self.gen, self.xp, self.bio, self.cfg
        n = gen.num_to_start + xp.num_gata6
        if n > cfg.capacity:
            raise ValueError(f"initial population {n} exceeds capacity {cfg.capacity}")
        C = cfg.capacity
        rs = np.random.default_rng(seed)

        arrays: Dict[str, np.ndarray] = {}
        for name, (dtype, vec) in HIPSC_ARRAY_SPECS.items():
            shape = (C,) if vec is None else (C, vec)
            np_dtype = np.int32 if dtype == torch.int32 else np.float32
            arrays[name] = np.zeros(shape, dtype=np_dtype)

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

        gradients: Dict[str, np.ndarray] = {}
        if cfg.enable_diffusion and self.diff is not None:
            gradients["fgf4_values"] = np.zeros(self.diff.grid_size(gen.size),
                                                dtype=np.float32)

        dev = self.device
        return CellState(
            arrays={k: torch.from_numpy(v).to(dev) for k, v in arrays.items()},
            alive=torch.from_numpy(alive).to(dev),
            bonds=BondState.empty(C, cfg.bond_cap, device=dev),
            gradients={k: torch.from_numpy(v).to(dev) for k, v in gradients.items()},
            key=rng.prng_key(seed),
            step=1,
            next_id=torch.tensor(n, dtype=torch.int32, device=dev),
        )

    # -- stepping -----------------------------------------------------------

    def _cfg_for_state(self, state: CellState) -> EngineConfig:
        """A config whose static shapes match the given state (``self.cfg``
        is a template that growth may have moved past an older state). The
        span-mask path's first step derives ``mask_bits`` from the state (a
        set-up read) and commits it to ``self.cfg``."""
        if self.cfg.contact_path == "span_mask" and self.cfg.mask_bits == 0:
            self.cfg = dataclasses.replace(self.cfg, mask_bits=initial_mask_bits(self.cfg, state))
        cfg = self.cfg
        bond_cap = state.bonds.partners.shape[1]
        if cfg.capacity != state.capacity or cfg.bond_cap != bond_cap:
            cfg = dataclasses.replace(cfg, capacity=state.capacity, bond_cap=bond_cap)
        return cfg

    def step(self, state: CellState) -> Tuple[CellState, StepInfo]:
        """Raw step (no overflow handling)."""
        return hipsc_step(state, self._cfg_for_state(state), self.gen, self.xp,
                          self.bio, self.diff)

    def safe_step(self, state: CellState) -> Tuple[CellState, StepInfo]:
        """Step with exact capacity-overflow recovery: if a static capacity
        (bond degree, daughter table, free slots, mask width) overflowed,
        re-execute from the same input state with that capacity grown. The
        probes come to the host in one transfer per attempt, the step's only
        host read. ``run_steps`` with k = 1 (on the card a captured graph of
        one step); the probes are Python numbers."""
        new_state, probes = self._run_attempts(state, 1)
        return new_state, _probes_from_host(probes[0])

    def run_steps(self, state: CellState, k: int) -> Tuple[CellState, StepInfo]:
        """Run ``k`` full steps with exact overflow recovery: the JAX
        engine's ``run_steps``. The result is that of ``k`` calls of
        ``safe_step``; the probes of the block's steps are stacked on the
        device and fetched in one transfer, the block's only host read.
        When a probe of any step overflowed, the config grows by the block's
        worst-case probes and the WHOLE block re-executes from its
        unmodified input state. Returns the final state and a ``StepInfo``
        whose fields are (k,) numpy arrays.

        On the card the block runs as one CUDA graph, captured once per
        ``(k, config, parameters)`` (``_BlockGraph``) and replayed; a config
        that growth replaces, or parameters the caller replaces
        (``self.gen``, ``xp``, ``bio``, ``diff``), drop the graphs captured
        before and their memory pools. On the CPU the same block runs
        eagerly."""
        if k < 1:
            raise ValueError(f"run_steps needs k >= 1, got {k}")
        new_state, probes = self._run_attempts(state, k)
        return new_state, _probes_from_host(probes, stacked=True)

    def _run_attempts(self, state: CellState, k: int):
        """The attempt loop of ``safe_step`` and ``run_steps``: ``k`` steps
        from ``state`` (a captured graph on the card, eagerly on the CPU),
        the (k, 14) probes fetched, and on overflow the config grown by the
        block's worst probes and the block re-executed from the re-padded
        input state; raises after 16 attempts. Returns the final state and
        the probe rows (lists of floats)."""
        for attempt in range(1, 17):
            self.block_attempts = attempt
            cfg = self._cfg_for_state(state)
            table, keys = step_inputs(state.key, state.step, k)
            if self.device.type == "cuda":
                new_state, probes = self._graph_for(cfg, k, state).run(state, table)
            else:
                new_state, probes = _run_block(self, cfg, state, table)
            rows = probes.tolist()
            infos = _probes_from_host(rows, stacked=True)
            self.window_rebuilds += int(infos.jkr_rebuilds.sum())
            grown_cfg = self._grown_cfg(cfg, StepInfo(*(np.max(f) for f in infos)))
            if grown_cfg is None:
                return new_state._replace(key=keys[-1], step=state.step + k), rows
            self.cfg = grown_cfg
            state = self.repad_state(state, grown_cfg)
        raise RuntimeError("capacity growth failed to converge")

    def _graph_for(self, cfg: EngineConfig, k: int, state: CellState) -> "_BlockGraph":
        """The captured block of ``k`` steps under ``cfg`` and the engine's
        parameters, whose values the graph holds as launch constants; graphs
        of another config or other parameters are dropped with their memory
        pools."""
        fixed = (cfg, self.gen, self.xp, self.bio, self.diff)
        graphs = self._graphs
        for key in [key for key in graphs if key[1:] != fixed]:
            del graphs[key]
        if (k,) + fixed not in graphs:
            torch.cuda.empty_cache()  # return the dropped pools
            graphs[(k,) + fixed] = _BlockGraph(self, cfg, k, state)
        return graphs[(k,) + fixed]

    def block_graphs(self) -> list:
        """The captured blocks held: ``{"k", "capture_s", "pool_mib",
        "launches"}`` each (``pool_mib``: device memory reserved by the
        capture, graph pool included; ``launches``: kernel launches per
        replay)."""
        return [dict(k=key[0], capture_s=g.capture_s, pool_mib=g.pool_bytes / 2**20,
                     launches=dict(g.launches)) for key, g in self._graphs.items()]

    def _grown_cfg(self, cfg: EngineConfig, info: StepInfo) -> Optional[EngineConfig]:
        """The config the step's overflow probes demand, or None. Raises
        when the ids near 2^31 (ids are never recycled)."""
        if int(info.max_id) >= (1 << 31) - 2:
            raise RuntimeError("agent id space exhausted (2^31 agents ever "
                               "created); id recycling is not implemented")
        changed = False
        bond_cap, capacity, div_cap = cfg.bond_cap, cfg.capacity, cfg.div_cap
        mask_bits = cfg.mask_bits
        if int(info.jkr_max_degree) > bond_cap:
            bond_cap = _round_up(int(info.jkr_max_degree) * 2, 8)
            if bond_cap > MAX_BOND_CAP:
                raise RuntimeError(_BOND_CAP_GUARD_MSG.format(
                    deg=int(info.jkr_max_degree), need=bond_cap, limit=MAX_BOND_CAP))
            changed = True
        if div_cap and int(info.num_dividing) > div_cap:
            # daughter-table overflow: grow the tables; the re-execution
            # reveals any true free-slot shortage separately
            div_cap = min(_round_up(int(info.num_dividing) * 2, 128), capacity)
            changed = True
        elif int(info.num_deferred) > 0:
            capacity = _round_up(capacity * 2, _CAPACITY_QUANTUM)
            changed = True
        if cfg.contact_path == "span_mask" and int(info.jkr_span_needed) > mask_bits:
            # the JAX engine's span growth rule (x1.25, rounded up to a word)
            mask_bits = _round_up(int(info.jkr_span_needed) * 1.25, 32)
            changed = True
        if not changed:
            return None
        return dataclasses.replace(cfg, bond_cap=bond_cap, capacity=capacity,
                                   div_cap=min(div_cap, capacity) if div_cap else div_cap,
                                   mask_bits=mask_bits)

    @staticmethod
    def repad_state(state: CellState, cfg: EngineConfig) -> CellState:
        """Re-pad a state to a (larger) capacity / bond capacity."""
        C, K = cfg.capacity, cfg.bond_cap

        def pad_rows(a):
            if a.shape[0] == C:
                return a
            pad = torch.zeros((C - a.shape[0],) + tuple(a.shape[1:]), dtype=a.dtype,
                              device=a.device)
            return torch.cat([a, pad], dim=0)

        partners = pad_rows(state.bonds.partners)
        mask = pad_rows(state.bonds.mask)
        if K != partners.shape[1]:
            if K < partners.shape[1]:
                raise ValueError("bond capacity cannot shrink")
            extra = (C, K - partners.shape[1])
            partners = torch.cat([partners, partners.new_zeros(extra)], dim=1)
            mask = torch.cat([mask, mask.new_zeros(extra)], dim=1)
        return CellState(
            arrays={k: pad_rows(v) for k, v in state.arrays.items()},
            alive=pad_rows(state.alive),
            bonds=BondState(partners=partners, mask=mask),
            gradients=state.gradients,
            key=state.key,
            step=state.step,
            next_id=state.next_id,
        )


def initial_mask_bits(cfg: EngineConfig, state: CellState) -> int:
    """The span-mask capacity to start from: the widest row of the contact
    window over the state's positions, grown by the growth rule (x1.25,
    rounded up to a word). One host read, at set-up."""
    grid = nbr_ops.build_grid(cfg.jkr_spec, state.arrays["locations"], state.arrays["ids"],
                              state.alive)
    widest = span_mask.widest_row(nbr_ops.run_bounds(cfg.jkr_spec, grid.sorted_flat))
    return _round_up(max(widest, 1) * 1.25, 32)


def _run_block(params, cfg: EngineConfig, state: CellState, table):
    """``len(table)`` steps from ``state`` with the step inputs of ``table``
    ((k, 13) int64 on the state's device) and the parameters of ``params``
    (anything with ``gen``, ``xp``, ``bio`` and ``diff``: the engine, or one
    replicate's parameters): the final state (its key and step as the last
    row left them) and the (k, 14) float64 probes, on the device. What
    ``_BlockGraph`` captures; on the CPU, what ``safe_step`` and
    ``run_steps`` run."""
    rows = []
    for t in range(table.shape[0]):
        state, info = hipsc_step(state, cfg, params.gen, params.xp, params.bio, params.diff,
                                 StepInputs(table[t], state.key))
        rows.append(_probe_row(info))
    return state, torch.stack(rows)


def _device_tensors(state: CellState) -> list:
    """The state's tensors on the device, in a fixed order."""
    return ([state.arrays[k] for k in sorted(state.arrays)] + [state.alive]
            + list(state.bonds) + [state.gradients[k] for k in sorted(state.gradients)]
            + [state.next_id])


def _with_device_tensors(state: CellState, tensors: list) -> CellState:
    """``state`` with its device tensors replaced, in ``_device_tensors``
    order."""
    it = iter(tensors)
    arrays = {k: next(it) for k in sorted(state.arrays)}
    alive = next(it)
    bonds = BondState(next(it), next(it))
    gradients = {k: next(it) for k in sorted(state.gradients)}
    return state._replace(arrays=arrays, alive=alive, bonds=bonds, gradients=gradients,
                          next_id=next(it))


def _wait_for_device(deadline_s: float, what: str) -> None:
    """Wait for the work queued on the current stream, polling an event,
    and raise ``TimeoutError`` after ``deadline_s`` seconds instead of
    blocking forever."""
    done = torch.cuda.Event()
    done.record()
    end = time.perf_counter() + deadline_s
    while not done.query():
        if time.perf_counter() > end:
            raise TimeoutError(f"{what}: not done after {deadline_s} s")
        time.sleep(5e-5)


class _CapturedGraph:
    """Work on a state captured as one CUDA graph (``torch.cuda.graph``):
    ``block(state, table)`` returns the new state and the probes, on the
    device. The graph reads static copies of the input state (of any
    leading shape: a colony, or an ensemble's stacked colonies) and a
    static int64 table of step inputs of ``table_shape``; ``run`` copies
    the state and the table into them, replays the graph, and returns
    clones of its outputs (the next replay overwrites them) and the probes
    on the host. ``warm_up`` runs before the capture: one eager step that
    loads every kernel of the path. The kernels launched in the capture are
    counted once per replay (``kernels.capturing``). ``capture_s`` and
    ``pool_bytes`` (device memory the capture reserved) are recorded for
    the measurements."""

    def __init__(self, device, block, state: CellState, table_shape: tuple, warm_up):
        t0 = time.perf_counter()
        warm_up()
        reserved = torch.cuda.memory_reserved(device)
        self.state = _with_device_tensors(state, [t.clone() for t in _device_tensors(state)])
        self.table = torch.zeros(table_shape, dtype=torch.int64, device=device)
        self.graph = torch.cuda.CUDAGraph()
        with kernels.capturing() as tally, torch.cuda.graph(self.graph):
            self.out_state, self.out_probes = block(self.state, self.table)
        torch.cuda.synchronize(device)
        self.launches = dict(tally)
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved

    def run(self, state: CellState, table: torch.Tensor, deadline_s: Optional[float] = None):
        """One replay from ``state`` with the inputs of ``table``; with
        ``deadline_s``, raise rather than wait longer for the replay."""
        for static, src in zip(_device_tensors(self.state), _device_tensors(state)):
            static.copy_(src)
        self.table.copy_(table.pin_memory(), non_blocking=True)
        self.graph.replay()
        out = _with_device_tensors(
            self.out_state, [t.clone() for t in _device_tensors(self.out_state)])
        if deadline_s is not None:
            _wait_for_device(deadline_s, "graph replay")
        kernels.launch_counts.update(self.launches)
        return out, self.out_probes.cpu()


class _BlockGraph(_CapturedGraph):
    """A k-step block of one config and the engine's parameters: the graph
    of ``_run_block``, after one eager step from the state (discarded; its
    rebuilds go to ``engine.window_rebuilds``)."""

    def __init__(self, engine: HipscEngine, cfg: EngineConfig, k: int, state: CellState):
        def warm_up():
            _, info = hipsc_step(state, cfg, engine.gen, engine.xp, engine.bio, engine.diff)
            engine.window_rebuilds += int(info.jkr_rebuilds)  # a set-up read

        super().__init__(engine.device, lambda s, t: _run_block(engine, cfg, s, t), state,
                         (k, 13), warm_up)
