"""How ``correct`` is decided: the program's output of two stretches of
``CHECK_STEPS`` steps of the window's last episode against the plain
reference (``portbench.reference``), agent by agent: the episode's first
stretch, which the reference runs from the same seeded inputs, and its
last, which the reference runs from the program's state at the stretch's
start (the colony grown, bonded and past doxycycline) with the step keys
it works out from the seed.

The configuration states float32 and the program's step is the plain
step's bit for bit, so every number compared is exact and its limit is 0:

- ``ids_apart``: agent ids alive on one side only;
- ``fields_apart``: agents whose per-agent fields (positions, radii, the
  pathway's fields and every counter) differ in any bit;
- ``bond_rows_apart``: agents whose bond sets differ;
- ``lattice_points_apart``: morphogen lattice points that differ in any bit;
- ``next_id_apart``: the difference of the next agent ids;
- ``position_gap_um``: the largest distance between an agent's positions.

``calls_unlike_first`` is the one number not taken against the reference:
the window's calls whose probes differ from the same call of the window's
first episode (every episode runs the same inputs).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

# steps of each compared stretch
CHECK_STEPS = 5

LIMITS: Dict[str, float] = {
    "ids_apart": 0,
    "fields_apart": 0,
    "bond_rows_apart": 0,
    "lattice_points_apart": 0,
    "next_id_apart": 0,
    "position_gap_um": 0.0,
    "calls_unlike_first": 0,
}


def _bits(x: np.ndarray) -> np.ndarray:
    return x.view(np.int32) if x.dtype == np.float32 else x


def _by_id(d: dict):
    alive = d["alive"]
    ids = d["arrays"]["ids"][alive]
    order = np.argsort(ids, kind="stable")
    fields = {k: v[alive][order] for k, v in d["arrays"].items()}
    bonds = np.sort(np.where(d["bond_mask"], d["partners"], -1)[alive][order], axis=1)
    return ids[order], fields, bonds


def _pad_left(z: np.ndarray, width: int) -> np.ndarray:
    return np.concatenate([np.full((z.shape[0], width - z.shape[1]), -1, z.dtype), z], axis=1)


def compare(program: dict, reference: dict) -> Dict[str, float]:
    """The numbers compared of one colony: two flat numpy states
    (``arrays``, ``alive``, ``partners``, ``bond_mask``, ``gradients``,
    ``next_id``), whatever their capacities and bond caps."""
    ip, fp, bp = _by_id(program)
    ir, fr, br = _by_id(reference)
    common, at_p, at_r = np.intersect1d(ip, ir, return_indices=True)
    out = {"ids_apart": int(len(ip) + len(ir) - 2 * len(common))}
    apart = np.zeros(len(common), dtype=bool)
    for k in fr:
        a, b = _bits(fp[k][at_p]), _bits(fr[k][at_r])
        apart |= (a != b).reshape(len(common), -1).any(axis=1)
    out["fields_apart"] = int(apart.sum())
    width = max(bp.shape[1], br.shape[1])
    out["bond_rows_apart"] = int((_pad_left(bp[at_p], width)
                                  != _pad_left(br[at_r], width)).any(axis=1).sum())
    points = 0
    for g in set(program["gradients"]) | set(reference["gradients"]):
        if g not in program["gradients"] or g not in reference["gradients"]:
            points += max(np.size(program["gradients"].get(g, 0)),
                          np.size(reference["gradients"].get(g, 0)))
            continue
        points += int((_bits(program["gradients"][g]) != _bits(reference["gradients"][g])).sum())
    out["lattice_points_apart"] = points
    out["next_id_apart"] = abs(int(program["next_id"]) - int(reference["next_id"]))
    gap = fp["locations"][at_p].astype(np.float64) - fr["locations"][at_r].astype(np.float64)
    out["position_gap_um"] = float(np.sqrt((gap ** 2).sum(axis=1)).max()) if len(common) else 0.0
    return out


def worst(readings: List[Dict[str, float]]) -> Dict[str, float]:
    """Each number's largest reading over the compared colonies."""
    return {k: max(r[k] for r in readings) for k in readings[0]}


def is_correct(numbers: Dict[str, float]) -> bool:
    return all(numbers[k] <= LIMITS[k] for k in LIMITS)


class Case(NamedTuple):
    """One compared colony: its seed, the program's state before the
    stretch (a flat numpy state; None: the seeded colony, which the
    reference makes itself), the stretch's first step (1-based), and the
    program's output after ``CHECK_STEPS`` steps."""

    seed: int
    start: Optional[dict]
    first_step: int
    output: dict


def key_at(seed: int, step: int) -> torch.Tensor:
    """The step key of ``step`` (1-based) in a colony seeded with ``seed``."""
    from portbench.reference import rng
    from portbench.reference.step import step_words

    key = rng.prng_key(seed)
    for s in range(1, step):
        key = step_words(key, s)[1]
    return key


def _state_of(flat: dict, seed: int, step: int, device):
    """A flat numpy state as the reference's ``CellState`` at ``step``."""
    from portbench.reference.jkr import BondState
    from portbench.reference.step import ARRAY_SPECS, CellState

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return CellState(arrays={k: dev(flat["arrays"][k]) for k in ARRAY_SPECS},
                     alive=dev(flat["alive"]),
                     bonds=BondState(dev(flat["partners"]), dev(flat["bond_mask"])),
                     gradients={k: dev(v) for k, v in flat["gradients"].items()},
                     key=key_at(seed, step), step=step,
                     next_id=torch.tensor(int(flat["next_id"]), dtype=torch.int32,
                                          device=device))


def reference_output(colony, case: Case, device, stored=torch.float32) -> Tuple[dict, dict]:
    """The plain reference's colony after ``CHECK_STEPS`` steps of
    ``case`` under ``colony`` (``portbench.colony.Colony``), as a flat
    numpy state, and its capacities: ``capacity``, ``jkr_span``,
    ``nbr_span`` and ``live_most``, the most live agents at a step's start
    or end. ``stored`` bfloat16 gives the lower-precision control."""
    from portbench.colony import seed_radii
    from portbench.reference import params
    from portbench.reference.step import Reference

    gen = params.GeneralParams(**colony.gen)
    xp = params.ExperimentalParams(**colony.xp)
    diff = params.DiffusionParams(**colony.diff) if colony.diff is not None else None
    ref = Reference(gen, xp, diff=diff, device=device, stored=stored, **colony.flags)
    if case.start is not None:
        state = _state_of(case.start, case.seed, case.first_step, ref.device)
    else:
        state = ref.init_state(case.seed, colony.locations)
        if colony.seeded_radii:
            radii = seed_radii(state.arrays["div_counters"].cpu().numpy(),
                               state.alive.cpu().numpy(), ref.bio)
            state = state._replace(arrays={**state.arrays,
                                           "radii": torch.from_numpy(radii).to(ref.device)})
    live = [int(state.alive.sum())]
    for _ in range(CHECK_STEPS):
        state = ref.run(state, 1)
        live.append(int(state.alive.sum()))
    caps = dict(capacity=state.capacity, jkr_span=ref.cfg.jkr_span, nbr_span=ref.cfg.nbr_span,
                live_most=max(live))
    return flat_numpy(state), caps


def flat_numpy(state) -> dict:
    """A colony (the program's or the reference's) as host numpy arrays:
    ``arrays``, ``alive``, ``partners``, ``bond_mask``, ``gradients``,
    ``next_id``."""
    return dict(arrays={k: v.cpu().numpy() for k, v in state.arrays.items()},
                alive=state.alive.cpu().numpy(), partners=state.bonds.partners.cpu().numpy(),
                bond_mask=state.bonds.mask.cpu().numpy(),
                gradients={k: v.cpu().numpy() for k, v in state.gradients.items()},
                next_id=int(state.next_id))


def clip_margin(caps: dict, program_caps: dict, align: int = 128) -> int:
    """Rows between the most live agents of a stretch (``caps["live_most"]``)
    and the furthest span start that the sums' grouping allows, ``(capacity
    - span cap) // align * align`` under the wider span cap, on the side
    where it is nearer: the reference's capacities (``caps``) or the
    program's (``program_caps``). While it is not negative no live block's
    start is clipped on either side, so the grouping is the same whatever
    capacities each side grew."""
    def room(c):
        return (c["capacity"] - max(c["jkr_span"], c["nbr_span"])) // align * align
    return min(room(caps), room(program_caps)) - caps["live_most"]
