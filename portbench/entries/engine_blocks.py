"""The single-colony entry: ``HipscEngine.run_steps(state, block)``, on the
card one CUDA graph replay of ``block`` steps and one probe fetch, as a
lifecycle run with ``output_interval: block`` and its writers off calls it.

Set-up builds the engine, makes the seeded colony, runs one whole warm-up
episode (which grows the capacities by the engine's own rule and captures
the block's graph) and makes the seeded colony again under the grown
config. Each episode of the window starts from a device copy of it.

The run compares the episode's first and last ``check.CHECK_STEPS`` steps
(``check_cases``): an entry's calls end on those steps' bounds.
"""

from __future__ import annotations

import time
from typing import List, NamedTuple

import numpy as np
import torch

from portbench.check import Case, flat_numpy


class Call(NamedTuple):
    """What one call did: the steps completed, the live agents at the start
    of each summed, the attempts the engine made (1: no re-execution), and
    its probes (a tuple that repeats exactly across episodes)."""

    steps: int
    agent_steps: int
    attempts: int
    probes: tuple


def engine_params(colony, device):
    """The program's parameter objects and optional-phase switches of
    ``colony`` (``portbench.colony.Colony``)."""
    from hipsc_abm_tpu_torch.params import DiffusionParams, ExperimentalParams, GeneralParams

    gen = GeneralParams(**colony.gen)
    xp = ExperimentalParams(**colony.xp)
    diff = DiffusionParams(**colony.diff) if colony.diff is not None else None
    return gen, xp, diff


def initial_state(eng, colony, seed: int):
    """``eng.init_state(seed)`` at the colony's seeding positions, with the
    radii seeded from the division counters where the colony asks."""
    from portbench.colony import seed_radii

    state = eng.init_state(seed=seed, locations=colony.locations)
    if colony.seeded_radii:
        radii = seed_radii(state.arrays["div_counters"].cpu().numpy(),
                           state.alive.cpu().numpy(), eng.bio)
        state = state._replace(arrays={**state.arrays,
                                       "radii": torch.from_numpy(radii).to(state.alive.device)})
    return state


def clone_state(state):
    """A device copy of a colony (every tensor cloned)."""
    from hipsc_abm_tpu_torch.ops.jkr import BondState

    return state._replace(arrays={k: v.clone() for k, v in state.arrays.items()},
                          alive=state.alive.clone(),
                          bonds=BondState(state.bonds.partners.clone(), state.bonds.mask.clone()),
                          gradients={k: v.clone() for k, v in state.gradients.items()},
                          next_id=state.next_id.clone())


def colony_view(state) -> dict:
    """What the counts read of one colony: ``locations``, ``radii``,
    ``alive``, ``bond_mask`` (device tensors) and ``lattice``, the shape of
    its morphogen lattice or None."""
    grid = state.gradients.get("fgf4_values")
    return dict(locations=state.arrays["locations"], radii=state.arrays["radii"],
                alive=state.alive, bond_mask=state.bonds.mask & state.alive[:, None],
                lattice=None if grid is None else tuple(grid.shape))


class Clock:
    """Set-up's seconds by part: each call records the seconds since the
    last (the device's queued work done) under a name."""

    def __init__(self, timings: dict, device):
        self.timings, self.device = timings, torch.device(device)
        self.t = time.perf_counter()

    def __call__(self, name: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        now = time.perf_counter()
        self.timings[name] = now - self.t
        self.t = now


def load_library(device) -> None:
    """Build or load the kernel library now, on the card, so that set-up
    times it apart from the first step."""
    if torch.device(device).type == "cuda":
        from hipsc_abm_tpu_torch import kernels

        kernels.library()


def compared_seeds(traffic: dict, seed: int) -> list:
    """The seeds of the compared colonies: the one colony's."""
    return [seed]


class Entry:
    """``run_steps`` blocks of one seeded colony."""

    def __init__(self, colony, traffic: dict, seed: int, device: str):
        from hipsc_abm_tpu_torch.engine import HipscEngine

        self.colony, self.seed = colony, seed
        self.block = int(traffic["block"])
        self.calls_per_episode = int(traffic["horizon"]) // self.block
        t = time.perf_counter()
        gen, xp, diff = engine_params(colony, device)
        self.eng = HipscEngine(gen, xp, diff=diff, device=device,
                               contact_path=traffic["contact_path"], **colony.flags)
        self.timings = {"engine": time.perf_counter() - t}
        self.bio, self.diff, self.two_d = self.eng.bio, diff, gen.is_2d
        self.start = None
        self.captures: List[float] = []

    def _note_captures(self) -> None:
        for g in self.eng.block_graphs():
            if g["capture_s"] not in self.captures:
                self.captures.append(g["capture_s"])

    def setup(self) -> None:
        """The warm-up episode from the seeded colony, then the seeded colony
        again under the grown config (``init_state`` sizes it from
        ``eng.cfg``), kept on the device."""
        clock = Clock(self.timings, self.eng.device)
        load_library(self.eng.device)
        clock("library")
        state = initial_state(self.eng, self.colony, self.seed)
        clock("colony")
        for _ in range(self.calls_per_episode):
            state, _ = self.eng.run_steps(state, self.block)
            self._note_captures()
        clock("warm_up")
        self.start = initial_state(self.eng, self.colony, self.seed)
        self.n0 = int(self.start.alive.sum())
        clock("colony_again")

    def reset(self):
        """An episode's first state: a device copy of the seeded colony."""
        self.agents = self.n0
        return clone_state(self.start)

    def call(self, state, index: int):
        """Call ``index`` of an episode: one block."""
        state, info = self.eng.run_steps(state, self.block)
        counts = np.asarray(info.num_agents, dtype=np.int64)
        starts = np.concatenate([[self.agents], counts[:-1]])
        self.agents = int(counts[-1])
        probes = tuple(tuple(np.asarray(f).tolist()) for f in info)
        return state, Call(self.block, int(starts.sum()), self.eng.block_attempts, probes)

    def colonies(self, state) -> list:
        """The colonies of a state (here one), as the counts read them."""
        return [colony_view(state)]

    def check_cases(self, kept: dict, first: int, last: int) -> list:
        """The compared ``check.Case``s of one episode's states ``kept`` by
        the steps done: the stretch from the seeded colony to step
        ``first``, and the stretch from step ``last - first`` to ``last``."""
        return [Case(self.seed, None, 1, flat_numpy(kept[first])),
                Case(self.seed, flat_numpy(kept[last - first]), last - first + 1,
                     flat_numpy(kept[last]))]

    def caps(self) -> dict:
        """The program's capacity and span caps (for the log)."""
        cfg = self.eng.cfg
        return dict(capacity=cfg.capacity, jkr_span=cfg.jkr_span, nbr_span=cfg.nbr_span)

    def graphs(self) -> list:
        return self.eng.block_graphs()

    def close(self) -> None:
        """Drop the engine, its graphs and every state."""
        self.eng = self.start = None
