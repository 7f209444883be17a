"""The ensemble entry: ``EnsembleEngine.safe_step(states)`` over R
replicate colonies, on the card one CUDA graph of R branches per step and
one probe fetch, as a replicate study steps it.

Replicate i starts from seed ``seed * R + i``. Set-up runs one whole
warm-up episode (growth and the capture) and makes the replicates again
under the grown config. The run compares ``CHECK_REPLICATES`` of the
replicates, drawn from the seed.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np

from portbench.catalog import load_module
from portbench.check import Case, flat_numpy

_blocks = load_module("entries", "engine_blocks")
Call = _blocks.Call
# the replicates compared with the reference
CHECK_REPLICATES = 4


def _replicate(states, i: int):
    from hipsc_abm_tpu_torch.parallel.ensemble import EnsembleEngine

    return EnsembleEngine.replicate(states, i)


def checked_replicates(replicates: int, seed: int) -> list:
    """The compared replicates, ``CHECK_REPLICATES`` of them (all where
    there are fewer) drawn from the seed."""
    picks = np.random.default_rng(seed).choice(replicates, min(CHECK_REPLICATES, replicates),
                                               replace=False)
    return sorted(int(i) for i in picks)


def compared_seeds(traffic: dict, seed: int) -> list:
    """The seeds of the compared colonies (replicate i's is ``seed * R + i``)."""
    R = int(traffic["replicates"])
    return [seed * R + i for i in checked_replicates(R, seed)]


class Entry:
    """One step of R stacked replicate colonies per call."""

    def __init__(self, colony, traffic: dict, seed: int, device: str):
        from hipsc_abm_tpu_torch.engine import HipscEngine
        from hipsc_abm_tpu_torch.parallel.ensemble import EnsembleEngine

        if colony.locations is not None or colony.seeded_radii:
            raise ValueError("the ensemble entry takes colonies drawn by init_state alone")
        self.colony, self.seed = colony, seed
        self.replicates = int(traffic["replicates"])
        self.seeds = [seed * self.replicates + i for i in range(self.replicates)]
        self.block = 1  # safe_step: one step of every replicate a call
        self.calls_per_episode = int(traffic["horizon"])
        t = time.perf_counter()
        gen, xp, diff = _blocks.engine_params(colony, device)
        eng = HipscEngine(gen, xp, diff=diff, device=device,
                          contact_path=traffic["contact_path"], **colony.flags)
        self.ens = EnsembleEngine(eng)
        self.timings = {"engine": time.perf_counter() - t}
        self.bio, self.diff, self.two_d = eng.bio, diff, gen.is_2d
        self.start = None
        self.captures: List[float] = []

    def _note_captures(self) -> None:
        for g in self.ens.graphs():
            if g["capture_s"] not in self.captures:
                self.captures.append(g["capture_s"])

    def setup(self) -> None:
        clock = _blocks.Clock(self.timings, self.ens.device)
        _blocks.load_library(self.ens.device)
        clock("library")
        states = self.ens.init_states(self.seeds)
        clock("colony")
        for _ in range(self.calls_per_episode):
            states, _ = self.ens.safe_step(states)
            self._note_captures()
        clock("warm_up")
        self.start = self.ens.init_states(self.seeds)
        self.n0 = int(self.start.alive.sum())
        clock("colony_again")

    def reset(self):
        self.agents = self.n0
        return _blocks.clone_state(self.start)

    def call(self, states, index: int):
        states, info = self.ens.safe_step(states)
        agents = self.agents
        self.agents = int(np.asarray(info.num_agents).sum())
        probes = tuple(tuple(np.asarray(f).tolist()) for f in info)
        return states, Call(1, agents, self.ens.attempts, probes)

    def colonies(self, states) -> list:
        return [_blocks.colony_view(_replicate(states, i)) for i in range(self.replicates)]

    def check_cases(self, kept: dict, first: int, last: int) -> list:
        """``engine_blocks.Entry.check_cases`` for each compared replicate."""
        def flat(steps, i):
            return flat_numpy(_replicate(kept[steps], i))
        cases = []
        for i in checked_replicates(self.replicates, self.seed):
            cases += [Case(self.seeds[i], None, 1, flat(first, i)),
                      Case(self.seeds[i], flat(last - first, i), last - first + 1,
                           flat(last, i))]
        return cases

    def caps(self) -> dict:
        cfg = self.ens.engine.cfg
        return dict(capacity=cfg.capacity, jkr_span=cfg.jkr_span, nbr_span=cfg.nbr_span)

    def graphs(self) -> list:
        return self.ens.graphs()

    def close(self) -> None:
        self.ens = self.start = None
