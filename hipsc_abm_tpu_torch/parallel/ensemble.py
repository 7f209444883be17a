"""Ensemble execution: R independent replicate colonies stepped together
(port of ``hipsc_abm_tpu/parallel/ensemble.py``).

The reference runs one colony per process; a stochastic-replicate study or
a dose-response sweep, the way ABM results are reported, means R runs one
after another. A reference colony (5k cells) cannot fill the card: its step
is a few thousand small kernels that leave most of the SMs idle. Here the R
replicates stack along a leading axis of one ``CellState``, and on the card
``safe_step`` replays ONE CUDA graph in which each replicate's step is a
branch of its own, captured on a side stream forked from the capture stream
and joined back to it, so the card overlaps the branches' kernels: the
counterpart of ``jax.vmap`` over the replicate axis. On the CPU the same
replicate steps run eagerly, one after another.

Two ensemble modes, as in the JAX package:

- **Replicates** (``init_states(seeds)``): identical parameters, different
  RNG streams.
- **Parameter sweeps** (``sweep=``): per-replicate values of the scalar
  parameters in ``SWEEPABLE``. Each replicate steps with its own ``xp`` and
  ``bio`` (``_replace_fields``); on the card the swept values are that
  branch's launch constants, so one graph covers the whole sweep. Every
  replicate computes with exactly the Python values its solo run would, so
  a sweep point is bit-identical to its solo run (the JAX sweep computes
  with a traced float32 scalar and matches its solo run to float32
  rounding only).

The JAX ensemble forces ``use_pallas=False``; its counterpart here is
``contact_path="id_list"`` (the ``_physics_scan_xla`` design), which the
wrapped engine's config is forced to. On the card the branches run the
port's kernels (B6 x11 per step, B4 x3, B5 and the fixed-order deposit with
diffusion); the plain versions run only on the CPU.

The branches share only read-only inputs: every kernel wrapper allocates
its outputs (and FTCS its arrival counter) per call on the current stream,
and the only cache in ``ops`` (``ftcs.ftcs_plan``) holds host-side plans.
FTCS is one cooperative launch whose grid barrier needs all its CTAs
resident at once; two on concurrent branches could each hold part of the
card and wait forever, so the branches' FTCS launches are chained
(``ftcs.serialized``), one after another.

Growth semantics: the probes of the R replicates are max-reduced on the
device and fetched once per attempt; a single shared config grows for all
replicates (stacked states stay uniform in shape) by
``HipscEngine._grown_cfg``, and the step re-executes from its unmodified
input. Dynamics are layout- and capacity-independent (id-keyed RNG, stable
ids) and the deposit sums in a fixed order, so every replicate stays
bit-identical to the same seed run solo, on the card as on the CPU.

``shard_states`` (the replicate axis over a device mesh) waits for the
port's multi-device engine.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from hipsc_abm_tpu_torch.engine import (
    CellState,
    EngineConfig,
    HipscEngine,
    StepInfo,
    _CapturedGraph,
    _probes_from_host,
    _run_block,
    hipsc_step,
    step_inputs,
)
from hipsc_abm_tpu_torch.ops import ftcs
from hipsc_abm_tpu_torch.ops.jkr import BondState

# Scalar parameters a sweep may vary per replicate, as in the JAX package:
# consumed by the step only through arithmetic and comparisons, never to
# choose what the step runs —
#   xp.dox_step:        biology.cell_pathway  `current_step >= xp.dox_step`
#   xp.lonely_thresh:   biology.cell_death    `nbr_count < lonely_thresh`
#   bio.GATA6_prob:     biology.cell_stochastic_update  Bernoulli threshold
#   bio.NANOG_prob:     biology.cell_stochastic_update  Bernoulli threshold
# and the five continuous physics parameters (the contact law's constants,
# the Stokes drag, the motility force). The window sizes (the contact grid's
# bin) come from the BASE parameter values: sweep the force law around the
# base, not orders of magnitude past it, or re-base the engine.
# Each entry maps name -> which params object it lives on.
SWEEPABLE: Dict[str, str] = {
    "dox_step": "xp",
    "lonely_thresh": "xp",
    "GATA6_prob": "bio",
    "NANOG_prob": "bio",
    "adhesion_const": "bio",
    "poisson": "bio",
    "youngs": "bio",
    "stokes": "bio",
    "motility_force": "bio",
}

# seconds one replay of the ensemble's graph may take before safe_step
# raises instead of waiting on (a replay takes milliseconds)
REPLAY_DEADLINE_S = 60.0


class StepParams(NamedTuple):
    """The parameters one replicate steps with (``_run_block`` reads them
    as it reads an engine's)."""

    gen: object
    xp: object
    bio: object
    diff: object


def _stack(states: Sequence[CellState]) -> CellState:
    """Solo states of one shape stacked along a leading replicate axis:
    ``key`` (R, 2) on the host, ``next_id`` (R,) and every array, bond table
    and lattice with a leading R; ``step`` is shared."""
    steps = {s.step for s in states}
    if len(steps) != 1:
        raise ValueError(f"replicates at different steps: {sorted(steps)}")
    first = states[0]

    def stack(get):
        return torch.stack([get(s) for s in states])

    return CellState(
        arrays={k: stack(lambda s, k=k: s.arrays[k]) for k in first.arrays},
        alive=stack(lambda s: s.alive),
        bonds=BondState(stack(lambda s: s.bonds.partners), stack(lambda s: s.bonds.mask)),
        gradients={k: stack(lambda s, k=k: s.gradients[k]) for k in first.gradients},
        key=stack(lambda s: s.key),
        step=first.step,
        next_id=stack(lambda s: s.next_id),
    )


def _ensemble_block(params: Sequence[StepParams], cfg: EngineConfig, states: CellState,
                    table: torch.Tensor, streams=None):
    """One step of each replicate of ``states`` with the inputs of its row
    of ``table`` ((R, 13) int64 on the states' device) and its parameters:
    the stacked new state (keys and step as the solo steps leave them) and
    the (R + 1, 14) float64 probes on the device, each replicate's row and
    then their max. With ``streams`` (one per replicate, on the card) each
    replicate's step runs on its own stream, forked from the current stream
    and joined back to it, and the FTCS launches run one after another
    (``ftcs.serialized``): what the ensemble's graph captures. Without,
    the steps run one after another."""
    outs = []
    if streams is None:
        for i, p in enumerate(params):
            outs.append(_run_block(p, cfg, EnsembleEngine.replicate(states, i), table[i:i + 1]))
    else:
        fork = torch.cuda.current_stream()
        with ftcs.serialized():
            for i, (p, stream) in enumerate(zip(params, streams)):
                stream.wait_stream(fork)
                with torch.cuda.stream(stream):
                    outs.append(_run_block(p, cfg, EnsembleEngine.replicate(states, i),
                                           table[i:i + 1]))
        for stream in streams:
            fork.wait_stream(stream)
    probes = torch.cat([p for _, p in outs])
    return (_stack([s for s, _ in outs]),
            torch.cat([probes, probes.max(dim=0, keepdim=True).values]))


class EnsembleEngine:
    """Host side of a stacked ensemble of replicate colonies.

    Wraps a :class:`HipscEngine` (whose config and parameters define every
    replicate, and whose device the ensemble runs on) and mirrors its
    ``step`` / ``safe_step`` surface on stacked states with a leading
    replicate axis.
    """

    def __init__(self, engine: HipscEngine,
                 sweep: Optional[Dict[str, Sequence[float]]] = None):
        if engine.cfg.contact_path != "id_list":
            engine.cfg = dataclasses.replace(engine.cfg, contact_path="id_list")
        self.engine = engine
        self.device = engine.device
        self.sweep: Optional[Dict[str, list]] = None
        self.n_replicates: Optional[int] = None
        if sweep:
            bad = sorted(set(sweep) - set(SWEEPABLE))
            if bad:
                raise ValueError(
                    f"not sweepable (trace-time parameters): {bad}; "
                    f"sweepable: {sorted(SWEEPABLE)}"
                )
            lens = {len(v) for v in sweep.values()}
            if len(lens) != 1:
                raise ValueError("sweep value lists must share one length")
            self.n_replicates = lens.pop()
            self.sweep = {k: np.asarray(v).tolist() for k, v in sweep.items()}
        # the captured ensembles on the card, by (R, config, per-replicate
        # parameters); the attempts (re-executions + 1) of the last safe_step
        self._graphs: Dict[tuple, _CapturedGraph] = {}
        self.attempts = 0

    # -- construction --------------------------------------------------------

    def _overrides(self, i: int) -> dict:
        return {k: v[i] for k, v in self.sweep.items()} if self.sweep else {}

    def replicate_params(self, n: int) -> Tuple[StepParams, ...]:
        """The parameters of each of ``n`` replicates: the engine's, with
        replicate i's swept values substituted."""
        if self.n_replicates is not None and n != self.n_replicates:
            raise ValueError(f"{n} replicates for a {self.n_replicates}-point sweep")
        eng = self.engine
        return tuple(StepParams(eng.gen, _replace_fields(eng.xp, self._overrides(i), "xp"),
                                _replace_fields(eng.bio, self._overrides(i), "bio"), eng.diff)
                     for i in range(n))

    def init_states(self, seeds: Sequence[int]) -> CellState:
        """Stacked initial colonies, one per seed (replicate axis first), on
        the engine's device.

        With a sweep configured, ``len(seeds)`` must match the sweep length,
        and initialization runs with each replicate's swept values
        substituted in (no ``SWEEPABLE`` entry is read by ``init_state``
        today, so this is future-proofing, as in the JAX package). The JAX
        ensemble also sizes one shared config's window caps for the densest
        replicate; the port's caps (``run_cap``) are 0, since its kernels
        walk exact run bounds, so there is nothing to share."""
        seeds = list(seeds)
        if self.n_replicates is not None and len(seeds) != self.n_replicates:
            raise ValueError(
                f"{len(seeds)} seeds for a {self.n_replicates}-point sweep"
            )
        eng = self.engine
        states = []
        base_xp, base_bio = eng.xp, eng.bio
        try:
            for i, seed in enumerate(seeds):
                eng.xp = _replace_fields(base_xp, self._overrides(i), "xp")
                eng.bio = _replace_fields(base_bio, self._overrides(i), "bio")
                states.append(eng.init_state(seed=seed))
        finally:
            eng.xp, eng.bio = base_xp, base_bio
        return _stack(states)

    @staticmethod
    def replicate(states: CellState, i: int) -> CellState:
        """Unstacked view of replicate ``i`` — feed to the existing output /
        checkpoint surfaces unchanged."""
        return CellState(
            arrays={k: v[i] for k, v in states.arrays.items()},
            alive=states.alive[i],
            bonds=BondState(states.bonds.partners[i], states.bonds.mask[i]),
            gradients={k: v[i] for k, v in states.gradients.items()},
            key=states.key[i],
            step=states.step,
            next_id=states.next_id[i],
        )

    # -- stepping -------------------------------------------------------------

    def _cfg_for_states(self, states: CellState) -> EngineConfig:
        cfg = self.engine.cfg
        capacity = states.alive.shape[1]
        bond_cap = states.bonds.partners.shape[2]
        if cfg.capacity != capacity or cfg.bond_cap != bond_cap:
            cfg = dataclasses.replace(cfg, capacity=capacity, bond_cap=bond_cap)
        return cfg

    def step(self, states: CellState) -> Tuple[CellState, StepInfo]:
        """Raw step (no overflow handling), eager: each replicate stepped by
        ``hipsc_step`` in turn and the outputs stacked. ``StepInfo`` fields
        are (R,) tensors on the device."""
        cfg = self._cfg_for_states(states)
        params = self.replicate_params(states.alive.shape[0])
        outs = [hipsc_step(self.replicate(states, i), cfg, *p) for i, p in enumerate(params)]
        infos = StepInfo(*(
            torch.stack([torch.as_tensor(getattr(info, f), device=self.device).reshape(())
                         for _, info in outs])
            for f in StepInfo._fields))
        return _stack([s for s, _ in outs]), infos

    def safe_step(self, states: CellState) -> Tuple[CellState, StepInfo]:
        """Step all replicates with exact capacity-overflow recovery.

        Mirrors :meth:`HipscEngine.safe_step`: the probes reduce with
        ``max`` over the replicate axis on the device and come to the host
        in one transfer per attempt, the shared config grows once for all
        replicates, and the step re-executes from its unmodified input — no
        replicate is ever silently truncated. On the card each attempt is
        one replay of the graph of ``(R, config, parameters)``, waited on
        with a deadline (``REPLAY_DEADLINE_S``); on the CPU the replicate
        steps run eagerly. ``StepInfo`` fields are (R,) numpy arrays."""
        eng = self.engine
        params = self.replicate_params(states.alive.shape[0])
        for attempt in range(1, 17):
            self.attempts = attempt
            cfg = self._cfg_for_states(states)
            inputs = [step_inputs(key, states.step) for key in states.key]
            table = torch.cat([t for t, _ in inputs])
            if self.device.type == "cuda":
                new_states, probes = self._graph_for(cfg, params, states).run(
                    states, table, deadline_s=REPLAY_DEADLINE_S)
            else:
                new_states, probes = _ensemble_block(params, cfg, states, table)
            rows = probes.tolist()
            grown_cfg = eng._grown_cfg(cfg, _probes_from_host(rows[-1]))
            if grown_cfg is None:
                keys = torch.stack([k[-1] for _, k in inputs])
                return (new_states._replace(key=keys, step=states.step + 1),
                        _probes_from_host(rows[:-1], stacked=True))
            eng.cfg = grown_cfg
            states = self.repad_states(states, grown_cfg)
        raise RuntimeError("capacity growth failed to converge")

    def _graph_for(self, cfg: EngineConfig, params, states: CellState) -> _CapturedGraph:
        """The captured ensemble step of ``len(params)`` replicates under
        ``cfg`` and the replicates' parameters (the graph holds their values
        as launch constants); graphs of other keys are dropped with their
        memory pools, as ``HipscEngine._graph_for`` drops them."""
        fixed = (cfg, params)
        graphs = self._graphs
        for key in [key for key in graphs if key[1:] != fixed]:
            del graphs[key]
        R = len(params)
        if (R,) + fixed not in graphs:
            torch.cuda.empty_cache()  # return the dropped pools
            streams = [torch.cuda.Stream(self.device) for _ in range(R)]

            def warm_up():
                hipsc_step(self.replicate(states, 0), cfg, *params[0])

            graph = _CapturedGraph(
                self.device, lambda s, t: _ensemble_block(params, cfg, s, t, streams),
                states, (R, 13), warm_up)
            graph.streams = streams
            graphs[(R,) + fixed] = graph
        return graphs[(R,) + fixed]

    def graphs(self) -> list:
        """The captured ensembles held: ``{"replicates", "capture_s",
        "pool_mib", "launches"}`` each (as ``HipscEngine.block_graphs``)."""
        return [dict(replicates=key[0], capture_s=g.capture_s, pool_mib=g.pool_bytes / 2**20,
                     launches=dict(g.launches)) for key, g in self._graphs.items()]

    @staticmethod
    def repad_states(states: CellState, cfg: EngineConfig) -> CellState:
        """Re-pad every replicate to a (larger) capacity / bond capacity."""
        return _stack([HipscEngine.repad_state(EnsembleEngine.replicate(states, i), cfg)
                       for i in range(states.alive.shape[0])])


def _replace_fields(params, values: Dict[str, object], owner: str):
    """Copy ``params`` with the swept fields that live on ``owner``
    replaced (``params`` itself when none does)."""
    mine = {k: v for k, v in values.items() if SWEEPABLE.get(k) == owner}
    return dataclasses.replace(params, **mine) if mine else params
