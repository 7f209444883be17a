"""Simulation-based calibration: fit model parameters to observed statistics
(port of ``hipsc_abm_tpu/calibrate.py``).

The reference framework has no calibration story at all: fitting its
biophysical constants (`cell_simulation.py:34-57`) to data means hand-tuning
across whole re-runs. Two strategies are exposed here behind one small API:

1. **Gradient calibration** (:meth:`Calibrator.fit`): reverse-mode autograd
   straight through a multi-step rollout of ``engine.hipsc_step``. The
   contact mechanics, Stokes integration and motility forces are continuous
   in the :data:`DIFFERENTIABLE` parameters, which enter the step as 0-d
   float32 tensors; the discrete fate and division events contribute zero
   (a fixed control sequence around the differentiable physics). The
   kernels take the pair law's constants as host floats and have no
   backward, so the gradient evaluation runs ``hipsc_step(plain=True)``:
   the plain PyTorch contact substeps, bio moments and FTCS on any device,
   with the id-list contact path (``dense_pairs`` off), as the JAX
   calibrator differentiates its XLA path. The JAX calibrator also
   rematerialises every contact substep, for the residuals of a vmap over
   all replicates; here the replicates roll out in turn, so a step's
   substep residuals are one colony's, and ``EngineConfig.remat_substeps``
   stays the engine's (off unless set: on the card it costs more time than
   the memory it saves is worth at calibration sizes). The deposit keeps its fixed-order
   kernel on the card, so a recompute replays the forward bit for bit (no
   gradient reaches it: its terms are constants of the agents' discrete
   states). With ``remat`` each step is rematerialised too
   (``torch.utils.checkpoint``), so reverse-mode memory stays O(state), not
   O(horizon * state). The NaN guards this relies on live in ``ops/jkr.py``,
   ``ops/integrate.py`` and ``models/biology.py``.

2. **Evolution-strategy calibration** (:meth:`Calibrator.fit_es`): for
   parameters whose effect is purely through discrete events (the
   Bernoulli fate probabilities, whose pathwise gradient is zero a.e.).
   Antithetic OpenAI-style ES with rank shaping. A population of P
   candidates over R replicates rolls out forward on the engine's path as
   one ``parallel.ensemble`` sweep of P * R branches (candidates repeated
   over the replicates, the initial states tiled, the same seeds: common
   random numbers): on the card one CUDA graph per generation, captured at
   its first step and replayed for the rest of the horizon, the
   counterpart of the JAX calibrator's ``jax.vmap`` over candidates. Each
   candidate's loss equals its solo rollout's (:meth:`Calibrator.evaluate`)
   bit for bit.

Both optimise in an unconstrained transform space (log for positive
parameters, logit for probabilities) with a ``torch.optim`` optimiser
(Adam by default, optax's defaults), and share growth-safe evaluation: the
overflow probes of every rollout are max-reduced and fed to the engine's
growth policy, and the whole rollout re-runs on a grown config, as the JAX
calibrator does. The calibrator forces ``contact_path="id_list"`` (the JAX
one forces ``use_pallas=False``) and selects ``dense_pairs`` at capacity
<= 4096 for its forward-only rollouts.
"""

from __future__ import annotations

import dataclasses
import math
import sys
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from hipsc_abm_tpu_torch.engine import (
    CellState,
    EngineConfig,
    HipscEngine,
    StepInfo,
    _probe_row,
    _probes_from_host,
    hipsc_step,
)
from hipsc_abm_tpu_torch.ops import rng
from hipsc_abm_tpu_torch.parallel.ensemble import EnsembleEngine, StepParams, _stack

# BiologyParams floats consumed by the step ONLY through arithmetic, with a
# non-zero pathwise derivative (they scale or shape the continuous physics):
#   adhesion_const, poisson, youngs : ops/jkr.py _pair_jkr (force law)
#   stokes                          : ops/integrate.py stokes_integrate
#   motility_force                  : models/biology.py cell_motility
DIFFERENTIABLE = frozenset(
    {"adhesion_const", "poisson", "youngs", "stokes", "motility_force"}
)

# Additionally searchable by ES: consumed arithmetically but through a.e.
# flat discrete events, so pathwise gradients are zero while finite moves
# do change the outcome.
#   GATA6_prob, NANOG_prob : biology.cell_stochastic_update Bernoulli gates
#   (a config-disabled reference method: requires enable_stochastic=True,
#   enforced in Calibrator.__init__)
SEARCHABLE = DIFFERENTIABLE | frozenset({"GATA6_prob", "NANOG_prob"})

# names that only have an effect behind an EngineConfig feature gate
_REQUIRES_FLAG = {"GATA6_prob": "enable_stochastic",
                  "NANOG_prob": "enable_stochastic"}

# unconstrained-space transform per parameter: positive -> log, (0,1) -> logit
_LOGIT = frozenset({"poisson", "GATA6_prob", "NANOG_prob"})


def _to_unconstrained(name: str, x: float) -> float:
    if name in _LOGIT:
        return math.log(x / (1.0 - x))
    return math.log(x)


def _from_unconstrained(name: str, t: torch.Tensor) -> torch.Tensor:
    if name in _LOGIT:
        return torch.sigmoid(t)
    return torch.exp(t)


# ---------------------------------------------------------------------------
# built-in colony statistics (loss building blocks); each takes a solo
# CellState and returns a 0-d float32 tensor on the state's device
# ---------------------------------------------------------------------------


def radius_of_gyration(state: CellState) -> torch.Tensor:
    """RMS distance of alive cells from the colony's center of mass (um) —
    the standard compaction statistic for adhesion/motility calibration."""
    locs = state.arrays["locations"]
    alive = state.alive
    n = torch.clamp(alive.sum(), min=1)
    com = torch.where(alive[:, None], locs, 0.0).sum(dim=0) / n
    r2 = torch.where(alive, ((locs - com) ** 2).sum(dim=-1), 0.0).sum() / n
    return torch.sqrt(r2)


def soft_contact_count(r_contact: float = 10.0, width: float = 1.0):
    """Statistic factory: differentiable mean contact coordination — for
    each alive cell, the sigmoid-smoothed number of alive neighbours within
    ``r_contact`` um (``sum_j sigmoid((r_contact - d_ij) / width)``),
    averaged over the colony.

    The second observable that breaks the (adhesion, motility) compensating
    ridge (docs/CALIBRATION.md): compaction (Rg) measures colony extent,
    which both force scales move; coordination measures local packing,
    which adhesion increases by pulling pairs into overlap. The smooth gate
    keeps the pathwise gradient alive; compute the target from observed
    positions with the same ``r_contact``/``width``. O(C^2) pairwise: the
    squared distances come from the Gram identity ``|x_i|^2 + |x_j|^2 -
    2 <x_i, x_j>`` (one (C, 3) x (3, C) matmul), as in the JAX package, so
    that no (C, C, 3) difference tensor is saved for the backward pass."""

    def stat(state: CellState) -> torch.Tensor:
        locs = state.arrays["locations"]
        alive = state.alive
        sq = (locs * locs).sum(dim=-1)
        d2 = sq[:, None] + sq[None, :] - 2.0 * (locs @ locs.T)
        # guarded: exact zero only on the masked diagonal; clamp the tiny
        # negative residue the Gram form can leave on near-coincident pairs
        d = torch.sqrt(torch.clamp(d2, min=0.0) + 1e-12)
        gate = torch.sigmoid((r_contact - d) / width)
        pair = alive[:, None] & alive[None, :]
        pair = pair & ~torch.eye(alive.shape[0], dtype=torch.bool, device=alive.device)
        per_cell = torch.where(pair, gate, 0.0).sum(dim=1)
        n = torch.clamp(alive.sum(), min=1)
        return torch.where(alive, per_cell, 0.0).sum() / n

    return stat


def gata6_high_fraction(state: CellState) -> torch.Tensor:
    """Fraction of alive cells with GATA6 > NANOG — the fate statistic the
    FDS probabilities control."""
    high = state.alive & (state.arrays["GATA6"] > state.arrays["NANOG"])
    return (high.sum() / torch.clamp(state.alive.sum(), min=1)).to(torch.float32)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, dtype=np.float32))


def squared_error(statistic: Callable[[CellState], torch.Tensor],
                  target: float) -> Callable[[CellState], torch.Tensor]:
    """Loss factory: ``(statistic(final_state) - target)**2``."""
    target = _f32(target)

    def loss(state: CellState) -> torch.Tensor:
        stat = statistic(state)
        return (stat - target.to(stat.device)) ** 2

    return loss


@dataclasses.dataclass(frozen=True)
class TrajectoryLoss:
    """Loss over the whole rollout instead of the final state — the shape of
    real calibration data (a time course of measurements, one per step).

    ``statistic`` maps each post-step state to a tensor of measurements;
    ``loss`` maps the stacked ``(horizon, ...)`` statistics to a scalar."""

    statistic: Callable[[CellState], torch.Tensor]
    loss: Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class EnsembleTrajectoryLoss(TrajectoryLoss):
    """Trajectory loss on the replicate-MEAN statistic time course.

    The trajectory analog of :class:`EnsembleLoss`: with a stacked state, a
    plain :class:`TrajectoryLoss` averages per-replicate losses, which
    bottoms out at each replicate's own seed noise against the target; an
    observed target that is itself a multi-run average is matched by the
    simulated replicate-mean course, whose loss is exactly zero at a
    perfect fit. Wrap any trajectory loss with
    :func:`ensemble_trajectory`."""


def ensemble_trajectory(loss: TrajectoryLoss) -> EnsembleTrajectoryLoss:
    """Method-of-moments wrapper: apply ``loss`` to the replicate-mean
    statistic trajectory instead of averaging per-replicate losses."""
    return EnsembleTrajectoryLoss(statistic=loss.statistic, loss=loss.loss)


def trajectory_squared_error(statistic: Callable[[CellState], torch.Tensor],
                             targets) -> TrajectoryLoss:
    """Mean squared error of a per-step statistic against an observed time
    course (``targets`` has shape ``(horizon,) + statistic shape``)."""
    targets = _f32(targets)

    def loss(stats: torch.Tensor) -> torch.Tensor:
        return ((stats - targets.to(stats.device)) ** 2).mean()

    return TrajectoryLoss(statistic, loss)


def delta_trajectory_squared_error(
        statistic: Callable[[CellState], torch.Tensor],
        targets) -> TrajectoryLoss:
    """Mean squared error of the per-step CHANGE of a statistic against the
    observed time course's change (both anchored at their first entry).

    The right loss when the statistic has a nuisance offset the dynamics do
    not control, e.g. each replicate's initial radius of gyration, which
    varies by ~Rg/sqrt(2N) from random placement: differencing cancels the
    offset exactly, per replicate and in the target."""
    targets = _f32(targets)

    def loss(stats: torch.Tensor) -> torch.Tensor:
        t = targets.to(stats.device)
        return (((stats - stats[0]) - (t - t[0])) ** 2).mean()

    return TrajectoryLoss(statistic, loss)


def multi_delta_trajectory_squared_error(observations, weights=None):
    """Joint delta-trajectory loss over SEVERAL statistics — the
    multi-observable objective that makes force scales jointly
    identifiable where one statistic has a compensating ridge
    (docs/CALIBRATION.md: (adhesion, motility) against compaction alone).

    ``observations`` is a sequence of ``(statistic_fn, targets)`` pairs, each
    ``targets`` a (horizon,) observed time course. Each statistic
    contributes the MSE of its per-step change (anchored at the first
    entry), normalised by the mean squared delta of its own target, so that
    a um-scale compaction course and a count-scale coordination course weigh
    equally. Pass explicit ``weights`` to override."""
    fns = [fn for fn, _ in observations]
    targets = torch.stack([_f32(t) for _, t in observations], dim=1)  # (horizon, n)
    tdelta = targets - targets[0]
    if weights is None:
        w = 1.0 / ((tdelta ** 2).mean(dim=0) + 1e-12)
    else:
        w = _f32(weights)

    def statistic(state: CellState) -> torch.Tensor:
        return torch.stack([fn(state) for fn in fns])  # (n_stats,)

    def loss(stats: torch.Tensor) -> torch.Tensor:  # (horizon, n_stats)
        d = (stats - stats[0]) - tdelta.to(stats.device)
        return (w.to(stats.device) * (d ** 2).mean(dim=0)).sum()

    return TrajectoryLoss(statistic, loss)


@dataclasses.dataclass(frozen=True)
class EnsembleLoss:
    """Loss on the replicate-AVERAGED statistic (method of moments).

    With a stacked-replicate state, a plain ``loss_fn`` is applied per
    replicate and the losses are averaged; against one scalar observation
    that bottoms out at the across-replicate variance of the statistic.
    ``EnsembleLoss`` averages ``statistic`` over the replicates first and
    applies ``loss`` to the mean, which is exactly zero at a perfect fit.
    On a flat (single-colony) state it is ``loss(statistic(final))``."""

    statistic: Callable[[CellState], torch.Tensor]
    loss: Callable[[torch.Tensor], torch.Tensor]


def ensemble_squared_error(statistic: Callable[[CellState], torch.Tensor],
                           target) -> EnsembleLoss:
    """``(mean over replicates of statistic(final) - target)**2``."""
    target = _f32(target)

    def loss(mean_stat: torch.Tensor) -> torch.Tensor:
        return ((mean_stat - target.to(mean_stat.device)) ** 2).sum()

    return EnsembleLoss(statistic, loss)


@dataclasses.dataclass
class FitResult:
    """Outcome of a calibration run."""

    params: Dict[str, float]  # BEST-evaluated parameter values (model space)
    theta: np.ndarray  # best values in the unconstrained space (optimizers
    # overshoot; the lowest-loss iterate seen is the fit, not the last one)
    loss_history: List[float]  # loss at each iterate (gradient: per step;
    # ES: population mean per generation, plus one final entry — the
    # unperturbed loss of the returned parameters)
    n_evaluations: int  # rollouts executed (ES counts the population)

    @property
    def best_loss(self) -> float:
        return min(self.loss_history)


class Calibrator:
    """Fits selected ``BiologyParams`` fields of ``engine`` so that
    ``loss_fn(final_state)`` of a ``horizon``-step rollout is minimised.

    ``loss_fn`` maps the rollout's final :class:`CellState` to a scalar
    tensor (compose one from the built-in statistics and
    :func:`squared_error`, or write any PyTorch function of the state), or
    is a :class:`TrajectoryLoss` fitting a per-step time course. The
    engine's current parameter values are the initial iterate. The wrapped
    engine's config is shared and may grow (capacity probes) during
    fitting, exactly like ``safe_step``; the engine's device (the card by
    default) runs every rollout.

    ``state`` may also be a STACKED ensemble of replicates
    (``EnsembleEngine.init_states``): the fit minimises the
    replicate-averaged objective — the mean of per-replicate losses for a
    plain ``loss_fn``, or, with an :class:`EnsembleLoss` or
    :class:`EnsembleTrajectoryLoss`, the loss on the replicate-mean
    statistic. A gradient evaluation runs the R replicates in one autograd
    graph.
    """

    def __init__(self, engine: HipscEngine, param_names: Sequence[str],
                 loss_fn: Callable[[CellState], torch.Tensor],
                 horizon: int = 4, remat: bool = True,
                 dense_pairs: Optional[bool] = None):
        bad = sorted(set(param_names) - SEARCHABLE)
        if bad:
            raise ValueError(
                f"not calibratable (static/trace-time parameters): {bad}; "
                f"searchable: {sorted(SEARCHABLE)}"
            )
        gated = sorted(
            n for n in param_names
            if n in _REQUIRES_FLAG
            and not getattr(engine.cfg, _REQUIRES_FLAG[n])
        )
        if gated:
            raise ValueError(
                f"{gated} only affect the simulation with "
                f"{sorted({_REQUIRES_FLAG[n] for n in gated})} set on the "
                "engine — the fit would see a constant loss"
            )
        if engine.cfg.contact_path != "id_list":
            engine.cfg = dataclasses.replace(engine.cfg, contact_path="id_list")
        if dense_pairs is None:
            # the JAX calibrator's rule: all-pairs physics below a few
            # thousand slots, for the forward-only rollouts
            dense_pairs = engine.cfg.capacity <= 4096
        if dense_pairs != engine.cfg.dense_pairs:
            engine.cfg = dataclasses.replace(engine.cfg, dense_pairs=bool(dense_pairs))
        self.engine = engine
        self.names: Tuple[str, ...] = tuple(param_names)
        self.loss_fn = loss_fn
        if int(horizon) < 1:
            raise ValueError("horizon must be >= 1")
        self.horizon = int(horizon)
        self.remat = bool(remat)
        self._ens: Optional[EnsembleEngine] = None  # prepare's and the populations'

    # -- parameter-space plumbing -------------------------------------------

    def theta0(self) -> torch.Tensor:
        """The engine's current parameter values in unconstrained space, a
        (n,) float32 tensor on the CPU."""
        return torch.tensor(
            [_to_unconstrained(n, getattr(self.engine.bio, n)) for n in self.names],
            dtype=torch.float32,
        )

    def params(self, theta) -> Dict[str, float]:
        """Unconstrained iterate -> model-space parameter dict (the float32
        values, as Python floats)."""
        theta = torch.as_tensor(theta, dtype=torch.float32).detach().cpu()
        return {n: float(_from_unconstrained(n, theta[i])) for i, n in enumerate(self.names)}

    def _bio_with(self, theta: torch.Tensor):
        """BiologyParams with the calibrated fields replaced by 0-d float32
        tensors, transforms of ``theta`` that autograd records."""
        over = {n: _from_unconstrained(n, theta[i]) for i, n in enumerate(self.names)}
        return dataclasses.replace(self.engine.bio, **over)

    def _grad_cfg(self, cfg: EngineConfig) -> EngineConfig:
        """The gradient evaluation's config: the windowed id-list physics,
        whatever ``dense_pairs`` the forward-only rollouts take (the dense
        path's (C, C) intermediates would be saved residuals), with the
        engine's ``remat_substeps``."""
        return dataclasses.replace(cfg, dense_pairs=False)

    def _ensemble(self) -> EnsembleEngine:
        if self._ens is None:
            self._ens = EnsembleEngine(self.engine)
        return self._ens

    # -- rollout --------------------------------------------------------------

    def _step(self, state: CellState, cfg: EngineConfig, bio, plain: bool):
        """One step of a rollout: the new state, its (16,) probes and, for
        a :class:`TrajectoryLoss`, the step's statistic (else None)."""
        eng = self.engine
        state, info = hipsc_step(state, cfg, eng.gen, eng.xp, bio, eng.diff, plain=plain)
        stat = (self.loss_fn.statistic(state)
                if isinstance(self.loss_fn, TrajectoryLoss) else None)
        return state, _probe_row(info), stat

    def _single_out(self, final: CellState, stats: list) -> torch.Tensor:
        """One colony's contribution: its loss, except under an
        :class:`EnsembleLoss` (the final statistic) or an
        :class:`EnsembleTrajectoryLoss` (the (horizon, ...) statistics),
        which ``_reduce`` aggregates across replicates first."""
        if isinstance(self.loss_fn, EnsembleTrajectoryLoss):
            return torch.stack(stats)
        if isinstance(self.loss_fn, TrajectoryLoss):
            return self.loss_fn.loss(torch.stack(stats))
        if isinstance(self.loss_fn, EnsembleLoss):
            return self.loss_fn.statistic(final)
        return self.loss_fn(final)

    def _reduce(self, outs: list, stacked: bool) -> torch.Tensor:
        """The loss of one parameter vector from its replicates' outputs: a
        stacked state's replicate-averaged objective (the loss of the mean
        statistic under the ensemble losses), or a flat state's own."""
        ensemble = isinstance(self.loss_fn, (EnsembleLoss, EnsembleTrajectoryLoss))
        if stacked:
            outs = torch.stack(outs)
            return self.loss_fn.loss(outs.mean(dim=0)) if ensemble else outs.mean()
        return self.loss_fn.loss(outs[0]) if ensemble else outs[0]

    def _rollout_single(self, bio, state: CellState, cfg: EngineConfig, plain: bool):
        """One colony rolled out ``horizon`` steps: its ``_single_out`` and
        the (16,) max of its steps' probes. With ``remat``, while autograd
        records, each step and its statistic are a checkpoint whose
        intermediates the backward pass recomputes (the step is
        deterministic, so the recompute replays its discrete events), as
        the JAX calibrator checkpoints its scan body."""
        stats, rows = [], []
        for _ in range(self.horizon):
            if self.remat and torch.is_grad_enabled():
                state, row, stat = torch.utils.checkpoint.checkpoint(
                    self._step, state, cfg, bio, plain, use_reentrant=False)
            else:
                state, row, stat = self._step(state, cfg, bio, plain)
            rows.append(row)
            stats.append(stat)
        return self._single_out(state, stats), torch.stack(rows).max(dim=0).values

    def _rollout(self, bio, state: CellState, cfg: EngineConfig, plain: bool):
        """Rollout loss of one parameter set ``bio`` and the rollout's max
        probes (a (16,) tensor). A stacked state (leading replicate axis,
        as built by ``EnsembleEngine.init_states``) rolls each replicate out
        in turn, in one autograd graph, and reduces as the JAX calibrator's
        ``_rollout`` does."""
        stacked = state.alive.dim() == 2
        reps = ([EnsembleEngine.replicate(state, i) for i in range(state.alive.shape[0])]
                if stacked else [state])
        outs = [self._rollout_single(bio, r, cfg, plain) for r in reps]
        return (self._reduce([o for o, _ in outs], stacked),
                torch.stack([i for _, i in outs]).max(dim=0).values)

    def _value_and_grad(self, theta: torch.Tensor, state: CellState, cfg: EngineConfig):
        """Loss and gradient at ``theta`` by reverse-mode autograd through
        the rollout on the plain path (``hipsc_step(plain=True)``) under
        ``cfg`` (``_grad_cfg``'s, or another for a measurement). Returns
        ``((loss, probes), grad)``: the loss a 0-d tensor, the probes
        (16,), the gradient a (n,) float32 tensor on the CPU."""
        t = theta.detach().to(self.engine.device).requires_grad_(True)
        loss, info = self._rollout(self._bio_with(t), state, cfg, plain=True)
        loss.backward()
        return (loss.detach(), info), t.grad.detach().cpu()

    def _population(self, cands: torch.Tensor, state: CellState):
        """Forward losses of the (P, n) candidates on the engine's path
        (the kernels on the card): one ``EnsembleEngine`` sweep of P * R
        branches, candidate c's parameters on branches c*R .. c*R + R - 1,
        each starting from replicate r of ``state`` (its seed's RNG
        stream). Each ensemble step is one ``EnsembleEngine.attempt`` (on
        the card a graph captured at the first and replayed after), with
        no growth inside: the probes are max-reduced over branches and
        steps for ``_eval_with_growth``. Returns the (P,) losses and the
        (16,) max probes; each candidate's loss equals ``evaluate``'s."""
        eng = self.engine
        stacked = state.alive.dim() == 2
        R = state.alive.shape[0] if stacked else 1
        reps = [EnsembleEngine.replicate(state, i) for i in range(R)] if stacked else [state]
        params = tuple(
            StepParams(eng.gen, eng.xp, dataclasses.replace(eng.bio, **self.params(c)),
                       eng.diff)
            for c in cands for _ in range(R))
        n = len(params)
        states = _stack(reps * cands.shape[0])
        traj = isinstance(self.loss_fn, TrajectoryLoss)
        stats: List[list] = [[] for _ in range(n)]
        rows = []
        ens = self._ensemble()
        with torch.no_grad():
            for _ in range(self.horizon):
                states, probes, _ = ens.attempt(states, params)
                rows.append(probes[-1])
                if traj:
                    for b in range(n):
                        stats[b].append(self.loss_fn.statistic(EnsembleEngine.replicate(states, b)))
            outs = [self._single_out(EnsembleEngine.replicate(states, b), stats[b])
                    for b in range(n)]
            losses = torch.stack([self._reduce(outs[c * R:(c + 1) * R], stacked)
                                  for c in range(cands.shape[0])])
        return losses, torch.tensor(rows, dtype=torch.float64).max(dim=0).values

    def evaluate(self, theta, state: CellState) -> float:
        """The loss at one iterate, forward only: each replicate rolled out
        on its own through ``hipsc_step`` on the engine's path (the kernels
        on the card), growth-safe as the fits are. The population
        evaluation of ``fit_es`` gives each candidate this loss bit for
        bit."""
        bio = dataclasses.replace(self.engine.bio, **self.params(theta))
        state = self._reconcile(state)
        with torch.no_grad():
            loss, _ = self._eval_with_growth(
                lambda st: self._rollout(bio, st, self.engine.cfg, plain=False), state)
        return float(loss)

    def _grow(self, state: CellState, info_max_host: StepInfo):
        """Apply the engine's growth policy to max-reduced rollout probes;
        returns the (possibly re-padded) state and whether anything grew."""
        eng = self.engine
        grown = eng._grown_cfg(eng.cfg, info_max_host)
        if grown is None:
            return state, False
        eng.cfg = grown
        if state.alive.dim() == 2:
            return EnsembleEngine.repad_states(state, grown), True
        return HipscEngine.repad_state(state, grown), True

    @staticmethod
    def _host_info(info: torch.Tensor) -> StepInfo:
        return _probes_from_host(info.tolist())

    def _eval_with_growth(self, fn, state: CellState):
        """``fn(state)`` (a rollout returning ``(result, max probes)``),
        growing the shared config and re-padding the state on any tripped
        overflow probe and running the whole rollout again: one copy of the
        retry policy shared by ``fit``, ``fit_es`` and ``evaluate``. The
        engine's ``_grown_cfg`` raises when the ids run out. Returns
        ``(result, state)``."""
        for _attempt in range(8):
            result, info = fn(state)
            state, grew = self._grow(state, self._host_info(info))
            if not grew:
                return result, state
        raise RuntimeError("capacity growth failed to converge")

    def _reconcile(self, state: CellState) -> CellState:
        """Make the engine config and the state's shapes agree in BOTH
        directions: a state from a grown run widens the config (capacity and
        bond width adopted), and a config grown past the state re-pads the
        state."""
        eng = self.engine
        cfg = eng.cfg
        cap = int(state.alive.shape[-1])
        bond_k = int(state.bonds.partners.shape[-1])
        if cap > cfg.capacity or bond_k > cfg.bond_cap:
            cfg = dataclasses.replace(cfg, capacity=max(cap, cfg.capacity),
                                      bond_cap=max(bond_k, cfg.bond_cap))
            eng.cfg = cfg
        if cfg.capacity != cap or cfg.bond_cap != bond_k:
            if state.alive.dim() == 2:
                state = EnsembleEngine.repad_states(state, cfg)
            else:
                state = HipscEngine.repad_state(state, cfg)
        return state

    def prepare(self, state: CellState) -> CellState:
        """Growth preflight: run the horizon once through ``safe_step`` (the
        ensemble's for a stacked state) with the engine's nominal
        parameters, so that the shared config settles before the fit's
        rollouts (mid-fit growth still works)."""
        state = self._reconcile(state)
        probe = state
        stepper = self._ensemble() if state.alive.dim() == 2 else self.engine
        for _ in range(self.horizon):
            probe, _ = stepper.safe_step(probe)
        # the probe may have committed capacity OR bond-cap growth
        return self._reconcile(state)

    def _optimizer(self, theta: torch.Tensor, optimizer, learning_rate: float):
        if optimizer is None:
            return torch.optim.Adam([theta], lr=learning_rate)
        return optimizer([theta])

    # -- gradient fitting -------------------------------------------------------

    def fit(self, state: CellState, iters: int = 40,
            optimizer=None, learning_rate: float = 0.05,
            log_every: int = 0) -> FitResult:
        """Gradient descent through the rollout (reverse-mode autograd).

        Every name must be in :data:`DIFFERENTIABLE` — the Bernoulli fate
        probabilities have zero pathwise gradient and would silently not
        move; fit those with :meth:`fit_es`. ``optimizer`` is a factory of
        a ``torch.optim`` optimiser from the parameter list (default
        ``torch.optim.Adam`` at ``learning_rate``). ``log_every=k`` prints
        iteration, loss and current params to stderr every k iterations.
        """
        flat = sorted(set(self.names) - DIFFERENTIABLE)
        if flat:
            raise ValueError(
                f"zero pathwise gradient for {flat} (discrete-event "
                "parameters) — use fit_es for these"
            )
        if iters < 1:
            raise ValueError("iters must be >= 1")
        state = self.prepare(state)
        theta = self.theta0().requires_grad_(True)
        opt = self._optimizer(theta, optimizer, learning_rate)
        history: List[float] = []
        best = (float("inf"), theta.detach().clone())
        n_evals = 0
        for it in range(iters):
            ((loss, _), grad), state = self._eval_with_growth(
                lambda st: self._vg_with_probes(theta, st), state)
            n_evals += 1
            history.append(float(loss))
            if history[-1] < best[0]:
                best = (history[-1], theta.detach().clone())
            theta.grad = grad
            opt.step()
            if log_every and (it + 1) % log_every == 0:
                print(f"calibrate.fit iter {it + 1}/{iters} "
                      f"loss {history[-1]:.6g} best {best[0]:.6g} "
                      f"params {self.params(theta)}",
                      file=sys.stderr, flush=True)
        return FitResult(self.params(best[1]), best[1].numpy().copy(), history, n_evals)

    def _vg_with_probes(self, theta: torch.Tensor, state: CellState):
        """``_value_and_grad`` under the gradient config, shaped for
        ``_eval_with_growth``: ``(((loss, probes), grad), probes)``."""
        result = self._value_and_grad(theta, state, self._grad_cfg(self.engine.cfg))
        return result, result[0][1]

    # -- evolution-strategy fitting ---------------------------------------------

    def fit_es(self, state: CellState, iters: int = 30, popsize: int = 16,
               sigma: float = 0.1, optimizer=None,
               learning_rate: float = 0.05, seed: int = 0,
               log_every: int = 0) -> FitResult:
        """Antithetic evolution strategies (OpenAI-ES) with rank shaping.

        The population of ``popsize`` perturbed parameter vectors rolls out
        as one ensemble sweep from the SAME initial states and RNG streams
        (common random numbers), so fitness differences isolate the
        parameter effect. The perturbations are ``jax.random.normal`` draws
        from ``jax.random.split`` of ``PRNGKey(seed)`` (``ops.rng``), as in
        the JAX calibrator. Works for every :data:`SEARCHABLE` name,
        including the discrete-event probabilities gradients cannot see.
        """
        if popsize < 2 or popsize % 2:
            raise ValueError("popsize must be even and >= 2 (antithetic)")
        if iters < 1:
            raise ValueError("iters must be >= 1")
        state = self.prepare(state)
        theta = self.theta0().requires_grad_(True)
        opt = self._optimizer(theta, optimizer, learning_rate)
        key = rng.prng_key(seed)
        half = popsize // 2
        history: List[float] = []
        best = (float("inf"), theta.detach().clone())
        n_evals = 0
        for it in range(iters):
            key, sub = rng.split(key, 2)
            eps = rng.random_normal(sub, (half, len(self.names)))
            eps = torch.cat([eps, -eps], dim=0)
            cands = theta.detach()[None, :] + sigma * eps
            losses, state = self._eval_with_growth(
                lambda st: self._population(cands, st), state)
            n_evals += popsize
            losses = losses.cpu().numpy().astype(np.float64)
            history.append(float(losses.mean()))
            if history[-1] < best[0]:
                best = (history[-1], theta.detach().clone())
            # centered-rank shaping (robust to loss scale/outliers)
            ranks = np.empty(popsize)
            ranks[np.argsort(losses)] = np.arange(popsize)
            shaped = ranks / (popsize - 1) - 0.5  # ascending with loss
            theta.grad = torch.tensor(
                (shaped[:, None] * eps.numpy()).sum(0) / (half * sigma), dtype=torch.float32)
            opt.step()
            if log_every and (it + 1) % log_every == 0:
                print(f"calibrate.fit_es iter {it + 1}/{iters} "
                      f"mean-loss {history[-1]:.6g} "
                      f"params {self.params(theta)}",
                      file=sys.stderr, flush=True)
        # the loop only ever measured PERTURBED populations (a proxy);
        # evaluate the final and proxy-best iterates unperturbed and return
        # the verified winner (appended to the history)
        finalists = [theta.detach().clone(), best[1]]
        final_losses, state = self._eval_with_growth(
            lambda st: self._population(torch.stack(finalists), st), state)
        n_evals += 2
        final_losses = final_losses.cpu().numpy().astype(np.float64)
        pick = int(np.argmin(final_losses))
        history.append(float(final_losses[pick]))
        chosen = finalists[pick]
        return FitResult(self.params(chosen), chosen.numpy().copy(), history, n_evals)
