"""Calibration demo: recover biophysical parameters from colony statistics
(port of ``examples/calibrate.py``).

Two workflows the reference framework cannot express at all:

1. GRADIENT calibration: reverse-mode autograd straight through a
   multi-step rollout recovers the JKR adhesion constant from a single
   colony-compaction statistic (radius of gyration).
2. EVOLUTION-STRATEGY calibration: a population search, on the card one
   captured ensemble of candidates per generation, recovers a Bernoulli
   fate probability, whose pathwise gradient is zero, from the GATA6-high
   fraction.

Run:  python -m hipsc_abm_tpu_torch.examples.calibrate [--device cpu]
      [--cells N] [--horizon H] [--iters K] [--es-iters K] [--popsize P]
(the defaults are those of the JAX package's example: 400 + 40 cells in a
500 um box, horizon 5, 30 gradient and 15 ES iterations, population 16.)
"""

import argparse
import dataclasses

from hipsc_abm_tpu_torch.calibrate import (
    Calibrator,
    gata6_high_fraction,
    radius_of_gyration,
    squared_error,
)
from hipsc_abm_tpu_torch.engine import HipscEngine
from hipsc_abm_tpu_torch.params import ExperimentalParams, GeneralParams


def make_engine(cells: int, device: str, **kw):
    """The example's colony: ``cells`` + ``cells // 10`` GATA6-high cells
    at the example's density (400 + 40 in a 500 um box)."""
    side = 500.0 * (cells / 400) ** 0.5
    gen = GeneralParams(num_to_start=cells, end_step=8, size=(side, side, 0.0))
    xp = ExperimentalParams(num_gata6=cells // 10, dox_step=1)
    return HipscEngine(gen, xp, device=device, **kw)


def synthetic_observation(statistic, steps, cells, device, **bio_overrides):
    """Pretend lab data: run the model at 'true' parameters and measure."""
    flags = {k: v for k, v in bio_overrides.items() if k == "enable_stochastic"}
    eng = make_engine(cells, device, **flags)
    eng.bio = dataclasses.replace(
        eng.bio, **{k: v for k, v in bio_overrides.items() if k != "enable_stochastic"})
    state = eng.init_state(seed=7)
    for _ in range(steps):
        state, _ = eng.safe_step(state)
    return float(statistic(state))


def main(device="cuda", cells=400, horizon=5, iters=30, es_iters=15, popsize=16):
    """Both fits; returns their ``FitResult``s as ``{"gradient", "es"}``."""
    # ---- 1. gradient calibration of the adhesion constant -----------------
    true_adhesion = 2.5e-4  # vs the reference default 1.07e-4
    observed_rog = synthetic_observation(
        radius_of_gyration, horizon, cells, device, adhesion_const=true_adhesion)
    print(f"observed radius of gyration: {observed_rog:.2f} um "
          f"(true adhesion_const = {true_adhesion:.3e})")

    eng = make_engine(cells, device)
    cal = Calibrator(eng, ["adhesion_const"],
                     squared_error(radius_of_gyration, observed_rog), horizon=horizon)
    res = cal.fit(eng.init_state(seed=7), iters=iters, learning_rate=0.15)
    print(f"gradient fit: loss {res.loss_history[0]:.3e} -> "
          f"{res.best_loss:.3e} (best) in {res.n_evaluations} rollouts")
    print(f"  recovered adhesion_const = {res.params['adhesion_const']:.3e}\n")

    # ---- 2. ES calibration of a discrete fate probability ------------------
    true_prob = 0.25
    observed_frac = synthetic_observation(
        gata6_high_fraction, horizon, cells, device, GATA6_prob=true_prob,
        enable_stochastic=True)
    print(f"observed GATA6-high fraction: {observed_frac:.3f} "
          f"(true GATA6_prob = {true_prob})")

    eng2 = make_engine(cells, device, enable_stochastic=True)
    cal2 = Calibrator(eng2, ["GATA6_prob"],
                      squared_error(gata6_high_fraction, observed_frac), horizon=horizon)
    res2 = cal2.fit_es(eng2.init_state(seed=7), iters=es_iters, popsize=popsize,
                       sigma=0.25, learning_rate=0.25, seed=0)
    print(f"ES fit: mean population loss {res2.loss_history[0]:.3e} -> "
          f"{res2.loss_history[-1]:.3e} in {res2.n_evaluations} rollouts")
    print(f"  recovered GATA6_prob = {res2.params['GATA6_prob']:.3f}")
    return {"gradient": res, "es": res2}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--cells", type=int, default=400)
    parser.add_argument("--horizon", type=int, default=5)
    parser.add_argument("--iters", type=int, default=30)
    parser.add_argument("--es-iters", type=int, default=15)
    parser.add_argument("--popsize", type=int, default=16)
    args = parser.parse_args()
    main(args.device, args.cells, args.horizon, args.iters, args.es_iters, args.popsize)
