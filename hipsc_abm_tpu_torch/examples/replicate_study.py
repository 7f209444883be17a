"""Replicate study: R colonies, one ensemble, mean +/- sd time courses
(port of ``examples/replicate_study.py``).

The standard way ABM results are reported is an ensemble of stochastic
replicates with per-step summary statistics. Here the whole study is ONE
``EnsembleEngine`` run (on the card one CUDA graph of R branches per step,
every replicate bit-identical to the same seed run solo) and the summary
lands in a single CSV:

    step, n_mean, n_sd, rog_mean, rog_sd, gata6_frac_mean, gata6_frac_sd

Run:  python -m hipsc_abm_tpu_torch.examples.replicate_study [R] [--device cpu]
"""

import argparse
import csv

import torch

from hipsc_abm_tpu_torch.calibrate import gata6_high_fraction, radius_of_gyration
from hipsc_abm_tpu_torch.engine import HipscEngine
from hipsc_abm_tpu_torch.params import ExperimentalParams, GeneralParams
from hipsc_abm_tpu_torch.parallel.ensemble import EnsembleEngine


def colony_stats(states):
    """(R,) per-replicate population, radius of gyration and GATA6-high
    fraction of the stacked state, on its device."""
    reps = [EnsembleEngine.replicate(states, i) for i in range(states.alive.shape[0])]
    n = states.alive.sum(dim=1)
    rog = torch.stack([radius_of_gyration(s) for s in reps])
    frac = torch.stack([gata6_high_fraction(s) for s in reps])
    return n, rog, frac


def main(R=8, steps=12, out_path="replicate_study.csv", device="cuda"):
    gen = GeneralParams(num_to_start=500, end_step=steps,
                        size=(650.0, 650.0, 0.0))
    xp = ExperimentalParams(num_gata6=50, dox_step=2)
    ens = EnsembleEngine(HipscEngine(gen, xp, device=device))
    states = ens.init_states(seeds=range(R))

    rows = []
    for step in range(1, steps + 1):
        states, infos = ens.safe_step(states)
        n, rog, frac = colony_stats(states)
        row = [step]
        for v in (n.to(torch.float32), rog, frac):
            row += [float(v.mean()), float(v.std(correction=0))]
        rows.append(row)
        print(f"step {step}: {row[1]:.1f}±{row[2]:.1f} cells, "
              f"RoG {row[3]:.1f}±{row[4]:.2f} um, "
              f"GATA6-high {row[5]:.3f}±{row[6]:.3f}", flush=True)

    with open(out_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["step", "n_mean", "n_sd", "rog_mean", "rog_sd",
                    "gata6_frac_mean", "gata6_frac_sd"])
        w.writerows(rows)
    print(f"wrote {out_path} ({R} replicates x {steps} steps)")
    return rows


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("replicates", nargs="?", type=int, default=8)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    main(args.replicates, device=args.device)
