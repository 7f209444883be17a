"""The lower-precision control of a cell: the plain reference with the
contact substeps' positions held in bfloat16, put in the program's place
and compared with the reference as the program's output is
(``check.compare``), on the colonies a run of the cell compares, over the
episode's first stretch (from the seeded colony)::

    python3 -m portbench.control --workload <cell> --seeds <n> [<n> ...] [--device cpu]

It prints one line per seed with the numbers compared, and exits with 1
when the comparison would take the control for correct (it has to fail).
The benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import catalog, check
from portbench.colony import colony as make_colony


def readings(workload: str, seed: int, device: str) -> dict:
    """The worst numbers of the control over the cell's compared colonies
    for ``seed``."""
    cell = catalog.cell(workload)
    config = catalog.load_json("configs", cell["config"])
    traffic = catalog.load_json("traffic", cell["traffic"])
    entry = catalog.load_module("entries", traffic["entry"])
    out = []
    for s in entry.compared_seeds(traffic, seed):
        col = make_colony(config, traffic, s)
        case = check.Case(s, None, 1, {})
        exact, _ = check.reference_output(col, case, device)
        lower, _ = check.reference_output(col, case, device, stored=torch.bfloat16)
        out.append(check.compare(lower, exact))
    return check.worst(out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    refused = True
    for seed in args.seeds:
        t = time.perf_counter()
        numbers = readings(args.workload, seed, args.device)
        ok = check.is_correct(dict(numbers, calls_unlike_first=0))
        refused &= not ok
        print(json.dumps({"workload": args.workload, "seed": seed, "control_correct": ok,
                          "seconds": time.perf_counter() - t, "numbers": numbers}), flush=True)
    return 0 if refused else 1


if __name__ == "__main__":
    sys.exit(main())
