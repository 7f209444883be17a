"""The id-list contact substep (B6) of two checkouts on the same state, bit
for bit.

    python hipsc_abm_tpu_torch/tools/contact_ab.py dump ROOT OUT.npz [--dims 2|3]
    python hipsc_abm_tpu_torch/tools/contact_ab.py compare A.npz B.npz

``dump`` imports ``hipsc_abm_tpu_torch`` and ``chip_smoke`` from the
checkout at ROOT, builds the main path's state there (``chip_smoke``'s 3D
99k spheroid or 2D 100k bench colony after ``init_state(seed=0)`` and one
``safe_step``, on the card), runs ``contact_substep_cuda`` once on the
physics scan's first substep inputs, and saves inputs and outputs. Run it
from two checkouts (for example a change and its parent, unpacked with
``git archive``), then ``compare``: the inputs must be equal (the earlier
steps ran the same kernels), and the forces, degrees and partner lists are
compared element for element.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def dump(root: str, out: str, dims: int) -> None:
    sys.path.insert(0, root)
    import torch

    import chip_smoke
    from hipsc_abm_tpu_torch.ops import contact
    from hipsc_abm_tpu_torch.ops import neighbors as nbr
    from hipsc_abm_tpu_torch.ops.jkr import pack_physics

    if not torch.cuda.is_available():
        raise SystemExit("contact_ab dump: no CUDA device")
    n = chip_smoke.N_MAIN_3D if dims == 3 else chip_smoke.N_MAIN
    eng, state = chip_smoke.engine_for(dims, n, "cuda", "id_list")
    state, _ = eng.safe_step(state)
    cfg, bio, a, alive = eng.cfg, eng.bio, state.arrays, state.alive
    grid = nbr.build_grid(cfg.jkr_spec, a["locations"], a["ids"], alive)
    o = grid.order
    args = (pack_physics(a["locations"][o], a["radii"][o]), a["ids"][o].contiguous(),
            alive[o].contiguous(), nbr.run_bounds(cfg.jkr_spec, grid.sorted_flat),
            state.bonds.ids()[o].contiguous())
    force, degree, partners = contact.contact_substep_cuda(
        *args, radius=bio.jkr_radius, adhesion_const=bio.adhesion_const,
        poisson=bio.poisson, youngs=bio.youngs, break_d=bio.jkr_break_d,
        uniform_radius=cfg.uniform_radius)
    torch.cuda.synchronize()
    np.savez(out, **{f"in{i}": t.cpu().numpy() for i, t in enumerate(args)},
             force=force.cpu().numpy(), degree=degree.cpu().numpy(),
             partners=partners.cpu().numpy())
    print(f"contact_ab dump: {root} {dims}D rows={args[0].shape[0]} K={args[4].shape[1]} "
          f"-> {out}")


def compare(a_path: str, b_path: str) -> bool:
    a, b = np.load(a_path), np.load(b_path)
    inputs = all(np.array_equal(a[f"in{i}"], b[f"in{i}"]) for i in range(5))
    force = np.array_equal(a["force"].view(np.int32), b["force"].view(np.int32))
    degree = np.array_equal(a["degree"], b["degree"])
    partners = np.array_equal(a["partners"], b["partners"])
    rows = int((a["partners"] != b["partners"]).any(axis=1).sum()) if not partners else 0
    df = float(np.abs(a["force"] - b["force"]).max())
    print(f"contact_ab compare: inputs equal {inputs}, forces bit-equal {force} "
          f"(max |dF| {df:.3e} N), degrees equal {degree}, partner lists equal {partners} "
          f"({rows} rows differ)")
    return inputs and force and degree and partners


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("dump")
    d.add_argument("root")
    d.add_argument("out")
    d.add_argument("--dims", type=int, choices=(2, 3), default=3)
    c = sub.add_parser("compare")
    c.add_argument("a")
    c.add_argument("b")
    args = p.parse_args(argv)
    if args.cmd == "dump":
        dump(args.root, args.out, args.dims)
        return 0
    return 0 if compare(args.a, args.b) else 1


if __name__ == "__main__":
    sys.exit(main())
