"""3D spheroid: the hiPSC model in a 3D box, driven through the engine API
(port of ``examples/spheroid_3d.py``).

The complete model (radius-15 neighbour search, division and death, the FDS
pathway and differentiation, motility, 11 JKR + Stokes substeps) runs in 3D
(the 9-run stencil kernels), seeded as an over-packed ball that the contact
mechanics relax outward while dox-induced differentiation patterns the core.
The engine is driven directly (state -> state steps, overflow-safe through
``safe_step``), with host output only where it is asked for: orthogonal x-y
and x-z projections of the colony.

Run:  python -m hipsc_abm_tpu_torch.examples.spheroid_3d [--device cpu]
"""

import argparse
import os

import numpy as np

from hipsc_abm_tpu_torch.colonies import SPHEROID_BOX, SPHEROID_RADIUS, seed_ball
from hipsc_abm_tpu_torch.engine import HipscEngine
from hipsc_abm_tpu_torch.params import ExperimentalParams, GeneralParams
from hipsc_abm_tpu_torch.utils.io import hipsc_cell_colors, render_step_image, save_image_png

BOX = SPHEROID_BOX  # um, cubic


def run(n_cells: int = 3000, n_gata6: int = 300, steps: int = 12,
        out_dir: str | None = None, seed: int = 0, device="cuda"):
    """Run the 3D spheroid on ``device``; returns (engine, final state,
    stats dict)."""
    gen = GeneralParams(num_to_start=n_cells, end_step=steps, size=(BOX, BOX, BOX))
    xp = ExperimentalParams(num_gata6=n_gata6, dox_step=2, guye_move=False)
    eng = HipscEngine(gen, xp, device=device)
    ball = seed_ball(n_cells + n_gata6, np.random.default_rng(seed), BOX, SPHEROID_RADIUS)
    state = eng.init_state(seed=seed, locations=ball)

    for _ in range(steps):
        state, info = eng.safe_step(state)

    host = {k: v.cpu().numpy() for k, v in state.arrays.items()}
    alive = state.alive.cpu().numpy()
    loc = host["locations"][alive]
    centered = loc - BOX / 2.0
    stats = {
        "population": int(alive.sum()),
        "differentiated": int(host["states"][alive].sum()),
        "mean_radius_um": float(np.linalg.norm(centered, axis=1).mean()),
        "z_extent_um": float(np.abs(centered[:, 2]).max()),
    }

    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        colors = hipsc_cell_colors(host["states"][alive], host["GATA6"][alive],
                                   host["NANOG"][alive], field=2, color_mode=True)
        radii = host["radii"][alive]
        for name, cols in (("xy", (0, 1)), ("xz", (0, 2))):
            proj = loc[:, [cols[0], cols[1]]]
            img = render_step_image(proj, radii, colors, (BOX, BOX, 0.0), image_quality=800)
            save_image_png(os.path.join(out_dir, f"spheroid_{name}.png"), img)
    return eng, state, stats


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "outputs", "spheroid_3d")
    _, _, stats = run(out_dir=out, device=args.device)
    print("3D spheroid after 12 steps:", stats)
    print(f"projections written to {out}/spheroid_{{xy,xz}}.png")
