"""The work of one step's contact substeps, whichever path runs them (the
id-list path's B6, ``contact_substep_kernel``; the span-mask path's B2
seed, B1 masked substep and B3 compaction, ``contact_mask_kernel`` and
``mask_compact_kernel``).

Per substep, of n live agents holding m bonds (ordered pairs) with p
ordered pairs within the contact search radius (``2 max_radius``):
bytes read and written once, 37 n (position and radius 16, id 4, alive 1,
force 12, degree 4) + 8 m (the partner ids read and written); operations
8 p (a squared distance and its test per pair within reach) + 20 m on the
uniform pair law, 81 m on the general law (the reduced radius, glibc's
``powf`` cube root in float64 counted at twice the float32 cost, the
overlap's division). Times the step's 11 substeps, on the state at the
block's start.

This replaces ``chip_smoke.py``'s ``contact_flops`` and the contact
entries of its ``bound``: those count a distance per candidate of the
port's bins (whose width holds the Verlet skin) and bytes over the
capacity C, the bond cap K and the mask words W, so a change of padding,
bins or skin moved the bound itself; here only the colony's own state
counts.
"""

from __future__ import annotations

import torch

from portbench.pairs import ordered_pairs_within

KERNELS = ("contact_substep_kernel", "contact_mask_kernel", "mask_compact_kernel")
SUBSTEPS = 11
DIST_OPS, UNIFORM_PAIR_OPS, GENERAL_PAIR_OPS = 8, 20, 81


def per_step(colony: dict, model) -> tuple:
    """``(bytes, operations)`` of one step's contact substeps of a colony
    (``entries.engine_blocks.colony_view``) of ``model`` (an entry: its
    ``bio`` and ``two_d``)."""
    bio, two_d = model.bio, model.two_d
    alive = colony["alive"]
    n = int(alive.sum())
    m = int(colony["bond_mask"].sum())
    p = ordered_pairs_within(colony["locations"], alive, bio.jkr_radius, 2 if two_d else 3)
    radii = colony["radii"][alive]
    uniform = n == 0 or bool(torch.all(radii == radii[0]))
    pair_ops = UNIFORM_PAIR_OPS if uniform else GENERAL_PAIR_OPS
    return SUBSTEPS * (37 * n + 8 * m), SUBSTEPS * (DIST_OPS * p + pair_ops * m)
