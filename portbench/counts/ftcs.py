"""The work of one step's FTCS diffusion call (B5,
``ftcs_diffuse_kernel``): one cooperative launch of every subcycle.

Of a lattice of P points and S subcycles (``step_dt / diffuse_dt`` full
ones and the remainder): bytes 8 P (the lattice read once and written
once); operations 7 S P (the four neighbours' sum, its product and the
fused update of each point per subcycle) + 3 P (the clamp and the
degradation). Colonies without a lattice do no FTCS work.

This replaces ``chip_smoke.py``'s FTCS entry of ``bound``; the counts
there were the same shapes, taken at the lattice and the subcycles.
"""

from __future__ import annotations

KERNELS = ("ftcs_diffuse_kernel",)


def per_step(colony: dict, model) -> tuple:
    """``(bytes, operations)`` of one step's FTCS call of a colony
    (``entries.engine_blocks.colony_view``) of ``model`` (an entry: its
    ``bio`` and ``diff``), (0, 0) without a lattice."""
    if colony["lattice"] is None or model.diff is None:
        return 0, 0
    nx, ny = colony["lattice"]
    points = nx * ny
    # the remainder subcycle runs even when it is 0
    subcycles = int(model.bio.step_dt // model.diff.diffuse_dt) + 1
    return 8 * points, 7 * subcycles * points + 3 * points
