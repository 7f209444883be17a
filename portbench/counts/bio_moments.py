"""The work of one step's radius-15 neighbour-moment passes (B4,
``bio_moments_kernel``): count, pathway and motility, and a fourth
(motility mode) with diff_surround on.

Per pass, of n live agents with q ordered pairs within the neighbour
radius: bytes read and written once, n (17 for the position and alive
flag, plus the inputs the pass reads: the pathway 4, the motility 24) + 4 n
per output lane it needs (count 1, pathway 3, motility 2 + 2 dims);
operations per pair within reach 8 (squared distance and test) plus the
pass's sums (count 1, pathway 4, motility 4 + 4 dims). On the state at the
block's start.

This replaces ``chip_smoke.py``'s ``bio_bound``, which counted the bytes of
the kernel's 16 output lanes over the capacity.
"""

from __future__ import annotations

from portbench.pairs import ordered_pairs_within

KERNELS = ("bio_moments_kernel",)
DIST_OPS = 8


def per_step(colony: dict, model) -> tuple:
    """``(bytes, operations)`` of one step's moment passes of a colony
    (``entries.engine_blocks.colony_view``) of ``model`` (an entry: its
    ``bio``, ``two_d`` and the colony's switches)."""
    bio, two_d = model.bio, model.two_d
    alive = colony["alive"]
    dims = 2 if two_d else 3
    n = int(alive.sum())
    q = ordered_pairs_within(colony["locations"], alive, bio.neighbor_radius, dims)
    passes = [(0, 1, 1), (4, 3, 4), (24, 2 + 2 * dims, 4 + 4 * dims)]
    if model.colony.flags.get("enable_diff_surround"):
        passes.append(passes[-1])
    total_bytes = sum(n * (17 + reads + 4 * lanes) for reads, lanes, _ in passes)
    total_ops = sum(q * (DIST_OPS + sums) for _, _, sums in passes)
    return total_bytes, total_ops
