"""The colonies that the tools, the examples and ``chip_smoke.py`` share, and
the comparison that holds two runs of a colony equal by agent id.

- ``bench_params``: the bench colony, a 2D box at the reference colony
  density;
- ``seed_ball`` and ``spheroid``: the 3D spheroid example's over-packed
  seeding ball, and its configuration scaled to a number of cells;
- ``by_id``, ``bond_rows_apart`` and ``assert_same``: two flat numpy states
  (``convert.state_to_numpy``) by agent id.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from hipsc_abm_tpu_torch.params import DiffusionParams, ExperimentalParams, GeneralParams

# the 3D spheroid example: 3,000 + 300 cells in a cubic box, seeded as a ball
# over-packed so that JKR relaxes it outward
SPHEROID_BOX = 600.0  # um
SPHEROID_RADIUS = 110.0  # um
SPHEROID_CELLS = 3300


def bench_params(n_cells: int):
    """``(gen, xp, diff)`` of the bench colony: a 2D box at reference colony
    density (side = 2000 * sqrt(n / 5000) um), n/10 GATA6-high cells, dox at
    step 5, FGF4 secretion and FTCS diffusion."""
    side = 2000.0 * (n_cells / 5000.0) ** 0.5
    gen = GeneralParams(num_to_start=n_cells, end_step=200, size=(side, side, 0.0))
    xp = ExperimentalParams(num_gata6=n_cells // 10, dox_step=5)
    diff = DiffusionParams(spat_res=20.0, diffuse_dt=6.0, diffuse_const=2.0,
                           max_concentration=2.0, degradation=0.1, release_amount=0.01)
    return gen, xp, diff


def seed_ball(n: int, rng: np.random.Generator, box: float, radius: float) -> np.ndarray:
    """(n, 3) float32: n uniform points inside a ball of ``radius`` at the
    centre of a cubic box of side ``box``."""
    direction = rng.normal(size=(n, 3))
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    r = radius * rng.random(n) ** (1.0 / 3.0)
    return (box / 2.0 + direction * r[:, None]).astype(np.float32)


def spheroid(n_cells: int, seed: int):
    """``(gen, xp, ball)``: the 3D spheroid example's configuration at
    ``n_cells`` (10:1 with GATA6-high cells, dox at step 2, guye_move off),
    its box and ball scaled by s = (n_cells / 3300)^(1/3), the ball drawn
    from ``default_rng(seed)``."""
    s = (n_cells / SPHEROID_CELLS) ** (1.0 / 3.0)
    box = SPHEROID_BOX * s
    n_gata6 = n_cells // 11
    gen = GeneralParams(num_to_start=n_cells - n_gata6, end_step=200, size=(box, box, box))
    xp = ExperimentalParams(num_gata6=n_gata6, dox_step=2, guye_move=False)
    ball = seed_ball(n_cells, np.random.default_rng(seed), box, SPHEROID_RADIUS * s)
    return gen, xp, ball


def by_id(d: dict) -> dict:
    """{field: values} of the alive agents of a flat numpy state in id
    order, with ``bonds``: each agent's partner ids in ascending order after
    its -1s (one row per agent)."""
    alive = d["alive"]
    order = np.argsort(d["arrays"]["ids"][alive])
    out = {k: v[alive][order] for k, v in d["arrays"].items()}
    out["bonds"] = np.sort(np.where(d["bond_mask"], d["partners"], -1)[alive][order], axis=1)
    return out


def bond_rows_apart(x: np.ndarray, y: np.ndarray) -> int:
    """The number of agents whose bond sets differ, between two ``by_id``
    bond rows of the same agents, whatever the two bond widths."""
    K = max(x.shape[1], y.shape[1])

    def pad(z):
        return np.concatenate([np.full((z.shape[0], K - z.shape[1]), -1, z.dtype), z], axis=1)

    return int((pad(x) != pad(y)).any(axis=1).sum())


def _bits(x: np.ndarray) -> np.ndarray:
    return x.view(np.int32) if x.dtype == np.float32 else x


def assert_same(a: dict, b: dict, label: str, lattice_atol: Optional[float] = None,
                fields: Optional[Sequence[str]] = None) -> str:
    """Two flat numpy states by agent id: the id sets equal, each of
    ``fields`` (every array field unless given) and the bond sets
    bit-equal; the lattices bit-equal, or within ``lattice_atol``. Raises
    naming what differs, or returns a summary."""
    ia, ib = by_id(a), by_id(b)
    if not np.array_equal(ia["ids"], ib["ids"]):
        raise AssertionError(f"{label}: agent id sets differ")
    compared = fields or [k for k in ia if k != "bonds"]
    differ = [k for k in compared if not np.array_equal(_bits(ia[k]), _bits(ib[k]))]
    if bond_rows_apart(ia["bonds"], ib["bonds"]):
        differ.append("bonds")
    lattice = []
    for g in a["gradients"]:
        x, y = a["gradients"][g], b["gradients"][g]
        if lattice_atol is None:
            apart = int((_bits(x) != _bits(y)).sum())
            if apart:
                differ.append(f"lattice {g} ({apart} points)")
            lattice.append(f"lattice {g} bit-equal")
        else:
            err = float(np.abs(x - y).max())
            if not err <= lattice_atol:
                differ.append(f"lattice {g} (max|d| {err})")
            lattice.append(f"lattice {g} max|d|={err:.3e}")
    if differ:
        raise AssertionError(f"{label}: {differ} differ")
    return ", ".join([f"{len(ia['ids'])} agents, {'the listed' if fields else 'all'} fields "
                      "and bond sets bit-equal by id"] + lattice)
