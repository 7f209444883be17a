"""The benchmark's inputs: a configuration file and a traffic file make the
parameters of a seeded colony, and the seed makes its inputs.

Both sides of a comparison build their colony from what this module
returns: the program from ``hipsc_abm_tpu_torch.params``, the plain
reference from ``portbench.reference.params`` (the same dataclasses), so
each makes its own parameter objects from the same plain values.

A configuration (``configs/<name>.json``) states the deployment: the
colony's density rule, its experimental and diffusion constants, and its
variants (sets of the engine's optional-phase switches). A traffic file
(``traffic/<name>.json``) states the size, the contact path, the variant,
the episode (horizon, and the block of a blocks entry) and, for an
ensemble, the replicates.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


class Colony(NamedTuple):
    """One seeded colony's parameters as plain values, and its inputs.

    ``gen``, ``xp``, ``diff`` are keyword arguments of ``GeneralParams``,
    ``ExperimentalParams`` and ``DiffusionParams`` (``diff`` None: no
    diffusion); ``flags`` the engine's optional-phase switches;
    ``locations`` the (n, 3) float32 seeding positions, or None for the
    engine's uniform draw in the box; ``seeded_radii`` whether the radii
    start as growth derives them from the division counters
    (``seed_radii``)."""

    gen: dict
    xp: dict
    diff: Optional[dict]
    flags: dict
    locations: Optional[np.ndarray]
    seeded_radii: bool


def seed_ball(n: int, rng: np.random.Generator, box: float, radius: float) -> np.ndarray:
    """(n, 3) float32: n uniform points inside a ball of ``radius`` at the
    centre of a cubic box of side ``box``."""
    direction = rng.normal(size=(n, 3))
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    r = radius * rng.random(n) ** (1.0 / 3.0)
    return (box / 2.0 + direction * r[:, None]).astype(np.float32)


def colony(config: dict, traffic: dict, seed: int) -> Colony:
    """The colony of ``traffic["cells"]`` agents under ``config`` and the
    variant ``traffic["variant"]``, its inputs drawn from ``seed``.

    ``config["layout"]`` is ``"sheet"``: a 2D box at the template's
    density (side = side_um * sqrt(n / cells)), the agents drawn uniform
    in it by the engine; or ``"ball"``: a cubic box of side box_um *
    (n / cells)^(1/3), the agents seeded in a ball of ball_um times the
    same factor. Every seed's ball is the same set of points (drawn from
    ``ball_seed``), dealt to the agents in an order drawn from ``seed``: the
    widest contact row, which sizes the span-mask path's mask, then does
    not change with the seed, and seeds change which agent sits where and
    every other draw. Of the n agents
    ``n // gata6_every`` are GATA6-high: on a sheet they come on top of the
    n (the bench colony's 10:1), in a ball they are part of it (the
    spheroid example's 10:1)."""
    n = int(traffic["cells"])
    layout = config["layout"]
    gata6 = n // int(config["gata6_every"])
    xp = dict(config["experimental"])
    variant = config["variants"][traffic.get("variant", "uniform")]
    if layout["kind"] == "sheet":
        side = float(layout["side_um"]) * (n / float(layout["cells"])) ** 0.5
        gen = dict(num_to_start=n, size=(side, side, 0.0))
        xp["num_gata6"] = gata6
        locations = None
    elif layout["kind"] == "ball":
        s = (n / float(layout["cells"])) ** (1.0 / 3.0)
        box = float(layout["box_um"]) * s
        gen = dict(num_to_start=n - gata6, size=(box, box, box))
        xp["num_gata6"] = gata6
        ball = seed_ball(n, np.random.default_rng(int(layout["ball_seed"])), box,
                         float(layout["ball_um"]) * s)
        locations = ball[np.random.default_rng(seed).permutation(n)]
    else:
        raise ValueError(f"unknown layout {layout['kind']!r}")
    diff = config.get("diffusion")
    flags = dict(variant.get("flags", {}))
    if diff is not None:
        flags["enable_diffusion"] = True
    return Colony(gen, xp, diff, flags, locations, bool(variant.get("seeded_radii", False)))


def seed_radii(div_counters: np.ndarray, alive: np.ndarray, bio) -> np.ndarray:
    """Radii as the growth rule derives them from the seeded division
    counters of pluripotent cells, ``min_radius + pluri_growth *
    div_counter`` in float32 (one rounding of the product, one of the sum),
    for the alive slots; the others 0."""
    dc = div_counters.astype(np.float32)
    radii = np.float32(bio.min_radius) + np.float32(bio.pluri_growth) * dc
    return np.where(alive, radii, np.float32(0.0)).astype(np.float32)
