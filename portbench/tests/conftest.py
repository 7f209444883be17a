"""Shared fixtures of the benchmark's tests: small copies of the benchmark's
cells, whose traffic files shrink the colony and the episode so that a run
of the harness on the CPU takes seconds, and a 3D spheroid colony that
holds the reference's 3D and general-law paths to the port's."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

from portbench import catalog

# a cell's size for the CPU: cells, and an episode of two compared stretches
SMALL = {"cells": 300, "horizon": 10}
SMALL_ENSEMBLE = {"cells": 200, "replicates": 3}

# a packed 3D spheroid seeded as an over-full ball, 10:1 with GATA6-high
# cells, and its variant with growth, stochastic bumps and diff_surround on
# (radii seeded as growth derives them): the general pair law
SPHEROID = {
    "name": "spheroid3d",
    "layout": {"kind": "ball", "cells": 3300, "box_um": 600.0, "ball_um": 110.0,
               "ball_seed": 0},
    "gata6_every": 11,
    "experimental": {"dox_step": 2, "guye_move": False, "lonely_thresh": 2},
    "variants": {"uniform": {},
                 "general": {"flags": {"enable_growth": True, "enable_stochastic": True,
                                       "enable_diff_surround": True},
                             "seeded_radii": True}},
}
SPHEROID_TRAFFIC = {"entry": "engine_blocks", "cells": 300, "horizon": 10, "block": 5}


def small_traffic(name: str) -> dict:
    traffic = dict(catalog.load_json("traffic", name), **SMALL)
    if traffic["entry"] == "ensemble":
        traffic.update(SMALL_ENSEMBLE)
    return traffic


@pytest.fixture
def small_root(tmp_path: Path) -> Path:
    """A copy of the benchmark's folder and ``BENCHMARK.json`` whose
    traffic files are cut to ``SMALL``."""
    root = tmp_path / "portbench"
    shutil.copytree(catalog.ROOT, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(catalog.ROOT.parent / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for name in catalog.names("traffic"):
        (root / "traffic" / f"{name}.json").write_text(json.dumps(small_traffic(name)))
    return root


@pytest.fixture(autouse=True)
def _few_threads():
    """The shared CPU's thread pool slows the plain versions' small ops."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def card():
    """The card, or a skip where there is none (decided inside the test)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"
