"""The roofline counts (``counts/``) read only the colony's own state: the
same for a state and that state re-padded to a larger capacity and bond
cap (``HipscEngine.repad_state``), and for the same colony stepped on
either contact path; and the pair count against a direct count.

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from portbench import catalog
from portbench.colony import colony
from portbench.pairs import ordered_pairs_within
from portbench.tests.conftest import SPHEROID, SPHEROID_TRAFFIC, small_traffic

entries = catalog.load_module("entries", "engine_blocks")
FAMILIES = ("contact", "bio_moments", "ftcs")
SEED = 12345


def stepped(config: str, variant: str, path: str, steps: int = 2):
    if config == "spheroid3d":
        config, traffic = SPHEROID, SPHEROID_TRAFFIC
    else:
        config, traffic = (catalog.load_json("configs", config),
                           small_traffic("uniform_500k_idlist_k5"))
    traffic = dict(traffic, variant=variant, contact_path=path)
    col = colony(config, traffic, SEED)
    entry = entries.Entry(col, traffic, SEED, "cpu")
    state = entries.initial_state(entry.eng, col, SEED)
    for _ in range(steps):
        state, _ = entry.eng.safe_step(state)
    return entry, state


def counts_of(entry, state) -> dict:
    view = entries.colony_view(state)
    return {f: catalog.load_module("counts", f).per_step(view, entry) for f in FAMILIES}


@pytest.mark.parametrize("config,variant", [("hipsc2d", "uniform"), ("spheroid3d", "general")])
def test_counts_do_not_move_with_padding(config, variant):
    entry, state = stepped(config, variant, "id_list")
    cfg = entry.eng.cfg
    grown = dataclasses.replace(cfg, capacity=cfg.capacity * 2 + 256, bond_cap=cfg.bond_cap * 3)
    padded = entry.eng.repad_state(state, grown)
    assert padded.capacity > state.capacity
    before = counts_of(entry, state)
    assert before["contact"][1] > 0 and before["bio_moments"][1] > 0
    assert counts_of(entry, padded) == before


def test_counts_agree_on_both_contact_paths():
    a_entry, a = stepped("spheroid3d", "uniform", "id_list")
    b_entry, b = stepped("spheroid3d", "uniform", "span_mask")
    assert counts_of(a_entry, a) == counts_of(b_entry, b)


@pytest.mark.parametrize("dims", (2, 3))
def test_pair_count_equals_a_direct_count(dims):
    g = torch.Generator().manual_seed(dims)
    loc = torch.rand((400, 3), generator=g, dtype=torch.float32) * 60.0
    alive = torch.rand(400, generator=g) < 0.8
    live = loc[alive][:, :dims].double()
    d2 = ((live[:, None, :] - live[None, :, :]) ** 2).sum(-1)
    direct = int((d2 <= 100.0).sum()) - live.shape[0]
    assert ordered_pairs_within(loc, alive, 10.0, dims) == direct
