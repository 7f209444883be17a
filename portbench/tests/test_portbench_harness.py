"""The harness on the CPU: every part loads by name, a new cell and a new
metric are found as new files alone, the command refuses to run without a
card, nothing of JAX or the JAX package is loaded, and a run whose timed
path is broken underneath comes out not correct.

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import catalog, check, run

REPO = Path(__file__).resolve().parents[2]
SEED = 2**31 + 5


def test_every_part_loads_by_name():
    bench = catalog.bench()
    for w in bench["workloads"]:
        assert catalog.cell(w["name"]) == w
        catalog.load_json("configs", w["config"])
        traffic = catalog.load_json("traffic", w["traffic"])
        assert hasattr(catalog.load_module("entries", traffic["entry"]), "Entry")
        for kind in ("end_to_end", "per_layer"):
            assert catalog.metrics_of(w["name"], kind)
    assert {c["name"] for c in bench["configs"]} == set(catalog.names("configs"))
    assert {w["traffic"] for w in bench["workloads"]} == set(catalog.names("traffic"))
    named = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]}
    assert named == set(catalog.names("metrics"))
    for name in named:
        assert callable(catalog.load_module("metrics", name).read)
    for family in catalog.names("counts"):
        c = catalog.load_module("counts", family)
        assert c.KERNELS and callable(c.per_step)


def test_a_new_cell_and_metric_need_no_edit(small_root):
    """A later cell and metric: a traffic file, a reader and their entries in
    ``BENCHMARK.json``, which every cell and metric has."""
    (small_root / "traffic" / "sheet_tiny.json").write_text(json.dumps(
        {"entry": "engine_blocks", "cells": 150, "variant": "uniform",
         "contact_path": "id_list", "horizon": 10, "block": 5}))
    (small_root / "metrics" / "calls.count.py").write_text(
        'def read(run):\n    return len(run.window.calls)\n')
    path = small_root.parent / "BENCHMARK.json"
    bench = json.loads(path.read_text())
    bench["workloads"].append({"name": "tiny_new", "config": "hipsc2d", "traffic": "sheet_tiny",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "calls.count", "unit": "count", "better": "higher",
                                "bound": 0.01, "source": "host_clock",
                                "workloads": ["tiny_new"]})
    path.write_text(json.dumps(bench))
    result = run.run_cell("tiny_new", SEED, 0.1, False, device="cpu", root=small_root,
                          log=lambda m: None)
    assert result["correct"]
    assert result["metrics"]["calls.count"] == {"value": result["attempted"], "unit": "count"}
    assert result["attempted"] % 2 == 0  # whole episodes of two blocks
    assert "agent_steps_per_s" in result["metrics"]
    other = run.run_cell("c2d_500k_idlist_k5", SEED, 0.1, False, device="cpu",
                         root=small_root, log=lambda m: None)
    assert "calls.count" not in other["metrics"]


def test_command_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    done = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                           "c2d_500k_idlist_k5", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert done.returncode != 0
    assert not done.stdout.strip()


def test_harness_entries_and_metrics_load_no_jax():
    code = ("import sys; from portbench import catalog, run; "
            "[catalog.load_module('entries', n) for n in catalog.names('entries')]; "
            "[catalog.load_module('metrics', n) for n in catalog.names('metrics')]; "
            "[catalog.load_module('counts', n) for n in catalog.names('counts')]; "
            "import hipsc_abm_tpu_torch.engine, hipsc_abm_tpu_torch.parallel.ensemble; "
            "bad = run.forbidden_modules(); print(bad); sys.exit(1 if bad else 0)")
    done = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert done.returncode == 0, done.stdout + done.stderr


def _unchanged(real):
    def step(self, state, *args):
        new, info = real(self, state, *args)
        return state._replace(key=new.key, step=new.step), info
    return step


def _half_left_out(real):
    def step(self, state, *args):
        if state.alive.dim() == 2:  # an ensemble: the second half of the replicates stays
            new, info = real(self, state, *args)
            half = state.alive.shape[0] // 2
            return _splice(new, state, half), info
        keep = state.alive.clone()
        keep[keep.nonzero()[::2, 0]] = False
        return real(self, state._replace(alive=keep), *args)
    return step


def _splice(new, old, half):
    from hipsc_abm_tpu_torch.ops.jkr import BondState

    def cat(a, b):
        return torch.cat([a[:half], b[half:]])
    return new._replace(arrays={k: cat(v, old.arrays[k]) for k, v in new.arrays.items()},
                        alive=cat(new.alive, old.alive),
                        bonds=BondState(cat(new.bonds.partners, old.bonds.partners),
                                        cat(new.bonds.mask, old.bonds.mask)),
                        gradients={k: cat(v, old.gradients[k]) for k, v in new.gradients.items()})


def _altered(real):
    def step(self, state, *args):
        new, info = real(self, state, *args)
        loc = new.arrays["locations"].clone()
        alive = new.alive.reshape(-1, new.alive.shape[-1])
        for r, colony_loc in enumerate(loc.reshape(-1, *loc.shape[-2:])):
            # one answer of each colony (every replicate of an ensemble)
            at = int(alive[r].nonzero()[0, 0])
            colony_loc[at, 0] = torch.nextafter(colony_loc[at, 0], torch.tensor(float("inf")))
        return new._replace(arrays={**new.arrays, "locations": loc}), info
    return step


def _altered_late(real):
    """``_altered`` only in the episode's last compared stretch: the colony
    grown and past doxycycline, which the first stretch never reaches."""
    altered = _altered(real)

    def step(self, state, *args):
        if state.step > check.CHECK_STEPS:
            return altered(self, state, *args)
        return real(self, state, *args)
    return step


@pytest.mark.parametrize("fault", [_unchanged, _half_left_out, _altered, _altered_late])
@pytest.mark.parametrize("cell", ["c2d_500k_idlist_k5", "c2d_ens16x5k"])
def test_a_broken_timed_path_is_not_correct(small_root, monkeypatch, cell, fault):
    from hipsc_abm_tpu_torch.engine import HipscEngine
    from hipsc_abm_tpu_torch.parallel.ensemble import EnsembleEngine

    sound = run.run_cell(cell, SEED, 0.1, False, device="cpu", root=small_root,
                         log=lambda m: None)
    assert sound["correct"], sound["checks"]
    if cell == "c2d_ens16x5k":
        monkeypatch.setattr(EnsembleEngine, "safe_step", fault(EnsembleEngine.safe_step))
    else:
        monkeypatch.setattr(HipscEngine, "run_steps", fault(HipscEngine.run_steps))
    broken = run.run_cell(cell, SEED, 0.1, False, device="cpu", root=small_root,
                          log=lambda m: None)
    assert not broken["correct"], broken["checks"]
