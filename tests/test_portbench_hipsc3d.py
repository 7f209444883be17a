"""The benchmark's 3D configuration ``hipsc3d`` (``portbench/configs/hipsc3d.json``)
and the program counter its cells read, ``contact.candidates_per_row``.

On the CPU: both 3D cells, cut to 300 agents and a 10-step episode, run
through the harness (``portbench.run.run_cell``) against the plain reference
with every compared number 0; the configuration names every key it changes
from the upstream's templates (``examples/templates``) under ``reduced``,
each with its ``departures`` entry; the counters ``contact.candidates`` and
``contact.live_rows`` equal a direct count of the candidates of each step's
entry window (every live agent within one contact bin on every axis) in 2D
and 3D; with tracing off, or inside an ensemble's replicates, nothing is
tallied; the reader gives nothing where the program has no such counter.

On the card (marked ``cuda``, skipped without one; the file imports no JAX):
a traced ``run_steps(5)`` graph counts what the same block counts run
eagerly; a graph captured with tracing off holds the same nodes whether the
tally's code path is there or not; both 3D cells at ~5k agents run
``correct`` through ``portbench.run``::

    python -m pytest --noconftest -m cuda tests/test_portbench_hipsc3d.py -q
"""

from __future__ import annotations

import json
import shutil
import types
from pathlib import Path

import pytest
import torch

from hipsc_abm_tpu_torch import engine as engine_mod
from hipsc_abm_tpu_torch.ops import neighbors as nbr
from hipsc_abm_tpu_torch.params import ExperimentalParams, GeneralParams
from hipsc_abm_tpu_torch.utils import profiling
from hipsc_abm_tpu_torch.utils.config import read_simple_yaml
from portbench import catalog, run
from portbench.colony import colony

REPO = Path(__file__).resolve().parents[1]
SEED = 2**31 + 2417
CELLS_3D = ["c3d_99k_general_k5", "c3d_99k_spanmask_k5"]
entries = catalog.load_module("entries", "engine_blocks")
reader = catalog.load_module("metrics", "contact.candidates_per_row")


def _cut_root(tmp_path: Path, cells: int, horizon: int = 10) -> Path:
    """A copy of the benchmark's folder and ``BENCHMARK.json`` whose traffic
    files hold ``cells`` agents and episodes of ``horizon`` steps."""
    root = tmp_path / "portbench"
    shutil.copytree(catalog.ROOT, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(catalog.ROOT.parent / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for name in catalog.names("traffic"):
        traffic = dict(catalog.load_json("traffic", name), cells=cells, horizon=horizon)
        (root / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
    return root


@pytest.fixture
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("cell", CELLS_3D)
def test_hipsc3d_cell_is_correct_on_the_cpu(tmp_path, few_threads, cell):
    root = _cut_root(tmp_path, 300)
    result = run.run_cell(cell, SEED, 0.1, True, device="cpu", root=root, log=lambda m: None)
    assert result["correct"], result["checks"]
    for name, number in result["checks"].items():
        assert number["value"] == number["limit"] == 0, name
    assert result["attempted"] % 2 == 0  # whole episodes of two blocks
    candidates = result["metrics"]["contact.candidates_per_row"]
    assert candidates["unit"] == "count" and 27 < candidates["value"] < 300
    assert {name for name, _ in catalog.metrics_of(cell, "end_to_end", root)} == {
        "agent_steps_per_s", "setup_s"}


def _template():
    general = read_simple_yaml((REPO / "examples/templates/general.yaml").read_text())
    experimental = read_simple_yaml((REPO / "examples/templates/experimental.yaml").read_text())
    return GeneralParams.from_dict(general), ExperimentalParams.from_dict(experimental)


def test_hipsc3d_names_every_key_it_changes_from_the_template():
    config = catalog.load_json("configs", "hipsc3d")
    (entry,) = [c for c in catalog.bench()["configs"] if c["name"] == "hipsc3d"]
    assert entry["reduced"] == config["reduced"]
    assert set(config["reduced"]) == set(config["departures"])
    assert all(config["departures"][k].strip() for k in config["reduced"])
    gen0, xp0 = _template()
    for cell in CELLS_3D:
        traffic = catalog.load_json("traffic", catalog.cell(cell)["traffic"])
        col = colony(config, traffic, SEED)
        changed = {k for k, v in col.gen.items() if v != getattr(gen0, k)}
        changed |= {k for k, v in col.xp.items() if v != getattr(xp0, k)}
        if traffic["horizon"] != gen0.end_step:
            changed.add("end_step")
        if col.diff is not None:
            changed.add("diffusion")
        assert changed == set(config["reduced"]), cell
        assert col.gen["size"][2] > 0 and col.diff is None


def _engine(dims: int, contact_path: str, device="cpu", cells=300):
    """The benchmark's engine and seeded colony: ``hipsc2d`` or ``hipsc3d``
    (its general variant on the id-list path) at ``cells`` agents."""
    config = catalog.load_json("configs", "hipsc2d" if dims == 2 else "hipsc3d")
    variant = "general" if dims == 3 and contact_path == "id_list" else "uniform"
    traffic = {"entry": "engine_blocks", "cells": cells, "variant": variant,
               "contact_path": contact_path, "horizon": 10, "block": 5}
    col = colony(config, traffic, SEED)
    entry = entries.Entry(col, traffic, SEED, device)
    return entry.eng, entries.initial_state(entry.eng, col, SEED)


def _direct_count(spec, loc, alive):
    """The candidates of every live row of a window: the live agents within
    one bin on every axis of the contact grid, itself included."""
    coords = nbr._bin_coords(spec, loc[alive])
    near = (coords[:, None, :] - coords[None, :, :]).abs().amax(dim=-1) <= 1
    return int(near.sum())


@pytest.mark.parametrize("dims,contact_path", [(2, "id_list"), (3, "id_list"),
                                               (3, "span_mask")])
def test_counter_equals_a_direct_count_of_the_entry_windows(monkeypatch, few_threads, dims,
                                                            contact_path):
    eng, state = _engine(dims, contact_path)
    builds = []
    real = engine_mod._build_window

    def build(cfg, rows, window=engine_mod.contact_window):
        out = real(cfg, rows, window)
        builds.append((cfg.jkr_spec, out[0]["loc"].clone(), out[0]["alive"].clone()))
        return out

    monkeypatch.setattr(engine_mod, "_build_window", build)
    with profiling.tracing() as rec:
        eng.run_steps(state, 3)
    (call,) = rec.calls
    assert call.counts["attempts"] == 1 and len(builds) == 3
    assert call.counts["contact.live_rows"] == sum(int(a.sum()) for _, _, a in builds)
    assert call.counts["contact.candidates"] == sum(_direct_count(*b) for b in builds)
    assert call.counts["contact.candidates"] > call.counts["contact.live_rows"] > 0
    assert "contact.candidates" in rec.report()


def test_nothing_is_tallied_outside_an_outermost_traced_block(monkeypatch, few_threads):
    from hipsc_abm_tpu_torch.parallel.ensemble import EnsembleEngine

    eng, state = _engine(3, "id_list", cells=150)

    def tally(name, value):
        raise AssertionError(f"tallied {name} with tracing off")

    with monkeypatch.context() as m:
        m.setattr(profiling, "tally", tally)
        eng.run_steps(state, 1)
    ens = EnsembleEngine(_engine(2, "id_list", cells=150)[0])
    states = ens.init_states([1, 2])
    with profiling.tracing() as rec:
        ens.safe_step(states)
    assert not {"contact.candidates", "contact.live_rows"} & set(rec.calls[0].counts)


def test_reader_gives_nothing_without_the_counter():
    def of(*counts):
        return types.SimpleNamespace(program_spans=[
            types.SimpleNamespace(counts=dict(c)) for c in counts] or None)

    assert reader.read(of()) is None
    assert reader.read(of({"steps": 5, "rebuilds": 3})) is None
    assert reader.read(of({"contact.candidates": 900, "contact.live_rows": 4},
                          {"contact.candidates": 300, "contact.live_rows": 6})) == 120.0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("contact_path", ["id_list", "span_mask"])
def test_card_traced_graph_counts_as_the_eager_block(dev, contact_path):
    eng, state = _engine(3, contact_path, dev, cells=5000)
    eng.run_steps(state, 5)  # growth and the untraced capture
    state = eng.repad_state(state, eng.cfg)
    with profiling.tracing() as rec:
        eng.run_steps(state, 5)  # the traced capture and its replay
    (graphed,) = rec.calls
    assert graphed.counts["attempts"] == 1 and graphed.device_clock
    cfg = eng._cfg_for_state(state)
    table, _ = engine_mod.step_inputs(state.key, state.step, 5)
    with profiling.tracing() as rec:
        with profiling.span("eager"):
            engine_mod._run_block(eng, cfg, state, table.to(dev))
    (eager,) = rec.calls
    for name in ("contact.candidates", "contact.live_rows"):
        assert graphed.counts[name] == eager.counts[name] > 0, name


@pytest.mark.cuda
def test_card_untraced_graph_holds_no_node_of_the_tally(dev, monkeypatch):
    def tally(name, value):
        raise AssertionError(f"tallied {name} with tracing off")

    monkeypatch.setattr(profiling, "tally", tally)
    nodes = []
    for tallied in (True, False):
        if not tallied:
            monkeypatch.setattr(engine_mod, "_tally_window", lambda bounds, rows: None)
        eng, state = _engine(3, "id_list", dev, cells=5000)
        eng.run_steps(state, 5)
        (graph,) = eng.block_graphs()
        assert not graph["traced"] and graph["nodes"]
        nodes.append(graph["nodes"])
    assert nodes[0] == nodes[1]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS_3D)
def test_card_hipsc3d_cell_is_correct(dev, tmp_path, cell):
    root = _cut_root(tmp_path, 5000)
    result = run.run_cell(cell, SEED, 1.0, True, device="cuda", root=root, log=lambda m: None)
    assert result["correct"], result["checks"]
    assert result["metrics"]["contact.candidates_per_row"]["value"] > 27
