"""PyTorch port: the framework layer against the JAX package.

- ``AgentGraph`` operations give the JAX graph's edges and adjacency;
- ``Simulation.get_neighbors`` gives the brute-force edge set and the JAX
  framework's edge list;
- the template reader without PyYAML parses the shipped templates as
  ``yaml.safe_load`` does;
- engine configs and npz state checkpoints carry across the two packages.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch
import yaml

from hipsc_abm_tpu import simulation as jsim
from hipsc_abm_tpu.engine import HipscEngine as JaxEngine
from hipsc_abm_tpu.engine import config_to_meta as jax_config_to_meta
from hipsc_abm_tpu.models.params import ExperimentalParams, GeneralParams
from hipsc_abm_tpu.utils import checkpoint as jckpt
from hipsc_abm_tpu_torch import convert, simulation as tsim
from hipsc_abm_tpu_torch.engine import EngineConfig, HipscEngine, config_from_meta, config_to_meta
from hipsc_abm_tpu_torch.ops import neighbors as tnbr
from hipsc_abm_tpu_torch.utils import checkpoint as tckpt
from hipsc_abm_tpu_torch.utils.config import read_simple_yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _graph_ops(graph):
    graph.set_edges([[0, 1], [1, 2], [2, 3], [3, 4]])
    graph.add_edges([[1, 0], [5, 6], [4, 2]])
    graph.simplify()
    graph.add_vertex(2)
    graph.add_edges([[7, 8]])
    graph.delete_edges([0])
    graph.delete_vertices([3, 6])
    return graph


def test_agent_graph_ops_match_jax():
    t, j = _graph_ops(tsim.AgentGraph(7)), _graph_ops(jsim.AgentGraph(7))
    np.testing.assert_array_equal(t.get_edgelist(), j.get_edgelist())
    assert (t.vcount(), t.ecount()) == (j.vcount(), j.ecount()) == (7, 3)
    for v in range(t.vcount()):
        assert t.neighbors(v) == j.neighbors(v)
        assert t.num_neighbors(v) == j.num_neighbors(v)
    t.delete_edges()
    assert t.ecount() == 0 and t.num_neighbors(0) == 0


def _sim(module, kwargs, n, size, seed):
    sim = module.Simulation("nbr", "unused/", **kwargs)
    sim.size = np.array(size, dtype=float)
    sim.number_agents = n
    sim.locations = np.random.default_rng(seed).random((n, 3)) * sim.size
    sim.agent_graph("neighbor_graph")
    return sim


def _edge_set(edges):
    return {(int(a), int(b)) for a, b in edges}


@pytest.mark.parametrize("size,distance", [((300.0, 300.0, 0.0), 15.0),
                                           ((300.0, 300.0, 0.0), 40.0),
                                           ((120.0, 120.0, 120.0), 25.0)])
def test_get_neighbors_matches_brute_force_and_jax(size, distance):
    n = 400
    t = _sim(tsim, {"device": "cpu"}, n, size, 3).get_neighbors("neighbor_graph", distance)
    j = _sim(jsim, {}, n, size, 3).get_neighbors("neighbor_graph", distance)
    locs = torch.as_tensor(np.random.default_rng(3).random((n, 3)) * np.array(size),
                           dtype=torch.float32)
    brute = tnbr.brute_force_mask(locs, torch.ones(n, dtype=torch.bool), distance).numpy()
    rows, cols = np.nonzero(np.triu(brute))
    assert _edge_set(t.get_edgelist()) == _edge_set(zip(rows, cols))
    assert len(t.get_edgelist()) > 0
    np.testing.assert_array_equal(t.get_edgelist(), j.get_edgelist())
    assert t.max_neighbors == j.max_neighbors and t.max_agents == j.max_agents


def test_get_neighbors_without_clear_merges_edges():
    sim = _sim(tsim, {"device": "cpu"}, 200, (200.0, 200.0, 0.0), 5)
    first = _edge_set(sim.get_neighbors("neighbor_graph", 15.0).get_edgelist())
    sim.locations = sim.locations[::-1].copy()
    second = sim.get_neighbors("neighbor_graph", 15.0, clear=False)
    assert first <= _edge_set(second.get_edgelist())


_TEMPLATES = sorted(os.path.join(REPO, "examples", "templates", f)
                    for f in os.listdir(os.path.join(REPO, "examples", "templates")))
_SYNTHETIC = """# a comment line
a: 1   # trailing comment
b: -2.5
c: [1, 2.0, True, off, ~]
d: 'quoted # not a comment'
e: plain words
f: null
g: 1e3
h: .5
i: []
j: yes
k: 0x1F
"""


@pytest.mark.parametrize("path", _TEMPLATES + [os.path.join(REPO, "examples", "paths.yaml"),
                                               "synthetic"])
def test_simple_yaml_reader_matches_safe_load(path):
    if path == "synthetic":
        text = _SYNTHETIC
    else:
        with open(path) as f:
            text = f.read()
    expected = yaml.safe_load(text)
    if path == "synthetic":  # hexadecimal ints are outside the subset
        expected.pop("k")
        text = text.replace("k: 0x1F\n", "")
    assert read_simple_yaml(text) == expected


def _jax_engine(n=300):
    gen = GeneralParams(num_to_start=n, size=(400.0, 400.0, 0.0))
    return JaxEngine(gen, ExperimentalParams(num_gata6=n // 10, dox_step=2))


def _common_meta(jmeta, tmeta):
    """The JAX meta restricted to the port config's keys; grid specs without
    ``run_cap`` (the JAX window width; the port walks exact run bounds)."""
    out = {k: jmeta[k] for k in tmeta if k in jmeta}
    for spec in ("nbr_spec", "jkr_spec"):
        out[spec] = {k: v for k, v in jmeta[spec].items() if k != "run_cap"}
    return out


def test_engine_config_meta_across_packages():
    jeng = _jax_engine()
    teng = HipscEngine(*(convert.params_from_jax(p) for p in (jeng.gen, jeng.xp)),
                       device="cpu")
    tmeta = config_to_meta(teng.cfg)
    assert config_from_meta(tmeta) == teng.cfg
    jmeta = jax_config_to_meta(jeng.cfg)
    from_jax = config_from_meta(jmeta)
    port_view = {k: v for k, v in tmeta.items() if k not in ("contact_path", "mask_bits")}
    for spec in ("nbr_spec", "jkr_spec"):
        port_view[spec] = {k: v for k, v in tmeta[spec].items() if k != "run_cap"}
    assert _common_meta(jmeta, tmeta) == port_view
    assert dataclasses.replace(
        from_jax, nbr_spec=teng.cfg.nbr_spec, jkr_spec=teng.cfg.jkr_spec) == teng.cfg
    # a JAX checkpoint with the optional biology phases keeps them
    flags = {"enable_growth": True, "enable_stochastic": True, "enable_diff_surround": True}
    flagged = config_from_meta({**jmeta, **flags, "uniform_radius": None})
    assert all(getattr(flagged, k) for k in flags) and flagged.uniform_radius is None


def test_npz_checkpoints_load_in_both_packages(tmp_path):
    jeng = _jax_engine()
    jstate, _ = jeng.safe_step(jeng.init_state(seed=2))
    jckpt.save_state(str(tmp_path / "jax.npz"), jstate, meta={"current_step": 1})
    tstate, meta = tckpt.load_state(str(tmp_path / "jax.npz"), device="cpu")
    assert meta == {"format_version": 2, "current_step": 1}
    assert tstate.key.dtype == torch.int64
    ref = convert.numpy_from_jax_state(jstate)
    got = convert.state_to_numpy(tstate)
    for k in ref["arrays"]:
        np.testing.assert_array_equal(got["arrays"][k], ref["arrays"][k], err_msg=k)
    for k in ("alive", "partners", "bond_mask", "key", "step", "next_id"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)

    tckpt.save_state(str(tmp_path / "port.npz"), tstate,
                     meta={"engine_config": config_to_meta(EngineConfig.create(
                         (400.0, 400.0, 0.0), 512, convert.params_from_jax(jeng.bio)))})
    back, meta2 = jckpt.load_state(str(tmp_path / "port.npz"))
    assert meta2["engine_config"]["capacity"] == 512
    assert back.key.dtype == jax.numpy.uint32
    for k in ref["arrays"]:
        np.testing.assert_array_equal(np.asarray(back.arrays[k]), ref["arrays"][k], err_msg=k)
    np.testing.assert_array_equal(np.asarray(back.bonds.partners), ref["partners"])
    np.testing.assert_array_equal(np.asarray(back.key), ref["key"])
    assert int(back.step) == int(ref["step"]) and int(back.next_id) == int(ref["next_id"])
