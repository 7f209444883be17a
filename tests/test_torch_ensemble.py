"""PyTorch port: the ensemble engine (``hipsc_abm_tpu_torch.parallel.ensemble``)
on the CPU, against the port's own solo runs and against the JAX package's
``EnsembleEngine`` (``tests/test_ensemble.py``'s workloads: 200 cells in a
400 um box, R = 3).

- Replicates and sweep points equal their solo runs bit for bit, floats,
  ``key`` and ``next_id`` included, also through a capacity growth inside
  the ensemble and with the FGF4 field coupled to the pathway. The port's
  physics sweep is bit-equal to its solo runs, where the JAX sweep (a traced
  float32 scalar against a constant-folded one) matches its solo runs to
  float32 rounding only.
- Against the JAX ensemble, by agent id: integer state, bond sets, ``key``
  and ``next_id`` equal; positions within ``tests/test_torch_step.py``'s
  1e-3 um. The JAX runs are made once per scenario by a module fixture.
- ``test_ensemble_sharded_over_mesh_no_collectives`` (the replicate axis
  over a device mesh) has no counterpart yet: it waits for the port's
  multi-device engine (ROADMAP A10).
"""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from hipsc_abm_tpu.engine import HipscEngine as JaxEngine
from hipsc_abm_tpu.models.params import ExperimentalParams as JaxExperimentalParams
from hipsc_abm_tpu.models.params import GeneralParams as JaxGeneralParams
from hipsc_abm_tpu.parallel.ensemble import SWEEPABLE as JAX_SWEEPABLE
from hipsc_abm_tpu.parallel.ensemble import EnsembleEngine as JaxEnsembleEngine
from hipsc_abm_tpu_torch import convert
from hipsc_abm_tpu_torch.engine import HipscEngine
from hipsc_abm_tpu_torch.params import DiffusionParams, ExperimentalParams, GeneralParams
from hipsc_abm_tpu_torch.parallel.ensemble import SWEEPABLE, EnsembleEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INT_FIELDS = ("FGF4", "FGFR", "ERK", "GATA6", "NANOG", "states", "death_counters",
              "diff_counters", "div_counters", "fds_counters")
DOX_SWEEP = {"dox_step": [1, 3, 100], "lonely_thresh": [2, 2, 3]}
PHYSICS_SWEEP = {"adhesion_const": [0.000107, 0.0003, 0.00005],
                 "motility_force": [2e-9, 2e-9, 8e-9]}


def make_engine(n=200, num_gata6=20, size=(400.0, 400.0, 0.0), capacity=None, **kw):
    gen = GeneralParams(num_to_start=n, end_step=5, size=size)
    xp = ExperimentalParams(num_gata6=num_gata6, dox_step=2, **kw.pop("xp", {}))
    eng = HipscEngine(gen, xp, device="cpu", **kw)
    if capacity:
        eng.cfg = dataclasses.replace(eng.cfg, capacity=capacity)
    return eng


def make_jax_engine(n=200, num_gata6=20, size=(400.0, 400.0, 0.0), capacity=None):
    gen = JaxGeneralParams(num_to_start=n, end_step=5, size=size)
    xp = JaxExperimentalParams(num_gata6=num_gata6, dox_step=2)
    eng = JaxEngine(gen, xp, use_pallas=False)
    if capacity:
        eng.cfg = dataclasses.replace(eng.cfg, capacity=capacity)
    return eng


def by_id(d: dict) -> dict:
    alive = d["alive"]
    order = np.argsort(d["arrays"]["ids"][alive])
    out = {k: v[alive][order] for k, v in d["arrays"].items()}
    partners = np.where(d["bond_mask"], d["partners"], -1)[alive][order]
    out["bonds"] = [frozenset(r[r >= 0].tolist()) for r in partners]
    return out


def assert_bit_equal(a, b, label):
    """Two port states equal bit for bit by agent id: every array (floats
    by their bits), bond sets, lattices, ``key``, ``next_id`` and step."""
    da, db = convert.state_to_numpy(a), convert.state_to_numpy(b)
    ia, ib = by_id(da), by_id(db)
    for k in da["arrays"]:
        x, y = ia[k], ib[k]
        if x.dtype == np.float32:
            x, y = x.view(np.int32), y.view(np.int32)
        np.testing.assert_array_equal(x, y, err_msg=f"{label}: {k}")
    assert ia["bonds"] == ib["bonds"], f"{label}: bond sets"
    for g in da["gradients"]:
        np.testing.assert_array_equal(da["gradients"][g].view(np.int32),
                                      db["gradients"][g].view(np.int32), err_msg=label)
    np.testing.assert_array_equal(da["key"], db["key"], err_msg=f"{label}: key")
    assert da["next_id"] == db["next_id"] and da["step"] == db["step"], label


def assert_matches_jax(tstate, jstate, label, atol=1e-3):
    """A port replicate against a JAX replicate by agent id: integer state,
    bond sets, ``key`` and ``next_id`` equal, positions within ``atol``."""
    a = by_id(convert.state_to_numpy(tstate))
    b = by_id(convert.numpy_from_jax_state(jstate))
    np.testing.assert_array_equal(a["ids"], b["ids"], err_msg=f"{label}: ids")
    for k in INT_FIELDS:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{label}: {k}")
    assert a["bonds"] == b["bonds"], f"{label}: bond sets"
    np.testing.assert_allclose(a["locations"], b["locations"], rtol=0, atol=atol,
                               err_msg=f"{label}: locations")
    np.testing.assert_array_equal(tstate.key.numpy(), np.asarray(jstate.key).astype(np.int64))
    assert int(tstate.next_id) == int(jstate.next_id), label


def solo_runs(ens, seeds, params=None, **kw):
    """One solo engine per replicate on the ensemble's shared config (so that
    both sides run the same per-replicate program), with the replicate's
    swept values, and its initial state."""
    out = []
    for i, seed in enumerate(seeds):
        eng = make_engine(**kw)
        over = {k: v[i] for k, v in (params or {}).items()}
        eng.xp = dataclasses.replace(eng.xp, **{k: v for k, v in over.items()
                                                 if SWEEPABLE[k] == "xp"})
        eng.bio = dataclasses.replace(eng.bio, **{k: v for k, v in over.items()
                                                   if SWEEPABLE[k] == "bio"})
        state = eng.init_state(seed=seed)
        eng.cfg = ens.engine.cfg
        out.append([eng, state])
    return out


_JAX_RUNS = {}


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX ensemble's final stacked state per scenario, each made once
    per process (JAX compiles each program once)."""

    def run(name, seeds, steps, sweep=None, **kw):
        if name not in _JAX_RUNS:
            ens = JaxEnsembleEngine(make_jax_engine(**kw), sweep=sweep)
            states = ens.init_states(seeds)
            for _ in range(steps):
                states, _ = ens.safe_step(states)
            _JAX_RUNS[name] = states
        return _JAX_RUNS[name]

    return run


def test_replicates_bit_exact_vs_solo(jax_runs):
    """Each replicate of an ensemble step reproduces the same seed run solo,
    bit for bit (ints AND floats), across several steps with
    division/death/pathway active; and matches the JAX ensemble."""
    seeds = [3, 11, 42]
    ens = EnsembleEngine(make_engine())
    states = ens.init_states(seeds)
    solos = solo_runs(ens, seeds)
    for _ in range(4):
        states, infos = ens.safe_step(states)
        assert infos.num_agents.shape == (3,)
        for i, pair in enumerate(solos):
            pair[1], info = pair[0].safe_step(pair[1])
            assert int(infos.num_agents[i]) == info.num_agents
    jstates = jax_runs("replicates", seeds, 4)
    for i, (_, s) in enumerate(solos):
        rep = EnsembleEngine.replicate(states, i)
        assert_bit_equal(rep, s, f"replicate {i}")
        assert_matches_jax(rep, JaxEnsembleEngine.replicate(jstates, i), f"replicate {i} vs JAX")


def test_ensemble_growth_bit_exact_same_seed(jax_runs):
    """Capacity growth inside the ensemble (probes max-reduced across
    replicates, one shared config regrown, step re-executed) stays exact:
    identical-seed replicates remain bit-identical to the solo run through
    a growth event, and to the JAX ensemble's growth."""
    kw = dict(n=220, num_gata6=30, size=(220.0, 220.0, 0.0), capacity=256)
    ens = EnsembleEngine(make_engine(**kw))
    seeds = [7, 7, 7]
    states = ens.init_states(seeds)
    [[solo, s]] = solo_runs(ens, [7], **kw)
    cap0 = states.alive.shape[1]
    grew = False
    for _ in range(6):
        states, _ = ens.safe_step(states)
        s, _ = solo.safe_step(s)
        grew = grew or states.alive.shape[1] != cap0
        assert_bit_equal(EnsembleEngine.replicate(states, 0),
                         EnsembleEngine.replicate(states, 1), "replicates 0 and 1")
    assert grew, "test workload never grew capacity — densify it"
    assert states.alive.shape[1] == s.capacity  # same growth decisions
    assert_bit_equal(EnsembleEngine.replicate(states, 0), s, "grown replicate")
    jstates = jax_runs("growth", seeds, 6, **kw)
    assert jstates.alive.shape[1] == states.alive.shape[1]
    assert_matches_jax(EnsembleEngine.replicate(states, 2),
                       JaxEnsembleEngine.replicate(jstates, 2), "grown vs JAX")


# test_ensemble_sharded_over_mesh_no_collectives: waits for the port's
# multi-device engine (ROADMAP A10); the port has no device mesh yet.


def test_parameter_sweep_matches_solo_param_values(jax_runs):
    """A dox_step/lonely_thresh sweep reproduces each parameter point's solo
    run bit for bit, and the JAX sweep by agent id."""
    seeds = [5, 5, 5]
    ens = EnsembleEngine(make_engine(), sweep=DOX_SWEEP)
    states = ens.init_states(seeds)
    solos = solo_runs(ens, seeds, DOX_SWEEP)
    for _ in range(4):
        states, _ = ens.safe_step(states)
        for pair in solos:
            pair[1], _ = pair[0].safe_step(pair[1])
    # dox_step=1 vs dox_step=100 must actually diverge (the sweep is live)
    r0 = by_id(convert.state_to_numpy(EnsembleEngine.replicate(states, 0)))
    r2 = by_id(convert.state_to_numpy(EnsembleEngine.replicate(states, 2)))
    assert not (len(r0["ids"]) == len(r2["ids"]) and np.array_equal(r0["ERK"], r2["ERK"]))
    jstates = jax_runs("dox sweep", seeds, 4, sweep=DOX_SWEEP)
    for i, (_, s) in enumerate(solos):
        rep = EnsembleEngine.replicate(states, i)
        assert_bit_equal(rep, s, f"sweep point {i}")
        assert_matches_jax(rep, JaxEnsembleEngine.replicate(jstates, i), f"point {i} vs JAX")


def test_sweep_rejects_trace_time_parameters():
    with pytest.raises(ValueError, match="not sweepable"):
        EnsembleEngine(make_engine(), sweep={"guye_move": [0, 1]})
    with pytest.raises(ValueError, match="share one length"):
        EnsembleEngine(make_engine(),
                       sweep={"dox_step": [1, 2], "lonely_thresh": [2]})
    ens = EnsembleEngine(make_engine(), sweep={"dox_step": [1, 2]})
    with pytest.raises(ValueError, match="2-point sweep"):
        ens.init_states([0, 1, 2])
    assert SWEEPABLE == JAX_SWEEPABLE


def test_physics_parameter_sweep_matches_solo(jax_runs):
    """The continuous physics parameters are sweepable too: an
    adhesion/motility dose-response sweep reproduces each point's solo run
    bit for bit (each replicate steps with the same Python values as its
    solo run), and the JAX sweep by agent id (ints exact, positions to the
    step tests' 1e-3 um)."""
    seeds = [5, 5, 5]
    ens = EnsembleEngine(make_engine(), sweep=PHYSICS_SWEEP)
    states = ens.init_states(seeds)
    solos = solo_runs(ens, seeds, PHYSICS_SWEEP)
    for _ in range(3):
        states, _ = ens.safe_step(states)
        for pair in solos:
            pair[1], _ = pair[0].safe_step(pair[1])
    # the dose actually matters: the high-adhesion replicate diverges
    r0 = by_id(convert.state_to_numpy(EnsembleEngine.replicate(states, 0)))
    r1 = by_id(convert.state_to_numpy(EnsembleEngine.replicate(states, 1)))
    assert (len(r0["ids"]) != len(r1["ids"])
            or np.abs(r0["locations"] - r1["locations"]).max() > 1e-2)
    jstates = jax_runs("physics sweep", seeds, 3, sweep=PHYSICS_SWEEP)
    for i, (_, s) in enumerate(solos):
        rep = EnsembleEngine.replicate(states, i)
        assert_bit_equal(rep, s, f"physics point {i}")
        assert_matches_jax(rep, JaxEnsembleEngine.replicate(jstates, i), f"point {i} vs JAX")


def test_coupled_diffusion_replicates_bit_exact_vs_solo():
    """With diffusion and the FGF4 field coupled to the pathway the lattice
    feeds integer state; each replicate, lattice included, equals its solo
    run. The eager ``step`` equals ``safe_step`` (no growth here) and
    returns (R,) probes."""
    diff = DiffusionParams(spat_res=20.0, diffuse_dt=6.0, diffuse_const=2.0,
                           max_concentration=2.0, degradation=0.1, release_amount=0.01,
                           field_coupling=True)
    kw = dict(diff=diff, enable_diffusion=True)
    seeds = [0, 1]
    ens = EnsembleEngine(make_engine(**kw))
    states = ens.init_states(seeds)
    eager, infos = ens.step(states)
    assert infos.num_agents.shape == (2,) and isinstance(infos.num_agents, torch.Tensor)
    solos = solo_runs(ens, seeds, **kw)
    for _ in range(3):
        states, _ = ens.safe_step(states)
        for pair in solos:
            pair[1], _ = pair[0].safe_step(pair[1])
        if eager is not None:
            for i in range(2):
                assert_bit_equal(EnsembleEngine.replicate(eager, i),
                                 EnsembleEngine.replicate(states, i), "eager step")
            eager = None
    assert float(states.gradients["fgf4_values"].abs().max()) > 0
    for i, (_, s) in enumerate(solos):
        assert_bit_equal(EnsembleEngine.replicate(states, i), s, f"coupled replicate {i}")


def test_span_mask_engine_is_forced_to_id_list():
    eng = make_engine(contact_path="span_mask")
    EnsembleEngine(eng)
    assert eng.cfg.contact_path == "id_list"


def test_stacked_jax_states_convert_to_the_ports():
    """``convert.numpy_from_jax_states`` / ``states_from_numpy`` carry a JAX
    ensemble's stacked state into the port's: equal to the port's own
    ``init_states``, and a replicate of it to the solo conversion."""
    seeds = [3, 11, 42]
    jstates = JaxEnsembleEngine(make_jax_engine()).init_states(seeds)
    d = convert.numpy_from_jax_states(jstates)
    ported = convert.states_from_numpy(d, "cpu")
    own = EnsembleEngine(make_engine()).init_states(seeds)
    assert ported.key.shape == (3, 2) and ported.next_id.shape == (3,)
    for i in range(3):
        assert_bit_equal(EnsembleEngine.replicate(ported, i),
                         EnsembleEngine.replicate(own, i), f"converted {i}")
        solo = convert.state_from_numpy(
            convert.numpy_from_jax_state(JaxEnsembleEngine.replicate(jstates, i)), "cpu")
        assert_bit_equal(EnsembleEngine.replicate(ported, i), solo, f"solo {i}")


def _load_example(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_replicate_study_example_matches_jax(tmp_path):
    """The port's ``examples/replicate_study.py`` at R = 2 and 2 steps on the
    CPU: populations equal the JAX example's CSV, radius of gyration and
    GATA6-high fraction allclose."""
    from hipsc_abm_tpu_torch.examples import replicate_study

    jmod = _load_example(os.path.join(REPO, "examples", "replicate_study.py"),
                         "jax_replicate_study")
    want = jmod.main(R=2, steps=2, out_path=str(tmp_path / "jax.csv"))
    got = replicate_study.main(R=2, steps=2, out_path=str(tmp_path / "port.csv"),
                               device="cpu")
    head = (tmp_path / "port.csv").read_text().splitlines()[0]
    assert head == (tmp_path / "jax.csv").read_text().splitlines()[0]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g[:3] == w[:3]  # step, n_mean, n_sd
        np.testing.assert_allclose(g[3:], w[3:], rtol=1e-5, atol=1e-3)
