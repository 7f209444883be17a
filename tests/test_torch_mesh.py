"""PyTorch port: ``parallel.mesh`` (the agent-sharded cross-check),
``parallel.domain`` (stripe-decomposed contact forces) and the ensemble's
``shard_states``, on the CPU.

- ``ShardedHipscEngine`` over 4 chunks equals ``HipscEngine`` bit for bit
  (every array, the bonds and the key: it steps the gathered chunks with
  the same engine), keeps the state chunked, and grows its capacity (the
  JAX ``test_parallel.py`` cases).
- ``domain_forces`` equals the all-pairs oracle within ``rtol=1e-4,
  atol=1e-14`` (the JAX ``test_domain.py`` tolerances: the halo sums add
  the pairs in another order), a pair across a stripe edge interacts
  through the halo, a stripe narrower than the reach raises, and the
  forces equal JAX's ``domain_forces`` on the 8-device CPU mesh within the
  same tolerances.
- ``EnsembleEngine.shard_states``: groups of replicates step alone and
  every replicate equals the unsharded ensemble's and its solo run's, bit
  for bit, growth included.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipsc_abm_tpu.models.params import BiologyParams as JaxBiologyParams
from hipsc_abm_tpu.parallel.domain import domain_forces as jax_domain_forces
from hipsc_abm_tpu.parallel.domain import make_stripe_mesh as jax_stripe_mesh
from hipsc_abm_tpu_torch.engine import HipscEngine
from hipsc_abm_tpu_torch.ops.jkr import _pair_jkr
from hipsc_abm_tpu_torch.params import BiologyParams, ExperimentalParams, GeneralParams
from hipsc_abm_tpu_torch.parallel.domain import (
    domain_forces,
    make_stripe_mesh,
    partition_by_stripe,
    stripe_of,
)
from hipsc_abm_tpu_torch.parallel.ensemble import EnsembleEngine, ShardedStates
from hipsc_abm_tpu_torch.parallel.mesh import (
    ShardedHipscEngine,
    ShardedState,
    gather_state,
    make_mesh,
    shard_state,
)

torch.set_num_threads(1)
BIO = BiologyParams()


def params():
    return (GeneralParams(num_to_start=200, end_step=4, size=(400.0, 400.0, 0.0)),
            ExperimentalParams(num_gata6=20, dox_step=2))


def assert_states_equal(a, b):
    for k in a.arrays:
        assert torch.equal(a.arrays[k], b.arrays[k]), k
    assert torch.equal(a.alive, b.alive)
    assert torch.equal(a.bonds.partners, b.bonds.partners)
    assert torch.equal(a.bonds.mask, b.bonds.mask)
    for k in a.gradients:
        assert torch.equal(a.gradients[k], b.gradients[k]), k
    assert torch.equal(a.key, b.key) and a.step == b.step
    assert int(a.next_id) == int(b.next_id)


# -- parallel.mesh ---------------------------------------------------------------


def test_make_mesh_lists_devices():
    assert make_mesh(4, device="cpu") == [torch.device("cpu")] * 4
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(2)  # the card by default, and there is none here


def test_sharded_engine_equals_the_single_engine_and_stays_chunked():
    gen, xp = params()
    eng_s = ShardedHipscEngine(gen, xp, mesh=make_mesh(4, device="cpu"))
    eng_1 = HipscEngine(gen, xp, device="cpu")
    eng_1.cfg = dataclasses.replace(eng_1.cfg, capacity=eng_s.cfg.capacity)
    s_sharded, s_single = eng_s.init_state(seed=17), eng_1.init_state(seed=17)
    assert isinstance(s_sharded, ShardedState) and len(s_sharded.chunks) == 4
    for _ in range(3):
        s_sharded, info_s = eng_s.safe_step(s_sharded)
        s_single, info_1 = eng_1.safe_step(s_single)
        assert info_s == info_1
    assert isinstance(s_sharded, ShardedState) and len(s_sharded.chunks) == 4
    assert {c.capacity for c in s_sharded.chunks} == {eng_s.cfg.capacity // 4}
    assert_states_equal(gather_state(s_sharded, "cpu"), s_single)
    locs = s_single.arrays["locations"][s_single.alive]
    assert (locs >= 0).all() and (locs <= 400.0).all()


def test_sharded_engine_run_steps_and_step_equal_the_single_engine():
    gen, xp = params()
    eng_s = ShardedHipscEngine(gen, xp, mesh=make_mesh(3, device="cpu"))
    eng_1 = HipscEngine(gen, xp, device="cpu")
    eng_1.cfg = eng_s.cfg
    chunks, flat = eng_s.init_state(seed=4), eng_1.init_state(seed=4)
    chunks, infos = eng_s.run_steps(chunks, 2)
    flat, want = eng_1.run_steps(flat, 2)
    np.testing.assert_array_equal(infos.num_agents, want.num_agents)
    chunks, _ = eng_s.step(chunks)
    flat, _ = eng_1.step(flat)
    assert isinstance(chunks, ShardedState) and len(chunks.chunks) == 3
    assert_states_equal(gather_state(chunks, "cpu"), flat)


def test_sharded_engine_grows_its_capacity():
    gen = GeneralParams(num_to_start=120, end_step=3, size=(300.0, 300.0, 0.0))
    xp = ExperimentalParams(num_gata6=0, dox_step=99)
    eng = ShardedHipscEngine(gen, xp, mesh=make_mesh(8, device="cpu"), device="cpu")
    eng.cfg = dataclasses.replace(eng.cfg, capacity=128)
    flat = gather_state(eng.init_state(seed=5), "cpu")
    flat = flat._replace(arrays={
        **flat.arrays,
        "div_counters": torch.full((128,), eng.bio.pluri_div_thresh, dtype=torch.int32),
        "death_counters": torch.zeros((128,), dtype=torch.int32)})
    state, info = eng.safe_step(shard_state(flat, eng.mesh))
    assert int(info.num_added) == 120
    assert eng.cfg.capacity >= 256 and state.capacity == eng.cfg.capacity
    assert len(state.chunks) == 8


# -- parallel.domain -------------------------------------------------------------


def global_forces(locations, alive, radius=5.0):
    """Oracle: all-pairs JKR forces within the search radius (float32)."""
    n = locations.shape[0]
    loc = torch.from_numpy(locations)
    delta = loc[:, None, :] - loc[None, :, :]
    ok = (torch.from_numpy(alive)[:, None] & torch.from_numpy(alive)[None, :]
          & ~torch.eye(n, dtype=torch.bool) & ((delta * delta).sum(-1) <= BIO.jkr_radius ** 2))
    radii = torch.full((n,), radius)
    force, _ = _pair_jkr(loc[:, None, :], loc[None, :, :], radii[:, None], radii[None, :],
                         BIO.adhesion_const, BIO.poisson, BIO.youngs, BIO.jkr_break_d)
    return torch.where(ok[..., None], force, 0.0).sum(dim=1).numpy()


def stripe_colony(rng, n=300, box_x=400.0):
    locations = np.zeros((n, 3), np.float32)
    locations[:, 0] = rng.random(n) * box_x
    locations[:, 1] = rng.random(n) * 100.0
    return locations, np.ones(n, bool)


def port_forces(sloc, salive, radius=5.0, box_x=400.0):
    S, P = salive.shape
    devs = make_stripe_mesh(S, device="cpu")
    out = domain_forces([torch.from_numpy(sloc[s]).to(d) for s, d in enumerate(devs)],
                        [torch.from_numpy(salive[s]).to(d) for s, d in enumerate(devs)],
                        [torch.full((P,), radius, device=d) for d in devs], box_x, BIO)
    return np.stack([f.numpy() for f in out])


def test_domain_forces_match_the_all_pairs_oracle(rng):
    n_stripes, per_stripe, box_x = 8, 64, 400.0
    locations, alive = stripe_colony(rng)
    sloc, salive, sgid = partition_by_stripe(locations, alive, box_x, n_stripes, per_stripe)
    np.testing.assert_array_equal(
        stripe_of(torch.from_numpy(locations[:, 0]), box_x, n_stripes).numpy(),
        np.clip((locations[:, 0] / (box_x / n_stripes)).astype(int), 0, n_stripes - 1))
    forces = port_forces(sloc, salive)
    want = global_forces(locations, alive)
    empty = sgid < 0
    assert (forces[empty] == 0.0).all()
    np.testing.assert_allclose(forces[~empty], want[sgid[~empty]], rtol=1e-4, atol=1e-14)


def test_domain_forces_pair_across_a_stripe_edge():
    n_stripes, per_stripe, box_x = 8, 8, 160.0  # stripes 20 um wide
    locations = np.array([[19.0, 50.0, 0.0], [21.0, 50.0, 0.0]], np.float32)
    sloc, salive, _ = partition_by_stripe(locations, np.ones(2, bool), box_x, n_stripes,
                                          per_stripe)
    forces = port_forces(sloc, salive, box_x=box_x)
    f0, f1 = forces[0, 0], forces[1, 0]
    assert f0[0] < 0 and f1[0] > 0  # deep overlap: repulsion across the boundary
    np.testing.assert_allclose(f0, -f1, rtol=1e-5)
    narrow = 8 * 0.9 * (BIO.jkr_radius + 2.0 * BIO.jkr_break_band)
    with pytest.raises(ValueError, match="reach"):
        port_forces(*partition_by_stripe(locations, np.ones(2, bool), narrow, 8, 8)[:2],
                    box_x=narrow)


@pytest.mark.skipif(jax.device_count() < 8, reason="needs the 8-device CPU mesh")
def test_domain_forces_match_jax_domain_forces(rng):
    n_stripes, per_stripe, box_x = 8, 64, 400.0
    locations, alive = stripe_colony(rng)
    sloc, salive, _ = partition_by_stripe(locations, alive, box_x, n_stripes, per_stripe)
    radii = np.full((n_stripes, per_stripe), 5.0, np.float32)
    want = np.asarray(jax_domain_forces(jnp.asarray(sloc), jnp.asarray(salive),
                                        jnp.asarray(radii), jax_stripe_mesh(n_stripes), box_x,
                                        JaxBiologyParams()))
    np.testing.assert_allclose(port_forces(sloc, salive), want, rtol=1e-4, atol=1e-14)


# -- the ensemble's shard_states -----------------------------------------------------


def ensemble_engine():
    """The growth colony of ``test_torch_ensemble.py``: 250 cells in a
    220 um box at a capacity of 256, which divisions overflow."""
    gen = GeneralParams(num_to_start=220, end_step=5, size=(220.0, 220.0, 0.0))
    eng = HipscEngine(gen, ExperimentalParams(num_gata6=30, dox_step=2), device="cpu")
    eng.cfg = dataclasses.replace(eng.cfg, capacity=256)
    return eng


def test_shard_states_equal_the_unsharded_ensemble_and_solo_runs():
    seeds = [3, 4, 5, 6, 7]
    ens, plain = EnsembleEngine(ensemble_engine()), EnsembleEngine(ensemble_engine())
    states = ens.init_states(seeds)
    unsharded = plain.init_states(seeds)
    sharded = EnsembleEngine.shard_states(states, ["cpu", "cpu"])
    assert isinstance(sharded, ShardedStates)
    assert [g.alive.shape[0] for g in sharded.groups] == [2, 3]
    for i in range(len(seeds)):
        assert_states_equal(EnsembleEngine.replicate(sharded, i),
                            EnsembleEngine.replicate(states, i))
    solos = []
    for seed in seeds:
        solo = ensemble_engine()
        state = solo.init_state(seed=seed)
        solo.cfg = ens.engine.cfg
        solos.append((solo, state))
    cap0 = states.alive.shape[1]
    for _ in range(4):
        sharded, infos = ens.safe_step(sharded)
        unsharded, want = plain.safe_step(unsharded)
        solos = [(e, e.safe_step(s)[0]) for e, s in solos]
        for got_f, want_f in zip(infos, want):  # the groups' probes, in replicate order
            np.testing.assert_array_equal(got_f, want_f)
    assert isinstance(sharded, ShardedStates) and len(sharded.groups) == 2
    assert {g.alive.shape[1] for g in sharded.groups} == {unsharded.alive.shape[1]} != {cap0}
    for i, (_, solo_state) in enumerate(solos):
        assert_states_equal(EnsembleEngine.replicate(sharded, i),
                            EnsembleEngine.replicate(unsharded, i))
        assert_states_equal(EnsembleEngine.replicate(sharded, i), solo_state)
    with pytest.raises(ValueError, match="groups"):
        EnsembleEngine.shard_states(states, ["cpu"] * 6)
