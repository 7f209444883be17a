"""PyTorch port: biology phases, the full step and capacity growth vs the JAX
package, compared by agent id (``__graft_entry__._by_id``'s canonical form).

Tolerances and their causes:
- integer state (ids, FDS values, states, counters, bond sets) is exact;
- positions: float32 force sums taken in another order, and libm
  ``cos``/``sin`` of the random unit vectors that differ by an ulp between
  PyTorch and XLA:CPU, accumulate over 11 substeps to far below 1e-3 um;
- the morphogen lattice: scatter-add order of the deposit (atol 1e-6).
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipsc_abm_tpu.engine import HipscEngine as JaxEngine
from hipsc_abm_tpu.models import biology as jbio
from hipsc_abm_tpu.models.params import (
    BiologyParams, DiffusionParams, ExperimentalParams, GeneralParams)
from hipsc_abm_tpu_torch import convert
from hipsc_abm_tpu_torch.engine import HipscEngine
from hipsc_abm_tpu_torch.models import biology as tbio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BIO = BiologyParams()
TBIO = convert.params_from_jax(BIO)
XP = ExperimentalParams(num_gata6=20, dox_step=1)
TXP = convert.params_from_jax(XP)
INT_FIELDS = ("FGF4", "FGFR", "ERK", "GATA6", "NANOG", "states", "death_counters",
              "diff_counters", "div_counters", "fds_counters")


def _key(seed):
    jkey = jax.random.split(jax.random.PRNGKey(seed), 6)[1]
    return jkey, torch.from_numpy(np.asarray(jkey).astype(np.int64))


def _agents(seed, C=300, n=260):
    rs = np.random.default_rng(seed)
    ids = rs.permutation(4 * C)[:C].astype(np.int32)
    alive = np.zeros(C, bool)
    alive[:n] = True
    rs.shuffle(alive)
    arrays = {
        "ids": ids,
        "locations": np.concatenate(
            [rs.random((C, 2)) * 300.0, np.zeros((C, 1))], axis=1).astype(np.float32),
        "radii": np.full(C, 5.0, np.float32),
        "states": (rs.random(C) < 0.3).astype(np.int32),
        "motility_forces": rs.normal(0, 1e-10, (C, 3)).astype(np.float32),
    }
    for k in ("FGF4", "FGFR", "ERK", "GATA6", "NANOG"):
        arrays[k] = rs.integers(0, 2, C).astype(np.int32)
    arrays["death_counters"] = rs.integers(BIO.death_thresh - 3, BIO.death_thresh + 1, C).astype(np.int32)
    arrays["diff_counters"] = rs.integers(25, BIO.pluri_to_diff + 1, C).astype(np.int32)
    arrays["div_counters"] = rs.integers(30, BIO.diff_div_thresh + 1, C).astype(np.int32)
    arrays["fds_counters"] = rs.integers(0, 5, C).astype(np.int32)
    nbr = rs.integers(0, 9, C).astype(np.int32)
    return arrays, alive, nbr


def _j(a):
    return {k: jnp.asarray(v) for k, v in a.items()} if isinstance(a, dict) else jnp.asarray(a)


def _t(a):
    return ({k: torch.from_numpy(v.copy()) for k, v in a.items()} if isinstance(a, dict)
            else torch.from_numpy(np.array(a)))


def test_cell_death_matches_jax():
    a, alive, nbr = _agents(0)
    want = jbio.cell_death(_j(a["states"]), _j(a["death_counters"]), _j(alive), _j(nbr), 2,
                           BIO.death_thresh)
    got = tbio.cell_death(_t(a["states"]), _t(a["death_counters"]), _t(alive), _t(nbr), 2,
                          BIO.death_thresh)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[2]) > 0


@pytest.mark.parametrize("div_cap", [16, 300])
def test_cell_division_matches_jax(div_cap):
    """The whole division chain (clock, canonical rank, slot allocation,
    daughter writes); div_cap 16 forces deferrals."""
    a, alive, nbr = _agents(1)
    jkey, tkey = _key(1)
    want = jbio.cell_division(_j(a), _j(alive), _j(nbr), jkey, BIO, True,
                              canon_order=None, next_id=jnp.int32(5000), div_cap=div_cap)
    got = tbio.cell_division(_t(a), _t(alive), _t(nbr), tkey, TBIO, True,
                             canon_order=None, next_id=torch.tensor(5000, dtype=torch.int32),
                             div_cap=div_cap)
    for k in a:
        g, w = got[0][k].numpy(), np.asarray(want[0][k])
        if k == "locations":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert int(got[3]) > 0 and (div_cap > 16 or int(got[4]) > 0)


def test_canonical_rank_with_order_matches_jax():
    rs = np.random.default_rng(2)
    mask = rs.random(200) < 0.4
    order = rs.permutation(200)
    np.testing.assert_array_equal(
        tbio.canonical_rank(_t(mask), _t(order.astype(np.int64))).numpy(),
        np.asarray(jbio.canonical_rank(_j(mask), _j(order.astype(np.int32)))),
    )


@pytest.mark.parametrize("field", [False, True])
def test_cell_pathway_matches_jax(field):
    a, alive, nbr = _agents(3)
    rs = np.random.default_rng(3)
    s1 = (rs.integers(0, 2, (300, 9)).sum(1)).astype(np.float32)
    s2 = s1 + rs.integers(0, 2, 300).astype(np.float32)
    ff = rs.random(300).astype(np.float32) * 2 if field else None
    jkey, tkey = _key(3)
    names = ("FGF4", "FGFR", "ERK", "GATA6", "NANOG", "fds_counters")
    want = jbio.cell_pathway(*[_j(a[k]) for k in names], _j(a["ids"]), _j(alive), _j(nbr),
                             _j(s1), _j(s2), jkey, jnp.int32(4), XP, BIO,
                             field_fgf4=None if ff is None else _j(ff))
    got = tbio.cell_pathway(*[_t(a[k]) for k in names], _t(a["ids"]), _t(alive), _t(nbr),
                            _t(s1), _t(s2), tkey, 4, TXP, TBIO,
                            field_fgf4=None if ff is None else _t(ff))
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_cell_differentiate_matches_jax():
    a, alive, _ = _agents(4)
    jkey, tkey = _key(4)
    names = ("GATA6", "NANOG", "states", "diff_counters", "ids")
    want = jbio.cell_differentiate(*[_j(a[k]) for k in names], _j(alive), jkey, BIO)
    got = tbio.cell_differentiate(*[_t(a[k]) for k in names], _t(alive), tkey, TBIO)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("guye", [True, False])
def test_cell_motility_matches_jax(guye):
    a, alive, nbr = _agents(5)
    rs = np.random.default_rng(5)
    cnt_n, cnt_d = rs.integers(0, 3, 300).astype(np.int32), rs.integers(0, 3, 300).astype(np.int32)
    sum_n = (rs.normal(0, 10, (300, 3)) * [1, 1, 0]).astype(np.float32)
    sum_d = (rs.normal(0, 10, (300, 3)) * [1, 1, 0]).astype(np.float32)
    jkey, tkey = _key(5)
    xp = dataclasses.replace(XP, guye_move=guye)
    names = ("locations", "GATA6", "NANOG", "states", "motility_forces", "ids")
    want = jbio.cell_motility(*[_j(a[k]) for k in names], _j(alive), _j(nbr), _j(cnt_n),
                              _j(sum_n), _j(cnt_d), _j(sum_d), jkey, xp, BIO, True)
    got = tbio.cell_motility(*[_t(a[k]) for k in names], _t(alive), _t(nbr), _t(cnt_n),
                             _t(sum_n), _t(cnt_d), _t(sum_d), tkey,
                             convert.params_from_jax(xp), TBIO, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-15)


# ---------------------------------------------------------------------------
# whole steps
# ---------------------------------------------------------------------------


def _by_id(d):
    alive = d["alive"]
    ids = d["arrays"]["ids"][alive]
    order = np.argsort(ids)
    out = {k: v[alive][order] for k, v in d["arrays"].items()}
    partners = np.where(d["bond_mask"], d["partners"], -1)[alive][order]
    out["bonds"] = [set(r[r >= 0].tolist()) for r in partners]
    return out


def _assert_same_colony(jstate, tstate, label, atol=1e-3):
    a = _by_id(convert.numpy_from_jax_state(jstate))
    b = _by_id(convert.state_to_numpy(tstate))
    np.testing.assert_array_equal(b["ids"], a["ids"], err_msg=f"{label}: ids")
    for k in INT_FIELDS:
        np.testing.assert_array_equal(b[k], a[k], err_msg=f"{label}: {k}")
    np.testing.assert_allclose(b["locations"], a["locations"], rtol=0, atol=atol,
                               err_msg=f"{label}: locations")
    assert b["bonds"] == a["bonds"], f"{label}: bond sets"
    assert int(tstate.next_id) == int(jstate.next_id)
    assert tstate.step == int(jstate.step)
    np.testing.assert_array_equal(tstate.key.numpy(), np.asarray(jstate.key).astype(np.int64))
    for g in jstate.gradients:
        np.testing.assert_allclose(tstate.gradients[g].numpy(), np.asarray(jstate.gradients[g]),
                                   rtol=0, atol=1e-6, err_msg=f"{label}: {g}")


def _bench_like(n):
    side = 2000.0 * (n / 5000.0) ** 0.5
    gen = GeneralParams(num_to_start=n, end_step=20, size=(side, side, 0.0))
    xp = ExperimentalParams(num_gata6=n // 10, dox_step=1)
    diff = DiffusionParams(spat_res=20.0, diffuse_dt=6.0, diffuse_const=2.0,
                           max_concentration=2.0, degradation=0.1, release_amount=0.01)
    return gen, xp, diff


def _torch_engine_like(jeng, gen, xp, diff):
    """The port's CPU engine with the JAX engine's parameters and capacities."""
    teng = HipscEngine(*(convert.params_from_jax(p) for p in (gen, xp)),
                       diff=convert.params_from_jax(diff), enable_diffusion=True,
                       device="cpu")
    teng.cfg = dataclasses.replace(teng.cfg, capacity=jeng.cfg.capacity,
                                   bond_cap=jeng.cfg.bond_cap, div_cap=jeng.cfg.div_cap)
    return teng


def test_hipsc_step_matches_jax():
    """One full step with diffusion and FGF4 release from one converted
    state (one JAX step in, so it carries bonds and a lattice)."""
    gen, xp, diff = _bench_like(500)
    jeng = JaxEngine(gen, xp, diff=diff, enable_diffusion=True, use_pallas=False)
    js = jeng.init_state(seed=0)
    js, _ = jeng.safe_step(js)
    teng = _torch_engine_like(jeng, gen, xp, diff)
    ts = convert.state_from_numpy(convert.numpy_from_jax_state(js), "cpu")
    assert int(ts.bonds.mask.sum()) > 0
    js2, jinfo = jeng.safe_step(js)
    ts2, tinfo = teng.safe_step(ts)
    assert tinfo.num_added == int(jinfo.num_added) > 0
    assert tinfo.num_removed == int(jinfo.num_removed)
    assert tinfo.jkr_max_degree == int(jinfo.jkr_max_degree)
    _assert_same_colony(js2, ts2, "step")


def test_hipsc_step_with_field_coupling_matches_jax():
    """One full step with ``DiffusionParams.field_coupling=True``: perceived
    FGF4 is the lattice sampled at each agent, so the lattice's floats feed
    the integer FDS update. The converted state carries a lattice of values
    in [0, 2), so that ``floor((1 + g) * field)`` takes both values; the
    step must match the JAX engine by agent id, and coupling must change
    ERK against the same step with coupling off."""
    gen, xp, diff = _bench_like(500)
    diff = dataclasses.replace(diff, field_coupling=True)
    jeng = JaxEngine(gen, xp, diff=diff, enable_diffusion=True, use_pallas=False)
    js, _ = jeng.safe_step(jeng.init_state(seed=0))
    shape = js.gradients["fgf4_values"].shape
    lattice = np.random.default_rng(0).random(shape).astype(np.float32) * 2
    js = js._replace(gradients={"fgf4_values": jnp.asarray(lattice)})
    d = convert.numpy_from_jax_state(js)
    js2, _ = jeng.safe_step(js)
    ts2, _ = _torch_engine_like(jeng, gen, xp, diff).safe_step(
        convert.state_from_numpy(d, "cpu"))
    _assert_same_colony(js2, ts2, "coupled step")
    uncoupled = dataclasses.replace(diff, field_coupling=False)
    ts_off, _ = _torch_engine_like(jeng, gen, xp, uncoupled).safe_step(
        convert.state_from_numpy(d, "cpu"))
    on, off = _by_id(convert.state_to_numpy(ts2)), _by_id(convert.state_to_numpy(ts_off))
    np.testing.assert_array_equal(on["ids"], off["ids"])
    assert not np.array_equal(on["ERK"], off["ERK"])


@pytest.mark.parametrize("seed", [0, 7])
def test_init_state_matches_jax(seed):
    gen, xp, diff = _bench_like(400)
    jeng = JaxEngine(gen, xp, diff=diff, enable_diffusion=True, use_pallas=False)
    teng = HipscEngine(*(convert.params_from_jax(p) for p in (gen, xp)),
                       diff=convert.params_from_jax(diff), enable_diffusion=True,
                       device="cpu")
    a = convert.numpy_from_jax_state(jeng.init_state(seed=seed))
    b = convert.state_to_numpy(teng.init_state(seed=seed))
    assert teng.cfg.capacity == jeng.cfg.capacity and teng.cfg.div_cap == jeng.cfg.div_cap
    assert set(a["arrays"]) == set(b["arrays"])
    for k in a["arrays"]:
        assert b["arrays"][k].dtype == a["arrays"][k].dtype, k
        np.testing.assert_array_equal(b["arrays"][k], a["arrays"][k], err_msg=k)
    for k in ("alive", "partners", "bond_mask", "key", "step", "next_id"):
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    np.testing.assert_array_equal(b["gradients"]["fgf4_values"], a["gradients"]["fgf4_values"])


def test_forced_division_safe_step_grows_like_jax():
    """Every division clock at threshold: the daughter table and then the
    capacity overflow; safe_step grows both and re-executes to the colony
    the JAX engine reaches."""
    # 394 agents in 768 slots: more mothers than free slots and than div_cap
    gen = GeneralParams(num_to_start=360, end_step=3, size=(560.0, 560.0, 0.0))
    xp = ExperimentalParams(num_gata6=34, dox_step=2)
    jeng = JaxEngine(gen, xp, use_pallas=False)
    teng = HipscEngine(convert.params_from_jax(gen), convert.params_from_jax(xp),
                       device="cpu")
    assert teng.cfg.capacity == jeng.cfg.capacity
    js = jeng.init_state(seed=0)
    ts = teng.init_state(seed=0)
    thresh = BIO.pluri_div_thresh
    js = js._replace(arrays={**js.arrays, "div_counters": jnp.full_like(
        js.arrays["div_counters"], thresh)})
    ts = ts._replace(arrays={**ts.arrays, "div_counters": torch.full_like(
        ts.arrays["div_counters"], thresh)})
    cap0 = ts.capacity
    js2, _ = jeng.safe_step(js)
    ts2, tinfo = teng.safe_step(ts)
    assert ts2.capacity > cap0 and ts2.capacity == js2.capacity
    assert tinfo.num_added > 0 and tinfo.num_deferred == 0
    _assert_same_colony(js2, ts2, "forced division")


def test_engine_device_is_explicit():
    gen = GeneralParams(num_to_start=50, end_step=3, size=(200.0, 200.0, 0.0))
    xp = ExperimentalParams(num_gata6=5, dox_step=2)
    tgen, txp = convert.params_from_jax(gen), convert.params_from_jax(xp)
    if torch.cuda.is_available():
        assert HipscEngine(tgen, txp, device="cuda").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            HipscEngine(tgen, txp, device="cuda")
    # growth makes radii unequal: the general pair law, on the device asked for
    grown = HipscEngine(tgen, txp, enable_growth=True, device="cpu")
    assert grown.device.type == "cpu" and grown.cfg.enable_growth
    assert grown.cfg.uniform_radius is None
    # a 3D box is ported: the same rules, cuda by default, cpu on request
    gen3 = convert.params_from_jax(GeneralParams(num_to_start=50, size=(100.0, 100.0, 100.0)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            HipscEngine(gen3, txp)
    eng3 = HipscEngine(gen3, txp, device="cpu")
    assert eng3.device.type == "cpu" and not eng3.cfg.two_d
    assert len(eng3.cfg.jkr_spec.flat_run_offsets) == 9


def test_numpy_round_trip_is_lossless():
    gen, xp, diff = _bench_like(300)
    teng = HipscEngine(*(convert.params_from_jax(p) for p in (gen, xp)),
                       diff=convert.params_from_jax(diff), enable_diffusion=True,
                       device="cpu")
    s, _ = teng.safe_step(teng.init_state(seed=4))
    d = convert.state_to_numpy(s)
    d2 = convert.state_to_numpy(convert.state_from_numpy(d, "cpu"))
    for k in d["arrays"]:
        np.testing.assert_array_equal(d2["arrays"][k], d["arrays"][k])
    for k in ("alive", "partners", "bond_mask", "key", "step", "next_id"):
        np.testing.assert_array_equal(d2[k], d[k])
    assert d["key"].dtype == np.uint32


def test_port_never_imports_jax():
    """Every module of the port, and chip_smoke, imported in a fresh process
    without JAX pulls in neither JAX nor the JAX package."""
    code = ("import importlib, pkgutil, sys\n"
            "import hipsc_abm_tpu_torch as pkg, chip_smoke\n"
            "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
            "for name in mods:\n"
            "    importlib.import_module(name)\n"
            "assert 'hipsc_abm_tpu_torch.ops.span_mask' in mods, mods\n"
            "assert 'hipsc_abm_tpu_torch.tools.dynslice_probe2' in mods, mods\n"
            "assert 'hipsc_abm_tpu_torch.models.hipsc' in mods, mods\n"
            "assert 'hipsc_abm_tpu_torch.utils.io' in mods, mods\n"
            "assert 'hipsc_abm_tpu_torch.parallel.ensemble' in mods, mods\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'tools', 'hipsc_abm_tpu')\n"
            "             or m.startswith(('jax.', 'jaxlib', 'hipsc_abm_tpu.', 'tools.')))\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True, timeout=120)
