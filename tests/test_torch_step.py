"""PyTorch port: biology phases, the full step and capacity growth vs the JAX
package, compared by agent id (``__graft_entry__._by_id``'s canonical form).

Tolerances and their causes:
- everything is exact against the JAX engine's TPU path run in interpret
  mode (``use_pallas=True``, ``pallas_interpret=True``), on the uniform law
  (every radius equal, growth off: the engine's default) and on the
  general law (growth on), in 2D and 3D: ids, integer state, bond sets,
  positions and the morphogen lattice, over single steps and five in a
  row. The port mirrors what XLA:CPU compiles that path to on an x86-64
  machine with FMA and glibc 2.36 (``ops.xla_f32``): the pair laws with
  XLA's ``rsqrt`` and their fused and folded forms, the general law's cube
  root glibc's ``powf``, the Stokes update's and growth's fused
  multiply-adds, the squared distances and norms, FTCS's fused stencil, the
  deposit's reciprocal; the draws are bit-equal already
  (``tests/test_torch_rng.py``). Force and moment sums follow the TPU
  kernels' grouping (per chunk and run, 32-lane windows of the sorted
  rows, ``neighbors.grouped_sum``), which the port reads from the JAX
  engine's span caps, carried across with the capacities.
- against the JAX engine's XLA path (``use_pallas=False``, the general
  law): integers and bond sets exact, positions within
  ``GENERAL_SPACINGS`` float32 spacings of the largest coordinate. That
  path's pair law takes a square root and divides by it where the TPU
  kernels, which the port follows, multiply by ``rsqrt``, and it sums each
  row's padded window in 32-wide partial sums.
- motility is held against the JAX function compiled as the engine
  compiles it (under ``jax.jit``).
"""

import dataclasses
import math
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
    """Against the JAX function compiled as its engine compiles it (under
    ``jax.jit``): XLA:CPU fuses the squared norm into FMAs, which eager
    JAX, one operation at a time, does not."""
    a, alive, nbr = _agents(5)
    rs = np.random.default_rng(5)
    cnt_n, cnt_d = rs.integers(0, 3, 300).astype(np.int32), rs.integers(0, 3, 300).astype(np.int32)
    sum_n = (rs.normal(0, 10, (300, 3)) * [1, 1, 0]).astype(np.float32)
    sum_d = (rs.normal(0, 10, (300, 3)) * [1, 1, 0]).astype(np.float32)
    jkey, tkey = _key(5)
    xp = dataclasses.replace(XP, guye_move=guye)
    names = ("locations", "GATA6", "NANOG", "states", "motility_forces", "ids")
    motility = jax.jit(jbio.cell_motility, static_argnums=(13, 14, 15))
    want = motility(*[_j(a[k]) for k in names], _j(alive), _j(nbr), _j(cnt_n),
                    _j(sum_n), _j(cnt_d), _j(sum_d), jkey, xp, BIO, True)
    got = tbio.cell_motility(*[_t(a[k]) for k in names], _t(alive), _t(nbr), _t(cnt_n),
                             _t(sum_n), _t(cnt_d), _t(sum_d), tkey,
                             convert.params_from_jax(xp), TBIO, True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


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


def _assert_same_colony(jstate, tstate, label, atol=1e-3, spacings=None, exact=False):
    """Integers, bonds, keys and lattices as the module docstring says;
    positions within ``atol`` um or, given ``spacings``, within that many
    float32 spacings of the largest coordinate; ``exact``: positions and the
    lattice bit-equal."""
    a = _by_id(convert.numpy_from_jax_state(jstate))
    b = _by_id(convert.state_to_numpy(tstate))
    np.testing.assert_array_equal(b["ids"], a["ids"], err_msg=f"{label}: ids")
    for k in INT_FIELDS:
        np.testing.assert_array_equal(b[k], a[k], err_msg=f"{label}: {k}")
    if exact:
        np.testing.assert_array_equal(b["locations"], a["locations"],
                                      err_msg=f"{label}: locations")
    else:
        if spacings is not None:
            atol = spacings * float(np.spacing(np.abs(a["locations"]).max().astype(np.float32)))
        np.testing.assert_allclose(b["locations"], a["locations"], rtol=0, atol=atol,
                                   err_msg=f"{label}: locations")
    assert b["bonds"] == a["bonds"], f"{label}: bond sets"
    assert int(tstate.next_id) == int(jstate.next_id)
    assert tstate.step == int(jstate.step)
    np.testing.assert_array_equal(tstate.key.numpy(), np.asarray(jstate.key).astype(np.int64))
    for g in jstate.gradients:
        if exact:
            np.testing.assert_array_equal(tstate.gradients[g].numpy(),
                                          np.asarray(jstate.gradients[g]), err_msg=f"{label}: {g}")
        else:
            np.testing.assert_allclose(tstate.gradients[g].numpy(),
                                       np.asarray(jstate.gradients[g]), rtol=0, atol=1e-6,
                                       err_msg=f"{label}: {g}")


def _bench_like(n):
    side = 2000.0 * (n / 5000.0) ** 0.5
    gen = GeneralParams(num_to_start=n, end_step=20, size=(side, side, 0.0))
    xp = ExperimentalParams(num_gata6=n // 10, dox_step=1)
    diff = DiffusionParams(spat_res=20.0, diffuse_dt=6.0, diffuse_const=2.0,
                           max_concentration=2.0, degradation=0.1, release_amount=0.01)
    return gen, xp, diff


# positions in float32 spacings of the largest coordinate against the JAX
# engine's XLA path (module docstring)
GENERAL_SPACINGS = 8


def _interpreted(jeng):
    """The JAX engine's TPU path in interpret mode, the port's reference."""
    jeng.cfg = dataclasses.replace(jeng.cfg, pallas_interpret=True)
    return jeng


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
    jeng = _interpreted(JaxEngine(gen, xp, diff=diff, enable_diffusion=True, use_pallas=True))
    js = jeng.init_state(seed=0)
    js, _ = jeng.safe_step(js)
    teng = _torch_engine_like(jeng, gen, xp, diff)
    assert teng.cfg.uniform_radius == BIO.max_radius
    ts = convert.state_from_numpy(convert.numpy_from_jax_state(js), "cpu")
    assert int(ts.bonds.mask.sum()) > 0
    js2, jinfo = jeng.safe_step(js)
    ts2, tinfo = teng.safe_step(ts)
    assert tinfo.num_added == int(jinfo.num_added) > 0
    assert tinfo.num_removed == int(jinfo.num_removed)
    assert tinfo.jkr_max_degree == int(jinfo.jkr_max_degree)
    assert tinfo.max_substep_move == float(jinfo.max_substep_move)
    _assert_same_colony(js2, ts2, "step", exact=True)


def test_hipsc_step_with_field_coupling_matches_jax():
    """One full step with ``DiffusionParams.field_coupling=True``: perceived
    FGF4 is the lattice sampled at each agent, so the lattice's floats feed
    the integer FDS update. The converted state carries a lattice of values
    in [0, 2), so that ``floor((1 + g) * field)`` takes both values; the
    step must match the JAX engine by agent id, and coupling must change
    ERK against the same step with coupling off."""
    gen, xp, diff = _bench_like(500)
    diff = dataclasses.replace(diff, field_coupling=True)
    jeng = _interpreted(JaxEngine(gen, xp, diff=diff, enable_diffusion=True, use_pallas=True))
    js, _ = jeng.safe_step(jeng.init_state(seed=0))
    shape = js.gradients["fgf4_values"].shape
    lattice = np.random.default_rng(0).random(shape).astype(np.float32) * 2
    js = js._replace(gradients={"fgf4_values": jnp.asarray(lattice)})
    d = convert.numpy_from_jax_state(js)
    js2, _ = jeng.safe_step(js)
    ts2, _ = _torch_engine_like(jeng, gen, xp, diff).safe_step(
        convert.state_from_numpy(d, "cpu"))
    _assert_same_colony(js2, ts2, "coupled step", exact=True)
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
    # the XLA path's law, the general one (the interpreted TPU path would
    # rebuild its kernels at each grown capacity: minutes on a CPU)
    teng.cfg = dataclasses.replace(teng.cfg, uniform_radius=None)
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
    _assert_same_colony(js2, ts2, "forced division", spacings=GENERAL_SPACINGS)


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
    without JAX pulls in neither JAX, nor the JAX package, nor optax (the
    card's machine has none)."""
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
            "assert 'hipsc_abm_tpu_torch.calibrate' in mods, mods\n"
            "assert 'hipsc_abm_tpu_torch.examples.calibrate' in mods, mods\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'tools', 'hipsc_abm_tpu', 'optax')\n"
            "             or m.startswith(('jax.', 'jaxlib', 'hipsc_abm_tpu.', 'tools.', 'optax.')))\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True, timeout=120)


# ---------------------------------------------------------------------------
# several steps in a row, and the mirrors of XLA:CPU's arithmetic
# ---------------------------------------------------------------------------


def _spheroid_like(n=400):
    """A small 3D ball (the spheroid example's shape): ``(gen, xp, ball)``."""
    from hipsc_abm_tpu_torch import colonies

    tgen, txp, ball = colonies.spheroid(n, 0)
    gen = GeneralParams(num_to_start=tgen.num_to_start, end_step=20, size=tgen.size)
    xp = ExperimentalParams(num_gata6=txp.num_gata6, dox_step=1, guye_move=False)
    return gen, xp, ball


# the bond and daughter capacities of the general-law five steps, wide
# enough that no step regrows them: the interpreted kernels rebuild at each
# grown shape (minutes on a CPU)
FIVE_STEP_CAPS = {2: dict(bond_cap=16), 3: dict(bond_cap=24)}


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("law", ["uniform", "general"])
def test_five_steps_match_jax(dims, law):
    """Five ``safe_step``s from one state, compared after each, against the
    JAX engine's TPU path in interpret mode, bit for bit: integer state,
    bond sets, positions and the lattice, on the uniform law and on the
    general law (growth on, radii seeded below max_radius; the bond and
    daughter capacities set at the start so that no step regrows them).
    The spans of the JAX kernels are carried across with the capacities:
    they set the sums' grouping near the end of the sorted order."""
    uniform = law == "uniform"
    growth = dict(enable_growth=not uniform)
    if dims == 2:
        gen, xp, diff = _bench_like(400)
        jeng = JaxEngine(gen, xp, diff=diff, enable_diffusion=True, use_pallas=True,
                         **growth)
        js = jeng.init_state(seed=3)
    else:
        gen, xp, ball = _spheroid_like()
        diff = None
        jeng = JaxEngine(gen, xp, use_pallas=True, **growth)
        js = jeng.init_state(seed=3, locations=jnp.asarray(ball))
    _interpreted(jeng)
    if not uniform:
        rs = np.random.default_rng(3)
        radii = rs.uniform(BIO.min_radius, BIO.max_radius, js.capacity).astype(np.float32)
        js = js._replace(arrays={**js.arrays, "radii": jnp.asarray(radii)})
        jeng.cfg = dataclasses.replace(jeng.cfg, div_cap=jeng.cfg.capacity,
                                       **FIVE_STEP_CAPS[dims])
        js = JaxEngine.repad_state(js, jeng.cfg)
    teng = HipscEngine(*(convert.params_from_jax(p) for p in (gen, xp)),
                       diff=None if diff is None else convert.params_from_jax(diff),
                       enable_diffusion=diff is not None, device="cpu", **growth)
    ts = convert.state_from_numpy(convert.numpy_from_jax_state(js), "cpu")
    caps = ("capacity", "bond_cap", "div_cap", "jkr_span", "nbr_span")
    cfg0 = [getattr(jeng.cfg, k) for k in caps]
    for step in range(5):
        js, jinfo = jeng.safe_step(js)
        teng.cfg = dataclasses.replace(
            teng.cfg, capacity=jeng.cfg.capacity, bond_cap=jeng.cfg.bond_cap,
            div_cap=jeng.cfg.div_cap, jkr_span=jeng.cfg.jkr_span, nbr_span=jeng.cfg.nbr_span)
        ts, tinfo = teng.safe_step(ts)
        assert (teng.cfg.uniform_radius is None) != uniform
        _assert_same_colony(js, ts, f"{dims}D {law} step {step + 1}", exact=True)
        # the JAX kernels' span probes, which grow the spans in both engines
        assert (tinfo.jkr_block_span, tinfo.nbr_block_span) == (
            int(jinfo.jkr_span_needed), int(jinfo.nbr_span_needed))
    if not uniform:
        assert [getattr(jeng.cfg, k) for k in caps] == cfg0  # nothing regrew


def test_span_growth_matches_jax():
    """Both engines start from span caps of 128 that the 2D colony's blocks
    outgrow: the JAX engine grows its DMA spans and re-executes the step,
    and the port, its spans not carried across, grows them by the same
    rule and reaches the same colony bit for bit."""
    gen, xp, diff = _bench_like(400)
    jeng = _interpreted(JaxEngine(gen, xp, diff=diff, enable_diffusion=True, use_pallas=True))
    js = jeng.init_state(seed=3)
    jeng.cfg = dataclasses.replace(jeng.cfg, jkr_span=128, nbr_span=128)
    teng = _torch_engine_like(jeng, gen, xp, diff)
    teng.cfg = dataclasses.replace(teng.cfg, jkr_span=128, nbr_span=128)
    assert teng.cfg.capacity == jeng.cfg.capacity
    ts = convert.state_from_numpy(convert.numpy_from_jax_state(js), "cpu")
    js, jinfo = jeng.safe_step(js)
    ts, tinfo = teng.safe_step(ts)
    assert (teng.cfg.jkr_span, teng.cfg.nbr_span) == (jeng.cfg.jkr_span, jeng.cfg.nbr_span)
    assert teng.cfg.jkr_span > 128 and teng.cfg.nbr_span > 128
    assert (tinfo.jkr_block_span, tinfo.nbr_block_span) == (
        int(jinfo.jkr_span_needed), int(jinfo.nbr_span_needed))
    _assert_same_colony(js, ts, "grown spans", exact=True)


def _update_inputs(seed, C=4000):
    rs = np.random.default_rng(seed)
    loc = (rs.random((C, 3)) * [300.0, 300.0, 200.0]).astype(np.float32)
    loc[:40, 0] = 0.0
    rad = rs.uniform(3.0, 5.0, C).astype(np.float32)
    alive = rs.random(C) < 0.9
    rad[~alive] = 0.0
    force = rs.normal(0, 3e-9, (C, 3)).astype(np.float32)
    force[:40, 0] = -1e-6  # past the wall: clamped
    force[40:80, 1] = 1e-6  # past the far wall
    mot = rs.normal(0, 1e-9, (C, 3)).astype(np.float32)
    ref = (loc + rs.normal(0, 4.0, (C, 3))).astype(np.float32)
    size = np.asarray([300.0, 300.0, 200.0], np.float32)
    return loc, rad, force, mot, alive, ref, size


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_update_mirror_matches_jax(seed):
    """``integrate.update_plain`` against the JAX package's
    ``stokes_integrate``, compiled (the scan's dt a traced value; the first
    substep's a literal, which XLA folds into the update), over random
    states with clamped and dead rows: the new locations bit for bit."""
    from hipsc_abm_tpu.ops.integrate import stokes_integrate as jstokes
    from hipsc_abm_tpu_torch.ops import integrate

    loc, rad, force, mot, alive, ref, size = _update_inputs(seed)
    dt = np.float32(BIO.move_dt)

    def probes(loc, rad, force, mot, alive, ref, size, dt):
        new = jstokes(loc, rad, force, mot, alive, BIO.stokes, size, dt)
        move2 = jnp.max(jnp.where(alive, jnp.sum((new - loc) ** 2, axis=-1), 0.0))
        drift2 = jnp.max(jnp.where(alive, jnp.sum((new - ref) ** 2, axis=-1), 0.0))
        return new, move2, drift2

    traced = jax.jit(probes)
    literal = jax.jit(lambda *a: probes(*a, float(dt)))
    args = [jnp.asarray(x) for x in (loc, rad, force, mot, alive, ref, size)]
    for folded, want in ((False, traced(*args, jnp.float32(dt))), (True, literal(*args))):
        got = integrate.update_plain(*(torch.from_numpy(x) for x in (
            loc, rad, force, mot, alive, ref, size)), stokes=BIO.stokes, dt=float(dt),
            folded=folded, threshold=49.0)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        # the probes' squared norms: XLA:CPU fuses them into FMAs in the
        # engine's step (the step tests hold max_substep_move exactly), but
        # not in this program, whose vectorised loop squares first
        for g, w in zip(got[1:3], want[1:]):
            np.testing.assert_allclose(float(g), float(w), rtol=4e-7)
        assert bool(got[3]) == (float(got[2]) > 49.0)
    assert float(got[0][:40, 0].max()) == 0.0 and bool((got[0][40:80, 1] == 300.0).any())
    assert np.array_equal(got[0].numpy()[~alive], loc[~alive])


@pytest.mark.parametrize("mirror", ["fma", "rsqrt", "sqrt", "update", "uniform_law", "general_law"])
def test_mirror_gradients_are_the_plain_formulas(mirror):
    """Each mirror on a differentiable path carries the plain formula's
    derivative (autograd does not pass its bit operations): its gradient
    equals that of the plain PyTorch expression, to float32 rounding."""
    from hipsc_abm_tpu_torch.ops import integrate, jkr, xla_f32

    rs = np.random.default_rng(7)

    def leaf(*shape, lo=0.5, hi=2.0):
        return torch.from_numpy(rs.uniform(lo, hi, shape).astype(np.float32)).requires_grad_()

    if mirror == "fma":
        xs = [leaf(64), leaf(64), leaf(64)]
        pair = (lambda a, b, c: xla_f32.fma(a, b, c), lambda a, b, c: a * b + c)
    elif mirror == "rsqrt":
        xs = [leaf(64)]
        pair = (xla_f32.rsqrt, lambda x: x ** -0.5)
    elif mirror == "sqrt":
        xs = [leaf(64)]
        pair = (xla_f32.sqrt, torch.sqrt)
    elif mirror == "update":
        loc, rad, force, mot, alive, ref, size = (torch.from_numpy(x) for x in _update_inputs(1, 64))
        xs = [loc.clone().requires_grad_(), (force * 1e-3).requires_grad_()]

        def plain(loc, force):
            fric = torch.where(rad > 0, 6.0 * math.pi * BIO.stokes * (rad / 1e6),
                               torch.ones_like(rad))
            new = loc + float(BIO.move_dt) * ((force + mot) / fric[:, None]) * 1e6
            new = torch.minimum(new.clamp(min=0.0), size)
            return torch.where(alive[:, None], new, loc)

        pair = (lambda loc, force: integrate.stokes_integrate(
            loc, rad, force, mot, alive, BIO.stokes, size, float(BIO.move_dt)), plain)
    elif mirror == "uniform_law":
        xs = [leaf(64, 3, lo=-6.0, hi=6.0)]
        law = jkr.uniform_law(BIO.max_radius, BIO.adhesion_const, BIO.poisson, BIO.youngs)

        def plain(d):
            mag = torch.sqrt((d * d).sum(-1))
            dd = (2 * BIO.max_radius - mag) * law["inv_scale"]
            f = ((-0.0204 * dd + 0.4942) * dd + 1.0801) * dd - 1.324
            return (f * law["fpre"] / mag)[:, None] * d

        pair = (lambda d: jkr._pair_uniform(d[:, 0], d[:, 1], d[:, 2], law)[2][:, None] * d,
                plain)
    else:
        xs = [leaf(64, 3, lo=-6.0, hi=6.0), leaf(64, lo=3.0, hi=5.0)]
        args = (BIO.adhesion_const, BIO.poisson, BIO.youngs, BIO.jkr_break_d)

        def plain(d, r):
            e_hat = 1.0 / (2.0 * (1.0 - BIO.poisson ** 2) / BIO.youngs)
            mag = torch.sqrt((d * d).sum(-1))
            r_hat = r * 5.0 / (1e6 * (r + 5.0))
            scale = ((math.pi * BIO.adhesion_const) / e_hat) ** (2 / 3) * r_hat ** (1 / 3)
            dd = (r + 5.0 - mag) / 1e6 / scale
            f = ((-0.0204 * dd + 0.4942) * dd + 1.0801) * dd - 1.324
            return (f * math.pi * BIO.adhesion_const * r_hat / mag)[:, None] * d

        pair = (lambda d, r: jkr._pair_jkr(d, torch.zeros_like(d), r, torch.full_like(r, 5.0),
                                           *args)[0], plain)
    grads = []
    for fn in pair:
        out = fn(*xs)
        g = torch.autograd.grad(out.sum(), xs)
        grads.append([x.double() for x in g])
        assert torch.isfinite(out).all()
    for g_mirror, g_plain in zip(*grads):
        np.testing.assert_allclose(g_mirror.numpy(), g_plain.numpy(), rtol=2e-4,
                                   atol=1e-6 * float(g_plain.abs().max()))


def test_rsqrt_mirror_equals_xla_over_every_mantissa():
    """``xla_f32.rsqrt`` (the x86 estimate table and two fused Newton
    steps) against XLA:CPU's compiled ``rsqrt`` at every float32 in [1, 4)
    (the table's whole domain: exponent parity and mantissa) and at random
    inputs over the normal range: bit for bit."""
    from hipsc_abm_tpu_torch.ops import xla_f32

    rsqrt = jax.jit(jax.lax.rsqrt)
    x = (np.arange(1 << 24, dtype=np.uint32) + np.uint32(127 << 23)).view(np.float32)
    np.testing.assert_array_equal(xla_f32.rsqrt(torch.from_numpy(x)).numpy(),
                                  np.asarray(rsqrt(jnp.asarray(x))))
    rs = np.random.default_rng(0)
    y = (rs.random(1 << 20) * 2.0 ** rs.integers(-120, 120, 1 << 20)).astype(np.float32)
    y = y[y >= np.finfo(np.float32).tiny]
    np.testing.assert_array_equal(xla_f32.rsqrt(torch.from_numpy(y)).numpy(),
                                  np.asarray(rsqrt(jnp.asarray(y))))
