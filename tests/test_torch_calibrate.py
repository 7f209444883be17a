"""PyTorch port: calibration (``hipsc_abm_tpu_torch.calibrate``), the
all-pairs physics path (``EngineConfig.dense_pairs``), rematerialisation
and the ES draws, against the JAX package on the CPU.

The colony is ``tests/test_calibrate.py``'s (150 + 15 cells in a 300 um box,
settled by one ``safe_step``); the JAX results are made once per module by
fixtures and passed as numpy. Tolerances and their causes:

- statistics and losses on one converted state: rtol 1e-5 (float32
  reductions taken in another order);
- a gradient evaluation (2 steps, the plain path): loss rtol 1e-5; the
  gradient rtol 1e-4 (measured ~1e-6: the same float32 pair law with the
  parameters as float32 scalars, force sums in another order), and within
  15% of the port's own central finite difference (the JAX test's
  criterion: float32 differences over a rollout carry a few percent of
  cancellation noise) on a statistic the step moves by many ulps;
- fits: histories and parameters rtol 1e-5 (measured ~2e-6);
- the dense path: integer state and bond sets equal by agent id, positions
  within the step tests' 1e-3 um against JAX, 2e-4 um against the port's
  windowed path (``tests/test_engine.py::test_dense_pairs_matches_windowed``);
- ``random_uniform`` and ``random_normal`` bit-equal to
  ``jax.random.uniform`` and ``jax.random.normal``: XLA's ``erf_inv`` and
  its own float32 ``log1p`` are mirrored (``ops.rng.erf_inv_f32``,
  ``log1p_f32``), checked over all 2^23 uniforms ``jax.random.normal``
  can draw; so ``fit_es`` draws JAX's perturbations bit for bit, and its
  iterates part from JAX's only through the rollouts' float32 force sums
  (measured 1.9e-6 relative; held to 4e-6).

The port's CPU ops run on one thread here: on a shared CPU the default
thread pool made a (256, 256, 3) elementwise op ~100x slower.
"""

import dataclasses
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hipsc_abm_tpu import calibrate as jcal
from hipsc_abm_tpu.engine import HipscEngine as JaxEngine
from hipsc_abm_tpu.models.params import ExperimentalParams as JaxExperimentalParams
from hipsc_abm_tpu.models.params import GeneralParams as JaxGeneralParams
from hipsc_abm_tpu.parallel.ensemble import EnsembleEngine as JaxEnsembleEngine
from hipsc_abm_tpu_torch import calibrate as tcal
from hipsc_abm_tpu_torch import convert
from hipsc_abm_tpu_torch.engine import HipscEngine
from hipsc_abm_tpu_torch.ops import rng as trng

GEN = JaxGeneralParams(num_to_start=150, end_step=5, size=(300.0, 300.0, 0.0))
XP = JaxExperimentalParams(num_gata6=15, dox_step=1)
NAMES = ["adhesion_const", "motility_force"]
TARGET_RG = 100.0
INT_FIELDS = ("FGF4", "FGFR", "ERK", "GATA6", "NANOG", "states", "death_counters",
              "diff_counters", "div_counters", "fds_counters")


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_engine(gen=GEN, capacity=None, **kw):
    eng = JaxEngine(gen, XP, use_pallas=False, **kw)
    if capacity:
        eng.cfg = dataclasses.replace(eng.cfg, capacity=capacity)
    return eng


def port_engine(jeng, **kw):
    """The port's CPU engine with the JAX engine's parameters and
    capacities."""
    teng = HipscEngine(convert.params_from_jax(jeng.gen), convert.params_from_jax(jeng.xp),
                       device="cpu", **kw)
    # uniform_radius None: the law of the JAX engine's XLA path, the general one
    teng.cfg = dataclasses.replace(teng.cfg, capacity=jeng.cfg.capacity,
                                   bond_cap=jeng.cfg.bond_cap, div_cap=jeng.cfg.div_cap,
                                   uniform_radius=None)
    return teng


def by_id(d):
    alive = d["alive"]
    order = np.argsort(d["arrays"]["ids"][alive])
    out = {k: v[alive][order] for k, v in d["arrays"].items()}
    partners = np.where(d["bond_mask"], d["partners"], -1)[alive][order]
    out["bonds"] = [set(r[r >= 0].tolist()) for r in partners]
    return out


def assert_same_colony(a, b, label, atol):
    """Two numpy colonies (``convert``'s dicts) equal by agent id: integer
    state and bond sets exactly, positions within ``atol`` um."""
    a, b = by_id(a), by_id(b)
    np.testing.assert_array_equal(a["ids"], b["ids"], err_msg=f"{label}: ids")
    for k in INT_FIELDS:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{label}: {k}")
    np.testing.assert_allclose(a["locations"], b["locations"], rtol=0, atol=atol,
                               err_msg=f"{label}: locations")
    assert a["bonds"] == b["bonds"], f"{label}: bond sets"


@pytest.fixture(scope="module")
def settled():
    """The JAX engine after ``init_state(seed=0)`` and one ``safe_step``: its
    config and the state as numpy."""
    eng = jax_engine()
    state, _ = eng.safe_step(eng.init_state(seed=0))
    return eng, convert.numpy_from_jax_state(state)


def port_calibrator(jeng, loss_fn, names=NAMES, horizon=2, **kw):
    return tcal.Calibrator(port_engine(jeng), names, loss_fn, horizon=horizon, **kw)


def port_state(d):
    return convert.state_from_numpy(d, "cpu")


@pytest.fixture(scope="module")
def jax_fits(settled):
    """The JAX calibrator on the settled colony (adhesion and motility,
    squared error of Rg, horizon 2): the gradient at theta0, 3 iterations
    of ``fit``, the population losses of fixed candidates and 2
    generations of ``fit_es`` (popsize 4)."""
    jeng0, d = settled
    jstate = convert_to_jax(d)
    eng = jax_engine()
    cal = jcal.Calibrator(eng, NAMES, jcal.squared_error(jcal.radius_of_gyration, TARGET_RG),
                          horizon=2)
    prepared = cal.prepare(jstate)
    theta0 = cal.theta0()
    vg, pop = cal._fns(eng.cfg)
    (loss, _), grad = vg(theta0, prepared)
    cands = np.asarray(theta0)[None, :] + np.array([[0.3, -0.2], [-0.3, 0.2], [0.0, 0.5]],
                                                   np.float32)
    pop_losses, _ = pop(jnp.asarray(cands), prepared)
    fit = cal.fit(jstate, iters=3, learning_rate=0.1)
    es = cal.fit_es(jstate, iters=2, popsize=4, sigma=0.3, learning_rate=0.1, seed=1)
    return dict(
        state=convert.numpy_from_jax_state(prepared), cfg=eng.cfg, loss=float(loss),
        grad=np.asarray(grad), cands=cands, pop_losses=np.asarray(pop_losses),
        fit=fit, es=es)


def convert_to_jax(d):
    """A JAX ``CellState`` of a numpy colony (``convert``'s dict)."""
    from hipsc_abm_tpu.engine import CellState as JaxCellState
    from hipsc_abm_tpu.ops.jkr import BondState as JaxBondState

    return JaxCellState(
        arrays={k: jnp.asarray(v) for k, v in d["arrays"].items()},
        alive=jnp.asarray(d["alive"]),
        bonds=JaxBondState(partners=jnp.asarray(d["partners"]),
                           mask=jnp.asarray(d["bond_mask"])),
        gradients={k: jnp.asarray(v) for k, v in d["gradients"].items()},
        key=jnp.asarray(d["key"], jnp.uint32),
        step=jnp.asarray(d["step"], jnp.int32),
        next_id=jnp.asarray(d["next_id"], jnp.int32),
    )


# ---------------------------------------------------------------------------
# statistics and losses
# ---------------------------------------------------------------------------

STATS = np.array([[50.0, 0.10], [49.2, 0.13], [48.1, 0.17]], np.float32)
TARGETS = np.array([[50.5, 0.11], [49.9, 0.12], [49.0, 0.16]], np.float32)

LOSS_CASES = {
    "radius_of_gyration": lambda m: m.radius_of_gyration,
    "gata6_high_fraction": lambda m: m.gata6_high_fraction,
    "soft_contact_count": lambda m: m.soft_contact_count(10.0, 1.0),
    "squared_error": lambda m: m.squared_error(m.radius_of_gyration, TARGET_RG),
    "trajectory": lambda m: m.trajectory_squared_error(None, TARGETS[:, 0]).loss,
    "delta_trajectory": lambda m: m.delta_trajectory_squared_error(None, TARGETS[:, 0]).loss,
    "multi_delta": lambda m: m.multi_delta_trajectory_squared_error(
        [(None, TARGETS[:, 0]), (None, TARGETS[:, 1])]).loss,
    "ensemble_squared_error": lambda m: m.ensemble_squared_error(None, 49.0).loss,
    "ensemble_trajectory": lambda m: m.ensemble_trajectory(
        m.multi_delta_trajectory_squared_error(
            [(None, TARGETS[:, 0]), (None, TARGETS[:, 1])], weights=[1.0, 50.0])).loss,
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_statistics_and_losses_match_jax(settled, case):
    """Each statistic on the converted settled state, each loss kind on one
    (horizon, 2) course of statistics (the ensemble losses on its mean or
    its first column), against the JAX function: rtol 1e-5."""
    _, d = settled
    fn_j, fn_t = LOSS_CASES[case](jcal), LOSS_CASES[case](tcal)
    if case in ("trajectory", "delta_trajectory"):
        args_j, args_t = (jnp.asarray(STATS[:, 0]),), (torch.from_numpy(STATS[:, 0].copy()),)
    elif case == "ensemble_squared_error":
        args_j, args_t = (jnp.asarray(STATS[0, 0]),), (torch.tensor(STATS[0, 0]),)
    elif case in ("multi_delta", "ensemble_trajectory"):
        args_j, args_t = (jnp.asarray(STATS),), (torch.from_numpy(STATS.copy()),)
    else:
        args_j, args_t = (convert_to_jax(d),), (port_state(d),)
    want, got = float(fn_j(*args_j)), float(fn_t(*args_t))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert want != 0.0


# ---------------------------------------------------------------------------
# the all-pairs physics path
# ---------------------------------------------------------------------------


def test_dense_pairs_matches_jax_dense(settled):
    """4 ``safe_step``s of the port's dense path against the JAX engine's
    dense path from one converted state: integer state and bond sets equal
    by agent id, positions within 1e-3 um."""
    jeng0, d = settled
    jeng = jax_engine()
    jeng.cfg = dataclasses.replace(jeng0.cfg, dense_pairs=True)
    teng = port_engine(jeng)
    teng.cfg = dataclasses.replace(teng.cfg, dense_pairs=True)
    js, ts = convert_to_jax(d), port_state(d)
    for step in range(4):
        js, jinfo = jeng.safe_step(js)
        ts, tinfo = teng.safe_step(ts)
        assert tinfo.jkr_max_degree == int(jinfo.jkr_max_degree), step
        assert_same_colony(convert.numpy_from_jax_state(js), convert.state_to_numpy(ts),
                           f"dense step {step}", atol=1e-3)
    assert teng.cfg.capacity == jeng.cfg.capacity and teng.cfg.bond_cap == jeng.cfg.bond_cap


def test_dense_pairs_matches_windowed(settled):
    """The port's dense path against its own windowed (id-list) path over
    4 ``safe_step``s from ``init_state``, as the JAX package's test holds
    its two paths: identical ids and bond sets, positions within 2e-4 um."""
    jeng0, _ = settled
    eng_w, eng_d = port_engine(jeng0), port_engine(jeng0)
    eng_d.cfg = dataclasses.replace(eng_d.cfg, dense_pairs=True)
    sw, sd = eng_w.init_state(seed=6), eng_d.init_state(seed=6)
    for _ in range(4):
        sw, iw = eng_w.safe_step(sw)
        sd, idn = eng_d.safe_step(sd)
        assert iw.num_added == idn.num_added
        assert iw.jkr_max_degree == idn.jkr_max_degree
    assert_same_colony(convert.state_to_numpy(sw), convert.state_to_numpy(sd), "dense",
                       atol=2e-4)


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------


def test_rollout_gradient_matches_jax_and_finite_difference(settled, jax_fits):
    """The gradient of a 2-step rollout's squared Rg error in (adhesion,
    motility) against ``jax.value_and_grad`` of the JAX calibrator's
    rollout: loss rtol 1e-5, gradient rtol 1e-4. Then the gradient of the
    soft contact count against the port's own central finite difference
    of ``evaluate`` (h = 1e-3 of the unconstrained theta) within 15%. Rg
    serves the parity check but not the finite difference: a 1e-3 step in
    adhesion moves it by ~4 float32 ulps, so one ulp of rounding moves
    that estimate by ~25% (JAX's own lands 2% off, the port's 28%); the
    contact count moves by hundreds of its ulps."""
    jeng, _ = settled
    cal = port_calibrator(jeng, tcal.squared_error(tcal.radius_of_gyration, TARGET_RG))
    state = port_state(jax_fits["state"])
    theta = cal.theta0()
    (loss, _), grad = cal._value_and_grad(theta, state, cal._grad_cfg(cal.engine.cfg))
    np.testing.assert_allclose(float(loss), jax_fits["loss"], rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), jax_fits["grad"], rtol=1e-4)
    cal = port_calibrator(jeng, tcal.soft_contact_count(10.0, 1.0))
    (_, _), grad = cal._value_and_grad(theta, state, cal._grad_cfg(cal.engine.cfg))
    assert bool(torch.isfinite(grad).all()) and float(grad.abs().min()) > 0
    for i, name in enumerate(NAMES):
        h = torch.zeros_like(theta)
        h[i] = 1e-3
        fd = (cal.evaluate(theta + h, state) - cal.evaluate(theta - h, state)) / 2e-3
        ad = float(grad[i])
        assert abs(ad - fd) <= 0.15 * max(abs(ad), abs(fd)), (name, ad, fd)


@pytest.mark.parametrize("dense", [False, True])
def test_remat_is_primal_identical_and_grad_equal(settled, dense):
    """``remat`` (per step) and ``remat_substeps`` (per contact substep), on
    and off, on both contact scans: the loss bit-identical and the
    gradients equal bit for bit (the recompute replays the forward)."""
    jeng, d = settled
    cal = port_calibrator(jeng, tcal.radius_of_gyration)
    state, theta = port_state(d), cal.theta0()
    base = dataclasses.replace(cal.engine.cfg, dense_pairs=dense)
    results = []
    for remat in (False, True):
        for substeps in (False, True):
            cal.remat = remat
            cfg = dataclasses.replace(base, remat_substeps=substeps)
            (loss, _), grad = cal._value_and_grad(theta, state, cfg)
            results.append((float(loss), grad))
    for loss, grad in results[1:]:
        assert loss == results[0][0]
        assert torch.equal(grad, results[0][1]), (grad, results[0][1])


def test_remat_substeps_keeps_no_substep_rows_after_forward(settled, monkeypatch):
    """Under the per-step checkpoint, ``remat_substeps`` holds no contact
    substep's rows once the rollout's forward is done (the step's
    recompute makes them again): a substep checkpoint that held its rows
    by reference kept every substep's for the whole graph."""
    from hipsc_abm_tpu_torch import engine as teng

    jeng, d = settled
    cal = port_calibrator(jeng, tcal.radius_of_gyration)
    state, theta = port_state(d), cal.theta0().requires_grad_(True)
    refs, substep = [], teng._id_list_substep

    def recorded(*args):
        out = substep(*args)
        refs.extend(weakref.ref(out[0][k]) for k in ("loc", "partners"))
        return out

    monkeypatch.setattr(teng, "_id_list_substep", recorded)
    cfg = dataclasses.replace(cal._grad_cfg(cal.engine.cfg), remat_substeps=True)
    loss, _ = cal._rollout(cal._bio_with(theta), state, cfg, plain=True)
    assert refs and not [r for r in refs if r() is not None]
    loss.backward()
    assert bool(torch.isfinite(theta.grad).all())


def test_gradient_finite_with_coincident_cells(settled):
    """The NaN guards: two live cells at one position (a self-distance of
    0 in the pair law) leave the loss and the gradient finite."""
    jeng, d = settled
    d = {**d, "arrays": dict(d["arrays"])}
    alive = np.nonzero(d["alive"])[0]
    locs = d["arrays"]["locations"].copy()
    locs[alive[1]] = locs[alive[0]]
    d["arrays"]["locations"] = locs
    cal = port_calibrator(jeng, tcal.squared_error(tcal.radius_of_gyration, TARGET_RG))
    (loss, _), grad = cal._value_and_grad(cal.theta0(), port_state(d),
                                          cal._grad_cfg(cal.engine.cfg))
    assert bool(torch.isfinite(loss)) and bool(torch.isfinite(grad).all()), (loss, grad)


def test_rejects_unknown_and_gated_and_nondifferentiable_names(settled):
    jeng, d = settled
    state = port_state(d)
    with pytest.raises(ValueError, match="not calibratable"):
        port_calibrator(jeng, tcal.radius_of_gyration, names=["max_radius"])
    with pytest.raises(ValueError, match="enable_stochastic"):
        port_calibrator(jeng, tcal.radius_of_gyration, names=["GATA6_prob"])
    cal = tcal.Calibrator(port_engine(jeng, enable_stochastic=True), ["GATA6_prob"],
                          tcal.radius_of_gyration)
    with pytest.raises(ValueError, match="fit_es"):
        cal.fit(state, iters=1)
    with pytest.raises(ValueError, match="horizon"):
        port_calibrator(jeng, tcal.radius_of_gyration, horizon=0)
    cal2 = port_calibrator(jeng, tcal.radius_of_gyration, names=["adhesion_const"])
    with pytest.raises(ValueError, match="iters"):
        cal2.fit(state, iters=0)
    with pytest.raises(ValueError, match="iters"):
        cal2.fit_es(state, iters=0, popsize=2)
    with pytest.raises(ValueError, match="popsize"):
        cal2.fit_es(state, iters=1, popsize=3)
    assert tcal.SEARCHABLE == jcal.SEARCHABLE and tcal.DIFFERENTIABLE == jcal.DIFFERENTIABLE
    assert tcal._REQUIRES_FLAG == jcal._REQUIRES_FLAG and tcal._LOGIT == jcal._LOGIT


def test_calibrator_selects_paths_as_jax_does(settled):
    """The id-list contact path is forced, ``dense_pairs`` auto-selected at
    capacity <= 4096 (off above it, or when the caller says so), and the
    gradient evaluation's config is windowed, with the engine's
    ``remat_substeps``."""
    jeng, _ = settled
    eng = port_engine(jeng, contact_path="span_mask")
    cal = tcal.Calibrator(eng, ["adhesion_const"], tcal.radius_of_gyration)
    assert eng.cfg.contact_path == "id_list" and eng.cfg.dense_pairs
    assert not cal._grad_cfg(eng.cfg).dense_pairs and not cal._grad_cfg(eng.cfg).remat_substeps
    on = dataclasses.replace(eng.cfg, remat_substeps=True)
    assert cal._grad_cfg(on).remat_substeps and not cal._grad_cfg(on).dense_pairs
    big = port_engine(jeng)
    big.cfg = dataclasses.replace(big.cfg, capacity=4352)
    tcal.Calibrator(big, ["adhesion_const"], tcal.radius_of_gyration)
    assert not big.cfg.dense_pairs
    off = port_engine(jeng)
    tcal.Calibrator(off, ["adhesion_const"], tcal.radius_of_gyration, dense_pairs=False)
    assert not off.cfg.dense_pairs


# ---------------------------------------------------------------------------
# ES draws and the optimiser
# ---------------------------------------------------------------------------

RNG_CASES = [(0, (8, 2)), (1, (4, 1)), (3, (100000,)), (17, (257, 3))]


@pytest.mark.parametrize("seed,shape", RNG_CASES)
def test_random_uniform_and_normal_match_jax(seed, shape):
    """``random_uniform`` and ``random_normal`` bit-equal to
    ``jax.random.uniform`` and ``jax.random.normal``, from a split key."""
    jkey = jax.random.split(jax.random.PRNGKey(seed))[1]
    tkey = torch.from_numpy(np.asarray(jkey).astype(np.int64))
    np.testing.assert_array_equal(trng.random_uniform(tkey, shape).numpy(),
                                  np.asarray(jax.random.uniform(jkey, shape)))
    got, want = trng.random_normal(tkey, shape).numpy(), np.asarray(jax.random.normal(jkey, shape))
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _normal_uniforms(lo: int, hi: int) -> torch.Tensor:
    """``jax.random.normal``'s uniforms on (nextafter(-1, 0), 1) of the
    23-bit mantissas [lo, hi), as ``random_uniform`` makes them."""
    low = np.nextafter(np.float32(-1.0), np.float32(0.0))
    floats = (torch.arange(lo, hi, dtype=torch.int32) | 0x3F800000).view(torch.float32) - 1.0
    out = floats * float(np.float32(1.0) - low) + float(low)
    return torch.clamp(out, min=float(low))


@pytest.mark.parametrize("quarter", range(4))
def test_erf_inv_and_log1p_match_xla_over_all_mantissas(quarter):
    """``log1p_f32`` at ``-(u * u)`` and ``sqrt(2) * erf_inv_f32(u)`` equal
    XLA:CPU's ``jnp.log1p`` and ``jax.random.normal``'s own ``erf_inv``
    product for every one of the 2^23 uniforms ``u`` it draws (a quarter of
    the mantissas per case)."""
    jlog1p = jax.jit(jnp.log1p)
    jnormal = jax.jit(lambda u: jax.lax.erf_inv(u) * np.float32(np.sqrt(2.0)))
    for lo in range(quarter << 21, (quarter + 1) << 21, 1 << 20):
        u = _normal_uniforms(lo, lo + (1 << 20))
        x = -(u * u)
        np.testing.assert_array_equal(trng.log1p_f32(x).numpy().view(np.int32),
                                      np.asarray(jlog1p(x.numpy())).view(np.int32))
        got = trng._SQRT2_F32 * trng.erf_inv_f32(u)
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      np.asarray(jnormal(u.numpy())).view(np.int32))


def test_random_normal_matches_jax_at_scale():
    """One draw of 2^20 normals, bit-equal to ``jax.random.normal``."""
    jkey = jax.random.PRNGKey(123)
    want = np.asarray(jax.random.normal(jkey, (1 << 20,)))
    got = trng.random_normal(torch.from_numpy(np.asarray(jkey).astype(np.int64)), (1 << 20,))
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))


def test_adam_update_matches_optax():
    """Three ``torch.optim.Adam`` updates (the calibrator's default) equal
    ``optax.adam``'s at the same learning rate (b1 0.9, b2 0.999, eps 1e-8
    both), to float32 rounding."""
    theta0 = np.array([-9.1, -19.9, 0.3], np.float32)
    grads = np.array([[0.5, -2.0, 1e-3], [0.4, -1.0, -2e-3], [-0.3, 3.0, 0.0]], np.float32)
    opt = optax.adam(0.05)
    jt = jnp.asarray(theta0)
    state = opt.init(jt)
    tt = torch.from_numpy(theta0.copy()).requires_grad_(True)
    topt = torch.optim.Adam([tt], lr=0.05)
    for g in grads:
        updates, state = opt.update(jnp.asarray(g), state, jt)
        jt = optax.apply_updates(jt, updates)
        tt.grad = torch.from_numpy(g.copy())
        topt.step()
    np.testing.assert_allclose(tt.detach().numpy(), np.asarray(jt), rtol=1e-6)


# ---------------------------------------------------------------------------
# fits
# ---------------------------------------------------------------------------


def test_fit_matches_jax(settled, jax_fits):
    """3 iterations of ``fit`` (Adam, lr 0.1): loss history and fitted
    parameters allclose to the JAX calibrator's (rtol 1e-5)."""
    jeng, d = settled
    cal = port_calibrator(jeng, tcal.squared_error(tcal.radius_of_gyration, TARGET_RG))
    res = cal.fit(port_state(d), iters=3, learning_rate=0.1)
    want = jax_fits["fit"]
    np.testing.assert_allclose(res.loss_history, want.loss_history, rtol=1e-5)
    for n in NAMES:
        np.testing.assert_allclose(res.params[n], want.params[n], rtol=1e-5)
    np.testing.assert_allclose(res.theta, np.asarray(want.theta), rtol=1e-5)
    assert res.n_evaluations == want.n_evaluations == 3


def test_fit_es_matches_jax(settled, jax_fits):
    """2 generations of ``fit_es`` (popsize 4, sigma 0.3, seed 1): its
    perturbations bit-equal to the JAX calibrator's (the same ``split``
    chain and ``random_normal``), its loss history and iterates allclose to
    the JAX calibrator's (rtol 4e-6: the rollouts' float32 force sums,
    measured 1.9e-6); the population losses of the same candidates
    allclose to the JAX vmap's (rtol 1e-5) and equal, bit for bit, to each
    candidate's solo rollout (``evaluate``)."""
    jeng, d = settled
    cal = port_calibrator(jeng, tcal.squared_error(tcal.radius_of_gyration, TARGET_RG))
    assert cal.engine.cfg.dense_pairs
    state = cal.prepare(port_state(jax_fits["state"]))
    cands = torch.from_numpy(jax_fits["cands"])
    losses, _ = cal._population(cands, state)
    np.testing.assert_allclose(losses.numpy(), jax_fits["pop_losses"], rtol=1e-5)
    for i in range(cands.shape[0]):
        assert float(losses[i]) == cal.evaluate(cands[i], state), i
    jkey, tkey = jax.random.PRNGKey(1), trng.prng_key(1)
    for _ in range(2):  # fit_es's perturbations, generation by generation
        jkey, jsub = jax.random.split(jkey)
        tkey, tsub = trng.split(tkey, 2)
        want_eps = np.asarray(jax.random.normal(jsub, (2, len(NAMES)), dtype=jnp.float32))
        got_eps = trng.random_normal(tsub, (2, len(NAMES))).numpy()
        np.testing.assert_array_equal(got_eps.view(np.int32), want_eps.view(np.int32))
    res = cal.fit_es(port_state(d), iters=2, popsize=4, sigma=0.3, learning_rate=0.1, seed=1)
    want = jax_fits["es"]
    assert len(res.loss_history) == len(want.loss_history) == 3
    np.testing.assert_allclose(res.loss_history, want.loss_history, rtol=4e-6)
    for n in NAMES:
        np.testing.assert_allclose(res.params[n], want.params[n], rtol=4e-6)
    np.testing.assert_allclose(res.theta, np.asarray(want.theta), rtol=4e-6)
    assert res.n_evaluations == want.n_evaluations == 10


def test_stacked_replicates_match_jax():
    """R = 2 stacked replicates with an ``EnsembleTrajectoryLoss`` (the
    replicate-mean Rg course against a target course): the gradient
    evaluation's loss and gradient against the JAX calibrator's (rtol 1e-5
    and 1e-4), and the population of the same stacked state equal to the
    solo ``evaluate`` bit for bit."""
    course = [95.0, 94.5]
    make_loss = lambda m: m.ensemble_trajectory(  # noqa: E731
        m.trajectory_squared_error(m.radius_of_gyration, course))
    jeng = jax_engine()
    jcalib = jcal.Calibrator(jeng, ["adhesion_const"], make_loss(jcal), horizon=2)
    jstates = jcalib.prepare(JaxEnsembleEngine(jeng).init_states(seeds=[0, 1]))
    ((jloss, _), jgrad), jstates = jcalib._eval_with_growth(0, jcalib.theta0(), jstates)

    cal = tcal.Calibrator(port_engine(jeng), ["adhesion_const"], make_loss(tcal), horizon=2)
    states = cal.prepare(convert.states_from_numpy(convert.numpy_from_jax_states(jstates),
                                                   "cpu"))
    theta = cal.theta0()
    ((loss, _), grad), states = cal._eval_with_growth(
        lambda st: cal._vg_with_probes(theta, st), states)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=1e-4)
    losses, _ = cal._population(theta[None, :], states)
    assert float(losses[0]) == cal.evaluate(theta, states)


def test_fit_with_capacity_growth_ends_with_jax_config():
    """A colony one slot short of its first division (240 + 15 cells at
    capacity 256): the fit's rollouts grow the capacity, and the port ends
    with the JAX calibrator's grown config and loss history."""
    gen = JaxGeneralParams(num_to_start=240, end_step=5, size=(300.0, 300.0, 0.0))
    jeng = jax_engine(gen, capacity=256)
    jstate = jeng.init_state(seed=2)
    loss_j = jcal.squared_error(jcal.radius_of_gyration, TARGET_RG)
    want = jcal.Calibrator(jeng, ["adhesion_const"], loss_j, horizon=2).fit(
        jstate, iters=2, learning_rate=0.1)
    teng = port_engine(jax_engine(gen, capacity=256))
    cal = tcal.Calibrator(teng, ["adhesion_const"],
                          tcal.squared_error(tcal.radius_of_gyration, TARGET_RG), horizon=2)
    res = cal.fit(port_state(convert.numpy_from_jax_state(jstate)), iters=2,
                  learning_rate=0.1)
    assert jeng.cfg.capacity > 256
    assert (teng.cfg.capacity, teng.cfg.bond_cap, teng.cfg.div_cap) == (
        jeng.cfg.capacity, jeng.cfg.bond_cap, jeng.cfg.div_cap)
    np.testing.assert_allclose(res.loss_history, want.loss_history, rtol=1e-5)


def test_example_runs_small_on_cpu(capsys):
    """The port's ``examples/calibrate.py`` at 2 iterations of each fit on a
    60-cell colony on the CPU: both fits run, with finite losses."""
    from hipsc_abm_tpu_torch.examples import calibrate as example

    out = example.main(device="cpu", cells=60, horizon=2, iters=2, es_iters=2, popsize=4)
    assert len(out["gradient"].loss_history) == 2
    assert len(out["es"].loss_history) == 3 and out["es"].n_evaluations == 10
    for res in out.values():
        assert np.all(np.isfinite(res.loss_history))
    assert "recovered GATA6_prob" in capsys.readouterr().out
