"""PyTorch port: ``HipscEngine.run_steps`` blocks, the step without host
reads and ``output_interval`` on the CPU, against the port's own
``safe_step`` and against the JAX package.

- ``run_steps(k)`` equals k ``safe_step``s bit for bit on both contact
  paths, also when a capacity grows inside the block (the whole block
  re-executes), and stacks every probe to a leading (k,) axis;
- it matches the JAX engine's ``run_steps`` (``use_pallas=False``) by agent
  id: integer state and bond sets exact, positions within the step tests'
  1e-3 um, window rebuilds per step equal;
- the step keys derived on the host (``split_words``, ``step_inputs``), the
  tensor path of ``split`` and ``hash_bits`` and JAX agree bit for bit;
- the drift test compares in float32, as JAX's ``lax.cond`` predicate does,
  and the rebuilds fire on JAX's substeps at a skin whose threshold is not a
  float32 (13.3 um);
- a span-mask step whose mask capacity is too small reports the widest row,
  and the grown re-execution equals a step with ample capacity;
- the lifecycle with ``output_interval: 3``: the colony of the per-step
  run, outputs on block boundaries only, a resume from a block boundary,
  and the JAX model's blocked run's values CSVs.
"""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from hipsc_abm_tpu import engine as jeng_mod
from hipsc_abm_tpu.engine import HipscEngine as JaxEngine
from hipsc_abm_tpu.models.hipsc import CellSimulation as JaxCellSimulation
from hipsc_abm_tpu.models.params import BiologyParams, ExperimentalParams, GeneralParams
from hipsc_abm_tpu.ops import neighbors as jnbr
from hipsc_abm_tpu.ops import rng as jrng
from hipsc_abm_tpu_torch import convert
from hipsc_abm_tpu_torch import engine as teng_mod
from hipsc_abm_tpu_torch.engine import HipscEngine
from hipsc_abm_tpu_torch.models.hipsc import CellSimulation
from hipsc_abm_tpu_torch.ops import rng as trng
from hipsc_abm_tpu_torch.ops.neighbors import GridSpec
from hipsc_abm_tpu_torch.params import DiffusionParams

PATHS = ("id_list", "span_mask")
INT_FIELDS = ("FGF4", "FGFR", "ERK", "GATA6", "NANOG", "states", "death_counters",
              "diff_counters", "div_counters", "fds_counters")
BIO = BiologyParams()


def _by_id(d: dict) -> dict:
    alive = d["alive"]
    order = np.argsort(d["arrays"]["ids"][alive])
    out = {k: v[alive][order] for k, v in d["arrays"].items()}
    partners = np.where(d["bond_mask"], d["partners"], -1)[alive][order]
    out["bonds"] = [frozenset(r[r >= 0].tolist()) for r in partners]
    return out


def _assert_same_colony(got: dict, ref: dict, atol: float, label: str) -> None:
    """By agent id: ids, integer fields and bond sets exact; positions
    bit-equal (``atol`` 0) or within ``atol`` um."""
    a, b = _by_id(got), _by_id(ref)
    np.testing.assert_array_equal(a["ids"], b["ids"], err_msg=f"{label}: ids")
    for k in INT_FIELDS:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{label}: {k}")
    assert a["bonds"] == b["bonds"], f"{label}: bond sets"
    if atol == 0:
        np.testing.assert_array_equal(a["locations"].view(np.int32),
                                      b["locations"].view(np.int32), err_msg=label)
        np.testing.assert_array_equal(a["radii"].view(np.int32), b["radii"].view(np.int32))
    else:
        np.testing.assert_allclose(a["locations"], b["locations"], rtol=0, atol=atol,
                                   err_msg=f"{label}: locations")


def _engine(path, n=300, side=420.0, **cfg):
    gen = GeneralParams(num_to_start=n, end_step=20, size=(side, side, 0.0))
    xp = ExperimentalParams(num_gata6=n // 10, dox_step=2)
    eng = HipscEngine(convert.params_from_jax(gen), convert.params_from_jax(xp), device="cpu",
                      contact_path=path)
    eng.cfg = dataclasses.replace(eng.cfg, **cfg)
    return eng


# ---------------------------------------------------------------------------
# run_steps against safe_step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", PATHS)
def test_run_steps_equals_safe_steps(path):
    """6 steps as one block against 6 ``safe_step``s from one state, both
    engines starting at a bond capacity of 2 (and, on the span-mask path, a
    mask capacity of 16 candidates) that the first steps outgrow: the block
    re-executes whole from its input and ends on the same colony, key and
    step, with the same probes step by step."""
    tight = dict(bond_cap=2, mask_bits=16 if path == "span_mask" else 0)
    a, b = _engine(path, **tight), _engine(path, **tight)
    s0 = a.init_state(seed=7)
    sa, infos = s0, []
    for _ in range(6):
        sa, info = a.safe_step(sa)
        infos.append(info)
    d0 = convert.state_to_numpy(s0)
    sb, block = b.run_steps(s0, 6)
    assert b.block_attempts > 1 and b.cfg.bond_cap > 2
    assert (b.cfg.bond_cap, b.cfg.mask_bits, b.cfg.capacity) == (
        a.cfg.bond_cap, a.cfg.mask_bits, a.cfg.capacity)
    if path == "span_mask":
        assert b.cfg.mask_bits > 16 and b.cfg.mask_bits % 32 == 0
    # the input state is left as it was
    for k, v in convert.state_to_numpy(s0)["arrays"].items():
        np.testing.assert_array_equal(v, d0["arrays"][k])
    for name in block._fields:
        col = getattr(block, name)
        assert isinstance(col, np.ndarray) and col.shape == (6,), name
        np.testing.assert_array_equal(col, [getattr(i, name) for i in infos], err_msg=name)
    assert int(block.jkr_span_needed.min()) > 0 and int(block.nbr_span_needed.min()) > 0
    da, db = convert.state_to_numpy(sa), convert.state_to_numpy(sb)
    _assert_same_colony(db, da, 0, f"run_steps[{path}]")
    for k in ("key", "step", "next_id"):
        np.testing.assert_array_equal(db[k], da[k], err_msg=k)


def test_run_steps_rejects_an_empty_block():
    eng = _engine("id_list")
    with pytest.raises(ValueError):
        eng.run_steps(eng.init_state(seed=0), 0)


@pytest.mark.parametrize("changed", ["cfg", "gen", "xp", "bio", "diff"])
def test_block_graphs_are_keyed_by_config_and_parameters(monkeypatch, changed):
    """A captured block holds the config's and the parameters' values as
    launch constants, so ``_graph_for`` finds a graph by ``(k, config, gen,
    xp, bio, diff)``: the same key finds the same graph, and a block after
    the caller replaced one of them is captured anew while the graphs of
    the old values are dropped. The capture is stood in for (no card)."""
    made = []

    class Capture:
        def __init__(self, engine, cfg, k, state):
            made.append(k)

    monkeypatch.setattr(teng_mod, "_BlockGraph", Capture)
    eng = _engine("id_list")
    state = eng.init_state(seed=0)
    cfg = eng._cfg_for_state(state)
    block, one = eng._graph_for(cfg, 2, state), eng._graph_for(cfg, 1, state)
    assert eng._graph_for(cfg, 2, state) is block and made == [2, 1]
    if changed == "cfg":
        cfg = dataclasses.replace(cfg, div_cap=cfg.div_cap * 2)
    elif changed == "diff":
        eng.diff = DiffusionParams(release_amount=0.5)
    else:
        old = getattr(eng, changed)
        field = {"gen": "end_step", "xp": "dox_step", "bio": "death_thresh"}[changed]
        setattr(eng, changed, dataclasses.replace(old, **{field: getattr(old, field) + 1}))
    again = eng._graph_for(cfg, 2, state)
    assert again is not block and made == [2, 1, 2]
    assert list(eng._graphs.values()) == [again]


# ---------------------------------------------------------------------------
# against the JAX engine
# ---------------------------------------------------------------------------


def _jax_rebuild_recorder(monkeypatch, jcfg):
    """Record the JAX XLA scan's contact-window builds ("B", ``sorted_window``
    on the contact spec) and its Stokes updates ("S", one per substep) in
    execution order, through debug callbacks. A build inside the drift
    ``lax.cond`` runs only where the branch is taken."""
    events = []
    real_window, real_stokes = jnbr.sorted_window, jeng_mod.stokes_integrate

    def window(spec, *args, **kwargs):
        if spec == jcfg.jkr_spec:
            jax.debug.callback(lambda: events.append("B"), ordered=True)
        return real_window(spec, *args, **kwargs)

    def stokes(*args, **kwargs):
        out = real_stokes(*args, **kwargs)
        jax.debug.callback(lambda: events.append("S"), ordered=True)
        return out

    monkeypatch.setattr(jnbr, "sorted_window", window)
    monkeypatch.setattr(jeng_mod, "stokes_integrate", stokes)
    return events


def _substep_rebuilds(events, substeps):
    """Per step, the substeps (1..) before which the window was rebuilt, from
    the recorded event stream (each step: its entry build, then per substep
    an optional rebuild and one Stokes update)."""
    steps, i = [], 0
    while i < len(events):
        assert events[i] == "B", events[i:i + 3]  # the step's entry build
        i += 1
        fired = []
        for s in range(substeps):
            if events[i] == "B":
                fired.append(s)
                i += 1
            assert events[i] == "S"
            i += 1
        steps.append(fired)
    return steps


def _port_rebuild_recorder(monkeypatch):
    """The port's drift decisions, one list per scan (every substep after
    the first), recorded where the scan calls the rebuild it chose
    (``_scan_rebuild``), whichever form it is."""
    scans = []
    real = teng_mod._scan_rebuild

    def scan_rebuild(*args):
        rebuild = real(*args)

        def recorded(s, stale, *rest):
            # the drift flag of the update before this substep (ops.integrate)
            scans[-1].append(bool(stale))
            return rebuild(s, stale, *rest)

        return recorded

    real_build = teng_mod._build_window

    def build(cfg, rows):
        scans.append([])
        return real_build(cfg, rows)

    monkeypatch.setattr(teng_mod, "_scan_rebuild", scan_rebuild)
    monkeypatch.setattr(teng_mod, "_build_window", build)
    return scans


def _jax_and_port(path, skin=None, n=300, side=420.0, seed=7):
    gen = GeneralParams(num_to_start=n, end_step=20, size=(side, side, 0.0))
    xp = ExperimentalParams(num_gata6=n // 10, dox_step=2)
    jeng = JaxEngine(gen, xp, use_pallas=False)
    teng = HipscEngine(convert.params_from_jax(gen), convert.params_from_jax(xp),
                       device="cpu", contact_path=path)
    # the XLA path's law, the general one
    teng.cfg = dataclasses.replace(teng.cfg, uniform_radius=None)
    if skin is not None:
        reach = BIO.jkr_radius + 2.0 * BIO.jkr_break_band + skin
        jeng.cfg = dataclasses.replace(jeng.cfg, verlet_skin=skin, jkr_spec=jnbr.GridSpec.from_box(
            gen.size, reach, jeng.cfg.jkr_spec.run_cap))
        teng.cfg = dataclasses.replace(teng.cfg, verlet_skin=skin,
                                       jkr_spec=GridSpec.from_box(gen.size, reach, 0))
    assert (teng.cfg.capacity, teng.cfg.div_cap, teng.cfg.bond_cap) == (
        jeng.cfg.capacity, jeng.cfg.div_cap, jeng.cfg.bond_cap)
    assert dataclasses.asdict(jeng.cfg.jkr_spec) | {"run_cap": 0} == dataclasses.asdict(
        teng.cfg.jkr_spec)
    return jeng, teng, jeng.init_state(seed=seed), teng.init_state(seed=seed)


@pytest.mark.parametrize("path", PATHS)
def test_run_steps_matches_jax(path, monkeypatch):
    """A 4-step block of the port against the JAX engine's ``run_steps`` on
    its XLA path from one numpy-seeded state: by agent id, integer state and
    bond sets exact, positions within 1e-3 um; the window rebuilds of each
    step on the substeps where JAX's ``lax.cond`` took its rebuild branch."""
    k = 4
    jeng, teng, js, ts = _jax_and_port(path)
    events = _jax_rebuild_recorder(monkeypatch, jeng.cfg)
    scans = _port_rebuild_recorder(monkeypatch)
    js, jinfo = jeng.run_steps(js, k)
    jax.effects_barrier()
    ts, tinfo = teng.run_steps(ts, k)
    n_sub = len(teng_mod._physics_dts(teng.bio))
    jfired = _substep_rebuilds(events, n_sub)[-k:]  # a re-executed block records twice
    tfired = [[s + 1 for s, hit in enumerate(scan) if hit] for scan in scans[-k:]]
    assert tfired == jfired
    np.testing.assert_array_equal(tinfo.jkr_rebuilds, [len(f) for f in jfired])
    assert sum(map(len, jfired)) > 0
    for name in ("num_agents", "num_added", "num_removed", "jkr_max_degree"):
        np.testing.assert_array_equal(getattr(tinfo, name), np.asarray(getattr(jinfo, name)),
                                      err_msg=name)
    _assert_same_colony(convert.state_to_numpy(ts), convert.numpy_from_jax_state(js), 1e-3,
                        f"run_steps[{path}] vs JAX")
    assert ts.step == int(js.step)
    np.testing.assert_array_equal(ts.key.numpy(), np.asarray(js.key).astype(np.int64))


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------


def test_keys_as_tensors_match_host_words_and_jax():
    """``split`` on a key tensor, ``split_words`` on Python ints and
    ``jax.random.split`` give the same keys (10^5 of them); ``hash_bits``
    keyed by a tensor and by the words agrees with JAX over 10^5 ids; the
    engine's ``step_inputs`` table is JAX's per-step key chain."""
    jkey = jax.random.PRNGKey(2024)
    tkey = trng.prng_key(2024)
    want = np.asarray(jax.random.split(jkey, 100_000)).astype(np.int64)
    np.testing.assert_array_equal(torch.stack(trng.split(tkey, 100_000)).numpy(), want)
    words = tuple(int(w) for w in tkey)
    np.testing.assert_array_equal(np.asarray(trng.split_words(words, 2000)), want[:2000])

    ids = np.random.default_rng(5).integers(0, 2**31 - 1, 100_000).astype(np.int32)
    sub = torch.from_numpy(want[3])
    expect = np.asarray(jrng.hash_bits(jnp.asarray(want[3].astype(np.uint32)),
                                       jnp.asarray(ids), 2)).astype(np.int64)
    tids = torch.from_numpy(ids)
    np.testing.assert_array_equal(trng.hash_bits(sub, tids, 2).numpy(), expect)
    np.testing.assert_array_equal(
        trng.hash_bits(tuple(int(w) for w in sub), tids, 2).numpy(), expect)

    table, keys = teng_mod.step_inputs(tkey, 5, k=8)
    assert table.shape == (8, 13) and table.dtype == torch.int64
    jk = jkey
    for t in range(8):
        split = np.asarray(jax.random.split(jk, 6)).astype(np.int64)
        np.testing.assert_array_equal(table[t, :12].numpy(), split.reshape(-1))
        assert int(table[t, 12]) == 5 + t
        np.testing.assert_array_equal(keys[t].numpy(), split[0])
        jk = jnp.asarray(split[0].astype(np.uint32))


# ---------------------------------------------------------------------------
# the drift test in float32
# ---------------------------------------------------------------------------


def _drift_at(x: np.float32):
    """Rows of one agent ``x`` um along x from its window reference."""
    rows = {"loc": torch.tensor([[float(x), 0.0, 0.0]], dtype=torch.float32),
            "alive": torch.tensor([True])}
    return rows, torch.zeros((1, 3), dtype=torch.float32)


def _port_stale(cfg, rows, ref):
    """The port's drift test, the flag of a substep's update
    (``ops.integrate.update_plain``), for rows that do not move."""
    from hipsc_abm_tpu_torch.ops.integrate import update_plain

    zero = torch.zeros_like(rows["loc"])
    return update_plain(rows["loc"], torch.ones(1), zero, zero, rows["alive"], ref,
                        torch.full((3,), 1e9), stokes=1.0, dt=1.0, folded=False,
                        threshold=teng_mod.drift_threshold(cfg.verlet_skin))[3]


@pytest.mark.parametrize("skin", [13.3, 13.6])
def test_drift_threshold_compares_in_float32(skin):
    """The drift test against JAX's predicate ``drift2 > (skin/2)**2`` (a
    float32 array against a weak-typed scalar: compared in float32) at the
    float32 drifts around the threshold. At 13.6 um the float32 threshold
    lies above the float64 one, and a drift of exactly that float32 value
    is stale in float64 but not in JAX."""
    t64 = (skin * 0.5) ** 2
    t32 = np.float32(t64)
    assert float(t32) != t64  # (skin/2)^2 is not a float32
    assert teng_mod.drift_threshold(skin) == float(t32)
    cfg = dataclasses.replace(_engine("id_list").cfg, verlet_skin=skin)
    x0 = np.float32(np.sqrt(t64))
    seen_exact = False
    for d in range(-12, 13):
        x = x0
        for _ in range(abs(d)):
            x = np.nextafter(x, np.float32(np.inf if d > 0 else -np.inf))
        rows, ref = _drift_at(x)
        drift2 = np.float32(x) * np.float32(x)
        jax_stale = bool(jnp.max(jnp.where(jnp.asarray([True]), jnp.sum(
            (jnp.asarray([[x, 0.0, 0.0]], jnp.float32) - 0.0) ** 2, axis=-1), 0.0)) > t64)
        assert bool(_port_stale(cfg, rows, ref)) == jax_stale, (skin, x)
        if drift2 == t32:
            seen_exact = True
            assert not jax_stale
            if skin == 13.6:  # the float64 comparison the port made before
                assert float(drift2) > t64
    assert seen_exact


def test_rebuild_substeps_match_jax_at_skin_13_3(monkeypatch):
    """Three steps at a 13.3 um skin (threshold 44.2225 um^2, not a
    float32): the port rebuilds its window before the substeps JAX's
    ``lax.cond`` does, in every step."""
    jeng, teng, js, ts = _jax_and_port("id_list", skin=13.3)
    events = _jax_rebuild_recorder(monkeypatch, jeng.cfg)
    scans = _port_rebuild_recorder(monkeypatch)
    for _ in range(3):
        js, _ = jeng.safe_step(js)
        ts, _ = teng.safe_step(ts)
    jax.effects_barrier()
    n_sub = len(teng_mod._physics_dts(teng.bio))
    jfired = _substep_rebuilds(events, n_sub)
    tfired = [[s + 1 for s, hit in enumerate(scan) if hit] for scan in scans]
    assert tfired == jfired and sum(map(len, jfired)) > 0
    _assert_same_colony(convert.state_to_numpy(ts), convert.numpy_from_jax_state(js), 1e-3,
                        "skin 13.3")


# ---------------------------------------------------------------------------
# the span-mask capacity
# ---------------------------------------------------------------------------


def test_mask_capacity_overflow_reports_and_regrows():
    """A dense colony (300 cells in 200 x 200 um, rows of some 70
    candidates): a span-mask step at a capacity of 32 candidates reports its
    widest row, ``safe_step`` grows the capacity by the JAX rule (x1.25,
    rounded up to a word) and re-executes, and the result equals the step
    at an ample capacity bit for bit."""
    small = _engine("span_mask", side=200.0, mask_bits=32)
    ample = _engine("span_mask", side=200.0, mask_bits=1024)
    s0 = small.init_state(seed=3)
    s0, _ = ample.safe_step(s0)  # bonds to carry
    small.cfg = dataclasses.replace(ample.cfg, mask_bits=32)
    _, raw = small.step(s0)
    need = int(raw.jkr_span_needed)
    assert need > 32
    s_small, info = small.safe_step(s0)
    assert small.cfg.mask_bits == ((int(need * 1.25) + 31) // 32) * 32
    assert info.jkr_span_needed == need
    s_ample, _ = ample.safe_step(s0)
    _assert_same_colony(convert.state_to_numpy(s_small), convert.state_to_numpy(s_ample), 0,
                        "grown mask capacity")


def test_mask_capacity_is_derived_and_kept_in_meta():
    """A config without ``mask_bits`` (a JAX checkpoint, or one from before
    the field) derives it from the state at the first step; the meta
    round-trips it."""
    eng = _engine("span_mask", side=200.0)
    assert eng.cfg.mask_bits == 0
    state = eng.init_state(seed=1)
    want = teng_mod.initial_mask_bits(eng.cfg, state)
    eng.step(state)
    assert eng.cfg.mask_bits == want > 0 and want % 32 == 0
    meta = teng_mod.config_to_meta(eng.cfg)
    assert teng_mod.config_from_meta(meta) == eng.cfg
    assert teng_mod.config_from_meta({k: v for k, v in meta.items()
                                      if k != "mask_bits"}).mask_bits == 0


# ---------------------------------------------------------------------------
# the lifecycle's output_interval
# ---------------------------------------------------------------------------

GENERAL = {
    "num_to_start": 80, "cuda": False, "end_step": 6, "size": [200, 200, 0],
    "output_values": True, "output_images": False, "record_initial_step": True,
    "image_quality": 100, "video_quality": 80, "fps": 5, "seed": 0,
}
EXPERIMENTAL = {
    "num_gata6": 8, "output_tda": False, "output_gradients": False, "group": 0,
    "dox_step": 1, "guye_move": True, "lonely_thresh": 2, "color_mode": True,
}


def _run(root, argv, cls=CellSimulation, general=None, **kwargs):
    """Templates under ``root`` (once), then ``cls.start`` into
    ``root/outputs``."""
    if not (root / "templates").exists():
        (root / "templates").mkdir(parents=True)
        (root / "outputs").mkdir()
    (root / "templates" / "general.yaml").write_text(yaml.dump({**GENERAL, **(general or {})}))
    (root / "templates" / "experimental.yaml").write_text(yaml.dump(EXPERIMENTAL))
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root)
        mp.setenv("HIPSC_NO_NATIVE_IO", "1")  # the JAX package's Python writers (C1)
        return cls.start(str(root / "outputs") + os.sep, argv=argv, **kwargs)


def _values(run_dir, name, step):
    path = os.path.join(run_dir, f"{name}_values", f"{name}_values_{step}.csv")
    with open(path) as f:
        header = f.readline().strip().split(",")
    return header, np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)


@pytest.fixture(scope="module")
def blocked_runs(tmp_path_factory):
    """The port per step and with ``output_interval: 3`` to step 6."""
    per_step = tmp_path_factory.mktemp("per_step")
    blocked = tmp_path_factory.mktemp("blocked")
    a = _run(per_step, ["-n", "a", "-m", "0"], device="cpu")
    b = _run(blocked, ["-n", "b", "-m", "0"], general={"output_interval": 3}, device="cpu")
    return dict(a=a, b=b, a_dir=per_step / "outputs" / "a", b_dir=blocked / "outputs" / "b")


def test_output_interval_blocks_match_per_step(blocked_runs):
    """``output_interval: 3`` runs two 3-step blocks: the colony equals the
    per-step run's bit for bit, the values CSVs exist at the initial step and
    the block boundaries only, each equal to the per-step run's, and the
    data CSV has its header and one row per block."""
    a, b = blocked_runs["a"], blocked_runs["b"]
    assert b.current_step == a.current_step == 6 and b.number_agents == a.number_agents
    _assert_same_colony(convert.state_to_numpy(b.state), convert.state_to_numpy(a.state), 0,
                        "blocked vs per step")
    for step in range(7):
        exists = os.path.isfile(os.path.join(blocked_runs["b_dir"], "b_values",
                                             f"b_values_{step}.csv"))
        assert exists == (step in (0, 3, 6)), step
    for step in (3, 6):
        ha, va = _values(blocked_runs["a_dir"], "a", step)
        hb, vb = _values(blocked_runs["b_dir"], "b", step)
        assert ha == hb
        np.testing.assert_array_equal(va, vb)
    with open(os.path.join(blocked_runs["b_dir"], "b_data.csv")) as f:
        lines = f.read().splitlines()
    assert lines[0].split(",")[:4] == ["Step Number", "Number Cells", "Step Time",
                                       "Memory (MB)"]
    assert [int(line.split(",")[0]) for line in lines[1:]] == [3, 6]


@pytest.mark.parametrize("pickle", [True, False], ids=["pickle", "npz"])
def test_block_boundary_checkpoint_resumes(tmp_path, blocked_runs, pickle):
    """Mode 0 with blocks to step 3, then mode 1 to step 6, from the pickle
    or (``temp_pickle: false``) the npz written at the boundary: bit-equal to
    the blocked run straight to step 6."""
    general = {"output_interval": 3, "end_step": 3, "temp_pickle": pickle}
    _run(tmp_path, ["-n", "r", "-m", "0"], general=general, device="cpu")
    base = tmp_path / "outputs" / "r"
    assert os.path.isfile(base / "r_temp.pkl") == pickle
    sim = _run(tmp_path, ["-n", "r", "-m", "1", "-fs", "6"],
               general={**general, "end_step": 6}, device="cpu")
    assert sim.current_step == 6
    _assert_same_colony(convert.state_to_numpy(sim.state),
                        convert.state_to_numpy(blocked_runs["b"].state), 0, "resumed")
    assert os.path.isfile(base / "r_values" / "r_values_6.csv")
    assert not os.path.isfile(base / "r_values" / "r_values_5.csv")


def test_blocked_run_matches_jax_blocked_run(tmp_path, blocked_runs):
    """The JAX model with ``output_interval: 3`` to step 6: its values CSVs
    at the block boundaries hold the port's blocked run's rows (integer
    columns exact, positions within 1e-3 um), and its npz at step 3 resumes
    in the port, blocked, to the JAX colony at step 6."""
    jsim = _run(tmp_path / "jax", ["-n", "j", "-m", "0"], cls=JaxCellSimulation,
                general={"output_interval": 3})
    jdir = tmp_path / "jax" / "outputs" / "j"
    for step in (3, 6):
        hj, vj = _values(jdir, "j", step)
        hb, vb = _values(blocked_runs["b_dir"], "b", step)
        assert hj == hb and vj.shape == vb.shape
        loc = [i for i, h in enumerate(hb) if h.startswith("locations")]
        ints = [i for i in range(len(hb)) if i not in loc]
        np.testing.assert_array_equal(vb[:, ints], vj[:, ints])
        np.testing.assert_allclose(vb[:, loc], vj[:, loc], rtol=0, atol=1e-3)

    _run(tmp_path / "j3", ["-n", "j", "-m", "0"], cls=JaxCellSimulation,
         general={"output_interval": 3, "end_step": 3, "temp_pickle": False})
    port = tmp_path / "port"
    (port / "outputs").mkdir(parents=True)
    (port / "templates").mkdir()
    shutil.copytree(tmp_path / "j3" / "outputs" / "j", port / "outputs" / "j")
    sim = _run(port, ["-n", "j", "-m", "1", "-fs", "6"],
               general={"output_interval": 3, "temp_pickle": False}, device="cpu")
    assert sim.current_step == 6
    _assert_same_colony(convert.state_to_numpy(sim.state),
                        convert.numpy_from_jax_state(jsim.state), 1e-3, "JAX npz resumed")
