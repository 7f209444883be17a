"""The contact window's rebuild inside a scan (``ops.window``,
``csrc/window.cu``): what its kernels rely on, held on the CPU at every
rebuild of real scans, the placement's mirror (``rebuild_plain``) against
``engine._rebuild_where``, and, on the card, the kernels against
``_rebuild_where`` and the scans that run them against the CPU's. Also the
rows' packed form that a single-colony scan carries (``engine._pack_rows``,
kept by the update and the rebuild) and the substep probes its contact
launches reduce into the update's scratch, held at every substep, on the
CPU through the plain mirrors and on the card through the kernels, and the
split of the scans' routes: every single-colony scan that is not ``plain``
takes the route the card runs, on any device."""

import dataclasses

import numpy as np
import pytest
import torch

from hipsc_abm_tpu_torch import colonies, convert, kernels
from hipsc_abm_tpu_torch import engine as engine_mod
from hipsc_abm_tpu_torch.engine import EngineConfig, HipscEngine
from hipsc_abm_tpu_torch.ops import integrate, span_mask, window
from hipsc_abm_tpu_torch.ops.jkr import BondState, pack_physics
from hipsc_abm_tpu_torch.params import BiologyParams, ExperimentalParams, GeneralParams

BIO = BiologyParams()


def _engine(path, dims, deaths, device="cpu", n=300):
    """A small colony on ``path``: the 2D template density with a skin of 2
    um, so that windows go stale every step, or a 3D spheroid. ``deaths``:
    every pluripotent agent is lonely and a third are one step from death,
    so rows die in the step before the scan, amid the live ones."""
    if dims == 2:
        side = 2000.0 * (n / 5000.0) ** 0.5
        gen = GeneralParams(num_to_start=n, end_step=20, size=(side, side, 0.0))
        xp = ExperimentalParams(num_gata6=n // 10, dox_step=1)
        ball = None
    else:
        gen, xp, ball = colonies.spheroid(n, 3)
    if deaths:
        xp = dataclasses.replace(xp, lonely_thresh=100)
    eng = HipscEngine(gen, xp, device=device, contact_path=path)
    if dims == 2:
        skin = 2.0
        reach = BIO.jkr_radius + 2.0 * BIO.jkr_break_band + skin
        eng.cfg = dataclasses.replace(eng.cfg, verlet_skin=skin,
                                      jkr_spec=engine_mod.GridSpec.from_box(gen.size, reach, 0))
    state = eng.init_state(seed=5, locations=ball)
    if deaths:
        a = state.arrays
        doomed = (a["ids"] % 3 == 0).to(torch.int32) * (BIO.death_thresh - 1)
        state = state._replace(arrays={**a, "death_counters": doomed})
    return eng, state


def _clone(rows, bounds, ref, grouping):
    return ({k: v.clone() for k, v in rows.items()}, bounds.clone(), ref.clone(),
            grouping._replace(starts=grouping.starts.clone()))


def _same(a, b) -> bool:
    """Equal dtypes, shapes and bytes (float32 as its bits)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def _assert_rebuilt(got, want, label):
    """``(rows, bounds, ref, grouping)`` of two rebuilds, byte for byte."""
    (rows, bounds, ref, grouping), (w_rows, w_bounds, w_ref, w_grouping) = got, want
    for k in w_rows:
        assert _same(rows[k], w_rows[k]), f"{label}: rows[{k!r}]"
    assert _same(bounds, w_bounds), f"{label}: bounds"
    assert _same(ref, w_ref), f"{label}: ref"
    assert _same(grouping.starts, w_grouping.starts), f"{label}: span starts"
    assert _same(grouping.needed, w_grouping.needed), f"{label}: span probe"


def _mirror(stale, cfg, rows, bounds, ref, grouping, seed):
    """``rebuild_plain`` into copies of the window, its arrivals shuffled
    from ``seed``."""
    rows, bounds, ref, grouping = _clone(rows, bounds, ref, grouping)
    needed = torch.empty((), dtype=torch.int32, device=bounds.device)
    window.rebuild_plain(stale, cfg.jkr_spec, cfg.jkr_span, rows, bounds, ref, grouping,
                         needed, arrival_seed=seed)
    return rows, bounds, ref, grouping._replace(needed=needed)


@pytest.mark.parametrize("deaths", [False, True], ids=["colony", "deaths"])
@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("path", ["id_list", "span_mask"])
def test_every_rebuild_permutes_only_the_live_prefix(path, dims, deaths, monkeypatch):
    """At every rebuild of two steps' scans: ``alive`` is the entry build's,
    its dead rows are exactly the tail ``[n_live, C)``, which has not moved
    since the build, and ``build_grid``'s order is the identity there; and
    the placement's mirror, its arrivals shuffled, equals ``_rebuild_where``
    with the flag set and with it clear. The checks run where the scan
    calls the rebuild it chose (``_scan_rebuild``)."""
    eng, state = _engine(path, dims, deaths)
    real_build, real_choice = engine_mod._build_window, engine_mod._scan_rebuild
    entry, seen = [], {"calls": 0, "taken": 0, "dead_in_prefix_at_entry": 0}

    def build(cfg, rows):
        out = real_build(cfg, rows)
        entry.append(out[0]["alive"].clone())
        alive = rows["alive"]
        seen["dead_in_prefix_at_entry"] += int((~alive[:int(alive.sum())]).sum())
        return out

    def check(cfg, stale, rows, bounds, ref, grouping):
        alive, C = rows["alive"], rows["alive"].shape[0]
        n_live = int(alive.sum())
        assert torch.equal(alive, entry[-1])
        assert bool(alive[:n_live].all()) and not bool(alive[n_live:].any())
        # dead rows do not move: the drift reference's tail is the rows'
        assert torch.equal(ref[n_live:], rows["loc"][n_live:])
        order, _, _ = engine_mod.contact_window(cfg, rows)
        assert torch.equal(order[n_live:], torch.arange(n_live, C))
        for flag in (True, False):
            flag_t = torch.tensor(flag)
            want = engine_mod._rebuild_where(flag_t, cfg, rows, bounds, ref, torch.arange(C),
                                             grouping=grouping)
            got = _mirror(flag_t, cfg, rows, bounds, ref, grouping, seed=seen["calls"])
            _assert_rebuilt(got, want, f"call {seen['calls']}, flag {flag}")
        seen["calls"] += 1
        seen["taken"] += bool(stale)

    def choice(cfg, rows, n_substeps, plain):
        rebuild = real_choice(cfg, rows, n_substeps, plain)

        def checked(s, stale, *window):
            check(cfg, stale, *window)
            return rebuild(s, stale, *window)

        return checked

    monkeypatch.setattr(engine_mod, "_build_window", build)
    monkeypatch.setattr(engine_mod, "_scan_rebuild", choice)
    state, info = eng.run_steps(state, 2)
    n_sub = len(engine_mod._physics_dts(eng.bio))
    assert seen["calls"] == 2 * (n_sub - 1) and len(entry) == 2
    assert seen["taken"] == int(np.sum(info.jkr_rebuilds)) > 0
    if deaths:
        assert int(np.sum(info.num_removed)) > 0
        # the deaths lie amid the live rows in the state's order at entry
        assert seen["dead_in_prefix_at_entry"] > 0


BOX = {2: (200.0, 200.0, 0.0), 3: (120.0, 120.0, 120.0)}


def _window_inputs(dims, C, n_live, seed=0, K=8, device="cpu"):
    """``(cfg, rows, bounds, ref, grouping)``: an entry build over C rows (a
    capacity past 512 that is not a multiple of 128, so that span starts
    clip), n_live of them alive at random slots, then every live row moved:
    48 of them into one bin, 24 onto or past the box's faces (clamped into
    its edge bins), the rest by a normal step of 0.6 bins. Ids are unique
    and unordered."""
    rs = np.random.default_rng(seed)
    box = BOX[dims]
    cfg = EngineConfig.create(box, capacity=1024, bio=BIO)
    cell = cfg.jkr_spec.cell_size
    loc = np.zeros((C, 3), np.float32)
    loc[:, :dims] = rs.uniform(0.0, box[0], (C, dims))
    alive = np.zeros(C, bool)
    alive[rs.permutation(C)[:n_live]] = True

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    rows = {
        "loc": t(loc), "rad": t(rs.uniform(4.0, 6.0, C).astype(np.float32)),
        "mot": t(rs.normal(size=(C, 3)).astype(np.float32)),
        "ids": t(rs.permutation(50 * C)[:C].astype(np.int32)), "alive": t(alive),
        "partners": t(rs.integers(-1, 50 * C, (C, K)).astype(np.int32)),
        "perm": torch.arange(C, dtype=torch.int64, device=device),
    }
    rows, bounds, grouping = engine_mod._build_window(cfg, rows)
    ref = rows["loc"].clone()
    x = rows["loc"][:n_live].cpu().numpy()
    x[:, :dims] += rs.normal(0.0, 0.6 * cell, (n_live, dims)).astype(np.float32)
    k = min(48, n_live)
    x[:k, :dims] = rs.uniform(1.2 * cell, 1.8 * cell, (k, dims))
    e = min(k + 24, n_live)
    x[k:e, 0] = rs.choice(np.float32([0.0, box[0], -7.5, box[0] + 40.0]), e - k)
    x[:, :dims] = np.clip(x[:, :dims], -10.0, box[0] + 50.0)
    rows["loc"] = rows["loc"].clone()
    rows["loc"][:n_live] = t(x)
    return cfg, rows, bounds, ref, grouping


@pytest.mark.parametrize("n_live", [0, 700, 1000])
@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_placement_mirror_equals_rebuild_where(seed, dims, n_live):
    """The mirror (bins counted, their exclusive prefix, rank by key within
    a bin, arrivals shuffled from a seed) against ``_rebuild_where`` with
    the flag set, over a dense bin, clamped edges, no live row and no dead
    one; with the flag clear it changes nothing and carries the probe."""
    cfg, rows, bounds, ref, grouping = _window_inputs(dims, 1000, n_live, seed)
    n_bin = torch.bincount(engine_mod.nbr_ops.build_grid(
        cfg.jkr_spec, rows["loc"], rows["ids"], rows["alive"]).sorted_flat)
    if n_live:
        assert int(n_bin[:cfg.jkr_spec.num_bins].max()) >= 40
    for flag in (True, False):
        stale = torch.tensor(flag)
        want = engine_mod._rebuild_where(stale, cfg, rows, bounds, ref,
                                         torch.arange(1000), grouping=grouping)
        got = _mirror(stale, cfg, rows, bounds, ref, grouping, seed=seed + 10)
        _assert_rebuilt(got, want, f"flag {flag}")
        if not flag:
            _assert_rebuilt(got, (rows, bounds, ref, grouping), "skipped")


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("n_live", [0, 700, 1000])
def test_rebuild_mirror_moves_the_packed_rows(dims, n_live):
    """Rows that carry their packed form (``window.PACKED``): the mirror's
    rebuild, taken, leaves it ``pack_physics`` of the moved rows bit for
    bit, which is what ``_rebuild_where`` gathers from the packed rows of
    the rows before; skipped, it keeps its bytes."""
    cfg, rows, bounds, ref, grouping = _window_inputs(dims, 1000, n_live)
    rows = engine_mod._pack_rows(rows)
    for flag in (True, False):
        stale = torch.tensor(flag)
        got = _mirror(stale, cfg, rows, bounds, ref, grouping, seed=3)
        want = engine_mod._rebuild_where(stale, cfg, rows, bounds, ref, torch.arange(1000),
                                         grouping=grouping)
        _assert_rebuilt(got, want, f"flag {flag}")
        assert _same(got[0][window.PACKED], pack_physics(got[0]["loc"], got[0]["rad"]))
        if not flag:
            assert _same(got[0][window.PACKED], rows[window.PACKED])


def test_plain_mirrors_fold_the_probes_and_write_the_packed_rows():
    """The CPU forms of the kernels' new outputs: each contact substep given
    ``probes`` folds in the widest run, the widest row and the largest
    degree (a predicated substep that does not run folds nothing), the
    update given ``xyzr`` writes ``pack_physics`` of its new locations, and
    the update given a scratch row writes the kernel's words into it (the
    largest move and drift by max, and the flag) and returns the values
    those words hold."""
    from hipsc_abm_tpu_torch.engine import _contact_law, _window_widths, drift_threshold
    from hipsc_abm_tpu_torch.ops import contact

    cfg, rows, bounds, ref, grouping = _window_inputs(2, 1000, 700)
    rows["loc"] = ref  # the window's own positions
    law = _contact_law(cfg, BIO)
    xyzr = pack_physics(rows["loc"], rows["rad"])
    run, cands = _window_widths(bounds)
    args = (xyzr, rows["ids"], rows["alive"], bounds)
    for name, fn, last in (("B6", contact.contact_substep_cuda, rows["partners"]),
                           ("B6 plain", contact.contact_substep_plain, rows["partners"]),
                           ("seed", span_mask.contact_seed_cuda, rows["partners"]),
                           ("seed plain", span_mask.contact_seed_plain, rows["partners"])):
        probes = torch.tensor([0, 0, 10_000], dtype=torch.int32)
        _, degree, _ = fn(*args, last, **law, grouping=grouping, probes=probes)
        assert probes.tolist() == [int(run), int(cands), 10_000], name
        probes.zero_()
        fn(*args, last, **law, grouping=grouping, probes=probes)
        assert probes.tolist() == [int(run), int(cands), int(degree.max())], name
        assert int(degree.max()) > 0
    _, _, mask = span_mask.contact_seed_cuda(*args, rows["partners"], **law, grouping=grouping)
    probes = torch.zeros(3, dtype=torch.int32)
    span_mask.contact_masked_cuda(*args, mask.clone(), **law, grouping=grouping,
                                  pred=torch.zeros(1, dtype=torch.int32), probes=probes)
    assert probes.tolist() == [0, 0, 0]
    _, degree, _ = span_mask.contact_masked_cuda(*args, mask, **law, grouping=grouping,
                                                 probes=probes)
    assert probes.tolist() == [int(run), int(cands), int(degree.max())]
    force = torch.full((1000, 3), 1e-9)
    packed = torch.full((1000, 4), float("nan"))
    size = torch.tensor(BOX[2], dtype=torch.float32)
    kw = dict(stokes=BIO.stokes, dt=float(BIO.move_dt), folded=False)
    upd = (rows["loc"], rows["rad"], force, rows["mot"] * 1e-9, rows["alive"], ref, size)
    new, *_ = integrate.update_cuda(*upd, **kw, threshold=drift_threshold(2.0), xyzr=packed)
    assert _same(packed, pack_physics(new, rows["rad"]))
    # the scratch words: the move's and the drift's float32 bits by max, the
    # flag, as the kernel writes them; the values come back as computed
    scratch = integrate.update_scratch(3, "cpu")
    want = integrate.update_plain(*upd, **kw, threshold=0.0)
    for s, threshold in ((0, 0.0), (1, float("inf"))):
        got = integrate.update_cuda(*upd, **kw, threshold=threshold, scratch=scratch[s])
        words = scratch[s, :16].view(torch.int32)
        assert _same(got[0], new) and float(got[1]) > 0.0
        assert [int(w) for w in words[:2]] == [int(v.view(torch.int32)) for v in want[1:3]]
        assert _same(scratch[s, :8].view(torch.float32), torch.stack(got[1:3]))
        assert int(words[3]) == int(got[3]) == (s == 0)
        assert not scratch[s, 16:].any()
    still = integrate.update_plain(*upd[:2], force * 0.0, upd[3] * 0.0, *upd[4:], **kw,
                                   threshold=0.0, scratch=scratch[0])
    assert float(still[1]) == 0.0 and float(scratch[0, :8].view(torch.float32)[0]) == float(
        want[1])
    assert not scratch[2].any()


def _substep_checks(monkeypatch, seen):
    """Wrap the scans' substeps (``contact_substep_rows``,
    ``span_mask_substep``): where the rows carry their packed form, it
    equals ``pack_physics`` of the rows on entry (after the substep's
    rebuild, taken or not) and after the update, and the probes the contact
    launch reduced equal ``_window_widths`` of the bounds it read and the
    largest degree it wrote. ``seen`` counts the substeps and those that
    carried packed rows."""
    real_rows, real_mask = engine_mod.contact_substep_rows, engine_mod.span_mask_substep

    def packed_ok(rows, label):
        if window.PACKED not in rows:
            return False
        assert _same(rows[window.PACKED], pack_physics(rows["loc"], rows["rad"])), label
        return True

    def probes_ok(probes, bounds, degree, label):
        run, cands = engine_mod._window_widths(bounds)
        want = [int(run), int(cands), int(degree.max())]
        assert [int(v) for v in probes] == want, label

    def rows_substep(law, contact, update, s, size, dt, rows, bounds, ref, probes=None, **kw):
        label = f"id-list substep {s}"
        packed = packed_ok(rows, label + " entry")
        out = real_rows(law, contact, update, s, size, dt, rows, bounds, ref, probes=probes,
                        **kw)
        if packed:
            assert packed_ok(out[0], label + " exit")
            probes_ok(probes, bounds, out[1], label)
        seen["substeps"] += 1
        seen["packed"] += packed
        return out

    def mask_substep(law, update, s, size, dt, rows, bounds, ref, mask, rebuild=None,
                     probes=None, **kw):
        label = f"span-mask substep {s}"
        packed = packed_ok(rows, label + " entry")
        out = real_mask(law, update, s, size, dt, rows, bounds, ref, mask, rebuild,
                        probes=probes, **kw)
        if packed:
            assert packed_ok(rows, label + " exit")
            probes_ok(probes, bounds, out[0], label)
        seen["substeps"] += 1
        seen["packed"] += packed
        return out

    monkeypatch.setattr(engine_mod, "contact_substep_rows", rows_substep)
    monkeypatch.setattr(engine_mod, "span_mask_substep", mask_substep)


def _small_bond_cap(eng, state, K=2):
    """The state with room for K partners a row (its bonds are still
    empty), so that rows' degrees pass K."""
    C = state.capacity
    assert not bool(state.bonds.mask.any())
    return state._replace(bonds=BondState.empty(C, K, device=state.alive.device))


def _assert_same_step(got, want):
    """Two ``(state, StepInfo)`` of one step: every field of the info equal,
    and the states bit for bit (arrays, liveness, bonds, key)."""
    (a, a_info), (b, b_info) = got, want
    for name, x, y in zip(engine_mod.StepInfo._fields, a_info, b_info):
        assert _same(torch.as_tensor(x).cpu(), torch.as_tensor(y).cpu()), name
    a, b = convert.state_to_numpy(a), convert.state_to_numpy(b)
    for k in b["arrays"]:
        np.testing.assert_array_equal(a["arrays"][k], b["arrays"][k], err_msg=k)
    for k in ("alive", "partners", "bond_mask", "key"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("path", ["id_list", "span_mask"])
def test_cpu_scan_carries_packed_rows_and_equals_rebuild_where(path, dims, monkeypatch):
    """The CPU's own single-colony scan, the card's route through the plain
    mirrors: at every substep the packed rows are ``pack_physics`` of the
    rows (also right after a taken rebuild) and the probes folded into the
    update's scratch equal ``_window_widths`` and the largest degree; two
    steps equal, bit for bit, those of the same scan whose rebuild selects
    (``_RebuildWhere``), with rebuilds taken and degrees past K."""
    eng, state = _engine(path, dims, deaths=False)
    state = _small_bond_cap(eng, state)
    with monkeypatch.context() as m:
        # swapped in where the rebuild is chosen; the rows still carry their
        # packed form
        m.setattr(engine_mod, "_scan_rebuild", lambda cfg, rows, n_substeps, plain:
                  engine_mod._RebuildWhere(cfg, torch.arange(rows["ids"].shape[0])))
        want = [eng.step(state)]
        want.append(eng.step(want[0][0]))
    seen = {"substeps": 0, "packed": 0}
    _substep_checks(monkeypatch, seen)
    got = eng.step(state)
    _assert_same_step(got, want[0])
    _assert_same_step(eng.step(got[0]), want[1])
    n_sub = len(engine_mod._physics_dts(eng.bio))
    assert seen["substeps"] == seen["packed"] == 2 * n_sub
    assert sum(int(info.jkr_rebuilds) for _, info in want) > 0
    assert max(int(info.jkr_max_degree) for _, info in want) > 2


def _route_record(monkeypatch):
    """Record, for every contact launch, whether it was given probes, and
    count the PyTorch packs of the rows."""
    from hipsc_abm_tpu_torch.parallel import domain_engine

    record = {"probes": [], "packs": 0}

    def wrap(fn):
        def wrapped(*a, **k):
            record["probes"].append(k.get("probes") is not None)
            return fn(*a, **k)
        return wrapped

    real_pack = engine_mod.pack_physics

    def pack(*a):
        record["packs"] += 1
        return real_pack(*a)

    for name in ("contact_substep_cuda", "contact_substep_plain"):
        monkeypatch.setattr(engine_mod, name, wrap(getattr(engine_mod, name)))
    monkeypatch.setattr(domain_engine, "contact_substep_cuda",
                        wrap(domain_engine.contact_substep_cuda))
    monkeypatch.setattr(span_mask, "contact_seed_cuda", wrap(span_mask.contact_seed_cuda))
    monkeypatch.setattr(span_mask, "contact_masked_cuda", wrap(span_mask.contact_masked_cuda))
    monkeypatch.setattr(engine_mod, "pack_physics", pack)
    return record


def _route_paths(device):
    """``(label, step)`` of the single-colony steps on both paths, the
    ``plain`` step and the domain engine's step, on ``device``."""
    from hipsc_abm_tpu_torch.parallel import DomainHipscEngine

    out = []
    for path in ("id_list", "span_mask"):
        eng, state = _engine(path, 2, deaths=False, device=device)
        out.append((path, lambda e=eng, st=state: e.step(st)))
    eng, state = _engine("id_list", 2, deaths=False, device=device)
    cfg = eng._cfg_for_state(state)
    out.append(("plain", lambda: engine_mod.hipsc_step(state, cfg, eng.gen, eng.xp, eng.bio,
                                                       eng.diff, plain=True)))
    for path in ("id_list", "span_mask"):
        gen = GeneralParams(num_to_start=600, end_step=4, size=(1200.0, 1200.0, 0.0))
        dom = DomainHipscEngine(gen, ExperimentalParams(num_gata6=60, dox_step=1),
                                tiles=(2, 1), device=device, contact_path=path)
        dstate = dom.init_state(seed=3)
        out.append((f"domain {path}", lambda d=dom, st=dstate: d.safe_step(st)))
    return out


def _assert_route_split(monkeypatch, device):
    """The scans' routes on ``device``: the single-colony scans give every
    contact launch probes and pack their rows once, at the entry build;
    ``plain`` gives every launch probes and packs on every substep; the
    domain engine gives none and packs on every substep."""
    record = _route_record(monkeypatch)
    n_sub = len(engine_mod._physics_dts(BIO))
    for label, step in _route_paths(device):
        record["probes"].clear()
        record["packs"] = 0
        step()
        assert record["probes"], label
        if label.startswith("domain"):
            assert not any(record["probes"]) and record["packs"] >= n_sub, label
        else:
            assert all(record["probes"]), label
            assert record["packs"] == (n_sub if label == "plain" else 1), label


def test_cpu_plain_and_domain_scans_keep_the_torch_glue(monkeypatch):
    """On the CPU only ``plain`` and the domain engine pack their rows in
    PyTorch on every substep, and only the domain engine probes its
    windows in PyTorch; the single-colony scans take the card's route
    (``_assert_route_split``): their rebuild is the in-place one."""
    cfg, rows, *_ = _window_inputs(2, 1000, 700)
    assert isinstance(engine_mod._scan_rebuild(cfg, rows, 11, plain=False),
                      engine_mod._WindowRebuild)
    assert isinstance(engine_mod._scan_rebuild(cfg, rows, 11, plain=True),
                      engine_mod._RebuildWhere)
    _assert_route_split(monkeypatch, "cpu")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run on the card)")
    return torch.device("cuda")


def _on_card(cfg, rows, bounds, ref, grouping, dev):
    rows = {k: v.to(dev) for k, v in rows.items()}
    grouping = grouping._replace(starts=grouping.starts.to(dev),
                                 needed=grouping.needed.to(dev))
    return cfg, rows, bounds.to(dev), ref.to(dev), grouping


def _kernel_rebuild(stale, cfg, rows, bounds, ref, grouping, n_substeps=3):
    """``rebuild_cuda`` into copies of the window (substep 1's slot)."""
    rows, bounds, ref, grouping = _clone(rows, bounds, ref, grouping)
    buf = window.buffers(cfg.jkr_spec, rows, n_substeps)
    window.rebuild_cuda(stale, cfg.jkr_spec, cfg.jkr_span, rows, bounds, ref, grouping,
                        buf.needed[1], buf)
    return (rows, bounds, ref, grouping._replace(needed=buf.needed[1])), buf


@pytest.mark.cuda
def test_only_the_cards_unplain_scans_take_the_kernels(dev):
    """A scan on the card that is not ``plain`` takes the in-place rebuild
    (``_WindowRebuild``), whose call launches the six kernels; under
    ``plain`` (the calibrator's autograd path) it takes ``_RebuildWhere``,
    which launches none of them."""
    cfg, rows, bounds, ref, grouping = _on_card(*_window_inputs(2, 1000, 700), dev)
    stale = torch.tensor(True, device=dev)
    for plain, kind, launched in ((False, engine_mod._WindowRebuild, 1),
                                  (True, engine_mod._RebuildWhere, 0)):
        rebuild = engine_mod._scan_rebuild(cfg, rows, 11, plain=plain)
        assert isinstance(rebuild, kind)
        before = dict(kernels.launch_counts)
        rebuild(1, stale, *_clone(rows, bounds, ref, grouping))
        for name in window.LAUNCHES:
            key = kernels.counted_name(name, 3)
            assert kernels.launch_counts[key] == before.get(key, 0) + launched, (plain, key)


@pytest.mark.cuda
@pytest.mark.parametrize("taken", [True, False], ids=["taken", "skipped"])
@pytest.mark.parametrize("n_live", [0, 700, 1000])
@pytest.mark.parametrize("dims", [2, 3])
def test_rebuild_kernels_match_rebuild_where(dev, dims, n_live, taken):
    """The six launches against ``_rebuild_where`` on the card: taken, every
    buffer holds the rebuilt window, and the counts are left zero for the
    next rebuild; skipped, every buffer keeps its bytes and the probe slot
    takes the held window's."""
    cfg, rows, bounds, ref, grouping = _on_card(*_window_inputs(dims, 1000, n_live), dev)
    stale = torch.tensor(taken, device=dev)
    before = dict(kernels.launch_counts)
    got, buf = _kernel_rebuild(stale, cfg, rows, bounds, ref, grouping)
    torch.cuda.synchronize()
    want = engine_mod._rebuild_where(stale, cfg, rows, bounds, ref,
                                     torch.arange(1000, device=dev), grouping=grouping)
    _assert_rebuilt(got, want, "kernels")
    if not taken:
        _assert_rebuilt(got, (rows, bounds, ref, grouping), "skipped")
    assert not bool(buf.counts.any())
    n_runs = 3 if dims == 2 else 9
    for name in window.LAUNCHES:
        key = kernels.counted_name(name, n_runs)
        assert kernels.launch_counts[key] == before.get(key, 0) + 1, key


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [2, 3])
def test_rebuild_kernels_at_550k_rows_and_a_capacity_off_128(dev, dims):
    """At the 550k cell's row count (1,430,016 rows) and at 1,430,016 - 37,
    the moved colony's rebuild against ``_rebuild_where``, twice in a row
    (the second over the first's output: the counts came back zero)."""
    for C in (1_430_016, 1_430_016 - 37):
        box = (21_000.0, 21_000.0, 0.0) if dims == 2 else (1_200.0, 1_200.0, 1_200.0)
        rs = np.random.default_rng(C)
        cfg = EngineConfig.create(box, capacity=C, bio=BIO)
        n_live = 550_000
        loc = np.zeros((C, 3), np.float32)
        loc[:, :dims] = rs.uniform(0.0, box[0], (C, dims))
        rows = {"loc": torch.from_numpy(loc).to(dev),
                "rad": torch.full((C,), BIO.max_radius, device=dev),
                "mot": torch.zeros((C, 3), device=dev),
                "ids": torch.from_numpy(rs.permutation(C).astype(np.int32)).to(dev),
                "alive": torch.arange(C, device=dev) < n_live,
                "partners": torch.full((C, 8), -1, dtype=torch.int32, device=dev),
                "perm": torch.arange(C, dtype=torch.int64, device=dev)}
        rows, bounds, grouping = engine_mod._build_window(cfg, rows)
        ref = rows["loc"].clone()
        stale = torch.tensor(True, device=dev)
        buf = window.buffers(cfg.jkr_spec, rows, 3)
        for s in (1, 2):
            step = torch.from_numpy(rs.normal(0.0, 9.0, (C, 3)).astype(np.float32)).to(dev)
            if dims == 2:
                step[:, 2] = 0.0
            # the live rows move, the dead ones stay (the substeps' update)
            moved = (rows["loc"] + step).clamp(0.0, box[0])
            rows["loc"] = torch.where(rows["alive"][:, None], moved, rows["loc"])
            want = engine_mod._rebuild_where(stale, cfg, rows, bounds, ref,
                                             torch.arange(C, device=dev), grouping=grouping)
            window.rebuild_cuda(stale, cfg.jkr_spec, cfg.jkr_span, rows, bounds, ref,
                                grouping, buf.needed[s], buf)
            grouping = grouping._replace(needed=buf.needed[s])
            _assert_rebuilt((rows, bounds, ref, grouping), want, f"C {C}, rebuild {s}")
            assert not bool(buf.counts.any())


@pytest.mark.cuda
def test_rebuild_graph_holds_only_its_kernels(dev):
    """A rebuild captured alone in a CUDA graph: its six kernels and no
    other node, so a later substep's window phase launches no PyTorch
    kernel; replayed skipped and taken, it gives ``_rebuild_where``'s
    window."""
    cfg, rows, bounds, ref, grouping = _on_card(*_window_inputs(2, 1000, 700), dev)
    work = _clone(rows, bounds, ref, grouping)
    buf = window.buffers(cfg.jkr_spec, work[0], 3)
    stale = torch.zeros((), dtype=torch.bool, device=dev)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with kernels.capturing() as tally, torch.cuda.graph(graph):
        window.rebuild_cuda(stale, cfg.jkr_spec, cfg.jkr_span, *work, buf.needed[1], buf)
    graph.instantiate()
    nodes = kernels.graph_nodes(graph)
    assert nodes["kernel"] == len(window.LAUNCHES) == sum(tally.values())
    assert sum(nodes.values()) == nodes["kernel"], nodes
    for flag in (False, True):
        stale.fill_(flag)
        graph.replay()
        torch.cuda.synchronize()
        want = engine_mod._rebuild_where(stale, cfg, rows, bounds, ref,
                                         torch.arange(1000, device=dev), grouping=grouping)
        _assert_rebuilt((*work[:3], work[3]._replace(needed=buf.needed[1])), want,
                        f"replay, flag {flag}")


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("path", ["id_list", "span_mask"])
def test_run_steps_with_kernel_rebuilds_equal_the_cpu(dev, path, dims):
    """A 5-step ``run_steps`` block on the card (the scans rebuild with the
    kernels) against the same block on the CPU (``rebuild_plain``), by
    agent id: integer state, positions and bonds bit-equal, the rebuilds
    taken equal; each replay runs the six rebuild kernels on each of a
    step's 10 later substeps."""
    cpu, state = _engine(path, dims, deaths=False, n=3000)
    card, _ = _engine(path, dims, deaths=False, device=dev, n=3000)
    state, _ = cpu.safe_step(state)
    d = convert.state_to_numpy(state)
    a, a_info = cpu.run_steps(convert.state_from_numpy(d, "cpu"), 5)
    card.run_steps(convert.state_from_numpy(d, dev), 5)  # the capture
    kernels.launch_counts.clear()
    b, b_info = card.run_steps(convert.state_from_numpy(d, dev), 5)
    n_runs = 3 if dims == 2 else 9
    n_later = len(engine_mod._physics_dts(card.bio)) - 1
    for name in window.LAUNCHES:
        assert kernels.launch_counts[kernels.counted_name(name, n_runs)] == 5 * n_later, name
    np.testing.assert_array_equal(b_info.jkr_rebuilds, a_info.jkr_rebuilds)
    assert int(np.sum(b_info.jkr_rebuilds)) > 0
    a, b = convert.state_to_numpy(a), convert.state_to_numpy(b)

    def by_id(x):
        o = np.argsort(x["arrays"]["ids"][x["alive"]])
        return ({k: v[x["alive"]][o] for k, v in x["arrays"].items()},
                {k: x[k][x["alive"]][o] for k in ("partners", "bond_mask")})

    (arr_a, bonds_a), (arr_b, bonds_b) = by_id(a), by_id(b)
    for k in arr_a:
        np.testing.assert_array_equal(arr_b[k], arr_a[k], err_msg=k)
    for k in bonds_a:
        np.testing.assert_array_equal(bonds_b[k], bonds_a[k], err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("path", ["id_list", "span_mask"])
def test_card_scan_probes_and_packed_rows_equal_the_cpu(dev, path, dims, monkeypatch):
    """Two eager steps on the card, whose scans carry packed rows and take
    the probes from their contact kernels: at every substep the kernels'
    widest run, widest row and largest degree equal ``_window_widths`` of
    the bounds and the largest degree on the same buffers, and the packed
    rows equal ``pack_physics`` of the rows on all C rows, right after a
    taken rebuild too; the steps' infos and states equal the CPU's bit for
    bit, with rebuilds taken and degrees past K."""
    cpu, state = _engine(path, dims, deaths=False, n=3000)
    card, _ = _engine(path, dims, deaths=False, device=dev, n=3000)
    state = _small_bond_cap(cpu, state)
    want = [cpu.step(state)]
    want.append(cpu.step(want[0][0]))
    seen = {"substeps": 0, "packed": 0}
    _substep_checks(monkeypatch, seen)
    got = card.step(convert.state_from_numpy(convert.state_to_numpy(state), dev))
    _assert_same_step(got, want[0])
    _assert_same_step(card.step(got[0]), want[1])
    n_sub = len(engine_mod._physics_dts(card.bio))
    assert seen["substeps"] == seen["packed"] == 2 * n_sub
    assert sum(int(info.jkr_rebuilds) for _, info in want) > 0
    assert max(int(info.jkr_max_degree) for _, info in want) > 2


@pytest.mark.cuda
def test_only_the_cards_single_colony_scans_take_the_kernel_probes(dev, monkeypatch):
    """On the card, as on the CPU: the single-colony scans give every
    contact launch the probes and pack their rows once, at the entry build;
    ``plain`` gives its plain launches probes and packs on every substep;
    the domain engine gives none and packs on every substep."""
    _assert_route_split(monkeypatch, "cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("taken", [True, False], ids=["taken", "skipped"])
@pytest.mark.parametrize("n_live", [0, 700, 1000])
@pytest.mark.parametrize("dims", [2, 3])
def test_rebuild_kernels_move_the_packed_rows(dev, dims, n_live, taken):
    """Rows that carry their packed form: the write-back leaves it
    ``pack_physics`` of the moved rows, as ``_rebuild_where`` gathers it;
    skipped, the packed rows keep their bytes."""
    cfg, rows, bounds, ref, grouping = _on_card(*_window_inputs(dims, 1000, n_live), dev)
    rows = engine_mod._pack_rows(rows)
    stale = torch.tensor(taken, device=dev)
    got, _ = _kernel_rebuild(stale, cfg, rows, bounds, ref, grouping)
    torch.cuda.synchronize()
    want = engine_mod._rebuild_where(stale, cfg, rows, bounds, ref,
                                     torch.arange(1000, device=dev), grouping=grouping)
    _assert_rebuilt(got, want, "kernels")
    assert _same(got[0][window.PACKED], pack_physics(got[0]["loc"], got[0]["rad"]))


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [2, 3])
def test_kernel_probes_and_packed_update_equal_the_mirrors(dev, dims):
    """B6, the seed (B2) and the masked substep (B1) given ``probes``, on
    1000 rows (a partial last CTA) with 300 dead: the probes equal the plain
    fold's, a masked launch skipped by its predicate leaves them; the
    update given ``xyzr`` writes the plain update's packed rows."""
    from hipsc_abm_tpu_torch.engine import _contact_law, drift_threshold
    from hipsc_abm_tpu_torch.ops import contact

    cfg, rows, bounds, ref, grouping = _on_card(*_window_inputs(dims, 1000, 700), dev)
    law = _contact_law(cfg, BIO)
    args = (pack_physics(ref, rows["rad"]), rows["ids"], rows["alive"], bounds)

    def probed(fn, last, **kw):
        got = torch.zeros(3, dtype=torch.int32, device=dev)
        out = fn(*args, last, **law, grouping=grouping, probes=got, **kw)
        want = torch.zeros(3, dtype=torch.int32)
        contact.fold_probes(want, bounds.cpu(), out[1].cpu())
        assert got.tolist() == want.tolist(), fn.__name__
        assert int(out[1].max()) > 0
        return out

    probed(contact.contact_substep_cuda, rows["partners"])
    _, _, mask = probed(span_mask.contact_seed_cuda, rows["partners"])
    skipped = torch.zeros(3, dtype=torch.int32, device=dev)
    span_mask.contact_masked_cuda(*args, mask.clone(), **law, grouping=grouping,
                                  pred=torch.zeros(1, dtype=torch.int32, device=dev),
                                  probes=skipped)
    assert skipped.tolist() == [0, 0, 0]
    probed(span_mask.contact_masked_cuda, mask)
    force = torch.full((1000, 3), 1e-9, device=dev)
    size = torch.tensor(BOX[dims], dtype=torch.float32, device=dev)
    kw = dict(stokes=BIO.stokes, dt=float(BIO.move_dt), folded=False,
              threshold=drift_threshold(2.0))
    packed = torch.full((1000, 4), float("nan"), device=dev)
    new, *_ = integrate.update_cuda(rows["loc"], rows["rad"], force, rows["mot"] * 1e-9,
                                    rows["alive"], ref, size, xyzr=packed,
                                    scratch=integrate.update_scratch(1, dev)[0], **kw)
    want = torch.full((1000, 4), float("nan"))
    integrate.update_plain(rows["loc"].cpu(), rows["rad"].cpu(), force.cpu(),
                           rows["mot"].cpu() * 1e-9, rows["alive"].cpu(), ref.cpu(),
                           size.cpu(), xyzr=want, **kw)
    assert _same(packed.cpu(), want)
    assert _same(packed.cpu(), pack_physics(new.cpu(), rows["rad"].cpu()))
