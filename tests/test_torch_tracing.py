"""PyTorch port: program tracing (``utils.profiling``) in the engines.

On the CPU: with tracing off nothing is recorded, and ``hipsc_step``,
``run_steps`` and the ensemble's ``safe_step`` give the same bits with it on
and off; the step's phases come in their order and tile each block, and an
ensemble's replicates mark nothing inside its block; a call's
host spans nest as the engines open them, and are record functions of the
same names, in the operators' scope, under ``torch.profiler``; the counters
follow the probes; each ``tracing()`` block starts a recorder of its own.

On the card (marked ``cuda``, skipped without one; the file imports no JAX):
a replay of a graph captured with its timing marks equals a replay without,
bit for bit; the phases sum to the replay's device time, which lies within
the host's events around the call; under ``torch.profiler`` no event of
the card's timeline carries a span's name; a traced graph holds one
event-record node per mark and, but for the nodes of the entry window's
tally (``engine._tally_window``), the same kernel, memcpy and memset nodes
as the untraced one, which holds no event-record node; an ensemble's traced
graph holds two (its replicates mark nothing)::

    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py -q
"""

import collections
import contextlib
import dataclasses

import pytest
import torch

from hipsc_abm_tpu_torch import engine as engine_mod
from hipsc_abm_tpu_torch.engine import HipscEngine, hipsc_step
from hipsc_abm_tpu_torch.params import DiffusionParams, ExperimentalParams, GeneralParams
from hipsc_abm_tpu_torch.parallel.ensemble import EnsembleEngine
from hipsc_abm_tpu_torch.utils import profiling

PHASES = ("sort", "biology", "diffusion", "window", "contact", "finish")
DIFF = DiffusionParams(spat_res=20.0, diffuse_dt=6.0, diffuse_const=2.0, max_concentration=2.0,
                       degradation=0.1, release_amount=0.01)


def _engine(device="cpu", n=300, contact_path="id_list", diffusion=True):
    side = 2000.0 * (n / 5000.0) ** 0.5
    gen = GeneralParams(num_to_start=n, end_step=20, size=(side, side, 0.0))
    xp = ExperimentalParams(num_gata6=n // 10, dox_step=1)
    return HipscEngine(gen, xp, diff=DIFF if diffusion else None, enable_diffusion=diffusion,
                       device=device, contact_path=contact_path)


def _step_phases(diffusion=True, substeps=11):
    """The phase marks of one step, in order."""
    bio = ("biology", "diffusion", "biology") if diffusion else ("biology",)
    return (("sort",) + bio + ("window", "contact")
            + ("window", "contact") * (substeps - 1) + ("finish",))


def _assert_same_bits(a, b):
    for x, y in zip(engine_mod._device_tensors(a), engine_mod._device_tensors(b),
                    strict=True):
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y)
    assert torch.equal(a.key, b.key) and a.step == b.step


def _traced(fn):
    with profiling.tracing() as rec:
        out = fn()
    return out, rec


@pytest.fixture
def read_blocks(monkeypatch):
    """The timelines of the blocks the recorder's calls read, in order."""
    added = []
    real = profiling.Recorder.add

    def add(self, timeline):
        added.append(timeline)
        real(self, timeline)

    monkeypatch.setattr(profiling.Recorder, "add", add)
    return added


def test_tracing_off_records_nothing():
    eng = _engine()
    state, _ = eng.run_steps(eng.init_state(seed=3), 2)
    assert not profiling.tracing_on() and profiling._recorder is None
    assert profiling.span("run_steps") is profiling.span("attempt")  # the shared null context
    profiling.phase("sort")
    profiling.count("steps", 2)
    with profiling.block(torch.device("cpu")):
        profiling.phase("sort")
    with profiling.tracing() as rec:
        assert profiling.tracing_on()
    assert rec.calls == [] and not profiling.tracing_on()


@pytest.mark.parametrize("what", ["hipsc_step", "run_steps", "ensemble"])
def test_outputs_are_the_same_bits_with_tracing_on_and_off(what):
    eng = _engine()
    state = eng.init_state(seed=5)
    if what == "hipsc_step":
        cfg = eng._cfg_for_state(state)

        def run():
            with profiling.block(state.alive.device):
                return hipsc_step(state, cfg, eng.gen, eng.xp, eng.bio, eng.diff)[0]
    elif what == "run_steps":
        def run():
            return eng.run_steps(state, 2)[0]
    else:
        ens = EnsembleEngine(_engine(n=150))
        states = ens.init_states([1, 2])

        def run():
            return ens.safe_step(states)[0]
    off = run()
    on, rec = _traced(run)
    _assert_same_bits(off, on)
    if what != "hipsc_step":
        assert len(rec.calls) == 1 and rec.calls[0].block_ms > 0


@pytest.mark.parametrize("contact_path,diffusion", [("id_list", True), ("span_mask", False)])
def test_phases_come_in_order_and_tile_each_block(contact_path, diffusion, read_blocks):
    eng = _engine(contact_path=contact_path, diffusion=diffusion)
    state = eng.init_state(seed=7)
    _, rec = _traced(lambda: eng.run_steps(state, 2))
    (call,) = rec.calls
    (timeline,) = read_blocks
    intervals = timeline.intervals()
    assert [name for name, _ in intervals] == list(_step_phases(diffusion) * 2)
    assert not call.device_clock
    assert all(ms >= 0 for _, ms in intervals)
    total = sum(ms for _, ms in intervals)
    assert call.block_ms == pytest.approx(total, rel=1e-9)
    assert sum(call.phase_ms.values()) == pytest.approx(total, rel=1e-9)
    assert set(call.phase_ms) == set(PHASES) - ({"diffusion"} if not diffusion else set())
    assert call.block_ms <= call.wall_s * 1e3


def test_ensemble_branches_keep_their_phases(read_blocks):
    """The replicates' blocks inside the ensemble's keep no marks of their
    own: the ensemble step is one interval, its first mark to its last."""
    ens = EnsembleEngine(_engine(n=150))
    states = ens.init_states([1, 2, 3])
    _, rec = _traced(lambda: ens.safe_step(states))
    (call,) = rec.calls
    (timeline,) = read_blocks
    assert [name for name, _ in timeline.intervals()] == [None]  # the fork to the join
    assert len(timeline.stamps) == 2
    assert call.phase_ms == {} and 0 < call.block_ms <= call.wall_s * 1e3
    with profiling.tracing() as rec:
        with profiling.block(torch.device("cpu")):
            profiling.phase("sort")
            with profiling.block(torch.device("cpu")):
                profiling.phase("biology")
            profiling.phase("finish")
    assert [name for name, _ in read_blocks[-1].intervals()] == ["sort", "finish"]
    assert len(read_blocks) == 2 and rec._depth == 0 and rec._open is None


def _span_paths(call):
    return list(call.span_s)


def test_host_spans_nest_as_listed():
    eng = _engine()
    state = eng.init_state(seed=2)
    _, rec = _traced(lambda: eng.run_steps(state, 1))
    (call,) = rec.calls
    assert _span_paths(call) == ["run_steps", "run_steps/attempt", "run_steps/attempt/inputs",
                                 "run_steps/attempt/growth.check"]
    assert call.wall_s == call.span_s["run_steps"]
    assert call.span_s["run_steps/attempt"] <= call.wall_s
    # a re-execution: the daughter table of one division overflows
    eng.cfg = dataclasses.replace(eng.cfg, div_cap=1)
    state = eng.init_state(seed=2)
    state = state._replace(arrays={**state.arrays, "div_counters": torch.where(
        state.alive, eng.bio.pluri_div_thresh, 0).to(torch.int32)})
    _, rec = _traced(lambda: eng.run_steps(state, 1))
    (call,) = rec.calls
    assert call.counts["attempts"] == eng.block_attempts >= 2
    assert "run_steps/attempt/growth.repad" in call.span_s
    ens = EnsembleEngine(_engine(n=150))
    states = ens.init_states([1, 2])
    _, rec = _traced(lambda: ens.safe_step(states))
    assert _span_paths(rec.calls[0]) == [
        "ensemble.safe_step", "ensemble.safe_step/attempt", "ensemble.safe_step/attempt/inputs",
        "ensemble.safe_step/growth.check"]


def _kind(event) -> str:
    """The profiler's kind of ``event``: ``cpu_op`` or ``user_annotation``
    (torch 2.11's events lack ``activity_type``)."""
    if hasattr(event, "activity_type"):
        return event.activity_type()
    return "user_annotation" if event.is_user_annotation() else "cpu_op"


def test_spans_are_profiler_functions_with_tracing_off():
    from torch.profiler import ProfilerActivity, profile

    eng = _engine()
    state = eng.init_state(seed=2)
    spans = {"run_steps", "attempt", "inputs", "growth.check"}
    for traced in (False, True):
        with profiling.tracing() if traced else contextlib.nullcontext():
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                eng.run_steps(state, 1)
        kinds = {e.name(): _kind(e) for e in prof.profiler.kineto_results.events()}
        assert {kinds.get(name) for name in spans} == {"cpu_op"}


def test_counters_follow_the_probes():
    eng = _engine()
    state = eng.init_state(seed=11)
    before = eng.window_rebuilds
    (_, infos), rec = _traced(lambda: eng.run_steps(state, 3))
    counts = rec.calls[0].counts
    assert counts["steps"] == 3 and counts["attempts"] == 1
    assert counts["rebuilds"] == int(infos.jkr_rebuilds.sum()) == eng.window_rebuilds - before


def test_a_growth_frees_the_dropped_graph_before_the_next_capture(monkeypatch):
    """The attempt loop keeps no reference to a graph that growth drops, so
    its memory pool is returned before the grown block is captured. The
    card's graphs are stood in for: each runs the block eagerly."""
    import types
    import weakref

    made, alive_at_capture = [], []

    class Graph:
        def __init__(self, cfg):
            alive_at_capture.append([ref() is not None for ref in made])
            made.append(weakref.ref(self))
            self.cfg = cfg

        def run(self, state, table):
            return engine_mod._run_block(eng, self.cfg, state, table)

    def graph_for(self, cfg, k, state):
        if cfg not in self._graphs:
            self._graphs.clear()
            self._graphs[cfg] = Graph(cfg)
        return self._graphs[cfg]

    eng = _engine()
    eng.cfg = dataclasses.replace(eng.cfg, div_cap=1)
    state = eng.init_state(seed=2)
    state = state._replace(arrays={**state.arrays, "div_counters": torch.where(
        state.alive, eng.bio.pluri_div_thresh, 0).to(torch.int32)})
    monkeypatch.setattr(HipscEngine, "_graph_for", graph_for)
    eng.device = types.SimpleNamespace(type="cuda")
    eng.run_steps(state, 1)
    assert eng.block_attempts >= 2 and len(made) == eng.block_attempts
    assert alive_at_capture == [[False] * n for n in range(len(made))]


def test_a_call_that_raises_leaves_no_marks_to_the_next(monkeypatch):
    eng = _engine()
    state = eng.init_state(seed=6)

    def overflow(*args):
        raise RuntimeError("overflow")

    with profiling.tracing() as rec:
        with monkeypatch.context() as m:
            m.setattr(eng, "_grown_cfg", overflow)
            with pytest.raises(RuntimeError, match="overflow"):
                eng.run_steps(state, 1)
        eng.run_steps(state, 1)
    failed, done = rec.calls
    assert failed.block_ms == 0 and failed.phase_ms == {}
    assert done.block_ms > 0 and set(done.phase_ms) == set(PHASES)
    assert rec._done == [] and rec._spans == []


def test_each_tracing_block_records_its_own_calls():
    eng = _engine()
    state = eng.init_state(seed=4)
    (state, _), first = _traced(lambda: eng.run_steps(state, 1))
    (state, _), second = _traced(lambda: (eng.run_steps(state, 1), eng.run_steps(state, 1))[1])
    assert len(first.calls) == 1 and len(second.calls) == 2
    assert first.calls[0] is not second.calls[0]
    assert all(c.counts["steps"] == 1 for c in first.calls + second.calls)
    assert "call 1 run_steps" in second.report() and "call 1" not in first.report()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run on the card)")
    return torch.device("cuda")


def _graph(eng, traced):
    (graph,) = [g for key, g in eng._graphs.items() if key[1] == traced]
    return graph


@pytest.mark.cuda
@pytest.mark.parametrize("contact_path", ["id_list", "span_mask"])
def test_card_replay_with_marks_equals_replay_without(dev, contact_path):
    eng = _engine(dev, n=3000, contact_path=contact_path)
    start = eng.init_state(seed=1)

    def two_blocks():
        state, _ = eng.run_steps(start, 3)  # the capture, then a replay
        return eng.run_steps(state, 3)

    off, off_info = two_blocks()
    (on, on_info), rec = _traced(two_blocks)
    _assert_same_bits(off, on)
    for a, b in zip(off_info, on_info):
        assert (a == b).all()
    assert [c.device_clock for c in rec.calls] == [True, True]


@pytest.mark.cuda
def test_card_phases_sum_to_the_replay_time(dev, read_blocks):
    eng = _engine(dev, n=3000)
    state = eng.init_state(seed=2)
    with profiling.tracing():
        state, _ = eng.run_steps(state, 3)
    before, after = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with profiling.tracing() as rec:
        before.record()
        eng.run_steps(state, 3)
        after.record()
    torch.cuda.synchronize()
    (call,) = rec.calls
    intervals = read_blocks[-1].intervals()
    assert [name for name, _ in intervals] == list(_step_phases() * 3)
    assert all(ms >= 0 for _, ms in intervals) and call.block_ms > 0
    assert sum(ms for _, ms in intervals) == pytest.approx(call.block_ms, rel=1e-3, abs=1e-3)
    assert sum(call.phase_ms.values()) == pytest.approx(call.block_ms, rel=1e-3, abs=1e-3)
    assert call.block_ms <= before.elapsed_time(after)
    assert call.block_ms <= call.wall_s * 1e3
    assert _span_paths(call) == [
        "run_steps", "run_steps/attempt", "run_steps/attempt/inputs",
        "run_steps/attempt/graph.lookup", "run_steps/attempt/graph.copy_in",
        "run_steps/attempt/graph.launch", "run_steps/attempt/graph.copy_out",
        "run_steps/attempt/probes.fetch", "run_steps/attempt/growth.check"]


@pytest.mark.cuda
def test_card_spans_leave_no_device_event(dev):
    """Under ``torch.profiler``, with tracing off and on, the host's events
    carry the spans' names and no event of the card's timeline does: a copy
    there would count as device time in a reading of the trace."""
    from torch.profiler import ProfilerActivity, profile

    eng = _engine(dev, n=3000)
    state = eng.init_state(seed=4)
    spans = {"run_steps", "attempt", "inputs", "graph.lookup", "graph.copy_in",
             "graph.launch", "graph.copy_out", "probes.fetch", "growth.check"}
    for traced in (False, True):
        with profiling.tracing() if traced else contextlib.nullcontext():
            eng.run_steps(state, 2)  # the capture
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                eng.run_steps(state, 2)
                torch.cuda.synchronize()
        names = collections.defaultdict(set)
        for e in prof.profiler.kineto_results.events():
            names[str(e.device_type()).split(".")[-1]].add(e.name())
        assert names["CUDA"] and not names["CUDA"] & spans
        assert spans <= names["CPU"]


@pytest.mark.cuda
def test_card_event_nodes_equal_the_marks(dev, monkeypatch):
    eng = _engine(dev, n=3000)
    state = eng.init_state(seed=3)
    eng.run_steps(state, 2)
    _, rec = _traced(lambda: eng.run_steps(state, 2))
    off, on = _graph(eng, False), _graph(eng, True)
    assert off.nodes["event_record"] == 0 and off.timelines == []
    marks = sum(len(t.stamps) for t in on.timelines)
    assert on.nodes["event_record"] == marks == 2 * len(_step_phases()) + 1
    assert on.nodes["kernel"] > off.nodes["kernel"] > 0  # the window tally's
    counts = rec.calls[0].counts
    assert "run_steps/attempt/graph.lookup/graph.capture" in rec.calls[0].span_s
    assert {k: counts[f"graph.nodes.{k}"] for k in on.nodes} == on.nodes
    listed = {g["traced"]: g["nodes"] for g in eng.block_graphs()}
    assert listed == {False: off.nodes, True: on.nodes}
    # without the tally the traced graph's work nodes are the untraced one's
    monkeypatch.setattr(engine_mod, "_tally_window", lambda bounds, rows: None)
    bare = _engine(dev, n=3000)
    _traced(lambda: bare.run_steps(state, 2))
    untallied = _graph(bare, True)
    assert untallied.nodes["event_record"] == on.nodes["event_record"]
    for kind in ("kernel", "memcpy", "memset", "other"):
        assert untallied.nodes[kind] == off.nodes[kind], kind


@pytest.mark.cuda
def test_card_ensemble_marks_change_no_bit(dev, read_blocks):
    ens = EnsembleEngine(_engine(dev, n=1500))
    start = ens.init_states([1, 2, 3])
    off, _ = ens.safe_step(ens.safe_step(start)[0])
    (on, _), rec = _traced(lambda: ens.safe_step(ens.safe_step(start)[0]))
    _assert_same_bits(off, on)
    call = rec.calls[1]
    assert len(read_blocks[-1].stamps) == 2 and call.phase_ms == {} and call.block_ms > 0
    traced = [g for key, g in ens._graphs.items() if key[2]]
    untraced = [g for key, g in ens._graphs.items() if not key[2]]
    (on_graph,), (off_graph,) = traced, untraced
    assert on_graph.nodes["event_record"] == 2
    assert off_graph.nodes["event_record"] == 0
    for kind in ("kernel", "memcpy", "memset"):
        assert on_graph.nodes[kind] == off_graph.nodes[kind], kind
