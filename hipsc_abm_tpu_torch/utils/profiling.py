"""Profiling and tracing of the port (port of ``hipsc_abm_tpu/utils/profiling.py``,
and the port's own tracing).

``record_time`` and ``record_block`` store a method's or a block's wall time
in ``sim.method_times`` under its name, the keys the data CSV's columns take.
Kernel launches return before the card has finished, so ``record_block``
synchronises the card before it reads the clock when the simulation's engine
runs on CUDA. ``device_trace`` records a ``torch.profiler`` trace of a
region (the JAX package's ``jax.profiler`` hook).

**Program tracing** is off by default; ``tracing()`` turns it on for a
region and yields the ``Recorder`` of every engine call made in it. The
engines mark themselves with:

- ``span(name)``: a host span (``run_steps`` / ``ensemble.safe_step``, then
  ``attempt``, ``inputs``, ``graph.lookup``, ``graph.capture``,
  ``graph.copy_in``, ``graph.launch``, ``graph.copy_out``,
  ``probes.fetch``, ``growth.check``, ``growth.repad``). While
  ``torch.profiler`` records, it is a record function of that name, so the
  span lies in the same trace as the card's work (of the operators' scope:
  the profiler copies a user-scope ``record_function`` onto the device's
  timeline as an annotation over the work launched in it, which a reading
  of the device's activity would count as device time); under
  ``tracing()`` its host seconds go to the call's record. With both off it
  tests a flag.
- ``block(device)`` and ``phase(name)``: a block (the steps of one
  ``_run_block``, or an ensemble step) is a timeline of marks, and each
  ``phase`` mark starts the named phase (``sort``, ``biology``,
  ``diffusion``, ``window``, ``contact``, ``finish`` in a step), which lasts
  to the next mark: the phases tile the block. A block inside another marks
  nothing: an ensemble step is one interval, from before its fork to after
  its join, and its replicates' steps name no phase (their marks would
  slow the launch of the ensemble's graph). On the card a mark records a
  timing event on the current stream (``torch.cuda.Event(enable_timing=True,
  external=True)``), so a block captured in a CUDA graph holds its marks as
  event-record nodes and every replay records them again (``replayed``
  hands them to the call after the replay's probe fetch, which has waited
  for the stream); they are read when the call ends, outside its wall time.
  On the CPU a mark takes the host clock. With tracing off neither records
  anything, and a graph captured then holds no event node (the engines key
  their graphs by ``tracing_on()``).
- ``count(name, n)``: a counter of the call (``steps``, ``attempts``,
  ``rebuilds``, and ``graph.nodes.<kind>`` at a capture).
- ``tally(name, value)``: a counter summed on the device, in the open
  block (``contact.candidates`` and ``contact.live_rows``, at each step's
  entry window build). The block's timeline holds the running sum, so a
  captured block holds its additions as graph nodes that every replay makes
  again; it is read into the call's counters with the marks, when the call
  ends. The caller computes ``value`` only where ``tallying()`` is true, so
  a graph captured with tracing off holds no node of it.

To see where a call's time goes::

    from hipsc_abm_tpu_torch.utils import profiling

    with profiling.tracing() as rec:
        state, infos = engine.run_steps(state, 5)   # the capture: its own call
        state, infos = engine.run_steps(state, 5)   # a replay
    print(rec.report())

prints each call's wall time, steps, attempts and rebuilds, the device time
of its blocks by phase, and its host spans, nested.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import time
from functools import wraps
from typing import Dict, List, Optional

import torch


def record_time(function):
    """Decorator storing the method's wall time in ``sim.method_times``
    under the method's name."""

    @wraps(function)
    def wrap(simulation, *args, **kwargs):
        start = time.perf_counter()
        result = function(simulation, *args, **kwargs)
        simulation.method_times[function.__name__] = time.perf_counter() - start
        return result

    return wrap


@contextlib.contextmanager
def record_block(simulation, name: str):
    """Context-manager form for timing inline blocks (the fused step); the
    card's queued work is waited for before the time is taken."""
    start = time.perf_counter()
    try:
        yield
    finally:
        engine = getattr(simulation, "engine", None)
        if engine is not None and engine.device.type == "cuda":
            torch.cuda.synchronize(engine.device)
        simulation.method_times[name] = time.perf_counter() - start


@contextlib.contextmanager
def device_trace(log_dir: str | None):
    """A ``torch.profiler`` trace of the region (host activity, and the
    card's kernels and copies when CUDA is available), written to
    ``log_dir`` as a Chrome trace (``trace_<pid>_<n>.json``; open it in
    Perfetto or ``chrome://tracing``); nothing when ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    n = len([f for f in os.listdir(log_dir) if f.startswith(f"trace_{os.getpid()}_")])
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{n}.json"))


# -- program tracing ----------------------------------------------------------

# the recorder of the enclosing ``tracing()``, or None: tracing is off
_recorder: Optional["Recorder"] = None
_NULL = contextlib.nullcontext()


class Timeline:
    """The marks of one block: ``stamps`` (CUDA events on the card, host
    seconds on the CPU) and ``names``, the phase of each interval between
    two stamps (None: no phase was named)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stamps: list = [self._stamp()]
        self.names: List[Optional[str]] = [None]
        # device sums of ``tally`` by counter name
        self.tallies: Dict[str, torch.Tensor] = {}

    def _stamp(self):
        if self.device.type != "cuda":
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True, external=True)
        event.record()
        return event

    def mark(self, name: str) -> None:
        """Start phase ``name`` here. A phase named before any other takes
        the block's first mark, so the block's start belongs to it."""
        if len(self.names) == 1 and self.names[0] is None:
            self.names[0] = name
            return
        self.stamps.append(self._stamp())
        self.names.append(name)

    def close(self) -> None:
        self.stamps.append(self._stamp())

    def tally(self, name: str, value: torch.Tensor) -> None:
        """Add the device scalar ``value`` to counter ``name``."""
        held = self.tallies.get(name)
        self.tallies[name] = value if held is None else held + value

    def intervals(self) -> List[tuple]:
        """``(phase, ms)`` of each interval, in order (the card's events
        must have completed)."""
        s = self.stamps
        if self.device.type == "cuda":
            ms = [a.elapsed_time(b) for a, b in zip(s, s[1:])]
        else:
            ms = [(b - a) * 1e3 for a, b in zip(s, s[1:])]
        return list(zip(self.names, ms))

    def total_ms(self) -> float:
        """From the first mark to the last."""
        s = self.stamps
        if self.device.type == "cuda":
            return s[0].elapsed_time(s[-1])
        return (s[-1] - s[0]) * 1e3


@dataclasses.dataclass
class Call:
    """One traced engine call (``run_steps`` or ``ensemble.safe_step``):
    its host wall seconds; ``counts`` (``steps`` completed, ``attempts``,
    window ``rebuilds`` of its step attempts, ``graph.nodes.<kind>`` of the
    graphs it captured, and its blocks' ``tally`` counters); ``block_ms``,
    the first-to-last mark of its blocks (on the card: the device time of
    its replays), and ``phase_ms`` by phase, which sum to it when every
    interval has a phase; ``span_s``, host seconds by span path
    (``run_steps/attempt/graph.launch``); ``device_clock``, whether the
    marks were CUDA events (else the host clock)."""

    name: str
    wall_s: float = 0.0
    counts: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    block_ms: float = 0.0
    phase_ms: Dict[str, float] = dataclasses.field(
        default_factory=lambda: collections.defaultdict(float))
    span_s: Dict[str, float] = dataclasses.field(
        default_factory=lambda: collections.defaultdict(float))
    device_clock: bool = False


class Recorder:
    """What ``tracing()`` recorded: ``calls``, one ``Call`` per outermost
    span, in order."""

    def __init__(self):
        self.calls: List[Call] = []
        self._spans: List[str] = []
        # the open outermost block, and how many blocks are open
        self._open: Optional[Timeline] = None
        self._depth = 0
        self._captured: Optional[List[Timeline]] = None
        # the finished blocks of the open call, read when it ends
        self._done: List[Timeline] = []

    @contextlib.contextmanager
    def span(self, name: str):
        with _profiled(name) if torch.autograd._profiler_enabled() else _NULL:
            if not self._spans:
                self.calls.append(Call(name))
            call = self.calls[-1]
            self._spans.append(name)
            path = "/".join(self._spans)
            call.span_s[path] += 0.0  # listed in the order the spans open
            t0 = time.perf_counter()
            try:
                yield
            finally:
                seconds = time.perf_counter() - t0
                self._spans.pop()
                call.span_s[path] += seconds
                done = []
                if not self._spans:
                    call.wall_s = seconds
                    done, self._done = self._done, []
            # read only after a call that returned (an exception may leave
            # its marks unrecorded)
            self._read(call, done)

    def add(self, timeline: Timeline) -> None:
        """A finished outermost block, for the open call (read when the
        call ends; a replay's marks hold until the next replay)."""
        if self._spans:
            self._done.append(timeline)

    @staticmethod
    def _read(call: Call, done: List[Timeline]) -> None:
        for timeline in done:
            if timeline.device.type == "cuda":
                timeline.stamps[-1].synchronize()
            call.block_ms += timeline.total_ms()
            for name, ms in timeline.intervals():
                if name is not None:
                    call.phase_ms[name] += ms
            for name, value in timeline.tallies.items():
                call.counts[name] += int(value)
            call.device_clock = timeline.device.type == "cuda"

    def report(self) -> str:
        """Each call's wall time, counters, block time by phase and host
        spans, one block of lines per call."""
        lines = []
        for n, c in enumerate(self.calls):
            counts = ", ".join(f"{k} {v}" for k, v in sorted(c.counts.items()))
            lines.append(f"call {n} {c.name}: wall {c.wall_s * 1e3:.3f} ms; {counts}")
            if c.block_ms:
                phases = ", ".join(f"{k} {v:.3f}" for k, v in c.phase_ms.items())
                clock = "device" if c.device_clock else "host"
                lines.append(f"  blocks {c.block_ms:.3f} ms ({clock} clock): {phases}")
            for path, s in c.span_s.items():
                lines.append(f"  {'  ' * path.count('/')}{path.rsplit('/', 1)[-1]} "
                             f"{s * 1e3:.3f} ms")
        return "\n".join(lines)


@contextlib.contextmanager
def tracing():
    """Program tracing on for the region: yields its ``Recorder``."""
    global _recorder
    outer, _recorder = _recorder, Recorder()
    try:
        yield _recorder
    finally:
        _recorder = outer


def tracing_on() -> bool:
    return _recorder is not None


def _profiled(name: str):
    """A record function of ``name`` in the operators' scope."""
    return torch._C._profiler._RecordFunctionFast(name)


def span(name: str):
    """A host span (see the module docstring)."""
    if _recorder is not None:
        return _recorder.span(name)
    if torch.autograd._profiler_enabled():
        return _profiled(name)
    return _NULL


def phase(name: str) -> None:
    """Start phase ``name`` in the open block (nothing when tracing is off,
    no block is open, or the innermost block lies inside another)."""
    if _recorder is not None and _recorder._depth == 1:
        _recorder._open.mark(name)


def tallying() -> bool:
    """Whether ``tally`` counts here: tracing is on and the innermost open
    block is the outermost (as for ``phase``)."""
    return _recorder is not None and _recorder._depth == 1


def tally(name: str, value: torch.Tensor) -> None:
    """Add the device scalar ``value`` to counter ``name`` of the open
    block, where ``tallying()`` (the caller checks it before computing
    ``value``)."""
    if tallying():
        _recorder._open.tally(name, value)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the open call."""
    if _recorder is not None and _recorder._spans:
        _recorder.calls[-1].counts[name] += int(n)


@contextlib.contextmanager
def block(device):
    """A block of marks on ``device``: its timeline goes into the graph
    being captured (``capturing``) or, run eagerly, into the open call. A
    block inside another (an ensemble's replicate) marks nothing, so the
    outer block's graph holds only its own two marks."""
    rec = _recorder
    if rec is None:
        yield
        return
    rec._depth += 1
    timeline = None
    if rec._depth == 1:
        timeline = rec._open = Timeline(torch.device(device))
    try:
        yield
    finally:
        rec._depth -= 1
        if timeline is not None:
            rec._open = None
            timeline.close()
            if rec._captured is not None:
                rec._captured.append(timeline)
            else:
                rec.add(timeline)


@contextlib.contextmanager
def capturing():
    """While a CUDA graph is captured: yields the list that collects the
    outermost blocks' timelines, for ``replayed`` after each replay (an
    empty list with tracing off)."""
    rec = _recorder
    captured: List[Timeline] = []
    if rec is None:
        yield captured
        return
    outer, rec._captured = rec._captured, captured
    try:
        yield captured
    finally:
        rec._captured = outer


def replayed(timelines: List[Timeline]) -> None:
    """A replay's blocks, into the open call, whose end reads their marks
    (after the replay's probe fetch, which has waited for the stream)."""
    if _recorder is not None:
        for timeline in timelines:
            _recorder.add(timeline)
