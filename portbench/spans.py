"""The program's own tracing (``hipsc_abm_tpu_torch.utils.profiling``), read
for the per-layer metrics of a ``--trace 1`` run.

After the window, two more episodes of the cell's entry run under
``profiling.tracing()``, without ``torch.profiler``: the first captures the
entry's graph again with its timing marks (a graph captured with tracing off
holds none), the second is read. The window, the peak memory and the check
do not see them. The reading is made once a run and kept on it
(``run.program_spans``), as ``Run.count_work`` keeps its own. A program
without this tracing gives no reading, and its metrics nothing.
"""

from __future__ import annotations

from typing import List, Optional

# the episodes run under tracing; the last is read
EPISODES = 2


def reading(run) -> Optional[list]:
    """The ``profiling.Call`` of each call of the read episode, or None."""
    if not hasattr(run, "program_spans"):
        run.program_spans = _read(run)
    return run.program_spans


def _read(run) -> Optional[list]:
    try:
        from hipsc_abm_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "tracing"):
        return None
    entry = run.entry
    for _ in range(EPISODES):
        with profiling.tracing() as recorder:
            state = entry.reset()
            for index in range(entry.calls_per_episode):
                state, _ = entry.call(state, index)
            del state
    return recorder.calls or None


def device_calls(run) -> Optional[list]:
    """The read calls when their blocks were timed on the device (CUDA
    events), else None: the CPU's host clock is no device time."""
    calls = reading(run)
    if not calls or not all(c.device_clock for c in calls):
        return None
    return calls


def steps(calls: List) -> int:
    return sum(c.counts["steps"] for c in calls)


def phase_ms_per_step(run, name: str) -> Optional[float]:
    """Device ms per step of step phase ``name`` (``profiling.phase``)."""
    calls = device_calls(run)
    if calls is None or not any(name in c.phase_ms for c in calls) or not steps(calls):
        return None
    return sum(c.phase_ms.get(name, 0.0) for c in calls) / steps(calls)
