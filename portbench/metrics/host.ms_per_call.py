"""Of a call's host wall time, the ms its replays' device time does not
cover (``replay.device_ms_per_call``'s time): inputs, graph lookup, copies
in and out, the launch, the probe fetch and the growth check around the
replay, averaged over the calls of the traced program episode
(``portbench/spans.py``). Nothing on the CPU. Layer: engine loop and
blocks."""

from portbench.spans import device_calls


def read(run):
    calls = device_calls(run)
    if calls is None:
        return None
    return sum(c.wall_s * 1e3 - c.block_ms for c in calls) / len(calls)
