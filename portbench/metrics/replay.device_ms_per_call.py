"""Device ms of a call's graph replays, from the replay's first timing mark
to its last (the block's start to after its probe stack; in an ensemble,
before the branches' fork to after their join), averaged over the calls of
the traced program episode (``portbench/spans.py``). Nothing on the CPU.
Layer: engine loop and blocks."""

from portbench.spans import device_calls


def read(run):
    calls = device_calls(run)
    return None if calls is None else sum(c.block_ms for c in calls) / len(calls)
