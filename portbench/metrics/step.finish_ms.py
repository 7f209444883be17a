"""Device ms per step of the step's ``finish`` phase: the scan's exit to slot
order, the zeroed forces, the probes and the probe row. Read from the
program's timing marks in graph replays (``portbench/spans.py``); the six
step phases tile the step. Nothing on the CPU."""

from portbench.spans import phase_ms_per_step


def read(run):
    return phase_ms_per_step(run, "finish")
