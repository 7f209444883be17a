"""Device ms per step of the step's ``sort`` phase: the neighbour grid, the
state's sort into it, the run bounds and the sums' grouping. Read from the
program's timing marks in graph replays (``portbench/spans.py``); the six
step phases tile the step. Nothing on the CPU."""

from portbench.spans import phase_ms_per_step


def read(run):
    return phase_ms_per_step(run, "sort")
