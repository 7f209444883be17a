"""Device ms per step of the step's ``window`` phase: the contact scan's entry
window and every later substep's predicated rebuild. Read from the program's
timing marks in graph replays (``portbench/spans.py``); the six step phases
tile the step. Nothing on the CPU."""

from portbench.spans import phase_ms_per_step


def read(run):
    return phase_ms_per_step(run, "window")
