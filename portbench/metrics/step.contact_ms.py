"""Device ms per step of the step's ``contact`` phase: the contact substeps
(B6, or B2/B1/B3), their updates and probes. Read from the program's timing
marks in graph replays (``portbench/spans.py``); the six step phases tile
the step. Nothing on the CPU."""

from portbench.spans import phase_ms_per_step


def read(run):
    return phase_ms_per_step(run, "contact")
