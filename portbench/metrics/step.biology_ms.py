"""Device ms per step of the step's ``biology`` phase: every bio-moments pass
(B4) with division, death, pathway, differentiation, the optional phases and
motility. Read from the program's timing marks in graph replays
(``portbench/spans.py``); the six step phases tile the step. Nothing on the
CPU."""

from portbench.spans import phase_ms_per_step


def read(run):
    return phase_ms_per_step(run, "biology")
