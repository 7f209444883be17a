"""Contact-window rebuilds taken per step (of the 10 that each step's later
substeps may take): the program's ``rebuilds`` counter, from the probes'
``jkr_rebuilds`` (``HipscEngine.window_rebuilds``), over the steps of the
traced program episode (``portbench/spans.py``). Layer: contact
substeps."""

from portbench.spans import reading, steps


def read(run):
    calls = reading(run)
    if not calls or not steps(calls):
        return None
    return sum(c.counts["rebuilds"] for c in calls) / steps(calls)
