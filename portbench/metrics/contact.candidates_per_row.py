"""Candidates a contact row walks: the entry window's run widths summed
over its rows (dead rows' runs are empty) over its live rows, at each
step's entry build, from the program's counters ``contact.candidates`` and
``contact.live_rows`` (``profiling.tally``, summed on the device in the
traced graph) over the traced program episode (``portbench/spans.py``).
Nothing where the program has no such counter. Layer: contact substeps."""

from portbench.spans import reading


def read(run):
    calls = reading(run)
    if not calls:
        return None
    rows = sum(c.counts.get("contact.live_rows", 0) for c in calls)
    if not rows:
        return None
    return sum(c.counts.get("contact.candidates", 0) for c in calls) / rows
