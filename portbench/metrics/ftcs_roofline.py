"""The least time of the traced steps' ftcs work on this card (the
larger of its bytes over the memory rate and its float32 operations over
the float32 rate, ``counts/ftcs.py``) as a share of the device time
its kernels took in the trace. Nothing where none of them ran."""


def read(run):
    work = run.work("ftcs")
    return None if work is None else 100.0 * work[0] / work[2]
