"""Of the traced window, the share in which no operation ran on the device:
one minus the union of the device's activity intervals over the window
(never the sum of their times: an ensemble's streams overlap). Layer:
device."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return 1.0 - run.trace.busy_s / run.trace.window_s
