"""The 95th percentile of every call of the cell's entry in the window, from
its launch to its return (the probe fetch included): the wait between a
user's outputs, re-executions and the episode's largest colony in it."""

import numpy as np


def read(run):
    return float(np.percentile(np.asarray(run.window.calls) * 1e3, 95))
