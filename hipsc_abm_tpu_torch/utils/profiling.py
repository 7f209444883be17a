"""Per-phase wall-time profiling (port of ``hipsc_abm_tpu/utils/profiling.py``).

``record_time`` and ``record_block`` store a method's or a block's wall time
in ``sim.method_times`` under its name, the keys the data CSV's columns take.
Kernel launches return before the card has finished, so ``record_block``
synchronises the card before it reads the clock when the simulation's engine
runs on CUDA.
"""

from __future__ import annotations

import contextlib
import time
from functools import wraps

import torch


def record_time(function):
    """Decorator storing the method's wall time in ``sim.method_times``
    under the method's name."""

    @wraps(function)
    def wrap(simulation, *args, **kwargs):
        start = time.perf_counter()
        result = function(simulation, *args, **kwargs)
        simulation.method_times[function.__name__] = time.perf_counter() - start
        return result

    return wrap


@contextlib.contextmanager
def record_block(simulation, name: str):
    """Context-manager form for timing inline blocks (the fused step); the
    card's queued work is waited for before the time is taken."""
    start = time.perf_counter()
    try:
        yield
    finally:
        engine = getattr(simulation, "engine", None)
        if engine is not None and engine.device.type == "cuda":
            torch.cuda.synchronize(engine.device)
        simulation.method_times[name] = time.perf_counter() - start
