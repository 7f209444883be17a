"""Per-phase wall-time profiling (port of ``hipsc_abm_tpu/utils/profiling.py``).

``record_time`` and ``record_block`` store a method's or a block's wall time
in ``sim.method_times`` under its name, the keys the data CSV's columns take.
Kernel launches return before the card has finished, so ``record_block``
synchronises the card before it reads the clock when the simulation's engine
runs on CUDA. ``device_trace`` records a ``torch.profiler`` trace of a
region (the JAX package's ``jax.profiler`` hook).
"""

from __future__ import annotations

import contextlib
import os
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


@contextlib.contextmanager
def device_trace(log_dir: str | None):
    """A ``torch.profiler`` trace of the region (host activity, and the
    card's kernels and copies when CUDA is available), written to
    ``log_dir`` as a Chrome trace (``trace_<pid>_<n>.json``; open it in
    Perfetto or ``chrome://tracing``); nothing when ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    n = len([f for f in os.listdir(log_dir) if f.startswith(f"trace_{os.getpid()}_")])
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{n}.json"))
