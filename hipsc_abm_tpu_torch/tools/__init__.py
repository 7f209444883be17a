"""Probes of the port: ``dynslice_probe`` (P1) and ``dynslice_probe2`` (P2),
the counterparts of the JAX package's Mosaic window probes
``tools/dynslice_probe.py`` and ``tools/dynslice_probe2.py``, at their
shapes and repetitions. Each runs on the card unless ``--device cpu`` asks
for its plain version::

    python -m hipsc_abm_tpu_torch.tools.dynslice_probe [modes]
    python -m hipsc_abm_tpu_torch.tools.dynslice_probe2 --device cpu full

On the card, ``python -m hipsc_abm_tpu_torch.tools.sync_probe`` lists the
synchronising calls (host reads) of a step and of a ``run_steps`` block.
A step's device time by phase, in graph replays, is ``utils.profiling``'s.

This module holds what the tools and ``chip_smoke.py`` share: the command
line, the timing, the device-time profile of a call, and the recording of
the engine's bio-moments calls.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Sequence

import torch


def parse_args(argv: Sequence[str], modes: Sequence[str], doc: str) -> argparse.Namespace:
    """``[modes] [--device D]``; no modes means all."""
    p = argparse.ArgumentParser(description=doc)
    p.add_argument("modes", nargs="*", help=f"any of {', '.join(modes)} (default: all)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernel, the default) or cpu (the plain version)")
    args = p.parse_args(list(argv))
    unknown = sorted(set(args.modes) - set(modes))
    if unknown:
        p.error(f"unknown modes {unknown}; choose from {list(modes)}")
    args.modes = args.modes or list(modes)
    return args


def time_ms(fn: Callable[[], object], reps: int, device: torch.device) -> float:
    """Mean milliseconds per call after one warm-up call: CUDA events on the
    card, the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_kernels(fn: Callable[[], object], calls: int, names: Sequence[str] = (),
                   warmup: bool = True) -> tuple:
    """Device time and launches per call of ``fn`` under ``torch.profiler``,
    over ``calls`` calls (after one unprofiled warm-up call unless
    ``warmup`` is false): ``(ms, launches, by_kernel)``. The first two count
    every device activity with device time (kernels, copies, fills).
    ``by_kernel`` maps each of ``names`` to the (ms, launches) per call of
    the kernels whose profiler name contains it, or, with no ``names``, each
    kernel's full name to its own."""
    from torch.profiler import ProfilerActivity, profile

    if warmup:
        fn()
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total, launches, by_kernel = 0.0, 0, {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        if t <= 0:
            continue
        total += t
        launches += e.count
        for key in [n for n in names if n in e.key] if names else [e.key]:
            ms, n = by_kernel.get(key, (0.0, 0.0))
            by_kernel[key] = (ms + t / 1e3 / calls, n + e.count / calls)
    return total / 1e3 / calls, launches / calls, by_kernel


def kernel_ms(fn: Callable[[], object], name: str, calls: int) -> float:
    """Device ms per launch of the kernel ``name`` names, alone (``fn``
    called ``calls`` times); nan when it never launched."""
    ms, launches = device_kernels(fn, calls, (name,))[2].get(name, (0.0, 0.0))
    return ms / launches if launches else float("nan")


def record_bio_calls(eng, state) -> list:
    """The arguments of the engine's bio-moments calls in one ``step`` from
    ``state``: ``[(args, kwargs)]``, in call order (count, pathway, with
    diff_surround on its motility-mode call, then motility). The engine
    calls ``bio_moments_cuda`` by its module-level name, which is wrapped
    for the step."""
    from hipsc_abm_tpu_torch import engine as engine_mod

    calls = []
    real = engine_mod.bio_moments_cuda

    def record(*args, **kw):
        calls.append((args, dict(kw)))
        return real(*args, **kw)

    engine_mod.bio_moments_cuda = record
    try:
        eng.step(state)
    finally:
        engine_mod.bio_moments_cuda = real
    return calls
