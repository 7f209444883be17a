"""Probes of the port: ``dynslice_probe`` (P1) and ``dynslice_probe2`` (P2),
the counterparts of the JAX package's Mosaic window probes
``tools/dynslice_probe.py`` and ``tools/dynslice_probe2.py``, at their
shapes and repetitions. Each runs on the card unless ``--device cpu`` asks
for its plain version::

    python -m hipsc_abm_tpu_torch.tools.dynslice_probe [modes]
    python -m hipsc_abm_tpu_torch.tools.dynslice_probe2 --device cpu full

This module holds what the two share: the command line and the timing.
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
