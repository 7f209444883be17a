"""The synchronising CUDA calls (host reads) of the engine on the card, with
the lines of the port that made them::

    python -m hipsc_abm_tpu_torch.tools.sync_probe

For each main path at a small size (the 2D bench configuration at 20,000
cells on both contact paths, the 3D spheroid at 3,300 cells with the
optional phases on both paths, and the 2D span-mask path with them), one
``step`` after a ``safe_step`` runs under ``torch.cuda.set_sync_debug_mode
("warn")``: every synchronising call is listed with the three innermost
frames of the port (the enabling call itself shows as one without them).
Then, for three paths, a 5-step ``run_steps`` block is captured, and a
second block is run under the same mode: its synchronising calls are
listed (the probe fetch is the one expected), with the first call's and
the replay's wall time and the captured graph. Needs the card.
"""

from __future__ import annotations

import collections
import os
import sys
import time
import traceback
import warnings

import torch


def main() -> int:
    if not torch.cuda.is_available():
        print("sync_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    print("torch", torch.__version__, "cuda", torch.version.cuda, torch.cuda.get_device_name(0))
    seen: collections.OrderedDict = collections.OrderedDict()

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        stack = traceback.extract_stack()[:-1]
        frames = [f for f in stack if "/hipsc_abm_tpu_torch/" in f.filename] or stack
        key = tuple(f"{os.path.relpath(f.filename)}:{f.lineno} {f.line}" for f in frames[-4:])
        seen[key] = seen.get(key, 0) + 1

    def report(label, extra=""):
        print(f"== {label}: {sum(seen.values())} syncs{extra}")
        for key, n in seen.items():
            print(f"  x{n}: " + " <- ".join(reversed(key)))

    warnings.showwarning = hook
    warnings.simplefilter("always")
    for dims, n, path, opt in ((2, 20000, "id_list", False), (2, 20000, "span_mask", False),
                               (3, 3300, "id_list", True), (3, 3300, "span_mask", True),
                               (2, 20000, "span_mask", True)):
        eng, state = cs.engine_for(dims, n, "cuda", path, opt)
        state, _ = eng.safe_step(state)
        torch.cuda.synchronize()
        seen.clear()
        torch.cuda.set_sync_debug_mode("warn")
        state, _ = eng.step(state)
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        report(f"{dims}D {path} optional={opt}")

    for dims, n, path in ((2, 20000, "id_list"), (2, 20000, "span_mask"), (3, 3300, "span_mask")):
        eng, state = cs.engine_for(dims, n, "cuda", path)
        state, _ = eng.safe_step(state)
        t0 = time.perf_counter()
        eng.run_steps(state, 5)
        t1 = time.perf_counter()
        seen.clear()
        torch.cuda.set_sync_debug_mode("warn")
        eng.run_steps(state, 5)
        torch.cuda.set_sync_debug_mode(0)
        t2 = time.perf_counter()
        report(f"block {dims}D {path}", f"; first call {t1 - t0:.2f} s, replay call "
               f"{t2 - t1:.3f} s; graphs {eng.block_graphs()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
