"""Where a step's device time goes: the kernels of the main paths' eager
step by device time, under ``torch.profiler``, and one block of
``run_steps`` (a CUDA graph replay) beside it::

    python -m hipsc_abm_tpu_torch.tools.step_profile [--top 25]

Each cell (the 2D bench configuration at 100k and 500k cells, the 3D
spheroid at 99k, as ``chip_smoke.py`` builds them) runs ``init_state``, 3
``safe_step`` warm-ups and then 2 profiled ``step``s; the lines give each
kernel's device ms and launches per step. Then the row gather of the bond
table against the gather of its flat elements (``engine.take_rows``) at
the 100k and 500k shapes. Needs the card.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch


def top_kernels(fn, calls: int, top: int) -> list:
    from hipsc_abm_tpu_torch.tools import device_kernels

    total, launches, by = device_kernels(fn, calls)
    rows = sorted(by.items(), key=lambda kv: -kv[1][0])[:top]
    return total, launches, rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--top", type=int, default=25)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("step_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from hipsc_abm_tpu_torch.engine import take_rows

    for dims, n, path in ((2, cs.N_MAIN, "id_list"), (2, cs.N_LARGE, "id_list"),
                          (3, cs.N_MAIN_3D, "span_mask")):
        eng, state = cs.engine_for(dims, n, "cuda", path)
        for _ in range(3):
            state, _ = eng.safe_step(state)
        carry = [state]

        def step():
            carry[0], _ = eng.step(carry[0])

        total, launches, rows = top_kernels(step, 2, args.top)
        print(f"step_profile [{dims}D, {path}, {n}]: eager step, device {total:.4f} ms, "
              f"{launches:.0f} launches per step")
        for name, (ms, k) in rows:
            print(f"  {ms:9.4f} ms {k:7.1f}x  {name[:140]}")
        del eng, state, carry
        torch.cuda.empty_cache()

    for C in (143_104, 650_240):
        x = torch.randint(0, 1 << 30, (C, 8), dtype=torch.int32, device="cuda")
        order = torch.argsort(torch.rand(C, device="cuda"))
        for label, fn in (("x[order]", lambda: x[order]),
                          ("take_rows", lambda: take_rows(x, order))):
            total, _, rows = top_kernels(fn, 20, 3)
            print(f"step_profile gather ({C}, 8) int32 {label}: {total:.4f} ms per call "
                  f"{[name[:50] for name, _ in rows]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
