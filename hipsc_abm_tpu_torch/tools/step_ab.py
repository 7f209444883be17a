"""Launches and device ms per step of the 2D bench colony (id-list path) at
1k and 100k cells, for several checkouts in turns, each in a process of its
own (on the card):

    python hipsc_abm_tpu_torch/tools/step_ab.py ROOT [ROOT ...]

Give the roots in turns (parent, change, change, parent) to compare two
versions within one call. For each root and size: 3 ``safe_step``s to warm
up, then the eager ``step`` and ``safe_step`` (a captured block of one
step), each profiled over 3 calls (device ms and device launches per step,
``tools.device_kernels``), the device ms and launches of the update kernel
per step where the root has one, and the host ms per call over 20 more. One
``AB {json}`` line per root.
"""

import json
import os
import subprocess
import sys

CHILD = r'''
import json, sys, time
root = sys.argv[1]
sys.path.insert(0, root)
import torch
import chip_smoke as cs
from hipsc_abm_tpu_torch import kernels
from hipsc_abm_tpu_torch.tools import device_kernels
assert kernels.__file__.startswith(root + "/"), kernels.__file__
out = {}
for n in (1000, 100000):
    eng, state = cs.engine_for(2, n, "cuda", "id_list")
    for _ in range(3):
        state, _ = eng.safe_step(state)
    carry = [state]
    def eager():
        carry[0], _ = eng.step(carry[0])
    def replay():
        carry[0], _ = eng.safe_step(carry[0])
    row = {}
    for label, fn in (("step", eager), ("safe_step", replay)):
        ms, launches, by = device_kernels(fn, 3, ("update_kernel",))
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        upd = by.get("update_kernel", (0.0, 0.0))
        row[label] = dict(device_ms=round(ms, 4), launches=launches,
                          update_ms=round(upd[0], 5), update_launches=upd[1],
                          host_ms=round((time.perf_counter() - t) / 20 * 1e3, 4))
    out[n] = dict(row, capacity=eng.cfg.capacity)
    del eng, state, carry
    torch.cuda.empty_cache()
print("AB " + json.dumps({"root": root, **{str(k): v for k, v in out.items()}}))
'''


def main(roots) -> int:
    rc = 0
    for root in map(os.path.abspath, roots):
        proc = subprocess.run([sys.executable, "-c", CHILD, root], capture_output=True,
                              text=True, cwd=root, timeout=900)
        lines = [line for line in proc.stdout.splitlines() if line.startswith("AB ")]
        if not lines:
            rc = 1
            print("AB " + json.dumps({"root": root, "rc": proc.returncode,
                                      "err": proc.stderr[-2000:]}), flush=True)
        else:
            print(lines[-1], flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
