"""Device ms per step, and each contact and moments kernel's device ms per
launch and launches per step, of the 2D bench colony at 100k cells and the
3D spheroid at 99k cells, on both contact paths and both pair laws (the
uniform law, and the general law with the optional phases on and seeded
radii), for several checkouts in turns, each in a process of its own (on
the card):

    python hipsc_abm_tpu_torch/tools/step_ab.py ROOT [ROOT ...]

Give the roots in turns (parent, change, change, parent) to compare two
versions within one call. For each root and configuration
(``chip_smoke.engine_for``): 3 ``safe_step``s to warm up, then
``safe_step`` (the replay of a captured one-step block) profiled over 3
calls (``tools.device_kernels``: device ms and launches per step, and per
kernel), and the host ms per call over 10 more. One ``AB {json}`` line per
root.
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
KERNELS = ("contact_substep_kernel", "contact_mask_kernel<true", "contact_mask_kernel<false",
           "mask_compact_kernel", "bio_moments_kernel")
out = {}
for dims, n in ((2, cs.N_MAIN), (3, cs.N_MAIN_3D)):
    for path in ("id_list", "span_mask"):
        for law in ("uniform", "general"):
            eng, state = cs.engine_for(dims, n, "cuda", path, law == "general")
            assert (eng.cfg.uniform_radius is None) == (law == "general")
            for _ in range(3):
                state, _ = eng.safe_step(state)
            carry = [state]
            def replay():
                carry[0], _ = eng.safe_step(carry[0])
            ms, launches, by = device_kernels(replay, 3, KERNELS)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(10):
                replay()
            torch.cuda.synchronize()
            out[f"{dims}D {path} {law}"] = dict(
                cells=n, device_ms=round(ms, 4), launches=launches,
                host_ms=round((time.perf_counter() - t) / 10 * 1e3, 4),
                kernels={k: dict(ms_per_launch=round(v[0] / v[1], 5) if v[1] else None,
                                 launches=v[1]) for k, v in by.items()})
            del eng, state, carry
            torch.cuda.empty_cache()
print("AB " + json.dumps({"root": root, **out}))
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
