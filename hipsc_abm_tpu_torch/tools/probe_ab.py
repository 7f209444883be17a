"""The window probes P1 and P2 of several checkouts, in turns, on one card.

    python hipsc_abm_tpu_torch/tools/probe_ab.py ROOT [ROOT ...]

Each ROOT runs in a process of its own, in the order given (A B B A for an
A/B in turns), with that checkout's ``hipsc_abm_tpu_torch``: for every mode
of both probes at the probes' NBLK = 4096 it holds the kernel against its
plain version (P1 rtol 1e-5, atol 1e-5; P2 rtol 1e-4, atol 1e-4 x
max|out|, as ``chip_smoke.py`` does), times the kernel alone per launch
under ``torch.profiler`` (``hipsc_abm_tpu_torch.tools.device_kernels``, 20
launches after one; "not measured" when two profiler passes record none)
and the probe's entry point (``run``: REPS calls after one, CUDA events),
and prints one JSON line per mode. Then a table of the
kernel-alone times of every run per mode, with the card's name and power
limit. Exits non-zero if a run fails or disagrees with its plain version.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

LAUNCHES = 20


def child(root: str) -> None:
    sys.path.insert(0, root)
    import torch

    from hipsc_abm_tpu_torch.tools import device_kernels
    from hipsc_abm_tpu_torch.tools import dynslice_probe as p1
    from hipsc_abm_tpu_torch.tools import dynslice_probe2 as p2

    if not torch.cuda.is_available():
        raise SystemExit("probe_ab: no CUDA device")
    for probe in (p1, p2):
        name = probe.__name__.rsplit(".", 1)[1]
        inputs = probe.make_inputs(probe.NBLK, "cuda")
        for mode in probe.MODES:
            got = probe.probe_cuda(*inputs, mode)
            want = probe.probe_plain(*inputs, mode)
            scale = float(want.abs().max())
            if probe is p1:
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            else:
                torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)
            err = float((got - want).abs().max())
            kname = f"{name}_kernel"
            # a profiler pass now and then records no kernel: one more try
            for _ in range(2):
                prof = device_kernels(lambda: probe.probe_cuda(*inputs, mode), LAUNCHES,
                                      (kname,))[2]
                if kname in prof:
                    break
            ms, launches = prof.get(kname, (float("nan"), 1.0))
            entry = probe.run(mode)
            print(json.dumps(dict(root=root, probe=name, mode=mode, kernel_ms=ms / launches,
                                  entry_ms=entry["ms"], max_abs_err=err, max_out=scale)),
                  flush=True)


def main(roots) -> int:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    rows, rc = [], 0
    for i, root in enumerate(roots):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root],
                              capture_output=True, text=True)
        sys.stdout.write(proc.stdout)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            print(f"probe_ab: run {i} ({root}) failed with exit code {proc.returncode}")
            rc = 1
        rows += [dict(json.loads(line), run=i) for line in proc.stdout.splitlines()
                 if line.startswith("{")]
    print(f"kernel alone, ms per launch (profiler, {LAUNCHES} launches), "
          f"runs in order {' '.join(str(i) for i in range(len(roots)))} [{card}]")
    for key in dict.fromkeys((r["probe"], r["mode"]) for r in rows):
        ms = {r["run"]: r["kernel_ms"] for r in rows if (r["probe"], r["mode"]) == key}
        print(f"{key[0]}[{key[1]}]: " + " / ".join(
            f"{ms[i]:.5f}" if i in ms and ms[i] == ms[i] else "not measured"
            for i in range(len(roots))))
    return rc


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child(sys.argv[2])
    elif len(sys.argv) > 1:
        sys.exit(main(sys.argv[1:]))
    else:
        sys.exit(__doc__)
