"""The benchmark's command: one run of one cell.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port ``hipsc_abm_tpu_torch``, on
a machine with an NVIDIA card. The cell (an entry of ``BENCHMARK.json``)
names a configuration and a traffic mix; the traffic names the program's
entry (``entries/<name>.py``). A run:

1. builds the entry's engine and makes the seeded colony, runs one whole
   warm-up episode (kernel build or load, capacity growth, graph capture)
   and makes the seeded colony again under the grown config: ``setup_s``,
   from the process's start to the first timed call;
2. measures for ``--seconds``: whole episodes of the entry's calls, each
   from a device copy of the seeded colony, until the first episode that
   ends past the deadline; ``--trace 1`` puts ``torch.profiler`` over the
   first ``TRACED_EPISODES``;
3. reads the peak device memory and the cell's metrics in
   ``BENCHMARK.json`` (``metrics/<name>.py``: with ``--trace 0`` the
   end-to-end ones, with ``--trace 1`` the per-layer ones), then frees the
   program and compares the last episode's first and last stretches with
   the plain reference (``check``);
4. prints the numbers compared beside their limits as the last lines of
   standard error, and one JSON line as the last line of standard output.

It exits with 1 and prints no result when no card is present, or when
``jax``, ``jaxlib``, ``flax`` or the JAX package is loaded once the window
has closed.
"""

from __future__ import annotations


def _process_age_s() -> float:
    """Seconds since this process started (``/proc/self/stat``), or 0
    where that cannot be read."""
    import os

    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


def _pin_cores() -> None:
    """Keep the process on a fixed pair of the host's cores (the third and
    fourth it may use; every thread it starts inherits them): the ensemble's
    host between replays read 3-7% slower in whole runs that landed
    elsewhere. Nothing where the host offers fewer than four."""
    import os

    try:
        cores = sorted(os.sched_getaffinity(0))
        if len(cores) >= 4:
            os.sched_setaffinity(0, cores[2:4])
    except (AttributeError, OSError):
        pass


import time  # noqa: E402

# the process's start on the host clock, taken before any heavy import
T_START = time.perf_counter() - _process_age_s()
if __name__ == "__main__":
    _pin_cores()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from contextlib import nullcontext  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

import torch  # noqa: E402

from portbench import catalog, check, peaks  # noqa: E402
from portbench import trace as trace_mod  # noqa: E402
from portbench.colony import colony as make_colony  # noqa: E402

# the imports done (torch's among them)
T_IMPORTED = time.perf_counter()

# top-level module names that may not be loaded in a run (whole names)
FORBIDDEN = ("jax", "jaxlib", "flax", "hipsc_abm_tpu")
# the window's first episodes that the traced run profiles
TRACED_EPISODES = 1


def forbidden_modules() -> List[str]:
    """The loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


class Window:
    """What the measured window did: its seconds, each call's seconds and
    attempts, the steps and agent-steps completed, each episode's seconds,
    and the calls whose probes differed from the same call of the first
    episode."""

    def __init__(self):
        self.seconds = 0.0
        self.calls: List[float] = []
        self.attempts: List[int] = []
        self.steps = 0
        self.agent_steps = 0
        self.episodes: List[float] = []
        self.unlike_first = 0


class Run:
    """One run's readings, which the metric readers (``metrics/``) read:
    ``window`` (``Window``), ``setup_s``, ``captures`` (capture seconds of
    every graph set-up made), ``entry`` (the program's entry), ``card``,
    and with ``--trace 1`` ``trace`` (``trace.Reading``), ``traced_steps``
    and ``traced_calls`` (of the traced episodes) and ``family_work``
    (``count_work``, made when a reader first asks for ``work``)."""

    def __init__(self, entry, card: str, root: Optional[Path] = None):
        self.entry, self.card, self.root = entry, card, root
        self.window = Window()
        self.setup_s = 0.0
        self.captures: List[float] = []
        self.trace: Optional[trace_mod.Reading] = None
        self.traced_steps = 0
        self.traced_calls = 0
        self.family_work: Optional[Dict[str, Dict[str, float]]] = None

    def count_work(self) -> None:
        """The least time on this card of each kernel family's work
        (``counts/<family>.py``) in the traced calls, by what bounds it:
        ``family_work[family] = {"bytes": s, "operations": s}``. The traced
        calls are replayed after the window from the episode's start (every
        episode runs the same inputs), so that the traced window holds no
        state for the counts."""
        self.family_work = {}
        if peaks.of(self.card) is None or not self.traced_calls:
            return
        families = {f: catalog.load_module("counts", f, self.root)
                    for f in catalog.names("counts", self.root)}
        work = {f: {"bytes": 0.0, "operations": 0.0} for f in families}
        entry = self.entry
        state = entry.reset()
        for n in range(self.traced_calls):
            index = n % entry.calls_per_episode
            if n and index == 0:
                state = entry.reset()
            for view in entry.colonies(state):
                for f, counts in families.items():
                    nbytes, ops = counts.per_step(view, entry)
                    if nbytes or ops:
                        t, by = peaks.least_seconds(nbytes, ops, self.card)
                        work[f][by] += entry.block * t
            state, _ = entry.call(state, index)
        self.family_work = work

    def work(self, family: str) -> Optional[tuple]:
        """``(least seconds, bound by, kernel seconds)`` of a kernel family
        over the traced calls: the least time of its work on this card, what
        bounds most of it, and the device time of the family's kernels in
        the trace. None without a trace, peaks or work."""
        if self.family_work is None:
            self.count_work()
        work = self.family_work.get(family)
        if self.trace is None or not work or sum(work.values()) <= 0:
            return None
        kernels = catalog.load_module("counts", family, self.root).KERNELS
        kernel_s = sum(s for name, s in self.trace.op_s.items() if any(k in name for k in kernels))
        if kernel_s <= 0:
            return None
        return sum(work.values()), max(work, key=work.get), kernel_s


def _card(device: str) -> str:
    return torch.cuda.get_device_name() if device == "cuda" else "cpu"


def _power_line() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout.strip()
        return out.splitlines()[0] if out else "nvidia-smi: no card"
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc}"


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def run_cell(workload: str, seed: int, seconds: float, traced: bool, device: str = "cuda",
             root: Optional[Path] = None, log=print) -> dict:
    """One run of ``workload``: the result line's dict, with the numbers
    compared under ``checks``. ``device`` "cpu" runs the program's plain
    versions (the tests; no metric of the device is read then); ``root``
    is the folder the benchmark's files are read from."""
    cell = catalog.cell(workload, root)
    config = catalog.load_json("configs", cell["config"], root)
    traffic = catalog.load_json("traffic", cell["traffic"], root)
    colony = make_colony(config, traffic, seed)
    entry_mod = catalog.load_module("entries", traffic["entry"], root)
    t_context = time.perf_counter()
    card = _card(device)  # makes the CUDA context on the card

    t0 = time.perf_counter()
    entry = entry_mod.Entry(colony, traffic, seed, device)
    horizon = entry.calls_per_episode * entry.block
    first = check.CHECK_STEPS
    if horizon < 2 * first or first % entry.block:
        raise ValueError(f"{workload}: an episode of {horizon} steps in calls of "
                         f"{entry.block} has no two compared stretches of {first} steps")
    entry.setup()
    run = Run(entry, card, root)
    run.captures = list(entry.captures)
    parts = ", ".join(f"{k} {v:.3f}" for k, v in entry.timings.items())
    log(f"portbench: {workload} seed {seed} on {card}: set-up {time.perf_counter() - t0:.3f} s "
        f"in the entry ({parts}; captures {sum(run.captures):.3f} of the warm-up), "
        f"before it {t0 - T_START:.3f} s (imports {T_IMPORTED - T_START:.3f}, CUDA context "
        f"{t0 - t_context:.3f}); graphs {entry.graphs()}")

    window, probes_first, kept = run.window, [], {}
    # the states the check reads, by the steps done in an episode
    checked = (first, horizon - first, horizon)
    prof = _profiler(device) if traced else None
    episode = 0
    run.setup_s = time.perf_counter() - T_START
    t_start = time.perf_counter()
    deadline = t_start + seconds
    if prof is not None:
        prof.__enter__()
    while True:
        tracing = prof is not None and episode < TRACED_EPISODES
        t_episode = time.perf_counter()
        with _span(traced, "episode.reset"):
            state = entry.reset()
        kept = {}
        for index in range(entry.calls_per_episode):
            t = time.perf_counter()
            with _span(traced, "entry.call"):
                state, call = entry.call(state, index)
            window.calls.append(time.perf_counter() - t)
            window.attempts.append(call.attempts)
            window.steps += call.steps
            window.agent_steps += call.agent_steps
            if (index + 1) * entry.block in checked:
                kept[(index + 1) * entry.block] = state
            if episode == 0:
                probes_first.append(call.probes)
            elif call.probes != probes_first[index]:
                window.unlike_first += 1
            if tracing:
                run.traced_steps += call.steps
                run.traced_calls += 1
        episode += 1
        if tracing and episode == TRACED_EPISODES:
            _sync(device)
            prof.__exit__(None, None, None)
        end = time.perf_counter()
        window.episodes.append(end - t_episode)
        # the window ends with the first whole episode past the deadline
        if end >= deadline:
            break
    window.seconds = time.perf_counter() - t_start
    del state
    if prof is not None:
        run.trace = trace_mod.read(prof)

    memory_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for name, unit in catalog.metrics_of(workload, kind, root):
        value = catalog.load_module("metrics", name, root).read(run)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": unit}
    log(f"portbench: window {window.seconds:.3f} s, {len(window.calls)} calls, "
        f"{window.steps} steps, {window.agent_steps} agent-steps, {episode} episodes "
        f"(seconds: {', '.join(f'{s:.4f}' for s in window.episodes)}); peak {memory_peak} B")
    for family in run.family_work or {}:
        work = run.work(family)
        if work is not None:
            log(f"portbench: {family}: least {work[0] * 1e3:.6f} ms ({work[1]}) against "
                f"{work[2] * 1e3:.6f} ms of its kernels; peaks {peaks.of(card)}")

    cases = entry.check_cases(kept, first, horizon)
    graphs, program_caps = entry.graphs(), entry.caps()
    entry.close()
    del entry, kept
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t_ref = time.perf_counter()
    readings, margins = [], []
    for case in cases:
        out, caps = check.reference_output(colony if case.seed == seed
                                           else make_colony(config, traffic, case.seed),
                                           case, device)
        readings.append(check.compare(case.output, out))
        margins.append(check.clip_margin(caps, program_caps))
    numbers = check.worst(readings)
    numbers["calls_unlike_first"] = window.unlike_first
    log(f"portbench: reference {time.perf_counter() - t_ref:.3f} s for {len(cases)} stretches "
        f"of {first} steps (from steps {sorted({c.first_step for c in cases})}); program's "
        f"capacities {program_caps}; rows to the sums' span clip, least per stretch {margins}")
    result = {
        "correct": check.is_correct(numbers),
        "attempted": len(window.calls),
        "failed": window.unlike_first + int(not check.is_correct(numbers)),
        "metrics": metrics,
        "device": {"platform": "gpu" if device == "cuda" else device, "kind": card,
                   "count": 1, "memory_peak_bytes": int(memory_peak)},
    }
    if run.trace is not None:
        result["device"]["busy_s"] = run.trace.busy_s
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = trace_mod.breakdown(run.trace)
    result["graphs"] = graphs
    result["checks"] = {k: {"value": v, "limit": check.LIMITS[k]} for k, v in numbers.items()}
    return result


def _span(traced: bool, name: str):
    if not traced:
        return nullcontext()
    return torch.profiler.record_function(name)


def _profiler(device: str):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("portbench: no CUDA device: the benchmark runs on the card only", file=sys.stderr)
        return 1
    seed = args.seed % (1 << 63)
    # the host only launches and fetches: one thread keeps its load steady
    torch.set_num_threads(1)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    result = run_cell(args.workload, seed, args.seconds, bool(args.trace), log=log)
    log(f"portbench: {_power_line()}; torch {torch.__version__} cuda {torch.version.cuda}")
    found = forbidden_modules()
    if found:
        log(f"portbench: modules of JAX or the JAX package are loaded: {found}")
        return 1
    log(f"portbench: device memory peak {result['device']['memory_peak_bytes']} B")
    for k, v in result["checks"].items():
        log(f"check {k} {v['value']} (limit {v['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
