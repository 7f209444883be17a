#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):

1. card and toolchain: ``nvidia-smi`` name and power limit, ``nvcc
   --version``, and the build of the CUDA kernels from ``csrc/``;
2. kernels: each kernel against its plain PyTorch version on the card, on
   the inputs the main path gives it (the 100k-cell bench colony after
   ``init_state(seed=0)`` and one ``safe_step``), with times of both;
3. step: one ``step`` of the port from the same 20k-cell state on the CPU
   (plain versions) and on the card (kernels), compared by agent id;
4. main path: the bench configuration at 100k cells, ``init_state(seed=0)``,
   3 ``safe_step`` warm-ups and 5 timed ``step``s; steps/s, agents, peak
   memory, and the kernels' launch counts, which must all be > 0;
5. the same timed run at 500k cells (steps/s and peak memory).

The last lines are one JSON object with each kernel's numbers, the card's
name and power limit, and ``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

N_MAIN = 100_000
N_LARGE = 500_000
N_STEP_CHECK = 20_000
SEED = 0


def bench_engine(n_cells: int, device: str):
    """The bench configuration: a 2D box at reference colony density
    (side = 2000 * sqrt(n / 5000) um), n/10 GATA6-high cells, dox at step
    5, FGF4 secretion and FTCS diffusion on."""
    from hipsc_abm_tpu_torch.engine import HipscEngine
    from hipsc_abm_tpu_torch.params import (
        DiffusionParams, ExperimentalParams, GeneralParams)

    side = 2000.0 * (n_cells / 5000.0) ** 0.5
    gen = GeneralParams(num_to_start=n_cells, end_step=200, size=(side, side, 0.0))
    xp = ExperimentalParams(num_gata6=n_cells // 10, dox_step=5)
    diff = DiffusionParams(spat_res=20.0, diffuse_dt=6.0, diffuse_const=2.0,
                           max_concentration=2.0, degradation=0.1,
                           release_amount=0.01)
    return HipscEngine(gen, xp, diff=diff, enable_diffusion=True, device=device)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the card (CUDA events, after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def by_id(d: dict) -> dict:
    """Alive rows of a numpy state dict, sorted by agent id."""
    alive = d["alive"]
    ids = d["arrays"]["ids"][alive]
    order = np.argsort(ids)
    out = {k: v[alive][order] for k, v in d["arrays"].items()}
    partners = np.where(d["bond_mask"], d["partners"], -1)[alive][order]
    out["bonds"] = [frozenset(r[r >= 0].tolist()) for r in partners]
    return out


def kernel_phase(eng, state):
    """Each kernel against its plain version on the main path's inputs."""
    from hipsc_abm_tpu_torch import kernels
    from hipsc_abm_tpu_torch.ops import bio_moments, contact, diffusion, ftcs
    from hipsc_abm_tpu_torch.ops import neighbors as nbr
    from hipsc_abm_tpu_torch.ops.jkr import pack_physics

    cfg, bio, diff = eng.cfg, eng.bio, eng.diff
    a, alive = state.arrays, state.alive
    results = []

    # B6 contact substep: the physics scan's first substep of the next step
    grid = nbr.build_grid(cfg.jkr_spec, a["locations"], a["ids"], alive)
    o = grid.order
    args = (pack_physics(a["locations"][o], a["radii"][o]), a["ids"][o].contiguous(),
            alive[o].contiguous(), nbr.run_bounds(cfg.jkr_spec, grid.sorted_flat),
            state.bonds.ids()[o].contiguous())
    law = dict(radius=bio.jkr_radius, adhesion_const=bio.adhesion_const,
               poisson=bio.poisson, youngs=bio.youngs, break_d=bio.jkr_break_d,
               uniform_radius=cfg.uniform_radius)
    f_k, d_k, p_k = contact.contact_substep_cuda(*args, **law)
    f_p, d_p, p_p = contact.contact_substep_plain(*args, **law)
    torch.cuda.synchronize()
    f_scale = float(f_p.abs().max())
    f_err = float((f_k - f_p).abs().max())
    # uniform-radius pair law (kernel) vs general pair law (plain): the two
    # round differently by a few ulps of the force
    torch.testing.assert_close(f_k, f_p, rtol=1e-5, atol=1e-6 * f_scale)
    if not torch.equal(d_k, d_p):
        raise AssertionError("contact: degrees differ")
    sets_k = [frozenset(r[r >= 0].tolist()) for r in p_k.cpu().numpy()]
    sets_p = [frozenset(r[r >= 0].tolist()) for r in p_p.cpu().numpy()]
    bad = sum(x != y for x, y in zip(sets_k, sets_p))
    if bad:
        raise AssertionError(f"contact: bond sets differ on {bad} rows")
    results.append(dict(
        name="contact_substep", route="cuda",
        source="hipsc_abm_tpu_torch/csrc/contact.cu",
        replaces="hipsc_abm_tpu/ops/pallas_contact.py:79",
        max_abs_err=f_err,
        ms=cuda_ms(lambda: contact.contact_substep_cuda(*args, **law), 50),
        plain_ms=cuda_ms(lambda: contact.contact_substep_plain(*args, **law), 10),
    ))
    print(f"kernel contact_substep: rows={args[0].shape[0]} K={args[4].shape[1]} "
          f"bonds={int((p_k >= 0).sum())} max|F|={f_scale:.6e} N "
          f"max_abs_err={f_err:.3e} N")

    # B4 bio moments: the step's radius-15 graph, all four modes
    grid = nbr.build_grid(cfg.nbr_spec, a["locations"], a["ids"], alive)
    o = grid.order
    loc = a["locations"][o]
    flat = grid.sorted_flat.to(torch.int32).contiguous()
    pack = torch.stack([loc[:, 0], loc[:, 1], loc[:, 0], loc[:, 1],
                        a["GATA6"][o].float(), a["NANOG"][o].float(),
                        a["states"][o].float(), torch.zeros_like(loc[:, 0])],
                       dim=1).contiguous()
    bounds = nbr.run_bounds(cfg.nbr_spec, grid.sorted_flat)
    kw = dict(num_bins=cfg.nbr_spec.num_bins, radius=bio.neighbor_radius)
    err = 0.0
    for mode in ("count", "pathway", "motility", "full"):
        m_k = bio_moments.bio_moments_cuda(pack, flat, bounds, mode=mode, **kw)
        m_p = bio_moments.bio_moments_plain(pack, flat, bounds, mode=mode, **kw)
        counts = [0, 3, 7]
        if not torch.equal(m_k[:, counts], m_p[:, counts]):
            raise AssertionError(f"bio_moments[{mode}]: count lanes differ")
        torch.testing.assert_close(m_k, m_p, rtol=1e-5, atol=1e-4)
        err = max(err, float((m_k - m_p).abs().max()))
    results.append(dict(
        name="bio_moments", route="cuda",
        source="hipsc_abm_tpu_torch/csrc/bio_moments.cu",
        replaces="hipsc_abm_tpu/ops/pallas_bio.py:58",
        max_abs_err=err,
        ms=cuda_ms(lambda: bio_moments.bio_moments_cuda(pack, flat, bounds, mode="full", **kw), 50),
        plain_ms=cuda_ms(lambda: bio_moments.bio_moments_plain(pack, flat, bounds, mode="full", **kw), 10),
    ))
    print(f"kernel bio_moments: rows={pack.shape[0]} "
          f"mean neighbours={float(m_k[:, 0].sum()) / max(1, int(alive.sum())):.3f} "
          f"max_abs_err={err:.3e} (all four modes)")

    # B5 FTCS: one step's subcycles on the step's lattice
    lattice = state.gradients["fgf4_values"]
    dts = diffusion.diffusion_dts(bio.step_dt, diff.diffuse_dt)
    fargs = (lattice, dts, diff.diffuse_const, diff.spat_res2,
             diff.max_concentration, diff.degradation)
    g_k = ftcs.ftcs_diffuse_cuda(*fargs)
    g_p = diffusion.ftcs_diffuse(*fargs)
    torch.testing.assert_close(g_k, g_p, rtol=0.0, atol=1e-6)
    g_err = float((g_k - g_p).abs().max())
    steps = len(dts)
    results.append(dict(
        name="ftcs_subcycle", route="cuda",
        source="hipsc_abm_tpu_torch/csrc/ftcs.cu",
        replaces="hipsc_abm_tpu/ops/pallas_diffusion.py:135",
        max_abs_err=g_err,
        ms=cuda_ms(lambda: ftcs.ftcs_diffuse_cuda(*fargs), 5) / steps,
        plain_ms=cuda_ms(lambda: diffusion.ftcs_diffuse(*fargs), 3) / steps,
    ))
    print(f"kernel ftcs_subcycle: lattice={tuple(lattice.shape)} subcycles={steps} "
          f"max_abs_err={g_err:.3e} bit-equal={bool(torch.equal(g_k, g_p))}")
    for r in results:
        print(f"  {r['name']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms"
              + (" (per subcycle)" if r["name"] == "ftcs_subcycle" else ""))
    kernels.launch_counts.clear()
    return results


def step_phase():
    """One step from one 20k-cell state on the CPU and on the card."""
    from hipsc_abm_tpu_torch import convert

    cpu = bench_engine(N_STEP_CHECK, "cpu")
    gpu = bench_engine(N_STEP_CHECK, "cuda")
    s0 = cpu.init_state(seed=SEED)
    s0, _ = cpu.safe_step(s0)  # bonds and a lattice to start from
    d0 = convert.state_to_numpy(s0)
    gpu.cfg = cpu.cfg
    t0 = time.perf_counter()
    s_cpu, _ = cpu.step(convert.state_from_numpy(d0, "cpu"))
    t1 = time.perf_counter()
    s_gpu, _ = gpu.step(convert.state_from_numpy(d0, gpu.device))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    a = convert.state_to_numpy(s_cpu)
    b = convert.state_to_numpy(s_gpu)
    ia, ib = by_id(a), by_id(b)
    if not np.array_equal(ia["ids"], ib["ids"]):
        raise AssertionError("step: agent id sets differ between CPU and card")
    for k in ("FGF4", "FGFR", "ERK", "GATA6", "NANOG", "states", "death_counters",
              "diff_counters", "div_counters", "fds_counters"):
        if not np.array_equal(ia[k], ib[k]):
            raise AssertionError(f"step: {k} differs between CPU and card")
    loc_err = float(np.abs(ia["locations"] - ib["locations"]).max())
    np.testing.assert_allclose(ia["locations"], ib["locations"], rtol=0, atol=1e-3)
    lat_err = float(np.abs(a["gradients"]["fgf4_values"] - b["gradients"]["fgf4_values"]).max())
    np.testing.assert_allclose(a["gradients"]["fgf4_values"], b["gradients"]["fgf4_values"],
                               rtol=0, atol=1e-6)
    bond_rows = sum(x != y for x, y in zip(ia["bonds"], ib["bonds"]))
    print(f"step phase: {len(ia['ids'])} agents, ints equal, max|dloc|={loc_err:.3e} um, "
          f"max|dlattice|={lat_err:.3e}, bond rows differing={bond_rows}, "
          f"cpu {t1 - t0:.2f} s, card {t2 - t1:.2f} s")
    if bond_rows > max(1, len(ia["ids"]) // 10000):
        raise AssertionError(f"step: bond sets differ on {bond_rows} rows")


def timed_run(n_cells: int):
    """init_state(seed=0), 3 safe_step warm-ups, 5 timed steps; returns the
    engine, the final state and (warm-up s, steps/s, peak bytes)."""
    eng = bench_engine(n_cells, "cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = eng.init_state(seed=SEED)
    for _ in range(3):
        state, _ = eng.safe_step(state)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    steps = 5
    for _ in range(steps):
        state, _ = eng.step(state)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return eng, state, (t1 - t0, steps / (t2 - t1), torch.cuda.max_memory_allocated())


def main_path():
    """The bench configuration at 100k cells through the engine API."""
    from hipsc_abm_tpu_torch import kernels

    kernels.launch_counts.clear()
    eng, state, (warm_s, rate, peak) = timed_run(N_MAIN)
    counts = dict(kernels.launch_counts)
    agents = state.num_agents()
    loc = state.arrays["locations"][state.alive]
    lattice = state.gradients["fgf4_values"]
    size = torch.tensor(eng.gen.size, device=loc.device)
    if not (N_MAIN < agents < 2 * N_MAIN):
        raise AssertionError(f"main path: implausible population {agents}")
    if not bool(torch.isfinite(loc).all()) or bool((loc < 0).any()) or bool((loc > size).any()):
        raise AssertionError("main path: locations not finite or outside the box")
    if not bool(torch.isfinite(lattice).all()) or float(lattice.min()) < 0 or float(lattice.max()) <= 0:
        raise AssertionError("main path: morphogen lattice not finite/positive")
    ids = state.arrays["ids"][state.alive]
    if ids.unique().numel() != agents:
        raise AssertionError("main path: duplicate agent ids")
    print(f"main path: {N_MAIN} cells start, {agents} agents after 8 steps, "
          f"capacity {state.capacity}, bond_cap {state.bonds.partners.shape[1]}")
    print(f"main path: warm-up (init + 3 safe_step) {warm_s:.2f} s; "
          f"5 steps at {rate:.3f} steps/s; peak device memory {peak / 2**20:.1f} MiB")
    print(f"main path: launches {counts}")
    for name in ("contact_substep", "bio_moments", "ftcs_subcycle"):
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"main path: kernel {name} was never launched")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from hipsc_abm_tpu_torch import kernels

    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    print(subprocess.run([kernels.nvcc(), "--version"], check=True, capture_output=True,
                         text=True).stdout.strip().splitlines()[-1])
    t0 = time.perf_counter()
    lib_path = kernels.build()
    kernels.library()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s: {lib_path.name}")
    log = lib_path.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")

    eng = bench_engine(N_MAIN, "cuda")
    state = eng.init_state(seed=SEED)
    state, _ = eng.safe_step(state)
    results = kernel_phase(eng, state)
    del eng, state
    torch.cuda.empty_cache()

    step_phase()
    counts = main_path()
    _, state, (warm_s, rate, peak) = timed_run(N_LARGE)
    print(f"large colony: {N_LARGE} cells start, {state.num_agents()} agents after 8 "
          f"steps; warm-up {warm_s:.2f} s; {rate:.3f} steps/s; peak device memory "
          f"{peak / 2**20:.1f} MiB")
    for r in results:
        r["launches"] = counts[r["name"]]
    print(json.dumps({"kernels": results}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
