#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):

1. card and toolchain: ``nvidia-smi`` name and power limit, ``nvcc
   --version``, and the build of the CUDA kernels from ``csrc/``;
2. kernels: each kernel against its plain PyTorch version on the card, on
   the inputs the main path gives it (the 100k-cell bench colony after
   ``init_state(seed=0)`` and one ``safe_step``), with times of both and the
   least time the card could take for the same work (``bound_ms``);
   the span-mask kernels run as the scan runs them: seed, then a masked
   substep at the positions the seed's forces move the rows to, then the
   compaction;
3. step: one ``step`` of the port from the same 20k-cell state on the CPU
   (plain versions) and on the card (kernels), compared by agent id, for
   each contact path, and the span-mask step against the id-list step on
   the card;
4. main paths: the bench configuration at 100k cells, ``init_state(seed=0)``,
   3 ``safe_step`` warm-ups and 5 timed ``step``s, twice per contact path
   in turns (``contact_path="id_list"``, ``"span_mask"``, ``"span_mask"``,
   ``"id_list"``); steps/s, agents, peak
   memory, window rebuilds per step, the launch counts of every kernel
   (each kernel of the path must have launched), and the device time per
   step, in all and of each contact kernel, over 2 more steps under
   ``torch.profiler``;
5. the same timed runs at 500k cells.

The last lines are one JSON object with each kernel's numbers, the card's
name and power limit, and ``{"ok": true, "device": {...}}``.
"""

import dataclasses
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
PATHS = ("id_list", "span_mask")
# the kernels each contact path launches (counted from its own main-path run)
PATH_KERNELS = {
    "id_list": ("contact_substep", "bio_moments", "ftcs_subcycle"),
    "span_mask": ("contact_seed", "contact_masked", "mask_compact", "bio_moments",
                  "ftcs_subcycle"),
}
# the card's published peaks (H100 SXM: HBM3 rate, float32 outside the
# tensor cores), for bound_ms
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# float32 operations the contact kernels spend per candidate (distance) and
# per kept pair (pair law, normal, force sum)
DIST_FLOPS = 8
PAIR_FLOPS = 20


def bench_engine(n_cells: int, device: str, contact_path: str = "id_list"):
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
    return HipscEngine(gen, xp, diff=diff, enable_diffusion=True, device=device,
                       contact_path=contact_path)


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


def bound(bytes_moved: float, flops: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the float32 operations over the float32 rate."""
    t_bytes, t_ops = bytes_moved / PEAK_BYTES_PER_S, flops / PEAK_F32_PER_S
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def contact_flops(bounds, alive, degree) -> float:
    """Operations of one contact substep on this data: a distance per
    candidate of a live row and the pair law per kept pair."""
    from hipsc_abm_tpu_torch.ops.span_mask import candidate_counts

    candidates = int(candidate_counts(bounds)[alive].sum())
    return DIST_FLOPS * candidates + PAIR_FLOPS * int(degree.sum())


def check_contact(name, f_k, d_k, f_p, d_p) -> tuple:
    """Forces within the pair-law rounding tolerance, degrees equal;
    returns (max |F|, max abs error)."""
    f_scale = float(f_p.abs().max())
    f_err = float((f_k - f_p).abs().max())
    # uniform-radius pair law (kernel) vs general pair law (plain): the two
    # round differently by a few ulps of the force
    torch.testing.assert_close(f_k, f_p, rtol=1e-5, atol=1e-6 * f_scale)
    if not torch.equal(d_k, d_p):
        raise AssertionError(f"{name}: degrees differ")
    return f_scale, f_err


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
    from hipsc_abm_tpu_torch.ops import bio_moments, contact, diffusion, ftcs, span_mask
    from hipsc_abm_tpu_torch.ops import neighbors as nbr
    from hipsc_abm_tpu_torch.ops.integrate import stokes_integrate
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
    C, K = args[4].shape
    f_k, d_k, p_k = contact.contact_substep_cuda(*args, **law)
    f_p, d_p, p_p = contact.contact_substep_plain(*args, **law)
    torch.cuda.synchronize()
    f_scale, f_err = check_contact("contact", f_k, d_k, f_p, d_p)
    sets_k = [frozenset(r[r >= 0].tolist()) for r in p_k.cpu().numpy()]
    sets_p = [frozenset(r[r >= 0].tolist()) for r in p_p.cpu().numpy()]
    bad = sum(x != y for x, y in zip(sets_k, sets_p))
    if bad:
        raise AssertionError(f"contact: bond sets differ on {bad} rows")
    row_bytes = 16 + 4 + 1 + 24  # xyzr, id, alive, bounds
    results.append(dict(
        name="contact_substep", route="cuda",
        source="hipsc_abm_tpu_torch/csrc/contact.cu",
        replaces="hipsc_abm_tpu/ops/pallas_contact.py:79",
        max_abs_err=f_err,
        ms=cuda_ms(lambda: contact.contact_substep_cuda(*args, **law), 50),
        plain_ms=cuda_ms(lambda: contact.contact_substep_plain(*args, **law), 10),
        **bound(C * (row_bytes + 8 * K + 16), contact_flops(args[3], args[2], d_p)),
        library_ms=None,
    ))
    print(f"kernel contact_substep: rows={C} K={K} "
          f"bonds={int((p_k >= 0).sum())} max|F|={f_scale:.6e} N "
          f"max_abs_err={f_err:.3e} N")

    # B2 seed, B1 masked, B3 compact: the span-mask scan's first two substeps
    # on the same rows (the masked substep at the positions the seed's forces
    # move them to, with the seed's mask) and the compaction after them
    f_k, d_k, m_k = span_mask.contact_seed_cuda(*args, **law)
    f_p, d_p, m_p = span_mask.contact_seed_plain(*args, **law)
    torch.cuda.synchronize()
    f_scale, f_err = check_contact("contact_seed", f_k, d_k, f_p, d_p)
    if m_k.shape != m_p.shape or not torch.equal(m_k, m_p):
        raise AssertionError("contact_seed: mask words differ")
    W = m_p.shape[0]
    seed_mask = m_p.clone()
    results.append(dict(
        name="contact_seed", route="cuda",
        source="hipsc_abm_tpu_torch/csrc/contact_mask.cu",
        replaces="hipsc_abm_tpu/ops/pallas_contact.py:697",
        max_abs_err=f_err,
        ms=cuda_ms(lambda: span_mask.contact_seed_cuda(*args, **law), 50),
        plain_ms=cuda_ms(lambda: span_mask.contact_seed_plain(*args, **law), 10),
        **bound(C * (row_bytes + 4 * K + 16 + 4 * W), contact_flops(args[3], args[2], d_p)),
        library_ms=None,
    ))
    print(f"kernel contact_seed: rows={C} K={K} widest row "
          f"{int(span_mask.candidate_counts(args[3]).max())} candidates -> W={W} words "
          f"({4 * W * C / 1e6:.3f} MB mask) max|F|={f_scale:.6e} N max_abs_err={f_err:.3e} N")

    size = torch.tensor(eng.gen.size, dtype=torch.float32, device=f_p.device)
    loc1 = stokes_integrate(args[0][:, :3], args[0][:, 3], f_p, torch.zeros_like(f_p),
                            args[2], bio.stokes, size, float(bio.move_dt))
    margs = (pack_physics(loc1, args[0][:, 3]), *args[1:4])
    m_k, m_p = seed_mask.clone(), seed_mask.clone()
    f_k, d_k, _ = span_mask.contact_masked_cuda(*margs, m_k, **law)
    f_p, d_p, _ = span_mask.contact_masked_plain(*margs, m_p, **law)
    torch.cuda.synchronize()
    f_scale, f_err = check_contact("contact_masked", f_k, d_k, f_p, d_p)
    if not torch.equal(m_k, m_p):
        raise AssertionError("contact_masked: mask words differ")
    m_time = seed_mask.clone()
    results.append(dict(
        name="contact_masked", route="cuda",
        source="hipsc_abm_tpu_torch/csrc/contact_mask.cu",
        replaces="hipsc_abm_tpu/ops/pallas_contact.py:481",
        max_abs_err=f_err,
        ms=cuda_ms(lambda: span_mask.contact_masked_cuda(*margs, m_time, **law), 50),
        plain_ms=cuda_ms(lambda: span_mask.contact_masked_plain(*margs, m_time, **law), 10),
        **bound(C * (row_bytes + 16 + 8 * W), contact_flops(args[3], args[2], d_p)),
        library_ms=None,
    ))
    print(f"kernel contact_masked: rows={C} W={W} kept pairs {int(d_p.sum())} "
          f"(seed {int(seed_mask.ne(0).sum())} nonzero words) max|F|={f_scale:.6e} N "
          f"max_abs_err={f_err:.3e} N")

    c_k = span_mask.mask_compact_cuda(args[1], args[3], m_p, K)
    c_p = span_mask.mask_compact_plain(args[1], args[3], m_p, K)
    torch.cuda.synchronize()
    if not torch.equal(c_k, c_p):
        raise AssertionError(f"mask_compact: ids differ on "
                             f"{int((c_k != c_p).any(dim=1).sum())} rows")
    results.append(dict(
        name="mask_compact", route="cuda",
        source="hipsc_abm_tpu_torch/csrc/contact_mask.cu",
        replaces="hipsc_abm_tpu/ops/pallas_contact.py:877",
        max_abs_err=0.0,
        ms=cuda_ms(lambda: span_mask.mask_compact_cuda(args[1], args[3], m_p, K), 50),
        plain_ms=cuda_ms(lambda: span_mask.mask_compact_plain(args[1], args[3], m_p, K), 10),
        **bound(C * (4 + 24 + 4 * W + 4 * K), 0.0),
        library_ms=None,
    ))
    print(f"kernel mask_compact: rows={C} K={K} W={W} bonds={int((c_k >= 0).sum())}, "
          f"ids equal row for row")

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
    # operations in mode full: a distance test per candidate (6), and per
    # neighbour the pathway sums (3) and motility sums (10)
    candidates = int(span_mask.candidate_counts(bounds)[alive[o]].sum())
    results.append(dict(
        name="bio_moments", route="cuda",
        source="hipsc_abm_tpu_torch/csrc/bio_moments.cu",
        replaces="hipsc_abm_tpu/ops/pallas_bio.py:58",
        max_abs_err=err,
        ms=cuda_ms(lambda: bio_moments.bio_moments_cuda(pack, flat, bounds, mode="full", **kw), 50),
        plain_ms=cuda_ms(lambda: bio_moments.bio_moments_plain(pack, flat, bounds, mode="full", **kw), 10),
        **bound(C * (32 + 4 + 24 + 4 * bio_moments.OUT_LANES),
                6 * candidates + 13 * float(m_p[:, 0].sum())),
        library_ms=None,
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
        # per subcycle: the lattice read once and written once; 9 operations
        # per cell (four differences, two scaled sums, the update)
        **bound(2 * 4 * lattice.numel(), 9 * lattice.numel()),
        library_ms=None,
    ))
    print(f"kernel ftcs_subcycle: lattice={tuple(lattice.shape)} subcycles={steps} "
          f"max_abs_err={g_err:.3e} bit-equal={bool(torch.equal(g_k, g_p))}")
    for r in results:
        print(f"  {r['name']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
              + (" (per subcycle)" if r["name"] == "ftcs_subcycle" else ""))
    kernels.launch_counts.clear()
    return results


def compare_colonies(a: dict, b: dict, label: str, bond_rows_allowed: int) -> str:
    """Two numpy states compared by agent id: integer state equal,
    positions within 1e-3 um, at most ``bond_rows_allowed`` bond sets
    differing. Returns a summary."""
    ia, ib = by_id(a), by_id(b)
    if not np.array_equal(ia["ids"], ib["ids"]):
        raise AssertionError(f"{label}: agent id sets differ")
    for k in ("FGF4", "FGFR", "ERK", "GATA6", "NANOG", "states", "death_counters",
              "diff_counters", "div_counters", "fds_counters"):
        if not np.array_equal(ia[k], ib[k]):
            raise AssertionError(f"{label}: {k} differs")
    loc_err = float(np.abs(ia["locations"] - ib["locations"]).max())
    np.testing.assert_allclose(ia["locations"], ib["locations"], rtol=0, atol=1e-3)
    lat_err = float(np.abs(a["gradients"]["fgf4_values"] - b["gradients"]["fgf4_values"]).max())
    np.testing.assert_allclose(a["gradients"]["fgf4_values"], b["gradients"]["fgf4_values"],
                               rtol=0, atol=1e-6)
    bond_rows = sum(x != y for x, y in zip(ia["bonds"], ib["bonds"]))
    if bond_rows > bond_rows_allowed:
        raise AssertionError(f"{label}: bond sets differ on {bond_rows} rows")
    return (f"{len(ia['ids'])} agents, ints equal, max|dloc|={loc_err:.3e} um, "
            f"max|dlattice|={lat_err:.3e}, bond rows differing={bond_rows}")


def step_phase():
    """One step from one 20k-cell state on the CPU and on the card, for each
    contact path, and the two paths against each other on the card."""
    from hipsc_abm_tpu_torch import convert

    base = bench_engine(N_STEP_CHECK, "cpu")
    s0 = base.init_state(seed=SEED)
    s0, _ = base.safe_step(s0)  # bonds and a lattice to start from
    d0 = convert.state_to_numpy(s0)
    on_card = {}
    for path in PATHS:
        cpu = bench_engine(N_STEP_CHECK, "cpu", path)
        gpu = bench_engine(N_STEP_CHECK, "cuda", path)
        cpu.cfg = gpu.cfg = dataclasses.replace(base.cfg, contact_path=path)
        t0 = time.perf_counter()
        s_cpu, _ = cpu.step(convert.state_from_numpy(d0, "cpu"))
        t1 = time.perf_counter()
        s_gpu, _ = gpu.step(convert.state_from_numpy(d0, gpu.device))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        on_card[path] = convert.state_to_numpy(s_gpu)
        # id_list keeps the tolerance of its first card runs; span_mask is
        # held to no bond set differing
        allowed = max(1, N_STEP_CHECK // 10000) if path == "id_list" else 0
        summary = compare_colonies(convert.state_to_numpy(s_cpu), on_card[path],
                                   f"step[{path}] card vs CPU", allowed)
        print(f"step phase [{path}] card vs CPU: {summary}, cpu {t1 - t0:.2f} s, "
              f"card {t2 - t1:.2f} s")
    summary = compare_colonies(on_card["id_list"], on_card["span_mask"],
                               "step span_mask vs id_list on the card", 0)
    print(f"step phase span_mask vs id_list on the card: {summary}")


def timed_run(n_cells: int, path: str):
    """init_state(seed=0), 3 safe_step warm-ups, 5 timed steps; returns the
    engine, the final state and its numbers (warm-up s, steps/s, peak bytes,
    contact-window rebuilds per timed step)."""
    eng = bench_engine(n_cells, "cuda", path)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = eng.init_state(seed=SEED)
    for _ in range(3):
        state, _ = eng.safe_step(state)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    steps = 5
    rebuilds = []
    for _ in range(steps):
        state, info = eng.step(state)
        rebuilds.append(info.jkr_rebuilds)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return eng, state, dict(warm_s=t1 - t0, steps_per_s=steps / (t2 - t1),
                            peak_mib=torch.cuda.max_memory_allocated() / 2**20,
                            rebuilds_per_step=float(sum(int(r) for r in rebuilds)) / steps)


def device_ms_per_step(eng, state, steps: int = 2) -> dict:
    """Device time per step under ``torch.profiler`` over ``steps`` more
    steps: ``{"all": ms, "contact": ms, "by_kernel": {short name: [ms,
    launches]}}``, the contact entries the contact kernels' own time and
    launches per step; empty where the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state, _ = eng.step(state)
        torch.cuda.synchronize()
    total, by_kernel = 0.0, {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        total += t
        for short in ("contact_substep_kernel", "contact_mask_kernel<true>",
                      "contact_mask_kernel<false>", "mask_compact_kernel"):
            if short in e.key:
                ms, n = by_kernel.get(short, (0.0, 0.0))
                by_kernel[short] = (ms + t / 1e3 / steps, n + e.count / steps)
    if total <= 0:
        return {}
    return {"all": total / 1e3 / steps, "contact": sum(v[0] for v in by_kernel.values()),
            "by_kernel": by_kernel}


def main_path(n_cells: int, path: str) -> dict:
    """The bench configuration through the engine API on one contact path,
    with the launch counts set to 0 just before and read just after."""
    from hipsc_abm_tpu_torch import kernels

    kernels.launch_counts.clear()
    eng, state, nums = timed_run(n_cells, path)
    counts = dict(kernels.launch_counts)
    agents = state.num_agents()
    loc = state.arrays["locations"][state.alive]
    lattice = state.gradients["fgf4_values"]
    size = torch.tensor(eng.gen.size, device=loc.device)
    label = f"main path [{path}, {n_cells}]"
    if not (n_cells < agents < 2 * n_cells):
        raise AssertionError(f"{label}: implausible population {agents}")
    if not bool(torch.isfinite(loc).all()) or bool((loc < 0).any()) or bool((loc > size).any()):
        raise AssertionError(f"{label}: locations not finite or outside the box")
    if not bool(torch.isfinite(lattice).all()) or float(lattice.min()) < 0 or float(lattice.max()) <= 0:
        raise AssertionError(f"{label}: morphogen lattice not finite/positive")
    ids = state.arrays["ids"][state.alive]
    if ids.unique().numel() != agents:
        raise AssertionError(f"{label}: duplicate agent ids")
    for name in PATH_KERNELS[path]:
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"{label}: kernel {name} was never launched")
    dev = device_ms_per_step(eng, state)
    fmt = lambda v: "not measured" if v is None else f"{v:.4f} ms"  # noqa: E731
    print(f"{label}: {n_cells} cells start, {agents} agents after 8 steps, "
          f"capacity {state.capacity}, bond_cap {state.bonds.partners.shape[1]}")
    print(f"{label}: warm-up (init + 3 safe_step) {nums['warm_s']:.2f} s; 5 steps at "
          f"{nums['steps_per_s']:.3f} steps/s; peak device memory {nums['peak_mib']:.1f} MiB; "
          f"rebuilds/step {nums['rebuilds_per_step']:.2f}; device time/step (profiler, 2 steps): "
          f"contact kernels {fmt(dev.get('contact'))}, all {fmt(dev.get('all'))}; "
          f"by kernel {dev.get('by_kernel')}")
    print(f"{label}: launches {counts}")
    return dict(nums, counts=counts, contact_ms=dev.get("contact"),
                device_ms=dev.get("all"), contact_ms_by_kernel=dev.get("by_kernel"))


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
    # each size runs the paths in turns (id_list, span_mask, span_mask,
    # id_list) so that neither gains from running second in the process
    runs = [(n, path, main_path(n, path)) for n in (N_MAIN, N_LARGE)
            for path in PATHS + PATHS[::-1]]
    print(json.dumps({"paths": [
        dict(cells=n, contact_path=path, **{k: v for k, v in r.items() if k != "counts"})
        for n, path, r in runs]}))
    for r in results:
        # each kernel's launches come from the first 100k main-path run of
        # its path
        path = "span_mask" if r["name"] in ("contact_seed", "contact_masked",
                                            "mask_compact") else "id_list"
        first = next(c for n, p, c in runs if (n, p) == (N_MAIN, path))
        r["launches"] = first["counts"][r["name"]]
    print(json.dumps({"kernels": results}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
