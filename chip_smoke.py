#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):

1. card and toolchain: ``nvidia-smi`` name and power limit, ``nvcc
   --version``, and the build of the CUDA kernels from ``csrc/`` (one
   ``nvcc`` per source, all started together);
2. kernels: each kernel against its plain PyTorch version on the card, on
   the inputs the main path gives it, with times of both and the least time
   the card could take for the same work (``bound_ms``): the 2D forms at
   the 100k-cell bench colony after ``init_state(seed=0)`` and one
   ``safe_step``, the 3D (9-run) forms at the 99k-cell spheroid after the
   same; the span-mask kernels run as the scan runs them: seed, then a
   masked substep at the positions the seed's forces move the rows to, then
   the compaction; the bio moments on the engine's own calls of one more
   step (recorded, so that deaths and births since the build are present),
   every mode on the motility call's inputs, and each engine call's device
   time and device launches, glue included; the seed, the masked substep,
   the compaction and the bio moments also each alone per launch under
   ``torch.profiler``, in turns, with the candidates per live row that
   reach the membership test; FTCS also on fixed halos beside the plan's;
   the deposit's fixed-order sum (``csrc/deposit.cu``, glue) bit-equal to
   ``index_add`` on the CPU at the 100k state and at 500k after one step,
   timed beside ``index_add_`` on the card;
3. probes: each mode of the window probes P1 and P2 against its plain
   version at NBLK = 4096, the kernel's own device time per launch under
   ``torch.profiler`` and its multiple of the bound, then each probe's entry point
   (``hipsc_abm_tpu_torch.tools.dynslice_probe[2].main``) per mode, with the
   launch counts set to 0 just before it;
4. step: one ``step`` of the port from the same 20k-cell 2D state on the
   CPU (plain versions) and on the card (kernels), compared by agent id, for
   each contact path, and the span-mask step against the id-list step on
   the card; then 4 ``safe_step``s of the 3,300-cell spheroid (the 3D
   example's configuration) on the CPU and on the card, both paths;
   then two runs of 20 ``safe_step``s of the 100k bench colony with
   FGF4 field coupling on, from one seed, equal by agent id;
5. main paths: the bench configuration at 100k and 500k cells (2D) and the
   spheroid at 99k cells (3D), ``init_state(seed=0)``, 3 ``safe_step``
   warm-ups and 20 timed ``safe_step``s (each the replay of the engine's
   captured one-step graph), twice per contact path in turns
   (``"id_list"``, ``"span_mask"``, ``"span_mask"``, ``"id_list"``);
   steps/s with the median and p90 time per step, agents, peak memory,
   window rebuilds per step, the launch counts of every kernel (each kernel
   of the path must have launched; in 2D one FTCS launch per step), the
   device time per step, in all and of the contact kernels, over 2 more
   eager ``step``s under ``torch.profiler`` (with their window rebuilds,
   which give the predicated span-mask kernels' taken launches), and in 2D
   the FTCS kernel against its
   plain version on the path's last lattice;
6. lifecycle (``lifecycle_phase``): ``CellSimulation.start`` on the card
   from templates written into a temporary directory. (a) The shipped
   templates' values (5,000 cells, 2000 x 2000 um, every output, image
   width 2000, ``temp_pickle: true``) with ``end_step`` 24, ``num_gata6``
   500 and ``dox_step`` 5: its first 4 steps on the card and on the CPU
   (``lifecycle_card_vs_cpu``: each card step from the CPU's state to the
   step phase's tolerance, the two trajectories' integer state equal by
   agent id); mode 0 to step 12 then mode 1 to step 24, bit-equal
   by agent id to a mode-0 run straight to step 24; the per-step population,
   GATA6-high and differentiated counts of both from their values CSVs;
   then mode 2 (video) and mode 3 (zip). (b) The bench configuration at
   100,000 + 10,000 cells through the lifecycle, diffusion on, values, TDA,
   gradient and image outputs, ``temp_pickle: false``, 6 steps: per step
   the wall, ``step_fused`` and output times from the data CSV, the peak
   device memory and the launches of the kernels (B4, B6 and B5 must all
   have launched).
7. optional biology phases (growth, stochastic GATA6 bumps, diff_surround:
   ``OPTIONAL``), with radii seeded uniform in [min_radius, max_radius]
   (``seeded_radii``), so that the contact kernels take their general
   (per-pair radius) law and the step makes a fourth bio-moments pass:
   (a) ``general_law_phase``: B6, B2 and B1 on the general law against
   their plain versions at the 2D 100k and 3D 99k states, forces on the
   rows that agree, and every pair the card and the CPU decide apart
   reported with its distance from its own break distance (and held within
   ``APART_UM`` of it), each kernel alone per launch beside the uniform law
   on the same rows; (b) phase 4's one step (20k, 2D) and 4 spheroid
   ``safe_step``s with the flags; (c) ``optional_lifecycle_phase``: the
   lifecycle colony, 8 card steps from the CPU's state on each contact
   path, and mode 0 + 1 against mode 0; (d) the 2D 100k and 3D 99k main
   paths with the flags, in turns, beside phase 5's (``optional_summary``).
8. ``run_steps`` blocks (``blocks_phase``), each block one CUDA graph replay
   and one probe fetch: (a) at the 2D 100k and 3D 99k states after one
   ``safe_step``, both contact paths, and the 3D span-mask path with the
   optional phases, ``run_steps(10)`` against 10 ``safe_step``s (blocks of
   one step) and against 10 eager ``step``s (integer state, bond sets,
   positions, radii and the lattice bit-equal by agent id, rebuilds per
   step equal), the block's launches counted from 0;
   (b) one eager step of each under
   ``set_sync_debug_mode("error")``, and the synchronising calls of one
   block counted (must be 1); (c) the 2D 100k colony from ``init_state`` at
   a bond capacity of 2 and a mask capacity of 16: the block re-executes
   grown and ends equal to ``safe_step``s; (d) time per step of blocks of
   10 and 50 against ``safe_step`` (a block of one) and the eager ``step``
   at 1k, 2D 100k, 2D 500k and 3D 99k cells on both paths, in turns, with
   device time, busy share, capture seconds
   and graph memory; (e) lifecycle b with ``output_interval: 3`` against
   the per-step run (the boundaries' values CSVs byte-equal).
9. ensembles (``ensemble_phase``, ``parallel.ensemble.EnsembleEngine``):
   R = 16 replicates of the 5,000-cell bench colony (seeds 0-15), FGF4
   field coupling on from lattices seeded in [0, 2) (degradation off), each
   ``safe_step`` one replay of one CUDA graph of 16 branches and one probe
   fetch: (a) 6 ``safe_step``s, each replicate bit-equal by agent id (the
   lattice, key and next_id too) to its solo card ``safe_step`` run, the
   launches counted from 0, one host read per attempt; (b) an 8-point
   sweep of ``adhesion_const`` (0.8-1.2x) and ``GATA6_prob`` (stochastic
   bumps on), each point bit-equal to its solo run; (c) replicates 0 and
   1 on the CPU, each card step from the CPU's state within the step
   phase's tolerance; (d) 4 replicates at a capacity that overflows,
   growing inside ``safe_step``, equal to solo runs; (e) the ensemble's
   ``safe_step`` against the 16 solo ``safe_step``s in turns (ensemble,
   solo, solo, ensemble): ms per step and per replicate-step, the kernels'
   summed device time (profiler) and the replays' device span (CUDA
   events), busy share, capture s, MiB and launches per replay,
   and one eager ensemble ``step``. Every replay waits with a deadline.

The last lines are the seconds per phase, one JSON object with each
kernel's numbers (``law``: the contact law of the run its inputs and
launches come from, ``"general"`` for the entries named ``[general]``;
``taken_launches``: those of ``launches`` that ran their branch, fewer for
the span-mask kernels, which launch on every substep under the rebuild
predicate; ``in_step_ms``: device time per taken launch in the step), the
card's name and power limit, and ``{"ok": true, "device": {...}}``.
"""

import contextlib
import dataclasses
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N_MAIN = 100_000
N_LARGE = 500_000
N_STEP_CHECK = 20_000
# the 3D spheroid (examples/spheroid_3d.py: 3,000 + 300 cells in a 600 um
# box, seeded as a ball of 110 um) and its realistic size, 90,000 + 9,000
# cells with box and ball grown by (99,000 / 3,300)^(1/3)
N_SPHEROID = 3_300
N_MAIN_3D = 99_000
SEED = 0
PATHS = ("id_list", "span_mask")
# the kernels each contact path launches in 2D and in 3D (counted from its
# own main-path run)
PATH_KERNELS = {
    (2, "id_list"): ("contact_substep", "bio_moments", "ftcs_diffuse", "deposit"),
    (2, "span_mask"): ("contact_seed", "contact_masked", "mask_compact", "bio_moments",
                       "ftcs_diffuse", "deposit"),
    (3, "id_list"): ("contact_substep_3d", "bio_moments_3d"),
    (3, "span_mask"): ("contact_seed_3d", "contact_masked_3d", "mask_compact_3d",
                       "bio_moments_3d"),
}
SPAN_MASK_KERNELS = ("contact_seed", "contact_masked", "mask_compact")
# the card's published peaks (H100 SXM: HBM3 rate, float32 outside the
# tensor cores), for bound_ms
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# float32 operations the contact kernels spend per candidate (distance) and
# per kept pair (pair law, normal, force sum)
DIST_FLOPS = 8
PAIR_FLOPS = 20
# and per kept pair on the general (per-pair radius) law: those 20, the
# reduced radius (a sum, a max, two products, a division), the cube root by
# powf counted as 8 (a log2 and an exp2 of the special-function unit and
# the products and fix-ups around them; CUDA's accurate powf issues more),
# the scale's product, the overlap's division and the clamp (2)
GENERAL_PAIR_FLOPS = 37
# the optional phases the reference ships disabled
OPTIONAL = dict(enable_growth=True, enable_stochastic=True, enable_diff_surround=True)
# a pair that the card and the CPU decide apart is put down to the rounding
# of the general law's cube root (powf on the card, pow on the CPU, neither
# correctly rounded) when it lies within this distance (um) of its own break
# distance; one ulp of the overlap d there is ~2.5e-8 um
APART_UM = 1e-4
# the general law's force tolerance, atol in units of max |F| (rtol stays
# 1e-5): a pair's force carries the cube root's rounding (powf within 2 ulp
# on the card, the CPU's pow within 1), some 4e-7 of its size, and a row sums
# up to ~10 such pairs that may cancel to near zero; the uniform law's 1e-6
# was passed by 1.07e-6 on 2 of 386,304 force components of the 3D masked
# substep at the 99k spheroid (NVIDIA H100 80GB HBM3, 700.00 W)
GENERAL_ATOL = 4e-6
# steps of the optional phase's lifecycle colony stepped on the card from the
# CPU's state
OPT_LIFECYCLE_STEPS = 8
# per (row, lane) pair: P1 two differences, two squares, a sum, the test,
# dx * d2 and the accumulation; P2 the 23 operations of its body every pair
# needs and 4 more (two products, two sums) per kept pair
P1_FLOPS = 8
P2_FLOPS, P2_KEPT_FLOPS = 23, 4
# kernel names as the profiler shows them: the contact kernels, then the
# others whose device time per step is reported beside them
CONTACT_KERNELS = ("contact_substep_kernel", "contact_mask_kernel<true",
                   "contact_mask_kernel<false", "mask_compact_kernel")
OTHER_KERNELS = ("bio_moments_kernel", "ftcs_diffuse_kernel", "deposit_sorted_kernel")
# timed steps of a main path (after 3 warm-ups)
TIMED_STEPS = 20
# launches per turn when a kernel is timed alone under the profiler
ALONE_LAUNCHES = 20
# FTCS halos timed beside the plan's own (subcycles per grid barrier)
FTCS_HALOS = (1, 2, 4, 8, 12, 16)
# the lifecycle phase's templates: the shipped examples/templates values,
# with the fate decision (dox at step 5) inside a 24-step window
LIFECYCLE_GENERAL = dict(
    num_to_start=5000, cuda=False, end_step=24, size=[2000, 2000, 0], output_values=True,
    output_images=True, record_initial_step=True, image_quality=2000, video_quality=1000,
    fps=10, seed=0, temp_pickle=True)
LIFECYCLE_EXPERIMENTAL = dict(
    num_gata6=500, output_tda=True, output_gradients=True, group=0, dox_step=5,
    guye_move=True, lonely_thresh=2, color_mode=True)
# and the bench configuration (bench_engine at N_MAIN) through the lifecycle
LIFECYCLE_BENCH_GENERAL = dict(
    LIFECYCLE_GENERAL, num_to_start=N_MAIN, end_step=6, size=[8944, 8944, 0],
    temp_pickle=False)
LIFECYCLE_BENCH_EXPERIMENTAL = dict(
    LIFECYCLE_EXPERIMENTAL, num_gata6=N_MAIN // 10, enable_diffusion=True, spat_res=20.0,
    release_amount=0.01, degradation=0.1)
LIFECYCLE_CPU_STEPS = 4
# phase 8, run_steps blocks: the block of the equality checks (a-c), the
# block sizes timed against safe_step (d), the 1k-cell bench cell (side
# 2000 * sqrt(1000 / 5000) = 894 um), safe_steps per timed run, and the
# timed cells' capacity over their start (so that no block re-executes for
# capacity while it is timed: 53 steps grow the colony ~1.5x)
BLOCK_K = 10
TIMED_KS = (10, 50)
N_SMALL = 1_000
BLOCK_TIMED_STEPS = 20
BLOCK_HEADROOM = 2.0
LIFECYCLE_BLOCK_INTERVAL = 3
# phase 9, ensembles: R replicates of the bench colony at 5,000 cells (side
# 2000 um; the JAX package's ensemble workload, tools/bench_ensemble.py),
# safe_steps of the equality checks, the sweep's points, the growth check's
# capacity (one quantum above the 5,500 starting agents: the first steps'
# divisions overflow it), and the timed turns' warm-up and timed steps
N_ENSEMBLE = 5_000
ENSEMBLE_R = 16
ENSEMBLE_STEPS = 6
SWEEP_POINTS = 8
ENSEMBLE_TIGHT_CAPACITY = 5_632
ENSEMBLE_WARMUP = 3
ENSEMBLE_TIMED = 10


def bench_engine(n_cells: int, device: str, contact_path: str = "id_list", **flags):
    """The bench configuration: a 2D box at reference colony density
    (side = 2000 * sqrt(n / 5000) um), n/10 GATA6-high cells, dox at step
    5, FGF4 secretion and FTCS diffusion on; ``flags`` are the engine's
    optional-phase switches (``OPTIONAL``)."""
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
                       contact_path=contact_path, **flags)


def spheroid_engine(n_cells: int, device: str, contact_path: str = "id_list", **flags):
    """The 3D spheroid example's configuration at ``n_cells`` (10:1 with
    GATA6-high cells, dox at step 2, guye_move off): a cubic box of
    600 * s um and a seeding ball of 110 * s um at its centre, with
    s = (n_cells / 3300)^(1/3). Returns the engine and the ball (numpy
    ``default_rng(SEED)``, drawn as the example draws it)."""
    from hipsc_abm_tpu_torch.engine import HipscEngine
    from hipsc_abm_tpu_torch.params import ExperimentalParams, GeneralParams

    s = (n_cells / 3300.0) ** (1.0 / 3.0)
    box, radius = 600.0 * s, 110.0 * s
    n_gata6 = n_cells // 11
    gen = GeneralParams(num_to_start=n_cells - n_gata6, end_step=200, size=(box, box, box))
    xp = ExperimentalParams(num_gata6=n_gata6, dox_step=2, guye_move=False)
    rng = np.random.default_rng(SEED)
    direction = rng.normal(size=(n_cells, 3))
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    r = radius * rng.random(n_cells) ** (1.0 / 3.0)
    ball = (box / 2.0 + direction * r[:, None]).astype(np.float32)
    return HipscEngine(gen, xp, device=device, contact_path=contact_path, **flags), ball


def seeded_radii(n: int, bio) -> np.ndarray:
    """Radii drawn uniform in [min_radius, max_radius] from the seed, as
    growth spreads them (every radius starts at max_radius, daughters copy
    their mother's, so growth alone does nothing at first)."""
    rng = np.random.default_rng(SEED + 1)
    return rng.uniform(bio.min_radius, bio.max_radius, n).astype(np.float32)


def engine_for(dims: int, n_cells: int, device: str, path: str, optional: bool = False):
    """``(engine, initial state)`` of the 2D bench or the 3D spheroid;
    ``optional`` turns the three optional phases on and seeds the radii
    (``seeded_radii``), so that the contact kernels take the general law."""
    flags = OPTIONAL if optional else {}
    if dims == 2:
        eng = bench_engine(n_cells, device, path, **flags)
        state = eng.init_state(seed=SEED)
    else:
        eng, ball = spheroid_engine(n_cells, device, path, **flags)
        state = eng.init_state(seed=SEED, locations=ball)
    if optional:
        radii = torch.from_numpy(seeded_radii(state.capacity, eng.bio)).to(state.alive.device)
        state = state._replace(arrays={**state.arrays, "radii": radii})
    return eng, state


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the card (CUDA events, after a warm-up)."""
    from hipsc_abm_tpu_torch.tools import time_ms

    return time_ms(fn, reps, torch.device("cuda"))


def bound(bytes_moved: float, flops: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the float32 operations over the float32 rate. The
    general-law entries count the uniform law's compulsory bytes and
    ``GENERAL_PAIR_FLOPS`` per kept pair, the cube root by ``powf`` counted
    as 8 operations."""
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


def bio_bound(args, kw, neighbours: float) -> dict:
    """``bound`` of one bio-moments call (``args``, ``kw`` as the engine
    passes them) with ``neighbours`` neighbour pairs. Bytes: per live row
    its build-time position (x, y in 2D, x, y, z in 3D), liveness and
    bounds, in modes motility and full its current position and three
    features, in pathway one feature, and the lanes the mode makes that are
    not always zero (count 1, pathway 3, motility 9, full 11); per dead row
    its liveness and those lanes. Operations: a distance test per candidate
    (6 in 2D, 9 in 3D), and per neighbour the pathway sums (3) and the
    motility sums (10 in 2D, 13 in 3D) that the mode makes."""
    from hipsc_abm_tpu_torch import kernels
    from hipsc_abm_tpu_torch.ops import span_mask

    pos0, alive, bounds = args[:3]
    mode = kw["mode"]
    n_runs = kernels.run_count(bounds)
    dims = 2 if n_runs == 3 else 3
    candidates = int(span_mask.candidate_counts(bounds)[alive].sum())
    C, live = pos0.shape[0], int(alive.sum())
    lanes_out = 4 * {"count": 1, "pathway": 3, "motility": 9, "full": 11}[mode]
    reads = {"count": 0, "pathway": 4, "motility": 4 * dims + 12, "full": 4 * dims + 12}[mode]
    dist_ops = 6 if dims == 2 else 9
    nbr_ops = ((3 if mode in ("pathway", "full") else 0)
               + ((10 if dims == 2 else 13) if mode in ("motility", "full") else 0))
    return bound(live * (4 * dims + 1 + 8 * n_runs + reads + lanes_out)
                 + (C - live) * (1 + lanes_out),
                 dist_ops * candidates + nbr_ops * neighbours)


def kernel_phase(eng, state):
    """Each run-bounds kernel (and, in 2D, FTCS) against its plain version
    on the main path's inputs. Entries are named as ``launch_counts`` names
    them (``_3d`` for the 9-run forms)."""
    from hipsc_abm_tpu_torch import kernels
    from hipsc_abm_tpu_torch.ops import bio_moments, contact, diffusion, ftcs, span_mask
    from hipsc_abm_tpu_torch.ops import neighbors as nbr
    from hipsc_abm_tpu_torch.ops.integrate import stokes_integrate
    from hipsc_abm_tpu_torch.ops.jkr import pack_physics
    from hipsc_abm_tpu_torch.tools import device_kernels, kernel_ms, record_bio_calls

    cfg, bio, diff = eng.cfg, eng.bio, eng.diff
    a, alive = state.arrays, state.alive
    n_runs = len(cfg.jkr_spec.flat_run_offsets)
    label = f"{3 if n_runs == 9 else 2}D"
    results = []

    def entry(name, source, replaces, **nums):
        results.append(dict(name=kernels.counted_name(name, n_runs), route="cuda",
                            source=f"hipsc_abm_tpu_torch/csrc/{source}",
                            replaces=replaces, library_ms=None, law="uniform", **nums))
        return results[-1]["name"]

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
    # per row: xyzr, alive, bounds (B6 also reads the row's id; B1 and B2
    # take the row itself by position)
    row_bytes = 16 + 1 + 8 * n_runs
    name = entry(
        "contact_substep", "contact.cu", "hipsc_abm_tpu/ops/pallas_contact.py:79",
        max_abs_err=f_err,
        ms=cuda_ms(lambda: contact.contact_substep_cuda(*args, **law), 50),
        plain_ms=cuda_ms(lambda: contact.contact_substep_plain(*args, **law), 10),
        **bound(C * (row_bytes + 4 + 8 * K + 16), contact_flops(args[3], args[2], d_p)))
    live = max(1, int(args[2].sum()))
    walk = membership_counts(args, law)
    print(f"kernel {name}: rows={C} runs={n_runs} K={K} mean candidates per live row "
          f"{int(span_mask.candidate_counts(args[3])[args[2]].sum()) / live:.2f}, "
          f"of which survive the break test beyond the search radius (reach the "
          f"membership test) {walk['membership'] / live:.3f}; "
          f"mean degree {float(d_p.sum()) / live:.3f}, max degree={int(d_p.max())} "
          f"bonds={int((p_k >= 0).sum())} max|F|={f_scale:.6e} N max_abs_err={f_err:.3e} N")

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
    # the seed reads the K partner ids of a row, and a candidate's id, only
    # where a candidate reaches the membership test
    name = entry(
        "contact_seed", "contact_mask.cu", "hipsc_abm_tpu/ops/pallas_contact.py:697",
        max_abs_err=f_err,
        ms=cuda_ms(lambda: span_mask.contact_seed_cuda(*args, **law), 50),
        plain_ms=cuda_ms(lambda: span_mask.contact_seed_plain(*args, **law), 10),
        **bound(C * (row_bytes + 16 + 4 * W) + 4 * K * walk["rows"] + 4 * walk["membership"],
                contact_flops(args[3], args[2], d_p)))
    print(f"kernel {name}: rows={C} K={K} widest row M="
          f"{int(span_mask.candidate_counts(args[3]).max())} candidates -> W={W} words "
          f"({4 * W * C / 1e6:.3f} MB mask) max|F|={f_scale:.6e} N max_abs_err={f_err:.3e} N; "
          f"per live row, candidates reaching the membership test "
          f"{walk['membership'] / live:.3f}, rows with one or more {walk['rows'] / live:.3f} "
          f"(the same inputs as {kernels.counted_name('contact_substep', n_runs)})")

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
    name = entry(
        "contact_masked", "contact_mask.cu", "hipsc_abm_tpu/ops/pallas_contact.py:481",
        max_abs_err=f_err,
        ms=cuda_ms(lambda: span_mask.contact_masked_cuda(*margs, m_time, **law), 50),
        plain_ms=cuda_ms(lambda: span_mask.contact_masked_plain(*margs, m_time, **law), 10),
        **bound(C * (row_bytes + 16 + 8 * W), contact_flops(args[3], args[2], d_p)))
    print(f"kernel {name}: rows={C} W={W} kept pairs {int(d_p.sum())} "
          f"(seed {int(seed_mask.ne(0).sum())} nonzero words) max|F|={f_scale:.6e} N "
          f"max_abs_err={f_err:.3e} N")
    # each kernel alone per launch, in turns, after B4 below
    alone_fns = {
        "seed": (lambda: span_mask.contact_seed_cuda(*args, **law), "contact_mask_kernel<true"),
        "masked": (lambda: span_mask.contact_masked_cuda(*margs, m_time, **law),
                   "contact_mask_kernel<false"),
        "compact": (lambda: span_mask.mask_compact_cuda(args[1], args[3], m_p, K),
                    "mask_compact_kernel"),
    }

    c_k = span_mask.mask_compact_cuda(args[1], args[3], m_p, K)
    c_p = span_mask.mask_compact_plain(args[1], args[3], m_p, K)
    torch.cuda.synchronize()
    if not torch.equal(c_k, c_p):
        raise AssertionError(f"mask_compact: ids differ on "
                             f"{int((c_k != c_p).any(dim=1).sum())} rows")
    # per row its bounds and K ids out; the mask words that hold its
    # candidates; one id read per id written
    words = int(torch.clamp((span_mask.candidate_counts(args[3]) + 31) // 32, max=W).sum())
    bonds = int((c_k >= 0).sum())
    name = entry(
        "mask_compact", "contact_mask.cu", "hipsc_abm_tpu/ops/pallas_contact.py:877",
        max_abs_err=0.0,
        ms=cuda_ms(lambda: span_mask.mask_compact_cuda(args[1], args[3], m_p, K), 50),
        plain_ms=cuda_ms(lambda: span_mask.mask_compact_plain(args[1], args[3], m_p, K), 10),
        **bound(C * (8 * n_runs + 4 * K) + 4 * words + 4 * bonds, 0.0))
    print(f"kernel {name}: rows={C} K={K} W={W} mask words read {words} "
          f"({words / C:.3f} per row) bonds={bonds}, ids equal row for row")

    # B4 bio moments: the engine's own calls of one more step, recorded (the
    # motility call's inputs hold the deaths and births since the build),
    # the motility call's inputs in all four modes
    calls = record_bio_calls(eng, state)
    b_args, b_kw = calls[2]
    pos0, b_alive, bounds = b_args[:3]
    err = 0.0
    for mode in ("count", "pathway", "motility", "full"):
        kw = dict(b_kw, mode=mode)
        b_k = bio_moments.bio_moments_cuda(*b_args, **kw)
        b_p = bio_moments.bio_moments_plain(*b_args, **kw)
        counts = [0, 3, 7]
        if not torch.equal(b_k[:, counts], b_p[:, counts]):
            raise AssertionError(f"bio_moments[{mode}]: count lanes differ")
        torch.testing.assert_close(b_k, b_p, rtol=1e-5, atol=1e-4)
        err = max(err, float((b_k - b_p).abs().max()))
    full = dict(b_kw, mode="full")
    candidates = int(span_mask.candidate_counts(bounds)[b_alive].sum())
    C, live = pos0.shape[0], int(b_alive.sum())
    name = entry(
        "bio_moments", "bio_moments.cu", "hipsc_abm_tpu/ops/pallas_bio.py:58",
        max_abs_err=err,
        ms=cuda_ms(lambda: bio_moments.bio_moments_cuda(*b_args, **full), 50),
        plain_ms=cuda_ms(lambda: bio_moments.bio_moments_plain(*b_args, **full), 10),
        **bio_bound(b_args, full, float(b_p[:, 0].sum())))
    print(f"kernel {name}: rows={C} live {live} mean candidates per live row "
          f"{candidates / max(1, live):.2f}, "
          f"mean neighbours={float(b_k[:, 0].sum()) / max(1, live):.3f} "
          f"max_abs_err={err:.3e} (all four modes, on the step's motility call)")
    # the engine's whole bio-moments work of one step: each call as the
    # engine makes it (device ms and device launches, glue included) and
    # the glue made once per step
    per_call = [device_kernels(lambda a=a, k=k: bio_moments.bio_moments_cuda(*a, **k),
                               ALONE_LAUNCHES) for a, k in calls]
    loc0 = pos0[:, :3].contiguous()
    glue = device_kernels(lambda: bio_moments.positions(loc0), ALONE_LAUNCHES)
    print(f"kernel {name} engine calls (count, pathway, motility; device ms, device launches "
          f"per call, profiler): "
          + ", ".join(f"{ms:.5f} ms / {n:g} {sorted(names)}" for ms, n, names in per_call)
          + f"; per step: positions {glue[0]:.5f} ms / {glue[1]:g} {sorted(glue[2])}")
    alone_fns["bio"] = (lambda: bio_moments.bio_moments_cuda(*b_args, **full),
                        "bio_moments_kernel")
    alone = {}
    for key in list(alone_fns) + list(alone_fns)[::-1]:
        alone.setdefault(key, []).append(round(kernel_ms(*alone_fns[key], ALONE_LAUNCHES), 5))
    print(f"kernel {label} alone per launch (profiler, {ALONE_LAUNCHES} launches, in turns; "
          f"bio in mode full): {alone}")

    # B5 FTCS: one step's whole subcycle schedule on the step's lattice (2D
    # bench only), one launch per call
    if "fgf4_values" in state.gradients:
        lattice = state.gradients["fgf4_values"]
        fargs = ftcs_args(eng, lattice)
        g_err = check_ftcs(fargs, "kernel ftcs_diffuse")
        steps = len(fargs[1])
        results.append(dict(
            name="ftcs_diffuse", route="cuda",
            source="hipsc_abm_tpu_torch/csrc/ftcs.cu",
            replaces="hipsc_abm_tpu/ops/pallas_diffusion.py:135",
            max_abs_err=g_err,
            ms=cuda_ms(lambda: ftcs.ftcs_diffuse_cuda(*fargs), 20),
            plain_ms=cuda_ms(lambda: diffusion.ftcs_diffuse(*fargs), 3),
            # per call: the lattice read once and written once; 9 operations
            # per cell and subcycle (four sums, two products, the update and
            # the clip and degradation around them)
            **bound(2 * 4 * lattice.numel(), 9 * lattice.numel() * steps),
            library_ms=None, law="uniform",
        ))
        # the kernel alone, on the plan's halo and on fixed ones, in turns
        limits = kernels.device_limits()
        plan = ftcs.ftcs_plan(*lattice.shape, limits["n_sm"], limits["smem_optin"])
        alone = {}
        for halo in (0,) + FTCS_HALOS + FTCS_HALOS[::-1] + (0,):
            alone.setdefault(halo, []).append(round(kernel_ms(
                lambda: ftcs.ftcs_diffuse_cuda(*fargs, halo=halo), "ftcs_diffuse_kernel", 10), 5))
        print(f"kernel ftcs_diffuse: plan {plan} ({plan.ctas} CTAs, {plan.smem_bytes} bytes "
              f"of shared memory each); kernel alone per launch by halo (profiler, 10 "
              f"launches, in turns; 0 = the plan's): {alone}")
        # the deposit's fixed-order sum (glue: the JAX deposit is XLA)
        results.append(deposit_entry(eng, state, "100k"))
    for r in results:
        print(f"  {r['name']} ({label}): kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    kernels.launch_counts.clear()
    return results


def break_distance(ri, rj, bio):
    """The distance (um, float64) at which a pair of radii ri, rj breaks,
    and the pair law's overlap scale (um): d = (ri + rj - mag) / scale."""
    e_hat = 1.0 / (2.0 * (1.0 - bio.poisson ** 2) / bio.youngs)
    scale_c = ((np.pi * bio.adhesion_const) / e_hat) ** (2.0 / 3.0)
    scale = scale_c * (ri * rj / (1e6 * (ri + rj))) ** (1.0 / 3.0) * 1e6
    return ri + rj - bio.jkr_break_d * scale, scale


def pairs_apart(args, keep_k, keep_p, rows, bio) -> list:
    """The pairs of ``rows`` (sorted rows whose keep sets differ) that one
    side kept and the other not, given each side's keep matrix over the
    rows' windows (``span_mask._window`` of their bounds): per pair the
    distance from its own break distance (um, float64; < 0 inside) and the
    overlap d's distance from break_d (float64), and which side kept it."""
    from hipsc_abm_tpu_torch.ops import span_mask

    pos, valid, _ = span_mask._window(args[3][rows])
    r_idx, t_idx = torch.nonzero(keep_k ^ keep_p, as_tuple=True)
    xyzr = args[0].double()
    me, other = xyzr[rows[r_idx]], xyzr[pos[r_idx, t_idx]]
    mag = torch.linalg.norm(me[:, :3] - other[:, :3], dim=1)
    out = []
    for m, ri, rj, k in zip(mag.tolist(), me[:, 3].tolist(), other[:, 3].tolist(),
                            keep_k[r_idx, t_idx].tolist()):
        reach, scale = break_distance(ri, rj, bio)
        out.append(dict(from_break_um=m - reach, d_minus_break=(ri + rj - m) / scale
                        - bio.jkr_break_d, kept_by="card" if k else "cpu"))
    return out


def keep_from_partners(args, partners, rows):
    """(rows, T) bool keep matrix over the rows' windows from (C, K)
    partner lists (exact where a row's degree is within K)."""
    from hipsc_abm_tpu_torch.ops import span_mask

    pos, valid, _ = span_mask._window(args[3][rows])
    cand = args[1][pos]
    p = partners[rows]
    return valid & ((cand[:, :, None] == p[:, None, :]) & (p[:, None, :] >= 0)).any(-1)


def keep_from_mask(args, mask, rows):
    from hipsc_abm_tpu_torch.ops import span_mask

    _, valid, j = span_mask._window(args[3][rows])
    return span_mask._unpack(mask[:, rows], j, valid)


def check_general(name, f_k, d_k, f_p, d_p, same_rows, keep, args, bio) -> dict:
    """A general-law kernel against its plain version: forces to rtol 1e-5,
    atol ``GENERAL_ATOL`` x max |F| and degrees equal on the rows whose keep
    sets agree; every pair of the other rows decided apart must lie within
    ``APART_UM`` of its own break distance (rounding of the cube root).
    ``keep(rows)`` gives both sides' keep matrices. Returns the numbers."""
    same_rows = same_rows & torch.eq(d_k, d_p)
    f_scale = float(f_p.abs().max())
    torch.testing.assert_close(f_k[same_rows], f_p[same_rows], rtol=1e-5,
                               atol=GENERAL_ATOL * f_scale)
    f_err = float((f_k[same_rows] - f_p[same_rows]).abs().max())
    rows = torch.nonzero(~same_rows).squeeze(1)
    apart = pairs_apart(args, *keep(rows), rows, bio) if rows.numel() else []
    far = [p for p in apart if abs(p["from_break_um"]) > APART_UM]
    if far or (rows.numel() and not apart):
        raise AssertionError(f"{name}: {rows.numel()} rows differ, pairs decided apart "
                             f"beyond {APART_UM} um of the break: {far or 'none found'}")
    return dict(max_abs_err=f_err, f_scale=f_scale, rows_apart=int(rows.numel()),
                pairs_apart=apart)


def general_law_phase(eng, state) -> list:
    """Optional phase a: the general-law forms of B6, B2 and B1 against
    their plain versions on the main path's rows (``state``: the flagged
    engine's colony with seeded radii after one ``safe_step``), each timed
    by CUDA events, alone per launch under the profiler beside the uniform
    law on the same rows (in turns), with its bound. Entries are named
    ``<launch_counts name>[general]``; ``main`` adds the launches and the
    in-step times from the timed runs."""
    from hipsc_abm_tpu_torch import kernels
    from hipsc_abm_tpu_torch.ops import bio_moments, contact, span_mask
    from hipsc_abm_tpu_torch.ops import neighbors as nbr
    from hipsc_abm_tpu_torch.ops.integrate import stokes_integrate
    from hipsc_abm_tpu_torch.ops.jkr import pack_physics
    from hipsc_abm_tpu_torch.tools import kernel_ms, record_bio_calls

    cfg, bio = eng.cfg, eng.bio
    assert cfg.uniform_radius is None and cfg.enable_growth
    a, alive = state.arrays, state.alive
    n_runs = len(cfg.jkr_spec.flat_run_offsets)
    label = f"optional phase a ({2 if n_runs == 3 else 3}D)"
    grid = nbr.build_grid(cfg.jkr_spec, a["locations"], a["ids"], alive)
    o = grid.order
    args = (pack_physics(a["locations"][o], a["radii"][o]), a["ids"][o].contiguous(),
            alive[o].contiguous(), nbr.run_bounds(cfg.jkr_spec, grid.sorted_flat),
            state.bonds.ids()[o].contiguous())
    law = dict(radius=bio.jkr_radius, adhesion_const=bio.adhesion_const,
               poisson=bio.poisson, youngs=bio.youngs, break_d=bio.jkr_break_d,
               uniform_radius=None)
    uni = dict(law, uniform_radius=bio.max_radius)
    C, K = args[4].shape
    live = args[2]
    radii = args[0][:, 3][live]
    row_bytes = 16 + 1 + 8 * n_runs
    candidates = int(span_mask.candidate_counts(args[3])[live].sum())
    walk = membership_counts(args, law)
    results = []

    def entry(base, source, replaces, fn_k, fn_p, fn_u, kname, bytes_moved, kept, check):
        alone = {"general": [], "uniform": []}
        for key in ("general", "uniform", "uniform", "general"):
            fn = fn_k if key == "general" else fn_u
            alone[key].append(round(kernel_ms(fn, kname, ALONE_LAUNCHES), 5))
        name = kernels.counted_name(base, n_runs) + "[general]"
        apart = check.pop("pairs_apart")
        results.append(dict(
            name=name, route="cuda", source=f"hipsc_abm_tpu_torch/csrc/{source}",
            replaces=replaces, law="general", max_abs_err=check["max_abs_err"],
            ms=cuda_ms(fn_k, 50), plain_ms=cuda_ms(fn_p, 10),
            **bound(bytes_moved, DIST_FLOPS * candidates + GENERAL_PAIR_FLOPS * kept),
            library_ms=None, alone_ms=alone["general"], alone_uniform_ms=alone["uniform"],
            kernel=kname,
            rows_apart=check["rows_apart"], pairs_apart=len(apart)))
        r = results[-1]
        print(f"{label} kernel {name}: rows={C} K={K} radii [{float(radii.min()):.4f}, "
              f"{float(radii.max()):.4f}] um, candidates per live row "
              f"{candidates / max(1, int(live.sum())):.2f}, kept pairs {kept}; "
              f"max|F|={check['f_scale']:.6e} N max_abs_err={check['max_abs_err']:.3e} N "
              f"(rows agreeing); rows with keep sets apart {check['rows_apart']}, pairs "
              f"decided apart {len(apart)}: {apart[:8]}; kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}); alone "
              f"per launch (profiler, {ALONE_LAUNCHES} launches, in turns) general "
              f"{alone['general']} uniform {alone['uniform']} ms")

    # B6, the id-list substep
    f_k, d_k, p_k = contact.contact_substep_cuda(*args, **law)
    f_p, d_p, p_p = contact.contact_substep_plain(*args, **law)
    torch.cuda.synchronize()
    check = check_general("contact_substep[general]", f_k, d_k, f_p, d_p,
                          torch.eq(p_k, p_p).all(dim=1), lambda rows: (
                              keep_from_partners(args, p_k, rows),
                              keep_from_partners(args, p_p, rows)), args, bio)
    entry("contact_substep", "contact.cu", "hipsc_abm_tpu/ops/pallas_contact.py:79",
          lambda: contact.contact_substep_cuda(*args, **law),
          lambda: contact.contact_substep_plain(*args, **law),
          lambda: contact.contact_substep_cuda(*args, **uni), "contact_substep_kernel",
          C * (row_bytes + 4 + 8 * K + 16), int(d_p.sum()), check)

    # B2, the seed
    f_k, d_k, m_k = span_mask.contact_seed_cuda(*args, **law)
    f_p, d_p, m_p = span_mask.contact_seed_plain(*args, **law)
    torch.cuda.synchronize()
    W = m_p.shape[0]
    check = check_general("contact_seed[general]", f_k, d_k, f_p, d_p,
                          torch.eq(m_k, m_p).all(dim=0), lambda rows: (
                              keep_from_mask(args, m_k, rows),
                              keep_from_mask(args, m_p, rows)), args, bio)
    entry("contact_seed", "contact_mask.cu", "hipsc_abm_tpu/ops/pallas_contact.py:697",
          lambda: span_mask.contact_seed_cuda(*args, **law),
          lambda: span_mask.contact_seed_plain(*args, **law),
          lambda: span_mask.contact_seed_cuda(*args, **uni), "contact_mask_kernel<true",
          C * (row_bytes + 16 + 4 * W) + 4 * K * walk["rows"] + 4 * walk["membership"],
          int(d_p.sum()), check)

    # B1, the masked substep at the positions the seed's forces move the rows
    # to, from the plain seed's mask
    size = torch.tensor(eng.gen.size, dtype=torch.float32, device=f_p.device)
    loc1 = stokes_integrate(args[0][:, :3], args[0][:, 3], f_p, torch.zeros_like(f_p),
                            args[2], bio.stokes, size, float(bio.move_dt))
    margs = (pack_physics(loc1, args[0][:, 3]), *args[1:4])
    m_k, m_p, m_time = m_p.clone(), m_p.clone(), m_p.clone()
    f_k, d_k, _ = span_mask.contact_masked_cuda(*margs, m_k, **law)
    f_p, d_p, _ = span_mask.contact_masked_plain(*margs, m_p, **law)
    torch.cuda.synchronize()
    check = check_general("contact_masked[general]", f_k, d_k, f_p, d_p,
                          torch.eq(m_k, m_p).all(dim=0), lambda rows: (
                              keep_from_mask(margs + (None,), m_k, rows),
                              keep_from_mask(margs + (None,), m_p, rows)),
                          margs + (None,), bio)
    entry("contact_masked", "contact_mask.cu", "hipsc_abm_tpu/ops/pallas_contact.py:481",
          lambda: span_mask.contact_masked_cuda(*margs, m_time, **law),
          lambda: span_mask.contact_masked_plain(*margs, m_time, **law),
          lambda: span_mask.contact_masked_cuda(*margs, m_time, **uni),
          "contact_mask_kernel<false", C * (row_bytes + 16 + 8 * W), int(d_p.sum()), check)
    # B4's fourth call (diff_surround, motility mode with the states as f2)
    # beside the step's other three, each with its bound
    calls = record_bio_calls(eng, state)
    bounds_ms = []
    for b_args, b_kw in calls:
        out = bio_moments.bio_moments_cuda(*b_args, **b_kw)
        bounds_ms.append(bio_bound(b_args, b_kw, float(out[:, 0].sum()))["bound_ms"])
    print(f"{label} kernel {kernels.counted_name('bio_moments', n_runs)} with diff_surround: "
          f"{len(calls)} calls per step ({', '.join(kw['mode'] for _, kw in calls)}), bound "
          f"per call {[round(b, 5) for b in bounds_ms]} ms, the diff_surround call's "
          f"{bounds_ms[2]:.5f} ms, the step's four {sum(bounds_ms):.5f} ms")
    kernels.launch_counts.clear()
    return results


def ftcs_args(eng, lattice) -> tuple:
    """The arguments of the step's FTCS call on ``lattice``."""
    from hipsc_abm_tpu_torch.ops import diffusion

    diff = eng.diff
    return (lattice, diffusion.diffusion_dts(eng.bio.step_dt, diff.diffuse_dt),
            diff.diffuse_const, diff.spat_res2, diff.max_concentration, diff.degradation)


def check_ftcs(fargs, label) -> float:
    """The FTCS kernel against its plain version, bit for bit; returns the
    max abs error (0)."""
    from hipsc_abm_tpu_torch.ops import diffusion, ftcs

    g_k = ftcs.ftcs_diffuse_cuda(*fargs)
    g_p = diffusion.ftcs_diffuse(*fargs)
    torch.cuda.synchronize()
    err = float((g_k - g_p).abs().max())
    equal = bool(torch.equal(g_k, g_p))
    print(f"{label}: lattice={tuple(fargs[0].shape)} subcycles={len(fargs[1])} "
          f"max_abs_err={err:.3e} bit-equal={equal}")
    if not equal:
        raise AssertionError(f"{label}: not bit-equal to the plain version")
    return err


def membership_counts(args, law, chunk: int = 16384) -> dict:
    """Candidates of live rows (self excluded) that the plain pair law
    keeps (d > break_d) and that lie beyond the search radius, the only
    ones that reach the bond-membership test of B6 and of the seed:
    ``membership``, their number, and ``rows``, the rows with one or
    more."""
    from hipsc_abm_tpu_torch.ops.jkr import _pair_jkr

    xyzr, ids, alive, bounds, _ = args
    C = xyzr.shape[0]
    b = bounds.to(torch.int64).view(C, -1, 2)
    width = int(torch.clamp(b[..., 1] - b[..., 0], min=0).max())
    k = torch.arange(max(width, 1), device=bounds.device)
    totals = dict(membership=0, rows=0)
    for lo in range(0, C, chunk):
        rows = slice(lo, lo + chunk)
        # each row's runs, padded to the widest; positions index all C rows
        pos = b[rows, :, :1] + k
        valid = (pos < b[rows, :, 1:]).flatten(1)
        pos = pos.clamp(0, C - 1).flatten(1)
        cand = xyzr[pos]
        me = xyzr[rows][:, None, :]
        dist2 = ((me[..., :3] - cand[..., :3]) ** 2).sum(-1)
        _, survive = _pair_jkr(me[..., :3], cand[..., :3], me[..., 3], cand[..., 3],
                               law["adhesion_const"], law["poisson"], law["youngs"],
                               law["break_d"])
        pair = valid & alive[rows][:, None] & (ids[pos] != ids[rows][:, None])
        reach = pair & survive & (dist2 > float(np.float32(law["radius"]) ** 2))
        totals["membership"] += int(reach.sum())
        totals["rows"] += int(reach.any(dim=1).sum())
    return totals


def _window_lanes(off: torch.Tensor, width: int) -> int:
    """Lanes in the union of each program's windows ``[off, off + width)``
    (``off`` is (groups, nblk))."""
    off = torch.sort(off, dim=0).values
    gap = torch.clamp(off[1:] - off[:-1], max=width)
    return int(width * off.shape[1] + gap.sum())


def probe_phase() -> list:
    """P1 and P2: every mode against its plain version at NBLK = 4096, then
    through the probe's entry point, one mode at a time, with the launch
    counts set to 0 just before; the entry point's time is the entry's
    ``ms``."""
    from hipsc_abm_tpu_torch import kernels
    from hipsc_abm_tpu_torch.tools import dynslice_probe as p1
    from hipsc_abm_tpu_torch.tools import device_kernels
    from hipsc_abm_tpu_torch.tools import dynslice_probe2 as p2

    results = []
    for probe in (p1, p2):
        name = probe.__name__.rsplit(".", 1)[1]
        src_line = 34 if probe is p1 else 42
        inputs = probe.make_inputs(probe.NBLK, "cuda")
        offs, rows, span = inputs
        nblk = probe.NBLK
        for mode in probe.MODES:
            got = probe.probe_cuda(*inputs, mode)
            want = probe.probe_plain(*inputs, mode)
            torch.cuda.synchronize()
            scale = float(want.abs().max())
            if probe is p1:
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
                width, span_rows, row_bytes = p1.W, 2, 8
                pairs = p1.lanes(nblk)
                flops = P1_FLOPS * pairs  # the data never fails d2 < 100
            else:
                torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)
                width, span_rows, row_bytes = p2.GROUPS[mode][1], 4, 16
                pairs = p2.lanes(mode, nblk)
                # the (row, lane) pairs this run's data keeps: one pass
                # over the body's test
                kept = sum(int(p2.pair_terms(r, c)[0].sum())
                           for _, _, r, c in p2.blocks(*inputs, mode))
                flops = P2_FLOPS * pairs + P2_KEPT_FLOPS * kept
            err = float((got - want).abs().max())
            # compulsory bytes: the rows' used columns, each program's
            # window lanes of the span rows read, the offsets where the
            # window depends on them, and the output
            span_lanes = _window_lanes(probe.window_offsets(mode, offs), width)
            uses_offs = mode not in ("static", "full")
            moved = (rows.shape[0] * (row_bytes + 4) + 4 * span_rows * span_lanes
                     + (offs.numel() * 4 if uses_offs else 0))
            plain_ms = cuda_ms(lambda: probe.probe_plain(*inputs, mode), 3)
            # the kernel's own device time per launch: the entry point's
            # CUDA-event time also holds the host's launch path
            kname = f"{name}_kernel"
            _, _, prof = device_kernels(lambda: probe.probe_cuda(*inputs, mode), 10, (kname,))
            kernel_ms = prof[kname][0] / prof[kname][1] if kname in prof else None
            kernels.launch_counts.clear()
            (run,) = probe.main([mode])
            launches = kernels.launch_counts[name]
            if launches != probe.REPS + 1:
                raise AssertionError(f"{name}[{mode}]: {launches} launches, "
                                     f"expected {probe.REPS + 1}")
            results.append(dict(
                name=f"{name}[{mode}]", route="cuda",
                source="hipsc_abm_tpu_torch/csrc/dynslice_probe.cu",
                replaces=f"tools/{name}.py:{src_line}", launches=launches,
                max_abs_err=err, ms=run["ms"], plain_ms=plain_ms,
                **bound(moved, flops), library_ms=None, law="uniform"))
            r = results[-1]
            alone = ("not measured" if kernel_ms is None else
                     f"{kernel_ms:.4f} ms per launch (profiler), "
                     f"{kernel_ms / r['bound_ms']:.2f}x its bound")
            print(f"probe {r['name']}: max|out|={scale:.6e} max_abs_err={err:.3e}; "
                  f"{r['ms']:.4f} ms ({run['glanes_per_s']:.1f} Glanes/s), kernel alone "
                  f"{alone}, plain "
                  f"{plain_ms:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}: "
                  f"{moved / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)")
        del inputs, offs, rows, span
    kernels.launch_counts.clear()
    torch.cuda.empty_cache()
    return results


def compare_colonies(a: dict, b: dict, label: str, bond_rows_allowed: int) -> str:
    """Two numpy states compared by agent id: integer state and radii
    equal, positions within 1e-3 um, at most ``bond_rows_allowed`` bond sets
    differing. Returns a summary."""
    ia, ib = by_id(a), by_id(b)
    if not np.array_equal(ia["ids"], ib["ids"]):
        raise AssertionError(f"{label}: agent id sets differ")
    for k in ("FGF4", "FGFR", "ERK", "GATA6", "NANOG", "states", "death_counters",
              "diff_counters", "div_counters", "fds_counters", "radii"):
        if not np.array_equal(ia[k], ib[k]):
            raise AssertionError(f"{label}: {k} differs")
    loc_err = float(np.abs(ia["locations"] - ib["locations"]).max())
    np.testing.assert_allclose(ia["locations"], ib["locations"], rtol=0, atol=1e-3)
    summary = f"{len(ia['ids'])} agents, ints equal, max|dloc|={loc_err:.3e} um"
    if "fgf4_values" in a["gradients"]:
        lat_err = float(np.abs(a["gradients"]["fgf4_values"]
                               - b["gradients"]["fgf4_values"]).max())
        np.testing.assert_allclose(a["gradients"]["fgf4_values"],
                                   b["gradients"]["fgf4_values"], rtol=0, atol=1e-6)
        summary += f", max|dlattice|={lat_err:.3e}"
    bond_rows = sum(x != y for x, y in zip(ia["bonds"], ib["bonds"]))
    if bond_rows > bond_rows_allowed:
        raise AssertionError(f"{label}: bond sets differ on {bond_rows} rows")
    return summary + f", bond rows differing={bond_rows}"


def step_phase(optional: bool = False):
    """One step from one 20k-cell state on the CPU and on the card, for each
    contact path, and the two paths against each other on the card;
    ``optional``: with the three optional phases on and seeded radii."""
    from hipsc_abm_tpu_torch import convert

    flags = OPTIONAL if optional else {}
    tag = " (optional phases)" if optional else ""
    base, s0 = engine_for(2, N_STEP_CHECK, "cpu", "id_list", optional)
    s0, _ = base.safe_step(s0)  # bonds and a lattice to start from
    d0 = convert.state_to_numpy(s0)
    on_card = {}
    for path in PATHS:
        cpu = bench_engine(N_STEP_CHECK, "cpu", path, **flags)
        gpu = bench_engine(N_STEP_CHECK, "cuda", path, **flags)
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
                                   f"step[{path}]{tag} card vs CPU", allowed)
        print(f"step phase [{path}]{tag} card vs CPU: {summary}, cpu {t1 - t0:.2f} s, "
              f"card {t2 - t1:.2f} s")
    summary = compare_colonies(on_card["id_list"], on_card["span_mask"],
                               f"step{tag} span_mask vs id_list on the card", 0)
    print(f"step phase{tag} span_mask vs id_list on the card: {summary}")


def step_phase_3d(steps: int = 4, optional: bool = False):
    """The spheroid example's configuration (3,000 + 300 cells): ``steps``
    ``safe_step``s on the CPU and on the card from the same seeded ball, for
    each contact path (bond sets held equal), and the two paths against each
    other on the card; ``optional`` as in ``step_phase``."""
    from hipsc_abm_tpu_torch import convert

    tag = " (optional phases)" if optional else ""
    on_card = {}
    for path in PATHS:
        out, k_grown = {}, {}
        for device in ("cpu", "cuda"):
            eng, state = engine_for(3, N_SPHEROID, device, path, optional)
            t0 = time.perf_counter()
            for _ in range(steps):
                state, info = eng.safe_step(state)
            if device == "cuda":
                torch.cuda.synchronize()
            out[device] = (convert.state_to_numpy(state), time.perf_counter() - t0)
            k_grown[device] = state.bonds.partners.shape[1]
        on_card[path] = out["cuda"][0]
        summary = compare_colonies(out["cpu"][0], out["cuda"][0],
                                   f"3D step[{path}]{tag} card vs CPU", 0)
        print(f"step phase 3D [{path}]{tag} card vs CPU after {steps} safe_steps: {summary}, "
              f"bond_cap {k_grown['cpu']}/{k_grown['cuda']}, cpu {out['cpu'][1]:.2f} s, "
              f"card {out['cuda'][1]:.2f} s")
    a, b = by_id(on_card["id_list"]), by_id(on_card["span_mask"])
    same_ids = np.array_equal(a["ids"], b["ids"])
    dloc = float(np.abs(a["locations"] - b["locations"]).max()) if same_ids else float("nan")
    bond_rows = sum(x != y for x, y in zip(a["bonds"], b["bonds"])) if same_ids else -1
    print(f"step phase 3D{tag} span_mask vs id_list on the card: same agents {same_ids}, "
          f"max|dloc|={dloc:.3e} um, bond rows differing={bond_rows}")


def coupling_phase(steps: int = 20) -> None:
    """Reproducibility with ``DiffusionParams.field_coupling`` on: two runs
    of the 2D bench configuration at ``N_MAIN`` cells from one seed,
    ``steps`` ``safe_step``s each, compared by agent id. With coupling on,
    the lattice feeds the integer FDS update through ``floor((1 + g) *
    field)``, so integer state, positions and (its deposit summing in a
    fixed order) the lattice must come out bit-equal. The bench's release
    (0.01 per cell and step) alone would keep the field far below the
    floor's first boundary, so both runs start from one lattice drawn
    uniform in [0, max_concentration) from the seed, with degradation off so
    that the field stays in that range for all the steps."""
    from hipsc_abm_tpu_torch import convert

    runs = []
    for _ in range(2):
        eng = bench_engine(N_MAIN, "cuda")
        eng.diff = dataclasses.replace(eng.diff, field_coupling=True, degradation=0.0)
        state = eng.init_state(seed=SEED)
        g = state.gradients["fgf4_values"]
        lattice = (np.random.default_rng(SEED).random(tuple(g.shape), dtype=np.float32)
                   * np.float32(eng.diff.max_concentration))
        state = state._replace(gradients={"fgf4_values": torch.from_numpy(lattice).to(g.device)})
        for _ in range(steps):
            state, _ = eng.safe_step(state)
        torch.cuda.synchronize()
        runs.append(convert.state_to_numpy(state))
    a, b = by_id(runs[0]), by_id(runs[1])
    label = f"coupling phase ({N_MAIN} cells, {steps} safe_steps, two runs)"
    if not np.array_equal(a["ids"], b["ids"]):
        raise AssertionError(f"{label}: agent id sets differ")
    ints = [k for k in ("FGF4", "FGFR", "ERK", "GATA6", "NANOG", "states", "death_counters",
                        "diff_counters", "div_counters", "fds_counters")
            if not np.array_equal(a[k], b[k])]
    loc_equal = np.array_equal(a["locations"].view(np.int32), b["locations"].view(np.int32))
    la, lb = (r["gradients"]["fgf4_values"] for r in runs)
    lat_diff = int((la.view(np.int32) != lb.view(np.int32)).sum())
    print(f"{label}: {len(a['ids'])} agents; integer fields differing {ints or 'none'}; "
          f"positions bit-equal {loc_equal}; lattice points differing in bits {lat_diff} of "
          f"{la.size} (max |d| {float(np.abs(la - lb).max()):.3e}); lattice mean "
          f"{float(la.mean()):.4f}, min {float(la.min()):.4f}, max {float(la.max()):.4f}")
    if ints or not loc_equal or lat_diff:
        raise AssertionError(f"{label}: the two runs part (integer fields {ints}, positions "
                             f"bit-equal {loc_equal}, lattice points apart {lat_diff})")


def write_templates(root: str, general: dict, experimental: dict) -> None:
    """``templates/general.yaml`` and ``experimental.yaml`` under ``root``,
    one ``key: value`` line each (lists as ``[a, b]``)."""

    def text(keys):
        return "".join(f"{k}: [{', '.join(map(str, v))}]\n" if isinstance(v, list)
                       else f"{k}: {v}\n" for k, v in keys.items())

    os.makedirs(os.path.join(root, "templates"), exist_ok=True)
    for name, keys in (("general", general), ("experimental", experimental)):
        with open(os.path.join(root, "templates", f"{name}.yaml"), "w") as f:
            f.write(text(keys))


def seeded_simulation():
    """``CellSimulation`` with the radii of its initial colony drawn by
    ``seeded_radii`` (growth then has something to do)."""
    from hipsc_abm_tpu_torch.models.hipsc import CellSimulation

    class SeededRadiiSimulation(CellSimulation):
        def agent_initials(self):
            super().agent_initials()
            self.radii = seeded_radii(self.number_agents, self.biology_params)

    return SeededRadiiSimulation


def run_lifecycle(root: str, argv: list, cls=None):
    """``cls.start`` (``CellSimulation`` by default) on the card from
    ``root`` (its templates) into ``root/outputs``; the run's own prints are
    kept out of this script's output unless it fails."""
    from hipsc_abm_tpu_torch.models.hipsc import CellSimulation

    cwd, log = os.getcwd(), io.StringIO()
    os.chdir(root)
    try:
        with contextlib.redirect_stdout(log):
            return (cls or CellSimulation).start(os.path.join(root, "outputs"), argv=argv,
                                                 device="cuda")
    except BaseException:
        print(log.getvalue()[-4000:])
        raise
    finally:
        os.chdir(cwd)


def lifecycle_card_vs_cpu(root: str, steps: int, cls=None, contact_path: str = "id_list",
                          label: str = "lifecycle") -> list:
    """The lifecycle's initial colony (``cls``, ``CellSimulation`` by
    default, set up from the templates under ``root``) stepped ``steps``
    times by ``safe_step`` on the card and on the CPU, on ``contact_path``.
    Per step: the two trajectories compared by agent id (agents, integer
    fields equal, max |dloc|, agents moved apart by more than 1e-3 um, bond
    sets differing), and one card step from the CPU's previous state against
    the CPU's step (max |dloc|, bond sets differing). Returns one dict per
    step."""
    from hipsc_abm_tpu_torch import convert
    from hipsc_abm_tpu_torch.models.hipsc import CellSimulation

    cls = cls or CellSimulation
    cwd = os.getcwd()
    os.chdir(root)
    try:
        sims = {}
        for device in ("cuda", "cpu"):
            sim = cls("drift", os.path.join(root, "outputs") + os.sep, device=device)
            sim.agent_initials()
            sim.build_state()
            sim.engine.cfg = dataclasses.replace(sim.engine.cfg, contact_path=contact_path)
            sims[device] = sim
    finally:
        os.chdir(cwd)
    card, cpu = sims["cuda"], sims["cpu"]
    one = cls.__new__(cls)  # an engine for the one-step check only
    one.__dict__.update(card.__dict__)
    one.engine = one._make_engine()

    def diff(a, b):
        ia, ib = by_id(a), by_id(b)
        if not np.array_equal(ia["ids"], ib["ids"]):
            return dict(same_agents=False)
        ints = all(np.array_equal(ia[k], ib[k]) for k in (
            "FGF4", "FGFR", "ERK", "GATA6", "NANOG", "states", "death_counters",
            "diff_counters", "div_counters", "fds_counters"))
        d = np.abs(ia["locations"] - ib["locations"]).max(axis=1)
        return dict(same_agents=True, ints_equal=ints, max_dloc=float(d.max()),
                    over_1e3=int((d > 1e-3).sum()),
                    bond_rows=sum(x != y for x, y in zip(ia["bonds"], ib["bonds"])))

    out = []
    for step in range(1, steps + 1):
        prev = convert.state_to_numpy(cpu.state)
        one.engine.cfg = cpu.engine.cfg
        one_state, _ = one.engine.safe_step(convert.state_from_numpy(prev, "cuda"))
        card.state, _ = card.engine.safe_step(card.state)
        cpu.state, _ = cpu.engine.safe_step(cpu.state)
        torch.cuda.synchronize()
        now = convert.state_to_numpy(cpu.state)
        row = dict(step=step, agents=int(now["alive"].sum()),
                   trajectory=diff(convert.state_to_numpy(card.state), now),
                   one_step=diff(convert.state_to_numpy(one_state), now))
        print(f"{label} card vs CPU, step {step}: {row}")
        out.append(row)
    return out


def values_trajectory(run_dir: str, name: str, steps) -> list:
    """``(agents, GATA6-high, differentiated)`` per step from the run's
    values CSVs (columns of ``models.hipsc.OUTPUT_ARRAYS``)."""
    out = []
    for step in steps:
        path = os.path.join(run_dir, f"{name}_values", f"{name}_values_{step}.csv")
        with open(path) as f:
            header = f.readline().strip().split(",")
        v = np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)
        col = {h: v[:, i] for i, h in enumerate(header)}
        out.append((len(v), int((col["GATA6"] > col["NANOG"]).sum()),
                    int((col["states"] == 1).sum())))
    return out


@contextlib.contextmanager
def lifecycle_timers(into: dict):
    """Time the lifecycle's parts that its data CSV does not hold: agent
    set-up (``agent_initials`` + ``build_state``), the drain of the output
    queue (``flush_outputs``) and, per output kind, the seconds the output
    worker spends on its tasks (keyed by the submitting method). At each
    step's ``data()`` call, ``into["steps"]`` gets the step's peak device
    memory (MiB, the peak is then reset) and the launch counts so far."""
    from hipsc_abm_tpu_torch import kernels
    from hipsc_abm_tpu_torch.models.hipsc import CellSimulation
    from hipsc_abm_tpu_torch.utils import io as io_utils

    def add(key, t0):
        into[key] = into.get(key, 0.0) + time.perf_counter() - t0

    def timed(fn, key):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                add(key, t0)
        return call

    def data(sim):
        into.setdefault("steps", []).append(
            (torch.cuda.max_memory_allocated() / 2**20, dict(kernels.launch_counts)))
        torch.cuda.reset_peak_memory_stats()
        saved[4](sim)

    submit = io_utils.submit_output
    patched = [(CellSimulation, "agent_initials"), (CellSimulation, "build_state"),
               (io_utils, "flush_outputs"), (io_utils, "submit_output"),
               (CellSimulation, "data")]
    saved = [getattr(obj, name) for obj, name in patched]
    CellSimulation.agent_initials = timed(saved[0], "set-up")
    CellSimulation.build_state = timed(saved[1], "set-up")
    io_utils.flush_outputs = timed(saved[2], "drain")
    io_utils.submit_output = lambda fn, *a, **k: submit(
        timed(fn, "worker " + fn.__qualname__.split(".<locals>")[0]), *a, **k)
    CellSimulation.data = data
    try:
        yield into
    finally:
        for (obj, name), value in zip(patched, saved):
            setattr(obj, name, value)


def resume_check(root: str, general: dict, experimental: dict, label: str, cls=None):
    """Mode 0 to half of ``end_step`` then mode 1 to ``end_step`` ("resumed")
    against mode 0 straight to ``end_step`` ("straight"), from the templates
    written under ``root``: bit-equal by agent id (integer fields, positions,
    radii and bond sets) or it raises."""
    from hipsc_abm_tpu_torch import convert

    steps = general["end_step"]

    def run(name, argv, end_step):
        write_templates(root, dict(general, end_step=end_step), experimental)
        t = time.perf_counter()
        sim = run_lifecycle(root, ["-n", name] + argv, cls)
        return sim, time.perf_counter() - t

    _, t_a0 = run("resumed", ["-m", "0"], steps // 2)
    resumed, t_a1 = run("resumed", ["-m", "1", "-fs", str(steps)], steps)
    straight, t_b = run("straight", ["-m", "0"], steps)
    a = by_id(convert.state_to_numpy(resumed.state))
    b = by_id(convert.state_to_numpy(straight.state))
    if not np.array_equal(a["ids"], b["ids"]):
        raise AssertionError(f"{label}: mode 0+1 and mode 0 hold different agents")
    differ = [k for k in ("FGF4", "FGFR", "ERK", "GATA6", "NANOG", "states",
                          "death_counters", "diff_counters", "div_counters",
                          "fds_counters") if not np.array_equal(a[k], b[k])]
    for k in ("locations", "radii"):
        if not np.array_equal(a[k].view(np.int32), b[k].view(np.int32)):
            differ.append(k)
    if a["bonds"] != b["bonds"]:
        differ.append("bonds")
    if differ:
        raise AssertionError(f"{label}: mode 0 to {steps // 2} + mode 1 to {steps} differs "
                             f"from mode 0 to {steps} in {differ}")
    print(f"{label}: mode 0 to step {steps // 2} ({t_a0:.2f} s) + mode 1 to step {steps} "
          f"({t_a1:.2f} s) bit-equal by agent id to mode 0 to step {steps} ({t_b:.2f} s): "
          f"{len(a['ids'])} agents, integer fields, positions, radii and bond sets")
    return straight


def lifecycle_phase() -> dict:
    """The lifecycle on the card (see the module docstring, phase 6);
    returns phase b's numbers."""
    from hipsc_abm_tpu_torch import kernels
    from hipsc_abm_tpu_torch.utils import io as io_utils

    tmp = tempfile.mkdtemp(prefix="hipsc_lifecycle_")
    try:
        # --- a: the reference's templates, resume and the trajectory ---
        root = os.path.join(tmp, "a")
        out = os.path.join(root, "outputs")
        steps = LIFECYCLE_GENERAL["end_step"]
        n0 = LIFECYCLE_GENERAL["num_to_start"] + LIFECYCLE_EXPERIMENTAL["num_gata6"]
        label = f"lifecycle phase a ({n0} cells)"

        # the first steps on the card against the CPU: each card step from the
        # CPU's previous state to the step phase's tolerance; the two
        # trajectories with integer state equal (their positions part by
        # more than one step's rounding where a contact decision falls
        # within it, so their drift is reported)
        write_templates(root, LIFECYCLE_GENERAL, LIFECYCLE_EXPERIMENTAL)
        allowed = max(1, n0 // 10000)
        for row in lifecycle_card_vs_cpu(root, LIFECYCLE_CPU_STEPS):
            one, traj = row["one_step"], row["trajectory"]
            if not (one["same_agents"] and one["ints_equal"] and one["max_dloc"] <= 1e-3
                    and one["bond_rows"] <= allowed):
                raise AssertionError(f"{label}: step {row['step']} on the card from the CPU's "
                                     f"state differs: {one}")
            if not (traj["same_agents"] and traj["ints_equal"]
                    and traj["bond_rows"] <= allowed):
                raise AssertionError(f"{label}: the card's and the CPU's trajectories part at "
                                     f"step {row['step']}: {traj}")

        resume_check(root, LIFECYCLE_GENERAL, LIFECYCLE_EXPERIMENTAL, label)
        traj = {name: values_trajectory(os.path.join(out, name), name, range(1, steps + 1))
                for name in ("resumed", "straight")}
        if traj["resumed"] != traj["straight"]:
            raise AssertionError(f"{label}: the two runs' values CSVs differ in their counts")
        for step, (ra, rb) in enumerate(zip(traj["resumed"], traj["straight"]), start=1):
            print(f"{label} step {step}: agents {ra[0]} / {rb[0]}, GATA6-high {ra[1]} / {rb[1]}, "
                  f"differentiated {ra[2]} / {rb[2]} (mode 0+1 / mode 0)")
        if traj["straight"][-1][2] == 0 or traj["straight"][-1][1] <= traj["straight"][3][1]:
            raise AssertionError(f"{label}: no fate decision after dox: {traj['straight']}")

        run_dir = os.path.join(out, "straight")
        video = os.path.join(run_dir, "straight_video.mp4")
        if os.path.exists(video):
            os.remove(video)
        run_lifecycle(root, ["-n", "straight", "-m", "2"])
        encoder = io_utils.video_encoder()
        if os.path.exists(video) != (encoder is not None):
            raise AssertionError(f"{label}: mode 2 with video encoder {encoder}: mp4 "
                                 f"{'written' if os.path.exists(video) else 'missing'}")
        run_lifecycle(root, ["-n", "straight", "-m", "3"])
        if not os.path.isfile(os.path.join(out, "straight.zip")):
            raise AssertionError(f"{label}: mode 3 wrote no zip")
        frames = len(os.listdir(os.path.join(run_dir, "straight_images")))
        for f in ("straight_temp.pkl", "straight_state.npz", "straight_data.csv"):
            if not os.path.isfile(os.path.join(run_dir, f)):
                raise AssertionError(f"{label}: {f} missing")
        if frames != steps + 1:
            raise AssertionError(f"{label}: {frames} step images for {steps} steps")
        print(f"{label}: mode 2 and mode 3 ran; {frames} step images by "
              f"{io_utils.image_encoder()}, video encoder {encoder or 'none installed'}")

        # --- b: the bench configuration through the lifecycle ---
        root = os.path.join(tmp, "b")
        out = os.path.join(root, "outputs")
        write_templates(root, LIFECYCLE_BENCH_GENERAL, LIFECYCLE_BENCH_EXPERIMENTAL)
        steps = LIFECYCLE_BENCH_GENERAL["end_step"]
        n0 = LIFECYCLE_BENCH_GENERAL["num_to_start"] + LIFECYCLE_BENCH_EXPERIMENTAL["num_gata6"]
        label = f"lifecycle phase b (bench, {n0} cells)"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.launch_counts.clear()
        t = time.perf_counter()
        with lifecycle_timers({}) as parts:
            sim = run_lifecycle(root, ["-n", "bench", "-m", "0"])
        wall = time.perf_counter() - t
        counts = dict(kernels.launch_counts)
        # the run's peak: each step's (reset at its data() call) and the rest
        peak = max([p for p, _ in parts.get("steps", [])]
                   + [torch.cuda.max_memory_allocated() / 2**20])
        for name in ("bio_moments", "contact_substep", "ftcs_diffuse"):
            if counts.get(name, 0) <= 0:
                raise AssertionError(f"{label}: kernel {name} was never launched ({counts})")
        if 3 * counts["ftcs_diffuse"] != counts["bio_moments"]:
            raise AssertionError(f"{label}: {counts['ftcs_diffuse']} FTCS launches for "
                                 f"{counts['bio_moments'] // 3} step attempts")
        run_dir = os.path.join(out, "bench")
        with open(os.path.join(run_dir, "bench_data.csv")) as f:
            header = f.readline().strip().split(",")
            rows = [list(map(float, line.split(","))) for line in f if line.strip()]
        if [int(r[0]) for r in rows] != list(range(1, steps + 1)):
            raise AssertionError(f"{label}: data CSV steps {[r[0] for r in rows]}")
        lattice = sim.state.gradients["fgf4_values"]
        if not (n0 < sim.number_agents < 2 * n0) or not bool(torch.isfinite(lattice).all()):
            raise AssertionError(f"{label}: {sim.number_agents} agents, lattice finite "
                                 f"{bool(torch.isfinite(lattice).all())}")
        expected = [os.path.join("bench_values", f"bench_values_{steps}.csv"),
                    os.path.join("bench_tda", "all", f"bench_tda_all_{steps}.csv"),
                    os.path.join("bench_gradients", "fgf4_values",
                                 f"bench_fgf4_values_{steps}.csv"),
                    os.path.join("bench_images", f"bench_image_{steps}.png"),
                    "bench_state.npz"]
        missing = [f for f in expected if not os.path.isfile(os.path.join(run_dir, f))]
        if missing or os.path.exists(os.path.join(run_dir, "bench_temp.pkl")):
            raise AssertionError(f"{label}: outputs missing {missing} or a pickle written")
        per_step = [dict(zip(header, r)) for r in rows]
        methods = header[4:]
        before = {}
        for r, (peak_step, launched) in zip(per_step, parts["steps"]):
            times = ", ".join(f"{m} {r[m] * 1e3:.2f}" for m in methods)
            step_counts = {k: launched.get(k, 0) - before.get(k, 0)
                           for k in ("bio_moments", "contact_substep", "ftcs_diffuse")}
            before = launched
            if min(step_counts.values()) <= 0:
                raise AssertionError(f"{label}: step {int(r['Step Number'])} launched "
                                     f"{step_counts}")
            r["peak_mib"], r["launches"] = peak_step, step_counts
            print(f"{label} step {int(r['Step Number'])}: {int(r['Number Cells'])} agents, wall "
                  f"{r['Step Time'] * 1e3:.2f} ms; ms: {times}; peak device memory "
                  f"{peak_step:.1f} MiB; launches {step_counts}")
        loop = sum(r["Step Time"] for r in per_step)
        print(f"{label}: {steps} steps in {wall:.2f} s from start() to its return: agent "
              f"set-up {parts.get('set-up', 0.0):.2f} s, the steps' wall {loop:.2f} s, drain of "
              f"the output queue {parts.get('drain', 0.0):.2f} s; output worker busy per step: "
              + ", ".join(f"{k[7:]} {v / steps * 1e3:.1f} ms" for k, v in sorted(parts.items())
                          if k.startswith("worker "))
              + f"; peak device memory {peak:.1f} MiB; launches {counts}")
        return dict(cells=n0, steps=steps, wall_s=wall, peak_mib=peak, launches=counts,
                    parts_s={k: v for k, v in parts.items() if k != "steps"},
                    per_step=[{k: r[k] for k in ["Step Time", *methods, "peak_mib", "launches"]}
                              for r in per_step])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def optional_lifecycle_phase() -> None:
    """Optional phase c: the lifecycle's colony (the ``LIFECYCLE_*``
    templates, 5,500 cells) with the three optional phases on and radii
    seeded at set-up (``seeded_simulation``), ``temp_pickle: false`` (mode 1
    resumes from the npz: a class made at run time does not pickle). On
    each contact path, ``OPT_LIFECYCLE_STEPS`` steps, each card step from
    the CPU's previous state: integer state equal by agent id at every step,
    max |dloc| and the bond rows that differ reported. Then mode 0 to 12 +
    mode 1 to 24 bit-equal by agent id to mode 0 to 24 (``resume_check``)."""
    cls = seeded_simulation()
    general = dict(LIFECYCLE_GENERAL, temp_pickle=False)
    experimental = dict(LIFECYCLE_EXPERIMENTAL, **OPTIONAL)
    n0 = general["num_to_start"] + experimental["num_gata6"]
    label = f"optional phase c ({n0} cells)"
    tmp = tempfile.mkdtemp(prefix="hipsc_optional_")
    try:
        root = os.path.join(tmp, "c")
        write_templates(root, general, experimental)
        for path in PATHS:
            rows = lifecycle_card_vs_cpu(root, OPT_LIFECYCLE_STEPS, cls, path,
                                         label=f"{label} [{path}]")
            for row in rows:
                one = row["one_step"]
                if not (one["same_agents"] and one["ints_equal"]):
                    raise AssertionError(f"{label} [{path}]: step {row['step']} on the card "
                                         f"from the CPU's state differs: {one}")
            dloc = [float(f"{r['one_step']['max_dloc']:.3e}") for r in rows]
            bond_rows = [r["one_step"]["bond_rows"] for r in rows]
            traj = [r["trajectory"] for r in rows]
            print(f"{label} [{path}]: {OPT_LIFECYCLE_STEPS} card steps from the CPU's state, "
                  f"integer state equal at each; max|dloc| per step {dloc} um, bond rows "
                  f"differing per step {bond_rows}; the card's own trajectory: integer state "
                  f"equal at each step {all(t.get('ints_equal', False) for t in traj)}, bond "
                  f"rows {[t.get('bond_rows') for t in traj]}")
        straight = resume_check(root, general, experimental, label, cls)
        cfg = straight.engine.cfg
        radii = straight.radii
        if cfg.uniform_radius is not None or not all(getattr(cfg, k) for k in OPTIONAL):
            raise AssertionError(f"{label}: engine config {cfg}")
        print(f"{label}: radii after {general['end_step']} steps in [{float(radii.min()):.4f}, "
              f"{float(radii.max()):.4f}] um, {int((radii < straight.max_radius).sum())} of "
              f"{len(radii)} below max_radius")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def timed_run(dims: int, n_cells: int, path: str, optional: bool = False):
    """init_state(seed=0), 3 safe_step warm-ups, TIMED_STEPS timed
    ``safe_step``s, each on the host clock up to a synchronise (the probe
    fetch that ends it); returns the engine, the
    final state and its numbers (warm-up s, steps/s, median and p90 ms per
    step, peak bytes, contact-window rebuilds per timed step)."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng, state = engine_for(dims, n_cells, "cuda", path, optional)
    for _ in range(3):
        state, _ = eng.safe_step(state)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rebuilds, per_step = [], []
    for _ in range(TIMED_STEPS):
        t = time.perf_counter()
        state, info = eng.safe_step(state)
        per_step.append(time.perf_counter() - t)
        rebuilds.append(info.jkr_rebuilds)
    t2 = time.perf_counter()
    ms = np.asarray(per_step) * 1e3
    return eng, state, dict(warm_s=t1 - t0, steps_per_s=TIMED_STEPS / (t2 - t1),
                            median_ms=float(np.median(ms)),
                            p90_ms=float(np.percentile(ms, 90)),
                            peak_mib=torch.cuda.max_memory_allocated() / 2**20,
                            rebuilds_per_step=float(sum(int(r) for r in rebuilds)) / TIMED_STEPS)


def device_ms_per_step(eng, state, steps: int = 2) -> dict:
    """Device time per step under ``torch.profiler`` over ``steps`` more
    eager steps: ``{"all": ms, "contact": ms, "by_kernel": {short name:
    [ms, launches]}, "rebuilds": r}``, ``by_kernel`` each hand-written
    kernel's own time and launches per step, ``contact`` the contact
    kernels' sum and ``rebuilds`` the window rebuilds per profiled step;
    empty where the profiler saw no device time. The profiled steps are the
    ones right after the timed window (no warm-up call)."""
    from hipsc_abm_tpu_torch.tools import device_kernels

    carry, rebuilds = [state], []

    def step():
        carry[0], info = eng.step(carry[0])
        rebuilds.append(info.jkr_rebuilds)

    total, _, by_kernel = device_kernels(step, steps, CONTACT_KERNELS + OTHER_KERNELS,
                                         warmup=False)
    if total <= 0:
        return {}
    return {"all": total,
            "contact": sum(v[0] for k, v in by_kernel.items() if k in CONTACT_KERNELS),
            "by_kernel": by_kernel, "rebuilds": sum(int(r) for r in rebuilds) / steps}


def taken_launches(name: str, launches: float, attempts: float, rebuilds: float,
                   substeps: int) -> float:
    """Of ``launches`` of the kernel ``name`` over ``attempts`` step
    attempts with ``rebuilds`` window rebuilds in all, those that ran their
    branch: the span-mask seed and compaction once per attempt (the entry
    seed, the exit compaction) and once per rebuild, the masked substep on
    every later substep without one; every launch of the other kernels."""
    if name.startswith(("contact_seed", "mask_compact")):
        return attempts + rebuilds
    if name.startswith("contact_masked"):
        return attempts * (substeps - 1) - rebuilds
    return launches


def main_path(dims: int, n_cells: int, path: str, optional: bool = False) -> dict:
    """One main path (the 2D bench or the 3D spheroid) through the engine
    API on one contact path, with the launch counts set to 0 just before
    and read just after; ``optional``: with the three optional phases on
    and seeded radii (the contact kernels' general law, four bio-moments
    passes per step attempt)."""
    from hipsc_abm_tpu_torch import kernels
    from hipsc_abm_tpu_torch.engine import _physics_dts

    kernels.launch_counts.clear()
    eng, state, nums = timed_run(dims, n_cells, path, optional)
    counts = dict(kernels.launch_counts)
    rebuilds = eng.window_rebuilds  # over every step attempt of the run
    agents = state.num_agents()
    loc = state.arrays["locations"][state.alive]
    size = torch.tensor(eng.gen.size, device=loc.device)
    label = f"main path [{dims}D, {path}, {n_cells}{', optional phases' if optional else ''}]"
    if optional != (eng.cfg.uniform_radius is None) or optional != eng.cfg.enable_diff_surround:
        raise AssertionError(f"{label}: config {eng.cfg}")
    if not (n_cells < agents < 2 * n_cells):
        raise AssertionError(f"{label}: implausible population {agents}")
    if not bool(torch.isfinite(loc).all()) or bool((loc < 0).any()) or bool((loc > size).any()):
        raise AssertionError(f"{label}: locations not finite or outside the box")
    if dims == 2:
        lattice = state.gradients["fgf4_values"]
        if (not bool(torch.isfinite(lattice).all()) or float(lattice.min()) < 0
                or float(lattice.max()) <= 0):
            raise AssertionError(f"{label}: morphogen lattice not finite/positive")
    else:
        extent = loc.max(dim=0).values - loc.min(dim=0).values
        if float(extent.min()) < float(size[0]) / 10:
            raise AssertionError(f"{label}: colony collapsed to a sheet ({extent.tolist()})")
    ids = state.arrays["ids"][state.alive]
    if ids.unique().numel() != agents:
        raise AssertionError(f"{label}: duplicate agent ids")
    for name in PATH_KERNELS[(dims, path)]:
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"{label}: kernel {name} was never launched")
    # every step attempt runs 11 contact substeps, three bio-moments passes
    # (four with diff_surround) and, in 2D, one deposit launch and one FTCS
    # launch for its whole subcycle schedule; on the span-mask path every substep launches the
    # seed (which runs at the entry and where the window is rebuilt), every
    # substep after the first the masked substep (which runs where it is
    # not) and the compaction (as the seed), and the scan's exit one more
    # compaction
    n_runs = 3 if dims == 2 else 9
    n_sub = len(_physics_dts(eng.bio))

    def launched(name):
        return counts.get(kernels.counted_name(name, n_runs), 0)

    substeps = launched("contact_seed" if path == "span_mask" else "contact_substep")
    attempts, rest = divmod(substeps, n_sub)
    if path == "span_mask" and (launched("contact_masked") != (n_sub - 1) * attempts
                                or launched("mask_compact") != n_sub * attempts):
        rest = 1
    passes = 4 if optional else 3
    bio_launches = counts.get(kernels.counted_name("bio_moments", n_runs), 0)
    if rest or attempts < 3 + TIMED_STEPS or bio_launches != passes * attempts or (
            dims == 2 and not counts["ftcs_diffuse"] == counts["deposit"] == attempts):
        raise AssertionError(f"{label}: contact launches {counts}, {bio_launches} "
                             f"bio-moments, {counts.get('ftcs_diffuse')} FTCS and "
                             f"{counts.get('deposit')} deposit launches for {attempts} step "
                             "attempts")
    other = {n for key, names in PATH_KERNELS.items() if key[0] != dims for n in names}
    stray = sorted(n for n in other if counts.get(n, 0))
    if stray:
        raise AssertionError(f"{label}: kernels of the other dimensionality ran: {stray}")
    dev = device_ms_per_step(eng, state)
    if dims == 2:  # the kernel on the main path's own last lattice
        check_ftcs(ftcs_args(eng, state.gradients["fgf4_values"]), f"{label}: ftcs_diffuse")
    fmt = lambda v: "not measured" if v is None else f"{v:.4f} ms"  # noqa: E731
    print(f"{label}: {n_cells} cells start, {agents} agents after {3 + TIMED_STEPS} steps, "
          f"capacity {state.capacity}, bond_cap {state.bonds.partners.shape[1]}")
    print(f"{label}: warm-up (init + 3 safe_step) {nums['warm_s']:.2f} s; {TIMED_STEPS} "
          f"safe_steps "
          f"at {nums['steps_per_s']:.3f} steps/s, per step median {nums['median_ms']:.3f} ms, "
          f"p90 {nums['p90_ms']:.3f} ms; peak device memory {nums['peak_mib']:.1f} MiB; "
          f"rebuilds/step {nums['rebuilds_per_step']:.2f}; device time/step (profiler, 2 eager "
          f"steps, {dev.get('rebuilds')} rebuilds per step): "
          f"contact kernels {fmt(dev.get('contact'))}, all {fmt(dev.get('all'))}; "
          f"by kernel {dev.get('by_kernel')}")
    print(f"{label}: launches {counts} over {attempts} step attempts ({passes} bio-moments "
          f"passes each, {rebuilds} window rebuilds)")
    return dict(nums, counts=counts, attempts=attempts, rebuilds=rebuilds, substeps=n_sub,
                contact_ms=dev.get("contact"), device_ms=dev.get("all"),
                contact_ms_by_kernel=dev.get("by_kernel"),
                profiled_rebuilds_per_step=dev.get("rebuilds"))


def optional_summary(runs) -> None:
    """Optional phase d beside the uniform-law main path: per dimensionality
    and contact path, the medians of the two runs of each, device time per
    step in all, of the contact kernels and of B4, and B4's launches per
    step."""
    def ms(rs, key):
        return [r[key] and round(r[key], 4) for r in rs]

    for dims, n in ((2, N_MAIN), (3, N_MAIN_3D)):
        for path in PATHS:
            cols = {}
            for opt in (False, True):
                rs = [r for d, c, p, o, r in runs if (d, c, p, o) == (dims, n, path, opt)]
                b4 = [(r.get("contact_ms_by_kernel") or {}).get("bio_moments_kernel", (0.0, 0.0))
                      for r in rs]
                cols[opt] = (f"median {ms(rs, 'median_ms')} ms, device {ms(rs, 'device_ms')} "
                             f"ms, contact {ms(rs, 'contact_ms')} ms, B4 "
                             f"{[round(t, 4) for t, _ in b4]} ms in {[k for _, k in b4]} "
                             f"launches per step")
            print(f"optional phase d [{dims}D, {path}, {n}]: optional phases {cols[True]}; "
                  f"uniform-law main path {cols[False]}")


def compare_bits(a: dict, b: dict, label: str) -> str:
    """Two numpy states by agent id: ids, integer fields and bond sets equal,
    positions, radii, the lattice (its deposit sums in a fixed order), the
    key and ``next_id`` bit-equal. Raises, or returns a summary."""
    ia, ib = by_id(a), by_id(b)
    if not np.array_equal(ia["ids"], ib["ids"]):
        raise AssertionError(f"{label}: agent id sets differ")
    differ = [k for k in ("FGF4", "FGFR", "ERK", "GATA6", "NANOG", "states", "death_counters",
                          "diff_counters", "div_counters", "fds_counters")
              if not np.array_equal(ia[k], ib[k])]
    differ += [k for k in ("locations", "radii")
               if not np.array_equal(ia[k].view(np.int32), ib[k].view(np.int32))]
    if ia["bonds"] != ib["bonds"]:
        differ.append("bonds")
    for g in a["gradients"]:
        apart = int((a["gradients"][g].view(np.int32) != b["gradients"][g].view(np.int32)).sum())
        if apart:
            differ.append(f"lattice {g} ({apart} points)")
    differ += [k for k in ("key", "next_id") if not np.array_equal(a[k], b[k])]
    if differ:
        raise AssertionError(f"{label}: {differ} differ")
    return (f"{len(ia['ids'])} agents, integer fields, bond sets, positions, radii, "
            f"{'the lattice, ' if a['gradients'] else ''}key and next_id bit-equal")


class SyncCounter:
    """Counts the synchronising CUDA calls (``torch.cuda.set_sync_debug_mode
    ("warn")``) made inside the ``with`` block: the host reads."""

    def __enter__(self):
        import warnings

        self.count = 0
        self._show = warnings.showwarning
        self._filters = warnings.filters[:]

        def show(message, *args, **kwargs):
            # PyTorch's notice on the first use of the debug mode is not a read
            if "synchroniz" in str(message) and "prototype" not in str(message):
                self.count += 1
            else:
                self._show(message, *args, **kwargs)

        warnings.showwarning = show
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        import warnings

        torch.cuda.set_sync_debug_mode(0)
        warnings.showwarning = self._show
        warnings.filters[:] = self._filters
        return False


def blocks_equal_phase(dims: int, n: int, path: str, optional: bool = False) -> dict:
    """Phase 8 a and b on one main path: from one state (one ``safe_step``
    after ``init_state``), ``run_steps(BLOCK_K)`` (one CUDA graph, captured
    then replayed) against ``BLOCK_K`` ``safe_step``s on the card (blocks of
    one step) and against ``BLOCK_K`` eager ``step``s at the config those
    ended on, compared by ``compare_bits``, with the window rebuilds of each
    step equal; the
    block's launches counted from 0 (each kernel of the path must have run
    in the graph); then one eager step under ``set_sync_debug_mode
    ("error")`` and the host reads of one more block counted."""
    from hipsc_abm_tpu_torch import convert, kernels

    label = (f"blocks phase a [{dims}D, {path}, {n}{', optional phases' if optional else ''}]")
    eng, state = engine_for(dims, n, "cuda", path, optional)
    state, _ = eng.safe_step(state)
    ref = engine_for(dims, n, "cuda", path, optional)[0]
    ref.cfg = eng.cfg
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    steps, infos = state, []
    for _ in range(BLOCK_K):
        steps, info = ref.safe_step(steps)
        infos.append(info)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    peak_steps = torch.cuda.max_memory_allocated() / 2**20
    eager, r_eager = ref.repad_state(state, ref.cfg), []
    for _ in range(BLOCK_K):
        eager, info = ref.step(eager)
        r_eager.append(int(info.jkr_rebuilds))
    eager_summary = compare_bits(convert.state_to_numpy(steps), convert.state_to_numpy(eager),
                                 f"{label} (eager steps)")
    torch.cuda.reset_peak_memory_stats()
    kernels.launch_counts.clear()
    block, binfo = eng.run_steps(state, BLOCK_K)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = dict(kernels.launch_counts)
    peak_block = torch.cuda.max_memory_allocated() / 2**20
    missing = [k for k in PATH_KERNELS[(dims, path)] if counts.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"{label}: kernels {missing} did not run in the block ({counts})")
    summary = compare_bits(convert.state_to_numpy(steps), convert.state_to_numpy(block), label)
    r_steps = [int(i.jkr_rebuilds) for i in infos]
    r_block = [int(r) for r in binfo.jkr_rebuilds]
    if not r_steps == r_eager == r_block:
        raise AssertionError(f"{label}: rebuilds per step {r_steps} (safe_step), {r_eager} "
                             f"(eager step) vs {r_block}")
    graphs = eng.block_graphs()
    print(f"{label}: run_steps({BLOCK_K}) ({t2 - t1:.2f} s, capture included, "
          f"{eng.block_attempts} attempt(s)) vs {BLOCK_K} safe_steps ({t1 - t0:.2f} s): "
          f"{summary}; safe_steps vs eager steps: {eager_summary}; rebuilds per step "
          f"{r_block} on all three; peak device memory "
          f"{peak_steps:.1f} MiB (safe_steps) / {peak_block:.1f} MiB (block); graph "
          f"{[(g['k'], round(g['capture_s'], 2), round(g['pool_mib'], 1)) for g in graphs]} "
          f"(k, capture s, MiB reserved); block launches {counts}")

    # b: no host read in a step, one in a block
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.step(state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    with SyncCounter() as reads:
        eng.run_steps(state, BLOCK_K)
    print(f"blocks phase b [{dims}D, {path}]: one eager step under "
          f"set_sync_debug_mode('error') ran; host reads per block {reads.count} "
          f"(k = {BLOCK_K})")
    if reads.count != 1:
        raise AssertionError(f"blocks phase b [{dims}D, {path}]: {reads.count} host reads in "
                             "one block, expected 1 (the probe fetch)")
    return dict(dims=dims, cells=n, contact_path=path, optional=optional,
                rebuilds=r_block, host_reads=reads.count, peak_mib_steps=peak_steps,
                peak_mib_block=peak_block, graphs=graphs)


def block_growth_phase() -> dict:
    """Phase 8 c: the 2D bench colony at ``N_MAIN`` cells on the span-mask
    path from ``init_state``, at a bond capacity of 2 and a mask capacity of
    16 candidates, both below what its first steps need: ``run_steps
    (BLOCK_K)`` re-executes with the config grown from the block's worst
    probes and ends equal (``compare_bits``) to ``BLOCK_K`` ``safe_step``s
    from the same tight config."""
    from hipsc_abm_tpu_torch import convert

    label = f"blocks phase c (growth, 2D span_mask, {N_MAIN})"
    eng = bench_engine(N_MAIN, "cuda", "span_mask")
    eng.cfg = dataclasses.replace(eng.cfg, bond_cap=2, mask_bits=16)
    ref = bench_engine(N_MAIN, "cuda", "span_mask")
    ref.cfg = eng.cfg
    state = eng.init_state(seed=SEED)
    steps = state
    for _ in range(BLOCK_K):
        steps, _ = ref.safe_step(steps)
    t = time.perf_counter()
    block, _ = eng.run_steps(state, BLOCK_K)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    grown = {k: getattr(eng.cfg, k) for k in ("capacity", "bond_cap", "div_cap", "mask_bits")}
    ref_grown = {k: getattr(ref.cfg, k) for k in grown}
    if eng.block_attempts < 2 or grown["bond_cap"] <= 2 or grown["mask_bits"] <= 16:
        raise AssertionError(f"{label}: no growth in the block ({eng.block_attempts} "
                             f"attempts, config {grown})")
    summary = compare_bits(convert.state_to_numpy(steps), convert.state_to_numpy(block), label)
    print(f"{label}: {eng.block_attempts} attempts in {wall:.2f} s; grown config {grown} "
          f"(safe_steps: {ref_grown}); {summary}")
    return dict(attempts=eng.block_attempts, grown=grown, safe_step_grown=ref_grown)


def timed_engine(dims: int, n: int, path: str):
    """The engine and initial state of a phase 8 d cell: the main path's
    configuration with the capacity ``BLOCK_HEADROOM`` times the initial
    colony."""
    if dims == 2:
        eng = bench_engine(n, "cuda", path)
    else:
        eng, ball = spheroid_engine(n, "cuda", path)
    n0 = eng.gen.num_to_start + eng.xp.num_gata6
    capacity = -(-int(n0 * BLOCK_HEADROOM) // 256) * 256
    eng.cfg = dataclasses.replace(eng.cfg, capacity=capacity,
                                  div_cap=min(eng.cfg.div_cap, capacity))
    state = eng.init_state(seed=SEED) if dims == 2 else eng.init_state(seed=SEED, locations=ball)
    return eng, state


def block_timing(dims: int, n: int, path: str) -> dict:
    """Phase 8 d on one cell: 3 ``safe_step`` warm-ups (the one-step graph
    captured), the blocks of ``TIMED_KS`` captured (their set-up), then from
    that one state, in turns, ``BLOCK_TIMED_STEPS`` eager ``step``s (each
    timed to a synchronise), as many ``safe_step``s, blocks of 10, blocks
    of 50, blocks of 50, blocks of 10, ``safe_step``s, eager ``step``s
    (each ``safe_step`` and block timed to its probe fetch, which ends it);
    the median, p90 and steps/s of each, device ms per step under
    ``torch.profiler`` (2 eager steps; 2 ``safe_step``s; one block of
    ``BLOCK_K``) and the busy share, the graphs' capture seconds and memory,
    and the launches of one block counted from 0."""
    from hipsc_abm_tpu_torch import kernels
    from hipsc_abm_tpu_torch.tools import device_kernels

    label = f"blocks phase d [{dims}D, {path}, {n}]"
    torch.cuda.reset_peak_memory_stats()
    eng, state = timed_engine(dims, n, path)
    for _ in range(3):
        state, _ = eng.safe_step(state)
    for _ in range(3):  # capture; a growth re-captures at the grown config
        before = eng.cfg
        for k in TIMED_KS:
            eng.run_steps(state, k)
        state = eng.repad_state(state, eng.cfg)
        if eng.cfg == before:
            break
    torch.cuda.synchronize()
    eng.safe_step(state)  # the one-step graph at the final config
    graphs = eng.block_graphs()
    if sorted(g["k"] for g in graphs) != sorted((1,) + TIMED_KS):
        raise AssertionError(f"{label}: graphs held {graphs}")

    def run_steps_of(step):
        s, ms = state, []
        for _ in range(BLOCK_TIMED_STEPS):
            t = time.perf_counter()
            s, _ = step(s)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        return ms

    def run_blocks(k):
        s, ms = state, []
        for _ in range(max(1, BLOCK_TIMED_STEPS // k)):
            t = time.perf_counter()
            s, _ = eng.run_steps(s, k)
            ms.append((time.perf_counter() - t) * 1e3 / k)
        return ms

    k1, k2 = TIMED_KS
    order = ["eager", "safe", k1, k2, k2, k1, "safe", "eager"]
    samples = {key: [] for key in order}
    for key in order:
        samples[key] += (run_steps_of(eng.step) if key == "eager" else
                         run_steps_of(eng.safe_step) if key == "safe" else run_blocks(key))
    attempts = eng.block_attempts
    if eng.block_graphs() != graphs:
        raise AssertionError(f"{label}: a timed block re-captured ({eng.block_graphs()})")

    kernels.launch_counts.clear()
    eng.run_steps(state, BLOCK_K)
    block_counts = dict(kernels.launch_counts)
    missing = [k for k in PATH_KERNELS[(dims, path)] if block_counts.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"{label}: kernels {missing} did not run in the block")
    carry = [state]

    def eager_step():
        carry[0], _ = eng.step(carry[0])

    dev = dict(eager=device_kernels(eager_step, 2, warmup=False)[0],
               safe=device_kernels(lambda: eng.safe_step(state), 2, warmup=False)[0],
               block=device_kernels(lambda: eng.run_steps(state, BLOCK_K), 1,
                                    warmup=False)[0] / BLOCK_K)
    names = dict(eager="step", safe="safe_step")
    out = dict(dims=dims, cells=n, contact_path=path, capacity=state.capacity,
               agents=state.num_agents(), peak_mib=torch.cuda.max_memory_allocated() / 2**20,
               graphs=graphs, block_launches=block_counts, attempts=attempts)
    parts = []
    for key in ("eager", "safe", k1, k2):
        ms = np.asarray(samples[key])
        d = dev.get(key, dev["block"])
        row = dict(median_ms=float(np.median(ms)), p90_ms=float(np.percentile(ms, 90)),
                   steps_per_s=1e3 / float(np.mean(ms)), samples=len(ms),
                   device_ms=d if d > 0 else None,
                   busy=d / float(np.median(ms)) if d > 0 else None)
        out[names.get(key, f"block{key}")] = row
        busy = "not measured" if row["busy"] is None else f"{row['busy']:.3f}"
        dms = "not measured" if row["device_ms"] is None else f"{row['device_ms']:.4f} ms"
        parts.append(f"{names.get(key, f'blocks of {key}')}: median "
                     f"{row['median_ms']:.3f} ms, p90 {row['p90_ms']:.3f} ms, "
                     f"{row['steps_per_s']:.2f} steps/s ({len(ms)} samples), device {dms} "
                     f"per step, busy {busy}")
    print(f"{label}: capacity {state.capacity}, {out['agents']} agents at the start; per step, "
          f"in turns {order}: " + "; ".join(parts)
          + f"; graphs (k, capture s, MiB reserved) "
          f"{[(g['k'], round(g['capture_s'], 2), round(g['pool_mib'], 1)) for g in graphs]}; "
          f"peak device memory {out['peak_mib']:.1f} MiB; launches of one block of {BLOCK_K} "
          f"{block_counts}")
    del eng, state, carry
    torch.cuda.empty_cache()
    return out


def block_lifecycle_phase() -> dict:
    """Phase 8 e: lifecycle b (the bench configuration at ``N_MAIN`` +
    ``N_MAIN // 10`` cells, every output but the pickle, 6 steps) with
    ``output_interval: LIFECYCLE_BLOCK_INTERVAL`` against the per-step run:
    the values CSVs of the block boundaries byte-equal, the blocked run
    writes no other step's, and the wall per step of both from their data
    CSVs."""
    tmp = tempfile.mkdtemp(prefix="hipsc_blocks_")
    try:
        walls, runs = {}, {}
        steps = LIFECYCLE_BENCH_GENERAL["end_step"]
        for name, interval in (("per_step", 1), ("blocked", LIFECYCLE_BLOCK_INTERVAL)):
            root = os.path.join(tmp, name)
            write_templates(root, dict(LIFECYCLE_BENCH_GENERAL, output_interval=interval),
                            LIFECYCLE_BENCH_EXPERIMENTAL)
            t = time.perf_counter()
            run_lifecycle(root, ["-n", name, "-m", "0"])
            wall = time.perf_counter() - t
            run_dir = os.path.join(root, "outputs", name)
            with open(os.path.join(run_dir, f"{name}_data.csv")) as f:
                f.readline()
                rows = [list(map(float, line.split(","))) for line in f if line.strip()]
            walls[name] = (wall, [(int(r[0]), r[2]) for r in rows])
            runs[name] = run_dir
        label = f"blocks phase e (lifecycle b, output_interval {LIFECYCLE_BLOCK_INTERVAL})"
        boundaries = list(range(LIFECYCLE_BLOCK_INTERVAL, steps + 1, LIFECYCLE_BLOCK_INTERVAL))
        for step in range(1, steps + 1):
            path = os.path.join(runs["blocked"], "blocked_values", f"blocked_values_{step}.csv")
            if os.path.isfile(path) != (step in boundaries):
                raise AssertionError(f"{label}: values CSV of step {step} "
                                     f"{'written' if os.path.isfile(path) else 'missing'}")
        for step in boundaries:
            with open(os.path.join(runs["per_step"], "per_step_values",
                                   f"per_step_values_{step}.csv"), "rb") as f:
                a = f.read()
            with open(os.path.join(runs["blocked"], "blocked_values",
                                   f"blocked_values_{step}.csv"), "rb") as f:
                b = f.read()
            if a != b:
                raise AssertionError(f"{label}: the values CSVs of step {step} differ")
        per_step = {name: [w / (LIFECYCLE_BLOCK_INTERVAL if name == "blocked" else 1)
                           for _, w in rows] for name, (_, rows) in walls.items()}
        print(f"{label}: values CSVs of steps {boundaries} byte-equal to the per-step run's, no "
              f"other step's written; wall per step (data CSV, ms): per step "
              f"{[round(w * 1e3, 2) for w in per_step['per_step']]}, blocked "
              f"{[round(w * 1e3, 2) for w in per_step['blocked']]}; runs "
              f"{walls['per_step'][0]:.2f} s / {walls['blocked'][0]:.2f} s from start()")
        return dict(wall_s={k: v[0] for k, v in walls.items()}, ms_per_step={
            k: [w * 1e3 for w in v] for k, v in per_step.items()})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def blocks_phase() -> dict:
    """Phase 8 (module docstring): a and b on both contact paths at 2D
    ``N_MAIN`` and 3D ``N_MAIN_3D``, and the 3D span-mask path with the
    optional phases; c; d on the 1k, 2D 100k, 2D 500k and 3D 99k cells, both
    paths; e."""
    out = dict(equal=[], timing=[])
    for dims, n in ((2, N_MAIN), (3, N_MAIN_3D)):
        for path in PATHS:
            out["equal"].append(blocks_equal_phase(dims, n, path))
            torch.cuda.empty_cache()
    out["equal"].append(blocks_equal_phase(3, N_MAIN_3D, "span_mask", optional=True))
    torch.cuda.empty_cache()
    out["growth"] = block_growth_phase()
    torch.cuda.empty_cache()
    for dims, n in ((2, N_SMALL), (2, N_MAIN), (2, N_LARGE), (3, N_MAIN_3D)):
        for path in PATHS:
            out["timing"].append(block_timing(dims, n, path))
    out["lifecycle"] = block_lifecycle_phase()
    return out


def deposit_entry(eng, state, tag: str) -> dict:
    """The fixed-order deposit (``diffusion.scatter_add_cuda``: a stable
    sort and the ``deposit`` kernel) on the step's deposit terms at
    ``state``, against its plain version, ``index_add`` on the CPU, bit for
    bit (twice: two card calls equal too); the wrapper's time beside the
    plain version's and ``index_add_``'s on the card (atomics in no fixed
    order), the kernel's and the sort's own device time, and the bound: the
    terms (int64 index, float32 amount) and the lattice read once, the
    lattice written once."""
    from hipsc_abm_tpu_torch.ops import diffusion
    from hipsc_abm_tpu_torch.tools import device_kernels

    a, alive, diff = state.arrays, state.alive, eng.diff
    secreting = alive & (a["NANOG"] > a["GATA6"])
    amounts = (torch.where(secreting, diff.release_amount, 0.0)
               - torch.where(alive, diff.uptake_amount, 0.0)).to(torch.float32)
    lattice = state.gradients["fgf4_values"]
    idx, contrib = diffusion.deposit_terms(lattice.shape, a["locations"], amounts,
                                           diff.spat_res)
    flat = lattice.reshape(-1).contiguous()
    got = diffusion.scatter_add_cuda(flat, idx, contrib)
    again = diffusion.scatter_add_cuda(flat, idx, contrib)
    want = diffusion.scatter_add_plain(flat.cpu(), idx.cpu(), contrib.cpu())
    err = float((got.cpu() - want).abs().max())
    label = f"kernel deposit [{tag}]"
    if not (torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
            and torch.equal(got.view(torch.int32), again.view(torch.int32))):
        raise AssertionError(f"{label}: not bit-equal to index_add on the CPU")
    ext = torch.cat([flat, flat.new_zeros(1)])
    n, P = idx.numel(), flat.numel()
    ms = cuda_ms(lambda: diffusion.scatter_add_cuda(flat, idx, contrib), 50)
    plain_ms = cuda_ms(lambda: diffusion.scatter_add_plain(flat, idx, contrib), 50)
    library_ms = cuda_ms(lambda: ext.index_add_(0, idx, contrib), 50)
    _, _, own = device_kernels(lambda: diffusion.scatter_add_cuda(flat, idx, contrib),
                               ALONE_LAUNCHES, ("deposit_sorted_kernel", "Sort", "sort"))
    nearby = int((idx < P).sum())
    entry = dict(name="deposit" if tag == "100k" else f"deposit[{tag}]", route="cuda",
                 source="hipsc_abm_tpu_torch/csrc/deposit.cu",
                 replaces="hipsc_abm_tpu/ops/diffusion.py:121 (an XLA scatter-add, not a "
                          "Pallas kernel: glue)",
                 max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                 law="uniform", **bound(8 * n + 4 * n + 2 * 4 * P, n))
    print(f"{label}: lattice {tuple(lattice.shape)}, {n} terms ({nearby} on the lattice), "
          f"bit-equal to index_add on the CPU and between two card calls; wrapper "
          f"{ms:.4f} ms, plain (index_add on the card) {plain_ms:.4f} ms, index_add_ "
          f"{library_ms:.4f} ms, bound {entry['bound_ms']:.4f} ms ({entry['bound_by']}); "
          f"device per call by kernel (profiler, {ALONE_LAUNCHES} calls) "
          + ", ".join(f"{k} {v[0]:.5f} ms / {v[1]:g}" for k, v in own.items()))
    return entry


def deposit_large_phase() -> list:
    """The deposit at the 2D 500k bench colony after one eager step."""
    eng, state = engine_for(2, N_LARGE, "cuda", "id_list")
    state, _ = eng.step(state)
    out = [deposit_entry(eng, state, "500k")]
    del eng, state
    torch.cuda.empty_cache()
    return out


def ensemble_engine(device: str, **flags):
    """Phase 9's configuration: the bench at ``N_ENSEMBLE`` cells (side 2000
    um, 500 GATA6-high, dox at step 5, diffusion on; the JAX package's
    ensemble workload) with the FGF4 field coupled to the pathway and
    degradation off (see ``seed_lattices``)."""
    eng = bench_engine(N_ENSEMBLE, device, **flags)
    eng.diff = dataclasses.replace(eng.diff, field_coupling=True, degradation=0.0)
    return eng


def seeded_lattice(seed: int, shape, max_concentration: float) -> np.ndarray:
    """A lattice uniform in [0, max_concentration) from ``seed``: the bench's
    release alone keeps the field below ``floor((1 + g) * field)``'s first
    boundary, so the coupling would change nothing (as in
    ``coupling_phase``)."""
    return (np.random.default_rng(seed).random(tuple(shape), dtype=np.float32)
            * np.float32(max_concentration))


def seed_lattices(states, seeds, diff):
    """Stacked states with replicate i's lattice ``seeded_lattice(seeds[i])``."""
    g = states.gradients["fgf4_values"]
    lat = np.stack([seeded_lattice(s, g.shape[1:], diff.max_concentration) for s in seeds])
    return states._replace(gradients={"fgf4_values": torch.from_numpy(lat).to(g.device)})


def solo_state(eng, seed: int):
    state = eng.init_state(seed=seed)
    g = state.gradients["fgf4_values"]
    lat = seeded_lattice(seed, g.shape, eng.diff.max_concentration)
    return state._replace(gradients={"fgf4_values": torch.from_numpy(lat).to(g.device)})


def ensemble_against_solo(label: str, ens, seeds, steps: int, make_eng, sweep=None) -> dict:
    """``steps`` ensemble ``safe_step``s from ``init_states(seeds)`` (lattices
    seeded), the launch counts set to 0 just before and read just after,
    and one host read per attempt counted on the last; then each replicate
    against its solo card ``safe_step`` run on the ensemble's initial
    config with its swept values, by ``compare_bits`` (every array by agent
    id, the lattice, key and next_id bit-equal)."""
    from hipsc_abm_tpu_torch import convert, kernels
    from hipsc_abm_tpu_torch.parallel.ensemble import SWEEPABLE, EnsembleEngine

    states = seed_lattices(ens.init_states(seeds), seeds, ens.engine.diff)
    cfg0 = ens.engine.cfg
    cap0 = states.alive.shape[1]
    kernels.launch_counts.clear()
    attempts = 0
    t0 = time.perf_counter()
    for t in range(steps):
        before = ens.graphs()
        if t == steps - 1:
            with SyncCounter() as reads:
                states, infos = ens.safe_step(states)
        else:
            states, infos = ens.safe_step(states)
        attempts += ens.attempts
    captured = ens.graphs() != before  # a capture makes set-up reads
    torch.cuda.synchronize()
    t_ens = time.perf_counter() - t0
    counts = dict(kernels.launch_counts)
    missing = [k for k in PATH_KERNELS[(2, "id_list")] if counts.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"{label}: kernels {missing} did not run ({counts})")
    if not captured and reads.count != ens.attempts:
        raise AssertionError(f"{label}: {reads.count} host reads for {ens.attempts} "
                             "attempt(s) of the last safe_step, expected one per attempt")
    graphs = ens.graphs()
    per_replay = sum(graphs[-1]["launches"].values())
    # each replay runs every replicate's step (11 contact substeps, 3
    # bio-moments passes, one deposit and one FTCS launch); each capture
    # adds one eager warm-up replicate step
    n_steps, rest = divmod(counts["contact_substep"], 11)
    R = len(seeds)
    if (rest or not R * attempts <= n_steps <= (R + 1) * attempts
            or counts["bio_moments"] != 3 * n_steps
            or not counts["ftcs_diffuse"] == counts["deposit"] == n_steps):
        raise AssertionError(f"{label}: launches {counts} for {attempts} attempts of "
                             f"{R} replicates")
    t0 = time.perf_counter()
    for i, seed in enumerate(seeds):
        eng = make_eng()
        over = {k: v[i] for k, v in (sweep or {}).items()}
        eng.xp = dataclasses.replace(eng.xp, **{k: v for k, v in over.items()
                                                 if SWEEPABLE[k] == "xp"})
        eng.bio = dataclasses.replace(eng.bio, **{k: v for k, v in over.items()
                                                   if SWEEPABLE[k] == "bio"})
        eng.cfg = cfg0
        solo = solo_state(eng, seed)
        for _ in range(steps):
            solo, _ = eng.safe_step(solo)
        summary = compare_bits(convert.state_to_numpy(EnsembleEngine.replicate(states, i)),
                               convert.state_to_numpy(solo), f"{label}: replicate {i}")
        del eng, solo
    torch.cuda.synchronize()
    t_solo = time.perf_counter() - t0
    held = [(g["replicates"], round(g["capture_s"], 2), round(g["pool_mib"], 1), per_replay)
            for g in graphs]
    print(f"{label}: {len(seeds)} replicates x {steps} safe_steps ({attempts} attempts, "
          f"{t_ens:.2f} s, capture included) each bit-equal to its solo card run "
          f"({t_solo:.2f} s); last: {summary}; capacity {cap0} -> {states.alive.shape[1]}; "
          f"agents {infos.num_agents.tolist()}; host reads in the last safe_step "
          f"{reads.count}; graph (R, capture s, MiB reserved, launches per replay) {held}; "
          f"launches {counts}")
    return dict(replicates=len(seeds), steps=steps, attempts=attempts,
                capacity=[cap0, states.alive.shape[1]], graphs=graphs,
                launches_per_replay=per_replay, launches=counts, states=states)


def ensemble_card_vs_cpu(steps: int = 2) -> str:
    """Phase 9 c: replicates 0 and 1 (seeds 0, 1) as an ensemble on the CPU
    (plain versions); each step of the card's ensemble from the CPU's state
    held to the CPU's next state by ``compare_colonies`` (the step phase's
    tolerance: integer state equal by agent id, positions within 1e-3 um,
    bond sets differing on at most one row)."""
    from hipsc_abm_tpu_torch.parallel.ensemble import EnsembleEngine
    from hipsc_abm_tpu_torch import convert

    seeds = [0, 1]
    cpu = EnsembleEngine(ensemble_engine("cpu"))
    card = EnsembleEngine(ensemble_engine("cuda"))
    states = seed_lattices(cpu.init_states(seeds), seeds, cpu.engine.diff)
    out = []
    t_cpu = t_card = 0.0
    for t in range(steps):
        card.engine.cfg = cpu.engine.cfg
        on_card = to_device(states, "cuda")
        t0 = time.perf_counter()
        states, _ = cpu.safe_step(states)
        t1 = time.perf_counter()
        on_card, _ = card.safe_step(on_card)
        torch.cuda.synchronize()
        t_cpu, t_card = t_cpu + t1 - t0, t_card + time.perf_counter() - t1
        for i in range(2):
            out.append(compare_colonies(
                convert.state_to_numpy(EnsembleEngine.replicate(states, i)),
                convert.state_to_numpy(EnsembleEngine.replicate(on_card, i)),
                f"ensemble phase c, step {t + 1}, replicate {i}", 1))
    summary = (f"ensemble phase c ({N_ENSEMBLE} cells, R = 2, {steps} card steps each from "
               f"the CPU's state): {'; '.join(out)}; cpu {t_cpu:.2f} s, card {t_card:.2f} s")
    print(summary)
    return summary


def to_device(states, device: str):
    """A (stacked) state with its device tensors moved to ``device``."""
    from hipsc_abm_tpu_torch.engine import _device_tensors, _with_device_tensors

    return _with_device_tensors(states, [t.to(device) for t in _device_tensors(states)])


def ensemble_timing(seeds) -> dict:
    """Phase 9 e: the ensemble's ``safe_step`` against the 16 solo
    ``safe_step``s of the same seeds (each a captured one-step graph), in
    turns (ensemble, solo, solo, ensemble), ``ENSEMBLE_WARMUP`` warm-up and
    ``ENSEMBLE_TIMED`` timed steps each from one set of states, each step
    timed on the host clock to its probe fetch; ms per step and per
    replicate-step, the kernels' summed device time and the replays' device
    span, the busy share (span over wall) of each, the graph's capture s,
    MiB and launches, and one eager ensemble ``step``. No claim."""
    from hipsc_abm_tpu_torch.parallel.ensemble import EnsembleEngine
    from hipsc_abm_tpu_torch.tools import device_kernels

    R = len(seeds)
    ens = EnsembleEngine(ensemble_engine("cuda"))
    states0 = seed_lattices(ens.init_states(seeds), seeds, ens.engine.diff)
    solos = []
    for seed in seeds:
        eng = ensemble_engine("cuda")
        eng.cfg = ens.engine.cfg
        solos.append((eng, solo_state(eng, seed)))
    for _ in range(ENSEMBLE_WARMUP):
        states0, _ = ens.safe_step(states0)
        solos = [(eng, eng.safe_step(s)[0]) for eng, s in solos]
    torch.cuda.synchronize()

    def run_ens():
        s, ms = states0, []
        for _ in range(ENSEMBLE_TIMED):
            t = time.perf_counter()
            s, _ = ens.safe_step(s)
            ms.append((time.perf_counter() - t) * 1e3)
        return ms

    def run_solo():
        ss, ms = [s for _, s in solos], []
        for _ in range(ENSEMBLE_TIMED):
            t = time.perf_counter()
            ss = [eng.safe_step(s)[0] for (eng, _), s in zip(solos, ss)]
            ms.append((time.perf_counter() - t) * 1e3)
        return ms

    graphs = ens.graphs()
    samples = {"ensemble": [], "solo": []}
    order = ["ensemble", "solo", "solo", "ensemble"]
    for key in order:
        samples[key] += run_ens() if key == "ensemble" else run_solo()
    if ens.graphs() != graphs:
        raise AssertionError(f"ensemble phase e: the ensemble re-captured ({ens.graphs()})")
    # device time per step: the kernels' summed time (profiler; it traces
    # concurrent kernels one after another, so it cannot see the overlap)
    # and the span of back-to-back replays (CUDA events), which the busy
    # share divides by the step's wall time
    ens_graph = next(iter(ens._graphs.values())).graph
    solo_graphs = [next(iter(eng._graphs.values())).graph for eng, _ in solos]
    dev = {"ensemble": (device_kernels(lambda: ens.safe_step(states0), 2, warmup=False)[0],
                        cuda_ms(ens_graph.replay, 10)),
           "solo": (device_kernels(lambda: [eng.safe_step(s) for eng, s in solos], 2,
                                   warmup=False)[0],
                    cuda_ms(lambda: [g.replay() for g in solo_graphs], 10))}
    t0 = time.perf_counter()
    ens.step(states0)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1e3
    out = dict(replicates=R, cells=N_ENSEMBLE, eager_step_ms=eager_ms, graphs=graphs,
               solo_graphs=[g for eng, _ in solos[:1] for g in eng.block_graphs()])
    parts = []
    for key in ("ensemble", "solo"):
        ms = np.asarray(samples[key])
        total, span = dev[key]
        med = float(np.median(ms))
        total = total if total > 0 else None  # the profiler saw no device time
        row = dict(median_ms=med, p90_ms=float(np.percentile(ms, 90)),
                   per_replicate_ms=med / R, samples=len(ms), kernel_ms_summed=total,
                   replay_span_ms=span, busy=span / med,
                   concurrency=total / span if total else None)
        out[key] = row
        fmt = lambda v: "not measured" if v is None else f"{v:.4f}"  # noqa: E731
        parts.append(f"{key}: median {med:.3f} ms per step ({med / R:.4f} per replicate-step), "
                     f"p90 {row['p90_ms']:.3f} ms ({len(ms)} samples); kernels "
                     f"{fmt(total)} ms summed (profiler), replays' device span {span:.4f} ms "
                     f"(CUDA events), busy {row['busy']:.3f}, kernels per span "
                     f"{fmt(row['concurrency'])}")
    out["speedup_per_replicate_step"] = out["solo"]["median_ms"] / out["ensemble"]["median_ms"]

    def held(gs):
        return [(round(g["capture_s"], 3), round(g["pool_mib"], 1), sum(g["launches"].values()))
                for g in gs]

    print(f"ensemble phase e ({R} x {N_ENSEMBLE} cells, in turns {order}, {ENSEMBLE_WARMUP} "
          f"warm-up and {ENSEMBLE_TIMED} timed steps each): " + "; ".join(parts)
          + f"; solo / ensemble {out['speedup_per_replicate_step']:.2f}x; ensemble graph "
          f"(capture s, MiB reserved, launches per replay) {held(graphs)}; a solo graph "
          f"{held(out['solo_graphs'])}; one eager ensemble step {eager_ms:.1f} ms")
    del ens, solos
    torch.cuda.empty_cache()
    return out


def ensemble_phase() -> dict:
    """Phase 9, ensembles (see the module docstring)."""
    from hipsc_abm_tpu_torch.parallel.ensemble import EnsembleEngine

    seeds = list(range(ENSEMBLE_R))
    out = {}
    # a: replicates against solo runs
    a = ensemble_against_solo(
        f"ensemble phase a ({ENSEMBLE_R} x {N_ENSEMBLE} cells, field coupling on)",
        EnsembleEngine(ensemble_engine("cuda")), seeds, ENSEMBLE_STEPS,
        lambda: ensemble_engine("cuda"))
    # b: a sweep of adhesion_const and GATA6_prob (the stochastic bumps on,
    # so that GATA6_prob is read)
    base = ensemble_engine("cuda", enable_stochastic=True).bio
    sweep = {"adhesion_const": [float(base.adhesion_const * f)
                                for f in np.linspace(0.8, 1.2, SWEEP_POINTS)],
             "GATA6_prob": [float(base.GATA6_prob * f)
                            for f in np.linspace(0.5, 4.0, SWEEP_POINTS)]}
    b = ensemble_against_solo(
        f"ensemble phase b ({SWEEP_POINTS}-point sweep of adhesion_const and GATA6_prob, "
        "stochastic bumps on)",
        EnsembleEngine(ensemble_engine("cuda", enable_stochastic=True), sweep=sweep),
        [0] * SWEEP_POINTS, ENSEMBLE_STEPS,
        lambda: ensemble_engine("cuda", enable_stochastic=True), sweep)
    first, last = (EnsembleEngine.replicate(b["states"], i) for i in (0, SWEEP_POINTS - 1))
    if torch.equal(first.arrays["locations"], last.arrays["locations"]):
        raise AssertionError("ensemble phase b: the sweep's ends did not part")
    # c: card against CPU
    out["card_vs_cpu"] = ensemble_card_vs_cpu()
    # d: growth inside safe_step
    def tight():
        eng = ensemble_engine("cuda")
        eng.cfg = dataclasses.replace(eng.cfg, capacity=ENSEMBLE_TIGHT_CAPACITY)
        return eng

    d = ensemble_against_solo(
        f"ensemble phase d (growth: capacity {ENSEMBLE_TIGHT_CAPACITY}, 4 replicates)",
        EnsembleEngine(tight()), seeds[:4], ENSEMBLE_STEPS, tight)
    if d["capacity"][1] == d["capacity"][0]:
        raise AssertionError(f"ensemble phase d: the capacity never grew ({d['capacity']})")
    for key, r in (("replicates", a), ("sweep", b), ("growth", d)):
        out[key] = {k: v for k, v in r.items() if k != "states"}
    del a, b, d, first, last
    torch.cuda.empty_cache()
    # e: timing, no claim
    out["timing"] = ensemble_timing(seeds)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from hipsc_abm_tpu_torch import kernels

    t_start = time.perf_counter()
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

    phase_s = {}

    def phase(name, fn, *args, **kwargs):
        t = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            phase_s[name] = round(time.perf_counter() - t, 2)

    def kernels_at(dims, n, optional=False):
        eng, state = engine_for(dims, n, "cuda", "id_list", optional)
        state, _ = eng.safe_step(state)
        out = (general_law_phase if optional else kernel_phase)(eng, state)
        del eng, state
        torch.cuda.empty_cache()
        return out

    results = []
    for dims, n in ((2, N_MAIN), (3, N_MAIN_3D)):
        results += phase(f"kernels {dims}D", kernels_at, dims, n)
    results += phase("deposit 500k", deposit_large_phase)
    results += phase("probes", probe_phase)

    phase("step", step_phase)
    phase("step 3D", step_phase_3d)
    phase("coupling", coupling_phase)
    lifecycle = phase("lifecycle", lifecycle_phase)
    print(json.dumps({"lifecycle": lifecycle}))
    # each main path runs the contact paths in turns (id_list, span_mask,
    # span_mask, id_list) so that neither gains from running second
    runs = phase("main paths", lambda: [
        (dims, n, path, False, main_path(dims, n, path))
        for dims, n in ((2, N_MAIN), (2, N_LARGE), (3, N_MAIN_3D))
        for path in PATHS + PATHS[::-1]])

    # the optional biology phases (growth, stochastic bumps, diff_surround):
    # a, the contact kernels' general law at the main path's shapes; b, one
    # step card vs CPU; c, the lifecycle colony; d, the timed runs, in turns
    for dims, n in ((2, N_MAIN), (3, N_MAIN_3D)):
        results += phase(f"optional a {dims}D", kernels_at, dims, n, optional=True)
    phase("optional b", step_phase, optional=True)
    phase("optional b 3D", step_phase_3d, optional=True)
    phase("optional c", optional_lifecycle_phase)
    runs += phase("optional d", lambda: [
        (dims, n, path, True, main_path(dims, n, path, optional=True))
        for dims, n in ((2, N_MAIN), (3, N_MAIN_3D)) for path in PATHS + PATHS[::-1]])
    print(json.dumps({"paths": [
        dict(dims=dims, cells=n, contact_path=path, optional=opt,
             **{k: v for k, v in r.items() if k != "counts"})
        for dims, n, path, opt, r in runs]}))
    optional_summary(runs)
    # run_steps blocks: one CUDA graph per block, against safe_step
    print(json.dumps({"blocks": phase("blocks", blocks_phase)}))
    # ensembles: R replicate steps as branches of one CUDA graph
    print(json.dumps({"ensemble": phase("ensemble", ensemble_phase)}))
    for r in results:
        if "launches" in r:  # the probes count their own entry points
            r["taken_launches"] = r["launches"]
            continue
        # each kernel's launches come from the first main-path run of its
        # dimensionality (100k in 2D), contact path and law; a general-law
        # entry also takes its in-step time per launch from that run and the
        # uniform law's from the uniform run's
        base = r["name"].split("[")[0]
        dims = 3 if base.endswith("_3d") else 2
        path = "span_mask" if base.startswith(SPAN_MASK_KERNELS) else "id_list"
        large = r["name"].endswith("[500k]")  # the deposit at 500k: the 500k run's
        first = {opt: c for d, n, p, opt, c in reversed(runs)
                 if (d, p) == (dims, path) and (n == N_LARGE) == large}
        general = r["law"] == "general"
        run = first[general]
        r["launches"] = run["counts"][base]
        r["taken_launches"] = taken_launches(base, r["launches"], run["attempts"],
                                             run["rebuilds"], run["substeps"])
        if general:  # per launch that ran its branch, in the profiled steps
            for key, opt in (("in_step_ms", True), ("uniform_in_step_ms", False)):
                ms, n = (first[opt].get("contact_ms_by_kernel") or {}).get(r["kernel"], (0, 0))
                n = taken_launches(base, n, 1, first[opt].get("profiled_rebuilds_per_step")
                                   or 0, first[opt]["substeps"])
                r[key] = ms / n if n else None
    print(f"chip_smoke: seconds per phase {phase_s}")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": results}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
