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
   the compaction; the substep's update (``csrc/update.cu``) and the glue
   FMA (``csrc/fma.cu``) on the 2D rows; the bio moments on the engine's own calls of one more
   step (recorded, so that deaths and births since the build are present),
   every mode on the motility call's inputs, and each engine call's device
   time and device launches, glue included; the seed, the masked substep,
   the compaction and the bio moments also each alone per launch under
   ``torch.profiler``, in turns, with the candidates per live row that
   reach the membership test; FTCS also on fixed halos beside the plan's;
   the deposit's fixed-order sum (``csrc/deposit.cu``, glue) bit-equal to
   ``index_add`` on the CPU at the 100k state and at 500k after one step,
   timed beside ``index_add_`` on the card;
3. probes and draws: each mode of the window probes P1 and P2 against its plain
   version at NBLK = 4096, the kernel's own device time per launch under
   ``torch.profiler`` and its multiple of the bound, then each probe's entry point
   (``hipsc_abm_tpu_torch.tools.dynslice_probe[2].main``) per mode, with the
   launch counts set to 0 just before it; then the draw kernels
   (``csrc/draws.cu``: the pathway's normal, the unit vectors in 2D and 3D)
   over every input, 2^24 ids per stream whose uniforms are every 24-bit
   uniform, bit-equal on the card to their plain versions on the CPU, and
   the step's launches and device ms per step at 1k and 100k cells (phase
   2 holds each draw kernel against its plain version at the main path's
   shapes);
4. step: one ``step`` of the port from the same 20k-cell 2D state on the
   CPU (plain versions) and on the card (kernels), compared by agent id
   bit for bit (positions, bond sets, the lattice), for each contact path,
   and the span-mask step against the id-list step on the card; then 2
   ``safe_step``s of the 100k bench colony on the id-list path on the card
   against the CPU's plain versions, bit for bit after each (``exact
   phase``), on the uniform law and, with the optional phases on and
   seeded radii, on the general law; then the device twin of glibc's
   ``powf`` (the general law's cube root) against the plain mirror at
   every float32 of [2^-25, 2^-13) (``powf phase``); then 3
   ``safe_step``s of the 3,300-cell spheroid (the 3D example's
   configuration) on the CPU and on the card, both paths;
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
   their plain versions at the 2D 100k and 3D 99k states, bit for bit
   (forces, degrees, partner lists and mask words; a pair decided apart
   would be reported with its distance from its own break distance), each
   kernel alone per launch beside the uniform law on the same rows (in
   turns) and the ratio, and the candidates per live row that reach the
   pair law past the general law's cut (``membership_counts``); (b) phase
   4's one step (20k, 2D) and 3 spheroid ``safe_step``s with the flags,
   bit for bit; (c) ``optional_lifecycle_phase``: the lifecycle colony, 8
   card steps from the CPU's state on each contact path, bit for bit, and
   mode 0 + 1 against mode 0; (d) the 2D 100k and 3D 99k main
   paths with the flags, in turns, beside phase 5's, with each contact
   kernel's device ms per step on both laws (``optional_summary``).
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
10. calibration (``calibration_phase``, ``calibrate.Calibrator``): (a) the
   JAX package's calibration showcase (1,000 + 100 cells in a 300 um box,
   R = 16 replicates, horizon 10, adhesion and motility from 3x the
   reference's constants, the replicate-mean Rg and contact delta courses
   of ``tools/calibration_target.json``): ``prepare``, one gradient
   evaluation on the plain path (loss, gradient, seconds, peak memory),
   again with ``remat_substeps`` on, a central finite difference through
   the kernels, and at horizon 2 over 2 replicates the card against the
   CPU with the share of the evaluation spent in the plain contact and
   bio-moments functions; recorded, not held, as that rollout is chaotic in
   float32; (b) on ``tests/test_calibrate.py``'s colony (settled by one
   step) the held checks: the gradient of the soft contact count at horizon
   2 within 15% of the finite difference through the kernels (B4, B6), the
   card's loss and gradient against the CPU's (2 replicates, rtol 1e-5 and
   1e-3), and the dense and windowed paths' Rg after 4 steps within 2e-4 um;
   (c) 2 generations of ``fit_es`` (population 16, sigma 0.3) at R = 4 on
   ``adhesion_const``, dense then windowed: per generation the capture and
   replay seconds, branches and peak memory, the launches of B4 (both) and
   B6 (windowed only), one candidate's population loss bit-equal to its
   solo rollout; (d) the port's ``examples/calibrate.py`` at its defaults,
   both fits lowering their loss.
11. the domain-decomposed engine (``domain_phase``,
   ``parallel.domain_engine.DomainHipscEngine``, every tile on the one
   card, span-mask path unless named): (a) the 2D 100k bench colony in 4
   stripes, 5 ``safe_step``s against the single engine on the card from
   one initial colony: integer fields, bond sets, positions and radii
   bit-equal by agent id, the lattice within 1e-5; (b) 20k cells in 2 x 2
   tiles, one ``step`` on the card against the CPU from the same
   decomposed state (integers equal, positions within 1e-3 um, the lattice
   bit-equal); (c) the 3D 99k spheroid in 2 stripes, 3 ``safe_step``s as
   in a; (d) the id-list path from b's state against the span-mask path on
   the card, with B6's launches counted; (e) the 2D 500k colony in 2 x 2
   tiles and on the single engine, each warmed up until a ``safe_step``
   grows nothing, one more domain step whose kernel calls (tile-local
   capacities and run bounds) are recorded and held against the plain
   versions (the ``[tile]`` entries), then ``safe_step`` median and p90
   over 10 steps each, in turns (domain, single, domain, single), peak
   memory per engine, the domain's launches per step attempt counted from
   0 over its turns (every kernel of the path, exactly); (f) the shipped
   templates' values with ``domain_tiles: [2, 2]`` through
   ``CellSimulation`` on the card (6 steps, no images) against the same
   run on one engine, bit-equal by agent id.
12. the domain engine over processes (``multiprocess_phase``,
   ``tools.multihost_domain``: ``MP_WORLD`` ranks, one process each, on
   the one card over gloo, which stages every cross-rank message through
   pinned host buffers): (a) the 2D 500k bench colony in 2 x 2 tiles (2 per
   rank), span-mask path, the JAX payload's sequence: ``MP_STEPS``
   ``safe_step``s, each bit-equal by agent id on rank 0 to the single engine
   on the card and to one controller over the same tiles (the lattice
   bit-equal to one controller's), the sharded checkpoint and value CSVs
   (merged: one row per agent), a resume from the shards stepped beside the
   original (bit-equal, lattice included), growth from undersized halo,
   migration and drift capacities, ``rebalance`` and a step, then
   ``MP_TIMED`` timed ``safe_step``s: per rank median and p90 ms, bytes
   copied between its tiles and received from the other rank, bytes staged
   through the host, collectives and peak memory per step, and the launches
   of each kernel over both ranks (every kernel of the path must have
   launched); (b) the same at 20k on the id-list path (B6); (c) on the
   card, ``EnsembleEngine.shard_states`` (``ENSEMBLE_R`` x 5k replicates in
   ``SHARD_GROUPS`` groups) against the unsharded ensemble and solo runs,
   ``parallel.mesh.ShardedHipscEngine`` (``MESH_CHUNKS`` chunks, 2D 100k)
   against the single engine, and ``parallel.domain.domain_forces`` against
   the all-pairs oracle and the CPU; (d) NCCL: more ranks than cards
   raises before NCCL starts, and with two cards (a) runs over NCCL, else
   ``nccl not run``.
13. the examples on the card (``examples_phase``): ``chemotaxis`` 3 steps
   against the CPU (positions within ``CHEMO_LOC_ATOL``, the field within
   ``CHEMO_FIELD_ATOL``; FTCS and the deposit launched once per step),
   ``spheroid_3d`` at 3,300 cells for 3 steps with both PNGs,
   ``minimal_abm`` and ``run.py`` mode 0 on the shipped templates for 2
   steps each, and ``device_trace`` around one ``safe_step`` of a warmed
   engine, whose trace must name a contact kernel.

The last lines are the seconds per phase, one JSON object with each
kernel's numbers (``law``: the contact law of the run its inputs and
launches come from, ``"general"`` for the entries named ``[general]``;
``domain_launches``: its launches on the domain path, phase 11 e in 2D,
c in 3D, d for B6; ``multiprocess_launches``: its launches on the
multi-process route over both ranks, phase 12 a, b for B6; the ``[tile]`` entries' ``launches`` are those;
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
# what compare_bits holds bit-equal by agent id, beside the bond sets: the
# integer fields, positions and radii (not the last substep's forces)
STATE_FIELDS = ("FGF4", "FGFR", "ERK", "GATA6", "NANOG", "states", "death_counters",
                "diff_counters", "div_counters", "fds_counters", "locations", "radii")
PATHS = ("id_list", "span_mask")
# the kernels each contact path launches in 2D and in 3D (counted from its
# own main-path run)
PATH_KERNELS = {
    (2, "id_list"): ("contact_substep", "bio_moments", "ftcs_diffuse", "deposit", "normal",
                     "unit_vectors", "update", "fma"),
    (2, "span_mask"): ("contact_seed", "contact_masked", "mask_compact", "bio_moments",
                       "ftcs_diffuse", "deposit", "normal", "unit_vectors", "update", "fma"),
    (3, "id_list"): ("contact_substep_3d", "bio_moments_3d", "normal", "unit_vectors_3d",
                     "update", "fma"),
    (3, "span_mask"): ("contact_seed_3d", "contact_masked_3d", "mask_compact_3d",
                       "bio_moments_3d", "normal", "unit_vectors_3d", "update", "fma"),
}
SPAN_MASK_KERNELS = ("contact_seed", "contact_masked", "mask_compact")
# the card's published peaks (H100 SXM: HBM3 rate, float32 outside the
# tensor cores), for bound_ms
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# float64 outside the tensor cores (H100 SXM data sheet), for the draw
# kernels' glibc sinf/cosf mirror
PEAK_F64_PER_S = 34e12
# the draw kernels (csrc/draws.cu): per id, the float32 and float64
# operations (each multiply, add, fused multiply-add, division or square
# root one): the hash's uniforms are integer work; log 23 float32, each
# sinf/cosf ~16 float64 and a conversion; the normal's radius, angle and
# product 4 float32; a unit vector's angles and products 2-4 float32
DRAW_OPS = {"normal": (28, 17), "unit_vectors": (2, 34), "unit_vectors_3d": (5, 68)}
# the exhaustive draw check: ids per chunk, and the (draw, stream offset)
# cases whose ids cover every 24-bit uniform of that stream
DRAW_CHUNK = 1 << 22
DRAW_CASES = (("normal", 0), ("normal", 17), ("unit_vectors", 0), ("unit_vectors_3d", 0),
              ("unit_vectors_3d", 29))
# the colonies whose step launches and device time the draws phase prints
# (the 1k bench cell of phase 8 and the 2D main path)
DRAW_STEP_CELLS = (1_000, 100_000)
# float32 operations the contact kernels spend per candidate (distance) and
# per kept pair (pair law, normal, force sum)
DIST_FLOPS = 8
PAIR_FLOPS = 20
# and per kept pair on the general (per-pair radius) law: those 20, the
# reduced radius (a sum, a max, two products, a division), the cube root by
# glibc's powf in float64 (csrc/glibc_powf.cuh: nine FMAs and eight other
# float64 operations, 26 floating-point operations counted at twice their
# float32 cost, the card's float64 rate being half its float32 rate), the
# scale's product, the overlap's division and the clamps (2)
GENERAL_PAIR_FLOPS = 81
# the powf phase checks the CPU's mirror at every this-many-th input
POWF_CPU_STRIDE = 16
# the optional phases the reference ships disabled
OPTIONAL = dict(enable_growth=True, enable_stochastic=True, enable_diff_surround=True)
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
# phase 10, calibration. The JAX package's calibration showcase
# (tools/calibration_showcase.py:216-266: 1,000 + 100 cells in a 300 um box,
# dox at step 5, adhesion and motility fitted from 3x the reference's
# constants against the replicate-mean Rg and contact delta courses of
# tools/calibration_target.json, read as data), R replicates (seeds 0..R-1)
# over the target's 10 steps. Its first step from random placement is
# chaotic in float32 (in the JAX package one ulp at every cell moves cells by
# ~6 um), so the checks that need a well-conditioned rollout run on
# tests/test_calibrate.py's colony (150 + 15 cells in a 300 um box, settled
# by one safe_step): the gradient against a finite difference of the soft
# contact count at horizon 2, the card against the CPU over CAL_CPU_R
# replicates, and the dense and windowed paths over CAL_DENSE_STEPS steps.
# The finite difference's step is 1e-3 of each parameter (1e-3 in its log);
# the ES runs take CAL_ES_R replicates, a population, sigma and generations.
CAL_TARGET = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                          "calibration_target.json")
CAL_TRUE = {"adhesion_const": 0.000107, "motility_force": 2e-9}
CAL_START = 3.0
CAL_R = 16
CAL_FD_H = 1e-3
CAL_CPU_R, CAL_CHECK_HORIZON, CAL_DENSE_STEPS = 2, 2, 4
CAL_ES_R, CAL_ES_POP, CAL_ES_SIGMA, CAL_ES_GENS = 4, 16, 0.3, 2
# the gradient's agreement with the finite difference (the JAX test's
# criterion), and the card against the CPU (tests/test_torch_cuda.py's)
CAL_FD_RTOL = 0.15
CAL_CPU_LOSS_RTOL, CAL_CPU_GRAD_RTOL = 1e-5, 1e-3
# the dense and windowed paths' replicate-mean Rg (um):
# tests/test_engine.py::test_dense_pairs_matches_windowed's position
# tolerance (Rg is a mean of distances: it moves no more than they do)
CAL_DENSE_ATOL = 2e-4
# phase 11, the domain-decomposed engine: the stripes and tile grid of its
# checks, the steps of the checks against the single engine (5 in 2D, 3 in
# 3D), the 500k cell's timed safe_steps per engine and turn (two turns
# each, in the order domain, single, domain, single), the most warm-up
# steps before one that grows nothing, and the lifecycle's cut (the shipped
# templates' values, 6 steps, no images)
DOMAIN_STRIPES = 4
DOMAIN_TILES = (2, 2)
DOMAIN_STEPS = 5
DOMAIN_STEPS_3D = 3
DOMAIN_TIMED = 5
DOMAIN_WARMUP = 8
DOMAIN_LIFECYCLE_STEPS = 6
DOMAIN_LATTICE_ATOL = 1e-5

# phase 12: the domain engine over processes (two ranks share the one card
# over gloo), the shard_states / mesh / domain_forces cross-checks
MP_WORLD = 2
MP_STEPS = 3
MP_TIMED = 5
MP_DEADLINE_S = 300.0
SHARD_GROUPS = 2
SHARD_STEPS = 2
MESH_CHUNKS = 4
MESH_STEPS = 3
DOMAIN_FORCES_RTOL = 1e-4
# phase 13: the examples
CHEMO_STEPS = 3
CHEMO_LOC_ATOL = 1e-3
CHEMO_FIELD_ATOL = 1e-5
EXAMPLE_STEPS = 2


def bench_engine(n_cells: int, device: str, contact_path: str = "id_list", **flags):
    """The bench colony (``colonies.bench_params``: a 2D box at reference
    colony density, n/10 GATA6-high cells, dox at step 5, FGF4 secretion
    and FTCS diffusion on); ``flags`` are the engine's optional-phase
    switches (``OPTIONAL``)."""
    from hipsc_abm_tpu_torch.colonies import bench_params
    from hipsc_abm_tpu_torch.engine import HipscEngine

    gen, xp, diff = bench_params(n_cells)
    return HipscEngine(gen, xp, diff=diff, enable_diffusion=True, device=device,
                       contact_path=contact_path, **flags)


def spheroid_engine(n_cells: int, device: str, contact_path: str = "id_list", **flags):
    """The 3D spheroid example's configuration at ``n_cells``
    (``colonies.spheroid``: 10:1 with GATA6-high cells, dox at step 2,
    guye_move off, box and seeding ball scaled to the cells). Returns the
    engine and the ball (drawn from ``SEED``)."""
    from hipsc_abm_tpu_torch.colonies import spheroid
    from hipsc_abm_tpu_torch.engine import HipscEngine

    gen, xp, ball = spheroid(n_cells, SEED)
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


def check_probes(name, launch, bounds, degree) -> None:
    """The substep probes a contact kernel reduces (``probes=``: the widest
    run, the widest row, the largest degree) against the PyTorch glue's on
    the same bounds and degrees (``engine._window_widths``, ``max``)."""
    from hipsc_abm_tpu_torch.engine import _window_widths

    probes = torch.zeros(3, dtype=torch.int32, device=bounds.device)
    launch(probes)
    run, cands = _window_widths(bounds)
    want = [int(run), int(cands), int(degree.max())]
    if probes.tolist() != want:
        raise AssertionError(f"{name}: probes {probes.tolist()} against the glue's {want}")
    print(f"kernel {name} probes: widest run, widest row, max degree {want}, equal to the "
          f"glue's")


def check_packed_update(eng, args, force) -> None:
    """The update kernel's packed rows (``xyzr=``) against ``pack_physics``
    of its new locations, bit for bit on every row, dead rows included."""
    from hipsc_abm_tpu_torch.engine import drift_threshold
    from hipsc_abm_tpu_torch.ops import integrate
    from hipsc_abm_tpu_torch.ops.jkr import pack_physics

    loc, rad, alive = args[0][:, :3].contiguous(), args[0][:, 3].contiguous(), args[2]
    size = torch.tensor(eng.gen.size, dtype=torch.float32, device=loc.device)
    xyzr = torch.full_like(args[0], float("nan"))
    new, *_ = integrate.update_cuda(
        loc, rad, force, torch.zeros_like(force), alive, loc, size, stokes=eng.bio.stokes,
        dt=float(eng.bio.move_dt), folded=False,
        threshold=drift_threshold(eng.cfg.verlet_skin),
        scratch=integrate.update_scratch(1, loc.device)[0], xyzr=xyzr)
    want = pack_physics(new, rad)
    if not torch.equal(xyzr.view(torch.int32), want.view(torch.int32)):
        raise AssertionError(f"update: packed rows differ on "
                             f"{int((xyzr != want).any(dim=1).sum())} rows")
    print(f"kernel update packed rows: {xyzr.shape[0]} rows ({int(alive.sum())} live) "
          f"bit-equal to pack_physics of the new locations")


def check_contact(name, f_k, d_k, f_p, d_p) -> tuple:
    """Forces and degrees bit-equal (the kernel and the plain version run
    the same float32 operations in the same order); returns (max |F|, max
    abs error)."""
    f_scale = float(f_p.abs().max())
    f_err = float((f_k - f_p).abs().max())
    if not torch.equal(f_k, f_p):
        rows = int((f_k != f_p).any(dim=1).sum())
        raise AssertionError(f"{name}: forces differ on {rows} rows (max {f_err:.3e} N)")
    if not torch.equal(d_k, d_p):
        raise AssertionError(f"{name}: degrees differ")
    return f_scale, f_err


def by_id(d: dict) -> dict:
    """Alive rows of a numpy state dict, sorted by agent id, each agent's
    bond set as a sorted row (``colonies.by_id``)."""
    from hipsc_abm_tpu_torch import colonies

    return colonies.by_id(d)


def bond_rows_apart(x: np.ndarray, y: np.ndarray) -> int:
    """Agents whose bond sets differ between two ``by_id`` bond rows."""
    from hipsc_abm_tpu_torch import colonies

    return colonies.bond_rows_apart(x, y)


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
    check_probes(kernels.counted_name("contact_substep", n_runs),
                 lambda p: contact.contact_substep_cuda(*args, **law, probes=p), args[3], d_p)
    check_packed_update(eng, args, f_p)
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
    check_probes(kernels.counted_name("contact_seed", n_runs),
                 lambda p: span_mask.contact_seed_cuda(*args, **law, probes=p), args[3], d_p)
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
    check_probes(kernels.counted_name("contact_masked", n_runs),
                 lambda p: span_mask.contact_masked_cuda(*margs, seed_mask.clone(), **law,
                                                         probes=p), margs[3], d_p)
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

    # the substep's update (glue: the JAX engine's update is XLA's), on the
    # B6 substep's outputs: the drift from the positions a rebuild would
    # hold (the current ones, shifted by a 0.75 um stride), in 2D only (one
    # kernel for both)
    if n_runs == 3:
        results.append(update_entry(eng, state, args, f_p, o))
        results.append(fma_entry(args))

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
        if not torch.equal(b_k, b_p):
            lanes = (b_k != b_p).any(dim=0).nonzero().flatten().tolist()
            raise AssertionError(f"bio_moments[{mode}]: lanes {lanes} differ")
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
    results += draw_entries(state, n_runs)
    for r in results:
        print(f"  {r['name']} ({label}): kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    kernels.launch_counts.clear()
    return results


def update_entry(eng, state, args, force, order) -> dict:
    """The update kernel (``csrc/update.cu``) against ``update_plain`` on
    the sorted rows of the kernel phase: new locations, the largest squared
    move and drift and the stale flag bit-equal, on the first substep's
    folded form and a later substep's. Bound: ~65 bytes per row (bytes)."""
    from hipsc_abm_tpu_torch.engine import drift_threshold
    from hipsc_abm_tpu_torch.ops import integrate

    bio, cfg = eng.bio, eng.cfg
    loc, rad, alive = args[0][:, :3].contiguous(), args[0][:, 3].contiguous(), args[2]
    mot = state.arrays["motility_forces"][order].contiguous()
    ref = (loc + 0.75).contiguous()
    size = torch.tensor(eng.gen.size, dtype=torch.float32, device=loc.device)
    kw = dict(stokes=bio.stokes, dt=float(bio.move_dt),
              threshold=drift_threshold(cfg.verlet_skin))
    err = 0.0
    for folded in (True, False):
        scratch = integrate.update_scratch(1, loc.device)[0]
        got = integrate.update_cuda(loc, rad, force, mot, alive, ref, size, folded=folded,
                                    scratch=scratch, **kw)
        want = integrate.update_plain(loc, rad, force, mot, alive, ref, size, folded=folded,
                                      **kw)
        torch.cuda.synchronize()
        for name, g, w in zip(("locations", "move2", "drift2", "stale"), got, want):
            if not torch.equal(g, w):
                raise AssertionError(f"update (folded={folded}): {name} differs "
                                     f"({g.flatten()[:4].tolist()} / {w.flatten()[:4].tolist()})")
        err = max(err, float((got[0] - want[0]).abs().max()))
    scratch = integrate.update_scratch(1, loc.device)[0]
    C = loc.shape[0]
    entry = dict(
        name="update", route="cuda", source="hipsc_abm_tpu_torch/csrc/update.cu",
        replaces="none (glue: XLA fuses the update into the JAX engine's step)",
        max_abs_err=err,
        ms=cuda_ms(lambda: integrate.update_cuda(loc, rad, force, mot, alive, ref, size,
                                                 folded=False, scratch=scratch, **kw), 50),
        plain_ms=cuda_ms(lambda: integrate.update_plain(loc, rad, force, mot, alive, ref, size,
                                                        folded=False, **kw), 10),
        # per row: location, radius, two forces, liveness, reference in;
        # the new location out; ~20 operations
        **bound(C * (12 + 4 + 24 + 1 + 12 + 12), 20.0 * C),
        library_ms=None, law="uniform")
    print(f"kernel update: rows={C} stale={bool(want[3])} move2={float(want[1]):.6e} "
          f"drift2={float(want[2]):.6e}, locations, maxima and flag bit-equal on both forms")
    return entry


def fma_entry(args) -> dict:
    """The glue FMA (``csrc/fma.cu``) against ``rng.fma_f32`` on the rows'
    coordinates (the shape of the step's calls: the motility norm's, the
    daughters' displacement), bit for bit. Bound: 16 bytes per element."""
    from hipsc_abm_tpu_torch.ops import rng, xla_f32

    x = args[0][:, :3].contiguous()
    y = torch.flip(x, dims=(0,)).contiguous()
    got = xla_f32.fma_cuda(x, y, x)
    want = rng.fma_f32(x, y, x)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"fma: {int((got != want).sum())} elements differ")
    n = x.numel()
    print(f"kernel fma: {n} elements bit-equal to rng.fma_f32")
    return dict(name="fma", route="cuda", source="hipsc_abm_tpu_torch/csrc/fma.cu",
                replaces="none (glue: XLA:CPU's fused multiply-adds in the step)",
                max_abs_err=0.0, ms=cuda_ms(lambda: xla_f32.fma_cuda(x, y, x), 50),
                plain_ms=cuda_ms(lambda: rng.fma_f32(x, y, x), 10),
                **bound(16 * n, 2.0 * n), library_ms=None, law="uniform")


def step_exact_phase(steps: int = 2, optional: bool = False) -> dict:
    """The 2D bench colony at ``N_MAIN`` cells on the id-list path: ``steps``
    ``safe_step``s on the card and on the CPU (the plain versions, as
    ``hipsc_step(plain=True)`` runs them) from the same state, compared by
    agent id after every step, bit for bit; both sides' seconds.
    ``optional``: with the optional phases on and seeded radii, the general
    pair law."""
    from hipsc_abm_tpu_torch import convert

    cpu, s0 = engine_for(2, N_MAIN, "cpu", "id_list", optional)
    gpu = bench_engine(N_MAIN, "cuda", **(OPTIONAL if optional else {}))
    gpu.cfg = cpu.cfg
    assert (cpu.cfg.uniform_radius is None) == optional
    law = "general" if optional else "uniform"
    d0 = convert.state_to_numpy(s0)
    s_cpu, s_gpu = convert.state_from_numpy(d0, "cpu"), convert.state_from_numpy(d0, "cuda")
    t_cpu = t_gpu = 0.0
    out = []
    for k in range(1, steps + 1):
        t0 = time.perf_counter()
        s_cpu, _ = cpu.safe_step(s_cpu)
        t1 = time.perf_counter()
        s_gpu, _ = gpu.safe_step(s_gpu)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        t_cpu, t_gpu = t_cpu + t1 - t0, t_gpu + t2 - t1
        summary = compare_colonies(convert.state_to_numpy(s_cpu), convert.state_to_numpy(s_gpu),
                                   f"exact phase [{law}] step {k} card vs CPU", 0)
        print(f"exact phase [2D, {N_MAIN}, id_list, {law} law] step {k} card vs CPU: {summary}; "
              f"cpu {t1 - t0:.2f} s, card {t2 - t1:.2f} s")
        out.append(summary)
    del cpu, gpu, s_cpu, s_gpu
    torch.cuda.empty_cache()
    return dict(cells=N_MAIN, steps=steps, law=law, cpu_s=round(t_cpu, 2),
                card_s=round(t_gpu, 2))


def powf_phase() -> dict:
    """The device twin of glibc's ``powf`` (``csrc/glibc_powf.cuh``, which
    the contact kernels' general law inlines; ``xla_f32.powf_cuda``)
    against the plain mirror (``xla_f32.powf``) at every float32 in
    [2^-25, 2^-13), the reduced radii of equal radii from about 0.06 to 240
    um, at y = float32(1/3): the mirror on the card over every input and on
    the CPU over every ``POWF_CPU_STRIDE``-th, bit for bit, and both
    devices' seconds."""
    from hipsc_abm_tpu_torch.ops import xla_f32

    third = float(np.float32(1.0 / 3.0))
    n = card_s = mirror_s = cpu_s = 0.0
    cpu_n = 0
    for e in range(-25, -13):
        bits = torch.arange(1 << 23, dtype=torch.int64, device="cuda") + ((e + 127) << 23)
        x = bits.to(torch.int32).view(torch.float32)
        t0 = time.perf_counter()
        got = xla_f32.powf_cuda(x, third)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        want = xla_f32._powf(x, third)  # the mirror's float64 operations, on the card
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if not torch.equal(got, want):
            bad = torch.nonzero(got != want).squeeze(1)[:8]
            raise AssertionError(f"powf phase: binade 2^{e}: {int((got != want).sum())} inputs "
                                 f"apart, e.g. x={x[bad].tolist()} card {got[bad].tolist()} "
                                 f"mirror {want[bad].tolist()}")
        sub = x[::POWF_CPU_STRIDE].cpu()
        t3 = time.perf_counter()
        cpu_want = xla_f32.powf(sub, third)
        t4 = time.perf_counter()
        if not torch.equal(got[::POWF_CPU_STRIDE].cpu(), cpu_want):
            raise AssertionError(f"powf phase: binade 2^{e}: the CPU's mirror differs")
        n += x.numel()
        cpu_n += sub.numel()
        card_s, mirror_s, cpu_s = card_s + t1 - t0, mirror_s + t2 - t1, cpu_s + t4 - t3
    out = dict(inputs=int(n), cpu_inputs=cpu_n, max_abs_err=0.0, card_s=round(card_s, 3),
               card_mirror_s=round(mirror_s, 3), cpu_mirror_s=round(cpu_s, 3))
    print(f"powf phase: device twin equal to the plain mirror at all {int(n)} float32 inputs "
          f"in [2^-25, 2^-13) (mirror on the card), and to the CPU's mirror at {cpu_n} of "
          f"them; twin {card_s:.3f} s, mirror on the card {mirror_s:.3f} s, on the CPU "
          f"{cpu_s:.3f} s")
    return out


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
    """A general-law kernel against its plain version, bit for bit: forces,
    degrees and the keep sets of every row (``same_rows``: where the partner
    lists or mask words agree). A failure reports each pair decided apart
    with its distance from its own break distance; ``keep(rows)`` gives both
    sides' keep matrices. Returns the numbers."""
    same_rows = same_rows & torch.eq(d_k, d_p) & torch.eq(f_k, f_p).all(dim=1)
    f_scale = float(f_p.abs().max())
    f_err = float((f_k - f_p).abs().max())
    rows = torch.nonzero(~same_rows).squeeze(1)
    if rows.numel():
        apart = pairs_apart(args, *keep(rows), rows, bio)
        raise AssertionError(f"{name}: {rows.numel()} rows differ (max|dF| {f_err:.3e} N), "
                             f"pairs decided apart {apart[:8]}")
    return dict(max_abs_err=f_err, f_scale=f_scale, rows_apart=0, pairs_apart=[])


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

    def alone_ms(fn, kname):
        # the profiler now and then sees no launch of the kernel in a
        # window (kernel_ms gives nan): take that sample again
        for _ in range(3):
            t = kernel_ms(fn, kname, ALONE_LAUNCHES)
            if t == t:
                break
        return round(t, 5)

    def entry(base, source, replaces, fn_k, fn_p, fn_u, kname, bytes_moved, kept, check):
        alone = {"general": [], "uniform": []}
        for key in ("general", "uniform", "uniform", "general"):
            alone[key].append(alone_ms(fn_k if key == "general" else fn_u, kname))
        name = kernels.counted_name(base, n_runs) + "[general]"
        apart = check.pop("pairs_apart")
        means = [np.mean([t for t in alone[k] if t == t] or [np.nan]) for k in alone]
        ratio = float(means[0] / means[1]) if np.isfinite(means).all() else None
        n_live = max(1, int(live.sum()))
        results.append(dict(
            name=name, route="cuda", source=f"hipsc_abm_tpu_torch/csrc/{source}",
            replaces=replaces, law="general", max_abs_err=check["max_abs_err"],
            ms=cuda_ms(fn_k, 50), plain_ms=cuda_ms(fn_p, 10),
            **bound(bytes_moved, DIST_FLOPS * candidates + GENERAL_PAIR_FLOPS * kept),
            library_ms=None, alone_ms=alone["general"], alone_uniform_ms=alone["uniform"],
            alone_ratio=ratio, law_per_row=walk["law"] / n_live, kernel=kname,
            rows_apart=check["rows_apart"], pairs_apart=len(apart)))
        r = results[-1]
        print(f"{label} kernel {name}: rows={C} K={K} radii [{float(radii.min()):.4f}, "
              f"{float(radii.max()):.4f}] um, candidates per live row "
              f"{candidates / n_live:.2f}, of which reach the pair law (B6 and the seed: "
              f"not dropped by the cut, self excluded) {walk['law'] / n_live:.3f} and the "
              f"membership test {walk['membership'] / n_live:.3f}; kept pairs {kept}; "
              f"max|F|={check['f_scale']:.6e} N max_abs_err={check['max_abs_err']:.3e} N, "
              f"rows with keep sets apart {check['rows_apart']}, pairs decided apart "
              f"{len(apart)}; kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}); alone "
              f"per launch (profiler, {ALONE_LAUNCHES} launches, in turns) general "
              f"{alone['general']} uniform {alone['uniform']} ms, general / uniform "
              f"{'not measured' if ratio is None else f'{ratio:.3f}'}")

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
    ds_args, ds_kw = calls[2]
    ds_ms = cuda_ms(lambda: bio_moments.bio_moments_cuda(*ds_args, **ds_kw), 50)
    ds_plain_ms = cuda_ms(lambda: bio_moments.bio_moments_plain(*ds_args, **ds_kw), 5)
    print(f"{label} kernel {kernels.counted_name('bio_moments', n_runs)} with diff_surround: "
          f"{len(calls)} calls per step ({', '.join(kw['mode'] for _, kw in calls)}), bound "
          f"per call {[round(b, 5) for b in bounds_ms]} ms, the diff_surround call's "
          f"{bounds_ms[2]:.5f} ms (card {ds_ms:.5f} ms, plain {ds_plain_ms:.5f} ms per call), "
          f"the step's four {sum(bounds_ms):.5f} ms")
    kernels.launch_counts.clear()
    return results


def draw_call(name: str, key, ids, cuda: bool):
    """One call of the draw kernel ``name`` (``csrc/draws.cu``), or of its
    plain version: the pathway's normal, division's unit vectors (2D, 3D)."""
    from hipsc_abm_tpu_torch.ops import rng

    if name == "normal":
        return (rng.normal if cuda else rng.normal_plain)(key, ids, 0)
    two_d = name == "unit_vectors"
    return (rng.unit_vectors if cuda else rng.unit_vectors_plain)(key, ids, two_d, 1)


def draw_bound(name: str, n: int) -> dict:
    """The draw kernel's least time for ``n`` ids: each id read once and each
    float written once (the key's 16 bytes besides), or its float32 and
    float64 operations over the card's rates for them."""
    f32, f64 = DRAW_OPS[name]
    t_bytes = (16 + n * (4 + (4 if name == "normal" else 12))) / PEAK_BYTES_PER_S
    t_ops = n * (f32 / PEAK_F32_PER_S + f64 / PEAK_F64_PER_S)
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def draw_entries(state, n_runs: int) -> list:
    """The draw kernels at the main path's shapes (the state's (C,) id
    column, a step key on the card) against their plain versions on the
    card, bit for bit; the normal in 2D only (it has one form)."""
    from hipsc_abm_tpu_torch.ops import rng

    ids = state.arrays["ids"]
    key = torch.stack(rng.split(rng.prng_key(SEED).to(ids.device), 6))[2]
    names = ("normal", "unit_vectors") if n_runs == 3 else ("unit_vectors_3d",)
    out = []
    for name in names:
        got, want = draw_call(name, key, ids, True), draw_call(name, key, ids, False)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"kernel {name}: not bit-equal to its plain version")
        out.append(dict(
            name=name, route="cuda", source="hipsc_abm_tpu_torch/csrc/draws.cu",
            replaces=("hipsc_abm_tpu/ops/rng.py:" + ("66" if name == "normal" else "74")
                      + " (XLA ops, not a Pallas kernel: glue)"),
            max_abs_err=float((got - want).abs().max()),
            ms=cuda_ms(lambda: draw_call(name, key, ids, True), 50),
            plain_ms=cuda_ms(lambda: draw_call(name, key, ids, False), 10),
            library_ms=None, law="uniform", **draw_bound(name, ids.numel())))
    return out


def draws_phase() -> dict:
    """The draw kernels over every input: for each case of ``DRAW_CASES``,
    2^24 ids whose uniforms in one stream of the draw are every 24-bit
    uniform (``rng.hash_preimage``), the kernel on the card against its
    plain version on the CPU, bit for bit; then the step's launches and
    device ms per step at ``DRAW_STEP_CELLS``."""
    from hipsc_abm_tpu_torch import kernels
    from hipsc_abm_tpu_torch.ops import rng

    key = torch.stack(rng.split(rng.prng_key(SEED + 7), 6))[3]
    dkey = key.to("cuda")
    salt = {"normal": 0, "unit_vectors": 1, "unit_vectors_3d": 1}
    checked = {}
    t0 = time.perf_counter()
    for name, stream in DRAW_CASES:
        for lo in range(0, 1 << 24, DRAW_CHUNK):
            bits = torch.arange(lo, lo + DRAW_CHUNK, dtype=torch.int64) << 8
            ids = rng.hash_preimage(key, bits, salt[name] + stream)
            got = draw_call(name, dkey, ids.to("cuda"), True).cpu()
            want = draw_call(name, key, ids, False)
            bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
            if bad:
                raise AssertionError(f"draws phase: {name} (stream +{stream}) differs from "
                                     f"its plain version at {bad} of the ids from {lo}")
        checked[f"{name}+{stream}"] = 1 << 24
    print(f"draws phase: every 24-bit uniform of each stream ({checked}), the kernels on "
          f"the card bit-equal to their plain versions on the CPU "
          f"({time.perf_counter() - t0:.1f} s)")
    steps = {}
    for n in DRAW_STEP_CELLS:
        steps[n] = step_launches(n)
        print(f"draws phase: step at {n} cells (2D bench, id_list): {steps[n]}")
    kernels.launch_counts.clear()
    return dict(checked=checked, steps=steps)


def step_launches(n_cells: int) -> dict:
    """Launches and device ms per step of the 2D bench colony at
    ``n_cells`` (profiler, after 3 ``safe_step`` warm-ups): the eager
    ``step`` over 2 steps, and ``safe_step`` (one replay of the captured
    step graph) over 2 steps; the draw kernels' own share of each."""
    from hipsc_abm_tpu_torch.tools import device_kernels

    eng, state = engine_for(2, n_cells, "cuda", "id_list")
    for _ in range(3):
        state, _ = eng.safe_step(state)
    carry = [state]

    def eager():
        carry[0], _ = eng.step(carry[0])

    def replay():
        carry[0], _ = eng.safe_step(carry[0])

    names = ("normal_kernel", "unit_vectors_kernel")
    out = {}
    for label, fn in (("step", eager), ("safe_step", replay)):
        ms, launches, by = device_kernels(fn, 2, names)
        out[label] = dict(device_ms=round(ms, 4), launches=launches,
                          draws={k: [round(v[0], 5), v[1]] for k, v in by.items()})
    del eng, state, carry
    torch.cuda.empty_cache()
    return out


def graph_ms(fn, reps: int) -> float:
    """Device ms per call of ``fn`` replayed from one CUDA graph of ``reps``
    calls (CUDA events around each of 3 replays; the least), free of the
    host's launch time, as in the step's graph."""
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    best = []
    for _ in range(3):
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best.append(start.elapsed_time(end) / reps)
    del graph
    torch.cuda.empty_cache()
    return min(best)


def window_entry(dims: int, n_cells: int, capacity=None, reps: int = 20) -> dict:
    """The contact window's rebuild kernels (``ops.window``) at the bench
    colony (2D) or the spheroid (3D) after one ``safe_step`` (re-padded to
    ``capacity`` rows where given): the scan's entry build, every live row
    moved by a normal step of 3 um (clamped to the box), then the kernels
    taken and skipped against ``engine._rebuild_where`` (the window bit for
    bit; skipped, every buffer's bytes kept), and each one's device ms per
    call as the step's graph replays it (``graph_ms``, in turns: kernels
    taken, skipped, ``_rebuild_where``, kernels taken)."""
    from hipsc_abm_tpu_torch import engine as engine_mod
    from hipsc_abm_tpu_torch.ops import window

    eng, state = engine_for(dims, n_cells, "cuda", "id_list")
    state, _ = eng.safe_step(state)
    cfg = eng._cfg_for_state(state)
    if capacity is not None:
        cfg = dataclasses.replace(cfg, capacity=capacity)
        state = eng.repad_state(state, cfg)
    rows = engine_mod._scan_rows(state.arrays, state.alive, state.bonds)
    rows, bounds, grouping = engine_mod._build_window(cfg, rows)
    ref = rows["loc"].clone()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    step = torch.randn(rows["loc"].shape, generator=gen, device="cuda") * 3.0
    if dims == 2:
        step[:, 2] = 0.0
    size = torch.tensor(eng.gen.size, dtype=torch.float32, device="cuda")
    # the live rows move, as the substeps' update moves them; dead rows stay
    moved = torch.minimum(torch.clamp(rows["loc"] + step, min=0.0), size)
    rows["loc"] = torch.where(rows["alive"][:, None], moved, rows["loc"])
    C = rows["ids"].shape[0]
    identity = torch.arange(C, device="cuda")
    buf = window.buffers(cfg.jkr_spec, rows, 3)
    out = dict(dims=dims, cells=n_cells, rows=C, n_live=int(rows["alive"].sum()),
               bins=cfg.jkr_spec.num_bins, launches_per_rebuild=len(window.LAUNCHES))

    def copies():
        return ({k: v.clone() for k, v in rows.items()}, bounds.clone(), ref.clone(),
                grouping._replace(starts=grouping.starts.clone()))

    for taken in (True, False):
        stale = torch.tensor(taken, device="cuda")
        w_rows, w_bounds, w_ref, w_grouping = engine_mod._rebuild_where(
            stale, cfg, rows, bounds, ref, identity, grouping=grouping)
        k_rows, k_bounds, k_ref, k_grouping = copies()
        window.rebuild_cuda(stale, cfg.jkr_spec, cfg.jkr_span, k_rows, k_bounds, k_ref,
                            k_grouping, buf.needed[1], buf)
        torch.cuda.synchronize()
        apart = [k for k in rows if not torch.equal(k_rows[k], w_rows[k])]
        apart += [name for name, a, b in (
            ("bounds", k_bounds, w_bounds), ("ref", k_ref, w_ref),
            ("starts", k_grouping.starts, w_grouping.starts),
            ("needed", buf.needed[1], w_grouping.needed)) if not torch.equal(a, b)]
        if apart or buf.counts.any():
            raise AssertionError(f"window phase {dims}D {n_cells} taken={taken}: {apart} apart")
        out["equal_taken" if taken else "equal_skipped"] = True

    work = copies()
    flags = {t: torch.tensor(t, device="cuda") for t in (True, False)}

    def kernels_call(taken):
        return lambda: window.rebuild_cuda(flags[taken], cfg.jkr_spec, cfg.jkr_span, *work,
                                           buf.needed[1], buf)

    def where_call():
        engine_mod._rebuild_where(flags[True], cfg, rows, bounds, ref, identity,
                                  grouping=grouping)

    times = {"taken": [], "skipped": [], "where": []}
    for label, fn in (("taken", kernels_call(True)), ("skipped", kernels_call(False)),
                      ("where", where_call), ("taken", kernels_call(True))):
        times[label].append(graph_ms(fn, reps))
    out.update({f"{k}_ms": round(min(v), 5) for k, v in times.items()})
    print(f"window phase [{dims}D, {n_cells}]: kernels bit-equal to _rebuild_where taken and "
          f"skipped; per rebuild: taken {out['taken_ms']:.4f} ms, skipped "
          f"{out['skipped_ms']:.4f} ms, _rebuild_where {out['where_ms']:.4f} ms "
          f"({out['n_live']} live of {C} rows, {out['bins']} bins)")
    del eng, state, rows, work, buf
    torch.cuda.empty_cache()
    return out


def window_phase() -> list:
    """``window_entry`` at the 550k bench colony in the benchmark's 550k
    cell's 1,430,016 rows, the 2D 100k colony and the 3D 99k spheroid."""
    return [window_entry(2, N_LARGE, capacity=1_430_016), window_entry(2, N_MAIN),
            window_entry(3, N_MAIN_3D)]


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
    more; and ``law``, the candidates that reach the pair law in B6 and
    the seed: on the general law (``law["uniform_radius"]`` None) those
    the cut does not drop (``ops.contact.certainly_breaks``, the kernels'
    formula in float32), on the uniform law all of them."""
    from hipsc_abm_tpu_torch.ops import contact
    from hipsc_abm_tpu_torch.ops.jkr import _pair_jkr

    xyzr, ids, alive, bounds, _ = args
    C = xyzr.shape[0]
    b = bounds.to(torch.int64).view(C, -1, 2)
    width = int(torch.clamp(b[..., 1] - b[..., 0], min=0).max())
    k = torch.arange(max(width, 1), device=bounds.device)
    general = law["uniform_radius"] is None
    law_args = contact.pair_law_args(**{k: law[k] for k in (
        "radius", "adhesion_const", "poisson", "youngs", "break_d", "uniform_radius")})
    totals = dict(membership=0, rows=0, law=0)
    for lo in range(0, C, chunk):
        rows = slice(lo, lo + chunk)
        # each row's runs, padded to the widest; positions index all C rows
        pos = b[rows, :, :1] + k
        valid = (pos < b[rows, :, 1:]).flatten(1)
        pos = pos.clamp(0, C - 1).flatten(1)
        cand = xyzr[pos]
        me = xyzr[rows][:, None, :]
        # the kernels' squared distance, rounded after each operation
        d = me[..., :3] - cand[..., :3]
        dist2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
        _, survive = _pair_jkr(me[..., :3], cand[..., :3], me[..., 3], cand[..., 3],
                               law["adhesion_const"], law["poisson"], law["youngs"],
                               law["break_d"])
        pair = valid & alive[rows][:, None] & (ids[pos] != ids[rows][:, None])
        reach = pair & survive & (dist2 > float(np.float32(law["radius"]) ** 2))
        totals["membership"] += int(reach.sum())
        totals["rows"] += int(reach.any(dim=1).sum())
        if general:
            culled = contact.certainly_breaks(
                contact.cull_reach(me[..., 3], law_args), cand[..., 3], dist2)
            totals["law"] += int((pair & ~culled).sum())
        else:
            totals["law"] += int(pair.sum())
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


def compare_colonies(a: dict, b: dict, label: str, bond_rows_allowed: int,
                     exact: bool = True) -> str:
    """Two numpy states compared by agent id: integer state and radii
    equal, positions and the lattice bit-equal (``exact``; else positions
    within 1e-3 um and the lattice within 1e-6), at most
    ``bond_rows_allowed`` bond sets differing. Returns a summary."""
    ia, ib = by_id(a), by_id(b)
    if not np.array_equal(ia["ids"], ib["ids"]):
        raise AssertionError(f"{label}: agent id sets differ")
    for k in ("FGF4", "FGFR", "ERK", "GATA6", "NANOG", "states", "death_counters",
              "diff_counters", "div_counters", "fds_counters", "radii"):
        if not np.array_equal(ia[k], ib[k]):
            raise AssertionError(f"{label}: {k} differs")
    loc_err = float(np.abs(ia["locations"] - ib["locations"]).max())
    if exact:
        np.testing.assert_array_equal(ia["locations"], ib["locations"], err_msg=label)
    else:
        np.testing.assert_allclose(ia["locations"], ib["locations"], rtol=0, atol=1e-3)
    summary = f"{len(ia['ids'])} agents, ints equal, max|dloc|={loc_err:.3e} um"
    if "fgf4_values" in a["gradients"]:
        la, lb = a["gradients"]["fgf4_values"], b["gradients"]["fgf4_values"]
        lat_err = float(np.abs(la - lb).max())
        if exact:
            np.testing.assert_array_equal(la, lb, err_msg=label)
        else:
            np.testing.assert_allclose(la, lb, rtol=0, atol=1e-6)
        summary += f", max|dlattice|={lat_err:.3e}"
    bond_rows = bond_rows_apart(ia["bonds"], ib["bonds"])
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
        # bit for bit on either law (the optional phases take the general)
        summary = compare_colonies(convert.state_to_numpy(s_cpu), on_card[path],
                                   f"step[{path}]{tag} card vs CPU", 0)
        print(f"step phase [{path}]{tag} card vs CPU: {summary}, cpu {t1 - t0:.2f} s, "
              f"card {t2 - t1:.2f} s")
    summary = compare_colonies(on_card["id_list"], on_card["span_mask"],
                               f"step{tag} span_mask vs id_list on the card", 0)
    print(f"step phase{tag} span_mask vs id_list on the card: {summary}")


def step_phase_3d(steps: int = 3, optional: bool = False):
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
    bond_rows = bond_rows_apart(a["bonds"], b["bonds"]) if same_ids else -1
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
        lattices = [x["gradients"].get("fgf4_values") for x in (a, b)]
        return dict(same_agents=True, ints_equal=ints, max_dloc=float(d.max()),
                    over_1e3=int((d > 1e-3).sum()),
                    bond_rows=bond_rows_apart(ia["bonds"], ib["bonds"]),
                    lattice_equal=(lattices[0] is None and lattices[1] is None)
                    or bool(np.array_equal(*lattices)))

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
    if bond_rows_apart(a["bonds"], b["bonds"]):
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
        # CPU's previous state, and the two trajectories, bit for bit
        write_templates(root, LIFECYCLE_GENERAL, LIFECYCLE_EXPERIMENTAL)
        for row in lifecycle_card_vs_cpu(root, LIFECYCLE_CPU_STEPS):
            for kind in ("one_step", "trajectory"):
                r = row[kind]
                if not (r["same_agents"] and r["ints_equal"] and r["max_dloc"] == 0
                        and r["bond_rows"] == 0 and r["lattice_equal"]):
                    raise AssertionError(f"{label}: step {row['step']} ({kind}) on the card "
                                         f"differs from the CPU's: {r}")

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
    the CPU's previous state, and the card's own trajectory: bit-equal by
    agent id at every step (integer state, positions, bond sets, lattice).
    Then mode 0 to 12 +
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
                for kind in ("one_step", "trajectory"):
                    d = row[kind]
                    if not (d["same_agents"] and d["ints_equal"] and d["max_dloc"] == 0
                            and d["bond_rows"] == 0 and d["lattice_equal"]):
                        raise AssertionError(f"{label} [{path}]: step {row['step']} on the "
                                             f"card ({kind}) differs from the CPU's: {d}")
            dloc = [float(f"{r['one_step']['max_dloc']:.3e}") for r in rows]
            bond_rows = [r["one_step"]["bond_rows"] for r in rows]
            traj = [r["trajectory"] for r in rows]
            print(f"{label} [{path}]: {OPT_LIFECYCLE_STEPS} card steps from the CPU's state, "
                  f"bit-equal at each; max|dloc| per step {dloc} um, bond rows "
                  f"differing per step {bond_rows}; the card's own trajectory bit-equal at "
                  f"each step {all(t.get('max_dloc') == 0 for t in traj)}, bond "
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
    # one update launch per substep (the Stokes update, move probe and
    # drift test)
    if counts.get("update", 0) != n_sub * attempts:
        raise AssertionError(f"{label}: {counts.get('update')} update launches for "
                             f"{attempts} step attempts of {n_sub} substeps")
    # the draws: the pathway's normal and division's and motility's unit
    # vectors, one launch each per step attempt
    unit = "unit_vectors" if dims == 2 else "unit_vectors_3d"
    if (counts.get("normal", 0), counts.get(unit, 0)) != (attempts, 2 * attempts):
        raise AssertionError(f"{label}: {counts.get('normal')} normal and "
                             f"{counts.get(unit)} {unit} launches for {attempts} step attempts")
    other = {n for key, names in PATH_KERNELS.items() if key[0] != dims
             for n in names} - set(PATH_KERNELS[(dims, path)])
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
    step; then each contact kernel's device ms per step on the general law
    beside the uniform law's, run by run in the order they ran, and the
    ratio of their means."""
    def ms(rs, key):
        return [r[key] and round(r[key], 4) for r in rs]

    def by_kernel(rs, name):
        return [(r.get("contact_ms_by_kernel") or {}).get(name, (0.0, 0.0)) for r in rs]

    for dims, n in ((2, N_MAIN), (3, N_MAIN_3D)):
        for path in PATHS:
            cols, sel = {}, {}
            for opt in (False, True):
                rs = sel[opt] = [r for d, c, p, o, r in runs
                                 if (d, c, p, o) == (dims, n, path, opt)]
                b4 = by_kernel(rs, "bio_moments_kernel")
                cols[opt] = (f"median {ms(rs, 'median_ms')} ms, device {ms(rs, 'device_ms')} "
                             f"ms, contact {ms(rs, 'contact_ms')} ms, B4 "
                             f"{[round(t, 4) for t, _ in b4]} ms in {[k for _, k in b4]} "
                             f"launches per step")
            print(f"optional phase d [{dims}D, {path}, {n}]: optional phases {cols[True]}; "
                  f"uniform-law main path {cols[False]}")
            for name in CONTACT_KERNELS:
                t = {opt: [round(ms_, 4) for ms_, _ in by_kernel(sel[opt], name)]
                     for opt in (False, True)}
                if not any(t[True]) and not any(t[False]):
                    continue
                ratio = (np.mean(t[True]) / np.mean(t[False])) if np.mean(t[False]) > 0 else None
                print(f"optional phase d [{dims}D, {path}, {n}] {name}: device ms per step "
                      f"general law {t[True]}, uniform law {t[False]}, general / uniform "
                      f"{'not measured' if ratio is None else f'{ratio:.3f}'}")


def compare_bits(a: dict, b: dict, label: str) -> str:
    """Two numpy states by agent id: ids, integer fields and bond sets equal,
    positions, radii, the lattice (its deposit sums in a fixed order), the
    key and ``next_id`` bit-equal. Raises, or returns a summary."""
    from hipsc_abm_tpu_torch.colonies import assert_same

    summary = assert_same(a, b, label, fields=STATE_FIELDS)
    differ = [k for k in ("key", "next_id") if not np.array_equal(a[k], b[k])]
    if differ:
        raise AssertionError(f"{label}: {differ} differ")
    return summary + ", key and next_id bit-equal"


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


def calibration_target() -> dict:
    with open(CAL_TARGET) as f:
        return json.load(f)


def calibration_engine(target: dict, device: str):
    """The showcase's colony, with adhesion and motility at 3x the
    reference's constants (the fit's start)."""
    from hipsc_abm_tpu_torch.engine import HipscEngine
    from hipsc_abm_tpu_torch.params import BiologyParams, ExperimentalParams, GeneralParams

    n, side, steps = target["n_cells"], target["side"], target["steps"]
    gen = GeneralParams(num_to_start=n, end_step=steps + 1, size=(side, side, 0.0))
    xp = ExperimentalParams(num_gata6=n // 10, dox_step=5)
    bio = BiologyParams(**{p: v * CAL_START for p, v in CAL_TRUE.items()})
    return HipscEngine(gen, xp, bio=bio, device=device)


def check_colony(device: str, replicates: int):
    """tests/test_calibrate.py's colony (150 + 15 cells in a 300 um box,
    dox at step 1) on ``device``: the engine and ``replicates`` states
    (seeds 0..), each settled by one ``safe_step``, stacked."""
    from hipsc_abm_tpu_torch.engine import HipscEngine
    from hipsc_abm_tpu_torch.params import ExperimentalParams, GeneralParams
    from hipsc_abm_tpu_torch.parallel.ensemble import EnsembleEngine

    eng = HipscEngine(GeneralParams(num_to_start=150, end_step=5, size=(300.0, 300.0, 0.0)),
                      ExperimentalParams(num_gata6=15, dox_step=1), device=device)
    ens = EnsembleEngine(eng)
    states, _ = ens.safe_step(ens.init_states(seeds=range(replicates)))
    return eng, states


def showcase_loss(target: dict, horizon: int):
    """The showcase's loss: the replicate-mean Rg and soft contact delta
    courses against the target's first ``horizon`` steps."""
    from hipsc_abm_tpu_torch import calibrate as cal_mod

    gate = target["contact_gate"]
    return cal_mod.ensemble_trajectory(cal_mod.multi_delta_trajectory_squared_error([
        (cal_mod.radius_of_gyration,
         np.asarray(target["rg_trajectory_um"][:horizon], np.float32)),
        (cal_mod.soft_contact_count(gate["r_um"], gate["width_um"]),
         np.asarray(target["contact_trajectory"][:horizon], np.float32)),
    ]))


def timed_gradient(cal, theta, states, cfg) -> dict:
    """One gradient evaluation under ``cfg``: loss, gradient, wall seconds
    and peak device memory (MiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (loss, _), grad = cal._value_and_grad(theta, states, cfg)
    torch.cuda.synchronize()
    return dict(loss=float(loss), grad=grad.tolist(), s=time.perf_counter() - t0,
                peak_mib=torch.cuda.max_memory_allocated() / 2**20)


def finite_difference(cal, theta, states) -> dict:
    """Central differences of the loss in each parameter, ``CAL_FD_H`` in
    its log, as one population through the kernels (the engine's path):
    the differences, seconds, branches and kernel launches."""
    from hipsc_abm_tpu_torch import kernels

    steps = torch.eye(theta.shape[0]) * CAL_FD_H
    cands = torch.stack([theta + sgn * steps[i] for i in range(theta.shape[0])
                         for sgn in (1, -1)])
    kernels.launch_counts.clear()
    t0 = time.perf_counter()
    losses, _ = cal._eval_with_growth(lambda st: cal._population(cands, st), states)
    torch.cuda.synchronize()
    fd = [(float(losses[2 * i]) - float(losses[2 * i + 1])) / (2 * CAL_FD_H)
          for i in range(theta.shape[0])]
    return dict(h=CAL_FD_H, fd=fd, s=time.perf_counter() - t0,
                branches=len(cands) * states.alive.shape[0],
                launches=dict(kernels.launch_counts))


@contextlib.contextmanager
def plain_path_timer():
    """Times the plain contact substeps and bio moments the gradient path
    calls (each call synchronised before and after; a checkpoint's
    recompute calls them again): yields a dict of seconds by name."""
    from hipsc_abm_tpu_torch import engine as engine_mod

    spent = {"contact_substep_plain": 0.0, "bio_moments_plain": 0.0}
    saved = {name: getattr(engine_mod, name) for name in spent}

    def timed(name):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = saved[name](*args, **kwargs)
            torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t0
            return out
        return call

    for name in spent:
        setattr(engine_mod, name, timed(name))
    try:
        yield spent
    finally:
        for name, fn in saved.items():
            setattr(engine_mod, name, fn)


def card_and_cpu_gradients(make_cal, numpy_states: list, time_plain: bool = False) -> dict:
    """One gradient evaluation of the same stacked states on the card and
    on the CPU (``make_cal(device)`` builds each calibrator); with
    ``time_plain``, the card's under ``plain_path_timer``."""
    from hipsc_abm_tpu_torch import convert
    from hipsc_abm_tpu_torch.parallel.ensemble import _stack

    got = {}
    for device in ("cuda", "cpu"):
        cal = make_cal(device)
        st = cal._reconcile(_stack([convert.state_from_numpy(d, device) for d in numpy_states]))
        timer = plain_path_timer() if time_plain and device == "cuda" else (
            contextlib.nullcontext({}))
        t0 = time.perf_counter()
        with timer as spent:
            (loss, _), g = cal._value_and_grad(cal.theta0(), st, cal._grad_cfg(cal.engine.cfg))
            if device == "cuda":
                torch.cuda.synchronize()
        got[device] = dict(loss=float(loss), grad=g.tolist(), s=time.perf_counter() - t0)
        if spent:
            got[device]["plain_s"] = dict(spent)
            got[device]["plain_share"] = sum(spent.values()) / got[device]["s"]
    return got


def calibration_showcase_part(target: dict) -> dict:
    """Phase 10 a: ``prepare`` and one gradient evaluation at the showcase
    width (R replicates, the target's horizon; ``dense_pairs`` off, so that
    the forward-only rollouts run the contact kernel), again with
    ``remat_substeps`` on, the central finite difference through the
    kernels, and at horizon 2 over 2 replicates the card against the CPU
    with the share of the card's evaluation spent in the plain contact and
    bio-moments functions. The finite difference and the card-vs-CPU
    numbers are recorded, not held to a tolerance (the rollout is chaotic
    in float32)."""
    from hipsc_abm_tpu_torch import calibrate as cal_mod
    from hipsc_abm_tpu_torch import convert
    from hipsc_abm_tpu_torch.parallel.ensemble import EnsembleEngine

    names = list(CAL_TRUE)
    horizon = target["steps"]
    eng = calibration_engine(target, "cuda")
    cal = cal_mod.Calibrator(eng, names, showcase_loss(target, horizon), horizon=horizon,
                             dense_pairs=False)
    states = EnsembleEngine(eng).init_states(seeds=range(CAL_R))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    states = cal.prepare(states)
    torch.cuda.synchronize()
    out = {"replicates": CAL_R, "horizon": horizon, "capacity": eng.cfg.capacity,
           "prepare_s": time.perf_counter() - t0}
    theta = cal.theta0()
    gcfg = cal._grad_cfg(eng.cfg)
    out["gradient"] = timed_gradient(cal, theta, states, gcfg)
    out["remat_substeps"] = timed_gradient(
        cal, theta, states, dataclasses.replace(gcfg, remat_substeps=True))
    grad = np.asarray(out["gradient"]["grad"])
    if not np.all(np.isfinite(grad)) or not np.any(grad):
        raise AssertionError(f"calibration a: gradient {grad}")
    if out["remat_substeps"]["loss"] != out["gradient"]["loss"]:
        raise AssertionError("calibration a: remat_substeps changed the loss: "
                             f"{out['gradient']['loss']} vs {out['remat_substeps']['loss']}")
    out["finite_difference"] = finite_difference(cal, theta, states)
    pair = [convert.state_to_numpy(EnsembleEngine.replicate(states, i)) for i in range(CAL_CPU_R)]
    out["card_vs_cpu"] = card_and_cpu_gradients(
        lambda device: cal_mod.Calibrator(
            calibration_engine(target, device), names,
            showcase_loss(target, CAL_CHECK_HORIZON), horizon=CAL_CHECK_HORIZON,
            dense_pairs=False), pair, time_plain=True)
    print(f"calibration a: loss {out['gradient']['loss']:.6g} gradient {grad.tolist()} in "
          f"{out['gradient']['s']:.1f} s, peak {out['gradient']['peak_mib']:.0f} MiB "
          f"(remat_substeps on: {out['remat_substeps']['s']:.1f} s, "
          f"{out['remat_substeps']['peak_mib']:.0f} MiB); finite difference "
          f"{out['finite_difference']['fd']}; horizon {CAL_CHECK_HORIZON} card vs CPU "
          f"{out['card_vs_cpu']}")
    return out


def calibration_checks_part() -> dict:
    """Phase 10 b, on ``check_colony``: the gradient of the soft contact
    count at horizon 2 (adhesion and motility) against the central finite
    difference through the kernels, within ``CAL_FD_RTOL``; the card's
    loss and gradient against the CPU's over ``CAL_CPU_R`` replicates; the
    dense and windowed paths' replicate-mean Rg after ``CAL_DENSE_STEPS``
    steps, within ``CAL_DENSE_ATOL``."""
    from hipsc_abm_tpu_torch import calibrate as cal_mod
    from hipsc_abm_tpu_torch import convert
    from hipsc_abm_tpu_torch.parallel.ensemble import EnsembleEngine

    names = list(CAL_TRUE)
    eng, states = check_colony("cuda", 1)
    cal = cal_mod.Calibrator(eng, names, cal_mod.soft_contact_count(10.0, 1.0),
                             horizon=CAL_CHECK_HORIZON, dense_pairs=False)
    states = cal.prepare(states)
    theta = cal.theta0()
    (_, _), grad = cal._value_and_grad(theta, states, cal._grad_cfg(eng.cfg))
    out = {"gradient": grad.tolist(), "finite_difference": finite_difference(cal, theta, states)}
    launches = out["finite_difference"]["launches"]
    if not (launches.get("contact_substep") and launches.get("bio_moments")):
        raise AssertionError(f"calibration b: kernels not launched {launches}")
    for name, ad, fd in zip(names, grad.tolist(), out["finite_difference"]["fd"]):
        if not abs(ad - fd) <= CAL_FD_RTOL * max(abs(ad), abs(fd)):
            raise AssertionError(f"calibration b: {name} gradient {ad} vs finite difference {fd}")
    _, pair_states = check_colony("cuda", CAL_CPU_R)
    pair = [convert.state_to_numpy(EnsembleEngine.replicate(pair_states, i))
            for i in range(CAL_CPU_R)]
    got = card_and_cpu_gradients(
        lambda device: cal_mod.Calibrator(
            check_colony(device, 1)[0], names,
            cal_mod.squared_error(cal_mod.radius_of_gyration, 100.0),
            horizon=CAL_CHECK_HORIZON), pair)
    out["card_vs_cpu"] = got
    lc, lp = got["cuda"]["loss"], got["cpu"]["loss"]
    gc, gp = np.asarray(got["cuda"]["grad"]), np.asarray(got["cpu"]["grad"])
    if not abs(lc - lp) <= CAL_CPU_LOSS_RTOL * abs(lp):
        raise AssertionError(f"calibration b: card loss {lc} vs CPU {lp}")
    if not np.all(np.abs(gc - gp) <= CAL_CPU_GRAD_RTOL * np.abs(gp)):
        raise AssertionError(f"calibration b: card gradient {gc} vs CPU {gp}")
    rg = {}
    for dense in (True, False):
        c = cal_mod.Calibrator(eng, ["adhesion_const"], cal_mod.TrajectoryLoss(
            cal_mod.radius_of_gyration, lambda stats: stats[-1]), horizon=CAL_DENSE_STEPS,
            dense_pairs=dense)
        st = c._reconcile(pair_states)
        rg["dense" if dense else "windowed"] = float(
            c._population(c.theta0()[None, :], st)[0][0])
    out["final_rg_um"] = rg
    if not abs(rg["dense"] - rg["windowed"]) <= CAL_DENSE_ATOL:
        raise AssertionError(f"calibration b: dense and windowed Rg {rg}")
    print(f"calibration b: gradient {grad.tolist()} finite difference "
          f"{out['finite_difference']['fd']}; card vs CPU {got}; Rg {rg}")
    return out


def calibration_es_part(target: dict) -> dict:
    """Phase 10 c: ``fit_es`` on ``adhesion_const`` at the showcase colony
    (``CAL_ES_R`` replicates, the target's horizon), first with the
    auto-selected dense path, then with ``dense_pairs=False``: per
    generation the population's capture seconds (the warm-up step
    included), the rest of its wall (``replay_s``: the replays and the
    statistics), branches and peak memory; the launches of B4 and B6 (B6
    only on the windowed path); one candidate's population loss against
    its solo rollout, bit for bit; the two runs' loss histories."""
    from hipsc_abm_tpu_torch import calibrate as cal_mod
    from hipsc_abm_tpu_torch import kernels
    from hipsc_abm_tpu_torch.parallel.ensemble import EnsembleEngine

    horizon = target["steps"]
    out = {}
    for label, dense in (("dense", None), ("windowed", False)):
        eng = calibration_engine(target, "cuda")
        cal = cal_mod.Calibrator(eng, ["adhesion_const"], showcase_loss(target, horizon),
                                 horizon=horizon, dense_pairs=dense)
        states = EnsembleEngine(eng).init_states(seeds=range(CAL_ES_R))
        gens = []
        population = cal._population

        def timed_population(cands, st):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            result = population(cands, st)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            graph = cal._ens.graphs()[0]
            gens.append(dict(branches=graph["replicates"], capture_s=graph["capture_s"],
                             replay_s=wall - graph["capture_s"], pool_mib=graph["pool_mib"],
                             peak_mib=torch.cuda.max_memory_allocated() / 2**20))
            return result

        cal._population = timed_population
        kernels.launch_counts.clear()
        t0 = time.perf_counter()
        res = cal.fit_es(states, iters=CAL_ES_GENS, popsize=CAL_ES_POP, sigma=CAL_ES_SIGMA,
                         learning_rate=0.1, seed=0)
        run = dict(dense_pairs=eng.cfg.dense_pairs, s=time.perf_counter() - t0,
                   loss_history=res.loss_history, params=res.params, generations=gens,
                   launches=dict(kernels.launch_counts))
        del cal._population
        b4, b6 = run["launches"].get("bio_moments", 0), run["launches"].get("contact_substep", 0)
        if not b4 or (b6 > 0) == eng.cfg.dense_pairs or eng.cfg.dense_pairs != (dense is None):
            raise AssertionError(f"calibration c ({label}): dense {eng.cfg.dense_pairs}, "
                                 f"launches {run['launches']}")
        states = cal._reconcile(states)
        theta = torch.from_numpy(res.theta)
        pop, _ = cal._population(theta[None, :], states)
        run["solo_loss"] = cal.evaluate(theta, states)
        if float(pop[0]) != run["solo_loss"]:
            raise AssertionError(f"calibration c ({label}): population {float(pop[0])!r} "
                                 f"vs solo {run['solo_loss']!r}")
        out[label] = run
        print(f"calibration c ({label}): {run['s']:.1f} s, losses {res.loss_history}, "
              f"generations {gens}, B4 {b4}, B6 {b6}; population = solo "
              f"{run['solo_loss']!r}")
    out["loss_apart_rel"] = [abs(a - b) / abs(b) for a, b in zip(
        out["dense"]["loss_history"], out["windowed"]["loss_history"])]
    return out


def calibration_phase() -> dict:
    """Phase 10, calibration (see the module docstring)."""
    from hipsc_abm_tpu_torch.examples import calibrate as example

    target = calibration_target()
    out = {"showcase": calibration_showcase_part(target)}
    torch.cuda.empty_cache()
    out["checks"] = calibration_checks_part()
    out["es"] = calibration_es_part(target)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fits = example.main(device="cuda")
    grad_fit, es_fit = fits["gradient"], fits["es"]
    out["example"] = dict(
        s=time.perf_counter() - t0, gradient=grad_fit.loss_history, es=es_fit.loss_history,
        params={**grad_fit.params, **es_fit.params})
    if not (grad_fit.best_loss < grad_fit.loss_history[0]
            and es_fit.loss_history[-1] < es_fit.loss_history[0]):
        raise AssertionError(f"calibration d: the example's losses did not fall: {out['example']}")
    return out


# ---------------------------------------------------------------------------
# phase 11: the domain-decomposed engine
# ---------------------------------------------------------------------------


def domain_like(eng, device: str, path: str = "span_mask", **grid):
    """A ``DomainHipscEngine`` with the parameters and phase switches of the
    single engine ``eng``, on ``device``, cut by ``grid`` (``n_stripes`` or
    ``tiles``)."""
    from hipsc_abm_tpu_torch.parallel import DomainHipscEngine

    cfg = eng.cfg
    return DomainHipscEngine(eng.gen, eng.xp, eng.bio, eng.diff, device=device,
                             contact_path=path, enable_diffusion=cfg.enable_diffusion,
                             enable_growth=cfg.enable_growth,
                             enable_stochastic=cfg.enable_stochastic,
                             enable_diff_surround=cfg.enable_diff_surround, **grid)


def domain_flat(dom, dstate) -> dict:
    """A decomposed state as a flat numpy state dict."""
    from hipsc_abm_tpu_torch import convert

    return convert.state_to_numpy(dom.to_cell_state(dstate))


def domain_equal(a: dict, b: dict, label: str) -> str:
    """A decomposed run's flat state against a single engine's, by agent id:
    every field and the bond sets bit-equal; the lattice within
    ``DOMAIN_LATTICE_ATOL`` (the tiles' deposits are summed in tile order,
    the single engine's go straight onto the lattice). Raises, or returns a
    summary."""
    from hipsc_abm_tpu_torch.colonies import assert_same

    return assert_same(a, b, label, lattice_atol=DOMAIN_LATTICE_ATOL)


def counted(fn):
    """``fn()`` with the launch counts set to 0 just before and read just
    after: ``(result, counts)``."""
    from hipsc_abm_tpu_torch import kernels

    kernels.launch_counts.clear()
    out = fn()
    counts = dict(kernels.launch_counts)
    kernels.launch_counts.clear()
    return out, counts


def clone_tree(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):  # a NamedTuple (a grouping)
        return type(x)(*(clone_tree(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(clone_tree(v) for v in x)
    if isinstance(x, dict):
        return {k: clone_tree(v) for k, v in x.items()}
    return x


class TileCalls:
    """Inside the ``with`` block, records the first call of each kernel
    wrapper that runs its kernel (no predicate, or one that is set; for the
    bio moments the motility-mode call), with its inputs cloned before the
    call: the inputs the domain path gives the kernels at a tile's shapes
    (own rows and halo blocks, tile-local run bounds)."""

    def __init__(self):
        from hipsc_abm_tpu_torch import engine as engine_mod
        from hipsc_abm_tpu_torch.ops import span_mask
        from hipsc_abm_tpu_torch.parallel import domain_engine

        self.targets = [(span_mask, "contact_seed_cuda", "contact_seed"),
                        (span_mask, "contact_masked_cuda", "contact_masked"),
                        (span_mask, "mask_compact_cuda", "mask_compact"),
                        (engine_mod, "bio_moments_cuda", "bio_moments"),
                        (domain_engine, "contact_substep_cuda", "contact_substep")]
        self.calls, self.real = {}, []

    def _wrap(self, real, name):
        def call(*args, **kw):
            pred = kw.get("pred")
            if (name not in self.calls and (pred is None or int(pred.reshape(-1)[0]) != 0)
                    and (name != "bio_moments" or kw.get("mode") == "motility")):
                self.calls[name] = (clone_tree(args), clone_tree(kw))
            return real(*args, **kw)
        return call

    def __enter__(self):
        for mod, attr, name in self.targets:
            self.real.append(getattr(mod, attr))
            setattr(mod, attr, self._wrap(self.real[-1], name))
        return self

    def __exit__(self, *exc):
        for (mod, attr, _), real in zip(self.targets, self.real):
            setattr(mod, attr, real)


def tile_kernel_entries(calls: dict) -> list:
    """Each kernel the domain path ran, on the inputs of its recorded tile
    call (``TileCalls``), against its plain version on the same inputs, with
    the times and bounds of ``kernel_phase``: entries ``<kernel>[tile]``."""
    from hipsc_abm_tpu_torch import kernels
    from hipsc_abm_tpu_torch.ops import bio_moments, contact, span_mask

    results = []

    def entry(name, n_runs, source, replaces, **nums):
        results.append(dict(name=f"{kernels.counted_name(name, n_runs)}[tile]", route="cuda",
                            source=f"hipsc_abm_tpu_torch/csrc/{source}", replaces=replaces,
                            library_ms=None, law="uniform", **nums))
        return results[-1]["name"]

    def law_of(kw):
        return {k: v for k, v in kw.items() if k not in ("out", "pred", "width")}

    if "contact_substep" in calls:
        args, kw = calls["contact_substep"]
        law, n_runs = law_of(kw), kernels.run_count(args[3])
        C, K = args[4].shape
        f_k, d_k, p_k = contact.contact_substep_cuda(*args, **law)
        f_p, d_p, p_p = contact.contact_substep_plain(*args, **law)
        torch.cuda.synchronize()
        f_scale, f_err = check_contact("contact_substep[tile]", f_k, d_k, f_p, d_p)
        bad = sum(x != y for x, y in zip(
            [frozenset(r[r >= 0].tolist()) for r in p_k.cpu().numpy()],
            [frozenset(r[r >= 0].tolist()) for r in p_p.cpu().numpy()]))
        if bad:
            raise AssertionError(f"contact_substep[tile]: bond sets differ on {bad} rows")
        name = entry("contact_substep", n_runs, "contact.cu",
                     "hipsc_abm_tpu/ops/pallas_contact.py:79", max_abs_err=f_err,
                     ms=cuda_ms(lambda: contact.contact_substep_cuda(*args, **law), 20),
                     plain_ms=cuda_ms(lambda: contact.contact_substep_plain(*args, **law), 5),
                     **bound(C * (16 + 1 + 8 * n_runs + 4 + 8 * K + 16),
                             contact_flops(args[3], args[2], d_p)))
        print(f"kernel {name}: rows={C} K={K} max|F|={f_scale:.6e} N max_abs_err={f_err:.3e} N")
    if "contact_seed" in calls:
        args, kw = calls["contact_seed"]
        law, n_runs = law_of(kw), kernels.run_count(args[3])
        C, K = args[4].shape
        row_bytes = 16 + 1 + 8 * n_runs
        f_k, d_k, m_k = span_mask.contact_seed_cuda(*args, **law)
        f_p, d_p, m_p = span_mask.contact_seed_plain(*args, **law)
        torch.cuda.synchronize()
        f_scale, f_err = check_contact("contact_seed[tile]", f_k, d_k, f_p, d_p)
        if m_k.shape != m_p.shape or not torch.equal(m_k, m_p):
            raise AssertionError("contact_seed[tile]: mask words differ")
        W, walk = m_p.shape[0], membership_counts(args, law)
        name = entry("contact_seed", n_runs, "contact_mask.cu",
                     "hipsc_abm_tpu/ops/pallas_contact.py:697", max_abs_err=f_err,
                     ms=cuda_ms(lambda: span_mask.contact_seed_cuda(*args, **law), 20),
                     plain_ms=cuda_ms(lambda: span_mask.contact_seed_plain(*args, **law), 5),
                     **bound(C * (row_bytes + 16 + 4 * W) + 4 * K * walk["rows"]
                             + 4 * walk["membership"], contact_flops(args[3], args[2], d_p)))
        print(f"kernel {name}: rows={C} K={K} W={W} max|F|={f_scale:.6e} N "
              f"max_abs_err={f_err:.3e} N")
    if "contact_masked" in calls:
        args, kw = calls["contact_masked"]
        law, n_runs = law_of(kw), kernels.run_count(args[3])
        C, W = args[0].shape[0], args[4].shape[0]
        m_k, m_p = args[4].clone(), args[4].clone()
        f_k, d_k, _ = span_mask.contact_masked_cuda(*args[:4], m_k, **law)
        f_p, d_p, _ = span_mask.contact_masked_plain(*args[:4], m_p, **law)
        torch.cuda.synchronize()
        f_scale, f_err = check_contact("contact_masked[tile]", f_k, d_k, f_p, d_p)
        if not torch.equal(m_k, m_p):
            raise AssertionError("contact_masked[tile]: mask words differ")
        m_time = args[4].clone()
        name = entry("contact_masked", n_runs, "contact_mask.cu",
                     "hipsc_abm_tpu/ops/pallas_contact.py:481", max_abs_err=f_err,
                     ms=cuda_ms(lambda: span_mask.contact_masked_cuda(*args[:4], m_time, **law),
                                20),
                     plain_ms=cuda_ms(lambda: span_mask.contact_masked_plain(
                         *args[:4], m_time, **law), 5),
                     **bound(C * (16 + 1 + 8 * n_runs + 16 + 8 * W),
                             contact_flops(args[3], args[2], d_p)))
        print(f"kernel {name}: rows={C} W={W} max|F|={f_scale:.6e} N max_abs_err={f_err:.3e} N")
    if "mask_compact" in calls:
        (ids, bounds, mask, K), _ = calls["mask_compact"]
        n_runs, C, W = kernels.run_count(bounds), ids.shape[0], mask.shape[0]
        c_k = span_mask.mask_compact_cuda(ids, bounds, mask, K)
        c_p = span_mask.mask_compact_plain(ids, bounds, mask, K)
        torch.cuda.synchronize()
        if not torch.equal(c_k, c_p):
            raise AssertionError("mask_compact[tile]: ids differ")
        words = int(torch.clamp((span_mask.candidate_counts(bounds) + 31) // 32, max=W).sum())
        name = entry("mask_compact", n_runs, "contact_mask.cu",
                     "hipsc_abm_tpu/ops/pallas_contact.py:877", max_abs_err=0.0,
                     ms=cuda_ms(lambda: span_mask.mask_compact_cuda(ids, bounds, mask, K), 20),
                     plain_ms=cuda_ms(lambda: span_mask.mask_compact_plain(ids, bounds, mask, K),
                                      5),
                     **bound(C * (8 * n_runs + 4 * K) + 4 * words + 4 * int((c_k >= 0).sum()),
                             0.0))
        print(f"kernel {name}: rows={C} K={K} W={W}, ids equal row for row")
    if "bio_moments" in calls:
        b_args, b_kw = calls["bio_moments"]
        b_kw = law_of(b_kw)
        n_runs = kernels.run_count(b_args[2])
        err = 0.0
        for mode in ("count", "pathway", "motility", "full"):
            kw = dict(b_kw, mode=mode)
            b_k = bio_moments.bio_moments_cuda(*b_args, **kw)
            b_p = bio_moments.bio_moments_plain(*b_args, **kw)
            if not torch.equal(b_k[:, [0, 3, 7]], b_p[:, [0, 3, 7]]):
                raise AssertionError(f"bio_moments[tile, {mode}]: count lanes differ")
            torch.testing.assert_close(b_k, b_p, rtol=1e-5, atol=1e-4)
            err = max(err, float((b_k - b_p).abs().max()))
        full = dict(b_kw, mode="full")
        name = entry("bio_moments", n_runs, "bio_moments.cu",
                     "hipsc_abm_tpu/ops/pallas_bio.py:58", max_abs_err=err,
                     ms=cuda_ms(lambda: bio_moments.bio_moments_cuda(*b_args, **full), 20),
                     plain_ms=cuda_ms(lambda: bio_moments.bio_moments_plain(*b_args, **full), 5),
                     **bio_bound(b_args, full, float(b_p[:, 0].sum())))
        print(f"kernel {name}: rows={b_args[0].shape[0]} max_abs_err={err:.3e} (all four "
              "modes, on the motility call's inputs)")
    return results


def domain_against_single(dims: int, n: int, grid: dict, steps: int, tag: str) -> dict:
    """``steps`` ``safe_step``s of the decomposed engine (span-mask path) and
    of the single engine on the card from one initial colony, held bit-equal
    by agent id (``domain_equal``); the domain's launches counted from 0."""
    from hipsc_abm_tpu_torch import convert

    eng, state = engine_for(dims, n, "cuda", "span_mask")
    dom = domain_like(eng, "cuda", **grid)
    ds = [dom.from_cell_state(state)]
    t0 = time.perf_counter()

    def run():
        for _ in range(steps):
            ds[0], _ = dom.safe_step(ds[0])
        torch.cuda.synchronize()

    _, counts = counted(run)
    t1 = time.perf_counter()
    for _ in range(steps):
        state, _ = eng.safe_step(state)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    label = f"domain phase {tag} [{dims}D, {n}, {grid}]"
    summary = domain_equal(domain_flat(dom, ds[0]), convert.state_to_numpy(state), label)
    cfg = dom.cfg
    print(f"{label}: {steps} safe_steps against the single engine on the card: {summary}; "
          f"domain {t1 - t0:.2f} s, single {t2 - t1:.2f} s; per tile {cfg.per_stripe} slots + "
          f"{cfg.n_halo_blocks} x {cfg.halo_cap} halo rows; launches {counts}")
    del eng, dom
    torch.cuda.empty_cache()
    return dict(counts=counts, domain_s=t1 - t0, single_s=t2 - t1)


def domain_card_vs_cpu() -> dict:
    """Phase 11 b and d: one domain step (tiles ``DOMAIN_TILES``) from one
    20k-cell state on the CPU and on the card (b: integers equal, positions
    within 1e-3 um, the lattice bit-equal), and the id-list path on the card
    from the same state against the span-mask path (d), with B6's launches
    counted from 0 and its tile-shaped call recorded."""
    from hipsc_abm_tpu_torch import convert
    from hipsc_abm_tpu_torch.engine import _physics_dts

    base, s0 = engine_for(2, N_STEP_CHECK, "cpu", "span_mask")
    s0, _ = base.safe_step(s0)  # bonds and a lattice to start from
    cpu = domain_like(base, "cpu", tiles=DOMAIN_TILES)
    d = convert.domain_state_to_numpy(cpu.from_cell_state(s0))
    t0 = time.perf_counter()
    a, _ = cpu.step(convert.domain_state_from_numpy(d, cpu.devices))
    t1 = time.perf_counter()
    gpu = domain_like(base, "cuda", tiles=DOMAIN_TILES)
    gpu.cfg = cpu.cfg
    b, _ = gpu.step(convert.domain_state_from_numpy(d, gpu.devices))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    x, y = domain_flat(cpu, a), domain_flat(gpu, b)
    summary = compare_colonies(x, y, "domain phase b card vs CPU", 0)
    lattice_bits = int((x["gradients"]["fgf4_values"].view(np.int32)
                        != y["gradients"]["fgf4_values"].view(np.int32)).sum())
    if lattice_bits:
        raise AssertionError(f"domain phase b: the lattice differs at {lattice_bits} points")
    print(f"domain phase b [2D, {N_STEP_CHECK}, tiles {DOMAIN_TILES}] one step card vs CPU: "
          f"{summary}, lattice bit-equal; cpu {t1 - t0:.2f} s, card {t2 - t1:.2f} s")
    gid = domain_like(base, "cuda", "id_list", tiles=DOMAIN_TILES)
    gid.cfg = dataclasses.replace(cpu.cfg, base=dataclasses.replace(cpu.cfg.base,
                                                                   contact_path="id_list"))
    with TileCalls() as calls:
        (c, _), counts = counted(lambda: gid.step(
            convert.domain_state_from_numpy(d, gid.devices)))
    S, n_sub = gid.cfg.n_stripes, len(_physics_dts(gid.bio))
    if counts.get("contact_substep", 0) != S * n_sub or any(
            counts.get(k, 0) for k in SPAN_MASK_KERNELS):
        raise AssertionError(f"domain phase d: launches {counts}")
    summary = compare_colonies(y, domain_flat(gid, c), "domain phase d id_list vs span_mask", 0)
    print(f"domain phase d [tiles {DOMAIN_TILES}] id_list against span_mask on the card: "
          f"{summary}; launches {counts}")
    entries = tile_kernel_entries({k: v for k, v in calls.calls.items()
                                   if k == "contact_substep"})
    return dict(counts=counts, entries=entries, cpu_s=t1 - t0, card_s=t2 - t1)


def domain_timing() -> dict:
    """Phase 11 e: the 2D 500k bench colony in tiles ``DOMAIN_TILES`` and on
    the single engine (span-mask path), each warmed up until a
    ``safe_step`` grows nothing, then one more domain step recording the
    kernels' tile-shaped calls (checked against their plain versions), then
    ``DOMAIN_TIMED`` ``safe_step``s per engine and turn in the order domain,
    single, domain, single: median and p90 ms per step, peak memory per
    engine's turns, and the domain's launches, counted from 0 over its
    turns (per step attempt: the seed and the compaction 11 per tile, the
    masked substep 10, the bio moments 3 and the deposit 1 per tile, FTCS 1
    per device)."""
    from hipsc_abm_tpu_torch import kernels
    from hipsc_abm_tpu_torch.engine import _physics_dts

    eng, state = engine_for(2, N_LARGE, "cuda", "span_mask")
    dom = domain_like(eng, "cuda", tiles=DOMAIN_TILES)
    ds = dom.from_cell_state(state)
    t0 = time.perf_counter()
    for i in range(DOMAIN_WARMUP):
        ds, _ = dom.safe_step(ds)
        if dom.attempts == 1 and i > 0:
            break
    else:
        raise AssertionError("domain phase e: the domain engine still grows after warm-up")
    for i in range(DOMAIN_WARMUP):
        state, _ = eng.safe_step(state)
        if eng.block_attempts == 1 and i > 0:
            break
    else:
        raise AssertionError("domain phase e: the single engine still grows after warm-up")
    warm_s = time.perf_counter() - t0
    with TileCalls() as calls:
        ds, _ = dom.safe_step(ds)
    entries = tile_kernel_entries(calls.calls)
    kernels.launch_counts.clear()
    ms = {"domain": [], "single": []}
    peak = {"domain": 0, "single": 0}
    counts, attempts, rebuilds = {}, 0, 0
    for turn in ("domain", "single", "domain", "single"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.launch_counts.clear()
        for _ in range(DOMAIN_TIMED):
            t = time.perf_counter()
            if turn == "domain":
                ds, info = dom.safe_step(ds)
                attempts += dom.attempts
                rebuilds += info.jkr_rebuilds
            else:
                state, info = eng.safe_step(state)
            ms[turn].append((time.perf_counter() - t) * 1e3)
        peak[turn] = max(peak[turn], torch.cuda.max_memory_allocated())
        if turn == "domain":
            for k, v in kernels.launch_counts.items():
                counts[k] = counts.get(k, 0) + v
        kernels.launch_counts.clear()
    S, n_sub = dom.cfg.n_stripes, len(_physics_dts(dom.bio))
    want = {"contact_seed": S * n_sub, "contact_masked": S * (n_sub - 1),
            "mask_compact": S * n_sub, "bio_moments": 3 * S, "deposit": S, "ftcs_diffuse": 1}
    wrong = {k: (counts.get(k, 0), v * attempts) for k, v in want.items()
             if counts.get(k, 0) != v * attempts or not v}
    if wrong:
        raise AssertionError(f"domain phase e: launches (got, want) {wrong} over {attempts} "
                             f"step attempts")
    agents = domain_flat(dom, ds)["alive"].sum()
    out = dict(
        cells=N_LARGE, tiles=list(DOMAIN_TILES), agents=int(agents), warm_s=warm_s,
        domain_median_ms=float(np.median(ms["domain"])),
        domain_p90_ms=float(np.percentile(ms["domain"], 90)),
        single_median_ms=float(np.median(ms["single"])),
        single_p90_ms=float(np.percentile(ms["single"], 90)),
        domain_peak_mib=peak["domain"] / 2**20, single_peak_mib=peak["single"] / 2**20,
        attempts=attempts, rebuilds=rebuilds, substeps=n_sub,
        launches_per_attempt={k: counts.get(k, 0) / attempts for k in want},
        per_stripe=dom.cfg.per_stripe, halo_cap=dom.cfg.halo_cap,
        exchange_bytes_per_step=dom.exchange_bytes[-1])
    print(f"domain phase e [2D, {N_LARGE}, tiles {DOMAIN_TILES}]: {agents} agents; "
          f"safe_step median {out['domain_median_ms']:.3f} ms, p90 {out['domain_p90_ms']:.3f} ms "
          f"(domain) against median {out['single_median_ms']:.3f} ms, p90 "
          f"{out['single_p90_ms']:.3f} ms (single engine), {2 * DOMAIN_TIMED} steps each in "
          f"turns; peak memory {out['domain_peak_mib']:.1f} / {out['single_peak_mib']:.1f} MiB; "
          f"launches per step attempt {out['launches_per_attempt']}; {rebuilds} window "
          f"rebuilds; exchange bytes per step {out['exchange_bytes_per_step']}; warm-up "
          f"{warm_s:.2f} s")
    del eng, dom
    torch.cuda.empty_cache()
    return dict(out, counts=counts, entries=entries)


def domain_lifecycle() -> dict:
    """Phase 11 f: the shipped templates' values (``LIFECYCLE_GENERAL``,
    cut to ``DOMAIN_LIFECYCLE_STEPS`` steps without images) through
    ``CellSimulation`` on the card with ``domain_tiles`` and without, equal
    by agent id."""
    from hipsc_abm_tpu_torch import convert
    from hipsc_abm_tpu_torch.parallel import DomainHipscEngine

    general = dict(LIFECYCLE_GENERAL, end_step=DOMAIN_LIFECYCLE_STEPS, output_images=False)
    runs = {}
    for key, extra in (("domain", {"domain_tiles": list(DOMAIN_TILES)}), ("single", {})):
        root = tempfile.mkdtemp(prefix=f"hipsc_domain_{key}_")
        try:
            write_templates(root, dict(general, **extra), LIFECYCLE_EXPERIMENTAL)
            t0 = time.perf_counter()
            sim = run_lifecycle(root, ["-n", "dl", "-m", "0"])
            seconds = time.perf_counter() - t0
            if isinstance(sim.engine, DomainHipscEngine) != (key == "domain"):
                raise AssertionError(f"domain phase f: {key} run on {type(sim.engine)}")
            state = sim.engine.to_cell_state(sim.state) if key == "domain" else sim.state
            runs[key] = (convert.state_to_numpy(state), seconds)
        finally:
            shutil.rmtree(root, ignore_errors=True)
    summary = domain_equal(runs["domain"][0], runs["single"][0], "domain phase f")
    print(f"domain phase f: lifecycle, shipped templates, {DOMAIN_LIFECYCLE_STEPS} steps, "
          f"domain_tiles {list(DOMAIN_TILES)} against one engine: {summary}; "
          f"{runs['domain'][1]:.2f} s / {runs['single'][1]:.2f} s")
    return dict(domain_s=runs["domain"][1], single_s=runs["single"][1])


def domain_phase() -> dict:
    """Phase 11, the domain-decomposed engine (see the module docstring)."""
    out = {"a": domain_against_single(2, N_MAIN, {"n_stripes": DOMAIN_STRIPES},
                                      DOMAIN_STEPS, "a")}
    out["b_d"] = domain_card_vs_cpu()
    out["c"] = domain_against_single(3, N_MAIN_3D, {"n_stripes": 2}, DOMAIN_STEPS_3D, "c")
    out["e"] = domain_timing()
    out["f"] = domain_lifecycle()
    return out


def multiprocess_route(label: str, args: list, route_kernels, backend: str = "gloo") -> dict:
    """The domain engine over ``MP_WORLD`` processes on the card
    (``tools.multihost_domain``: the JAX payload's sequence, every check on
    rank 0 against the single engine and one controller on the card), with
    a deadline; each kernel of ``route_kernels`` must have launched on the
    route (the ranks' counts, set to 0 just before each call of an engine
    under test and read just after, summed over the ranks)."""
    from hipsc_abm_tpu_torch.tools import multihost_domain

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    workdir = tempfile.mkdtemp(prefix="hipsc_mp_")
    t0 = time.perf_counter()
    try:
        outs = multihost_domain.run_ranks(MP_WORLD, workdir,
                                          ["--device", "cuda", "--backend", backend,
                                           "--seed", str(SEED), *args],
                                          timeout_s=MP_DEADLINE_S)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    seconds = time.perf_counter() - t0
    if "MULTIHOST OK" not in outs[0]:
        raise AssertionError(f"{label}: rank 0 did not finish its checks\n{outs[0][-3000:]}")
    for line in outs[0].splitlines():
        if line.startswith(("rank 0: ", "MULTIHOST OK")):
            print(f"{label}: {line}")
    res = multihost_domain.results(outs)
    launches = {}
    for r in res:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    missing = [k for k in route_kernels if not launches.get(k)]
    if missing:
        raise AssertionError(f"{label}: kernels {missing} never launched on the route "
                             f"({launches})")
    ranks = []
    for r in res:
        steps = r["timed_steps"]
        ranks.append(dict(
            rank=r["rank"], tiles=r["local_tiles"], median_ms=r["median_ms"],
            p90_ms=r["p90_ms"], exchange_bytes_per_step=float(np.median(r["exchange_bytes"])),
            rank_bytes_per_step=float(np.median(r["rank_bytes"])),
            staged_bytes_per_step=float(np.median(r["staged_bytes"])),
            collectives_per_step=float(np.median(r["collectives"])),
            peak_mib=r["peak_mib"], launches=r["launches"]))
        print(f"{label}: rank {r['rank']} (tiles {r['local_tiles']}, {r['agents']} agents in "
              f"all) over {steps} timed safe_steps: median {r['median_ms']:.3f} ms, p90 "
              f"{r['p90_ms']:.3f} ms; per step {ranks[-1]['exchange_bytes_per_step']:.0f} B "
              f"copied between its own tiles, {ranks[-1]['rank_bytes_per_step']:.0f} B "
              f"received from the other rank, {ranks[-1]['staged_bytes_per_step']:.0f} B "
              f"staged through pinned host memory, "
              f"{ranks[-1]['collectives_per_step']:.0f} collectives; peak "
              f"{r['peak_mib']:.1f} MiB")
    print(f"{label}: {seconds:.2f} s in all; launches over both ranks {launches}")
    return dict(seconds=seconds, backend=backend, ranks=ranks, launches=launches,
                agents=res[0]["agents"])


def shard_states_check() -> dict:
    """Phase 12 c: ``ENSEMBLE_R`` replicates of phase 9's colony in
    ``SHARD_GROUPS`` groups on the one card (``shard_states``), each group
    one captured graph; every replicate bit-equal (``compare_bits``) to the
    unsharded ensemble's, and the first replicate of each group to its solo
    run."""
    from hipsc_abm_tpu_torch import convert
    from hipsc_abm_tpu_torch.parallel.ensemble import EnsembleEngine

    seeds = list(range(ENSEMBLE_R))
    ens, plain = EnsembleEngine(ensemble_engine("cuda")), EnsembleEngine(ensemble_engine("cuda"))
    states = seed_lattices(ens.init_states(seeds), seeds, ens.engine.diff)
    unsharded = seed_lattices(plain.init_states(seeds), seeds, plain.engine.diff)
    sharded = EnsembleEngine.shard_states(states, [torch.device("cuda", 0)] * SHARD_GROUPS)
    firsts = np.cumsum([0] + [g.alive.shape[0] for g in sharded.groups[:-1]]).tolist()
    solos = []
    for i in firsts:
        eng = ensemble_engine("cuda")
        eng.cfg = ens.engine.cfg
        solos.append((i, eng, solo_state(eng, seeds[i])))
    t0 = time.perf_counter()
    for _ in range(SHARD_STEPS):
        sharded, _ = ens.safe_step(sharded)
    torch.cuda.synchronize()
    t_sharded = time.perf_counter() - t0
    for _ in range(SHARD_STEPS):
        unsharded, _ = plain.safe_step(unsharded)
        solos = [(i, e, e.safe_step(s)[0]) for i, e, s in solos]
    for i in range(len(seeds)):
        summary = compare_bits(convert.state_to_numpy(EnsembleEngine.replicate(sharded, i)),
                               convert.state_to_numpy(EnsembleEngine.replicate(unsharded, i)),
                               f"multiprocess phase c shard_states replicate {i}")
    for i, _, solo in solos:
        compare_bits(convert.state_to_numpy(EnsembleEngine.replicate(sharded, i)),
                     convert.state_to_numpy(solo), f"multiprocess phase c solo {i}")
    graphs = ens.graphs()
    print(f"multiprocess phase c shard_states: {len(seeds)} x {N_ENSEMBLE} replicates in "
          f"{SHARD_GROUPS} groups on the one card, {SHARD_STEPS} safe_steps ({t_sharded:.2f} s, "
          f"captures included; graphs (R, capture s) "
          f"{[(g['replicates'], round(g['capture_s'], 2)) for g in graphs]}): each replicate "
          f"bit-equal to the unsharded ensemble's (last: {summary}), replicates {firsts} to "
          "their solo runs")
    del ens, plain, sharded, unsharded, solos
    torch.cuda.empty_cache()
    return dict(replicates=len(seeds), groups=SHARD_GROUPS, steps=SHARD_STEPS,
                seconds=t_sharded)


def mesh_check() -> dict:
    """Phase 12 c: ``parallel.mesh.ShardedHipscEngine`` over ``MESH_CHUNKS``
    chunks on the one card at the 2D 100k bench colony, ``MESH_STEPS``
    ``safe_step``s bit-equal (``compare_bits``) to the single engine."""
    from hipsc_abm_tpu_torch import convert
    from hipsc_abm_tpu_torch.parallel.mesh import ShardedHipscEngine, gather_state, make_mesh

    eng, state = engine_for(2, N_MAIN, "cuda", "id_list")
    mesh = make_mesh(MESH_CHUNKS, device="cuda")
    sharded = ShardedHipscEngine(eng.gen, eng.xp, eng.bio, eng.diff, cfg=eng.cfg, mesh=mesh)
    chunks = sharded.init_state(seed=SEED)
    if sharded.cfg.capacity != eng.cfg.capacity:
        eng.cfg = dataclasses.replace(eng.cfg, capacity=sharded.cfg.capacity)
        state = eng.init_state(seed=SEED)
    t0 = time.perf_counter()
    for _ in range(MESH_STEPS):
        chunks, _ = sharded.safe_step(chunks)
    torch.cuda.synchronize()
    t_mesh = time.perf_counter() - t0
    for _ in range(MESH_STEPS):
        state, _ = eng.safe_step(state)
    summary = compare_bits(convert.state_to_numpy(gather_state(chunks, "cuda")),
                           convert.state_to_numpy(state), "multiprocess phase c mesh")
    print(f"multiprocess phase c ShardedHipscEngine [2D, {N_MAIN}, {len(chunks.chunks)} chunks "
          f"on {sorted(set(map(str, mesh)))}]: {MESH_STEPS} safe_steps ({t_mesh:.2f} s) against "
          f"the single engine: {summary}")
    del eng, sharded, chunks, state
    torch.cuda.empty_cache()
    return dict(chunks=MESH_CHUNKS, steps=MESH_STEPS, seconds=t_mesh)


def domain_forces_check() -> dict:
    """Phase 12 c: ``parallel.domain.domain_forces`` at the JAX test's colony
    (300 agents in 8 stripes of a 400 um box) on the card, against the
    all-pairs oracle (``DOMAIN_FORCES_RTOL``, atol 1e-14: the halo sums add
    the pairs in another order) and against the same call on the CPU."""
    from hipsc_abm_tpu_torch.ops.jkr import _pair_jkr
    from hipsc_abm_tpu_torch.params import BiologyParams
    from hipsc_abm_tpu_torch.parallel.domain import (
        domain_forces, make_stripe_mesh, partition_by_stripe)

    bio = BiologyParams()
    rng = np.random.default_rng(1234)
    n, n_stripes, per_stripe, box_x = 300, 8, 64, 400.0
    loc = np.zeros((n, 3), np.float32)
    loc[:, 0] = rng.random(n) * box_x
    loc[:, 1] = rng.random(n) * 100.0
    sloc, salive, sgid = partition_by_stripe(loc, np.ones(n, bool), box_x, n_stripes,
                                             per_stripe)

    def run(device):
        devs = make_stripe_mesh(n_stripes, device=device)
        out = domain_forces([torch.from_numpy(sloc[s]).to(d) for s, d in enumerate(devs)],
                            [torch.from_numpy(salive[s]).to(d) for s, d in enumerate(devs)],
                            [torch.full((per_stripe,), 5.0, device=d) for d in devs], box_x, bio)
        return np.stack([f.cpu().numpy() for f in out])

    card, cpu = run("cuda"), run("cpu")
    x = torch.from_numpy(loc)
    delta = x[:, None, :] - x[None, :, :]
    ok = ~torch.eye(n, dtype=torch.bool) & ((delta * delta).sum(-1) <= bio.jkr_radius ** 2)
    r = torch.full((n,), 5.0)
    force, _ = _pair_jkr(x[:, None, :], x[None, :, :], r[:, None], r[None, :],
                         bio.adhesion_const, bio.poisson, bio.youngs, bio.jkr_break_d)
    oracle = torch.where(ok[..., None], force, 0.0).sum(dim=1).numpy()
    own = sgid >= 0
    np.testing.assert_allclose(card[own], oracle[sgid[own]], rtol=DOMAIN_FORCES_RTOL, atol=1e-14)
    np.testing.assert_allclose(card, cpu, rtol=DOMAIN_FORCES_RTOL, atol=1e-14)
    if (card[~own] != 0).any():
        raise AssertionError("domain_forces: a padding slot has a force")
    err = float(np.abs(card - cpu).max())
    print(f"multiprocess phase c domain_forces [{n} agents, {n_stripes} stripes on the card]: "
          f"against the all-pairs oracle and the CPU within rtol {DOMAIN_FORCES_RTOL} "
          f"(card vs CPU max|d| {err:.3e} N)")
    return dict(agents=n, stripes=n_stripes, card_vs_cpu_max_abs=err)


def nccl_phase() -> dict:
    """Phase 12 d: NCCL with two ranks on one card is refused before NCCL is
    initialised; with a card per rank, phase a's route over NCCL."""
    from hipsc_abm_tpu_torch.parallel import distributed

    cards = torch.cuda.device_count()
    try:
        distributed.init_process_group("nccl", "tcp://127.0.0.1:1", 0, cards + 1,
                                       device="cuda:0")
    except RuntimeError as err:
        if "one card per rank" not in str(err) or torch.distributed.is_initialized():
            raise
        print(f"multiprocess phase d: backend nccl with {cards + 1} ranks on {cards} card(s) "
              f"raised before NCCL started: {err}")
    else:
        raise AssertionError("multiprocess phase d: nccl with more ranks than cards did not "
                             "raise")
    if cards < MP_WORLD:
        print(f"multiprocess phase d: nccl not run: {cards} card")
        return dict(nccl=None)
    return dict(nccl=multiprocess_route(
        "multiprocess phase d [nccl]", ["--cells", str(N_LARGE), "--tiles",
                                        *map(str, DOMAIN_TILES), "--steps", str(MP_STEPS),
                                        "--timed", str(MP_TIMED)],
        PATH_KERNELS[(2, "span_mask")], backend="nccl"))


def multiprocess_phase() -> dict:
    """Phase 12, the domain engine over processes (see the module
    docstring)."""
    tiles = ["--tiles", *map(str, DOMAIN_TILES)]
    out = {"a": multiprocess_route(
        f"multiprocess phase a [2D, {N_LARGE}, {MP_WORLD} ranks x tiles {DOMAIN_TILES}, gloo]",
        ["--cells", str(N_LARGE), *tiles, "--steps", str(MP_STEPS), "--timed", str(MP_TIMED)],
        PATH_KERNELS[(2, "span_mask")])}
    out["b"] = multiprocess_route(
        f"multiprocess phase b [2D, {N_STEP_CHECK}, id_list, {MP_WORLD} ranks, gloo]",
        ["--cells", str(N_STEP_CHECK), *tiles, "--path", "id_list", "--steps", "2",
         "--timed", str(MP_TIMED)], PATH_KERNELS[(2, "id_list")])
    out["c"] = dict(shard_states=shard_states_check(), mesh=mesh_check(),
                    domain_forces=domain_forces_check())
    out["d"] = nccl_phase()
    return out


def examples_phase() -> dict:
    """Phase 13, the examples on the card (see the module docstring)."""
    from hipsc_abm_tpu_torch import kernels
    from hipsc_abm_tpu_torch.examples import chemotaxis, minimal_abm, run, spheroid_3d
    from hipsc_abm_tpu_torch.utils.profiling import device_trace

    out = {}
    root = tempfile.mkdtemp(prefix="hipsc_examples_")
    cwd = os.getcwd()
    try:
        # chemotaxis: 3 steps on the card and on the CPU from one colony
        small = dict(num_to_start=40, cuda=False, end_step=CHEMO_STEPS, size=[300, 300, 0],
                     output_values=True, output_images=False, record_initial_step=False,
                     image_quality=100, video_quality=80, fps=5, seed=0)
        small_xp = dict(num_gata6=4, output_tda=False, output_gradients=False, group=0,
                        dox_step=1, guye_move=False, lonely_thresh=2, color_mode=True)
        sims = {}
        for i, device in enumerate(("cuda", "cpu")):
            d = os.path.join(root, f"chemotaxis_{i}")
            write_templates(d, small, small_xp)
            os.chdir(d)
            kernels.launch_counts.clear()
            with contextlib.redirect_stdout(io.StringIO()):
                sims[device] = chemotaxis.Chemotaxis.start(os.path.join(d, "outputs"),
                                                           argv=["-n", "fg", "-m", "0"],
                                                           device=device)
            if i == 0:
                counts = dict(kernels.launch_counts)
                card = sims.pop(device)
        cpu = sims["cpu"]
        if counts.get("ftcs_diffuse") != CHEMO_STEPS or counts.get("deposit") != CHEMO_STEPS:
            raise AssertionError(f"examples phase chemotaxis: launches {counts}")
        loc_err = float(np.abs(card.locations - cpu.locations).max())
        field_err = float(np.abs(card.attractant.cpu().numpy() - cpu.attractant.numpy()).max())
        if not (loc_err <= CHEMO_LOC_ATOL and field_err <= CHEMO_FIELD_ATOL):
            raise AssertionError(f"examples phase chemotaxis: card vs CPU positions "
                                 f"{loc_err}, field {field_err}")
        print(f"examples phase chemotaxis: {CHEMO_STEPS} steps, card against CPU: positions "
              f"max|d| {loc_err:.3e} um, field max|d| {field_err:.3e}; launches {counts}")
        out["chemotaxis"] = dict(steps=CHEMO_STEPS, loc_err=loc_err, field_err=field_err,
                                 launches=counts)

        # the 3D spheroid example at its own size
        kernels.launch_counts.clear()
        t0 = time.perf_counter()
        _, _, stats = spheroid_3d.run(n_cells=3000, n_gata6=300, steps=3,
                                      out_dir=os.path.join(root, "spheroid"), device="cuda")
        counts = dict(kernels.launch_counts)
        seconds = time.perf_counter() - t0
        pngs = sorted(f for f in os.listdir(os.path.join(root, "spheroid")) if f.endswith(".png"))
        if (pngs != ["spheroid_xy.png", "spheroid_xz.png"] or stats["population"] < N_SPHEROID
                or not counts.get("contact_substep_3d") or not counts.get("bio_moments_3d")):
            raise AssertionError(f"examples phase spheroid_3d: {stats} {pngs} {counts}")
        print(f"examples phase spheroid_3d: {N_SPHEROID} cells, 3 steps in {seconds:.2f} s: "
              f"{stats}; {pngs}; launches {counts}")
        out["spheroid_3d"] = dict(stats, seconds=seconds)

        # minimal_abm and run.py mode 0 (the shipped templates), 2 steps each
        d = os.path.join(root, "minimal")
        write_templates(d, dict(small, end_step=EXAMPLE_STEPS), small_xp)
        os.chdir(d)
        with contextlib.redirect_stdout(io.StringIO()):
            walkers = minimal_abm.RandomWalkers.start(os.path.join(d, "outputs"),
                                                      argv=["-n", "rw", "-m", "0"],
                                                      device="cuda")
        vals = os.path.join(d, "outputs", "rw", "rw_values", f"rw_values_{EXAMPLE_STEPS}.csv")
        if walkers.number_agents != 40 or not os.path.isfile(vals):
            raise AssertionError("examples phase minimal_abm: no values CSV")
        d = os.path.join(root, "run")
        write_templates(d, dict(LIFECYCLE_GENERAL, end_step=EXAMPLE_STEPS),
                        LIFECYCLE_EXPERIMENTAL)
        os.chdir(d)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            sim = run.main(["-n", "ex", "-m", "0"], output_dir=os.path.join(d, "outputs"))
        seconds = time.perf_counter() - t0
        vals = os.path.join(d, "outputs", "ex", "ex_values", f"ex_values_{EXAMPLE_STEPS}.csv")
        if sim.device.type != "cuda" or not os.path.isfile(vals):
            raise AssertionError("examples phase run: no values CSV on the card")
        print(f"examples phase minimal_abm: 40 walkers, {EXAMPLE_STEPS} steps on the card; run.py "
              f"mode 0 on the shipped templates: {sim.number_agents} agents after "
              f"{EXAMPLE_STEPS} steps in {seconds:.2f} s")
        out["run"] = dict(agents=sim.number_agents, seconds=seconds)
    finally:
        os.chdir(cwd)
        shutil.rmtree(root, ignore_errors=True)

    # device_trace around one safe_step (a graph replay) of a warmed engine
    eng, state = engine_for(2, N_STEP_CHECK, "cuda", "id_list")
    state, _ = eng.safe_step(state)
    trace_dir = tempfile.mkdtemp(prefix="hipsc_trace_")
    try:
        with device_trace(trace_dir):
            state, _ = eng.safe_step(state)
        files = os.listdir(trace_dir)
        text = "".join(open(os.path.join(trace_dir, f)).read() for f in files)
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    named = [k for k in ("contact_substep_kernel", "contact_mask_kernel") if k in text]
    if len(files) != 1 or not named:
        raise AssertionError(f"examples phase device_trace: {files}, kernels named {named}")
    print(f"examples phase device_trace: one safe_step traced into {files[0]} "
          f"({len(text)} bytes), naming {named}")
    out["device_trace"] = dict(bytes=len(text), named=named)
    del eng, state
    torch.cuda.empty_cache()
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
    print(json.dumps({"window": phase("window", window_phase)}))
    results += phase("probes", probe_phase)
    print(json.dumps({"draws": phase("draws", draws_phase)}))

    phase("step", step_phase)
    print(json.dumps({"exact": phase("exact 100k", step_exact_phase)}))
    print(json.dumps({"exact_general": phase("exact 100k general", step_exact_phase,
                                             optional=True)}))
    print(json.dumps({"powf": phase("powf", powf_phase)}))
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
    # calibration: gradients through the plain path, ES populations as
    # captured ensembles, the example
    print(json.dumps({"calibration": phase("calibration", calibration_phase)}))
    # the domain-decomposed engine: stripes and tiles on the card against the
    # single engine and against the CPU, the timed 500k tiles, the lifecycle
    domain = phase("domain", domain_phase)
    e = domain["e"]
    print(json.dumps({"domain": {
        "a": {k: v for k, v in domain["a"].items() if k != "counts"},
        "b_d": {k: v for k, v in domain["b_d"].items() if k not in ("counts", "entries")},
        "c": {k: v for k, v in domain["c"].items() if k != "counts"},
        "e": {k: v for k, v in e.items() if k not in ("counts", "entries")},
        "f": domain["f"]}}))
    # the domain engine over processes, and the cross-checks of the last
    # ported modules; then the examples and device_trace
    mp = phase("multiprocess", multiprocess_phase)
    print(json.dumps({"multiprocess": {
        "a": {k: v for k, v in mp["a"].items() if k != "launches"},
        "b": {k: v for k, v in mp["b"].items() if k != "launches"},
        "c": mp["c"],
        "d": {"nccl": None if mp["d"]["nccl"] is None else {
            k: v for k, v in mp["d"]["nccl"].items() if k != "launches"}}}}))
    print(json.dumps({"examples": phase("examples", examples_phase)}))
    # each kernel's launches on the domain path: the timed 500k tiles in 2D,
    # the 3D stripes (c), and B6 on the id-list step (d)
    domain_counts = {**domain["c"]["counts"], **e["counts"],
                     "contact_substep": domain["b_d"]["counts"]["contact_substep"]}
    n_tiles = DOMAIN_TILES[0] * DOMAIN_TILES[1]
    for r in domain["b_d"]["entries"] + e["entries"]:
        base = r["name"].split("[")[0]
        r["launches"] = domain_counts.get(base, 0)
        r["taken_launches"] = (r["launches"] if base == "contact_substep" else taken_launches(
            base, r["launches"], n_tiles * e["attempts"], n_tiles * e["rebuilds"],
            e["substeps"]))
        results.append(r)
    # each kernel's launches on the multi-process route, over both ranks: the
    # 500k span-mask route (a), and B6 on the id-list route (b)
    mp_counts = {**mp["a"]["launches"],
                 "contact_substep": mp["b"]["launches"].get("contact_substep", 0)}
    for r in results:  # the domain runs took the uniform law only
        r["domain_launches"] = (0 if r.get("law") == "general"
                                else domain_counts.get(r["name"].split("[")[0], 0))
        r["multiprocess_launches"] = (0 if r.get("law") == "general"
                                      else mp_counts.get(r["name"].split("[")[0], 0))
        if "launches" in r:  # the probes count their own entry points; the tile entries
            r.setdefault("taken_launches", r["launches"])
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
        r["launches"] = run["counts"].get(base, 0)
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
