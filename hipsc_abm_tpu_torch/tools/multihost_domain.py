"""The domain engine across processes: one rank per process, each the
controller of its own block of tiles, checked against one controller and
the single engine (port of ``tools/multihost_domain.py``, whose
``jax.distributed`` mesh becomes a ``torch.distributed`` process group).

Each rank runs::

    python -m hipsc_abm_tpu_torch.tools.multihost_domain <rank> <world> <port> <dir>
        [--device cpu|cuda] [--backend gloo|nccl] [--cells N] [--tiles TX TY]
        [--dims 2|3] [--path span_mask|id_list] [--steps K] [--timed K] [--seed S]

and ``run_ranks`` starts them all on this machine (``tcp://127.0.0.1:<port>``)
and waits with a deadline. The colony is the JAX payload's (1,000 + 100 cells
in a 1,400 um box, seed 11 unless ``--seed``) with FGF4 secretion and
diffusion on; ``--cells N`` takes the bench colony (``colonies.bench_params``)
at N cells instead, and ``--dims 3`` the 3D spheroid example's ball
(``colonies.spheroid``, 700 cells unless ``--cells``).
The sequence is the JAX payload's:

1. ``--steps`` ``safe_step``s; after each, the colony by agent id bit-equal
   to the single engine's (integers, positions, radii, bond sets) and to one
   controller's over the same tiles, whose lattice it equals bit for bit
   (the single engine's within 1e-5: the tile deltas are summed in tile
   order);
2. ``save_checkpoint_sharded`` and ``write_values_sharded`` (each rank its
   own tiles), a barrier, and on rank 0 the merge, one row per agent;
3. a fresh engine resumed from the shards, stepped beside the original:
   bit-equal, lattice included;
4. growth from ``halo_cap=8, mig_cap=8`` and a drift allowance of 2 um
   inside ``safe_step``, a re-execution at least, against the single engine;
5. ``rebalance`` and a step, against the single engine and one controller
   (the lattice within 1e-5 of both: the tiles have moved);
6. on rank 0 the checkpoint reassembled and held against the single engine.

With ``--timed K``, K more ``safe_step``s are timed after the references are
freed. Every rank prints a ``MULTIHOST RESULT`` JSON line (its launches of
each kernel over the engines under test, its times, bytes, collectives and
peak memory) and rank 0 prints ``MULTIHOST OK ...`` last. The references run
on rank 0 only.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

from hipsc_abm_tpu_torch import colonies
from hipsc_abm_tpu_torch.colonies import assert_same
from hipsc_abm_tpu_torch.parallel.distributed import loopback_env

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# the JAX payload's colony, its seed (the default of ``--seed``) and the
# diffusion of the port's domain tests
PAYLOAD = dict(num_to_start=1000, num_gata6=100, size=1400.0, seed=11)
DIFF = dict(spat_res=25.0, diffuse_dt=6.0, diffuse_const=2.0, max_concentration=2.0,
            degradation=0.05, release_amount=0.02, uptake_amount=0.004)
LATTICE_ATOL = 1e-5
# the growth engine's undersized capacities (step 4)
GROW_FROM = dict(halo_cap=8, mig_cap=8, drift_allowance=2.0)


def free_port() -> int:
    """A port that was free a moment ago (bound, then released)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(world: int, workdir: str, args=(), timeout_s: float = 180.0) -> list:
    """Start ``world`` ranks of this tool on this machine with ``args``
    after the positional ones, and wait for all of them: returns each
    rank's output. A rank that fails, or a run past ``timeout_s``, kills
    every rank and raises with the outputs' ends."""
    port = free_port()
    env = loopback_env()
    env["PYTHONPATH"] = os.pathsep.join([ROOT] + [p for p in [env.get("PYTHONPATH")] if p])
    logs = [open(os.path.join(workdir, f"rank{r}.log"), "w+") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-u", "-m", "hipsc_abm_tpu_torch.tools.multihost_domain", str(r),
         str(world), str(port), workdir, *map(str, args)],
        stdout=logs[r], stderr=subprocess.STDOUT, env=env, cwd=ROOT) for r in range(world)]
    deadline = time.monotonic() + timeout_s
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            failed = next((r for r, p in enumerate(procs) if p.returncode not in (None, 0)),
                          None)
            if failed is not None or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        failed = next((r for r, p in enumerate(procs) if p.returncode not in (None, 0)),
                      failed)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        outs = []
        for f in logs:
            f.seek(0)
            outs.append(f.read())
            f.close()
    if failed is not None or any(p.returncode for p in procs):
        what = f"rank {failed} failed" if failed is not None else f"past {timeout_s} s"
        tails = "\n".join(f"--- rank {r} (exit {p.returncode}) ---\n{o[-3000:]}"
                          for r, (p, o) in enumerate(zip(procs, outs)))
        raise RuntimeError(f"multihost_domain: {what}\n{tails}")
    return outs


def results(outputs: list) -> list:
    """The ``MULTIHOST RESULT`` objects of the ranks' outputs, in rank order."""
    found = [json.loads(line.split(" ", 2)[2]) for out in outputs
             for line in out.splitlines() if line.startswith("MULTIHOST RESULT ")]
    return sorted(found, key=lambda r: r["rank"])


def colony(args):
    """``(gen, xp, diff, locations)`` of the run's colony."""
    if args.dims == 3:
        gen, xp, ball = colonies.spheroid(args.cells or 700, args.seed)
        return gen, xp, None, ball
    if args.cells:
        return (*colonies.bench_params(args.cells), None)
    from hipsc_abm_tpu_torch.params import DiffusionParams, ExperimentalParams, GeneralParams

    box = PAYLOAD["size"]
    return (GeneralParams(num_to_start=PAYLOAD["num_to_start"], end_step=6,
                          size=(box, box, 0.0)),
            ExperimentalParams(num_gata6=PAYLOAD["num_gata6"], dox_step=2),
            DiffusionParams(**DIFF), None)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("rank", type=int)
    p.add_argument("world", type=int)
    p.add_argument("port", type=int)
    p.add_argument("dir")
    p.add_argument("--device", default="cuda")
    p.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    p.add_argument("--cells", type=int, default=0)
    p.add_argument("--tiles", type=int, nargs=2, default=None)
    p.add_argument("--dims", type=int, default=2, choices=(2, 3))
    p.add_argument("--path", default="span_mask", choices=("span_mask", "id_list"))
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--timed", type=int, default=0)
    p.add_argument("--seed", type=int, default=PAYLOAD["seed"])
    args = p.parse_args(argv)
    if args.steps < 2:
        p.error("--steps must be at least 2 (growth and rebalance compare with steps 1-2)")

    from hipsc_abm_tpu_torch.parallel import distributed

    dev = torch.device(args.device)
    if dev.type == "cpu":
        # the small ops of a tile step are slower on a thread pool that
        # other processes share
        torch.set_num_threads(1)
    elif dev.index is None:
        dev = torch.device("cuda", args.rank % torch.cuda.device_count())
    group = distributed.init_process_group(args.backend, f"tcp://127.0.0.1:{args.port}",
                                           args.rank, args.world, device=dev)
    try:
        run(args, group, dev)
    finally:
        torch.distributed.destroy_process_group()


def run(args, group, dev) -> None:
    from hipsc_abm_tpu_torch import convert, kernels
    from hipsc_abm_tpu_torch.engine import HipscEngine
    from hipsc_abm_tpu_torch.parallel import DomainHipscEngine
    from hipsc_abm_tpu_torch.utils import checkpoint as ckpt
    from hipsc_abm_tpu_torch.utils import io as io_utils

    rank, world = args.rank, args.world
    gen, xp, diff, locations = colony(args)
    tiles = tuple(args.tiles) if args.tiles else (2 * world, 2)

    def domain(**kw):
        return DomainHipscEngine(gen, xp, diff=diff, enable_diffusion=diff is not None,
                                 tiles=tiles, device=dev, contact_path=args.path, **kw)

    route = collections.Counter()

    def on_route(fn, *a):
        """``fn(*a)`` with its kernel launches added to the route's counts
        (the counts set to 0 just before and read just after)."""
        kernels.launch_counts.clear()
        out = fn(*a)
        route.update(kernels.launch_counts)
        kernels.launch_counts.clear()
        return out

    def flat(eng, dstate) -> dict:
        return convert.state_to_numpy(eng.to_cell_state(dstate))

    t_start = time.perf_counter()

    def log(msg):
        print(f"rank {rank}: [{time.perf_counter() - t_start:.1f} s] {msg}", flush=True)

    seed = args.seed
    dom = domain(rank=rank, world=world)  # the default group, named by rank and world
    S = dom.cfg.n_stripes
    dstate = dom.init_state(seed=seed, locations=locations)
    ref = rank == 0
    if ref:
        single = HipscEngine(gen, xp, diff=diff, cfg=dom.cfg.base, device=dev)
        sstate = single.init_state(seed=seed, locations=locations)
        ctrl = domain()
        cstate = ctrl.init_state(seed=seed, locations=locations)
        snaps = []

    def check(label, d, n_step_info):
        """Rank 0: the spread run's flat state ``d`` against the single
        engine and one controller, stepped once more."""
        nonlocal sstate, cstate
        sstate, sinfo = single.safe_step(sstate)
        cstate, cinfo = ctrl.safe_step(cstate)
        for f in ("num_agents", "num_added", "num_removed"):
            vals = {int(getattr(i, f)) for i in (n_step_info, sinfo, cinfo)}
            if len(vals) != 1:
                raise AssertionError(f"{label}: {f} differs {vals}")
        s_flat, c_flat = convert.state_to_numpy(sstate), flat(ctrl, cstate)
        summary = assert_same(d, s_flat, f"{label} vs single", lattice_atol=LATTICE_ATOL)
        log(f"{label}: against the single engine {summary}; against one controller "
            + assert_same(d, c_flat, f"{label} vs one controller"))
        return s_flat, c_flat

    # 1. steps, each checked
    for step in range(args.steps):
        dstate, dinfo = on_route(dom.safe_step, dstate)
        d = flat(dom, dstate)
        if ref:
            snaps.append(check(f"step {step + 1}", d, dinfo))
        log(f"step {step + 1}: {int(dinfo.num_agents)} agents, {dom.attempts} attempt(s)")

    # 2. sharded checkpoint and value CSVs: each rank its own tiles
    ck, vals = os.path.join(args.dir, "ck"), os.path.join(args.dir, "vals")
    dom.save_checkpoint_sharded(ck, dstate)
    written = dom.write_values_sharded(vals, "pod", args.steps, dstate)
    if len(written) != S // world:
        raise AssertionError(f"wrote {len(written)} value shards, own {S // world} tiles")
    dom.transport.barrier()
    if ref:
        merged = io_utils.merge_sharded_values(vals, "pod", args.steps, n_shards=S)
        with open(merged, "rb") as f:
            n_rows = sum(1 for _ in f) - 1
        if n_rows != int(dinfo.num_agents):
            raise AssertionError(f"merged values hold {n_rows} rows, {dinfo.num_agents} agents")
        log(f"sharded values merged: {n_rows} rows")

    # 3. resume from the shards on a fresh engine, beside the original
    dom2 = domain(process_group=group)
    rstate = dom2.load_checkpoint_sharded(ck)
    rstate, rinfo = on_route(dom2.safe_step, rstate)
    dstate, dinfo = on_route(dom.safe_step, dstate)
    r_flat, d = flat(dom2, rstate), flat(dom, dstate)
    assert_same(r_flat, d, "resume vs original")
    if ref:
        check("resume step", d, dinfo)
    log(f"resume step: {int(rinfo.num_agents)} agents, bit-equal to the original")

    # 4. growth inside safe_step from undersized capacities: the halo rows
    # (rounded up to 128 rows at construction), the migration rows and the
    # drift allowance, which the payload's 2D colony exceeds in its first step
    domg = domain(process_group=group, **GROW_FROM)
    cfg0 = domg.cfg
    gstate = domg.init_state(seed=seed, locations=locations)
    gstate, ginfo = on_route(domg.safe_step, gstate)
    grown = {k: (getattr(cfg0, k), getattr(domg.cfg, k)) for k in GROW_FROM
             if getattr(domg.cfg, k) != getattr(cfg0, k)}
    if domg.attempts < 2 or not grown:
        raise AssertionError(f"growth never tripped ({domg.attempts} attempt(s))")
    g = flat(domg, gstate)
    if ref:
        assert_same(g, snaps[0][0], "growth vs single", lattice_atol=LATTICE_ATOL)
        assert_same(g, snaps[0][1], "growth vs one controller")
    log(f"growth: {domg.attempts} attempts, grown (from, to) {grown}")

    # 5. rebalance (gathers the colony on every rank) and a step
    gstate = domg.rebalance(gstate)
    gstate, _ = on_route(domg.safe_step, gstate)
    g = flat(domg, gstate)
    if ref:
        # the rebalanced tiles are not one controller's: their deposit
        # deltas sum to the lattice in another rounding
        assert_same(g, snaps[1][0], "rebalance vs single", lattice_atol=LATTICE_ATOL)
        assert_same(g, snaps[1][1], "rebalance vs one controller", lattice_atol=LATTICE_ATOL)
    log(f"rebalance + step: col bounds {list(domg.cfg.col_bounds)}")

    # 6. the checkpoint reassembled against the single engine
    if ref:
        state, _ = ckpt.load_domain_sharded(ck, device="cpu")
        summary = assert_same(convert.state_to_numpy(state), snaps[args.steps - 1][0],
                              "checkpoint vs single", lattice_atol=LATTICE_ATOL)
        assert_same(convert.state_to_numpy(state), snaps[args.steps - 1][1],
                    "checkpoint vs one controller")
        del single, ctrl, sstate, cstate, snaps
    del dom2, domg, rstate, gstate

    out = dict(rank=rank, world=world, backend=dom.transport.backend,
               device=str(dev), tiles=list(tiles), local_tiles=dom.tiles,
               agents=int(dinfo.num_agents), per_stripe=dom.cfg.per_stripe,
               halo_cap=dom.cfg.halo_cap)
    if args.timed:
        dom.transport.barrier()  # rank 0's checks above are not timed on the others
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        tr = dom.transport
        ms, staged, colls, ex, rk = [], [], [], [], []
        for _ in range(args.timed):
            s0, c0 = tr.staged_bytes, tr.collectives
            t0 = time.perf_counter()
            dstate, _ = on_route(dom.safe_step, dstate)
            ms.append((time.perf_counter() - t0) * 1e3)
            staged.append(tr.staged_bytes - s0)
            colls.append(tr.collectives - c0)
            ex.append(sum(dom.exchange_bytes))
            rk.append(sum(dom.rank_bytes))
        out.update(timed_steps=args.timed, ms=ms, median_ms=float(np.median(ms)),
                   p90_ms=float(np.percentile(ms, 90)), exchange_bytes=ex, rank_bytes=rk,
                   staged_bytes=staged, collectives=colls, attempts=dom.attempts,
                   peak_mib=(torch.cuda.max_memory_allocated(dev) / 2**20
                             if dev.type == "cuda" else None))
    out["launches"] = dict(route)
    print("MULTIHOST RESULT " + json.dumps(out), flush=True)
    dom.transport.barrier()
    if ref:
        print(f"MULTIHOST OK: {world} processes over {dom.transport.backend}, {S} tiles "
              f"{list(tiles)}; the checkpoint against the single engine: {summary}", flush=True)


if __name__ == "__main__":
    main()
