"""PyTorch port: the domain engine spread over processes
(``parallel.distributed``), on the CPU over gloo.

The payload ``hipsc_abm_tpu_torch.tools.multihost_domain`` runs in 2 or 4
processes, one rank each, at the JAX payload's colony (1,000 + 100 cells in
a 1,400 um box, FGF4 secretion and diffusion on) and, in 3D, at a 700-cell
spheroid. Each rank steps its own block of tiles; rank 0 holds every step,
the resume from the sharded checkpoint, the growth from undersized
capacities and the rebalance against the single engine and against one
controller over the same tiles, bit-equal by agent id (integers, positions,
radii, bond sets), the lattice bit-equal to one controller's and within
1e-5 of the single engine's (the tile deltas are summed in tile order).
The payload prints ``MULTIHOST OK`` only when every check held. Each run
has a deadline; a rank that fails kills the others and fails the test.
"""

import subprocess
import sys

import pytest
import torch

from hipsc_abm_tpu_torch.parallel import distributed
from hipsc_abm_tpu_torch.tools import multihost_domain

CASES = {
    "2x2-2proc": (2, ["--tiles", "2", "2"]),
    "stripes4-4proc": (4, ["--tiles", "4", "1"]),
    # 3D tiles carry wide bands (the halo grows to 768 rows): fewer steps
    "3d-stripes2-2proc": (2, ["--tiles", "2", "1", "--dims", "3", "--steps", "2"]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_payload_bit_equal_to_one_controller_and_the_single_engine(case, tmp_path):
    world, args = CASES[case]
    outs = multihost_domain.run_ranks(world, str(tmp_path), ["--device", "cpu", *args],
                                      timeout_s=180)
    assert "MULTIHOST OK" in outs[0], outs[0][-3000:]
    res = multihost_domain.results(outs)
    assert [r["rank"] for r in res] == list(range(world))
    tiles = [s for r in res for s in r["local_tiles"]]
    assert tiles == sorted(tiles) == list(range(len(tiles)))  # contiguous blocks, in order
    assert len({r["agents"] for r in res}) == 1  # every rank saw the same colony


def test_a_failed_rank_fails_the_run(tmp_path):
    # 3 tiles do not split over 2 ranks: every rank raises before stepping
    with pytest.raises(RuntimeError, match="failed"):
        multihost_domain.run_ranks(2, str(tmp_path), ["--device", "cpu", "--tiles", "3", "1"],
                                   timeout_s=120)


DIVERGE = """
import sys
from hipsc_abm_tpu_torch.parallel import distributed
rank = int(sys.argv[1])
group = distributed.init_process_group("gloo", sys.argv[2], rank, 2, device="cpu")
transport = distributed.Transport(group, 2, "cpu")
try:
    transport.agree(3 + rank, "a test")
except RuntimeError as err:
    print("DIVERGED", err)
"""


def test_ranks_at_different_collectives_raise(tmp_path):
    """Two ranks about to issue different collectives both raise instead of
    exchanging mismatched bytes."""
    init = f"tcp://127.0.0.1:{multihost_domain.free_port()}"
    env = distributed.loopback_env()
    env["PYTHONPATH"] = multihost_domain.ROOT
    procs = [subprocess.Popen([sys.executable, "-c", DIVERGE, str(r), init], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    for out in outs:
        assert "DIVERGED" in out and "codes by rank [3, 4]" in out, out[-2000:]


def test_backend_nccl_on_cpu_raises():
    """NCCL is refused before it is initialised: on the CPU, and for more
    ranks than cards (there is no card here)."""
    with pytest.raises(RuntimeError, match="nccl"):
        distributed.init_process_group("nccl", "tcp://127.0.0.1:1", 0, 2, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        distributed.init_process_group("nccl", "tcp://127.0.0.1:1", 0, 2, device="cuda")
    with pytest.raises(ValueError, match="backend"):
        distributed.init_process_group("mpi", "tcp://127.0.0.1:1", 0, 2, device="cpu")
    assert not torch.distributed.is_initialized()
