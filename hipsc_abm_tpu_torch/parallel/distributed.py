"""The transport between the tiles of ``DomainHipscEngine`` when its tiles
are spread over several processes (ranks) of one ``torch.distributed``
process group.

This module has no counterpart file in the JAX package: there the domain
engine runs one controller per host under ``jax.distributed`` over one
global device mesh, and XLA inserts the cross-host collectives
(``hipsc_abm_tpu/parallel/domain_engine.py``, ``_host_replicated`` and
``_to_global``). Here each rank is a controller of its own block of tiles,
and ``Transport`` carries what crosses ranks:

- the owner map: tile ``s`` lives on rank ``s // (S / world)``, a contiguous
  block of tiles per rank (the JAX mesh's order, whose devices are sorted by
  process);
- one axis's point-to-point exchange as one ``dist.batch_isend_irecv``,
  the messages issued in one canonical order on every rank, each with a tag
  of its own (``exchange``);
- a gather of every tile's value in tile order (``gather_tiles``), so that
  float sums are taken in tile order on every rank, as the single controller
  takes them: a float is never summed by the backend (NCCL's ring order and
  gloo's differ from tile order); only maxima and sums of integers are
  all-reduced (``all_reduce_max``, ``all_reduce_sum_int``);
- a barrier, and ``agree``: every rank states what its next collective is,
  and a rank that would issue another one raises instead of hanging.

The backend is the caller's: ``init_process_group`` takes ``"gloo"`` or
``"nccl"`` and never picks or switches one. Under NCCL each rank needs a
card of its own, and two ranks on one card are refused before NCCL starts.
Under gloo, tensors on the card are staged through pinned host buffers,
explicitly: the packs are copied to the host, sent and received there, and
copied back to the card (gloo's transport takes host memory); the staged
bytes are counted in ``staged_bytes``. Each staged collective waits for the
card. Under NCCL and on the CPU nothing is staged.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")
# seconds a collective may wait for the other ranks before it fails
TIMEOUT_S = 120.0


def init_process_group(backend: str, init_method: str, rank: int, world: int,
                       device="cuda"):
    """Join the default process group (``init_method`` such as
    ``tcp://127.0.0.1:<port>``) with the given backend, rank and world size,
    and return it; every rank runs on this machine. ``device`` is this
    rank's device. NCCL needs CUDA and one card per rank: otherwise this
    raises before NCCL is initialised. A collective that waits longer than
    ``TIMEOUT_S`` fails."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a rank on device 'cuda' needs a CUDA device")
    if backend == "nccl":
        if device.type != "cuda":
            raise RuntimeError(f"backend 'nccl' needs ranks on CUDA devices, not {device}")
        cards = torch.cuda.device_count()
        if cards < world:
            raise RuntimeError(
                f"backend 'nccl' needs one card per rank: {world} ranks on this machine, "
                f"{cards} card(s); NCCL refuses two ranks of one communicator on one card "
                "(run them over backend 'gloo')")
        torch.cuda.set_device(device if device.index is not None else rank % cards)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return dist.group.WORLD


def loopback_env() -> dict:
    """The environment for ranks that meet on this machine: gloo bound to the
    loopback interface, where it has one (it otherwise resolves the host's
    name, which a machine without a network may not have)."""
    env = dict(os.environ)
    if "GLOO_SOCKET_IFNAME" not in env and os.path.exists("/sys/class/net/lo"):
        env["GLOO_SOCKET_IFNAME"] = "lo"
    return env


class Transport:
    """What crosses ranks for a domain engine of ``n_tiles`` tiles on the
    process group ``group``; ``device`` is this rank's device (its tiles'
    tensors live there).

    Counters, kept for the measurements: ``collectives`` (every collective
    this rank issued: exchanges, gathers, all-reduces, barriers and
    ``agree`` checks), ``rank_bytes`` (bytes this rank received from
    other ranks) and ``staged_bytes`` (bytes copied between the card and
    pinned host buffers under gloo)."""

    def __init__(self, group, n_tiles: int, device):
        self.group = group
        self.backend = dist.get_backend(group)
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        if n_tiles % self.world:
            raise ValueError(f"{n_tiles} tiles do not split evenly over {self.world} ranks")
        self.per_rank = n_tiles // self.world
        self.n_tiles = n_tiles
        self.local_tiles = list(range(self.rank * self.per_rank,
                                      (self.rank + 1) * self.per_rank))
        self.device = torch.device(device)
        if self.backend == "nccl" and self.device.type != "cuda":
            raise RuntimeError("backend 'nccl' needs the tiles on a CUDA device")
        # gloo carries host memory: tensors on the card go through pinned buffers
        self.stage = self.backend == "gloo" and self.device.type == "cuda"
        # where small control tensors live: the host, except under NCCL
        self.control_device = self.device if self.backend == "nccl" else torch.device("cpu")
        self.collectives = 0
        self.rank_bytes = 0
        self.staged_bytes = 0

    def owner(self, tile: int) -> int:
        return tile // self.per_rank

    # -- staging ----------------------------------------------------------------

    def _to_wire(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The tensors as the backend takes them: on the host under gloo
        (copied into pinned buffers, then waited for), else as they are;
        bools as uint8."""
        out = [t.contiguous().view(torch.uint8) if t.dtype == torch.bool else t.contiguous()
               for t in tensors]
        if not self.stage:
            return out
        host = []
        for t in out:
            if t.device.type == "cuda":
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                self.staged_bytes += t.numel() * t.element_size()
                t = h
            host.append(t)
        for d in {t.device for t in out if t.device.type == "cuda"}:
            torch.cuda.current_stream(d).synchronize()
        return host

    def _buffer(self, like: torch.Tensor) -> torch.Tensor:
        """An empty receive buffer for a tensor like ``like``, where the
        backend writes it."""
        dtype = torch.uint8 if like.dtype == torch.bool else like.dtype
        if self.stage and like.device.type == "cuda":
            return torch.empty(like.shape, dtype=dtype, pin_memory=True)
        return torch.empty(like.shape, dtype=dtype, device=like.device)

    def _from_wire(self, buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """A received buffer as a tensor like ``like`` (its device and dtype)."""
        if buf.device != like.device:
            self.staged_bytes += buf.numel() * buf.element_size()
            buf = buf.to(like.device, non_blocking=True)
        return buf.view(torch.bool) if like.dtype == torch.bool else buf

    # -- collectives --------------------------------------------------------------

    def exchange(self, ops: Sequence[Tuple[str, torch.Tensor, int, int]]) -> List[torch.Tensor]:
        """One batch of point-to-point messages: ``ops`` holds
        ``("send", tensor, peer, tag)`` and ``("recv", like, peer, tag)``
        entries, which every rank lists in the same canonical order (so NCCL,
        which matches a pair's messages in issue order, and gloo, which
        matches them by tag, pair them alike). Returns the received tensors,
        in the order of the ``recv`` entries, like their ``like``."""
        sends = self._to_wire([t for kind, t, _, _ in ops if kind == "send"])
        bufs, likes, p2p = [], [], []
        it = iter(sends)
        for kind, t, peer, tag in ops:
            if kind == "send":
                p2p.append(dist.P2POp(dist.isend, next(it), peer, self.group, tag))
            else:
                buf = self._buffer(t)
                bufs.append(buf)
                likes.append(t)
                p2p.append(dist.P2POp(dist.irecv, buf, peer, self.group, tag))
        if p2p:
            self.collectives += 1
            for req in dist.batch_isend_irecv(p2p):
                req.wait()
        self.rank_bytes += sum(b.numel() * b.element_size() for b in bufs)
        return [self._from_wire(b, like) for b, like in zip(bufs, likes)]

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(world, *x.shape): every rank's ``x`` in rank order, on ``x``'s
        device."""
        (wire,) = self._to_wire([x])
        bufs = [torch.empty_like(wire) for _ in range(self.world)]
        self.collectives += 1
        dist.all_gather(bufs, wire, group=self.group)
        self.rank_bytes += sum(b.numel() * b.element_size()
                               for r, b in enumerate(bufs) if r != self.rank)
        return self._from_wire(torch.stack(bufs), x)

    def gather_tiles(self, values: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Every tile's value in tile order, from this rank's tiles' values
        (one tensor per local tile, of one shape and dtype on every rank),
        on the device of the first."""
        stacked = torch.stack([v.to(values[0].device) for v in values])
        gathered = self.all_gather(stacked)
        return list(gathered.reshape((self.n_tiles,) + tuple(stacked.shape[1:])).unbind(0))

    def _all_reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        (wire,) = self._to_wire([x])
        wire = wire.clone() if wire is x else wire
        self.collectives += 1
        dist.all_reduce(wire, op=op, group=self.group)
        return wire.to(x.device, non_blocking=True) if wire.device != x.device else wire

    def all_reduce_max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum over the ranks (exact in any order)."""
        return self._all_reduce(x, dist.ReduceOp.MAX)

    def all_reduce_sum_int(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise sum over the ranks of an integer tensor (exact in
        any order). Floats are refused: their sums are taken in tile order
        after ``gather_tiles``."""
        if x.is_floating_point() or x.dtype == torch.bool:
            raise TypeError(f"all_reduce_sum_int takes integers, not {x.dtype}")
        return self._all_reduce(x, dist.ReduceOp.SUM)

    def barrier(self) -> None:
        self.collectives += 1
        if self.backend == "nccl":
            dist.barrier(group=self.group, device_ids=[self.device.index or 0])
        else:
            dist.barrier(group=self.group)

    def agree(self, code: int, what: str) -> None:
        """Check that every rank is at the same collective (``code``, the
        caller's encoding of it), before issuing it: raises on every rank
        when one differs, where mismatched collectives would hang or
        exchange the wrong bytes."""
        codes = self.all_gather(torch.tensor([code], dtype=torch.int64,
                                             device=self.control_device))
        codes = codes.reshape(-1).tolist()
        if len(set(codes)) != 1:
            raise RuntimeError(f"ranks diverged at a collective ({what}): codes by rank {codes}")
