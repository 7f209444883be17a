"""Agent-sharded step: a correctness cross-check, NOT the deployment path
(port of ``hipsc_abm_tpu/parallel/mesh.py``). **Use
``parallel.domain_engine.DomainHipscEngine`` for runs on several devices.**

The JAX module shards the slot axis of every per-agent array over a 1-D
device mesh and lets GSPMD insert the collectives; its value is that it
equals the single-device engine with no decomposition code, and its cost is
O(colony) communication per step. Here the mesh is a list of devices
(``make_mesh``), a state is split along the slot axis into contiguous
chunks, one per device (``shard_state``: a ``ShardedState``), and
``ShardedHipscEngine`` gathers the chunks onto the first device, steps them
with the inherited ``HipscEngine`` (its kernels on the card), and splits the
result back: the same O(colony) traffic, made explicit. The gradients, key,
step and next_id are replicated in every chunk.

Like the JAX module, this one is not re-exported from ``parallel``.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from hipsc_abm_tpu_torch.engine import CellState, HipscEngine, StepInfo
from hipsc_abm_tpu_torch.ops.jkr import BondState


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> List[torch.device]:
    """The devices a state is split over: ``n_devices`` of them (default:
    every card), ``cuda:{i % device_count}`` on the card, so that more
    chunks than cards share them; on the CPU ``n_devices`` times the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh(device='cuda') needs a CUDA device")
        count = torch.cuda.device_count()
        return [torch.device("cuda", i % count) for i in range(n_devices or count)]
    return [device] * (n_devices or 1)


class ShardedState(NamedTuple):
    """A colony split along its slot axis: ``chunks[i]`` is a ``CellState``
    of a contiguous block of slots on ``mesh[i]``, each with the replicated
    gradients, key, step and next_id."""

    chunks: Tuple[CellState, ...]

    @property
    def capacity(self) -> int:
        return sum(c.capacity for c in self.chunks)


def shard_state(state: CellState, mesh: Sequence) -> ShardedState:
    """``state`` split into ``len(mesh)`` contiguous slot chunks, chunk ``i``
    on ``mesh[i]`` (the last chunks one slot shorter when the capacity does
    not divide)."""
    n = len(mesh)

    def split(x):
        return x.tensor_split(n, dim=0)

    arrays = {k: split(v) for k, v in state.arrays.items()}
    alive, partners, mask = split(state.alive), split(state.bonds.partners), split(
        state.bonds.mask)
    chunks = []
    for i, dev in enumerate(mesh):
        chunks.append(CellState(
            arrays={k: v[i].to(dev) for k, v in arrays.items()}, alive=alive[i].to(dev),
            bonds=BondState(partners[i].to(dev), mask[i].to(dev)),
            gradients={k: v.to(dev) for k, v in state.gradients.items()},
            key=state.key, step=state.step, next_id=state.next_id.to(dev)))
    return ShardedState(tuple(chunks))


def gather_state(sharded: ShardedState, device) -> CellState:
    """The chunks concatenated into one ``CellState`` on ``device`` (the
    replicated leaves from the first chunk)."""
    first = sharded.chunks[0]

    def cat(get):
        return torch.cat([get(c).to(device) for c in sharded.chunks], dim=0)

    return CellState(
        arrays={k: cat(lambda c, k=k: c.arrays[k]) for k in first.arrays},
        alive=cat(lambda c: c.alive),
        bonds=BondState(cat(lambda c: c.bonds.partners), cat(lambda c: c.bonds.mask)),
        gradients={k: v.to(device) for k, v in first.gradients.items()},
        key=first.key, step=first.step, next_id=first.next_id.to(device))


class ShardedHipscEngine(HipscEngine):
    """``HipscEngine`` over a chunked state. **Correctness cross-check
    only**: each step gathers the whole colony onto the first device of the
    mesh and splits it back (see the module docstring); deploy on
    ``parallel.domain_engine.DomainHipscEngine``.

    The step, its kernels and its capacity growth are inherited unchanged;
    the capacity is rounded up to a multiple of the mesh size at
    construction, as in the JAX engine, for chunks of one size."""

    def __init__(self, *args, mesh: Optional[Sequence] = None, **kwargs):
        if mesh is not None:
            kwargs["device"] = mesh[0]
        super().__init__(*args, **kwargs)
        self.mesh = list(mesh) if mesh is not None else make_mesh(device=self.device)
        n = len(self.mesh)
        if self.cfg.capacity % n:
            cap = ((self.cfg.capacity + n - 1) // n) * n
            self.cfg = dataclasses.replace(self.cfg, capacity=cap)

    def init_state(self, seed: int = 0, locations=None) -> ShardedState:
        return shard_state(super().init_state(seed=seed, locations=locations), self.mesh)

    def step(self, state: ShardedState) -> Tuple[ShardedState, StepInfo]:
        new, info = HipscEngine.step(self, gather_state(state, self.device))
        return shard_state(new, self.mesh), info

    def safe_step(self, state: ShardedState) -> Tuple[ShardedState, StepInfo]:
        new, info = HipscEngine.safe_step(self, gather_state(state, self.device))
        return shard_state(new, self.mesh), info

    def run_steps(self, state: ShardedState, k: int) -> Tuple[ShardedState, StepInfo]:
        new, info = HipscEngine.run_steps(self, gather_state(state, self.device), k)
        return shard_state(new, self.mesh), info
