"""Parallel execution of the port (port of ``hipsc_abm_tpu/parallel/``):
``ensemble`` steps R replicate colonies (or the points of a parameter
sweep) together, on the card as one CUDA graph of R concurrent branches,
and splits them over devices (``shard_states``); ``domain_engine`` steps
one colony cut into tiles, with halo exchange and migration, from one
process or spread over the ranks of a process group (``distributed``, the
transport between ranks). ``mesh`` (the agent-sharded cross-check, O(colony)
traffic) is deliberately not re-exported here, as in the JAX package;
``domain`` is the stripe-decomposed contact force the domain engine grew
from."""

from hipsc_abm_tpu_torch.parallel.domain_engine import DomainHipscEngine, DomainState

__all__ = ["DomainHipscEngine", "DomainState"]
