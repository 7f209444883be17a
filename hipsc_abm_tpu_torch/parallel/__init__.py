"""Parallel execution of the port: ``ensemble`` steps R replicate colonies
(or the points of a parameter sweep) together, on the card as one CUDA
graph of R concurrent branches, and ``domain_engine`` steps one colony cut
into tiles, each on its own device, with halo exchange and migration (port
of ``hipsc_abm_tpu/parallel/``'s ensemble and domain engine)."""

from hipsc_abm_tpu_torch.parallel.domain_engine import DomainHipscEngine, DomainState

__all__ = ["DomainHipscEngine", "DomainState"]
