"""Parallel execution of the port: ``ensemble`` steps R replicate colonies
(or the points of a parameter sweep) together, on the card as one CUDA
graph of R concurrent branches (port of ``hipsc_abm_tpu/parallel/``'s
ensemble)."""
