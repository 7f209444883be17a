"""The benchmark of the PyTorch and CUDA port ``hipsc_abm_tpu_torch`` on one
NVIDIA H100: ``python -m portbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` (``run``). See ``catalog`` for how its parts
are found by name.
"""
