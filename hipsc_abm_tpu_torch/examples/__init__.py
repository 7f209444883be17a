"""Examples of the port, runnable as ``python -m
hipsc_abm_tpu_torch.examples.<name>``."""
