"""hipsc_abm_tpu_torch — the hiPSC colony model's fused step in PyTorch, with
hand-written CUDA kernels for the neighbour walks and the diffusion stencil.

A port of ``hipsc_abm_tpu`` (the JAX package, which stays the reference).
Module names follow the JAX package:

- ``params``: the parameter dataclasses;
- ``ops.rng``, ``ops.neighbors``, ``ops.integrate``, ``ops.jkr``,
  ``ops.diffusion``: plain tensor code;
- ``ops.contact``, ``ops.bio_moments``, ``ops.ftcs``: the three CUDA kernels
  (sources in ``csrc/``, built by ``kernels``) beside their plain versions;
- ``models.biology``: the biology phases;
- ``engine``: ``hipsc_step`` and ``HipscEngine``;
- ``parallel.ensemble``: replicate ensembles and parameter sweeps;
  ``parallel.domain_engine``: one colony cut into tiles, from one process
  or over a process group (``parallel.distributed``); ``parallel.mesh`` and
  ``parallel.domain``: the JAX package's cross-checks;
  ``calibrate``: gradient and ES fits of the model's parameters;
  ``examples``: runnable demos (``run``, ``minimal_abm``, ``chemotaxis``,
  ``spheroid_3d``, ``replicate_study``, ``calibrate``);
- ``simulation``, ``models.hipsc``, ``__main__``: the framework and the
  colony model's lifecycle (``python -m hipsc_abm_tpu_torch``, modes 0-3);
- ``utils``: templates, the command line, outputs, checkpoints, timing;
  ``native``: the C++ CSV writers (built with ``g++`` at first use);
- ``convert``: state and parameters to and from numpy / the JAX package.

Nothing here imports JAX.
"""
