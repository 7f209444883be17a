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
- ``convert``: state and parameters to and from numpy / the JAX package.

Nothing here imports JAX.
"""
