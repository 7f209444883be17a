"""The benchmark's plain reference of the hiPSC step: a frozen copy of the
port's plain step (``engine.hipsc_step(plain=True)`` on the id-list contact
path, and the ``ops``, ``models.biology``, ``rng``, ``xla_f32`` and
``params`` code it calls), with its imports rewritten into this folder.

It launches no hand-written kernel and reads nothing another program made:
``xla_f32.fma`` and ``powf`` are their float64 mirrors, the draws their
plain mirrors, the deposit's sum the fixed-order plain schedule, and the
contact substeps, neighbour moments, FTCS and update their plain versions,
on whichever device the tensors are. It imports neither the port, nor the
JAX package, nor JAX (``tests/test_portbench_reference.py`` holds it to
that in a fresh process). ``step.Reference`` is the entry.
"""
