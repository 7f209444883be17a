"""Entry point: the reference's ``run.py`` (port of ``examples/run.py``).

Run from a directory that holds ``templates/`` (the repository's
``examples/`` is one; without it the repository's example templates are
read); outputs go to this package's ``examples/outputs/``::

    python -m hipsc_abm_tpu_torch.examples.run -n my_sim -m 0            # new simulation
    python -m hipsc_abm_tpu_torch.examples.run -n my_sim -m 1 -fs 300    # continue to step 300
    python -m hipsc_abm_tpu_torch.examples.run -n my_sim -m 2            # images -> video
    python -m hipsc_abm_tpu_torch.examples.run -n my_sim -m 3            # zip outputs

on the card, or on the host with ``-d cpu``.
"""

import os

from hipsc_abm_tpu_torch.models.hipsc import CellSimulation
from hipsc_abm_tpu_torch.utils import cli

OUTPUTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "outputs")


def main(argv=None, output_dir: str = OUTPUTS):
    """``CellSimulation.start`` into ``output_dir``, on the ``-d`` device."""
    return CellSimulation.start(output_dir, argv=argv, device=cli.get_device(argv))


if __name__ == "__main__":
    main()
