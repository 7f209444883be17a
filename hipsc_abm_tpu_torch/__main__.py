"""``python -m hipsc_abm_tpu_torch -n <name> -m <mode> [-fs N] [-d DEVICE]``.

Reads ``paths.yaml`` and ``templates/*.yaml`` from the current directory
(modes: 0 new, 1 continue to ``-fs``, 2 video, 3 zip) and runs on the card
unless ``-d cpu`` asks for the host.
"""

from hipsc_abm_tpu_torch.models.hipsc import CellSimulation
from hipsc_abm_tpu_torch.utils import cli

if __name__ == "__main__":
    CellSimulation.start(device=cli.get_device())
