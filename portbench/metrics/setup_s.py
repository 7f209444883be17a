"""From the process's start to the first timed call: imports, the CUDA
context, the kernel library's load (or build), the colony, the warm-up
episode with its captures, and the colony made again."""


def read(run):
    return run.setup_s
