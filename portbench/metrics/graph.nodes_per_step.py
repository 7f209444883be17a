"""The kernel, memcpy and memset nodes of the window's graph (captured with
program tracing off) per step it replays: the device launches of a step,
hand-written kernels and PyTorch's alike (an ensemble step: all its
branches). Counted once at capture (``nodes`` of ``block_graphs()`` or the
ensemble's ``graphs()``). Nothing on the CPU, which captures none, nor where
the count failed. Layer: graph capture."""

WORK = ("kernel", "memcpy", "memset")


def read(run):
    graphs = [g for g in run.entry.graphs() if g.get("nodes") and not g.get("traced")]
    if not graphs:
        return None
    g = graphs[-1]
    return sum(g["nodes"][kind] for kind in WORK) / g.get("k", 1)
