"""Seconds of every CUDA graph capture of set-up, summed (``capture_s`` of
each graph ``block_graphs()`` or the ensemble's ``graphs()`` listed after a
call of the warm-up episode, the dropped ones included). Layer: graph
capture. Nothing on the CPU, which captures none."""


def read(run):
    return sum(run.captures) if run.captures else None
