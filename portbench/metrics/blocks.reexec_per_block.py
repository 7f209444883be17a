"""Re-executions per call of the entry over the window: the engine's
attempts less one (``HipscEngine.block_attempts``, the ensemble's
``attempts``), averaged. Layer: engine loop and blocks."""


def read(run):
    attempts = run.window.attempts
    return sum(a - 1 for a in attempts) / len(attempts) if attempts else None
