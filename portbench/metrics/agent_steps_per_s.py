"""All the work of the window over all its time: the live agents at the
start of every step completed in the window (every replicate), summed, over
the window's seconds (episode resets included)."""


def read(run):
    return run.window.agent_steps / run.window.seconds
