"""Device memory peak over the window (``max_memory_allocated`` after a
reset at the window's start: the train state, its gradients and the
activations), in GB."""

from portbench.harness import readers


def read(summary):
    return readers.peak_gb(summary)
