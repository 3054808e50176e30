"""Device idle share of two steps, in %: one less the union of the
device's operations in the two profiled steps over the wall time of the two
steps three before them, unprofiled (the same units; other rows)."""

from portbench.harness import readers


def read(summary):
    return readers.idle_share(summary)
