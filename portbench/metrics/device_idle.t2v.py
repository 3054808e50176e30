"""Device idle share of a unit, in %: one less the union of the device's
operations in the profiled unit over the wall time of the unit before it,
unprofiled (its layouts differ by one history frame)."""

from portbench.harness import readers


def read(summary):
    return readers.idle_share(summary)
