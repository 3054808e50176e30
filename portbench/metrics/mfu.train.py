"""Model FLOPs of the counted steps (three times the forwards' 2 per
multiply-add of every matrix product and their attention's visible pairs,
every batch row) over the stretch's wall time at the card's bf16 peak,
in %."""

from portbench.harness import readers


def read(summary):
    return readers.mfu(summary)
