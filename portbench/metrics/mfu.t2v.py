"""Model FLOPs of the counted units' DiT forwards (2 per multiply-add of
every matrix product, both CFG rows, and the attention's visible pairs)
over their stretch's wall time at the card's bf16 peak, in %."""

from portbench.harness import readers


def read(summary):
    return readers.mfu(summary)
