"""Attention's share of its roofline in the profiled unit, in %: the
least time the card could take for the visible (query, key) pairs of the
unit's layouts (4 * head_dim flops per pair and head at the bf16 peak, or q,
k, v and o once at the memory rate, whichever is larger) over the device
time of what the DiTs' attention-core call launched."""

from portbench.harness import readers


def read(summary):
    return readers.roofline_share(summary)
