"""Attention's share of its roofline in the two profiled steps, in %: the
least time the card could take for the visible (query, key) pairs of the
steps' layouts (4 * head_dim flops per pair and head in the forward and 2.5
times that in the backward, at the bf16 peak, or the bytes at the memory
rate, whichever is larger; the recompute under remat is not counted) over
the device time of what the DiTs' attention-core call and its autograd
backward launched."""

from portbench.harness import readers


def read(summary):
    return readers.roofline_share(summary)
