"""Wan's cross-attention's share of its roofline in the profiled unit, in
%: the least time the card could take for its (valid latent query, text
key) pairs (4 * head_dim flops per pair and head at the bf16 peak, or q, k,
v and o once at the memory rate, whichever is larger) over the device time
of what was launched inside the program's ``wan.cross_attn`` spans."""


def read(summary):
    dev = summary.get("cross_attn_device_s")
    return 100.0 * summary["cross_attn_bound_s"] / dev if dev else None
