"""Mean host milliseconds between the DiT's forward pre-hook and its hook,
over the forwards of the counted units (the launch cost of a forward)."""

from portbench.harness import readers


def read(summary):
    return readers.mean_ms(summary, "forward_host_s")
