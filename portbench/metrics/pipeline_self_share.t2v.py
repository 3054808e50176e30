"""Share of the counted stretch the host spends outside DiT forwards
(the pipeline's own work and its waits on the device), in %."""


def read(summary):
    if "host_outside_forward_s" not in summary:
        return None
    return 100.0 * summary["host_outside_forward_s"] / summary["stretch_s"]
