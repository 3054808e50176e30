"""Wan's cross-attention's share of the profiled unit's device time, in %:
the device time launched inside the program's ``wan.cross_attn`` spans over
the union of the device's operations in the unit."""


def read(summary):
    dev = summary.get("cross_attn_device_s")
    busy = summary.get("busy_s")
    return 100.0 * dev / busy if dev and busy else None
