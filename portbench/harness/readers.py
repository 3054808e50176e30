"""What the per-layer metric files read from a run's summary (the keys the
traffic generators write); each returns None where the run has nothing to
read."""

from __future__ import annotations

from .yardstick import PEAK_BF16_FLOPS


def mean_ms(summary, key: str):
    """The mean of a list of host seconds, in ms."""
    spans = summary.get(key)
    return 1e3 * sum(spans) / len(spans) if spans else None


def roofline_share(summary):
    """The profiled stretch's attention bound over its device time, in %."""
    dev = summary.get("attn_device_s")
    return 100.0 * summary["attn_bound_s"] / dev if dev else None


def idle_share(summary):
    """One less the profiled busy time over the same work's unprofiled
    wall, in %."""
    if "same_work_unprofiled_s" not in summary:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["same_work_unprofiled_s"])


def mfu(summary):
    """Model FLOPs of the counted stretch over its wall at the bf16 peak,
    in %."""
    if "model_flops" not in summary:
        return None
    return 100.0 * summary["model_flops"] / (summary["stretch_s"]
                                             * PEAK_BF16_FLOPS)


def peak_gb(summary):
    peak = summary.get("peak_mem_bytes")
    return peak / 1e9 if peak else None
