"""What several readers compute alike, each from a run's ``Record``.

A reader returns None where its run holds nothing to read; a share of a
roofline or a peak is never returned as 0 in that case.
"""
from __future__ import annotations

from port_bench.work import PEAK_BF16


def kernels_roofline(record):
    """Σ bound of the kernel calls launched in the traced span over Σ device
    seconds of the port's ``csrc/`` kernels there, in %."""
    tr, bound = record.readings.get("trace"), record.readings.get("kernel_bound_s")
    if not tr or not bound or not tr["by_class"].get("port"):
        return None
    return 100.0 * bound / tr["by_class"]["port"]


def mfu(record):
    """Model FLOPs a second (2 or 6 × active parameters × tokens, over the
    host wall of the window's untraced part) over the bf16 peak, in %."""
    rate = record.readings.get("model_flops_per_s")
    return None if not rate else 100.0 * rate / PEAK_BF16


def device_idle(record):
    """Share of the traced span with no operation on the device, in %."""
    tr = record.readings.get("trace")
    if not tr or not tr["window_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
