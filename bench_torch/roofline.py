"""The card's published peaks and the roofline share a kernel's reader
reports: the least time the card could take for the work (the larger of
its bytes over the memory rate and its operations over the rate of their
type), over the time the kernel took on the card.

Peaks: NVIDIA H100 SXM5 80 GB data sheet, dense, at the 700 W power
limit: HBM3 3.35 TB/s, 67 TFLOP/s float32 and 33.5 TFLOP/s float64 outside
the tensor cores. A card set to a lower power limit reads lower shares.
"""

from __future__ import annotations

PEAK_BYTES = 3.35e12  # bytes/s
PEAK_F32 = 67e12  # float32 operations/s
PEAK_F64 = 33.5e12  # float64 operations/s


def bound_s(nbytes: float, f32_ops: float = 0.0, f64_ops: float = 0.0) -> float:
    """The least seconds one launch could take: bytes read once and written
    once at the memory rate, or its operations at their rates."""
    return max(nbytes / PEAK_BYTES, f32_ops / PEAK_F32 + f64_ops / PEAK_F64)


def share(run, kernels, launches: int, bound_total_s: float):
    """``bound_total_s`` over the device time of ``kernels`` in the traced
    window, in percent; None without a trace, without such kernels in it,
    or when the wrappers launched another number of times than the bound
    counts (``launches``), so that the bound would cover other work."""
    if run.trace is None or launches <= 0:
        return None
    device_s, _ = run.trace.kernel_s(kernels)
    if device_s <= 0.0:
        return None
    return 100.0 * bound_total_s / device_s
