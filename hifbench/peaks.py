"""The table of peaks and the least time of a piece of work on one card.

NVIDIA H100 SXM data sheet: 3.35 TB/s of device memory; 67 TFLOP/s in
float32 outside the tensor cores and 67 TFLOP/s in float64 on them (the
rates ``chip_smoke.py``'s kernel bounds use).  The rates assume the card's
full 700 W; each run names its card and power limit beside its numbers."""

from __future__ import annotations

__all__ = ["MEM_BYTES_PER_S", "PEAK_FLOPS", "least_seconds"]

MEM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12}


def least_seconds(nbytes: float, flops: float, dtype: str) -> float:
    """The least time the card could take: the larger of the bytes over the
    memory's rate and the operations over the dtype's peak."""
    return max(nbytes / MEM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])
