"""The card's published peaks (NVIDIA's H100 SXM data sheet, dense, without
sparsity, at the full 700 W): HBM3 bytes per second and float32 operations
per second outside the tensor cores, by the name
``torch.cuda.get_device_name`` gives. A card not listed has no peaks, and
no roofline share is reported for it."""

from __future__ import annotations

from typing import Optional, Tuple

PEAKS = {
    "NVIDIA H100 80GB HBM3": (3.35e12, 67e12),
}


def of(card: str) -> Optional[Tuple[float, float]]:
    """``(bytes/s, float32 operations/s)`` of the card named ``card``."""
    return PEAKS.get(card)


def least_seconds(bytes_moved: float, operations: float, card: str) -> Optional[Tuple[float, str]]:
    """The least time the card could take for that work and what bounds it
    (``"bytes"`` or ``"operations"``), or None for a card with no peaks."""
    peaks = of(card)
    if peaks is None:
        return None
    t_bytes, t_ops = bytes_moved / peaks[0], operations / peaks[1]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
