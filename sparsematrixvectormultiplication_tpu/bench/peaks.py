"""Published peak rates of the devices the benchmark measures, keyed by
``jax.devices()[0].device_kind``.

Roofline shares are stated against these numbers, with the card's power
limit beside them (a card capped below its maximum cannot hold its top
clock). A device that is not in the table is an error, not a default.
"""

from __future__ import annotations

__all__ = ["PEAKS", "peak_memory_bandwidth"]

PEAKS = {
    # NVIDIA H100 Tensor Core GPU data sheet, SXM5 part: 80 GB HBM3 at
    # 3.35 TB/s, at the full 700 W power limit.
    "NVIDIA H100 80GB HBM3": {"memory_bytes_per_s": 3.35e12},
}


def peak_memory_bandwidth(device_kind: str) -> float:
    """Published device-memory bandwidth in bytes/s of ``device_kind``."""
    try:
        return PEAKS[device_kind]["memory_bytes_per_s"]
    except KeyError:
        raise KeyError(f"no published peak for device {device_kind!r}; "
                       f"known: {sorted(PEAKS)}") from None
