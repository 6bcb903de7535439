"""Device memory usage report (reference util.t:907-926 ``reportGPUMemoryUse``).

The reference queries cudaMemGetInfo and prints used/free/total; here the
JAX device memory stats (when the backend exposes them) plus a live-buffer
census give the same observability for device memory.
"""

from __future__ import annotations

from typing import Dict, Optional

import jax


def memory_stats(device=None) -> Optional[Dict[str, int]]:
    """Raw backend memory stats, or None when unavailable (CPU backend)."""
    device = device or jax.devices()[0]
    try:
        stats = device.memory_stats()
    except Exception:
        return None
    return dict(stats) if stats else None


def live_buffer_bytes(device=None) -> int:
    """Total bytes of live jax arrays on the device (framework-visible)."""
    total = 0
    for buf in jax.live_arrays():
        if device is None or device in buf.devices():
            total += buf.nbytes
    return total


def report(device=None, print_fn=print) -> str:
    """Human-readable usage line (the reference prints used/free/total MB)."""
    device = device or jax.devices()[0]
    stats = memory_stats(device)
    live_mb = live_buffer_bytes(device) / 1e6
    if stats:
        used = stats.get("bytes_in_use", 0) / 1e6
        limit = stats.get("bytes_limit", stats.get("bytes_reservable_limit", 0)) / 1e6
        peak = stats.get("peak_bytes_in_use", 0) / 1e6
        text = (
            f"{device.platform} memory: in use {used:.1f} MB"
            f" (peak {peak:.1f} MB, limit {limit:.1f} MB);"
            f" live arrays {live_mb:.1f} MB"
        )
    else:
        text = f"{device.platform} memory: live arrays {live_mb:.1f} MB"
    print_fn(text)
    return text
