"""Device-memory budgets.

Every size limit in the package (when to serve from the packed payload,
when to build in bulk, when the bench frees the flat engine) is a share of
what the device can hold: `jax.devices()[0].memory_stats()["bytes_limit"]`,
about 60 GB on an 80 GB H100 under JAX's default 75% reservation.  A backend
that reports no limit, such as the CPU the tests run on, gets
FALLBACK_BYTES (16 GiB), the size the shares were first chosen against, so
the limits there do not depend on the host.
"""

from __future__ import annotations

FALLBACK_BYTES = 16 << 30


def device_bytes_limit() -> int:
    """Bytes the first device lets this process allocate."""
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return int(stats.get("bytes_limit") or FALLBACK_BYTES)


def budget_bytes(share: float) -> int:
    """`share` of the device's memory limit, in bytes."""
    return int(share * device_bytes_limit())
