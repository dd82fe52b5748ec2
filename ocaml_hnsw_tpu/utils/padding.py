"""Shape padding helpers.

XLA traces everything under jit once per static shape, so all index
capacities and query batches are padded to aligned sizes and masked with
sentinels (a bounded set of compiled programs).
"""

from __future__ import annotations

import numpy as np


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_to(arr: np.ndarray, n: int, fill, axis: int = 0) -> np.ndarray:
    """Pad `arr` along `axis` up to length `n` with `fill`."""
    cur = arr.shape[axis]
    if cur == n:
        return arr
    if cur > n:
        raise ValueError(f"cannot pad axis {axis} from {cur} down to {n}")
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, n - cur)
    return np.pad(arr, widths, constant_values=fill)
