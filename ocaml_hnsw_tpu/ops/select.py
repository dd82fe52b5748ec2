"""Smallest-k selection over a wide score block — the one helper behind the
three wide scans: the flat engine (models/flat.py, also the bulk build's kNN
table), the query seed scan (models/search.py) and the build's seed entries
(models/build.py).

The score block is implicit: `score_block(start, width)` returns the
[B, width] scores of columns [start, start + width), and `min_k` walks the
columns in slabs, so the full [B, N] block (32 GB in f32 at the bulk build's
8192 × 1M shape) is never materialised.  Each slab keeps its own k smallest
columns; one final `lax.top_k` over the slabs' candidates merges them.

Per-slab methods:

  "exact"  `lax.top_k` over the slab.  Bit-exact top-k (ties to the lower
           column id).
  "group"  a group-min first: the slab's columns are split into `group`
           interleaved runs (column c sits in bin c mod width/group), each
           bin keeps its minimum, then `lax.top_k` picks k of the
           width/group bin minima.  It is approximate only where two of
           a row's true top-k share a bin, an expected fraction of about
           k·group / (2·N) of the true top-k.  `min_k` halves the group
           until that fraction is at most LOSS, and selects exactly when
           even a group of 2 would exceed it — so small indexes (and the
           CPU tests) get exact top-k, and only wide scans go approximate.

`METHOD` is what the wide scans use, chosen by the selection race on the
GPU (scripts/race_select.py; times in PERF.md): at 8192 queries × 1M rows
the group-min selects in 67.5 ms where exact `lax.top_k` takes 516 ms, and
`lax.approx_min_k` compiles to a sort on the GPU — as slow as exact, and
refused outright on a block of more than 2^31 scores.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

#: per-slab method used by every wide scan (see module docstring)
METHOD = "group"
#: columns per slab: bounds the transient [B, SLAB] score block
SLAB = 1 << 17
#: group-min bin count per slab ("group" method), at most
GROUP = 16
#: largest expected fraction of the true top-k the group-min may drop
LOSS = 0.002


def group_for(n: int, k: int, group: int = GROUP, loss: float = LOSS) -> int:
    """Group size for a group-min over n columns keeping k: the largest
    power-of-two halving of `group` whose expected loss k·g/(2n) is at most
    `loss`; 1 means select exactly."""
    g = group
    while g > 1 and k * g > 2 * loss * n:
        g //= 2
    return g


def _slab_min_k(s, k: int, method: str, group: int):
    """(vals [B, k], local column ids i32[B, k]) of one [B, w] slab."""
    w = s.shape[1]
    if (method == "group" and group > 1 and w % group == 0
            and k <= w // group):
        bins = w // group
        g = s.reshape(s.shape[0], group, bins)
        which = jnp.argmin(g, axis=1).astype(jnp.int32)  # [B, bins]
        gmin = jnp.min(g, axis=1)
        neg, j = jax.lax.top_k(-gmin, k)
        col = jnp.take_along_axis(which, j, axis=1) * bins + j
        return -neg, col.astype(jnp.int32)
    if method not in ("exact", "group"):
        raise ValueError(f"unknown selection method {method!r}")
    neg, col = jax.lax.top_k(-s, k)
    return -neg, col.astype(jnp.int32)


def min_k(score_block, n: int, k: int, *, method: str | None = None,
          slab: int | None = None, group: int = GROUP, loss: float = LOSS):
    """k smallest columns of the implicit [B, n] score matrix.

    score_block(start, width): scores f32/bf16[B, width] of columns
    [start, start + width); `start` is a traced int32, `width` static.
    Returns (vals f32[B, k], ids i32[B, k]) ascending.  Columns whose score
    is +inf can appear when fewer than k are finite: callers mask them.

    When n is not a multiple of the slab width the last slab is shifted
    left to end at column n, and the columns it shares with the previous
    slab are scored +inf there, so every column is counted once.

    group / loss: the "group" method's largest group and loss bound (see
    group_for)."""
    method = method or METHOD
    slab = min(slab or SLAB, n)
    if k > n:
        raise ValueError(f"k={k} exceeds the {n} columns")
    group = group_for(n, k, group, loss)
    if slab == n:
        vals, ids = _slab_min_k(score_block(jnp.int32(0), n), k, method,
                                group)
        return vals.astype(jnp.float32), ids
    k_s = min(k, slab)
    n_slabs = -(-n // slab)
    s0 = jax.eval_shape(lambda st: score_block(st, slab), jnp.int32(0))
    b, dt = s0.shape[0], s0.dtype

    def body(i, carry):
        vals, ids = carry
        want = i * slab
        start = jnp.minimum(want, n - slab)
        s = score_block(start, slab)
        col = start + jnp.arange(slab, dtype=jnp.int32)
        s = jnp.where((col >= want)[None, :], s, jnp.inf)
        v, c = _slab_min_k(s, k_s, method, group)
        vals = jax.lax.dynamic_update_slice_in_dim(vals, v, i * k_s, 1)
        ids = jax.lax.dynamic_update_slice_in_dim(ids, c + start, i * k_s, 1)
        return vals, ids

    vals, ids = jax.lax.fori_loop(
        0, n_slabs, body,
        (jnp.full((b, n_slabs * k_s), jnp.inf, dt),
         jnp.zeros((b, n_slabs * k_s), jnp.int32)))
    neg, j = jax.lax.top_k(-vals, k)
    return (-neg).astype(jnp.float32), jnp.take_along_axis(ids, j, axis=1)
