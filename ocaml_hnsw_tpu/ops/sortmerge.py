"""Bitonic sort / merge networks for the beam update — the heap replacement.

The beam loop merges candidates into the beam twice per iteration.  A
bitonic network does it without a sort op: every compare-exchange stage is
an elementwise min/max against a *statically* permuted copy (idx ^ j), so
the whole merge is elementwise work with no dynamic scatter/gather.  Whether
`lax.top_k` or a sort beats it on the GPU at beam widths is not measured
yet.

Cost: full sort of width n = log²(n)/2 stages; merging an ascending run with a
descending run of equal width = log(n) stages.  The beam loop only ever needs
the merge plus one small candidate sort.

All widths must be powers of two; callers pad with ±inf sentinels.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _stage(d, payloads, j: int, want_min: np.ndarray):
    """One compare-exchange stage: partner = idx ^ j (static shuffle)."""
    n = d.shape[-1]
    perm = np.arange(n) ^ j
    pd = d[:, perm]
    wm = jnp.asarray(want_min)[None, :]
    take_partner = jnp.where(wm, pd < d, pd > d)
    out_d = jnp.where(take_partner, pd, d)
    out_p = [jnp.where(take_partner, p[:, perm], p) for p in payloads]
    return out_d, out_p


def bitonic_sort(d, payloads=(), ascending: bool = True):
    """Full bitonic sort of f32[B, n] (n a power of two), payloads carried."""
    n = d.shape[-1]
    assert n & (n - 1) == 0, "width must be a power of two"
    idx = np.arange(n)
    payloads = list(payloads)
    k = 2
    while k <= n:
        up = (idx & k) == 0
        if not ascending:
            up = ~up
        j = k // 2
        while j >= 1:
            is_lower = (idx & j) == 0
            want_min = np.where(is_lower, up, ~up)
            d, payloads = _stage(d, payloads, j, want_min)
            j //= 2
        k *= 2
    return d, payloads


def bitonic_merge(d, payloads=()):
    """Ascending merge of a *bitonic* row (e.g. ascending half ++ descending
    half): f32[B, n] with n a power of two; log2(n) stages."""
    n = d.shape[-1]
    assert n & (n - 1) == 0, "width must be a power of two"
    idx = np.arange(n)
    payloads = list(payloads)
    j = n // 2
    while j >= 1:
        is_lower = (idx & j) == 0
        d, payloads = _stage(d, payloads, j, is_lower)
        j //= 2
    return d, payloads


def entries_to_beam(entry_ids, entry_d, ef: int):
    """Initial beam from entry candidates: sort ascending at the entries'
    own (power-of-two) width, then pad/truncate to ef.

    Replaces `lax.top_k(-d, ef)` over the ef-padded entries: entry widths
    are tiny (seed_e=8..32), so a 6-15 stage bitonic network at the narrow
    width suffices.
    Returns (beam_ids i32[B, ef], beam_d f32[B, ef]) ascending."""
    e0 = entry_ids.shape[1]
    p2 = next_pow2(e0)
    if p2 > e0:
        entry_d = jnp.pad(entry_d, ((0, 0), (0, p2 - e0)),
                          constant_values=jnp.inf)
        entry_ids = jnp.pad(entry_ids, ((0, 0), (0, p2 - e0)),
                            constant_values=-1)
    d_s, (ids_s,) = bitonic_sort(entry_d, [entry_ids], ascending=True)
    if p2 >= ef:
        return ids_s[:, :ef], d_s[:, :ef]
    pad = ef - p2
    return (
        jnp.pad(ids_s, ((0, 0), (0, pad)), constant_values=-1),
        jnp.pad(d_s, ((0, 0), (0, pad)), constant_values=jnp.inf),
    )


def topk_ascending(d, payload_ids, k: int):
    """Smallest-k of f32[B, n] with an i32 payload, ascending — a bitonic
    full sort at next_pow2(n), in place of `lax.top_k(-d, k)`.  Returns
    (d f32[B, k], ids i32[B, k])."""
    n = d.shape[-1]
    p2 = next_pow2(n)
    if p2 > n:
        d = jnp.pad(d, ((0, 0), (0, p2 - n)), constant_values=jnp.inf)
        payload_ids = jnp.pad(payload_ids, ((0, 0), (0, p2 - n)),
                              constant_values=-1)
    d_s, (ids_s,) = bitonic_sort(d, [payload_ids], ascending=True)
    return d_s[:, :k], ids_s[:, :k]


def merge_into_beam(beam_d, beam_payloads, cand_d, cand_payloads, ef: int):
    """Merge unsorted candidates into a sorted-ascending beam, keep best ef.

    beam: f32[B, ef] ascending (+inf padded).  cand: f32[B, C] unsorted.
    Returns (d, payloads) of width ef, ascending.  Pure compare-exchange
    network: sort candidates descending AT THEIR OWN power-of-two width
    (when C < ef this is the bulk of the merge's stage count — a C=64
    candidate block sorts in 21 stages at width 64 instead of 28 at the
    beam-padded 128), pad to the common width, then one bitonic merge.
    +inf padding goes at the FRONT of the descending run (prepending infs
    keeps it descending), so beam(asc)++cand(desc) stays bitonic.
    """
    c = cand_d.shape[-1]
    p2 = next_pow2(max(ef, c))
    p2c = next_pow2(c)
    fills = [f for _, f in cand_payloads]
    cps = [p for p, _ in cand_payloads]
    if c < p2c:
        cand_d = jnp.pad(cand_d, ((0, 0), (0, p2c - c)),
                         constant_values=jnp.inf)
        cps = [
            jnp.pad(p, ((0, 0), (0, p2c - c)), constant_values=f)
            for p, f in zip(cps, fills)
        ]
    cd, cp = bitonic_sort(cand_d, cps, ascending=False)
    if p2c < p2:
        # prepend +inf: [inf .. inf, d_max .. d_min] is still descending
        cd = jnp.pad(cd, ((0, 0), (p2 - p2c, 0)), constant_values=jnp.inf)
        cp = [
            jnp.pad(p, ((0, 0), (p2 - p2c, 0)), constant_values=f)
            for p, f in zip(cp, fills)
        ]
    # beam: ascending, pad at the tail
    if ef < p2:
        beam_d = jnp.pad(beam_d, ((0, 0), (0, p2 - ef)), constant_values=jnp.inf)
        beam_payloads = [
            jnp.pad(p, ((0, 0), (0, p2 - ef)), constant_values=fill)
            for p, fill in beam_payloads
        ]
    else:
        beam_payloads = [p for p, _ in beam_payloads]
    m_d = jnp.concatenate([beam_d, cd], axis=1)  # ascending ++ descending
    m_p = [jnp.concatenate([a, b], axis=1) for a, b in zip(beam_payloads, cp)]
    m_d, m_p = bitonic_merge(m_d, m_p)
    return m_d[:, :ef], [p[:, :ef] for p in m_p]
