"""Batched distance computation — the tensor replacement for the reference's
L0 "vector storage & distance" layer (SURVEY.md §1): instead of one scalar
`distance(a, b)` call per edge, every frontier expansion computes a whole
[B, K] block of query↔neighbor distances.

Metric conventions match the oracle / hnswlib surface: "l2" = squared
Euclidean, "ip" = 1 - <q, x>, "cosine" = 1 - <q̂, x̂> with vectors normalized
at add/query time, making it identical to "ip" on-device.

Precision note (load-bearing): on an H100, an f32 matmul at the DEFAULT
precision runs on the tensor cores in TF32 (10-bit mantissa, ~1e-3 relative
error), which is larger than the gap between the 10th and 11th nearest
neighbor on clustered data — it silently scrambles neighbor order on the
card and not on the CPU, where DEFAULT is f32.  The per-candidate l2 path
therefore computes exact f32 (x−q)² elementwise — the search is bound by
memory traffic, so these FLOPs are free — and every remaining exact
contraction forces Precision.HIGHEST, which is true f32 (chip_smoke.py
phase 6 prints both errors).  Only the build's shrink heuristic keeps
DEFAULT (TF32): it decides near-tie diversity only.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ocaml_hnsw_tpu.ops.metrics import get_metric

INF = jnp.float32(jnp.inf)
HIGHEST = jax.lax.Precision.HIGHEST


def query_norms(q: jax.Array, metric: str) -> jax.Array:
    """Per-query ||q||² for norm-consuming metrics (l2); zeros otherwise. [B]"""
    if get_metric(metric).needs_norms:
        return jnp.sum(q * q, axis=-1)
    return jnp.zeros(q.shape[:-1], dtype=q.dtype)


def dists_to_ids(
    vectors: jax.Array,  # [N_cap, D] stored rows (f32 / bf16 / int8)
    scales: jax.Array,  # f32[N_cap] per-vector dequant scale (ones unless int8)
    norms: jax.Array,  # f32[N_cap]   precomputed ||x||² (zeros for ip/cosine)
    q: jax.Array,  # f32[B, D]
    qn: jax.Array,  # f32[B]
    ids: jax.Array,  # i32[B, K]    -1 = sentinel
    metric: str,
) -> jax.Array:
    """Distances d(q_b, x_{ids[b,k]}) as f32[B, K]; +inf at sentinel slots.

    The gather of `vectors` rows is the bandwidth-critical op — storage dtype
    (f32/bf16/int8) sets its byte cost.  l2 uses exact elementwise (x−q)² after
    dequantization (see precision note above); ip/cosine use one
    HIGHEST-precision contraction.
    """
    del norms, qn  # matmul-form variants would use these
    safe = jnp.maximum(ids, 0)
    rows = vectors[safe]  # [B, K, D] gather
    if rows.dtype == jnp.int8:
        rows = rows.astype(jnp.float32) * scales[safe][:, :, None]
    elif rows.dtype != jnp.float32:
        rows = rows.astype(jnp.float32)
    d = get_metric(metric).pair_dist(rows, q)
    return jnp.where(ids < 0, INF, d)


def gather_dequant(vectors: jax.Array, scales: jax.Array, ids: jax.Array):
    """Gather rows by id and dequantize to f32[B, K, D] (sentinels → row 0)."""
    safe = jnp.maximum(ids, 0)
    rows = vectors[safe]
    if rows.dtype == jnp.int8:
        return rows.astype(jnp.float32) * scales[safe][:, :, None]
    return rows.astype(jnp.float32)


def pairwise_dists(
    x: jax.Array,  # f32[B, K, D] candidate vectors
    x_norms: jax.Array,  # f32[B, K]  ||x||² per candidate (zeros for ip/cosine)
    metric: str,
    precision=HIGHEST,
) -> jax.Array:
    """All-pairs distances within each row's candidate set: f32[B, K, K].

    Used by the vectorized select-neighbors heuristic (paper Alg 4), where the
    O(|C|·M) sequential distance loop becomes one small batched matmul
    (SURVEY.md §7 step 4).  The [B,K,K,D] diff form would blow memory, so the
    built-in metrics stay a matmul at HIGHEST precision; registry metrics
    without a matmul form fall back to a vmapped pair_dist (XLA fuses the
    elementwise chain, but custom-metric builds are expected to be slower).
    """
    if metric == "l2":
        dot = jnp.einsum("bkd,bjd->bkj", x, x, precision=precision)
        d = x_norms[:, :, None] - 2.0 * dot + x_norms[:, None, :]
        return jnp.maximum(d, 0.0)
    if metric in ("ip", "cosine"):
        return 1.0 - jnp.einsum("bkd,bjd->bkj", x, x, precision=precision)
    m = get_metric(metric)
    # d[b, k, j] = dist(query=x[b, k], row=x[b, j]) per pair_dist convention
    return jax.vmap(lambda xk: m.pair_dist(x, xk), in_axes=1, out_axes=1)(x)
