"""Flat-scan index: one matrix product over the whole dataset per query
batch, then an exact rerank.  It is the exact-ish companion of the HNSW
engine (FlatIndex / BFIndex in api.py) and the kNN pass of the bulk build
(models/bulk.py).  The bench harness measures both engines per workload.

Pipeline per query batch:
  1. scores = bf16 tensor-core contraction against all N rows (‖x‖² − 2⟨q,x⟩
     for l2, −⟨q,x⟩ for ip/cosine), walked in column slabs — bf16 error is
     fine here because
  2. `ops.select.min_k` keeps `rerank_k` ≫ k candidates, and
  3. the exact f32 rows of those candidates are gathered (rerank_k rows per
     query) and re-scored in f32; final exact top-k.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ocaml_hnsw_tpu.utils import round_up
from ocaml_hnsw_tpu.ops.distance import INF, HIGHEST
from ocaml_hnsw_tpu.ops.select import min_k


class FlatTensors(NamedTuple):
    """Flat index state.  scan: bf16[N_cap, D] (or int8 — the quantized
    distance path, half the scan memory of bf16 at 10M scale) matmul
    operand; scales: f32[N_cap] per-vector dequant scales (ones for bf16);
    rerank: exact rows (f32, or bf16 when memory-constrained); norms:
    f32[N_cap] ‖x‖² (+inf on empty slots so padding never scores); n: count;
    deleted: tombstones."""

    scan: jnp.ndarray
    scales: jnp.ndarray
    rerank: jnp.ndarray
    norms: jnp.ndarray
    n: jnp.ndarray
    deleted: jnp.ndarray

    @property
    def n_cap(self) -> int:
        return self.scan.shape[0]


def empty_flat(dim: int, max_elements: int, scan_dtype: str = "bf16",
               rerank_dtype: str = "f32") -> FlatTensors:
    # 4096-row capacity alignment: whole column slabs for the scan (and the
    # 4096-row chunks of the pair_dist path)
    n_cap = round_up(max(max_elements, 4096), 4096)
    sd = {"bf16": jnp.bfloat16, "int8": jnp.int8}[scan_dtype]
    rd = {"f32": jnp.float32, "bf16": jnp.bfloat16}[rerank_dtype]
    return FlatTensors(
        scan=jnp.zeros((n_cap, dim), sd),
        scales=jnp.ones((n_cap,), jnp.float32),
        rerank=jnp.zeros((n_cap, dim), rd),
        norms=jnp.full((n_cap,), jnp.inf, jnp.float32),
        n=jnp.int32(0),
        deleted=jnp.zeros((n_cap,), jnp.bool_),
    )


@jax.jit
def flat_add(flat: FlatTensors, rows, start, count) -> FlatTensors:
    """Append `count` of the (padded) `rows` at slots [start, start+count)."""
    r = rows.shape[0]
    p = (start + jnp.arange(r, dtype=jnp.int32)).astype(jnp.int32)
    valid = jnp.arange(r) < count
    rows = rows.astype(jnp.float32)
    if flat.scan.dtype == jnp.int8:
        amax = jnp.max(jnp.abs(rows), axis=1)
        scale = jnp.where(amax > 0, amax / 127.0, 1.0)
        srows = jnp.clip(
            jnp.round(rows / scale[:, None]), -127, 127
        ).astype(jnp.int8)
    else:
        scale = jnp.ones((r,), jnp.float32)
        srows = rows.astype(flat.scan.dtype)
    return flat._replace(
        scan=flat.scan.at[p].set(
            jnp.where(valid[:, None], srows, flat.scan[p])
        ),
        scales=flat.scales.at[p].set(jnp.where(valid, scale, flat.scales[p])),
        rerank=flat.rerank.at[p].set(
            jnp.where(valid[:, None], rows.astype(flat.rerank.dtype),
                      flat.rerank[p])
        ),
        norms=flat.norms.at[p].set(
            jnp.where(valid, jnp.sum(rows * rows, axis=1), flat.norms[p])
        ),
        n=flat.n + count.astype(jnp.int32),
    )


def _scan_scores(flat: FlatTensors, q, metric: str, exact: bool, start,
                 width: int):
    """Rank-equivalent scores f32[B, width] of the queries against flat rows
    [start, start + width); tombstones and empty slots score +inf.

    Metrics with a matmul form score from one contraction: bf16 (or int8
    with int32 accumulation) over the scan rows, or f32 at HIGHEST over the
    rerank rows when exact.  Registry metrics without one score the exact
    rows through pair_dist."""
    from ocaml_hnsw_tpu.ops.metrics import get_metric

    m = get_metric(metric)
    sl = lambda a: jax.lax.dynamic_slice_in_dim(a, start, width)  # noqa: E731
    ids = start + jnp.arange(width, dtype=jnp.int32)
    live = (ids < flat.n) & ~sl(flat.deleted)
    if m.matmul_score is None:
        d = m.pair_dist(sl(flat.rerank).astype(jnp.float32)[None], q)
        return jnp.where(live[None, :], d, INF)
    if exact:
        dot = jnp.einsum("bd,nd->bn", q, sl(flat.rerank).astype(jnp.float32),
                         precision=HIGHEST)
    elif flat.scan.dtype == jnp.int8:
        # symmetric int8 x int8 with int32 accumulation, one f32 rescale by
        # the per-query x per-vector scales
        qmax = jnp.max(jnp.abs(q), axis=1)
        qs = jnp.where(qmax > 0, qmax / 127.0, 1.0)
        qi = jnp.clip(jnp.round(q / qs[:, None]), -127, 127).astype(jnp.int8)
        idot = jax.lax.dot_general(
            qi, sl(flat.scan), (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.int32,
        )
        dot = idot.astype(jnp.float32) * (qs[:, None] * sl(flat.scales)[None])
    else:
        dot = jax.lax.dot_general(
            q.astype(jnp.bfloat16), sl(flat.scan), (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
    # rank-equivalent (e.g. l2 drops +‖q‖²); empty slots carry norms=+inf,
    # and `live` masks them for norm-free metrics too
    scores = m.matmul_score(dot, sl(flat.norms)[None, :])
    return jnp.where(live[None, :], scores, INF)


@partial(jax.jit, static_argnames=("k", "rerank_k", "metric", "exact"))
def flat_search(
    flat: FlatTensors,
    queries,  # f32[B, D]
    k: int,
    metric: str,
    rerank_k: int = 32,
    exact: bool = False,
):
    """Returns (ids i32[B, k], dists f32[B, k]) ascending, -1/+inf padded.

    exact=True scores the scan in f32 at HIGHEST precision and selects
    with exact top-k (the hnswlib-parity BFIndex semantics).  Default: bf16
    scan, `ops.select.min_k` keeps rerank_k candidates, exact f32 rerank.
    Either way the [B, N] score block is walked in column slabs and never
    materialised whole."""
    from ocaml_hnsw_tpu.models.search import preprocess_queries
    from ocaml_hnsw_tpu.ops.metrics import get_metric

    m = get_metric(metric)
    q = preprocess_queries(queries, metric)
    rerank_k = max(k, min(rerank_k, flat.n_cap))
    # registry metrics without a matmul form score [B, slab, D] diff blocks
    # through pair_dist, so they take narrow slabs
    no_mm = m.matmul_score is None
    _, ids = min_k(
        partial(_scan_scores, flat, q, metric, exact), flat.n_cap, rerank_k,
        method="exact" if exact or no_mm else None,
        slab=4096 if no_mm else None,
    )

    # exact rerank of the candidates (f32, or bf16 upcast when so stored)
    rows = flat.rerank[ids].astype(jnp.float32)  # [B, rerank_k, D]
    d = m.pair_dist(rows, q)
    # mask tombstones and unoccupied slots (their rerank rows are zeros and
    # would otherwise score a finite distance)
    d = jnp.where(flat.deleted[ids] | (ids >= flat.n), INF, d)
    neg, idx = jax.lax.top_k(-d, k)
    out_d = -neg
    out_ids = jnp.take_along_axis(ids, idx, axis=1)
    out_ids = jnp.where(jnp.isinf(out_d), -1, out_ids)
    return out_ids, out_d
