"""Bulk graph construction — "build the whole index at once" (SURVEY.md
§3.1's `build` fold, re-designed around matrix products instead of
translated insert-by-insert).

The incremental builder (models/build.py) replays the paper's Alg 1 in
batched rounds: each round runs an ef_construction-wide beam search against
the graph-so-far.  That is the right shape for *streaming* inserts, but for
a bulk build it is a long dependent chain of ~N/R round dispatches whose hot
loop is row gathers.

When the whole dataset is present up front, none of that dependency chain is
necessary.  This module builds the SAME layered structure (same tensors,
same query engine, same device footprint, same M/M_max0 caps, same level
distribution from the same RNG formula) in a handful of full-dataset passes
that are all matmul- or elementwise-shaped:

  1. exact-rerank kNN of every node against the dataset via the flat scan
     (models/flat.py);
  2. SELECT-NEIGHBORS-HEURISTIC (paper Alg 4, the exact vectorized
     `heuristic_admit` the round builder uses) picks each node's M forward
     edges from its top-k — slab-batched, one pass;
  3. reverse edges (Alg 1's bidirectional connect) via a deterministic
     chunked column-major slot-counter scatter (same conflict-free trick as
     build.apply_edges, scaled to all N rows at once);
  4. per-node shrink: re-prune (own kNN ∪ reverse) to M_max0 with the same
     heuristic (Alg 1's shrink semantics, keep_pruned backfill optional);
  5. upper layers ℓ = 1..L: the ~N/M^ℓ sampled nodes (same
     `sample_levels` formula/stream) get the same treatment against the
     *subset* — kNN by flat scan over the subset rows, select M, reverse,
     shrink to M_max — written into the compact arena.

The output graph is drop-in: `pack_graph`, `build_seed_index`,
`knn_search(_packed)`, checkpointing, and ShardedIndex all consume it
unchanged, and `BuildState.adopt_graph` lets incremental inserts continue
on top (the streaming path).

Provenance note: the reference repo (empty mount — SURVEY.md §0) is a
single-threaded fold of Alg 1; this module is behaviorally equivalent at
the level the paper specifies (layered NSW, heuristic-pruned edges, capped
degrees, exponential level sampling) but constructs the base layer from
exact kNN instead of approximate beam search — strictly richer candidate
sets, and end recall equal or better (tests/test_bulk.py checks parity
with the round builder).
"""

from __future__ import annotations

import time
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ocaml_hnsw_tpu.config import HnswConfig
from ocaml_hnsw_tpu.models.graph import (
    GraphTensors, capacity, arena_capacity,
)
from ocaml_hnsw_tpu.models.build import (
    heuristic_admit, compact_by_mask, sample_levels,
)
from ocaml_hnsw_tpu.models.flat import empty_flat, flat_add, flat_search
from ocaml_hnsw_tpu.ops.distance import (
    INF, gather_dequant, pairwise_dists, dists_to_ids,
)
from ocaml_hnsw_tpu.ops.bitset import first_occurrence_mask
from ocaml_hnsw_tpu.ops.sortmerge import next_pow2
from ocaml_hnsw_tpu.utils import round_up


# ----------------------------------------------------------- workspace guard
def bulk_workspace_bytes(n_cap: int, dim: int, m: int, m_max0: int,
                         knn_k: int = 64) -> int:
    """Transient device residency of bulk_build's n_cap-scaled workspace,
    BEYOND the graph tensors themselves (which the round path allocates
    too).  Pure arithmetic so eligibility is testable without allocating a
    full-capacity BuildState.  Terms, in bulk_build order:

      - f32 source copy `src` [n_cap, d_pad]               (4 B)
      - flat engine: bf16 scan + f32 rerank rows           (2 + 4 B)
      - kNN tables ids+dists [n_cap, knn_k]                (4 + 4 B)
      - forward select ids+dists [n_cap, m]                (8 B)
      - reverse table ids+dists [n_cap, m_max0 + m]        (8 B)
      - reverse_scatter: 3 sort lanes over n_cap*m keys (i32,f32,i32),
        doubled for the sort's out-of-place buffers

    dim enters rounded up to a multiple of 128, a conservative bound that
    also covers layouts which pad rows to 128 lanes.  The scan's [batch,
    slab] score block (ops/select.py) is not n_cap-scaled and not counted."""
    d_pad = round_up(dim, 128)
    rev_cap = m_max0 + m
    per_row = (
        d_pad * (4 + 2 + 4)
        + knn_k * 8
        + m * 8
        + rev_cap * 8
        + m * 12 * 2
    )
    return n_cap * per_row


# --------------------------------------------------------------- flat loader
def flat_from_rows(rows, metric: str, scan_dtype: str = "bf16",
                   n_valid=None, chunk: int = 262144):
    """Device rows -> FlatTensors for the kNN passes (rerank rows f32,
    cosine rows normalized).  `rows` may carry padding; n_valid caps the
    occupied count."""
    from ocaml_hnsw_tpu.ops.metrics import get_metric

    rows = jnp.asarray(rows)
    n = int(rows.shape[0]) if n_valid is None else int(n_valid)
    if get_metric(metric).normalize_add:
        nrm = jnp.linalg.norm(rows.astype(jnp.float32), axis=1, keepdims=True)
        rows = rows / jnp.where(nrm == 0, 1.0, nrm)
    # capacity from the (possibly bucketed) row count, not n_valid, so the
    # upper-level flats share compiled shape families across levels
    flat = empty_flat(rows.shape[1], max(int(rows.shape[0]), n, 1),
                      scan_dtype=scan_dtype, rerank_dtype="f32")
    chunk = min(chunk, flat.n_cap)
    src = jnp.pad(rows.astype(jnp.float32),
                  ((0, flat.n_cap + chunk - rows.shape[0]), (0, 0)))
    for i in range(0, n, chunk):
        blk = jax.lax.dynamic_slice_in_dim(src, i, chunk, axis=0)
        flat = flat_add(flat, blk, jnp.int32(i), jnp.int32(min(chunk, n - i)))
    return flat


# ------------------------------------------------------------------ base kNN
@partial(jax.jit, static_argnames=("k", "metric", "batch", "n_pad",
                                   "rerank_pad"))
def _knn_table_rounds(flat, src, k: int, metric: str, batch: int, n_pad: int,
                      rerank_pad: int):
    def body(j, carry):
        ids_out, d_out = carry
        start = j * batch
        q = jax.lax.dynamic_slice_in_dim(src, start, batch, axis=0)
        ids, d = flat_search(flat, q, k=k + 1, metric=metric,
                             rerank_k=k + 1 + rerank_pad)
        own = start + jnp.arange(batch, dtype=jnp.int32)
        not_self = ids != own[:, None]
        ids2, d2 = compact_by_mask(ids, d, not_self & (ids >= 0), k)
        return (
            jax.lax.dynamic_update_slice_in_dim(ids_out, ids2, start, 0),
            jax.lax.dynamic_update_slice_in_dim(d_out, d2, start, 0),
        )

    return jax.lax.fori_loop(
        0, n_pad // batch, body,
        (jnp.full((n_pad, k), -1, jnp.int32), jnp.full((n_pad, k), INF)),
    )


def knn_table(flat, rows, k: int, metric: str, batch: int = 8192,
              rerank_pad: int = 32):
    """Top-k neighbor ids+dists of every row against the flat index, self
    excluded: (ids i32[n_rows_cap, k], d f32[n_rows_cap, k]) ascending.

    rows may be longer than the flat's occupied count (padding); each batch
    asks for k+1 then drops the self column.  ops.select.min_k keeps
    k+1+rerank_pad candidates before the exact f32 rerank.  One jitted
    fori_loop over the batches, so a 1M build is one dispatch, not ~123."""
    rows = jnp.asarray(rows)
    n_rows = rows.shape[0]
    n_pad = round_up(max(n_rows, batch), batch)
    src = jnp.pad(rows.astype(jnp.float32), ((0, n_pad - n_rows), (0, 0)))
    ids_out, d_out = _knn_table_rounds(flat, src, k=k, metric=metric,
                                       batch=batch, n_pad=n_pad,
                                       rerank_pad=rerank_pad)
    return ids_out[:n_rows], d_out[:n_rows]


# ------------------------------------------------------ forward selection
@partial(jax.jit, static_argnames=("m", "metric", "slab", "keep_pruned"))
def _select_rounds(vectors, scales, norms, cand_ids, cand_d, m: int,
                   metric: str, slab: int, keep_pruned: bool):
    """Alg-4 heuristic selection of m forward edges per node from its
    (ascending) candidate list — slab-batched over all rows.  Returns
    (ids i32[n_rows, m], d f32[n_rows, m])."""
    n_rows, k = cand_ids.shape
    out = jnp.full((n_rows, m), -1, jnp.int32)
    out_d = jnp.full((n_rows, m), INF)

    def body(i, carry):
        out, out_d = carry
        start = i * slab
        ids = jax.lax.dynamic_slice_in_dim(cand_ids, start, slab)
        d = jax.lax.dynamic_slice_in_dim(cand_d, start, slab)
        valid = ids >= 0
        cvec = gather_dequant(vectors, scales, ids)
        cnorm = norms[jnp.maximum(ids, 0)]
        pair = pairwise_dists(cvec, cnorm, metric,
                              precision=jax.lax.Precision.DEFAULT)
        sel = heuristic_admit(d, pair, valid, m, keep_pruned)
        new_ids, new_d = compact_by_mask(ids, d, sel & valid, m)
        return (
            jax.lax.dynamic_update_slice_in_dim(out, new_ids, start, 0),
            jax.lax.dynamic_update_slice_in_dim(out_d, new_d, start, 0),
        )

    return jax.lax.fori_loop(0, n_rows // slab, body, (out, out_d))


# ------------------------------------------------------- reverse scatter
@partial(jax.jit, static_argnames=("n_rows", "rev_cap"))
def reverse_scatter(fwd_ids, fwd_d, n_rows: int, rev_cap: int):
    """Deterministic capped reverse-edge table from forward edges.

    fwd_ids i32[R, M] (-1 padded), fwd_d f32[R, M].  Returns
    (rev i32[n_rows, rev_cap], rev_d f32) where row u collects the sources v
    with u ∈ fwd[v], ascending by edge distance — capped drops shed exactly
    the farthest incoming edges per target.

    One `lax.sort` over all R·M edges keyed lexicographically by
    (target, distance, source): within each equal-target run the edges land
    distance-ascending, the in-run rank is (position − run start) via a
    cummax over run-start markers, and (target, rank<cap) pairs are then
    unique → one conflict-free scatter, with no per-column [chunk, chunk]
    duplicate-ranking block.  Pure function of (fwd_ids, fwd_d):
    deterministic (is_stable + the source-id tiebreak make the order
    total)."""
    r, m = fwd_ids.shape
    e = r * m
    tgt = fwd_ids.reshape(e)
    d = fwd_d.reshape(e)
    src = jnp.repeat(jnp.arange(r, dtype=jnp.int32), m, total_repeat_length=e)
    live = tgt >= 0
    sink = n_rows  # dead edges sort to the sink row, dropped at the end
    tgt = jnp.where(live, tgt, sink)
    d = jnp.where(live, d, INF)
    st, sd, ss = jax.lax.sort((tgt, d, src), num_keys=3, is_stable=True)
    idx = jnp.arange(e, dtype=jnp.int32)
    run_start = jnp.where(
        jnp.concatenate([jnp.ones((1,), jnp.bool_), st[1:] != st[:-1]]),
        idx, 0)
    rank = idx - jax.lax.cummax(run_start)
    keep = (st < n_rows) & (rank < rev_cap)
    row = jnp.where(keep, st, sink)
    col = jnp.where(keep, rank, 0)
    rev = jnp.full((n_rows + 1, rev_cap), -1, jnp.int32)
    rev_d = jnp.full((n_rows + 1, rev_cap), INF)
    # (row, col) pairs are unique where keep; sink collisions resolve by
    # max/min, and the sink row is dropped — deterministic either way
    rev = rev.at[row, col].max(jnp.where(keep, ss, -1))
    rev_d = rev_d.at[row, col].min(jnp.where(keep, sd, INF))
    return rev[:n_rows], rev_d[:n_rows]


# ------------------------------------------------------------ shrink merge
@partial(jax.jit, static_argnames=("m_cap", "metric", "slab", "keep_pruned"))
def _merge_rounds(vectors, scales, norms, fwd_ids, fwd_d, rev, rev_d,
                  m_cap: int, metric: str, slab: int, keep_pruned: bool):
    """Final per-node rows: forward edges ∪ incoming reverse edges, with
    sequential Alg 1 semantics (same policy as build.apply_edges): reverse
    edges APPEND while the row fits m_cap; only over-full rows get the
    heuristic shrink re-prune."""
    from ocaml_hnsw_tpu.ops.sortmerge import bitonic_sort, next_pow2

    n_rows = fwd_ids.shape[0]
    k2 = fwd_ids.shape[1] + rev.shape[1]
    p2 = next_pow2(k2)
    out = jnp.full((n_rows, m_cap), -1, jnp.int32)

    def body(i, out):
        start = i * slab
        ids = jnp.concatenate([
            jax.lax.dynamic_slice_in_dim(fwd_ids, start, slab),
            jax.lax.dynamic_slice_in_dim(rev, start, slab),
        ], axis=1)
        d = jnp.concatenate([
            jax.lax.dynamic_slice_in_dim(fwd_d, start, slab),
            jax.lax.dynamic_slice_in_dim(rev_d, start, slab),
        ], axis=1)
        valid = (ids >= 0) & first_occurrence_mask(ids)
        d = jnp.where(valid, d, INF)
        ids = jnp.where(valid, ids, -1)
        overflow = jnp.sum(valid, axis=1) > m_cap
        # append path: forward slots first, then reverse, packed left
        app_ids, _ = compact_by_mask(ids, d, valid, m_cap)
        # shrink path: Alg 4 over the distance-sorted union
        ds, idss = d, ids
        if p2 > k2:
            ds = jnp.pad(ds, ((0, 0), (0, p2 - k2)), constant_values=jnp.inf)
            idss = jnp.pad(idss, ((0, 0), (0, p2 - k2)), constant_values=-1)
        sd, (sids,) = bitonic_sort(ds, [idss])
        svalid = jnp.isfinite(sd)
        cvec = gather_dequant(vectors, scales, sids)
        cnorm = norms[jnp.maximum(sids, 0)]
        pair = pairwise_dists(cvec, cnorm, metric,
                              precision=jax.lax.Precision.DEFAULT)
        sel = heuristic_admit(sd, pair, svalid, m_cap, keep_pruned,
                              scan_limit=k2)
        heur_ids, _ = compact_by_mask(sids, sd, sel & svalid, m_cap)
        new_ids = jnp.where(overflow[:, None], heur_ids, app_ids)
        return jax.lax.dynamic_update_slice_in_dim(out, new_ids, start, 0)

    return jax.lax.fori_loop(0, n_rows // slab, body, out)


def _local_ids(global_adj, inv):
    """Map global-id adjacency to subset-local ids via an inverse table."""
    loc = inv[jnp.maximum(global_adj, 0)]
    return jnp.where(global_adj >= 0, loc, -1)


# ------------------------------------------------------- fused upper level
@partial(jax.jit, static_argnames=("cap", "m", "m_max", "metric",
                                   "keep_pruned", "scan_dtype", "knn_k",
                                   "batch"))
def _upper_level(dataf, vectors, scales, norms, row_ids, n_sub, *, cap: int,
                 m: int, m_max: int, metric: str, keep_pruned: bool,
                 scan_dtype: str, knn_k: int, batch: int):
    """One whole upper layer — bucket flat load, kNN, Alg-4 select, reverse
    scatter, shrink merge — as a SINGLE jitted program.

    Why fused: each upper level runs on a small node subset (≈N/M^ℓ), where
    the device compute is microseconds but every separate jit call-site
    costs host tracing and dispatch; one program per level pays that once.
    n_sub rides as a TRACED scalar so every level at the same power-of-two
    bucket reuses one compiled program."""
    n_cap = vectors.shape[0]
    dim = dataf.shape[1]
    # dataf arrives pre-normalized from bulk_build (cosine-style metrics
    # normalize once up front), so bucket rows are used as-is
    rows = jnp.where((row_ids >= 0)[:, None],
                     dataf[jnp.maximum(row_ids, 0)], 0.0)
    # flat engine over the bucket (static cap-trip chunk loop; flat_add
    # masks by the traced remaining count, clamped to >= 0 internally)
    flat = empty_flat(dim, cap, scan_dtype=scan_dtype, rerank_dtype="f32")
    chunk = min(262144, flat.n_cap)
    src = jnp.pad(rows, ((0, flat.n_cap + chunk - cap), (0, 0)))
    for i in range(0, cap, chunk):
        blk = jax.lax.dynamic_slice_in_dim(src, i, chunk, axis=0)
        cnt = jnp.clip(n_sub - i, 0, chunk).astype(jnp.int32)
        flat = flat_add(flat, blk, jnp.int32(i), cnt)
    # kNN of every bucket row (self excluded); fori_loop, not a Python
    # unroll — the 16-batch unroll at the 65536 bucket cost ~15 s of
    # single-core TRACING per fresh process (the device work is identical)
    kk = max(1, min(knn_k, cap - 1 - 32))
    sb = min(batch, 4096, cap)
    n_pad = round_up(max(cap, sb), sb)
    qsrc = jnp.pad(rows, ((0, n_pad - cap), (0, 0)))

    def knn_body(j, carry):
        knn_ids, knn_d = carry
        i = j * sb
        q = jax.lax.dynamic_slice_in_dim(qsrc, i, sb, axis=0)
        ids, d = flat_search(flat, q, k=kk + 1, metric=metric,
                             rerank_k=kk + 1 + 32)
        own = i + jnp.arange(sb, dtype=jnp.int32)
        not_self = ids != own[:, None]
        ids2, d2 = compact_by_mask(ids, d, not_self & (ids >= 0), kk)
        return (jax.lax.dynamic_update_slice_in_dim(knn_ids, ids2, i, 0),
                jax.lax.dynamic_update_slice_in_dim(knn_d, d2, i, 0))

    knn_ids, knn_d = jax.lax.fori_loop(
        0, n_pad // sb, knn_body,
        (jnp.full((n_pad, kk), -1, jnp.int32), jnp.full((n_pad, kk), INF)),
    )
    knn_ids, knn_d = knn_ids[:cap], knn_d[:cap]
    pad_row = row_ids < 0
    g_knn = jnp.where((knn_ids >= 0) & ~pad_row[:, None],
                      row_ids[jnp.maximum(knn_ids, 0)], -1)
    knn_ld = jnp.where(g_knn >= 0, knn_d, INF)
    slab_u = min(2048, cap)
    fwd_u, fwd_ud = _select_rounds(vectors, scales, norms, g_knn, knn_ld,
                                   m, metric, slab_u, keep_pruned)
    inv = jnp.full((n_cap,), -1, jnp.int32).at[
        jnp.maximum(row_ids, 0)].set(jnp.arange(cap, dtype=jnp.int32))
    l_fwd = _local_ids(fwd_u, inv)
    rev_u, rev_ud = reverse_scatter(l_fwd, fwd_ud, cap, m_max + m)
    g_rev = jnp.where(rev_u >= 0, row_ids[jnp.maximum(rev_u, 0)], -1)
    return _merge_rounds(vectors, scales, norms, fwd_u, fwd_ud, g_rev,
                         rev_ud, m_max, metric, slab_u, keep_pruned)


# ----------------------------------------------------------------- bulk build
def bulk_build(
    data,
    config: HnswConfig,
    max_elements: int | None = None,
    knn_k: int = 64,
    batch: int = 8192,
    scan_dtype: str = "bf16",
    levels=None,
    verbose: bool = False,
) -> GraphTensors:
    """Construct a full GraphTensors from the complete dataset (module
    docstring).  `data`: [n, dim] host or device array.  Deterministic for a
    fixed (data, config).  `levels`: optional pre-sampled per-node levels
    (BuildState's bulk path passes them from ITS RNG stream so a bulk first
    add() leaves the stream exactly where n incremental inserts would —
    save/resume and later streaming adds stay deterministic)."""
    from ocaml_hnsw_tpu.ops.quantize import quantize_rows
    from ocaml_hnsw_tpu.ops.metrics import get_metric

    def log(msg):
        if verbose:
            print(f"[bulk] {msg}", flush=True)

    t_all = time.perf_counter()
    data = jnp.asarray(data)
    n, dim = int(data.shape[0]), int(data.shape[1])
    assert dim == config.dim
    max_elements = max_elements or n
    n_cap = capacity(max_elements)
    l_max = config.derived_max_level(max_elements)
    m, m_max, m_max0 = config.M, config.M, config.M_max0
    metric = config.metric
    keep_pruned = config.keep_pruned_connections

    # ---- levels: same formula/stream as the incremental builder
    if levels is None:
        rng = np.random.RandomState(config.seed)
        levels = sample_levels(rng, n, config.mL, l_max)
    levels_np = np.asarray(levels)
    assert levels_np.shape == (n,)
    max_level = int(levels_np.max(initial=0))
    entry = int(np.argmax(levels_np))  # lowest id at the top level

    # ---- storage rows (quantized per config), norms
    normalize = get_metric(metric).normalize_add
    dataf = data.astype(jnp.float32)
    if normalize:
        nrm = jnp.linalg.norm(dataf, axis=1, keepdims=True)
        dataf = dataf / jnp.where(nrm == 0, 1.0, nrm)
    src = jnp.zeros((n_cap, dim), jnp.float32).at[:n].set(dataf)
    vectors, scales, norms_all = quantize_rows(src, config.storage)
    norms = norms_all if get_metric(metric).needs_norms \
        else jnp.zeros((n_cap,), jnp.float32)

    # ---- layer 0: kNN over everything, select, reverse, shrink
    flat = flat_from_rows(dataf, metric, scan_dtype=scan_dtype)
    t0 = time.perf_counter()
    knn_ids, knn_d = knn_table(flat, dataf, knn_k, metric, batch=batch)
    knn_ids = jnp.pad(knn_ids, ((0, n_cap - n), (0, 0)), constant_values=-1)
    knn_d = jnp.pad(knn_d, ((0, n_cap - n), (0, 0)),
                    constant_values=jnp.inf)
    del flat
    log(f"layer0 kNN (k={knn_k}) in {time.perf_counter()-t0:.1f}s")

    slab = 2048
    while n_cap % slab:
        slab //= 2
    t0 = time.perf_counter()
    fwd, fwd_d = _select_rounds(vectors, scales, norms, knn_ids, knn_d, m,
                                metric, slab, keep_pruned)
    log(f"layer0 forward select in {time.perf_counter()-t0:.1f}s")
    t0 = time.perf_counter()
    rev, rev_d = reverse_scatter(fwd, fwd_d, n_cap, m_max0 + m)
    log(f"layer0 reverse scatter in {time.perf_counter()-t0:.1f}s")
    t0 = time.perf_counter()
    adj0 = _merge_rounds(vectors, scales, norms, fwd, fwd_d, rev, rev_d,
                         m_max0, metric, slab, keep_pruned)
    log(f"layer0 shrink merge in {time.perf_counter()-t0:.1f}s")

    # ---- upper layers into the compact arena
    t_cap = arena_capacity(max_elements, m)
    adj_up = jnp.full((t_cap, m), -1, jnp.int32)
    up_base_np = np.full((n_cap,), -1, np.int32)
    upper = np.nonzero(levels_np >= 1)[0]
    up_base_np[upper] = np.cumsum(
        np.concatenate([[0], levels_np[upper][:-1]])).astype(np.int32)
    up_n = int(levels_np[upper].sum()) if upper.size else 0
    if up_n >= t_cap:
        raise RuntimeError(f"arena overflow: {up_n} rows > capacity {t_cap}")
    up_base = jnp.asarray(up_base_np)

    for lvl in range(1, max_level + 1):
        sub = np.nonzero(levels_np >= lvl)[0].astype(np.int32)
        n_sub = sub.size
        if n_sub == 0:
            break
        t0 = time.perf_counter()
        if n_sub == 1:
            arows = jnp.asarray(up_base_np[sub] + (lvl - 1))
            adj_up = adj_up.at[arows].set(-1)
            continue
        # bucket the subset capacity to a power of two (min 4096) so every
        # level ≤ the 4096 bucket shares ONE compiled shape family; the
        # whole level runs as ONE fused jit call (_upper_level), so per-call
        # trace and dispatch overhead is paid once per level
        n_sub_cap = max(4096, next_pow2(n_sub))
        row_ids = jnp.asarray(
            np.pad(sub, (0, n_sub_cap - n_sub), constant_values=-1))
        adj_l = _upper_level(
            dataf, vectors, scales, norms, row_ids, jnp.int32(n_sub),
            cap=n_sub_cap, m=m, m_max=m_max, metric=metric,
            keep_pruned=keep_pruned, scan_dtype=scan_dtype, knn_k=knn_k,
            batch=batch,
        )
        arows = jnp.asarray(up_base_np[sub] + (lvl - 1))
        adj_up = adj_up.at[arows].set(adj_l[:n_sub])
        log(f"layer {lvl}: {n_sub} nodes in {time.perf_counter()-t0:.1f}s")

    g = GraphTensors(
        vectors=vectors,
        scales=scales,
        norms=norms,
        adj0=adj0,
        adj_up=adj_up,
        up_base=up_base,
        up_n=jnp.int32(up_n),
        levels=jnp.asarray(
            np.pad(levels_np, (0, n_cap - n), constant_values=-1)),
        entry=jnp.int32(entry if n else -1),
        max_level=jnp.int32(max_level if n else -1),
        n=jnp.int32(n),
        deleted=jnp.zeros((n_cap,), jnp.bool_),
        l_max_static=l_max,
    )
    log(f"total {time.perf_counter()-t_all:.1f}s = "
        f"{n / (time.perf_counter()-t_all):.0f} vps")
    return g
