"""Batched HNSW search on the accelerator — the reference's L2 hot loops
(SURVEY.md §3.2/3.3) re-designed as lockstep tensor programs.

The OCaml reference's `search_layer` pops one candidate from a heap, chases its
adjacency pointers, and pushes survivors back (SURVEY.md §3.3).  Here, B queries
advance together under one `lax.while_loop`:

  per iteration (SURVEY.md §7 step 2, "batched frontier expansion"):
    1. each query selects its E nearest *unexpanded* beam entries (masked
       top-k — replaces the candidate min-heap pop; E = expand width),
    2. gathers those nodes' adjacency rows (i32[B, E·deg] — replaces the
       pointer chase),
    3. filters by a dense visited bitset (test + scatter-or set; hashed to a
       small per-query bitmap at scale — see ops/bitset.py),
    4. computes the [B, E·deg] distance block (gather + exact f32),
    5. merges candidates into the beam with `lax.top_k` (replaces both heaps).

  A query whose beam is fully expanded stops contributing work; the loop ends
  when every query converges (beam divergence is amortized across the batch —
  SURVEY.md §7 "hard parts").

Performance shape: the loop is bound by device-memory traffic — vector-row
gathers plus the per-iteration copy XLA makes of the visited buffer (scatters
in a while_loop are not aliased).  Multi-expand divides the iteration count
and therefore the copies; the hashed bitmap divides the copied bytes.

Beam semantics: bounded best-first (beam of ef, expand nearest unexpanded).
Paper Alg 2 additionally keeps already-evicted candidates in its heap but
never expands one farther than the current ef-th best — the same stopping
frontier — so recall matches the sequential oracle at equal (M, ef); parity
is enforced by tests/test_search.py.  Expand width E>1 expands a few more
nodes than Alg 2 would (equal-or-better recall per ef, more distance evals).

Upper layers use pure greedy descent (Alg 5's ef=1 loop).  Greedy moves only
on strict improvement, so no visited set is needed there (distance strictly
decreases ⇒ no cycles) — saving a bitmap clear per layer.
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ocaml_hnsw_tpu.models.graph import GraphTensors, adj_take, upper_view
from ocaml_hnsw_tpu.ops.distance import dists_to_ids, query_norms, INF
from ocaml_hnsw_tpu.ops.bitset import (
    bitset_new,
    bitset_test,
    bitset_set,
    first_occurrence_mask,
    hash_ids,
)
from ocaml_hnsw_tpu.ops.select import min_k
from ocaml_hnsw_tpu.ops.sortmerge import (
    bitonic_sort, entries_to_beam, merge_into_beam, topk_ascending,
)


def _visit_idx(ids, visited_bits: int | None):
    """Index into the visited bitmap for each id (identity or hashed)."""
    if visited_bits is None:
        return jnp.maximum(ids, 0)
    return hash_ids(ids, visited_bits)


def _greedy_level(vectors, scales, norms, adj, q, qn, cur, cur_d, enabled, metric):
    """One layer of greedy ef=1 descent for B queries (Alg 5 upper loop)."""

    def cond(state):
        _, _, active = state
        return jnp.any(active)

    def body(state):
        cur, cur_d, active = state
        nbrs = adj_take(adj, jnp.maximum(cur, 0))  # [B, deg]
        nbrs = jnp.where(active[:, None], nbrs, -1)
        d = dists_to_ids(vectors, scales, norms, q, qn, nbrs, metric)
        bi = jnp.argmin(d, axis=1)
        bd = jnp.take_along_axis(d, bi[:, None], axis=1)[:, 0]
        bid = jnp.take_along_axis(nbrs, bi[:, None], axis=1)[:, 0]
        better = active & (bd < cur_d)
        return (
            jnp.where(better, bid, cur),
            jnp.where(better, bd, cur_d),
            better,
        )

    cur, cur_d, _ = jax.lax.while_loop(cond, body, (cur, cur_d, enabled))
    return cur, cur_d


def beam_search_layer(
    vectors,
    scales,
    norms,
    adj,  # i32[N_cap, deg] adjacency of the layer being searched
    q,  # f32[B, D]
    qn,  # f32[B]
    entry_ids,  # i32[B, E0]  (-1 padded)
    entry_d,  # f32[B, E0]  (+inf at sentinel)
    ef: int,
    metric: str,
    max_iters: int | None = None,
    expand: int = 1,
    visited_bits: int | None = None,
    compact_k: int | None = None,
):
    """Beam search one layer for B queries; returns (ids, d, iters):
    i32/f32[B, ef] sorted ascending by distance (-1/+inf padded) plus the
    number of loop iterations executed (observability: hop count).

    compact_k: if set, each iteration packs the fresh candidates left and
    gathers/scores only the first compact_k of the expand·deg slots.  The
    vector-row gather is the loop's main cost, and only ~2/3 of candidate
    slots are fresh in practice, so compact_k ≈ 0.75·expand·deg cuts ~25% of
    the gather for a small recall cost (overflow drops are re-found through
    graph links on later iterations)."""
    b = q.shape[0]
    n_cap = vectors.shape[0]
    expand = max(1, min(expand, ef))
    # visited_bits=0: no global visited set — candidates dedup against the
    # current beam only (CAGRA-style).  Correct because the beam's worst
    # distance is monotone non-increasing, so a once-rejected candidate is
    # rejected forever; the only cost is occasionally re-gathering evicted
    # nodes, the only risk unbounded churn (bounded by max_iters).
    beam_only = visited_bits == 0
    if compact_k is not None and not beam_only:
        raise ValueError(
            "compact_k requires beam-only dedup (visited_bits=0): a bitset "
            "would mark compacted-away candidates visited and never revisit"
        )
    n_bits = 32 if beam_only else (
        n_cap if visited_bits is None else (1 << visited_bits)
    )

    # Entries may repeat within a row (and distinct ids may collide in hash
    # space); dedup on the *visit index* so the scatter-OR stays exact.
    vidx = _visit_idx(entry_ids, None if beam_only else visited_bits)
    uniq = first_occurrence_mask(vidx) & (entry_ids >= 0)
    entry_ids = jnp.where(uniq, entry_ids, -1)
    entry_d = jnp.where(uniq, entry_d, INF)
    visited = bitset_new(b, n_bits)
    if not beam_only:
        visited = bitset_set(visited, vidx, uniq)

    # Initial beam = best ef of the entries (bitonic sort at the narrow
    # entry width).  Beam state packs
    # (id, expanded) into ONE int32 — pk = 2·id + exp; sentinel -1 decodes
    # to (id=-1, expanded) — so the merge carries a single payload lane.
    beam_ids, beam_d = entries_to_beam(entry_ids, entry_d, ef)
    beam_pk = jnp.where(beam_ids < 0, -1, beam_ids * 2)

    def cond(state):
        beam_pk, _, _, it = state
        live = jnp.any((beam_pk & 1) == 0)
        if max_iters is not None:
            live &= it < max_iters
        return live

    def body(state):
        beam_pk, beam_d, visited, it = state
        # 1. pop the E nearest unexpanded beam members per query.  The beam is
        #    kept sorted ascending, so "first E unexpanded" (a cumsum mask —
        #    no sort, no scatter) IS "E nearest unexpanded".
        unexp = (beam_pk & 1) == 0
        slot = jnp.cumsum(unexp.astype(jnp.int32), axis=1)
        sel_mask = unexp & (slot <= expand)
        beam_pk = jnp.where(sel_mask, beam_pk | 1, beam_pk)
        oh = sel_mask[:, None, :] & (
            slot[:, None, :] == jnp.arange(1, expand + 1)[None, :, None]
        )  # [B, E, ef] one-hot of the e-th selected position
        pos = jnp.argmax(oh, axis=2)
        active = jnp.any(oh, axis=2)
        nodes = jnp.where(
            active, jnp.take_along_axis(beam_pk, pos, axis=1) >> 1, -1
        )  # [B, E]
        # 2. frontier expansion: adjacency gather
        nbrs = adj_take(adj, jnp.maximum(nodes, 0))  # [B, E, deg]
        nbrs = jnp.where((nodes >= 0)[:, :, None], nbrs, -1).reshape(b, -1)
        # 3. visited filter + mark (dedup on visit index), or beam-only dedup
        if beam_only:
            in_beam = jnp.any(
                nbrs[:, :, None] == (beam_pk >> 1)[:, None, :], axis=2
            )
            fresh = (nbrs >= 0) & ~in_beam & first_occurrence_mask(nbrs)
        else:
            nvidx = _visit_idx(nbrs, visited_bits)
            fresh = (
                (nbrs >= 0)
                & ~bitset_test(visited, nvidx, nbrs >= 0)
                & first_occurrence_mask(jnp.where(nbrs >= 0, nvidx, -1))
            )
            visited = bitset_set(visited, nvidx, fresh)
        cand_ids = jnp.where(fresh, nbrs, -1)
        if compact_k is not None and compact_k < cand_ids.shape[1]:
            # pack fresh ids left (stable bitonic on slot index), keep first
            # compact_k — the dropped tail is the only deviation from the
            # uncompacted trajectory
            kk = cand_ids.shape[1]
            key = jnp.where(
                fresh, jnp.arange(kk, dtype=jnp.int32)[None, :], kk
            ).astype(jnp.float32)
            skey, (s_ids,) = bitonic_sort(key, [cand_ids])
            cand_ids = jnp.where(skey[:, :compact_k] < kk,
                                 s_ids[:, :compact_k], -1)
        # 4. distance block (gather + exact f32)
        cand_d = dists_to_ids(vectors, scales, norms, q, qn, cand_ids, metric)
        # 5. beam merge: bitonic network
        cand_pk = jnp.where(cand_ids < 0, -1, cand_ids * 2)
        beam_d, (beam_pk,) = merge_into_beam(
            beam_d, [(beam_pk, -1)], cand_d, [(cand_pk, -1)], ef,
        )
        return beam_pk, beam_d, visited, it + 1

    beam_pk, beam_d, visited, iters = jax.lax.while_loop(
        cond, body, (beam_pk, beam_d, visited, jnp.int32(0))
    )
    return beam_pk >> 1, beam_d, iters


class SeedIndex(NamedTuple):
    """Coarse entry-point index: a dense copy of every level>=1 node's vector.

    A matmul redesign of Alg 5's upper-layer descent (the reference's greedy
    ef=1 pointer chase, SURVEY.md §3.2): the upper layers hold ~N/M nodes, so
    one bf16 contraction over all of them + top-E selection IS the descent —
    no adjacency gathers, and the E seeds are the (near-)exact nearest
    upper-layer nodes, which is strictly better entry quality than greedy's
    single local optimum, so seeded beams converge in fewer iterations.

    ids:   i32[U_cap]     global node id per row (padding repeats a real row)
    vecs:  bf16[U_cap, D] that node's stored vector (dequantized, bf16)
    norms: f32[U_cap]     ||x||² for l2 scoring (zeros for ip/cosine)
    bias:  f32[U_cap]     additive score bias: 0 on live rows, +inf on
                          masked padding (lets a partially-filled seed bank
                          be scanned without host-side compaction)
    """

    ids: jnp.ndarray
    vecs: jnp.ndarray
    norms: jnp.ndarray
    bias: jnp.ndarray


def build_seed_index(graph: GraphTensors, metric: str,
                     cap: int | None = None) -> SeedIndex | None:
    """Extract the level>=1 node set from a built graph (host-side, one-off
    per build/add batch).  Returns None when the graph has no upper nodes.

    cap: serve the scan from at most `cap` bank rows — highest levels first
    (the backbone), the level-1 remainder subsampled evenly.  The [B, U]
    score block is the scan's whole cost, so halving the bank halves the
    entry stage; level sampling is iid, so any level-1 subset is an
    unbiased coarse net."""
    lv = np.asarray(graph.levels)
    upper = np.nonzero(lv >= 1)[0].astype(np.int32)
    if upper.size == 0:
        return None
    if cap is not None and upper.size > cap:
        order = np.argsort(-lv[upper], kind="stable")
        ranked = upper[order]
        hi = ranked[lv[ranked] >= 2]
        lo = ranked[lv[ranked] == 1]
        take = max(0, cap - hi.size)
        if take and lo.size:
            idx = np.linspace(0, lo.size - 1, take).astype(np.int64)
            lo = lo[idx]
        else:
            lo = lo[:take]
        upper = np.sort(np.concatenate([hi, lo]).astype(np.int32))
    u_cap = max(128, 1 << int(math.ceil(math.log2(upper.size))))
    pad = np.full(u_cap, upper[0], np.int32)
    pad[: upper.size] = upper
    ids = jnp.asarray(pad)
    from ocaml_hnsw_tpu.ops.distance import gather_dequant

    vecs = gather_dequant(graph.vectors, graph.scales, ids[None, :])[0]
    from ocaml_hnsw_tpu.ops.metrics import get_metric

    norms = jnp.sum(vecs * vecs, axis=1) if get_metric(metric).needs_norms \
        else jnp.zeros((u_cap,), jnp.float32)
    return SeedIndex(ids=ids, vecs=vecs.astype(jnp.bfloat16), norms=norms,
                     bias=jnp.zeros((u_cap,), jnp.float32))


def seed_index_from_bank(graph: GraphTensors, bank, n_live, metric: str
                         ) -> SeedIndex:
    """SeedIndex view of a build-time seed bank (i32[U_cap] ids + live
    count), entirely on device — used by the sharded engine where each shard
    keeps its own bank.  Dead slots get a +inf score bias."""
    safe = jnp.maximum(bank, 0)
    from ocaml_hnsw_tpu.ops.distance import gather_dequant

    vecs = gather_dequant(graph.vectors, graph.scales, safe[None, :])[0]
    live = jnp.arange(bank.shape[0]) < n_live
    from ocaml_hnsw_tpu.ops.metrics import get_metric

    if get_metric(metric).needs_norms:
        norms = jnp.sum(vecs * vecs, axis=1)
    else:
        norms = jnp.zeros((bank.shape[0],), jnp.float32)
    return SeedIndex(
        ids=safe,
        vecs=vecs.astype(jnp.bfloat16),
        norms=norms,
        bias=jnp.where(live, 0.0, jnp.inf),
    )


def seed_entries(graph: GraphTensors, seeds: SeedIndex, q, qn, e: int,
                 metric: str):
    """Top-E upper-layer nodes per query: one matmul scan + ops.select.min_k,
    then exact re-scoring of the E winners (so beam ordering sees true
    distances).  Returns (ids i32[B, E], d f32[B, E])."""
    from ocaml_hnsw_tpu.ops.metrics import get_metric

    mm = get_metric(metric).matmul_score
    if mm is None:
        raise ValueError(
            f"metric {metric!r} has no matmul_score; seed-scan entry needs "
            "one — pass seeds=None to use greedy descent"
        )

    def block(start, width):
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, start, width)  # noqa
        dot = jax.lax.dot_general(
            q.astype(jnp.bfloat16), sl(seeds.vecs), (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        # rank-equivalent (e.g. +‖q‖² dropped); bf16 scores halve the bytes
        # the selection reads — ranking precision only, the E winners are
        # exactly re-scored below
        scores = mm(dot, sl(seeds.norms)[None, :]) + sl(seeds.bias)[None, :]
        return scores.astype(jnp.bfloat16)

    _, ii = min_k(block, seeds.vecs.shape[0], e)
    sids = jnp.where(seeds.bias[ii] == 0.0, seeds.ids[ii], -1)
    sd = dists_to_ids(graph.vectors, graph.scales, graph.norms, q, qn, sids,
                      metric)
    return sids, sd


def descend(graph: GraphTensors, q, qn, metric: str, stop_level: int = 0):
    """Greedy descent from the top layer down to stop_level+1 (Alg 5 upper part).

    Returns (cur, cur_d): the per-query entry point for layer `stop_level`.
    The layer stack height is static (graph.l_max); layers above the
    live max_level are masked out."""
    b = q.shape[0]
    cur = jnp.broadcast_to(graph.entry, (b,)).astype(jnp.int32)
    cur_d = dists_to_ids(graph.vectors, graph.scales, graph.norms, q, qn, cur[:, None], metric)[:, 0]
    for li in range(graph.l_max, stop_level, -1):
        enabled = jnp.broadcast_to(li <= graph.max_level, (b,))
        cur, cur_d = _greedy_level(
            graph.vectors,
            graph.scales,
            graph.norms,
            upper_view(graph, li),
            q,
            qn,
            cur,
            cur_d,
            enabled,
            metric,
        )
    return cur, cur_d


def preprocess_queries(q, metric: str):
    """Match the oracle's query prep (e.g. cosine normalizes at query time)."""
    from ocaml_hnsw_tpu.ops.metrics import get_metric

    q = q.astype(jnp.float32)
    if get_metric(metric).normalize_query:
        n = jnp.linalg.norm(q, axis=-1, keepdims=True)
        q = q / jnp.where(n == 0, 1.0, n)
    return q


@partial(
    jax.jit,
    static_argnames=(
        "k", "ef", "metric", "max_iters", "expand", "visited_bits", "seed_e",
        "compact_k",
    ),
)
def knn_search(
    graph: GraphTensors,
    queries,  # f32[B, D]
    k: int,
    ef: int,
    metric: str,
    max_iters: int | None = None,
    expand: int | None = None,
    visited_bits: int | None = None,
    seeds: SeedIndex | None = None,
    seed_e: int = 16,
    compact_k: int | None = None,
):
    """Full Alg 5: entry into layer 0 (greedy descent, or the matmul seed scan
    when `seeds` is given — see SeedIndex), then an ef-wide beam; returns
    (ids i32[B, k], dists f32[B, k]) ascending, -1/inf padded.  Tombstoned
    nodes are traversed but filtered from results (hnswlib mark_deleted
    semantics).

    max_iters bounds the lockstep beam loop; None = run to convergence (with
    a generous safety cap so tie-churn provably terminates).  Small explicit
    values trade recall for throughput — the bench sweeps (ef, max_iters).

    visited_bits: 0 (default) = beam-only dedup — provably the same beam
    trajectory as an exact visited set (the beam's worst distance is monotone
    non-increasing, so evicted/rejected nodes can never re-enter) at ~3x the
    speed; None/int force an exact or hashed-2^b bitset."""
    ef = max(ef, k)
    if expand is None:
        expand = 4
    if visited_bits is None:
        visited_bits = 0  # beam-only dedup: identical trajectory, ~3x faster
    if max_iters is None:
        # Finite safety cap so tie-churn (equal-distance re-admission under
        # beam-only dedup) provably terminates: a converging search expands
        # ≲ 2·ef nodes at ef/expand-ish iterations; 8× that is far outside
        # normal convergence yet bounds the pathological all-duplicates case.
        max_iters = max(64, (8 * ef) // max(1, expand))
    from ocaml_hnsw_tpu.ops.metrics import get_metric

    if seeds is not None and get_metric(metric).matmul_score is None:
        seeds = None  # registry metric without a matmul form: greedy descent
    q = preprocess_queries(queries, metric)
    qn = query_norms(q, metric)
    if seeds is not None:
        entry_ids, entry_d = seed_entries(graph, seeds, q, qn, seed_e, metric)
    else:
        cur, cur_d = descend(graph, q, qn, metric, stop_level=0)
        entry_ids, entry_d = cur[:, None], cur_d[:, None]
    ids, d, _ = beam_search_layer(
        graph.vectors,
        graph.scales,
        graph.norms,
        graph.adj0,
        q,
        qn,
        entry_ids,
        entry_d,
        ef,
        metric,
        max_iters,
        expand=expand,
        visited_bits=visited_bits,
        compact_k=compact_k,
    )
    # tombstone filter, then final top-k (beam is sorted but masking reorders;
    # a small bitonic sort)
    dead = graph.deleted[jnp.maximum(ids, 0)] | (ids < 0)
    d = jnp.where(dead, INF, d)
    out_d, out_ids = topk_ascending(d, jnp.where(dead, -1, ids), k)
    out_ids = jnp.where(jnp.isinf(out_d), -1, out_ids)
    return out_ids, out_d
