"""Batched parallel index construction on the accelerator (SURVEY.md §7
step 4).

The reference builds its graph by folding a sequential `insert` over the
dataset in one thread (SURVEY.md §3.1).  Here construction runs as *rounds* of
R simultaneous inserts, all inside one jitted step:

  1. levels for every point are pre-sampled on the host from the seeded RNG
     (identical stream to the oracle's, Alg 1's only randomness),
  2. each round searches the **pre-round graph snapshot** for all R points at
     once — greedy descent above each point's level, then an ef_construction
     beam per layer (reusing the query engine's kernels),
  3. the select-neighbors heuristic (Alg 4) is vectorized: the O(|C|·M)
     pairwise-distance loop becomes one [R, K, K] batched matmul plus a
     fixed-length admit scan,
  4. edges are applied with **conflict-free deterministic scatter**: forward
     rows are unique by construction; reverse edges get per-target slots from
     a column-by-column running counter (nearest-first, since selection
     columns are distance-ascending), and over-full rows are re-pruned with
     the same heuristic (Alg 1's shrink) — SURVEY.md §5.2's "race surface" is
     closed by construction, verified by determinism tests.

Round sizes follow a doubling schedule capped at `round_size` so points only
ever connect to an already-dense snapshot; the jitted step has a single static
shape (rounds are padded and masked) so the whole build compiles once.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ocaml_hnsw_tpu.config import HnswConfig
from ocaml_hnsw_tpu.models.graph import (
    GraphTensors, UpperView, adj_take, capacity, empty_graph,
)
from ocaml_hnsw_tpu.models.search import beam_search_layer, _greedy_level
from ocaml_hnsw_tpu.ops.distance import (
    dists_to_ids,
    gather_dequant,
    pairwise_dists,
    query_norms,
    INF,
)
from ocaml_hnsw_tpu.ops.quantize import quantize_rows
from ocaml_hnsw_tpu.ops.select import min_k
from ocaml_hnsw_tpu.utils import round_up

#: reverse-edge scatter: cap on the column-major ranking block's row count.
#: The per-column loop is latency-bound, not compute-bound, so apply_edges
#: groups as many adjacency columns per serial step as fit this block.
#: 32k keeps the [R·G, R·G] boolean ranking block ~1 GB of fused
#: elementwise work; divisor-of-M fallback below.
REV_BLOCK_ROWS = 32768


def upper_round_width(r: int, m: int, level: int) -> int:
    """Static row capacity for the packed upper-level connect stage.

    Level 1 (the wide stage, run once per round): 2x the binomial expectation
    r/M with a 128 floor — the floor keeps small rounds ≥ +5σ and the 2x
    margin is ≥ +11σ at r=2048 (Chernoff ≤ e^-42 per round); BuildState
    raises if a sampled round ever exceeds it.  Levels ≥ 2 (run per level in
    the narrow fori stage): 4x expectation r/M^level with a 64 floor, so
    they do not pay level-1's width in masked rows."""
    if level <= 1:
        want = max(128, (2 * r) // m)
    else:
        want = max(64, (4 * r) // (m ** level))
    p = 1
    while p < want:
        p *= 2
    return min(p, r)


def seed_capacity(n_cap: int, m: int) -> int:
    """Static capacity for the build-time seed bank (ids of level>=1 nodes).

    Expected upper-node count is n/M (P(level>=1) = 1/M); 3x headroom makes
    binomial overflow negligible, capped at n_cap."""
    want = max(128, (3 * n_cap) // max(m, 2))
    p = 1
    while p < want:
        p *= 2
    return min(p, round_up(n_cap, 128))


# --------------------------------------------------------------------- levels
def sample_levels(rng: np.random.RandomState, n: int, m_l: float, cap: int):
    """level = ⌊−ln(U(0,1))·mL⌋ (Alg 1), same RNG stream as the oracle."""
    u = rng.uniform(size=n)
    return np.minimum((-np.log(1.0 - u) * m_l).astype(np.int32), cap)


# ------------------------------------------------------- heuristic (Alg 4)
def heuristic_admit(cand_d, pair_d, valid, m: int, keep_pruned: bool,
                    scan_limit: int | None = None):
    """Vectorized SELECT-NEIGHBORS-HEURISTIC admit loop.

    cand_d: f32[B, K] distances to the query point, **sorted ascending**.
    pair_d: f32[B, Ke, Ke] pairwise distances among the first Ke candidates
    (Ke = K, or the scan_limit prefix — only admission-eligible candidates
    need pairwise distances, so callers with a scan_limit may pass the
    narrowed matrix and skip gathering the rest).
    Admit candidate j iff it is strictly closer to the query than to every
    already-admitted candidate, in the oracle's sequential candidate order
    (a fixed-length scan over the eligible prefix).  Returns bool[B, K].

    The scan's per-step work is a contiguous pair_d row slice + masked min;
    a winner-at-a-time variant (m steps, one pair_d *column* gather each)
    trades those K cheap fused steps for take_along_axis column gathers
    from the [B,K,K] tensor.

    scan_limit caps the candidate rank eligible for admission (candidates
    beyond that rank are never admitted); the keep_pruned backfill still
    sees all K candidates.
    """
    b, k = cand_d.shape
    ke = pair_d.shape[1]  # admission-eligible prefix (pairwise width)
    depth = ke if scan_limit is None else min(ke, scan_limit)

    def body(j, state):
        sel, cnt = state
        pj = jax.lax.dynamic_slice_in_dim(pair_d, j, 1, axis=1)[:, 0, :]
        dmin = jnp.min(jnp.where(sel, pj, INF), axis=1)
        dj = jax.lax.dynamic_slice_in_dim(cand_d, j, 1, axis=1)[:, 0]
        vj = jax.lax.dynamic_slice_in_dim(valid, j, 1, axis=1)[:, 0]
        admit = vj & (cnt < m) & (dj < dmin)
        sel = jax.lax.dynamic_update_slice_in_dim(
            sel, admit[:, None], j, axis=1
        )
        return sel, cnt + admit.astype(jnp.int32)

    sel, cnt = jax.lax.fori_loop(
        0, depth, body,
        (jnp.zeros((b, ke), jnp.bool_), jnp.zeros((b,), jnp.int32)),
    )
    if ke < k:
        sel = jnp.pad(sel, ((0, 0), (0, k - ke)))
    if keep_pruned:  # Alg 4 keepPrunedConnections: backfill nearest rejected
        free = m - cnt
        rej = valid & ~sel
        rank = jnp.cumsum(rej, axis=1)
        sel = sel | (rej & (rank <= free[:, None]))
    return sel


def compact_by_mask(ids, d, mask, m: int):
    """Pack masked entries left (stable) and truncate/pad to width m.

    Runs as a bitonic compare-exchange network on the slot index (stable:
    the key is the original position) rather than lax.top_k; this helper
    runs many times per insert round."""
    from ocaml_hnsw_tpu.ops.sortmerge import bitonic_sort, next_pow2

    k = ids.shape[1]
    key = jnp.where(mask, jnp.arange(k, dtype=jnp.int32)[None, :], k + 1)
    p2 = next_pow2(k)
    if p2 > k:
        key = jnp.pad(key, ((0, 0), (0, p2 - k)), constant_values=k + 1)
        ids = jnp.pad(ids, ((0, 0), (0, p2 - k)), constant_values=-1)
        d = jnp.pad(d, ((0, 0), (0, p2 - k)), constant_values=jnp.inf)
    skey, (out_ids, out_d) = bitonic_sort(
        key.astype(jnp.float32), [ids, d], ascending=True
    )
    w = min(m, k)
    ok = skey[:, :w] <= k
    out_ids = jnp.where(ok, out_ids[:, :w], -1)
    out_d = jnp.where(ok, out_d[:, :w], INF)
    if m > k:
        out_ids = jnp.pad(out_ids, ((0, 0), (0, m - k)), constant_values=-1)
        out_d = jnp.pad(out_d, ((0, 0), (0, m - k)), constant_values=jnp.inf)
    return out_ids, out_d


def select_neighbors(vectors, scales, norms, w_ids, w_d, m: int, metric: str,
                     keep_pruned: bool, heuristic: bool = True,
                     scan_limit: int | None = None):
    """Neighbor selection over beam results (sorted ascending): Alg 4
    diversity pruning (default) or Alg 3 plain nearest-M (heuristic=False).
    Returns ids/d [B, m]."""
    valid = w_ids >= 0
    if not heuristic:  # Alg 3: the beam is distance-ascending already
        return compact_by_mask(w_ids, w_d, valid, m)
    k = w_ids.shape[1]
    ke = k if scan_limit is None else min(k, scan_limit)
    # only the first `ke` candidates are admission-eligible, so only they
    # need vectors + pairwise distances (the keep_pruned backfill uses w_d
    # alone) — at scan_limit=64 of K=200 this is 3x fewer gathered rows and
    # ~10x less pairwise work
    ids_e = w_ids[:, :ke]
    cvec = gather_dequant(vectors, scales, ids_e)
    cnorm = norms[jnp.maximum(ids_e, 0)]
    pair = pairwise_dists(cvec, cnorm, metric)
    sel = heuristic_admit(w_d, pair, valid, m, keep_pruned,
                          scan_limit=scan_limit)
    return compact_by_mask(w_ids, w_d, sel, m)


def extend_candidates(vectors, scales, norms, adj_l, q, qn, w_ids, w_d,
                      ef_l: int, metric: str):
    """Alg 4's extendCandidates flag, batched: widen the candidate pool with
    the beam members' own neighbors at this layer, then keep the nearest ef_l
    (deduplicated) as the new pool.

    Deviation from the sequential oracle (documented): the oracle's pool
    grows unboundedly to |W|·(deg+1); here it is truncated to the nearest
    ef_l after extension so shapes stay static.  Selection admits at most
    M ≪ ef_l nearest-diverse candidates, so the truncation is outside the
    admitted region in practice (recall parity is covered by tests)."""
    r = w_ids.shape[0]
    nb = adj_take(adj_l, jnp.maximum(w_ids, 0))  # [R, ef_l, deg]
    nb = jnp.where((w_ids >= 0)[:, :, None], nb, -1).reshape(r, -1)
    all_ids = jnp.concatenate([w_ids, nb], axis=1)
    d_all = dists_to_ids(vectors, scales, norms, q, qn, all_ids, metric)
    kk = min(2 * ef_l, all_ids.shape[1])
    neg, idx = jax.lax.top_k(-d_all, kk)
    t_ids = jnp.take_along_axis(all_ids, idx, axis=1)
    t_d = -neg
    from ocaml_hnsw_tpu.ops.bitset import first_occurrence_mask

    uniq = first_occurrence_mask(t_ids) & (t_ids >= 0)
    return compact_by_mask(t_ids, t_d, uniq, ef_l)


# ------------------------------------------------------------- edge updates
def apply_edges(
    adj,  # i32[N_cap, m_cap] dense layer-0 table, OR an UpperView
    vectors,
    scales,
    norms,
    p_ids,  # i32[R] new point ids (unique)
    sel_ids,  # i32[R, M] chosen neighbors (-1 padded)
    sel_d,  # f32[R, M]
    mask,  # bool[R] point participates at this layer
    m_cap: int,
    rev_cap: int,
    metric: str,
    keep_pruned: bool,
    heuristic: bool = True,
    pack_dist=None,  # f32[N_rows, m_cap] stored d(node, neighbor) per slot
    packed_ctx=None,  # (pay, meta, scale, q8, q8n, start) — see below
):
    """Forward + reverse edge application with deterministic conflict handling.

    Reverse edges targeting the same node get slots from a per-target running
    counter (column order ≈ nearest first), capped at rev_cap per round, then
    merged into the target's row: plain append when it fits (sequential Alg 1
    semantics), heuristic re-prune (Alg 1's shrink) when over-full.  The
    result is a pure function of the round's inputs — intra-round point order
    cannot matter.

    The layer's storage is either the dense layer-0 table (row == node id) or
    an UpperView over the compact arena (row == up_base[id] + level-1); all
    scatter bookkeeping (slot counters, rev buffers) is indexed by *row*, and
    the tables' last row is the reserved all--1 scatter sink.  Returns the
    updated table (the caller re-wraps views).

    pack_dist (packed builds only): the payload's per-slot exact distances
    (models/packed.py PackedGraph.dist), kept in sync with the table by
    refresh_payload_rows after every round.  When given, the affected rows'
    old distances are READ from it and the new reverse-edge distances are
    carried through the slot scatter (d(e,p) = sel_d, symmetric metrics) —
    replacing the ~R·M·(m_cap+rev_cap) vector-row re-gather that dominated
    the round's edge-update cost.

    packed_ctx (packed layer-0 builds only): (pay, meta, scale, q8, q8n,
    start) — the live inline-int8 payload plus this round's quantized
    queries.  Every int8 vector an affected row can end up holding is
    already on device in int8: old slots live in the row's own payload
    chunk, new reverse edges are this round's points (q8 row = id − start).
    So the shrink heuristic's pairwise block is computed from the payload
    (one fat-row gather, ~4 KB/row) instead of re-gathering ~A·K2 scattered
    vector rows, and the updated payload rows come out as a by-product: the
    returned `packed_out = (aff, new_ids, new_d, row_pay8, row_norms)` is
    exactly what insert_round scatters into pay/meta/dist — replacing the
    refresh_payload_rows re-gather with a permutation.  Quantized pair distances flip only near-tie diversity
    decisions, same argument as the 1-pass-precision note below; the
    beam/selection distances stay exact f32.
    """
    r, m = sel_ids.shape
    is_view = isinstance(adj, UpperView)
    table = adj.table if is_view else adj
    n_rows = table.shape[0]
    sink = n_rows - 1

    def rows_of(ids, valid):
        safe = jnp.maximum(ids, 0)
        rows = adj.rows_of(safe) if is_view else safe
        return jnp.where(valid, rows, sink)

    # ---- forward rows (unique p_ids ⇒ conflict-free scatter)
    p_rows = rows_of(p_ids, mask)
    fwd = jnp.pad(sel_ids, ((0, 0), (0, m_cap - m)), constant_values=-1)
    rows = jnp.where(mask[:, None], fwd, table[p_rows])
    table = table.at[p_rows].set(rows)

    # ---- reverse pairs (e ← p), grouped by target row.
    # Slot assignment runs column-by-column with a running per-target counter
    # instead of a global (target, distance) lexsort over the round's
    # edges.  Columns of sel_ids are distance-ascending (selection is
    # compacted nearest-first), so column order ≈ nearest-first per target and
    # the rev_cap drop still sheds the farthest edges; the result is a pure
    # function of (sel_ids, p_ids) — intra-round order still can't matter.
    pair_valid = mask[:, None] & (sel_ids >= 0)
    e_rows = rows_of(sel_ids, pair_valid)  # [R, M], sink on invalid
    e_ids = jnp.where(pair_valid, sel_ids, -1)

    carry_d = pack_dist is not None
    # columns per scatter step: the per-column loop is latency-bound, so G
    # columns are flattened column-major and ranked with one [R·G, R·G] block — same
    # positions, fewer serial steps
    g = max(1, min(m, REV_BLOCK_ROWS // max(r, 1)))
    while m % g:
        g -= 1
    cg = r * g
    p_ids_g = jnp.tile(p_ids, g)
    tri_g = jnp.arange(cg)[None, :] < jnp.arange(cg)[:, None]

    def rev_blk(jb, carry):  # one traced body (columns were Python-unrolled)
        cnt, rev, rev_d = carry
        blk = jax.lax.dynamic_slice_in_dim(e_rows, jb * g, g, axis=1)
        er = blk.T.reshape(-1)  # column-major: matches per-column order
        live = er != sink
        base = cnt[er]
        # rank among duplicates of the same target within this block
        same = (er[None, :] == er[:, None]) & live[:, None]
        dup_rank = jnp.sum(same & tri_g, axis=1)
        pos = base + dup_rank
        keep = live & (pos < rev_cap)
        srow = jnp.where(keep, er, sink)
        spos = jnp.where(keep, pos, 0)
        rev = rev.at[srow, spos].max(jnp.where(keep, p_ids_g, -1))
        if carry_d:  # d(e ← p) = d(p → e) = sel_d (metrics are symmetric)
            d_blk = jax.lax.dynamic_slice_in_dim(sel_d, jb * g, g, axis=1)
            d_col = d_blk.T.reshape(-1)
            rev_d = rev_d.at[srow, spos].min(jnp.where(keep, d_col, INF))
        cnt = cnt.at[er].add(live.astype(jnp.int32))
        return cnt, rev, rev_d

    cnt, rev, rev_d = jax.lax.fori_loop(
        0, m // g,
        rev_blk,
        (jnp.zeros((n_rows,), jnp.int32),
         jnp.full((n_rows, rev_cap), -1, jnp.int32),
         jnp.full((n_rows, rev_cap), INF) if carry_d else None),
    )

    # ---- affected target rows: the flattened pair targets themselves.
    # Duplicates (same target hit by several new points) all recompute the
    # identical merged row and scatter identical values — deterministic — and
    # the width equals the nonzero() padding this replaces, so skipping the
    # O(n_cap) nonzero scan is a strict win.
    aff = e_rows.reshape(-1)  # [R*M] table rows, with dups; sink on invalid
    aff_ids = jnp.where(e_ids >= 0, e_ids, 0).reshape(-1)  # node ids (safe)

    old = table[aff]  # [A, m_cap]
    new_ps = rev[aff]  # [A, rev_cap]
    combined = jnp.concatenate([old, new_ps], axis=1)  # [A, K2]
    cvalid = combined >= 0
    overflow = jnp.sum(cvalid, axis=1) > m_cap

    if carry_d:
        # stored distances: old slots from the payload's dist table (synced
        # by refresh_payload_rows), new slots carried through the rev
        # scatter — no vector re-gather at all
        dcomb = jnp.concatenate([pack_dist[aff], rev_d[aff]], axis=1)
        dcomb = jnp.where(cvalid, dcomb, INF)
    else:
        # append path: old entries first, then the new ones, packed.
        # (A one-gather variant that computed the pairwise matrix in
        # combined order and permuted it to sorted order paid an
        # [A, K2, K2] double take_along_axis, more than the re-gather it
        # saved.)
        evec = gather_dequant(vectors, scales, aff_ids[:, None])[:, 0, :]
        enorm = norms[aff_ids]
        dcomb = dists_to_ids(
            vectors, scales, norms, evec, enorm,
            jnp.where(cvalid, combined, -1), metric
        )
    app_ids, app_d = compact_by_mask(combined, dcomb, cvalid, m_cap)

    # int8 candidate block for the packed path: old slots from the row's own
    # payload chunk (ONE fat-row gather), new slots from this round's q8
    a_rows = aff.shape[0]
    k2 = combined.shape[1]
    if packed_ctx is not None:
        from ocaml_hnsw_tpu.ops.metrics import get_metric

        pay, pmeta, pscale, q8, q8n, start = packed_ctx
        deg_full = pmeta.shape[1] // 2
        c = pay.shape[0] // pmeta.shape[0]
        d_pad = (pay.shape[1] * c) // deg_full
        cid = (aff[:, None] * c
               + jnp.arange(c, dtype=jnp.int32)[None, :]).reshape(-1)
        old8 = pay[cid].reshape(a_rows, deg_full, d_pad)
        old_n = pmeta[aff][:, deg_full:]  # int32 ‖x8‖² per old slot
        q_rows = jnp.clip(new_ps - start, 0, q8.shape[0] - 1)
        y8 = jnp.concatenate([old8, q8[q_rows]], axis=1)  # [A, K2, d_pad]
        yn = jnp.concatenate([old_n, q8n[q_rows]], axis=1)  # int32[A, K2]

    # shrink path: re-prune over old ∪ new, sorted by distance — Alg 4
    # heuristic by default, plain nearest-m_cap under select="simple".
    # Distance sort as a bitonic network (pure elementwise
    # compare-exchange stages).  The combined
    # POSITION rides along as a second payload lane so the packed path can
    # permute its int8 block (y8) into sorted order — permuting the vectors
    # is one [A, K2, D] take_along_axis, not the [A, K2, K2] matrix permute
    # the reverted one-gather variant paid for.
    from ocaml_hnsw_tpu.ops.sortmerge import bitonic_sort, next_pow2

    p2 = next_pow2(k2)
    sd_in = jnp.where(cvalid, dcomb, INF)
    si_in = combined
    pos_in = jnp.broadcast_to(
        jnp.arange(k2, dtype=jnp.int32)[None, :], combined.shape
    )
    if p2 > k2:
        sd_in = jnp.pad(sd_in, ((0, 0), (0, p2 - k2)),
                        constant_values=jnp.inf)
        si_in = jnp.pad(si_in, ((0, 0), (0, p2 - k2)), constant_values=-1)
        pos_in = jnp.pad(pos_in, ((0, 0), (0, p2 - k2)))
    sc_d, (sc_ids, sc_pos) = bitonic_sort(sd_in, [si_in, pos_in],
                                          ascending=True)
    sc_d = sc_d[:, :k2]
    sc_ids = sc_ids[:, :k2]
    sc_pos = sc_pos[:, :k2]
    sc_valid = sc_ids >= 0
    if heuristic and packed_ctx is not None:
        # pairwise block from the quantized vectors (no vector gather).
        # s-grid noise flips only near-tie diversity decisions — same class
        # of error as the precision note below.
        y8s = jnp.take_along_axis(y8, sc_pos[:, :, None], axis=1)
        yns = jnp.take_along_axis(yn, sc_pos, axis=1).astype(jnp.float32)
        dot = jnp.einsum(
            "akd,ajd->akj",
            y8s.astype(jnp.bfloat16), y8s.astype(jnp.bfloat16),
            preferred_element_type=jnp.float32,
        )
        s2 = (pscale * pscale).astype(jnp.float32)
        if get_metric(metric).needs_norms:
            pair2 = s2 * (yns[:, :, None] - 2.0 * dot + yns[:, None, :])
            pair2 = jnp.maximum(pair2, 0.0)
        else:
            pair2 = 1.0 - s2 * dot
        sel2 = heuristic_admit(sc_d, pair2, sc_valid, m_cap, keep_pruned)
    elif heuristic:
        svec = gather_dequant(vectors, scales, sc_ids)
        snorm = norms[jnp.maximum(sc_ids, 0)]
        # shrink-only pruning at DEFAULT precision (TF32 for these f32
        # inputs on an H100, ~1e-3 relative error): it flips only near-tie
        # diversity decisions, and HIGHEST makes these many small batched
        # matmuls several passes each
        pair2 = pairwise_dists(svec, snorm, metric,
                               precision=jax.lax.Precision.DEFAULT)
        sel2 = heuristic_admit(sc_d, pair2, sc_valid, m_cap, keep_pruned)
    else:
        sel2 = sc_valid
    heur_ids, heur_d = compact_by_mask(sc_ids, sc_d, sel2, m_cap)

    new_rows = jnp.where(overflow[:, None], heur_ids, app_ids)
    # sink-row fill entries all compute the identical all--1 row → benign dups
    table = table.at[aff].set(new_rows)
    if packed_ctx is None:
        return table

    # packed payload by-product: each output slot's int8 vector/norm is a
    # permutation of y8/yn (output ids are a subset of `combined`; valid ids
    # are unique within a row, so the argmax position is exact).  Slots with
    # id −1 keep whatever bytes the argmax picked — the query engine masks
    # candidates by meta id, never by payload bytes — but their dist is INF
    # (compact_by_mask) so the stored-dist invariant stays bit-exact.
    new_d = jnp.where(overflow[:, None], heur_d, app_d)
    eq = new_rows[:, :, None] == jnp.where(cvalid, combined, -2)[:, None, :]
    src = jnp.argmax(eq, axis=2).astype(jnp.int32)  # [A, m_cap] pos in K2
    row_pay8 = jnp.take_along_axis(y8, src[:, :, None], axis=1)
    row_norms = jnp.take_along_axis(yn, src, axis=1)
    return table, (aff, new_rows, new_d, row_pay8, row_norms)


# ------------------------------------------------------------- insert round
@partial(
    jax.jit,
    static_argnames=(
        "efc", "efc_upper", "m", "m_max0", "rev_cap", "metric",
        "keep_pruned", "storage", "seed_e",
        "build_mi", "build_ck", "build_expand", "extend", "heuristic",
        "select_scan",
    ),
    # donate the graph: without aliasing, every dispatch transiently holds
    # TWO copies of each updated tensor (at 5M x 768-d the int8 vectors
    # alone are 3.84 GB).  Every production caller replaces its graph with
    # the result (BuildState.add, the scan driver, shard_map steps); a
    # caller that re-calls insert_round on a kept snapshot must copy it
    # first, and must not pass `start` from inside the donated tree.
    donate_argnames=("graph",),
)
def insert_round(
    graph: GraphTensors,
    new_vecs,  # f32[R, D]  (already metric-prepped)
    new_levels,  # i32[R]
    start,  # i32 scalar: first slot id for this round
    count,  # i32 scalar: how many of the R rows are real
    seed_bank=None,  # i32[U_cap] ids of level>=1 nodes (pre-round snapshot)
    seed_n=None,  # i32 scalar: live entries in seed_bank
    seed_vecs=None,  # bf16[U_cap, D] cached bank vectors (avoids re-gathering
    #                  the whole bank every round: ~10 ms at 1M)
    seed_norms=None,  # f32[U_cap] cached ||x||^2 of the bank rows
    pack_pay=None,  # int8[N_cap·C, W] inline-neighbor payload (packed build)
    pack_meta=None,  # i32[N_cap, 2·deg] packed adjacency ids + int32 norms
    pack_scale=None,  # f32[] global quantization scale of the payload
    pack_dist=None,  # f32[N_cap, deg] stored per-slot exact distances
    *,
    efc: int,
    m: int,
    m_max0: int,
    rev_cap: int,
    metric: str,
    keep_pruned: bool,
    storage: str = "f32",
    efc_upper: int | None = None,
    seed_e: int = 16,
    build_mi: int | None = None,
    build_ck: int | None = None,
    build_expand: int = 4,
    extend: bool = False,
    heuristic: bool = True,
    select_scan: int | None = None,
):
    """One fully-batched insertion round (Alg 1 for R points against the
    pre-round snapshot).  R is static; real rounds are padded to R and masked.

    seed_bank/seed_n: the matmul entry-scan state (ids of all level>=1
    nodes).  When provided, layer<=1 beams start from the top-seed_e
    upper-layer nodes per point instead of the greedy-descent position, so
    the efc-wide level-0 beam starts near its answer and converges in fewer
    lockstep iterations.  The bank is updated with the round's new upper
    nodes and returned.

    The whole round is ONE compiled program for all round shapes: greedy
    descent and the upper-level connect stages are fori_loops with the layer
    as a *dynamic* scalar (the compact arena makes per-level adjacency a
    base-offset lookup, models/graph.py UpperView), so there are no
    per-round-top compile variants (statically-specialized variants
    multiply the compile time of a cold build).

    pack_pay/pack_meta/pack_scale: when given, the level-0 beam runs on the
    inline-int8 payload (models/packed.py) and the payload rows whose
    adjacency changed are refreshed before returning — the packed build
    path (BuildState auto-enables it on large matmul-metric builds).

    Returns (graph, seed_bank, seed_n, seed_vecs, seed_norms, pack_pay,
    pack_meta) — the pack tensors are None when packed build is off."""
    r = new_vecs.shape[0]
    n_cap = graph.n_cap
    l_max = graph.l_max
    # Upper layers hold ~N/M^l nodes and only route; a narrow beam there loses
    # nothing (selection still picks m of efc_upper) and the lockstep
    # while_loop converges in ~2·ef/expand iterations instead of 2·efc/expand.
    if efc_upper is None:
        efc_upper = min(efc, max(2 * m, 32))
    use_seeds = seed_bank is not None

    p_ids = (start + jnp.arange(r, dtype=jnp.int32)).astype(jnp.int32)
    valid = jnp.arange(r) < count

    # ---- place vectors / norms / levels (slots are unoccupied ⇒ safe)
    q = new_vecs.astype(jnp.float32)
    qn = query_norms(q, metric)
    qrows, qscales, qnorms_store = quantize_rows(q, storage)
    vectors = graph.vectors.at[p_ids].set(
        jnp.where(valid[:, None], qrows, graph.vectors[p_ids])
    )
    scales = graph.scales.at[p_ids].set(
        jnp.where(valid, qscales, graph.scales[p_ids])
    )
    from ocaml_hnsw_tpu.ops.metrics import get_metric

    norms_store = qnorms_store if get_metric(metric).needs_norms \
        else jnp.zeros_like(qnorms_store)
    norms = graph.norms.at[p_ids].set(
        jnp.where(valid, norms_store, graph.norms[p_ids])
    )
    levels = graph.levels.at[p_ids].set(jnp.where(valid, new_levels, -1))

    # ---- arena allocation: a level-L point owns L consecutive rows starting
    # at up_base (deterministic exclusive prefix sum over the round; the host
    # driver pre-checks capacity against the sampled levels exactly)
    rows_needed = jnp.where(valid, new_levels, 0)
    base = graph.up_n + jnp.cumsum(rows_needed) - rows_needed
    up_base = graph.up_base.at[p_ids].set(
        jnp.where(valid & (new_levels >= 1), base, -1)
    )
    up_n = graph.up_n + jnp.sum(rows_needed)

    max_level_pre = graph.max_level
    connect_start = jnp.minimum(new_levels, max_level_pre)  # [R]

    # ---- matmul seed scan over the pre-round upper-node bank (layer<=1
    # entries)
    use_seed_cache = seed_vecs is not None
    if use_seeds:
        u_cap = seed_bank.shape[0]
        safe_bank = jnp.maximum(seed_bank, 0)
        if use_seed_cache:
            # bf16 cache carried across rounds: scan precision only (winners
            # are exactly re-scored below), maintained by appending the
            # round's new upper nodes — no 3·N/M-row gather per round
            bank_f32 = seed_vecs.astype(jnp.float32)
            bank_b16 = seed_vecs
            bank_norms = seed_norms
        else:
            bank_f32 = gather_dequant(vectors, scales, safe_bank[None, :])[0]
            bank_b16 = bank_f32.astype(jnp.bfloat16)
            bank_norms = jnp.sum(bank_f32 * bank_f32, axis=1)
        mm = get_metric(metric).matmul_score

        def bank_scores(start, width):
            sl = lambda a: jax.lax.dynamic_slice_in_dim(a, start, width)  # noqa
            if mm is not None:
                dot = jax.lax.dot_general(
                    q.astype(jnp.bfloat16), sl(bank_b16),
                    (((1,), (1,)), ((), ())),
                    preferred_element_type=jnp.float32,
                )
                scores = mm(dot, sl(bank_norms)[None, :])
            else:
                # registry metric without a matmul form: pair distances
                # over the (cached or gathered) bank rows
                scores = get_metric(metric).pair_dist(sl(bank_f32)[None], q)
            live = start + jnp.arange(width) < seed_n
            # bf16 ranking (winners exactly re-scored below) halves the
            # bytes the selection reads
            return jnp.where(live[None, :], scores, jnp.inf).astype(
                jnp.bfloat16)

        _, ii = min_k(bank_scores, u_cap, seed_e)
        live = jnp.arange(u_cap) < seed_n
        s_ids = jnp.where(live[ii], safe_bank[ii], -1)
        s_d = dists_to_ids(vectors, scales, norms, q, qn, s_ids, metric)
        have_seeds = seed_n > 0

    # ---- descend + connect, one static pass over the layer stack
    cur = jnp.broadcast_to(graph.entry, (r,)).astype(jnp.int32)
    cur_d = dists_to_ids(
        vectors, scales, norms, q, qn, cur[:, None], metric
    )[:, 0]
    ep_ids = jnp.full((r, efc_upper), -1, jnp.int32)
    ep_d = jnp.full((r, efc_upper), jnp.inf, jnp.float32)

    adj0 = graph.adj0
    arena = graph.adj_up

    def first_entries(cur_v, cur_dv, sids_v, sdv, width, at_seed_level):
        """Entry block for a point's FIRST connect layer: the greedy-descent
        position, upgraded to the seed-scan top-E at layers <= 1 (seed-bank
        nodes are level>=1, so they exist at layers 0 and 1).  at_seed_level
        may be a traced bool (the rolled upper loop's `level <= 1`)."""
        n_rows = cur_v.shape[0]
        f_ids = jnp.concatenate(
            [cur_v[:, None], jnp.full((n_rows, width - 1), -1, jnp.int32)],
            axis=1,
        )
        f_d = jnp.concatenate(
            [cur_dv[:, None], jnp.full((n_rows, width - 1), jnp.inf)], axis=1
        )
        if use_seeds:
            pick = have_seeds & at_seed_level
            pad_i = jnp.full((n_rows, width - seed_e), -1, jnp.int32)
            pad_dd = jnp.full((n_rows, width - seed_e), jnp.inf)
            f_ids = jnp.where(pick,
                              jnp.concatenate([sids_v, pad_i], axis=1), f_ids)
            f_d = jnp.where(pick,
                            jnp.concatenate([sdv, pad_dd], axis=1), f_d)
        return f_ids, f_d

    # ---- greedy descent, ONE fori_loop over the layer stack (the dynamic
    # `level` in UpperView keeps this a single traced body — the dominant
    # compile-size lever).  Points whose
    # entries come from the seed scan (connect_start <= 1 with a live bank)
    # skip descent entirely — their first_entries never reads `cur`.
    round_top_dyn = jnp.max(jnp.where(valid, connect_start, 0))

    def desc_body(i, carry):
        cur, cur_d = carry
        li = l_max - i  # l_max .. 1
        need_pt = (connect_start >= 2) | ~have_seeds if use_seeds \
            else jnp.bool_(True)
        greedy_on = (valid & (li > connect_start) & (li <= max_level_pre)
                     & need_pt)
        view = UpperView(table=arena, up_base=up_base, levels=levels,
                         level=li)
        return _greedy_level(vectors, scales, norms, view, q, qn, cur, cur_d,
                             greedy_on, metric)

    cur, cur_d = jax.lax.fori_loop(0, l_max, desc_body, (cur, cur_d))

    # ---- upper-level connect: a narrow fori_loop for levels round_top..2
    # (~r/M^level live rows — at level-1's width those stages were ~all
    # masked rows: 106 ms of a 407 ms round at 1M), then one level-1 stage at
    # its own width.  BuildState asserts every round's per-level counts fit.
    def up_stage(arena, ep_ids, ep_d, level, width: int):
        lvl_mask = valid & (connect_start >= level)
        (idx,) = jnp.nonzero(lvl_mask, size=width, fill_value=r)
        on = idx < r
        safe_idx = jnp.minimum(idx, r - 1)
        q_l = q[safe_idx]
        qn_l = qn[safe_idx]
        f_ids, f_d = first_entries(
            cur[safe_idx], cur_d[safe_idx],
            s_ids[safe_idx] if use_seeds else None,
            s_d[safe_idx] if use_seeds else None,
            efc_upper, level <= 1,
        )
        seeding = (connect_start[safe_idx] == level)[:, None]
        entry_ids = jnp.where(seeding, f_ids, ep_ids[safe_idx])
        entry_d = jnp.where(seeding, f_d, ep_d[safe_idx])
        entry_ids = jnp.where(on[:, None], entry_ids, -1)
        entry_d = jnp.where(on[:, None], entry_d, INF)

        adj_l = UpperView(table=arena, up_base=up_base, levels=levels,
                          level=level)
        w_ids, w_d, _ = beam_search_layer(
            vectors, scales, norms, adj_l, q_l, qn_l, entry_ids, entry_d,
            efc_upper, metric, expand=4, visited_bits=0,
        )
        # W becomes the next-lower layer's entry set for these points.
        # Fill rows scatter into a dedicated dump row (index r) so they
        # can never collide with a real row's write — a clamped fill
        # index could otherwise race the genuinely-active last row.
        scatter_idx = jnp.where(on, safe_idx, r)
        ep_ids2 = jnp.pad(ep_ids, ((0, 1), (0, 0)))
        ep_d2 = jnp.pad(ep_d, ((0, 1), (0, 0)))
        ep_ids2 = ep_ids2.at[scatter_idx].set(w_ids)[:r]
        ep_d2 = ep_d2.at[scatter_idx].set(w_d)[:r]

        if extend:
            c_ids, c_d = extend_candidates(
                vectors, scales, norms, adj_l, q_l, qn_l, w_ids, w_d,
                efc_upper, metric,
            )
        else:
            c_ids, c_d = w_ids, w_d
        sel_ids, sel_d = select_neighbors(
            vectors, scales, norms, c_ids, c_d, m, metric, keep_pruned,
            heuristic=heuristic,
        )
        arena = apply_edges(
            adj_l, vectors, scales, norms, p_ids[safe_idx], sel_ids,
            sel_d, on, m, rev_cap, metric, keep_pruned,
            heuristic=heuristic,
        )
        return arena, ep_ids2, ep_d2

    r_hi = upper_round_width(r, m, 2)

    def up_body(i, carry):
        arena, ep_ids, ep_d = carry
        return up_stage(arena, ep_ids, ep_d, round_top_dyn - i, r_hi)

    arena, ep_ids, ep_d = jax.lax.fori_loop(
        0, jnp.maximum(round_top_dyn - 1, 0), up_body, (arena, ep_ids, ep_d)
    )
    # level 1 (masks handle the no-upper-points case: every row is sink-bound)
    arena, ep_ids, ep_d = up_stage(
        arena, ep_ids, ep_d, jnp.int32(1), upper_round_width(r, m, 1)
    )

    # ---- level 0: full-width connect for every valid point
    seeding = (connect_start == 0)[:, None]
    f_ids, f_d = first_entries(
        cur, cur_d,
        s_ids if use_seeds else None,
        s_d if use_seeds else None,
        efc_upper, jnp.bool_(True),
    )
    entry_ids = jnp.where(seeding, f_ids, ep_ids)
    entry_d = jnp.where(seeding, f_d, ep_d)
    entry_ids = jnp.where(valid[:, None], entry_ids, -1)
    entry_d = jnp.where(valid[:, None], entry_d, INF)

    use_packed = pack_pay is not None
    if use_packed:
        # packed construction beam: the efc-wide level-0 search runs on the
        # inline-int8 payload (models/packed.py) — E·C ~2KB chunk rows per
        # expansion instead of E·deg scattered vector rows.  The W set is
        # then exactly re-scored and re-sorted so selection (Alg 4) and
        # apply_edges see true-f32 distances: quantization only perturbs
        # *which* candidates the beam visited, not how they are pruned.
        from ocaml_hnsw_tpu.models.packed import (
            PackedGraph, beam_search_layer_packed, quantize_queries,
        )
        from ocaml_hnsw_tpu.ops.sortmerge import bitonic_sort, next_pow2

        pk = PackedGraph(pay=pack_pay, meta=pack_meta, scale=pack_scale,
                         dist=pack_dist)
        q8 = quantize_queries(q, pack_scale)
        if pk.d_pad > q8.shape[1]:
            q8 = jnp.pad(q8, ((0, 0), (0, pk.d_pad - q8.shape[1])))
        mi_eff = build_mi if build_mi is not None else 2 * efc // build_expand
        w_ids, _, _ = beam_search_layer_packed(
            pk, q8, qn, entry_ids, entry_d, efc,
            needs_norms=get_metric(metric).needs_norms,
            max_iters=mi_eff, expand=build_expand,
        )
        w_d = dists_to_ids(vectors, scales, norms, q, qn, w_ids, metric)
        p2 = next_pow2(efc)
        if p2 > efc:
            w_d = jnp.pad(w_d, ((0, 0), (0, p2 - efc)),
                          constant_values=jnp.inf)
            w_ids = jnp.pad(w_ids, ((0, 0), (0, p2 - efc)),
                            constant_values=-1)
        w_d, (w_ids,) = bitonic_sort(w_d, [w_ids], ascending=True)
        w_d, w_ids = w_d[:, :efc], w_ids[:, :efc]
    else:
        w_ids, w_d, _ = beam_search_layer(
            vectors, scales, norms, adj0, q, qn, entry_ids, entry_d,
            efc, metric, expand=build_expand, visited_bits=0,
            max_iters=build_mi, compact_k=build_ck,
        )
    if extend:
        c_ids, c_d = extend_candidates(
            vectors, scales, norms, adj0, q, qn, w_ids, w_d, efc, metric,
        )
    else:
        c_ids, c_d = w_ids, w_d
    sel_ids, sel_d = select_neighbors(
        vectors, scales, norms, c_ids, c_d, m, metric, keep_pruned,
        heuristic=heuristic, scan_limit=select_scan,
    )
    if use_packed:
        # q8 was computed above for the packed beam; its exact int32 norms
        # feed the payload by-product (meta stores ‖x8‖² per slot)
        from ocaml_hnsw_tpu.models.packed import (
            _int8_sqnorm, refresh_payload_rows,
        )

        q8n = _int8_sqnorm(q8)
        adj0, (aff, aff_ids_new, aff_d_new, aff_pay8, aff_norms) = \
            apply_edges(
                adj0, vectors, scales, norms, p_ids, sel_ids, sel_d, valid,
                m_max0, rev_cap, metric, keep_pruned,
                heuristic=heuristic,
                pack_dist=pack_dist,
                packed_ctx=(pack_pay, pack_meta, pack_scale, q8, q8n,
                            start.astype(jnp.int32)),
            )
        # scatter the affected rows' payload by-product (duplicate aff rows
        # all carry identical values — deterministic), then refresh the R
        # forward rows the classic way (their adjacency is arbitrary graph
        # nodes, not derivable from any existing payload row; R rows ≪ R·M)
        c = pack_pay.shape[0] // n_cap
        cid = (aff[:, None] * c
               + jnp.arange(c, dtype=jnp.int32)[None, :]).reshape(-1)
        pack_pay = pack_pay.at[cid].set(
            aff_pay8.reshape(cid.shape[0], pack_pay.shape[1])
        )
        pack_meta = pack_meta.at[aff].set(
            jnp.concatenate([aff_ids_new, aff_norms], axis=1)
        )
        if pack_dist is not None:
            pack_dist = pack_dist.at[aff].set(aff_d_new)
        pk = pk._replace(pay=pack_pay, meta=pack_meta, dist=pack_dist)
        sink = n_cap - 1
        fwd_rows = jnp.where(valid, p_ids, sink)
        pk = refresh_payload_rows(pk, vectors, scales, adj0, fwd_rows,
                                  metric=metric)
        pack_pay, pack_meta, pack_dist = pk.pay, pk.meta, pk.dist
    else:
        adj0 = apply_edges(
            adj0, vectors, scales, norms, p_ids, sel_ids, sel_d, valid,
            m_max0, rev_cap, metric, keep_pruned,
            heuristic=heuristic,
        )

    # ---- entry point / max level (first-max ⇒ matches sequential ties)
    lv = jnp.where(valid, new_levels, -1)
    best = jnp.max(lv)
    bi = jnp.argmax(lv)
    raise_entry = best > max_level_pre
    entry = jnp.where(raise_entry, p_ids[bi], graph.entry).astype(jnp.int32)
    max_level = jnp.maximum(max_level_pre, best)

    out_graph = GraphTensors(
        vectors=vectors,
        scales=scales,
        norms=norms,
        adj0=adj0,
        adj_up=arena,
        up_base=up_base,
        up_n=up_n,
        levels=levels,
        entry=entry,
        max_level=max_level,
        n=graph.n + count.astype(jnp.int32),
        deleted=graph.deleted,
        l_max_static=graph.l_max_static,
    )
    if not use_seeds:
        return (out_graph, None, None, None, None, pack_pay, pack_meta,
                pack_dist)

    # ---- append this round's new upper nodes to the seed bank
    is_up = valid & (new_levels >= 1)
    slot = seed_n + jnp.cumsum(is_up.astype(jnp.int32)) - 1
    keep = is_up & (slot < seed_bank.shape[0])
    safe_slot = jnp.where(keep, slot, seed_bank.shape[0] - 1)
    seed_bank = seed_bank.at[safe_slot].max(jnp.where(keep, p_ids, -1))
    # (capacity has 3x headroom over E[n/M]; silent drop beyond it only
    # degrades entry quality, never correctness)
    seed_n = seed_n + jnp.sum(keep.astype(jnp.int32))
    if use_seed_cache:
        # append the new upper nodes' (dequantized) vectors + norms; dropped
        # (non-keep) rows scatter out of bounds with mode="drop" so they can
        # never race a legitimate write to the same slot
        deq = (qrows.astype(jnp.float32) * qscales[:, None]).astype(
            jnp.bfloat16)
        drop_slot = jnp.where(keep, slot, seed_bank.shape[0])
        seed_vecs = seed_vecs.at[drop_slot].set(deq, mode="drop")
        seed_norms = seed_norms.at[drop_slot].set(norms_store, mode="drop")
    return (out_graph, seed_bank, seed_n, seed_vecs, seed_norms,
            pack_pay, pack_meta, pack_dist)


# ------------------------------------------------------- scan round driver
@jax.jit
def _normalize_rows(data):
    """Row-normalized copy of a device array, built by a slab fori_loop so
    the transient beyond the output is one f32 slab (a whole-array f32 temp
    of a bf16 source doubles the peak).  The caller's array is left intact.

    Slabs past the end clamp to the last full-slab start, so tail rows are
    normalized twice — idempotent, and cheaper than shape-specializing the
    tail."""
    n = data.shape[0]
    if n == 0:
        return data
    slab = min(262144, n)

    def body(i, buf):
        start = jnp.minimum(i * slab, n - slab)
        blk = jax.lax.dynamic_slice_in_dim(buf, start, slab).astype(
            jnp.float32)
        nrm = jnp.linalg.norm(blk, axis=1, keepdims=True)
        blk = (blk / jnp.where(nrm == 0, 1.0, nrm)).astype(buf.dtype)
        return jax.lax.dynamic_update_slice_in_dim(buf, blk, start, 0)

    return jax.lax.fori_loop(0, -(-n // slab), body, data)


def _pick_round(data, levels, done, count, rs: int):
    """Slice one round's rows out of the device-resident payload (clip-gather
    so no padded copy of `data` is ever made; rows past `count` are masked to
    level 0 and their content is ignored by insert_round's valid mask)."""
    idx = jnp.minimum(
        done + jnp.arange(rs, dtype=jnp.int32), data.shape[0] - 1
    )
    vecs = jnp.take(data, idx, axis=0)
    lv = jnp.where(jnp.arange(rs) < count, jnp.take(levels, idx), 0)
    return vecs, lv


_pick_round_jit = jax.jit(_pick_round, static_argnames=("rs",))


@partial(
    jax.jit,
    static_argnames=(
        "rs", "efc", "m", "m_max0", "rev_cap", "metric", "keep_pruned",
        "storage", "build_mi", "build_ck", "build_expand", "extend",
        "heuristic", "select_scan",
    ),
    donate_argnames=("graph", "seed_bank", "seed_n", "seed_vecs",
                     "seed_norms", "pack_pay", "pack_meta",
                     "pack_dist"),
)
def insert_rounds_scan(
    graph: GraphTensors,
    data,  # f32[n_new, D] device-resident, already metric-prepped
    levels,  # i32[n_new]
    dones,  # i32[C] round offsets into data/levels
    counts,  # i32[C] live rows per round
    seed_bank, seed_n, seed_vecs, seed_norms,
    pack_pay=None, pack_meta=None, pack_scale=None, pack_dist=None,
    *,
    rs: int,
    efc: int, m: int, m_max0: int, rev_cap: int, metric: str,
    keep_pruned: bool, storage: str, build_mi, build_ck,
    build_expand: int, extend: bool, heuristic: bool, select_scan,
):
    """A fixed-length `lax.scan` of insert_round: C rounds in ONE dispatch.

    A per-round Python loop pays host->device puts and a dispatch per
    round.  Scanning C rounds moves the whole schedule to the device: zero
    puts, one dispatch, and XLA keeps the carry (the graph) in place."""
    packed = pack_pay is not None

    def body(carry, x):
        done, count = x
        vecs, lv = _pick_round(data, levels, done, count, rs)
        kw = dict(
            efc=efc, m=m, m_max0=m_max0, rev_cap=rev_cap, metric=metric,
            keep_pruned=keep_pruned, storage=storage, build_mi=build_mi,
            build_ck=build_ck, build_expand=build_expand, extend=extend,
            heuristic=heuristic, select_scan=select_scan,
        )
        if packed:
            graph, bank, bn, bvec, bnrm, pay, meta, pdist = carry
            out = insert_round(
                graph, vecs, lv, graph.n, count, bank, bn, bvec, bnrm,
                pay, meta, pack_scale, pdist, **kw,
            )
            return out, None
        graph, bank, bn, bvec, bnrm = carry
        out = insert_round(
            graph, vecs, lv, graph.n, count, bank, bn, bvec, bnrm, **kw,
        )
        return out[:5], None

    if packed:
        carry0 = (graph, seed_bank, seed_n, seed_vecs, seed_norms,
                  pack_pay, pack_meta, pack_dist)
        (graph, seed_bank, seed_n, seed_vecs, seed_norms, pack_pay,
         pack_meta, pack_dist), _ = jax.lax.scan(
            body, carry0, (dones, counts))
    else:
        carry0 = (graph, seed_bank, seed_n, seed_vecs, seed_norms)
        (graph, seed_bank, seed_n, seed_vecs, seed_norms), _ = jax.lax.scan(
            body, carry0, (dones, counts))
    return (graph, seed_bank, seed_n, seed_vecs, seed_norms,
            pack_pay, pack_meta, pack_dist)


# ---------------------------------------------------------------- bootstrap
@partial(jax.jit, static_argnames=("metric", "storage"),
         donate_argnames=("graph",))
def bootstrap(graph: GraphTensors, vec, level, metric: str,
              storage: str = "f32") -> GraphTensors:
    """Insert the very first point (no search needed — empty graph).

    Jitted with the graph donated: the eager `.at[0].set` chain transiently
    doubles the vectors tensor, which a near-full device cannot afford."""
    q = jnp.asarray(vec, jnp.float32)[None, :]
    qrows, qscales, qnorms = quantize_rows(q, storage)
    if metric != "l2":
        qnorms = jnp.zeros_like(qnorms)
    return graph._replace(
        vectors=graph.vectors.at[0].set(qrows[0]),
        scales=graph.scales.at[0].set(qscales[0]),
        norms=graph.norms.at[0].set(qnorms[0]),
        levels=graph.levels.at[0].set(
            jnp.asarray(level, graph.levels.dtype)),
        up_base=graph.up_base.at[0].set(
            jnp.where(jnp.asarray(level) >= 1, 0, -1).astype(jnp.int32)),
        up_n=jnp.asarray(level, jnp.int32),
        entry=jnp.int32(0),
        max_level=jnp.asarray(level, jnp.int32),
        n=jnp.int32(1),
    )


# ------------------------------------------------------------------- driver
class BuildState:
    """Host-side build driver: owns the RNG stream (level sampling is the only
    randomness, SURVEY.md §4) and the doubling round schedule."""

    def __init__(self, config: HnswConfig, max_elements: int,
                 round_size: int = 1024):
        self.config = config
        self.round_size = round_size
        # reserve headroom: one padded round may run past max_elements, and
        # the last row is the scatter sink (pad_row) — never occupied
        self.max_elements = max_elements
        n_cap_target = max_elements + round_size + 1
        self.graph = empty_graph(config, n_cap_target)
        self.l_max = self.graph.l_max
        self.rng = np.random.RandomState(config.seed)
        # reverse-edge candidates kept per target per round: the shrink
        # heuristic's pairwise matmul is O((m_cap + rev_cap)^2) per affected
        # row, and >M new back-edges landing on one node in one round is rare;
        # nearest-M semantics keep the drop deterministic.
        self.rev_cap = 8
        # matmul entry-scan state: ids of level>=1 nodes + live count, and a host
        # mirror of the graph's max level (observability; the rolled
        # insert_round derives its own dynamic round top on device)
        u_cap = seed_capacity(self.graph.n_cap, config.M)
        self.seed_bank = jnp.full((u_cap,), -1, jnp.int32)
        self.seed_n = jnp.int32(0)
        # bf16 cache of the bank rows (scan precision; winners re-scored
        # exactly) — saves the whole-bank gather every round
        self.seed_vecs = jnp.zeros((u_cap, config.dim), jnp.bfloat16)
        self.seed_norms = jnp.zeros((u_cap,), jnp.float32)
        self.host_max_level = -1
        self.host_upper_count = 0  # mirror of seed_n (descent-skip decision)
        self.host_up_n = 0  # mirror of graph.up_n (arena-capacity pre-check)
        # host mirror of graph.n: the round loop must never fetch a device
        # scalar — each fetch waits for the queued work and serializes the
        # otherwise fully-async dispatch stream
        self.host_n = 0
        # level-0 build-beam throughput knobs (see insert_round): candidate
        # compaction defaults on for wide candidate blocks.  (expand, mi):
        # e=8/mi=24 on the PACKED path visits the same ~192 nodes per beam
        # as e=4/mi=48 in half the serial iterations (fatter gathers, same
        # trajectory quality); classic builds (small N, or payload over
        # budget) keep the conservative (48, 4).  "auto" resolves per path
        # in _round_kwargs; users may still pin explicit ints.  select_scan
        # stays None: capping the admit scan costs end recall.
        self.build_mi: int | str | None = "auto"
        self.build_expand: int | str = "auto"
        self.select_scan: int | None = None
        self.build_ck: int | None = (
            (3 * 4 * config.M_max0) // 4 if 4 * config.M_max0 >= 128 else None
        )
        # packed construction (models/packed.py build-time maintenance):
        # level-0 beams on the inline-int8 payload.  Auto-enabled on the
        # first add() when the index is large enough to matter and the
        # payload fits; None = undecided, False = decided off.
        self.pack_pay = None
        self.pack_meta = None
        self.pack_scale = None
        self.pack_dist = None
        self._packed_build: bool | None = None
        # deferred scale-growth check state (see _maybe_init_packed): a lazy
        # device-side max of the last device-array add, and a host mirror of
        # the range the current scale covers (scale * 127)
        self._pack_pending_mx = None
        self._pack_covered: float | None = None
        # opt-out of the bulk first-add constructor: users who
        # need reference-matching incremental construction order (bitwise
        # graph reproducibility across versions) set this False; recall
        # parity between the two paths is tested either way (test_bulk.py)
        self.bulk_first_add: bool = True
        self._warned_seed_drop = False

    # first add() of at least this many rows into an EMPTY index takes the
    # bulk constructor (models/bulk.py) instead of incremental rounds; the
    # margin keeps small indexes on the exhaustively-tested round path
    BULK_THRESHOLD = 100_000
    #: transient-workspace budget for the bulk passes, as a share of the
    #: device memory (utils/memory.py), leaving room for the graph tensors
    #: the build allocates either way
    BULK_BUDGET_SHARE = 0.5

    @classmethod
    def bulk_budget_bytes(cls) -> int:
        from ocaml_hnsw_tpu.utils.memory import budget_bytes

        return budget_bytes(cls.BULK_BUDGET_SHARE)

    def _bulk_eligible(self, n_new: int) -> bool:
        cfg = self.config
        if not self.bulk_first_add:
            return False
        if self.host_n or n_new < self.BULK_THRESHOLD:
            return False
        # bulk_build pads every pass to the index CAPACITY, so a sparse
        # first add into a much larger index would pay ~capacity/n_new
        # extra compute vs the round path (and the workspace scales the
        # same way) — bulk only when the first batch mostly fills the index
        if 2 * n_new < self.max_elements:
            return False
        # the bulk passes reproduce heuristic-select semantics only; the
        # simple selector / extend_candidates modes keep the round path
        if cfg.select != "heuristic" or cfg.extend_candidates:
            return False
        # memory guard, sized from the capacity-padded workspace bulk_build
        # actually allocates (an n_new-based estimate passes at shapes that
        # run out of memory)
        from ocaml_hnsw_tpu.models.bulk import bulk_workspace_bytes

        n_cap = capacity(self.max_elements + self.round_size + 1)
        need = bulk_workspace_bytes(n_cap, cfg.dim, m=cfg.M,
                                    m_max0=cfg.M_max0)
        return need < self.bulk_budget_bytes()

    def adopt_graph(self, graph: GraphTensors) -> None:
        """Take over an existing graph (load_index / resize): installs it and
        rebuilds every host-side mirror — max level, upper-node count, arena
        watermark — plus the seed bank (ids of all level>=1 nodes), so
        subsequent add() rounds get scan-seeded entries and the arena-capacity
        pre-check starts from the true watermark."""
        self.graph = graph
        # drop any packed-build payload: it mirrors the OLD adjacency.  The
        # next add() re-decides and (re)packs from the adopted graph.
        self.pack_pay = self.pack_meta = self.pack_scale = None
        self.pack_dist = None
        self._packed_build = None
        self._pack_pending_mx = None
        self._pack_covered = None
        lv = np.asarray(graph.levels)
        n = int(graph.n)
        self.host_n = n
        self.host_max_level = int(lv[:n].max()) if n else -1
        upper = np.nonzero(lv[:n] >= 1)[0].astype(np.int32)
        self.host_upper_count = int(upper.size)
        self.host_up_n = int(graph.up_n)
        cap = self.seed_bank.shape[0]
        bank = np.full((cap,), -1, np.int32)
        keep = min(upper.size, cap)
        bank[:keep] = upper[:keep]
        self.seed_bank = jnp.asarray(bank)
        self.seed_n = jnp.int32(keep)
        # rebuild the bf16 scan cache from the stored vectors (one gather)
        from ocaml_hnsw_tpu.ops.distance import gather_dequant
        from ocaml_hnsw_tpu.ops.metrics import get_metric

        safe = jnp.maximum(self.seed_bank, 0)
        vecs = gather_dequant(graph.vectors, graph.scales, safe[None, :])[0]
        live = (jnp.arange(cap) < keep)[:, None]
        self.seed_vecs = jnp.where(live, vecs, 0.0).astype(jnp.bfloat16)
        nrm = jnp.sum(vecs * vecs, axis=1) \
            if get_metric(self.config.metric).needs_norms \
            else jnp.zeros((cap,), jnp.float32)
        self.seed_norms = jnp.where(live[:, 0], nrm, 0.0)

    def prep(self, data):
        """Normalize at add time (cosine-style metrics) on whichever side the
        data lives."""
        from ocaml_hnsw_tpu.ops.metrics import get_metric

        normalize = get_metric(self.config.metric).normalize_add
        if isinstance(data, jnp.ndarray):
            # device-resident data keeps its dtype (a bf16 source halves the
            # build's device residency at 10M; insert_round casts each
            # round's R-row slice to f32, so compute precision is
            # unchanged).  The caller still owns `data`, so normalization
            # writes a new array and never donates the caller's buffer.
            if normalize:
                data = _normalize_rows(data)
            return data
        data = np.asarray(data, dtype=np.float32)
        if normalize:
            nrm = np.linalg.norm(data, axis=1, keepdims=True)
            data = data / np.where(nrm == 0, 1.0, nrm)
        return data

    #: rounds per lax.scan dispatch, tried largest-first — each length is one
    #: extra compiled program (the scan body is insert_round) reused by every
    #: add() call; the remainder (< min chunk) runs through the per-round
    #: path.  The 8-round scan keeps the per-round tail to < 8 dispatches
    #: (each passing multi-GB donated arguments) for one extra compile
    SCAN_CHUNKS = (64, 8)
    SCAN_CHUNK = 64  # kept: back-compat for tests/scripts that reference it
    #: packed construction auto-enables at this index capacity (below it
    #: the classic beam is cheap and tests keep oracle-parity trajectories)
    PACKED_BUILD_THRESHOLD = 100_000
    #: ... and only while the payload fits this share of device memory
    PACKED_BUILD_BUDGET_SHARE = 0.375

    def _maybe_init_packed(self, data) -> None:
        """Decide once, on the first add(): build the payload tensors when
        the metric has a matmul form and the payload fits the budget."""
        from ocaml_hnsw_tpu.ops.metrics import get_metric
        from ocaml_hnsw_tpu.models.packed import (
            empty_packed, pack_d_pad, pack_graph,
        )

        if self._packed_build is not None:
            if self.pack_scale is not None:
                # a later batch can exceed the payload's quantization range:
                # grow the scale and repack (rare; one pass over adjacency).
                # No per-add host sync: host arrays check on the host for
                # free; device arrays accumulate a LAZY device-side max that
                # is fetched on the next add / at packed_graph() — by then
                # the value is long materialized, so the fetch waits on
                # completed work, not a pipeline stall.  A one-round-late
                # repack only coarsens
                # that round's construction-beam scoring (payload clips at
                # the old grid); stored vectors stay exact and the repack
                # recomputes every payload row.
                if isinstance(data, jnp.ndarray):
                    self._flush_scale_check()
                    self._pack_pending_mx = jnp.max(
                        jnp.abs(data.astype(jnp.float32)))
                else:
                    mx = float(np.max(np.abs(data))) if data.size else 0.0
                    self._grow_scale_if_needed(mx)
            return
        cfg = self.config
        g = self.graph
        deg = g.adj0.shape[1]
        from ocaml_hnsw_tpu.utils.memory import budget_bytes

        fits = (g.n_cap * deg * pack_d_pad(cfg.dim)
                <= budget_bytes(self.PACKED_BUILD_BUDGET_SHARE))
        on = (g.n_cap >= self.PACKED_BUILD_THRESHOLD and fits
              and get_metric(cfg.metric).matmul_score is not None)
        self._packed_build = on
        if not on:
            return
        if self.host_n == 0:
            scale = jnp.maximum(jnp.max(jnp.abs(data)) / 127.0, 1e-30)
            pk = empty_packed(g.n_cap, deg, cfg.dim, scale)
        else:  # adopted/loaded graph: pack what exists
            pk = pack_graph(g, cfg.metric, with_dist=True)
            if isinstance(data, jnp.ndarray):
                mx = float(jnp.max(jnp.abs(data.astype(jnp.float32)))) / 127.0
            else:
                mx = (float(np.max(np.abs(data))) / 127.0) if data.size else 0.0
            cov = float(pk.scale)
            if mx > cov:  # range must cover this batch too
                pk = pack_graph(g, cfg.metric, scale=mx, with_dist=True)
                cov = mx
            self._pack_covered = cov * 127.0
        self.pack_pay, self.pack_meta = pk.pay, pk.meta
        self.pack_scale = pk.scale
        self.pack_dist = pk.dist

    def _flush_scale_check(self) -> None:
        """Materialize the deferred device-side batch max (if any) and grow
        the payload scale when it exceeded the covered range."""
        if self._pack_pending_mx is None:
            return
        mx = float(self._pack_pending_mx)
        self._pack_pending_mx = None
        self._grow_scale_if_needed(mx)

    def _grow_scale_if_needed(self, mx: float) -> None:
        if self.pack_scale is None:
            return
        if self._pack_covered is None:  # one fetch per build lifetime
            self._pack_covered = float(self.pack_scale) * 127.0
        if mx <= self._pack_covered:
            return
        from ocaml_hnsw_tpu.models.packed import pack_graph

        pk = pack_graph(self.graph, self.config.metric,
                        scale=mx / 127.0, with_dist=True)
        self.pack_pay, self.pack_meta = pk.pay, pk.meta
        self.pack_scale = pk.scale
        self.pack_dist = pk.dist
        self._pack_covered = mx

    def packed_graph(self):
        """The live build-maintained payload as a PackedGraph (or None) —
        exactly what pack_graph(graph) would produce, for free."""
        if self.pack_pay is None:
            return None
        self._flush_scale_check()
        from ocaml_hnsw_tpu.models.packed import PackedGraph

        return PackedGraph(pay=self.pack_pay, meta=self.pack_meta,
                           scale=self.pack_scale, dist=self.pack_dist)

    def _round_kwargs(self) -> dict:
        cfg = self.config
        packed = bool(self._packed_build)
        build_mi = self.build_mi
        build_expand = self.build_expand
        if build_mi == "auto":
            build_mi = 24 if packed else 48
        if build_expand == "auto":
            build_expand = 8 if packed else 4
        return dict(
            efc=cfg.ef_construction,
            m=cfg.M,
            m_max0=cfg.M_max0,
            rev_cap=self.rev_cap,
            metric=cfg.metric,
            keep_pruned=cfg.keep_pruned_connections,
            storage=cfg.storage,
            build_mi=build_mi,
            build_ck=self.build_ck,
            build_expand=build_expand,
            extend=cfg.extend_candidates,
            heuristic=cfg.select == "heuristic",
            select_scan=self.select_scan,
        )

    def add(self, data) -> None:
        """Insert `data` (host numpy OR a device array) via padded fixed-shape
        rounds.  The whole call ships at most two host->device transfers (the
        vectors and the sampled levels); the round schedule then runs as
        lax.scan chunks of SCAN_CHUNK insert_rounds per dispatch (see
        insert_rounds_scan)."""
        cfg = self.config
        rs = self.round_size
        if self.host_n + data.shape[0] > self.max_elements:
            raise RuntimeError(
                f"index is full: {self.host_n} + {data.shape[0]} > "
                f"max_elements {self.max_elements}"
            )
        data = self.prep(data)
        n_new = data.shape[0]
        levels = sample_levels(self.rng, n_new, cfg.mL, self.l_max)
        if self._bulk_eligible(n_new):
            # whole-dataset first add(): construct via the bulk passes
            # (models/bulk.py — exact-kNN + Alg 4 select + sort-scatter
            # reverse + shrink) instead of ~n/R dependent beam rounds.
            # Levels come from THIS state's RNG stream (sampled above), so
            # the stream position after the call matches the incremental
            # path exactly; adopt_graph rebuilds every host mirror and the
            # seed bank, and later add() calls stream on top incrementally.
            from ocaml_hnsw_tpu.models.bulk import bulk_build

            graph = bulk_build(
                data, cfg, max_elements=self.max_elements + rs + 1,
                levels=np.asarray(levels),
            )
            self.adopt_graph(graph)
            return
        # arena-capacity pre-check, exact (host knows every sampled level):
        # the last arena row is the reserved scatter sink
        need = self.host_up_n + int(levels.sum())
        if need > self.graph.t_cap - 1:
            raise RuntimeError(
                f"upper-arena overflow: need {need} rows, capacity "
                f"{self.graph.t_cap - 1} — astronomically unlikely at default "
                f"mL; raise arena_capacity's margin if hit"
            )
        self.host_up_n = need
        if not isinstance(data, jnp.ndarray):
            data = jnp.asarray(data)  # ONE put for the whole call
        levels_dev = jnp.asarray(levels)  # and one for the levels
        if n_new:
            self._maybe_init_packed(data)
        done = 0
        if self.host_n == 0:
            lvl0 = int(levels[0])
            self.graph = bootstrap(
                self.graph, data[0], lvl0, cfg.metric, storage=cfg.storage,
            )
            if lvl0 >= 1:
                self.seed_bank = self.seed_bank.at[0].set(0)
                self.seed_n = jnp.int32(1)
                self.host_upper_count = 1
                g0 = self.graph
                v0 = (g0.vectors[0].astype(jnp.float32) * g0.scales[0])
                self.seed_vecs = self.seed_vecs.at[0].set(
                    v0.astype(jnp.bfloat16))
                self.seed_norms = self.seed_norms.at[0].set(g0.norms[0])
            self.host_max_level = lvl0
            self.host_n = 1
            done = 1
        # host-side schedule (doubling: a round never inserts more points
        # than the pre-round snapshot holds) + packed-width pre-check
        w_1 = upper_round_width(rs, cfg.M, 1)
        w_2 = upper_round_width(rs, cfg.M, 2)
        rounds = []
        n_cur = self.host_n
        while done < n_new:
            count = min(rs, n_new - done, max(n_cur, 1))
            lv_r = levels[done : done + count]
            c_1 = int((lv_r >= 1).sum())
            c_2 = int((lv_r >= 2).sum())
            if c_1 > w_1 or c_2 > w_2:
                raise RuntimeError(
                    f"round has {c_1} points at level>=1 / {c_2} at "
                    f"level>=2, packed widths {w_1}/{w_2} — astronomically "
                    f"unlikely at default mL; raise upper_round_width's "
                    f"margin if hit"
                )
            rounds.append((done, count))
            n_cur += count
            done += count
        kw = self._round_kwargs()
        i = 0
        rounds_since_sync = 0
        # host mirror of graph.n for the per-round path's `start` argument:
        # graph.n itself is part of the DONATED graph tree, and passing the
        # same buffer again as a separate argument trips XLA's runtime
        # donation-aliasing check (an async InvalidArgument)
        n_base = self.host_n - (rounds[0][0] if rounds else 0)
        while i < len(rounds):
            # Bound the in-flight dispatch queue: one scalar fetch per ~256
            # rounds keeps a whole 10M build (~4900 rounds) from being
            # enqueued at once.  Whether this still pays on a local GPU is
            # not measured yet.
            if rounds_since_sync >= 256:
                np.asarray(self.graph.n)
                rounds_since_sync = 0
            chunk_len = next(
                (c for c in self.SCAN_CHUNKS if len(rounds) - i >= c), None
            )
            if chunk_len is not None:
                chunk = rounds[i : i + chunk_len]
                (self.graph, self.seed_bank, self.seed_n, self.seed_vecs,
                 self.seed_norms, self.pack_pay, self.pack_meta,
                 self.pack_dist) = insert_rounds_scan(
                    self.graph, data, levels_dev,
                    jnp.asarray(np.array([d for d, _ in chunk], np.int32)),
                    jnp.asarray(np.array([c for _, c in chunk], np.int32)),
                    self.seed_bank, self.seed_n, self.seed_vecs,
                    self.seed_norms, self.pack_pay, self.pack_meta,
                    self.pack_scale, self.pack_dist, rs=rs, **kw,
                )
                i += chunk_len
                rounds_since_sync += chunk_len
            else:
                d, count = rounds[i]
                vecs, lvls = _pick_round_jit(
                    data, levels_dev, jnp.int32(d), jnp.int32(count), rs=rs
                )
                (self.graph, self.seed_bank, self.seed_n, self.seed_vecs,
                 self.seed_norms, self.pack_pay, self.pack_meta,
                 self.pack_dist) = insert_round(
                    self.graph, vecs, lvls, jnp.int32(n_base + d),
                    jnp.int32(count),
                    self.seed_bank, self.seed_n, self.seed_vecs,
                    self.seed_norms, self.pack_pay, self.pack_meta,
                    self.pack_scale, self.pack_dist, **kw,
                )
                i += 1
                rounds_since_sync += 1
        if rounds:
            tail = levels[rounds[0][0]:]  # rows inserted by the rounds
            self.host_max_level = max(self.host_max_level, int(tail.max()))
            self.host_upper_count += int((tail >= 1).sum())
            self.host_n += int(sum(c for _, c in rounds))
            bank_cap = int(self.seed_bank.shape[0])
            if self.host_upper_count > bank_cap and not self._warned_seed_drop:
                # the device-side append silently drops beyond capacity —
                # correct (entry quality only degrades) but worth one log
                # line when it actually happens (capacity has 3x headroom
                # over E[n/M], so this fires only at pathological level
                # distributions)
                import warnings

                warnings.warn(
                    f"seed bank full: {self.host_upper_count} upper nodes > "
                    f"capacity {bank_cap}; newest upper nodes won't seed "
                    "entry scans (recall may need slightly higher ef)",
                    RuntimeWarning, stacklevel=2,
                )
                self._warned_seed_drop = True


def build(data: np.ndarray, config: HnswConfig,
          max_elements: int | None = None, round_size: int = 1024,
          ) -> GraphTensors:
    """Build a full index over `data` with batched parallel insertion."""
    data = np.asarray(data, dtype=np.float32)
    state = BuildState(config, max_elements or data.shape[0],
                       round_size=round_size)
    state.add(data)
    return state.graph
