"""Packed inline-neighbor query engine — a redesign of the reference's
`search_layer` hot loop (SURVEY.md §3.3) around the device's memory system.

Why this exists:

  * The classic engine's cost is the per-iteration gather of E·deg candidate
    vector rows (E·deg scattered 512 B f32 rows per query at 128-d).
    Random-row gathers pay per transaction, so the lever is *fewer, fatter
    transactions*.
  * Inline the neighborhood: store, per node, its deg neighbors' vectors as
    int8 in one contiguous payload.  Expanding E nodes then gathers E·C
    consecutive ~2 KB chunk rows instead of E·deg scattered rows, and reads
    4× fewer bytes per neighbor.
  * Score the gathered block with a bf16 elementwise multiply-reduce.
    Whether an int8 `dot_general` with int32 accumulation scores faster on
    the GPU is not measured yet.

Distance arithmetic runs in the quantized domain: vectors are quantized with
ONE global scale s (x8 = round(x/s)), queries likewise, and

    d = s²·(‖x8‖² − 2·x8·q8) + ‖q‖²           (l2)
    d = 1 − s²·(x8·q8)                         (ip / cosine)

where ‖x8‖² is a precomputed exact int32 and x8·q8 is the bf16
multiply-reduce (int8 values are bf16-exact; each product rounds to 8
significand bits — noise well under the s-grid quantization error).  Beam
state stays in true-f32-distance domain, so the bitonic merge machinery, the
seed-scan entry, and tombstone semantics are shared with models/search.py
unchanged; a final exact-f32 rerank of the top beam makes the returned top-k
ordering exact.

The payload costs N·deg·D_pad bytes of device memory (4.1 GB at 1M × 128-d,
M=16) and is rebuilt by `pack_graph` after the graph changes, amortized
across queries (api.Index packs lazily; streaming repacks per ingest
round).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ocaml_hnsw_tpu.models.graph import GraphTensors
from ocaml_hnsw_tpu.models.search import (
    SeedIndex,
    seed_entries,
    descend,
    preprocess_queries,
)
from ocaml_hnsw_tpu.ops.distance import dists_to_ids, query_norms, INF
from ocaml_hnsw_tpu.ops.bitset import first_occurrence_mask
from ocaml_hnsw_tpu.ops.sortmerge import (
    entries_to_beam, merge_into_beam, topk_ascending,
)
from ocaml_hnsw_tpu.utils import round_up


class PackedGraph(NamedTuple):
    """Inline-neighbor payload tensors (a pytree; all shapes static).

    pay:   int8[N_cap·C, W]   node i's neighbors' int8 vectors, flattened to C
                              chunk rows of W bytes each (W·C = deg·D_pad)
    meta:  int32[N_cap, 2·deg]  [adjacency ids | int32 norms ‖x8‖²]; ids are
                              -1 sentinels exactly like GraphTensors.adj0
    scale: f32[]              the global quantization scale s
    dist:  f32[N_cap, deg]    OPTIONAL (build-maintained packs only):
                              exact f32 d(node, neighbor) per adjacency slot,
                              +inf on empty slots — lets apply_edges read the
                              over-full-row distances instead of re-gathering
                              ~R·M·(m_cap+rev_cap) vector rows per round.
                              Query-only packs leave it None.
    """

    pay: jnp.ndarray
    meta: jnp.ndarray
    scale: jnp.ndarray
    dist: jnp.ndarray | None = None

    @property
    def deg(self) -> int:
        return self.meta.shape[1] // 2

    @property
    def n_cap(self) -> int:
        return self.meta.shape[0]

    @property
    def chunks(self) -> int:
        return self.pay.shape[0] // self.meta.shape[0]

    @property
    def d_pad(self) -> int:
        return (self.pay.shape[1] * self.chunks) // self.deg


def _chunk_width(total: int, max_chunk: int = 2048) -> int:
    """Chunk rows of <= max_chunk bytes.  The gather pays per row, so
    fewer/fatter chunks win up to the width where a row stops being one
    transaction; callers raise max_chunk to fetch each node's payload as
    ONE row (e.g. 4096 at deg=32 x 128-d int8).  Default 2048."""
    if total <= max_chunk:
        return total
    for w in (4096, 3584, 3072, 2560, 2048, 1536, 1280, 1024, 512, 256, 128):
        if w <= max_chunk and total % w == 0 and total // w >= 1:
            return w
    # no preferred width divides: take the largest divisor <= max_chunk
    # rather than silently emitting rows past the fat-row gather cliff
    best = max((w for w in range(1, max_chunk + 1) if total % w == 0),
               default=None)
    if best is None or best < 32:
        raise ValueError(
            f"no payload chunk width <= {max_chunk} divides row size {total}"
        )
    return best


def pack_d_pad(dim: int) -> int:
    """Payload inner dim: pad to the int8 lane width so the [B,E,deg,D] view
    of the gathered chunk rows is a relayout-free reshape."""
    return round_up(dim, 128)


def _int8_sqnorm(y):
    """Exact ‖y‖² of int8 rows as int32, computed in f32.

    Products ≤ 127² = 16129 and sums ≤ D·16129 are exactly representable in
    f32 up to D = 1039 (< 2²⁴), so the f32 multiply-reduce is bit-exact
    there.  Falls back to int32 arithmetic for wider rows."""
    if y.shape[-1] <= 1024:
        yf = y.astype(jnp.float32)
        return jnp.sum(yf * yf, axis=-1).astype(jnp.int32)
    yi = y.astype(jnp.int32)
    return jnp.sum(yi * yi, axis=-1)


def _nibble_pack(y):
    """int8 values in [-8, 7] -> nibble-packed int8, two per byte along the
    last axis: byte j = (y[2j+1] << 4) | (y[2j] & 0xF)."""
    lo = y[..., 0::2]
    hi = y[..., 1::2]
    return ((hi.astype(jnp.int32) << 4)
            | (lo.astype(jnp.int32) & 0xF)).astype(jnp.int8)


def nibble_unpack_bf16(v):
    """Packed int4 bytes -> (lo, hi) bf16 planes (each [-8, 7]); lo holds
    even dims, hi odd dims.  The XOR trick decodes the signed low nibble
    without a widening shift: ((v & 0xF) ^ 8) - 8."""
    vi = v.astype(jnp.int32)
    lo = ((vi & 0xF) ^ 8) - 8
    hi = (vi >> 4)  # arithmetic shift: signed high nibble directly
    return lo.astype(jnp.bfloat16), hi.astype(jnp.bfloat16)


def _i32_to_bytes(x):
    """int32[..., K] -> int8[..., 4K] little-endian byte view."""
    return jax.lax.bitcast_convert_type(x, jnp.int8).reshape(
        x.shape[:-1] + (x.shape[-1] * 4,))


def _bytes_to_i32(x):
    """int8[..., 4K] -> int32[..., K] (inverse of _i32_to_bytes)."""
    return jax.lax.bitcast_convert_type(
        x.reshape(x.shape[:-1] + (x.shape[-1] // 4, 4)), jnp.int32)


#: total bytes of fused per-node metadata: 32 int32 ids + 32 int32 norms
#: (deg<=32 pads), split evenly across the node's chunks — see
#: pack_graph(fused=True)
FUSED_META_TOTAL = 256


@partial(jax.jit, static_argnames=("d_pad", "w", "slab", "metric",
                                   "with_dist", "bits", "fused"))
def _pack_rounds(vectors, scales, adj0, inv_s, d_pad: int, w: int, slab: int,
                 metric: str = "l2", with_dist: bool = False, bits: int = 8,
                 fused: bool = False):
    from ocaml_hnsw_tpu.ops.metrics import get_metric

    n_cap, deg = adj0.shape
    d = vectors.shape[1]
    stored = d_pad if bits == 8 else d_pad // 2  # bytes per neighbor
    c = (deg * stored) // w
    row_w = w + FUSED_META_TOTAL // c if fused else w
    pay = jnp.zeros((n_cap * c, row_w), jnp.int8)
    meta = jnp.zeros((n_cap, 2 * deg), jnp.int32)
    dist = jnp.full((n_cap, deg), INF) if with_dist else None
    qmax = 127 if bits == 8 else 7

    def body(i, carry):
        pay, meta, dist = carry
        start = i * slab
        a = jax.lax.dynamic_slice_in_dim(adj0, start, slab)  # [S, deg]
        safe = jnp.maximum(a, 0)
        rows = vectors[safe].astype(jnp.float32)
        if vectors.dtype == jnp.int8:
            rows = rows * scales[safe][:, :, None]
        y = jnp.clip(jnp.round(rows * inv_s), -qmax, qmax).astype(jnp.int8)
        nrm = _int8_sqnorm(y)  # [S, deg] int32, exact
        if with_dist:
            own = jax.lax.dynamic_slice_in_dim(vectors, start, slab)
            own = own.astype(jnp.float32)
            if vectors.dtype == jnp.int8:
                own = own * jax.lax.dynamic_slice_in_dim(
                    scales, start, slab)[:, None]
            dd = get_metric(metric).pair_dist(rows, own)  # [S, deg]
            dd = jnp.where(a < 0, INF, dd)
            dist = jax.lax.dynamic_update_slice_in_dim(dist, dd, start, 0)
        if d_pad > d:
            y = jnp.pad(y, ((0, 0), (0, 0), (0, d_pad - d)))
        if bits == 4:
            y = _nibble_pack(y)
        if fused:
            # chunk j of node v = [meta_j (128 B) | its w/c payload bytes]:
            # meta_0 carries the 32 ids, meta_1 the 32 int32 norms (deg<32
            # rows pad with -1 ids / 0 norms), so ONE gather of the node's
            # chunk rows delivers adjacency + norms + vectors — no separate
            # meta-table gather per iteration
            pad_deg = 32 - deg
            ids_b = _i32_to_bytes(
                jnp.pad(a, ((0, 0), (0, pad_deg)), constant_values=-1))
            nrm_b = _i32_to_bytes(
                jnp.pad(nrm, ((0, 0), (0, pad_deg))))
            mblk = jnp.concatenate([ids_b, nrm_b], axis=1).reshape(
                slab, c, FUSED_META_TOTAL // c)  # ids then norms, c splits
            vblk = y.reshape(slab, c, w)
            rows_out = jnp.concatenate([mblk, vblk], axis=2)
            pay = jax.lax.dynamic_update_slice_in_dim(
                pay, rows_out.reshape(slab * c, row_w), start * c, 0
            )
        else:
            pay = jax.lax.dynamic_update_slice_in_dim(
                pay, y.reshape(slab * c, w), start * c, 0
            )
        meta = jax.lax.dynamic_update_slice_in_dim(
            meta, jnp.concatenate([a, nrm], axis=1), start, 0
        )
        return pay, meta, dist

    return jax.lax.fori_loop(0, n_cap // slab, body, (pay, meta, dist))


def pack_graph(graph: GraphTensors, metric: str,
               scale=None, with_dist: bool = False,
               max_chunk: int = 2048, bits: int = 8,
               fused: bool = False) -> PackedGraph:
    """Build the inline-neighbor payload from a (re)built graph.

    One pass over adjacency in slabs; the global scale is the
    max |component| of the stored vectors (dequantized) — or the caller's
    `scale` when future inserts/queries need a wider range — so integer-grid
    data quantizes exactly.  Must be re-run after any insert (api.Index does
    this lazily via a dirty flag; BuildState maintains it incrementally)."""
    from ocaml_hnsw_tpu.ops.metrics import get_metric

    if get_metric(metric).matmul_score is None:
        raise ValueError(
            f"metric {metric!r} has no matmul_score; the packed engine's "
            "int8 dot path needs one — use the classic knn_search"
        )
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    deg = graph.adj0.shape[1]
    d_pad = pack_d_pad(graph.dim)
    stored = d_pad if bits == 8 else d_pad // 2
    w = _chunk_width(deg * stored, max_chunk)
    if fused:
        c = (deg * stored) // w
        if deg > 32 or FUSED_META_TOTAL % c or with_dist:
            raise ValueError(
                "fused meta layout supports deg<=32, chunk counts dividing "
                "256, and query-only packs (no with_dist)"
            )
    n_cap = graph.n_cap
    slab = min(8192, n_cap)
    while n_cap % slab:
        slab //= 2
    grid = 127.0 if bits == 8 else 7.0
    if scale is None:
        vmax = jnp.max(jnp.abs(graph.vectors.astype(jnp.float32)))
        if graph.vectors.dtype == jnp.int8:
            vmax = jnp.max(
                jnp.abs(graph.vectors.astype(jnp.float32))
                * graph.scales[:, None]
            )
        s = jnp.maximum(vmax / grid, 1e-30)
    else:
        s = jnp.maximum(jnp.asarray(scale, jnp.float32), 1e-30)
    pay, meta, dist = _pack_rounds(
        graph.vectors, graph.scales, graph.adj0, 1.0 / s,
        d_pad=d_pad, w=w, slab=slab, metric=metric, with_dist=with_dist,
        bits=bits, fused=fused,
    )
    return PackedGraph(pay=pay, meta=meta, scale=s.astype(jnp.float32),
                       dist=dist)


def quantize_queries(q, scale):
    """Round preprocessed queries onto the payload's s-grid (int8[B, D])."""
    return jnp.clip(jnp.round(q / scale), -127, 127).astype(jnp.int8)


# --------------------------------------------------- build-time maintenance
# The level-0 construction beam dominates an insert round, and it pays the
# same per-row gather tax the packed engine was built to avoid.  Maintaining
# the payload *during* construction lets insert_round run its efc-wide beam
# on inlined int8 neighborhoods; each round then refreshes only the O(R·M)
# payload rows whose adjacency changed instead of re-packing the graph.

def empty_packed(n_cap: int, deg: int, dim: int, scale) -> PackedGraph:
    """All-sentinel payload for an empty graph (meta ids -1, zero norms,
    dists +inf).  Build-maintained packs always carry `dist` (apply_edges
    reads it instead of re-gathering over-full rows' vectors)."""
    d_pad = pack_d_pad(dim)
    w = _chunk_width(deg * d_pad)
    c = (deg * d_pad) // w
    meta = jnp.concatenate(
        [jnp.full((n_cap, deg), -1, jnp.int32),
         jnp.zeros((n_cap, deg), jnp.int32)], axis=1,
    )
    return PackedGraph(
        pay=jnp.zeros((n_cap * c, w), jnp.int8),
        meta=meta,
        scale=jnp.asarray(scale, jnp.float32),
        dist=jnp.full((n_cap, deg), INF),
    )


def refresh_payload_rows(packed: PackedGraph, vectors, scales, adj0, rows,
                         metric: str = "l2"):
    """Recompute pay/meta (and dist, when maintained) for the given node ids
    (i32[A], duplicates fine — they all compute identical values; pass the
    sink row n_cap-1 for masked slots, it recomputes to all-sentinel).
    `vectors` must already contain the current rows (insert_round scatters
    the round's vectors first)."""
    from ocaml_hnsw_tpu.ops.distance import gather_dequant
    from ocaml_hnsw_tpu.ops.metrics import get_metric

    deg, c = packed.deg, packed.chunks
    d_pad = packed.d_pad
    a = adj0[rows]  # [A, deg]
    safe = jnp.maximum(a, 0)
    v = gather_dequant(vectors, scales, safe)  # [A, deg, D] f32
    inv = 1.0 / packed.scale
    y = jnp.clip(jnp.round(v * inv), -127, 127).astype(jnp.int8)
    nrm = _int8_sqnorm(y)  # [A, deg] int32, exact
    d = v.shape[-1]
    if d_pad > d:
        y = jnp.pad(y, ((0, 0), (0, 0), (0, d_pad - d)))
    n_rows = rows.shape[0]
    cid = (rows[:, None] * c
           + jnp.arange(c, dtype=jnp.int32)[None, :]).reshape(-1)
    pay = packed.pay.at[cid].set(y.reshape(n_rows * c, packed.pay.shape[1]))
    meta = packed.meta.at[rows].set(jnp.concatenate([a, nrm], axis=1))
    dist = packed.dist
    if dist is not None:
        own = gather_dequant(vectors, scales, rows[:, None])[:, 0]  # [A, D]
        dd = get_metric(metric).pair_dist(v, own)  # [A, deg] exact f32
        dd = jnp.where(a < 0, INF, dd)
        dist = dist.at[rows].set(dd)
    return packed._replace(pay=pay, meta=meta, dist=dist)


def _packed_layout(packed: PackedGraph, expand: int, ef: int,
                   deg_limit: int | None, bits: int, fused: bool):
    """Resolve the static payload-layout constants the beam body needs."""
    deg, c, w = packed.deg, packed.chunks, packed.pay.shape[1]
    if fused:
        if deg_limit is not None:
            raise ValueError("deg_limit is unsupported on fused payloads")
        mpc = FUSED_META_TOTAL // c  # meta bytes per chunk row
        stored = ((w - mpc) * c) // deg
    else:
        mpc = 0
        stored = packed.d_pad  # BYTES per neighbor (d_pad/2 when bits=4)
    if deg_limit is not None and deg_limit < deg:
        # whole chunks only: each chunk row holds w/stored neighbor vectors
        per_chunk = max(1, w // stored)
        c = max(1, -(-deg_limit // per_chunk))  # ceil
        deg = min(deg, c * per_chunk)
    c_full = packed.chunks
    expand = max(1, min(expand, ef))
    return deg, c, c_full, w, mpc, stored, expand


def _beam_body(packed: PackedGraph, q8, qn, ef: int, needs_norms: bool,
               expand: int, deg_limit: int | None, bits: int, fused: bool):
    """One iteration of the packed beam loop as a (pk, d) -> (pk, d)
    closure over this (sub)batch's query tensors.  Shared by the single
    loop and the interleaved duo loop (which runs two independent
    half-batch bodies per iteration so one half's payload DMA overlaps
    the other half's score/merge compute)."""
    deg, c, c_full, w, mpc, stored, expand = _packed_layout(
        packed, expand, ef, deg_limit, bits, fused)
    b = q8.shape[0]
    s2 = packed.scale * packed.scale
    q16 = q8.astype(jnp.bfloat16)
    if bits == 4:
        q16e = q16[:, 0::2]  # even dims pair with low nibbles
        q16o = q16[:, 1::2]

    def body(beam_pk, beam_d):
        # E nearest unexpanded beam members (beam sorted ⇒ cumsum mask,
        # then a one-hot/argmax per selected slot)
        unexp = (beam_pk & 1) == 0
        slot = jnp.cumsum(unexp.astype(jnp.int32), axis=1)
        sel_mask = unexp & (slot <= expand)
        beam_pk = jnp.where(sel_mask, beam_pk | 1, beam_pk)
        oh = sel_mask[:, None, :] & (
            slot[:, None, :] == jnp.arange(1, expand + 1)[None, :, None]
        )
        pos = jnp.argmax(oh, axis=2)
        active = jnp.any(oh, axis=2)
        nodes = jnp.where(
            active, jnp.take_along_axis(beam_pk, pos, axis=1) >> 1, -1
        )  # [B, E]
        safe = jnp.maximum(nodes, 0)
        if fused:
            # ONE gather delivers ids + norms + vectors: each chunk row is
            # [meta_slice (256/c B) | payload bytes] — no separate
            # meta-table gather
            cid = (safe[:, :, None] * c_full
                   + jnp.arange(c, dtype=jnp.int32)[None, None, :]
                   ).reshape(b, -1)
            raw = packed.pay[cid].reshape(b, expand, c, w)
            mwords = _bytes_to_i32(
                raw[:, :, :, :mpc].reshape(b, expand, c * mpc))  # [B,E,64]
            nbrs = jnp.where((nodes >= 0)[:, :, None],
                             mwords[:, :, :deg], -1)
            nrm = mwords[:, :, 32:32 + deg].astype(jnp.float32)
            vec8 = raw[:, :, :, mpc:].reshape(b, expand, deg, stored)
        else:
            # meta row: neighbor ids + their int32 norms, one thin gather
            mrow = packed.meta[safe]  # [B, E, 2·deg_full]
            deg_full = packed.deg
            nbrs = jnp.where((nodes >= 0)[:, :, None], mrow[:, :, :deg], -1)
            nrm = mrow[:, :, deg_full:deg_full + deg].astype(jnp.float32)
            # payload chunk rows -> [B, E, deg, D_pad] int8 (relayout-free)
            cid = (safe[:, :, None] * c_full
                   + jnp.arange(c, dtype=jnp.int32)[None, None, :]
                   ).reshape(b, -1)
            vec8 = packed.pay[cid].reshape(b, expand, deg, stored)
        # dot as a bf16 elementwise multiply-reduce with f32 accumulation.
        # int8 values are exact in bf16; products round to 8 significand
        # bits — noise well
        # under the global-scale quantization error, and the final exact-f32
        # rerank absorbs both.
        if bits == 8:
            dot = jnp.sum(
                vec8.astype(jnp.bfloat16) * q16[:, None, None, :],
                axis=-1, dtype=jnp.float32,
            )
        else:
            # int4 payload: HALF the gathered bytes of int8 at equal deg —
            # see module docstring; the query rides as FRACTIONAL bf16 on
            # the s-grid (q/s, not rounded) — only the stored side pays the
            # coarse grid.
            lo, hi = nibble_unpack_bf16(vec8)
            dot = jnp.sum(
                lo * q16e[:, None, None, :] + hi * q16o[:, None, None, :],
                axis=-1, dtype=jnp.float32,
            )
        if needs_norms:
            d = s2 * (nrm - 2.0 * dot) + qn[:, None, None]
        else:
            d = 1.0 - s2 * dot
        cand_ids = nbrs.reshape(b, -1)
        cand_d = d.reshape(b, -1)
        in_beam = jnp.any(
            cand_ids[:, :, None] == (beam_pk >> 1)[:, None, :], axis=2
        )
        fresh = (cand_ids >= 0) & ~in_beam & first_occurrence_mask(cand_ids)
        cand_pk = jnp.where(fresh, cand_ids * 2, -1)  # enter unexpanded
        cand_d = jnp.where(fresh, cand_d, INF)
        beam_d, (beam_pk,) = merge_into_beam(
            beam_d, [(beam_pk, -1)], cand_d, [(cand_pk, -1)], ef,
        )
        return beam_pk, beam_d

    return body


def _entries_to_packed_beam(entry_ids, entry_d, ef: int):
    """Dedup entries and build the sorted (pk, d) beam state."""
    uniq = first_occurrence_mask(entry_ids) & (entry_ids >= 0)
    entry_ids = jnp.where(uniq, entry_ids, -1)
    entry_d = jnp.where(uniq, entry_d, INF)
    beam_ids, beam_d = entries_to_beam(entry_ids, entry_d, ef)
    # beam state packs (id, expanded) into ONE int32 — pk = 2·id + exp —
    # so the bitonic merge carries a single payload lane instead of two
    # (each compare-exchange stage does one fewer masked-select + permute
    # over [B, 2·p2]).
    # Sentinel id=-1 packs to -1 (= 2·(-1)+1: expanded), so `pk & 1` and
    # `pk >> 1` (arithmetic shift) decode both fields with sign intact.
    beam_pk = jnp.where(beam_ids < 0, -1, beam_ids * 2)
    return beam_pk, beam_d


def beam_search_layer_packed_duo(
    packed: PackedGraph,
    q8,  # int8[B, D_pad] (bits=8) or bf16[B, D_pad] q/s (bits=4)
    qn,  # f32[B]
    entry_ids,  # i32[B, E0]
    entry_d,  # f32[B, E0]
    ef: int,
    needs_norms: bool,
    max_iters: int,
    expand: int = 2,
    bits: int = 8,
    fused: bool = False,
    ways: int = 2,
):
    """Interleaved serving loop: the batch is split into `ways`
    INDEPENDENT sub-batches whose beam iterations are emitted back-to-back
    inside one fori_loop body, so each sub-batch keeps a smaller
    per-iteration shape while one dispatch amortizes the fixed per-batch
    cost (seed scan, rerank, host dispatch).  Whether this pays on the GPU
    is not measured yet.  Results are bit-identical to running each
    sub-batch through the plain loop — they share no state."""
    b = q8.shape[0]
    h = b // ways
    slices = [slice(i * h, (i + 1) * h) for i in range(ways)]
    bodies = [
        _beam_body(packed, q8[s], qn[s], ef, needs_norms, expand, None,
                   bits, fused)
        for s in slices
    ]
    init = tuple(
        _entries_to_packed_beam(entry_ids[s], entry_d[s], ef) for s in slices
    )

    def body(i, st):
        return tuple(fn(pk, d) for fn, (pk, d) in zip(bodies, st))

    final = jax.lax.fori_loop(0, max_iters, body, init)
    ids = jnp.concatenate([pk for pk, _ in final], axis=0) >> 1
    d = jnp.concatenate([d for _, d in final], axis=0)
    return ids, d, jnp.int32(max_iters)


def beam_search_layer_packed(
    packed: PackedGraph,
    q8,  # int8[B, D_pad] (bits=8) or bf16[B, D_pad] q/s (bits=4)
    qn,  # f32[B]  ‖q‖² (zeros for ip/cosine)
    entry_ids,  # i32[B, E0]
    entry_d,  # f32[B, E0]
    ef: int,
    needs_norms: bool,
    max_iters: int,
    expand: int = 4,
    deg_limit: int | None = None,
    early_exit: bool = True,
    bits: int = 8,
    fused: bool = False,
    init_pk=None,
    init_d=None,
    raw_state: bool = False,
):
    """The packed layer-0 beam loop: per iteration, expand the E nearest
    unexpanded beam nodes by gathering their meta row (ids+norms) and payload
    chunk rows, scoring all E·deg inlined neighbors with one bf16
    multiply-reduce.  Beam dedup only (the classic engine's default
    visited mode); distances land in true-f32 domain so the shared bitonic
    merge applies unchanged.  Returns (ids, d, iters) like the classic
    layer.

    init_pk/init_d: resume from a previous phase's raw beam state (packed
    (id, expanded) lanes + distances) instead of seeding from entries —
    the expand-schedule path (knn_search_packed) chains a wide beam-filling
    phase into a narrow cruising phase without re-expanding phase-1 work.
    raw_state=True returns (beam_pk, beam_d, iters) unshifted for chaining.

    deg_limit: expand only each node's first `deg_limit` neighbors.
    Adjacency rows are distance-ascending (build compaction sorts them), so
    this visits the nearest deg_limit per node — a degree/iteration tradeoff
    knob (CAGRA-style): half the gather bytes, half the score work, and a
    narrower candidate sort per iteration, at more iterations for equal
    recall.  Only whole payload chunks are fetched, so the effective limit
    rounds up to a chunk boundary."""
    step = _beam_body(packed, q8, qn, ef, needs_norms, expand, deg_limit,
                      bits, fused)

    if init_pk is not None:
        beam_pk, beam_d = init_pk, init_d
    else:
        beam_pk, beam_d = _entries_to_packed_beam(entry_ids, entry_d, ef)

    def cond(state):
        beam_pk, _, it = state
        return jnp.any((beam_pk & 1) == 0) & (it < max_iters)

    def body(state):
        beam_pk, beam_d, it = state
        beam_pk, beam_d = step(beam_pk, beam_d)
        return beam_pk, beam_d, it + 1

    if early_exit:
        beam_pk, beam_d, iters = jax.lax.while_loop(
            cond, body, (beam_pk, beam_d, jnp.int32(0))
        )
    else:
        # capped-iteration serving mode: when essentially no beam converges
        # before the cap, the while_loop's any() over [B, ef] each
        # iteration — a full-state reduction feeding the loop predicate — is
        # pure overhead; fori_loop drops it
        beam_pk, beam_d, iters = jax.lax.fori_loop(
            0, max_iters, lambda i, s: body(s), (beam_pk, beam_d, jnp.int32(0))
        )
    if raw_state:
        return beam_pk, beam_d, iters
    return beam_pk >> 1, beam_d, iters


# NOTE: a software-pipelined variant of the packed beam loop (select+gather
# for iteration t+1 issued before iteration t's merge) bought no overlap
# when it was tried, and its 1-merge-stale expansion order cost recall.  On
# the GPU, true gather/score overlap is the job of a fused gather+score
# kernel (ROADMAP.md), worth writing only once a trace shows the beam
# iteration gather-bound.


@partial(
    jax.jit,
    static_argnames=(
        "k", "ef", "metric", "max_iters", "expand", "seed_e", "rerank_k",
        "deg_limit", "early_exit", "bits", "expand_schedule", "fused",
        "interleave",
    ),
)
def knn_search_packed(
    graph: GraphTensors,
    packed: PackedGraph,
    queries,  # f32[B, D]
    k: int,
    ef: int,
    metric: str,
    max_iters: int | None = None,
    expand: int = 4,
    seeds: SeedIndex | None = None,
    seed_e: int = 16,
    rerank_k: int | None = None,
    deg_limit: int | None = None,
    early_exit: bool = True,
    bits: int = 8,
    expand_schedule: tuple | None = None,
    fused: bool = False,
    interleave: int = 1,
):
    """Alg 5 on the packed engine: seed-scan (or greedy) entry, packed int8
    beam at layer 0, then an exact-f32 rerank of the top `rerank_k` beam
    entries so the returned (ids, dists) ordering is exact despite the
    quantized beam.  Same (ids i32[B,k], d f32[B,k]) contract as
    models.search.knn_search, including tombstone filtering."""
    from ocaml_hnsw_tpu.ops.metrics import get_metric

    ef = max(ef, k)
    if max_iters is None:
        max_iters = max(64, (8 * ef) // max(1, expand))
    if rerank_k is None:
        rerank_k = min(ef, max(2 * k, 16))
    rerank_k = max(k, min(rerank_k, ef))
    needs_norms = get_metric(metric).needs_norms
    q = preprocess_queries(queries, metric)
    qn = query_norms(q, metric)
    if seeds is not None:
        entry_ids, entry_d = seed_entries(graph, seeds, q, qn, seed_e, metric)
    else:
        cur, cur_d = descend(graph, q, qn, metric, stop_level=0)
        entry_ids, entry_d = cur[:, None], cur_d[:, None]
    if fused:
        c_, w_ = packed.chunks, packed.pay.shape[1]
        stored_ = ((w_ - FUSED_META_TOTAL // c_) * c_) // packed.deg
    else:
        stored_ = packed.d_pad
    d_pad = stored_ * (1 if bits == 8 else 2)  # logical query width
    if bits == 8:
        q8 = quantize_queries(q, packed.scale)
    else:
        # fractional bf16 on the payload's s-grid (see beam docstring)
        q8 = (q / packed.scale).astype(jnp.bfloat16)
    if d_pad > q8.shape[1]:
        q8 = jnp.pad(q8, ((0, 0), (0, d_pad - q8.shape[1])))
    if expand_schedule is not None:
        # phased beam: e.g. ((8, 2), (2, 26)) fills the beam with two WIDE
        # expansions from the seed entries (8·deg candidates each — beam
        # ramp-up in 2 serial steps instead of ~10 narrow ones), then
        # cruises at the cheap narrow width.  Expanded flags carry across
        # phases via the raw (pk, d) state, so no work repeats.
        state = (None, None)
        for e_p, mi_p in expand_schedule:
            state = beam_search_layer_packed(
                packed, q8, qn, entry_ids, entry_d, ef,
                needs_norms=needs_norms, max_iters=mi_p, expand=e_p,
                deg_limit=deg_limit, early_exit=False, bits=bits,
                fused=fused, init_pk=state[0], init_d=state[1],
                raw_state=True,
            )[:2]
        ids, d = state[0] >> 1, state[1]
    elif (interleave > 1 and queries.shape[0] % interleave == 0
          and deg_limit is None):
        # interleaved sub-batch loop (fori mode): `interleave` independent
        # sub-batches per iteration — keeps the per-iteration sweet-spot
        # shape while amortizing fixed cost.  Bit-identical results to the
        # plain loop per sub-batch.
        ids, d, _ = beam_search_layer_packed_duo(
            packed, q8, qn, entry_ids, entry_d, ef,
            needs_norms=needs_norms, max_iters=max_iters, expand=expand,
            bits=bits, fused=fused, ways=interleave,
        )
    else:
        ids, d, _ = beam_search_layer_packed(
            packed, q8, qn, entry_ids, entry_d, ef,
            needs_norms=needs_norms, max_iters=max_iters, expand=expand,
            deg_limit=deg_limit, early_exit=early_exit, bits=bits,
            fused=fused,
        )
    # tombstone filter on the approx beam, keep top rerank_k live candidates.
    # The beam arrives sorted; dead entries perturb that, so both selections
    # are small bitonic sorts.
    dead = graph.deleted[jnp.maximum(ids, 0)] | (ids < 0)
    d = jnp.where(dead, INF, d)
    _, top_ids = topk_ascending(d, jnp.where(dead, -1, ids), rerank_k)
    # exact f32 rerank (one small gather) -> exact final ordering
    d_exact = dists_to_ids(
        graph.vectors, graph.scales, graph.norms, q, qn, top_ids, metric
    )
    out_d, out_ids = topk_ascending(d_exact, top_ids, k)
    out_ids = jnp.where(jnp.isinf(out_d), -1, out_ids)
    return out_ids, out_d
