"""Query-graph distillation: re-select a smaller, uniform out-degree
adjacency for serving, so the packed query engine gathers half the payload
bytes per expansion.

Why: the packed beam loop is gather-bound (E expansions of deg=32
payloads, two 2 KB chunk rows per node at 128-d).  Halving the payload by
`deg_limit` (scoring only each row's nearest 16) halves those bytes but
ruins recall, because a plain distance-ascending truncation drops exactly the
diversity/long-range edges the Alg-4 heuristic (paper arXiv:1603.09320
Alg 4; SURVEY.md §3.4) put there for navigability.

The fix is to *re-run the diversity heuristic at the target degree*: for
each node, take its M_max0 build edges (optionally + a 2-hop extension
through its nearest neighbors, CAGRA-style), and admit `out_deg` of them in
ascending-distance order with the same admit rule the builder used
(closer-to-query-than-to-any-admitted), backfilling nearest-rejected to a
full row.  The result keeps the near/diverse structure at half the width.
The distilled adjacency is for QUERIES only — the build graph keeps its
full M_max0 rows (shrink semantics and future inserts are untouched);
`pack_graph(graph.with_adj0(refined), ...)` builds the serving payload.

Cost: one pass of ~32 gathered rows + one 32x32 pairwise block per node,
slab-batched, amortized over the index lifetime.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ocaml_hnsw_tpu.models.graph import GraphTensors
from ocaml_hnsw_tpu.models.build import (
    heuristic_admit, compact_by_mask,
)
from ocaml_hnsw_tpu.ops.distance import (
    gather_dequant, pairwise_dists, dists_to_ids,
)
from ocaml_hnsw_tpu.ops.bitset import first_occurrence_mask
from ocaml_hnsw_tpu.ops.sortmerge import bitonic_sort, next_pow2


@partial(jax.jit, static_argnames=("out_deg", "metric", "slab", "hops"))
def _refine_rounds(vectors, scales, norms, adj0, out_deg: int, metric: str,
                   slab: int, hops: int):
    n_cap, k = adj0.shape
    kt = k + hops * k  # total candidate width after 2-hop extension
    out = jnp.full((n_cap, out_deg), -1, jnp.int32)

    def body(i, out):
        start = i * slab
        a = jax.lax.dynamic_slice_in_dim(adj0, start, slab)  # [S, K]
        own_ids = start + jnp.arange(slab, dtype=jnp.int32)
        if hops:
            # 2-hop extension through the `hops` nearest neighbors: their
            # adjacency rows join the candidate pool (adjacency rows are
            # distance-ascending, so columns 0..hops-1 are the nearest)
            ext = adj0[jnp.maximum(a[:, :hops], 0)]  # [S, hops, K]
            ext = jnp.where(
                (a[:, :hops] >= 0)[:, :, None], ext, -1
            ).reshape(slab, hops * k)
            cand = jnp.concatenate([a, ext], axis=1)  # [S, Kt]
        else:
            cand = a
        # self-edges and duplicates are invalid candidates
        valid = ((cand >= 0) & (cand != own_ids[:, None])
                 & first_occurrence_mask(cand))
        cand = jnp.where(valid, cand, -1)
        own = jax.lax.dynamic_slice_in_dim(vectors, start, slab)
        own = own.astype(jnp.float32)
        if vectors.dtype == jnp.int8:
            own = own * jax.lax.dynamic_slice_in_dim(
                scales, start, slab)[:, None]
        own_n = jax.lax.dynamic_slice_in_dim(norms, start, slab)
        d = dists_to_ids(vectors, scales, norms, own, own_n, cand, metric)
        cvec = gather_dequant(vectors, scales, cand)  # [S, Kt, D]
        cnorm = norms[jnp.maximum(cand, 0)]
        # ascending-distance candidate order (the oracle's admit order); the
        # vectors ride along as an in-register permutation payload (cheaper
        # than a second device-memory gather of the sorted rows)
        p2 = next_pow2(kt)
        if p2 > kt:
            d = jnp.pad(d, ((0, 0), (0, p2 - kt)), constant_values=jnp.inf)
            cand = jnp.pad(cand, ((0, 0), (0, p2 - kt)), constant_values=-1)
            perm0 = jnp.pad(
                jnp.tile(jnp.arange(kt, dtype=jnp.int32), (slab, 1)),
                ((0, 0), (0, p2 - kt)), constant_values=0)
        else:
            perm0 = jnp.tile(jnp.arange(kt, dtype=jnp.int32), (slab, 1))
        sd, (sids, perm) = bitonic_sort(d, [cand, perm0])
        svalid = jnp.isfinite(sd)
        cvec = jnp.take_along_axis(cvec, perm[:, :, None], axis=1)
        cnorm = jnp.take_along_axis(cnorm, perm, axis=1)
        pair = pairwise_dists(cvec, cnorm, metric)  # [S, P2, P2]
        sel = heuristic_admit(sd, pair, svalid, out_deg, keep_pruned=True,
                              scan_limit=kt)
        new_ids, _ = compact_by_mask(sids, sd, sel & svalid, out_deg)
        return jax.lax.dynamic_update_slice_in_dim(out, new_ids, start, 0)

    return jax.lax.fori_loop(0, n_cap // slab, body, out)


def refine_adjacency(graph: GraphTensors, out_deg: int, metric: str,
                     slab: int = 4096, hops: int = 0) -> jnp.ndarray:
    """Distill graph.adj0 down to `out_deg` columns (see module docstring).

    hops > 0 additionally pools each node's `hops` nearest neighbors' own
    adjacency rows (2-hop extension) before re-selection.  Returns a fresh
    i32[N_cap, out_deg] adjacency (rows distance-ascending, -1 padded);
    unoccupied slots stay all -1.
    """
    n_cap, k = graph.adj0.shape
    if out_deg >= k and not hops:
        return graph.adj0
    slab = min(slab, n_cap)
    while n_cap % slab:
        slab //= 2
    return _refine_rounds(
        graph.vectors, graph.scales, graph.norms, graph.adj0,
        out_deg=out_deg, metric=metric, slab=slab, hops=hops,
    )


def refined_graph(graph: GraphTensors, out_deg: int, metric: str,
                  slab: int = 4096, hops: int = 0) -> GraphTensors:
    """graph with adj0 replaced by the distilled serving adjacency (for
    pack_graph / the packed query engine; upper layers untouched)."""
    return graph._replace(
        adj0=refine_adjacency(graph, out_deg, metric, slab=slab, hops=hops)
    )
