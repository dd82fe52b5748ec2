"""Query-graph distillation (models/refine.py): structural invariants of the
re-selected serving adjacency, and recall retention of the distilled packed
engine at half the build degree (the deg-cut that plain truncation ruins —
the deg_limit ladder)."""

import numpy as np
import pytest

from ocaml_hnsw_tpu.bench.datasets import clustered, queries_like
from ocaml_hnsw_tpu.config import HnswConfig
from ocaml_hnsw_tpu.models.build import BuildState
from ocaml_hnsw_tpu.models.search import build_seed_index
from ocaml_hnsw_tpu.models.packed import pack_graph, knn_search_packed
from ocaml_hnsw_tpu.models.refine import refine_adjacency, refined_graph
from ocaml_hnsw_tpu.oracle.bruteforce import bruteforce_knn, recall


@pytest.fixture(scope="module")
def built():
    from tests.conftest import built_state_cached

    n, dim = 4000, 24
    data = clustered(n, dim, n_clusters=32, seed=1)
    st = built_state_cached(
        "std4000x24", HnswConfig(dim=dim, M=12, ef_construction=80), n,
        data, round_size=512)
    return data, st


class TestRefineStructure:
    @pytest.mark.parametrize("hops", [0, 1])
    def test_invariants(self, built, hops):
        _, st = built
        g = st.graph
        out_deg = 12
        refined = np.asarray(
            refine_adjacency(g, out_deg, "l2", slab=512, hops=hops))
        n = int(g.n)
        adj = np.asarray(g.adj0)
        assert refined.shape == (g.n_cap, out_deg)
        for i in range(0, n, 97):
            row = refined[i]
            live = row[row >= 0]
            # no duplicates, no self-edges, all in range
            assert len(set(live.tolist())) == len(live)
            assert i not in live
            assert (live < n).all()
            # hops=0 rows are a subset of the original adjacency
            if hops == 0:
                assert set(live.tolist()) <= set(
                    adj[i][adj[i] >= 0].tolist())
            # -1 padding is contiguous at the tail
            if len(live) < out_deg:
                assert (row[len(live):] == -1).all()
        # unoccupied slots stay empty
        assert (refined[n:] == -1).all()

    def test_rows_distance_ascending(self, built):
        data, st = built
        g = st.graph
        refined = np.asarray(refine_adjacency(g, 12, "l2", slab=512))
        vecs = np.asarray(g.vectors, np.float32)
        for i in range(0, int(g.n), 211):
            live = refined[i][refined[i] >= 0]
            d = ((vecs[live] - vecs[i]) ** 2).sum(-1)
            assert (np.diff(d) >= -1e-5).all()

    def test_full_degree_rows(self, built):
        """keep_pruned backfill should give (nearly) full rows wherever the
        source row had >= out_deg live edges."""
        _, st = built
        g = st.graph
        out_deg = 12
        refined = np.asarray(refine_adjacency(g, out_deg, "l2", slab=512))
        adj = np.asarray(g.adj0)
        src_deg = (adj[: int(g.n)] >= 0).sum(1)
        ref_deg = (refined[: int(g.n)] >= 0).sum(1)
        full = src_deg >= out_deg
        assert (ref_deg[full] == out_deg).all()


class TestRefinedRecall:
    def test_distilled_half_degree_recall(self, built):
        """Packed engine on the distilled deg-M adjacency (half of M_max0)
        must stay within a small recall margin of the full-degree engine."""
        data, st = built
        g = st.graph
        k = 10
        queries = queries_like(data, 200, seed=5)
        gt, _ = bruteforce_knn(data, queries, k)
        seeds = build_seed_index(g, "l2")

        full_packed = pack_graph(g, "l2")
        ids_full, _ = knn_search_packed(
            g, full_packed, queries, k=k, ef=64, metric="l2",
            max_iters=24, seeds=seeds, seed_e=8)
        r_full = recall(np.asarray(ids_full), gt)

        half = refined_graph(g, 12, "l2", slab=512)
        half_packed = pack_graph(half, "l2")
        ids_half, _ = knn_search_packed(
            half, half_packed, queries, k=k, ef=64, metric="l2",
            max_iters=30, seeds=seeds, seed_e=8)
        r_half = recall(np.asarray(ids_half), gt)

        assert r_full >= 0.9
        assert r_half >= r_full - 0.03, (r_half, r_full)
