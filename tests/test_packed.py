"""Packed inline-int8 engine (models/packed.py) — correctness vs the classic
engine, payload encoding round-trip, tombstones, metrics, and API wiring.

The packed engine is approximate in the beam (global-scale int8 + bf16
products) but exact in its returned distances (final f32 rerank), so tests
assert recall-level parity plus exact distance values, not bit-equal beams.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from ocaml_hnsw_tpu.bench.datasets import clustered, queries_like
from ocaml_hnsw_tpu.config import HnswConfig
from ocaml_hnsw_tpu.models.build import BuildState
from ocaml_hnsw_tpu.models.search import knn_search, build_seed_index
from ocaml_hnsw_tpu.models.packed import (
    pack_graph,
    knn_search_packed,
    pack_d_pad,
)
from ocaml_hnsw_tpu.oracle.bruteforce import bruteforce_knn, recall
from ocaml_hnsw_tpu.api import Index


@pytest.fixture(scope="module")
def built():
    from tests.conftest import built_state_cached

    n, dim = 4000, 24
    data = clustered(n, dim, n_clusters=32, seed=1)
    st = built_state_cached(
        "std4000x24", HnswConfig(dim=dim, M=12, ef_construction=80), n,
        data, round_size=512)
    return data, st


class TestPackGraph:
    def test_meta_ids_match_adjacency(self, built):
        _, st = built
        p = pack_graph(st.graph, "l2")
        deg = st.graph.adj0.shape[1]
        np.testing.assert_array_equal(
            np.asarray(p.meta[:, :deg]), np.asarray(st.graph.adj0)
        )

    def test_payload_roundtrip_within_half_scale(self, built):
        """Dequantized payload must reproduce each neighbor's vector to
        within s/2 per component (the rounding bound)."""
        _, st = built
        p = pack_graph(st.graph, "l2")
        g = st.graph
        deg, d = g.adj0.shape[1], g.dim
        s = float(p.scale)
        pay = np.asarray(p.pay).reshape(g.n_cap, deg, p.d_pad)[:, :, :d]
        vecs = np.asarray(g.vectors, dtype=np.float32)
        adj = np.asarray(g.adj0)
        rng = np.random.default_rng(0)
        for i in rng.integers(0, int(g.n), size=20):
            for j in range(deg):
                nb = adj[i, j]
                if nb < 0:
                    continue
                err = np.abs(pay[i, j] * s - vecs[nb])
                assert err.max() <= s / 2 + 1e-6

    def test_norms_exact_int32(self, built):
        _, st = built
        p = pack_graph(st.graph, "l2")
        deg = st.graph.adj0.shape[1]
        pay = np.asarray(p.pay).astype(np.int32).reshape(
            st.graph.n_cap, deg, p.d_pad
        )
        nrm = np.asarray(p.meta[:, deg:])
        np.testing.assert_array_equal((pay * pay).sum(-1), nrm)

    def test_d_pad_lane_aligned(self):
        assert pack_d_pad(24) == 128
        assert pack_d_pad(128) == 128
        assert pack_d_pad(129) == 256


class TestPackedSearch:
    def test_recall_matches_classic(self, built):
        data, st = built
        q = queries_like(data, 64, seed=2)
        gt, _ = bruteforce_knn(data, q, 10, "l2")
        seeds = build_seed_index(st.graph, "l2")
        ids_c, _ = knn_search(st.graph, jnp.asarray(q), k=10, ef=64,
                              metric="l2", seeds=seeds)
        p = pack_graph(st.graph, "l2")
        ids_p, _ = knn_search_packed(st.graph, p, jnp.asarray(q), k=10,
                                     ef=64, metric="l2", seeds=seeds)
        r_c = recall(np.asarray(ids_c), gt)
        r_p = recall(np.asarray(ids_p), gt)
        assert r_p >= r_c - 0.02, (r_p, r_c)

    @pytest.mark.parametrize("ways", [2, 4])
    def test_interleaved_loop_bit_identical(self, built, ways):
        """The round-5 interleaved serving loop (duo loop) splits the batch
        into independent sub-batches in ONE fori program; results must be
        bit-identical to the plain capped loop."""
        data, st = built
        q = jnp.asarray(queries_like(data, 64, seed=7))
        seeds = build_seed_index(st.graph, "l2")
        p = pack_graph(st.graph, "l2")
        kw = dict(k=10, ef=32, metric="l2", max_iters=10, seeds=seeds,
                  seed_e=8, rerank_k=16, expand=2, early_exit=False)
        i1, d1 = knn_search_packed(st.graph, p, q, **kw)
        i2, d2 = knn_search_packed(st.graph, p, q, interleave=ways, **kw)
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
        np.testing.assert_array_equal(np.asarray(d1), np.asarray(d2))

    def test_seed_cap_recall_close(self, built):
        """Serving from a capped seed bank (build_seed_index cap=...) must
        stay within a small recall band of the full bank."""
        data, st = built
        q = queries_like(data, 64, seed=8)
        gt, _ = bruteforce_knn(data, q, 10, "l2")
        p = pack_graph(st.graph, "l2")
        full = build_seed_index(st.graph, "l2")
        capped = build_seed_index(st.graph, "l2", cap=64)
        assert capped.ids.shape[0] <= 128  # pow2 padding of <=64 rows
        kw = dict(k=10, ef=48, metric="l2", seeds=None, seed_e=8)
        r = {}
        for name, s in (("full", full), ("capped", capped)):
            kw["seeds"] = s
            ids, _ = knn_search_packed(st.graph, p, jnp.asarray(q), **kw)
            r[name] = recall(np.asarray(ids), gt)
        assert r["capped"] >= r["full"] - 0.05, r

    def test_returned_distances_are_exact_f32(self, built):
        """The final rerank recomputes distances in f32 — returned values
        must equal the true metric on the returned ids."""
        data, st = built
        q = queries_like(data, 16, seed=3)
        p = pack_graph(st.graph, "l2")
        seeds = build_seed_index(st.graph, "l2")
        ids, d = knn_search_packed(st.graph, p, jnp.asarray(q), k=5, ef=48,
                                   metric="l2", seeds=seeds)
        ids, d = np.asarray(ids), np.asarray(d)
        for qi in range(q.shape[0]):
            for j in range(5):
                if ids[qi, j] < 0:
                    continue
                true = float(((data[ids[qi, j]] - q[qi]) ** 2).sum())
                assert abs(true - d[qi, j]) <= 1e-3 * max(1.0, true)

    def test_fori_serving_mode_bit_identical(self, built):
        """early_exit=False (fori_loop, no per-iter convergence reduction)
        must return bit-identical results: the body is a no-op on converged
        beams (zero unexpanded -> no selection, INF candidates, merge
        no-op), so running to the cap changes nothing."""
        data, st = built
        q = queries_like(data, 32, seed=6)
        p = pack_graph(st.graph, "l2")
        seeds = build_seed_index(st.graph, "l2")
        for mi in (4, 24):
            ids_w, d_w = knn_search_packed(
                st.graph, p, jnp.asarray(q), k=10, ef=48, metric="l2",
                max_iters=mi, seeds=seeds)
            ids_f, d_f = knn_search_packed(
                st.graph, p, jnp.asarray(q), k=10, ef=48, metric="l2",
                max_iters=mi, seeds=seeds, early_exit=False)
            np.testing.assert_array_equal(np.asarray(ids_w),
                                          np.asarray(ids_f))
            np.testing.assert_array_equal(np.asarray(d_w), np.asarray(d_f))

    def test_wide_single_chunk_payload_same_results(self, built):
        """max_chunk=4096 packs each node's payload as one fat row; the
        engine must return identical results to the 2x2048 layout."""
        data, st = built
        q = queries_like(data, 32, seed=7)
        seeds = build_seed_index(st.graph, "l2")
        p2 = pack_graph(st.graph, "l2")
        p1 = pack_graph(st.graph, "l2", max_chunk=4096)
        assert p1.chunks <= p2.chunks
        ids_a, d_a = knn_search_packed(st.graph, p2, jnp.asarray(q), k=10,
                                       ef=48, metric="l2", seeds=seeds)
        ids_b, d_b = knn_search_packed(st.graph, p1, jnp.asarray(q), k=10,
                                       ef=48, metric="l2", seeds=seeds)
        np.testing.assert_array_equal(np.asarray(ids_a), np.asarray(ids_b))
        np.testing.assert_array_equal(np.asarray(d_a), np.asarray(d_b))

    def test_int4_payload_grid_data_recall(self):
        """bits=4 nibble-packed payload on GRID-ALIGNED data (components on
        the 15-level s-grid): quantization is then exact, so the int4
        engine must match the int8 engine's recall — this verifies the
        pack/unpack/score machinery end to end.

        Measured limitation (round 4, kept deliberately): on real-valued
        clustered data the GLOBAL s-grid is too coarse — vmax covers the
        cluster-center spread while neighbor ranking happens at the
        within-cluster scale (recall 0.81 vs 0.996 at 2k x 128-d; 0.33 at
        1M).  bits=4 is therefore NOT the default anywhere; it exists for
        narrow-dynamic-range data, where it halves payload bytes."""
        n, dim = 2000, 128
        rng = np.random.RandomState(9)
        data = rng.randint(-7, 8, size=(n, dim)).astype(np.float32)
        st = BuildState(HnswConfig(dim=dim, M=8, ef_construction=60), n,
                        round_size=256)
        st.add(data)
        q = data[rng.randint(0, n, 48)] + rng.randint(
            -1, 2, size=(48, dim)).astype(np.float32)
        gt, _ = bruteforce_knn(data, q, 10, "l2")
        seeds = build_seed_index(st.graph, "l2")
        p8 = pack_graph(st.graph, "l2")
        p4 = pack_graph(st.graph, "l2", bits=4)
        assert p4.pay.nbytes * 2 == p8.pay.nbytes
        i8, _ = knn_search_packed(st.graph, p8, jnp.asarray(q), k=10,
                                  ef=64, metric="l2", seeds=seeds,
                                  rerank_k=48)
        i4, _ = knn_search_packed(st.graph, p4, jnp.asarray(q), k=10,
                                  ef=64, metric="l2", seeds=seeds,
                                  rerank_k=48, bits=4)
        r8 = recall(np.asarray(i8), gt)
        r4 = recall(np.asarray(i4), gt)
        assert r4 >= r8 - 0.02, (r4, r8)

    def test_nibble_pack_roundtrip_exact(self):
        from ocaml_hnsw_tpu.models.packed import (
            _nibble_pack, nibble_unpack_bf16,
        )

        rng = np.random.RandomState(0)
        y = rng.randint(-8, 8, size=(7, 128)).astype(np.int8)
        lo, hi = nibble_unpack_bf16(_nibble_pack(jnp.asarray(y)))
        un = np.zeros((7, 128), np.float32)
        un[:, 0::2] = np.asarray(lo, np.float32)
        un[:, 1::2] = np.asarray(hi, np.float32)
        np.testing.assert_array_equal(un, y.astype(np.float32))

    def test_tombstones_filtered(self, built):
        data, st = built
        q = data[:8]
        p = pack_graph(st.graph, "l2")
        ids0, _ = knn_search_packed(st.graph, p, jnp.asarray(q), k=1, ef=32,
                                    metric="l2")
        hit = np.asarray(ids0)[:, 0]
        g2 = st.graph._replace(
            deleted=st.graph.deleted.at[jnp.asarray(hit)].set(True)
        )
        ids1, _ = knn_search_packed(g2, p, jnp.asarray(q), k=1, ef=32,
                                    metric="l2")
        assert not np.isin(np.asarray(ids1)[:, 0], hit).any()

    def test_cosine_metric(self):
        n, dim = 2000, 16
        data = clustered(n, dim, n_clusters=16, seed=5)
        st = BuildState(HnswConfig(dim=dim, M=8, ef_construction=60,
                                   metric="cosine"), n, round_size=256)
        st.add(data)
        q = queries_like(data, 32, seed=6)
        gt, _ = bruteforce_knn(data, q, 10, "cosine")
        p = pack_graph(st.graph, "cosine")
        ids, _ = knn_search_packed(st.graph, p, jnp.asarray(q), k=10, ef=48,
                                   metric="cosine")
        assert recall(np.asarray(ids), gt) >= 0.9

    def test_unsupported_metric_raises(self, built):
        from ocaml_hnsw_tpu.ops.metrics import register_metric, _REGISTRY

        name = "test-packed-l1"
        if name not in _REGISTRY:
            register_metric(
                name, lambda rows, q: abs(rows - q[..., None, :]).sum(-1)
            )
        _, st = built
        with pytest.raises(ValueError, match="matmul_score"):
            pack_graph(st.graph, name)


class TestApiWiring:
    def test_auto_uses_packed_above_threshold(self, monkeypatch):
        n, dim = 3000, 16
        data = clustered(n, dim, n_clusters=24, seed=7)
        q = queries_like(data, 32, seed=8)
        gt, _ = bruteforce_knn(data, q, 10, "l2")
        idx = Index(space="l2", dim=dim)
        idx.init_index(max_elements=n, M=8, ef_construction=60,
                       round_size=512)
        idx.add_items(data)
        monkeypatch.setattr(Index, "PACKED_THRESHOLD", 1000)
        labels, dists = idx.knn_query(q, k=10, ef=48)
        assert idx._packed is not None  # auto path engaged the packed engine
        assert recall(labels, gt) >= 0.9
        # forcing classic gives equivalent recall
        l2_, _ = idx.knn_query(q, k=10, ef=48, engine="classic")
        assert recall(l2_, gt) >= 0.9

    def test_forced_packed_raises_when_small(self):
        idx = Index(space="l2", dim=8)
        idx.init_index(max_elements=300, M=8, ef_construction=40,
                       round_size=64)
        idx.add_items(clustered(300, 8, n_clusters=4, seed=9))
        with pytest.raises(RuntimeError, match="packed engine unavailable"):
            idx.knn_query(np.zeros((1, 8), np.float32), k=1, engine="packed")

    def test_mutation_invalidates_packed_cache(self, monkeypatch):
        monkeypatch.setattr(Index, "PACKED_THRESHOLD", 500)
        n, dim = 600, 8
        data = clustered(n, dim, n_clusters=6, seed=10)
        idx = Index(space="l2", dim=dim)
        idx.init_index(max_elements=2 * n, M=8, ef_construction=40,
                       round_size=128)
        idx.add_items(data[:n // 2])
        idx.add_items(data[n // 2:])
        idx.knn_query(data[:4], k=1, ef=16)
        assert idx._packed is not None
        idx.add_items(clustered(32, dim, n_clusters=4, seed=11))
        assert idx._packed is None  # adjacency changed -> repack next query
        labels, _ = idx.knn_query(data[:50], k=1, ef=32)
        assert (labels[:, 0] == np.arange(50)).mean() >= 0.9


class TestPackedBuildDist:
    """The build-maintained per-slot distance table (PackedGraph.dist): sync
    with recomputation, and apply_edges stored-dist path == gather path."""

    @pytest.fixture(scope="class")
    def packed_built(self, tmp_path_factory):
        from ocaml_hnsw_tpu.models import build as B

        old = B.BuildState.PACKED_BUILD_THRESHOLD
        B.BuildState.PACKED_BUILD_THRESHOLD = 1  # force packed at tiny N
        try:
            rng = np.random.RandomState(0)
            data = rng.randn(3000, 32).astype(np.float32)
            cfg = HnswConfig(dim=32, metric="l2", M=8, ef_construction=48)
            st = BuildState(cfg, 3500, round_size=256)
            st.add(data[:2500])
            yield data, cfg, st
        finally:
            B.BuildState.PACKED_BUILD_THRESHOLD = old

    def test_dist_sync_invariant(self, packed_built):
        # after a multi-round build, the maintained dist table equals a
        # fresh recomputation from the final adjacency (bit-for-bit)
        _, cfg, st = packed_built
        assert st.pack_dist is not None
        fresh = pack_graph(st.graph, "l2", with_dist=True)
        a = np.asarray(st.pack_dist)
        b = np.asarray(fresh.dist)
        n = int(st.graph.n)
        same = (a[:n] == b[:n]) | (np.isinf(a[:n]) & np.isinf(b[:n]))
        assert same.all()

    def test_stored_dist_apply_equals_gather_apply(self, packed_built):
        # one insert_round on the same snapshot, with and without the
        # stored-dist fast path, must produce identical tensors (f32
        # storage: sel_d == recomputed pair distances exactly)
        from ocaml_hnsw_tpu.models import build as B

        data, cfg, st = packed_built
        q = jnp.asarray(data[2500:2756])
        lv = jnp.asarray(B.sample_levels(
            np.random.RandomState(5), 256, cfg.mL, st.l_max))
        kw = st._round_kwargs()
        # insert_round donates its graph: each call gets its own copy of
        # the snapshot, and `start` comes from the host, not from inside
        # the donated tree
        start = jnp.int32(st.host_n)

        def args():
            return (jax.tree.map(jnp.copy, st.graph), q, lv, start,
                    jnp.int32(256), st.seed_bank, st.seed_n, st.seed_vecs,
                    st.seed_norms, st.pack_pay, st.pack_meta, st.pack_scale)

        out_a = B.insert_round(*args(), st.pack_dist, **kw)
        out_b = B.insert_round(*args(), None, **kw)
        assert np.array_equal(np.asarray(out_a[0].adj0),
                              np.asarray(out_b[0].adj0))
        assert np.array_equal(np.asarray(out_a[0].adj_up),
                              np.asarray(out_b[0].adj_up))
        assert np.array_equal(np.asarray(out_a[5]), np.asarray(out_b[5]))
        assert np.array_equal(np.asarray(out_a[6]), np.asarray(out_b[6]))
        assert out_a[7] is not None and out_b[7] is None
