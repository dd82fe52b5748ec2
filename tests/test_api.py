"""API-layer tests: the canonical index surface (SURVEY.md §1 L3 — init_index,
add_items, knn_query, set_ef, save/load, mark_deleted, resize_index), custom
labels, BFIndex, and checkpoint round-trips (SURVEY.md §5.4)."""

import numpy as np
import pytest

from ocaml_hnsw_tpu import Index, BFIndex
from ocaml_hnsw_tpu.oracle import bruteforce_knn, recall
from ocaml_hnsw_tpu.bench.datasets import clustered, queries_like


@pytest.fixture(scope="module")
def small_index():
    data = clustered(600, 16, n_clusters=16, seed=0)
    idx = Index(space="l2", dim=16)
    idx.init_index(max_elements=800, M=8, ef_construction=48, round_size=128)
    idx.add_items(data)
    return data, idx


class TestSurface:
    def test_counts(self, small_index):
        data, idx = small_index
        assert idx.get_current_count() == 600
        assert idx.get_max_elements() == 800
        assert idx.get_ids_list()[:3] == [0, 1, 2]

    def test_query_recall(self, small_index):
        data, idx = small_index
        q = queries_like(data, 50, seed=1)
        gt, _ = bruteforce_knn(data, q, 10, "l2")
        idx.set_ef(64)
        labels, dists = idx.knn_query(q, k=10)
        assert labels.shape == (50, 10)
        assert recall(labels, gt) >= 0.9
        assert (np.diff(dists, axis=1) >= -1e-6).all()

    def test_single_query_1d(self, small_index):
        data, idx = small_index
        labels, dists = idx.knn_query(data[5], k=1, ef=32)
        assert labels.shape == (1, 1)
        assert labels[0, 0] == 5

    def test_ef_arg_overrides_set_ef(self, small_index):
        data, idx = small_index
        q = queries_like(data, 30, seed=2)
        gt, _ = bruteforce_knn(data, q, 10, "l2")
        idx.set_ef(10)
        r_low = recall(idx.knn_query(q, k=10)[0], gt)
        r_high = recall(idx.knn_query(q, k=10, ef=128)[0], gt)
        assert r_high >= r_low

    def test_get_items(self, small_index):
        data, idx = small_index
        got = idx.get_items([3, 7])
        np.testing.assert_allclose(got, data[[3, 7]], rtol=1e-6)

    def test_errors(self):
        idx = Index(space="l2", dim=4)
        with pytest.raises(RuntimeError, match="init_index"):
            idx.add_items(np.zeros((1, 4)))
        idx.init_index(max_elements=10)
        with pytest.raises(RuntimeError, match="empty"):
            idx.knn_query(np.zeros((1, 4)), k=1)
        with pytest.raises(ValueError, match="dim"):
            idx.add_items(np.zeros((1, 5)))
        idx.add_items(np.zeros((1, 4)))
        with pytest.raises(RuntimeError, match="full"):
            idx.add_items(np.zeros((10, 4)))
        with pytest.raises(ValueError):
            Index(space="manhattan", dim=4)


class TestLabels:
    def test_custom_labels(self):
        data = clustered(100, 8, n_clusters=4, seed=3)
        idx = Index(space="l2", dim=8)
        idx.init_index(max_elements=200, M=8, ef_construction=40, round_size=32)
        labels = np.arange(100) * 10 + 5
        idx.add_items(data, ids=labels)
        got, _ = idx.knn_query(data[7], k=1, ef=32)
        assert got[0, 0] == 75
        with pytest.raises(ValueError, match="duplicate"):
            idx.add_items(data[:1], ids=[75])

    def test_mark_deleted_by_label(self):
        data = clustered(120, 8, n_clusters=4, seed=4)
        idx = Index(space="l2", dim=8)
        idx.init_index(max_elements=200, M=8, ef_construction=40, round_size=32)
        idx.add_items(data, ids=np.arange(120) + 1000)
        assert idx.knn_query(data[9], k=1, ef=32)[0][0, 0] == 1009
        idx.mark_deleted(1009)
        assert idx.knn_query(data[9], k=1, ef=32)[0][0, 0] != 1009
        idx.unmark_deleted(1009)
        assert idx.knn_query(data[9], k=1, ef=32)[0][0, 0] == 1009
        with pytest.raises(KeyError):
            idx.mark_deleted(77777)


class TestCheckpoint:
    def test_save_load_roundtrip(self, small_index, tmp_path):
        data, idx = small_index
        path = tmp_path / "index.npz"
        idx.save_index(path)
        idx2 = Index(space="l2", dim=16)
        idx2.load_index(path)
        assert idx2.get_current_count() == 600
        q = queries_like(data, 40, seed=5)
        l1, d1 = idx.knn_query(q, k=10, ef=48)
        l2, d2 = idx2.knn_query(q, k=10, ef=48)
        np.testing.assert_array_equal(l1, l2)
        np.testing.assert_allclose(d1, d2)

    def test_incremental_insert_after_load(self, tmp_path):
        # the LAION streaming config requires insert-after-load (SURVEY.md §5.4)
        data = clustered(400, 8, n_clusters=8, seed=6)
        idx = Index(space="l2", dim=8)
        idx.init_index(max_elements=500, M=8, ef_construction=40, round_size=64)
        idx.add_items(data[:300])
        path = tmp_path / "partial.npz"
        idx.save_index(path)
        idx2 = Index(space="l2", dim=8)
        idx2.load_index(path)
        idx2.add_items(data[300:])
        assert idx2.get_current_count() == 400
        gt, _ = bruteforce_knn(data, data[300:310], 1, "l2")
        labels, _ = idx2.knn_query(data[300:310], k=1, ef=48)
        assert (labels[:, 0] == np.arange(300, 310)).all()
        # determinism of the continued RNG stream: straight-through build
        # must equal save+load+continue build
        idx3 = Index(space="l2", dim=8)
        idx3.init_index(max_elements=500, M=8, ef_construction=40, round_size=64)
        idx3.add_items(data)
        np.testing.assert_array_equal(
            np.asarray(idx3.graph.levels), np.asarray(idx2.graph.levels)
        )

    def test_space_mismatch_rejected(self, small_index, tmp_path):
        data, idx = small_index
        path = tmp_path / "l2.npz"
        idx.save_index(path)
        other = Index(space="cosine", dim=16)
        with pytest.raises(ValueError, match="cosine"):
            other.load_index(path)


class TestResize:
    def test_resize_then_add(self):
        data = clustered(300, 8, n_clusters=8, seed=7)
        idx = Index(space="l2", dim=8)
        idx.init_index(max_elements=200, M=8, ef_construction=40, round_size=64)
        idx.add_items(data[:200])
        with pytest.raises(RuntimeError, match="full"):
            idx.add_items(data[200:])
        idx.resize_index(400)
        idx.add_items(data[200:])
        assert idx.get_current_count() == 300
        labels, _ = idx.knn_query(data[250], k=1, ef=48)
        assert labels[0, 0] == 250


class TestBFIndex:
    def test_exact(self):
        data = clustered(500, 12, n_clusters=10, seed=8)
        bf = BFIndex(space="l2", dim=12)
        bf.init_index(max_elements=600)
        bf.add_items(data)
        q = queries_like(data, 40, seed=9)
        gt, gtd = bruteforce_knn(data, q, 10, "l2")
        labels, dists = bf.knn_query(q, k=10)
        assert recall(labels, gt) == 1.0
        np.testing.assert_allclose(dists, gtd, rtol=1e-3, atol=1e-3)

    def test_delete_and_roundtrip(self, tmp_path):
        data = clustered(100, 8, n_clusters=4, seed=10)
        bf = BFIndex(space="l2", dim=8)
        bf.init_index(max_elements=100)
        bf.add_items(data)
        assert bf.knn_query(data[3], k=1)[0][0, 0] == 3
        bf.delete_vector(3)
        assert bf.knn_query(data[3], k=1)[0][0, 0] != 3
        path = tmp_path / "bf.npz"
        bf.save_index(path)
        bf2 = BFIndex(space="l2", dim=8)
        bf2.load_index(path)
        assert bf2.knn_query(data[3], k=1)[0][0, 0] != 3
        assert bf2.get_current_count() == 100

    def test_k_exceeds_count_pads(self):
        bf = BFIndex(space="l2", dim=4)
        bf.init_index(max_elements=10)
        bf.add_items(np.eye(4, dtype=np.float32)[:2])
        labels, dists = bf.knn_query(np.zeros((1, 4)), k=5)
        assert labels.shape == (1, 5)
        assert (labels[0, 2:] == -1).all()

    def test_ef_persists_across_save_load(self, small_index, tmp_path):
        data, idx = small_index
        idx.set_ef(64)
        path = tmp_path / "ef.npz"
        idx.save_index(path)
        idx2 = Index(space="l2", dim=16)
        idx2.load_index(path)
        assert idx2.ef == 64
        q = queries_like(data, 20, seed=11)
        np.testing.assert_array_equal(
            idx.knn_query(q, k=10)[0], idx2.knn_query(q, k=10)[0]
        )


class TestFlatIndex:
    def test_fast_path_high_recall(self):
        from ocaml_hnsw_tpu.api import FlatIndex
        data = clustered(2000, 32, n_clusters=40, seed=20)
        fi = FlatIndex(space="l2", dim=32)
        fi.init_index(max_elements=2500, rerank_k=32)
        fi.add_items(data)
        q = queries_like(data, 100, seed=21)
        gt, _ = bruteforce_knn(data, q, 10, "l2")
        labels, dists = fi.knn_query(q, k=10)
        assert recall(labels, gt) >= 0.99
        assert (np.diff(dists, axis=1) >= -1e-6).all()

    def test_delete_and_save_load(self, tmp_path):
        from ocaml_hnsw_tpu.api import FlatIndex
        data = clustered(300, 16, n_clusters=8, seed=22)
        fi = FlatIndex(space="l2", dim=16)
        fi.init_index(max_elements=300)
        fi.add_items(data, ids=np.arange(300) + 50)
        assert fi.knn_query(data[4], k=1)[0][0, 0] == 54
        fi.mark_deleted(54)
        assert fi.knn_query(data[4], k=1)[0][0, 0] != 54
        p = tmp_path / "flat.npz"
        fi.save_index(p)
        fi2 = FlatIndex(space="l2", dim=16)
        fi2.load_index(p)
        assert fi2.knn_query(data[4], k=1)[0][0, 0] != 54
        fi2.unmark_deleted(54)
        assert fi2.knn_query(data[4], k=1)[0][0, 0] == 54

    def test_resize_on_load_grows_tensors(self, tmp_path):
        """load_index(max_elements=...) must actually grow capacity so
        subsequent add_items works (the count-only bump let
        add_items overrun the tensors)."""
        from ocaml_hnsw_tpu.api import FlatIndex
        data = clustered(4100, 16, n_clusters=8, seed=29)
        fi = FlatIndex(space="l2", dim=16)
        fi.init_index(max_elements=4100)
        fi.add_items(data[:4100])
        p = tmp_path / "flat_rs.npz"
        fi.save_index(p)
        fi2 = FlatIndex(space="l2", dim=16)
        fi2.load_index(p, max_elements=8200)
        assert fi2.max_elements == 8200
        assert fi2._flat.n_cap >= 8200
        extra = clustered(4100, 16, n_clusters=8, seed=30)
        fi2.add_items(extra, ids=np.arange(4100) + 10_000)
        assert fi2.get_current_count() == 8200
        # new rows are searchable, old rows survived the re-pad
        assert fi2.knn_query(extra[7], k=1)[0][0, 0] == 10_007
        assert fi2.knn_query(data[3], k=1)[0][0, 0] == 3

    def test_cosine(self):
        from ocaml_hnsw_tpu.api import FlatIndex
        data = clustered(500, 16, n_clusters=10, seed=23)
        fi = FlatIndex(space="cosine", dim=16)
        fi.init_index(max_elements=500)
        fi.add_items(data)
        q = queries_like(data, 50, seed=24)
        gt, _ = bruteforce_knn(data, q, 10, "cosine")
        labels, _ = fi.knn_query(q, k=10)
        assert recall(labels, gt) >= 0.97


class TestStreaming:
    def test_interleaved_inserts_and_queries(self):
        # BASELINE config 5 shape: streaming batched queries + incremental
        # inserts against the same index object
        data = clustered(600, 16, n_clusters=12, seed=30)
        idx = Index(space="cosine", dim=16)
        idx.init_index(max_elements=700, M=8, ef_construction=40,
                       round_size=64)
        idx.add_items(data[:200])
        for step in range(4):
            lo = 200 + step * 100
            q = queries_like(data[:lo], 20, seed=31 + step)
            labels, dists = idx.knn_query(q, k=5, ef=32)
            assert (labels[:, 0] >= 0).all()
            idx.add_items(data[lo : lo + 100])
        assert idx.get_current_count() == 600
        gt, _ = bruteforce_knn(data, data[:50], 1, "cosine")
        labels, _ = idx.knn_query(data[:50], k=1, ef=48)
        assert (labels[:, 0] == np.arange(50)).mean() >= 0.95


class TestFastPathParity:
    """the public Index.knn_query must serve the
    benchmarked engine — identical results to a direct knn_search call at
    equal knobs (seed entry + auto compact_k active at this size)."""

    def test_knn_query_matches_harness_call(self):
        import jax.numpy as jnp
        from ocaml_hnsw_tpu.models.search import knn_search as raw_search
        from ocaml_hnsw_tpu.models.search import build_seed_index

        n, dim, k, ef, mi = 6000, 24, 10, 96, 15
        data = clustered(n, dim, n_clusters=48, seed=6)
        q = queries_like(data, 64, seed=7)
        idx = Index(space="l2", dim=dim)
        idx.init_index(max_elements=n, M=16, ef_construction=80,
                       round_size=1024)
        idx.add_items(data)
        assert idx._seed_index() is not None  # seeds active at this size

        labels, dists = idx.knn_query(q, k=k, ef=ef, max_iters=mi)

        # the bench harness's exact call shape (harness.py run_config)
        cfg = idx.config
        compact = 3 * (4 * cfg.M_max0) // 4 if 4 * cfg.M_max0 >= 128 else None
        seeds = build_seed_index(idx.graph, "l2")
        ids2, d2 = raw_search(idx.graph, jnp.asarray(q), k=k, ef=ef,
                              metric="l2", max_iters=mi, seeds=seeds,
                              compact_k=compact)
        np.testing.assert_array_equal(labels, np.asarray(ids2))
        np.testing.assert_allclose(dists, np.asarray(d2), rtol=1e-6)

    def test_knn_query_packed_schedule_matches_harness_call(self, monkeypatch):
        """Same parity for the packed engine at the round-4 headline knobs
        (ef=64, expand_schedule=((4,4),(2,22)), rk=32)."""
        import jax.numpy as jnp
        from ocaml_hnsw_tpu.models.packed import (
            knn_search_packed, pack_graph,
        )
        from ocaml_hnsw_tpu.models.search import build_seed_index

        n, dim, k = 6000, 24, 10
        sched = ((4, 4), (2, 22))
        data = clustered(n, dim, n_clusters=48, seed=6)
        q = queries_like(data, 64, seed=8)
        monkeypatch.setattr(Index, "PACKED_THRESHOLD", 1000)
        idx = Index(space="l2", dim=dim)
        idx.init_index(max_elements=n, M=16, ef_construction=80,
                       round_size=1024)
        idx.add_items(data)
        labels, dists = idx.knn_query(q, k=k, ef=64,
                                      expand_schedule=sched, rerank_k=32)
        seeds = build_seed_index(idx.graph, "l2")
        p = pack_graph(idx.graph, "l2")
        ids2, d2 = knn_search_packed(
            idx.graph, p, jnp.asarray(q), k=k, ef=64, metric="l2",
            seeds=seeds, seed_e=8, rerank_k=32, expand_schedule=sched)
        np.testing.assert_array_equal(labels, np.asarray(ids2))
        np.testing.assert_allclose(dists, np.asarray(d2), rtol=1e-6)
