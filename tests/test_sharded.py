"""Sharded-index tests on the CPU-simulated 8-device mesh (SURVEY.md §4:
multi-node testing without a real cluster)."""

import numpy as np
import jax
import pytest

from ocaml_hnsw_tpu.parallel import ShardedIndex
from ocaml_hnsw_tpu.parallel.sharded import make_mesh
from ocaml_hnsw_tpu.oracle import bruteforce_knn, recall
from ocaml_hnsw_tpu.bench.datasets import clustered, queries_like


@pytest.fixture(scope="module")
def sharded():
    assert len(jax.devices()) == 8, "conftest must provide 8 CPU devices"
    data = clustered(800, 16, n_clusters=32, seed=0)
    idx = ShardedIndex(space="l2", dim=16, mesh=make_mesh(8))
    idx.init_index(max_elements=1000, M=8, ef_construction=40, round_size=64,
                   max_level_cap=2)
    idx.add_items(data)
    return data, idx


class TestShardedQuery:
    def test_recall(self, sharded):
        data, idx = sharded
        assert idx.get_current_count() == 800
        q = queries_like(data, 100, seed=1)
        gt, _ = bruteforce_knn(data, q, 10, "l2")
        labels, dists = idx.knn_query(q, k=10, ef=48)
        assert recall(labels, gt) >= 0.95
        assert (np.diff(dists, axis=1) >= -1e-6).all()

    def test_exact_self_hits(self, sharded):
        data, idx = sharded
        labels, dists = idx.knn_query(data[:32], k=1, ef=32)
        assert (labels[:, 0] == np.arange(32)).all()
        np.testing.assert_allclose(dists[:, 0], 0.0, atol=1e-4)

    def test_merge_is_global(self, sharded):
        # top-k must mix shards: with round-robin placement the true top-10 of
        # a query will span several shards essentially always
        data, idx = sharded
        q = queries_like(data, 20, seed=2)
        labels, _ = idx.knn_query(q, k=10, ef=64)
        shards = labels % 8
        assert (np.ptp(shards, axis=1) > 0).any()

    def test_mark_deleted(self, sharded):
        data, idx = sharded
        labels, _ = idx.knn_query(data[5], k=1, ef=32)
        assert labels[0, 0] == 5
        idx.mark_deleted(5)
        labels, _ = idx.knn_query(data[5], k=1, ef=32)
        assert labels[0, 0] != 5


class TestShardedPacked:
    """the sharded path serves the per-shard packed
    inline-int8 engine (the single-chip fast path) above the threshold."""

    def test_packed_query_matches_classic(self, sharded, monkeypatch):
        from ocaml_hnsw_tpu.parallel.sharded import ShardedIndex

        data, idx = sharded
        q = queries_like(data, 60, seed=11)
        gt, _ = bruteforce_knn(data, q, 10, "l2")
        monkeypatch.setattr(ShardedIndex, "PACKED_THRESHOLD", 100)
        idx._packed_cache = None
        assert idx._packed_stacked() is not None
        lp, dp = idx.knn_query(q, k=10, ef=48)
        rp = recall(lp, gt)
        assert (np.diff(dp, axis=1) >= -1e-6).all()
        monkeypatch.setattr(ShardedIndex, "PACKED_THRESHOLD", 10**9)
        idx._packed_cache = None
        lc, _ = idx.knn_query(q, k=10, ef=48)
        rc = recall(lc, gt)
        assert rp >= rc - 0.02, (rp, rc)

    def test_packed_respects_tombstones(self, sharded, monkeypatch):
        from ocaml_hnsw_tpu.parallel.sharded import ShardedIndex

        data, idx = sharded
        monkeypatch.setattr(ShardedIndex, "PACKED_THRESHOLD", 100)
        idx._packed_cache = None
        labels, _ = idx.knn_query(data[7], k=1, ef=32)
        assert labels[0, 0] == 7
        idx.mark_deleted(7)
        labels, _ = idx.knn_query(data[7], k=1, ef=32)
        assert labels[0, 0] != 7
        idx.unmark_deleted(7)


class TestShardedIncremental:
    def test_two_phase(self):
        data = clustered(400, 8, n_clusters=16, seed=3)
        idx = ShardedIndex(space="l2", dim=8, mesh=make_mesh(8))
        idx.init_index(max_elements=500, M=8, ef_construction=32,
                       round_size=32, max_level_cap=2)
        idx.add_items(data[:250])
        idx.add_items(data[250:])
        assert idx.get_current_count() == 400
        q = queries_like(data, 60, seed=4)
        gt, _ = bruteforce_knn(data, q, 10, "l2")
        labels, _ = idx.knn_query(q, k=10, ef=48)
        assert recall(labels, gt) >= 0.9


class TestMeshSizes:
    # minimal static shapes: each mesh size compiles its own insert_round and
    # these compiles dominated the whole suite (885 s for S=2 at the previous
    # sizes on this one-core machine).  S=2 is slow-lane only: the 8-device
    # fixture and dryrun_multichip cover multi-shard; S=1 covers the
    # single-device degenerate case cheaply.
    @pytest.mark.parametrize(
        "n_dev", [1, pytest.param(2, marks=pytest.mark.slow)]
    )
    def test_small_meshes(self, n_dev):
        data = clustered(120, 8, n_clusters=6, seed=5)
        idx = ShardedIndex(space="l2", dim=8, mesh=make_mesh(n_dev))
        idx.init_index(max_elements=200, M=4, ef_construction=16,
                       round_size=16, max_level_cap=1)
        idx.add_items(data)
        labels, _ = idx.knn_query(data[:10], k=1, ef=16)
        assert (labels[:, 0] == np.arange(10)).all()


class TestShardedLifecycle:
    def test_save_load_roundtrip(self, sharded, tmp_path):
        data, idx = sharded
        q = queries_like(data, 40, seed=9)
        l1, d1 = idx.knn_query(q, k=10, ef=48)
        p = str(tmp_path / "sharded.bin")
        idx.save_index(p)
        idx2 = ShardedIndex(space="l2", dim=16, mesh=make_mesh(8))
        idx2.load_index(p)
        assert idx2.get_current_count() == idx.get_current_count()
        l2, d2 = idx2.knn_query(q, k=10, ef=48)
        np.testing.assert_array_equal(l1, l2)
        np.testing.assert_allclose(d1, d2, rtol=1e-6)

    def test_load_then_incremental_add(self, sharded, tmp_path):
        data, idx = sharded
        p = str(tmp_path / "s2.bin")
        idx.save_index(p)
        idx2 = ShardedIndex(space="l2", dim=16, mesh=make_mesh(8))
        idx2.load_index(p, max_elements=1400)
        extra = clustered(100, 16, n_clusters=4, seed=77)
        idx2.add_items(extra)
        assert idx2.get_current_count() == idx.get_current_count() + 100
        labels, _ = idx2.knn_query(extra[:5], k=1, ef=48)
        base = idx.get_current_count()
        assert set(labels[:, 0]) <= set(range(base, base + 100)) | set(
            range(base)
        )

    def test_get_items_and_unmark(self, sharded):
        data, idx = sharded
        got = idx.get_items([3, 17])
        np.testing.assert_allclose(got, data[[3, 17]], rtol=1e-5, atol=1e-5)
        idx.mark_deleted(3)
        l, _ = idx.knn_query(data[3], k=1, ef=32)
        assert l[0, 0] != 3
        idx.unmark_deleted(3)
        l, _ = idx.knn_query(data[3], k=1, ef=32)
        assert l[0, 0] == 3

    def test_shard_count_mismatch_rejected(self, sharded, tmp_path):
        data, idx = sharded
        p = str(tmp_path / "s3.bin")
        idx.save_index(p)
        idx4 = ShardedIndex(space="l2", dim=16, mesh=make_mesh(4))
        with pytest.raises(ValueError, match="shard"):
            idx4.load_index(p)


class TestShardedStorage:
    """quantized storage through the sharded engine."""

    def test_int8_build_query_saveload(self, tmp_path):
        data = clustered(400, 16, n_clusters=16, seed=21)
        idx = ShardedIndex(space="l2", dim=16, mesh=make_mesh(8))
        idx.init_index(max_elements=500, M=8, ef_construction=40,
                       round_size=64, max_level_cap=2, storage="int8")
        assert idx.config.storage == "int8"
        idx.add_items(data)
        q = queries_like(data, 60, seed=22)
        gt, _ = bruteforce_knn(data, q, 10, "l2")
        labels, _ = idx.knn_query(q, k=10, ef=48)
        assert recall(labels, gt) >= 0.9  # int8 quantization headroom

        p = str(tmp_path / "int8.bin")
        idx.save_index(p)
        idx2 = ShardedIndex(space="l2", dim=16, mesh=make_mesh(8))
        idx2.load_index(p)
        assert idx2.config.storage == "int8"
        l2_, _ = idx2.knn_query(q, k=10, ef=48)
        np.testing.assert_array_equal(labels, l2_)
