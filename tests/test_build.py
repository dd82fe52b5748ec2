"""Batched device-build tests: graph invariants, oracle recall parity,
determinism, incremental insertion (SURVEY.md §4, §7 step 4)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ocaml_hnsw_tpu.config import HnswConfig
from ocaml_hnsw_tpu.oracle import OracleHNSW, bruteforce_knn, recall
from ocaml_hnsw_tpu.models import knn_search
from ocaml_hnsw_tpu.models.build import build, BuildState, sample_levels
from ocaml_hnsw_tpu.models.graph import dense_upper
from ocaml_hnsw_tpu.bench.datasets import clustered, queries_like

CFG = HnswConfig(dim=24, M=8, ef_construction=60)


@pytest.fixture(scope="module")
def built():
    data = clustered(1200, 24, n_clusters=24, seed=0)
    g = build(data, CFG, round_size=128)
    jax.block_until_ready(g.adj0)
    return data, g


class TestInvariants:
    def test_degree_caps_and_no_dups(self, built):
        data, g = built
        n = int(g.n)
        assert n == len(data)
        adj0 = np.asarray(g.adj0)[:n]
        assert ((adj0 >= 0).sum(1) <= CFG.M_max0).all()
        for lv in range(1, g.l_max + 1):
            up = dense_upper(g, lv)
            assert ((up >= 0).sum(1) <= CFG.M).all()
        # arena accounting: allocated rows match the summed levels exactly
        levels = np.asarray(g.levels)[:n]
        assert int(g.up_n) == int(levels.sum())
        ub = np.asarray(g.up_base)[:n]
        assert ((ub >= 0) == (levels >= 1)).all()
        blocks = sorted((int(b), int(l)) for b, l in zip(ub, levels) if l >= 1)
        end = 0
        for b, l in blocks:  # blocks are disjoint and tightly packed
            assert b == end
            end = b + l
        for i in range(n):
            row = adj0[i][adj0[i] >= 0]
            assert len(set(row.tolist())) == len(row)
            assert i not in row
            assert (row < n).all()

    def test_levels_and_entry(self, built):
        data, g = built
        n = int(g.n)
        levels = np.asarray(g.levels)
        assert (levels[:n] >= 0).all()
        assert (levels[n:] == -1).all()
        assert int(g.max_level) == levels[:n].max()
        assert levels[int(g.entry)] == int(g.max_level)
        # edges only between nodes that exist at that layer
        for lv in range(1, g.l_max + 1):
            up = dense_upper(g, lv)
            owners = np.repeat(np.arange(n), up.shape[1])
            flat = up.reshape(-1)
            mask = flat >= 0
            assert (levels[flat[mask]] >= lv).all()
            assert (levels[owners[mask]] >= lv).all()

    def test_level_stream_matches_oracle(self, built):
        # determinism hook: device build consumes the same RNG stream as the
        # sequential oracle (seeded level sampling is the only randomness)
        data, g = built
        o = OracleHNSW(CFG)
        o.add_items(data)
        n = int(g.n)
        dev_levels = np.asarray(g.levels)[:n]
        orc_levels = np.minimum(np.asarray(o.levels), g.l_max)
        np.testing.assert_array_equal(dev_levels, orc_levels)


class TestRecallParity:
    def test_vs_oracle_and_bruteforce(self, built):
        data, g = built
        q = queries_like(data, 150, seed=1)
        gt, _ = bruteforce_knn(data, q, 10, "l2")
        ids, _ = knn_search(g, jnp.asarray(q), k=10, ef=48, metric="l2")
        r_dev = recall(np.asarray(ids), gt)
        o = OracleHNSW(CFG)
        o.add_items(data)
        r_orc = recall(o.knn_query(q, k=10, ef=48)[0], gt)
        assert r_dev >= r_orc - 0.02, (r_dev, r_orc)
        assert r_dev >= 0.9

    def test_cosine_build(self):
        cfg = HnswConfig(dim=16, metric="cosine", M=8, ef_construction=50)
        data = clustered(600, 16, n_clusters=12, seed=3)
        g = build(data, cfg, round_size=128)
        q = queries_like(data, 60, seed=4)
        gt, _ = bruteforce_knn(data, q, 10, "cosine")
        ids, _ = knn_search(g, jnp.asarray(q), k=10, ef=48, metric="cosine")
        assert recall(np.asarray(ids), gt) >= 0.9

    def test_cosine_device_add_keeps_caller_array(self):
        """A cosine add of a device array normalizes into a new buffer: the
        caller's array stays usable and unchanged, so a warm-up add and a
        timed add of the same array (bench/harness.py) both work and agree."""
        cfg = HnswConfig(dim=16, metric="cosine", M=8, ef_construction=50)
        data = clustered(600, 16, n_clusters=12, seed=3)
        dev = jnp.asarray(data)
        graphs = []
        for _ in range(2):
            st = BuildState(cfg, 600, round_size=128)
            st.add(dev)
            graphs.append(np.asarray(st.graph.adj0))
        np.testing.assert_array_equal(np.asarray(dev), data)
        np.testing.assert_array_equal(graphs[0], graphs[1])

    @pytest.mark.parametrize("n_rows,dtype", [
        (0, jnp.float32), (5, jnp.float32), (7, jnp.bfloat16),
    ])
    def test_prep_normalizes_without_donation(self, n_rows, dtype):
        cfg = HnswConfig(dim=16, metric="cosine", M=8)
        st = BuildState(cfg, 64, round_size=16)
        rows = np.random.RandomState(0).randn(n_rows, 16).astype(np.float32)
        dev = jnp.asarray(rows, dtype)
        out = st.prep(dev)
        assert out.shape == dev.shape and out.dtype == dev.dtype
        # the caller's buffer is still alive and unchanged
        np.testing.assert_array_equal(np.asarray(dev, np.float32),
                                      np.asarray(jnp.asarray(rows, dtype),
                                                 np.float32))
        if n_rows:
            nrm = np.linalg.norm(np.asarray(out, np.float32), axis=1)
            np.testing.assert_allclose(nrm, 1.0, rtol=1e-2)


class TestDeterminism:
    def test_same_seed_same_graph(self):
        data = clustered(500, 16, n_clusters=10, seed=5)
        cfg = HnswConfig(dim=16, M=8, ef_construction=40)
        g1 = build(data, cfg, round_size=64)
        g2 = build(data, cfg, round_size=64)
        np.testing.assert_array_equal(np.asarray(g1.adj0), np.asarray(g2.adj0))
        np.testing.assert_array_equal(
            np.asarray(g1.adj_up), np.asarray(g2.adj_up)
        )
        np.testing.assert_array_equal(
            np.asarray(g1.up_base), np.asarray(g2.up_base)
        )
        assert int(g1.entry) == int(g2.entry)

    def test_scan_driver_matches_per_round(self):
        """The lax.scan round driver (BuildState.SCAN_CHUNK rounds per
        dispatch) is the same program as the per-round path — graphs must
        match exactly."""
        data = clustered(600, 16, n_clusters=10, seed=5)
        cfg = HnswConfig(dim=16, M=8, ef_construction=40)
        st1 = BuildState(cfg, max_elements=600, round_size=64)
        st1.SCAN_CHUNK = 4  # force the scan path on a small build
        st1.add(data)
        st2 = BuildState(cfg, max_elements=600, round_size=64)
        st2.SCAN_CHUNK = 10**9  # pure per-round path
        st2.add(data)
        g1, g2 = st1.graph, st2.graph
        assert st1.host_n == st2.host_n == 600
        np.testing.assert_array_equal(np.asarray(g1.adj0), np.asarray(g2.adj0))
        np.testing.assert_array_equal(
            np.asarray(g1.adj_up), np.asarray(g2.adj_up)
        )
        np.testing.assert_array_equal(
            np.asarray(g1.levels), np.asarray(g2.levels)
        )
        assert int(g1.entry) == int(g2.entry)
        assert int(g1.n) == int(g2.n) == 600
        np.testing.assert_array_equal(
            np.asarray(st1.seed_bank), np.asarray(st2.seed_bank)
        )

    def test_sample_levels_stream(self):
        rng1 = np.random.RandomState(100)
        a = sample_levels(rng1, 1000, 1 / np.log(16), 8)
        rng2 = np.random.RandomState(100)
        b1 = sample_levels(rng2, 400, 1 / np.log(16), 8)
        b2 = sample_levels(rng2, 600, 1 / np.log(16), 8)
        np.testing.assert_array_equal(a, np.concatenate([b1, b2]))


class TestIncremental:
    def test_two_phase_add(self):
        cfg = HnswConfig(dim=16, M=8, ef_construction=40)
        data = clustered(800, 16, n_clusters=16, seed=6)
        st = BuildState(cfg, max_elements=800, round_size=64)
        st.add(data[:500])
        assert int(st.graph.n) == 500
        st.add(data[500:])
        assert int(st.graph.n) == 800
        q = queries_like(data, 80, seed=7)
        gt, _ = bruteforce_knn(data, q, 10, "l2")
        ids, _ = knn_search(st.graph, jnp.asarray(q), k=10, ef=48, metric="l2")
        assert recall(np.asarray(ids), gt) >= 0.9

    def test_late_points_reachable(self):
        # incremental points must get reverse edges into the old graph
        cfg = HnswConfig(dim=8, M=8, ef_construction=40)
        data = clustered(400, 8, n_clusters=8, seed=8)
        st = BuildState(cfg, max_elements=400, round_size=64)
        st.add(data[:300])
        st.add(data[300:])
        ids, dists = knn_search(
            st.graph, jnp.asarray(data[300:]), k=1, ef=32, metric="l2"
        )
        found = (np.asarray(ids)[:, 0] == np.arange(300, 400)).mean()
        assert found >= 0.95


class TestSelectionModes:
    """Alg 3 simple selector and Alg 4 extendCandidates as usable modes in
    BOTH the oracle and the device builder."""

    def _recall_pair(self, cfg, n=900, seed=0):
        data = clustered(n, cfg.dim, n_clusters=18, seed=seed)
        q = queries_like(data, 80, seed=seed + 1)
        gt, _ = bruteforce_knn(data, q, 10, cfg.metric)
        o = OracleHNSW(cfg)
        o.add_items(data)
        o_ids, _ = o.knn_query(q, k=10, ef=48)
        g = build(data, cfg, round_size=128)
        t_ids, _ = knn_search(g, jnp.asarray(q), k=10, ef=48,
                              metric=cfg.metric)
        return recall(o_ids, gt), recall(np.asarray(t_ids), gt)

    def test_simple_select_parity(self):
        # Alg 3 builds measurably worse graphs (the point of the ablation);
        # without the heuristic's diversity correction the batched builder's
        # per-round reverse-edge cap costs more than it does under Alg 4, so
        # the parity band is wider here (observed ~0.72 vs oracle ~0.78).
        cfg = HnswConfig(dim=16, M=8, ef_construction=60, select="simple")
        r_o, r_t = self._recall_pair(cfg)
        assert r_t >= r_o - 0.09, (r_t, r_o)
        assert r_t >= 0.7

    def test_extend_candidates_parity(self):
        cfg = HnswConfig(dim=16, M=8, ef_construction=60,
                         extend_candidates=True)
        r_o, r_t = self._recall_pair(cfg)
        assert r_t >= r_o - 0.03, (r_t, r_o)
        assert r_t >= 0.9

    def test_extend_candidates_not_worse_than_plain(self):
        base = HnswConfig(dim=16, M=8, ef_construction=60)
        ext = HnswConfig(dim=16, M=8, ef_construction=60,
                         extend_candidates=True)
        _, r_plain = self._recall_pair(base, seed=5)
        _, r_ext = self._recall_pair(ext, seed=5)
        # extendCandidates targets clustered data; it must not hurt
        assert r_ext >= r_plain - 0.02, (r_ext, r_plain)
