"""Bulk MXU graph constructor (models/bulk.py): reverse-scatter semantics,
structural invariants of the constructed layered graph, determinism, and end
recall parity with the incremental builder at equal settings."""

import numpy as np
import jax.numpy as jnp
import pytest

from ocaml_hnsw_tpu.bench.datasets import clustered, queries_like
from ocaml_hnsw_tpu.config import HnswConfig
from ocaml_hnsw_tpu.models.build import BuildState, sample_levels
from ocaml_hnsw_tpu.models.bulk import bulk_build, reverse_scatter
from ocaml_hnsw_tpu.models.search import build_seed_index, knn_search
from ocaml_hnsw_tpu.oracle.bruteforce import bruteforce_knn, recall


class TestReverseScatter:
    def test_matches_numpy_reference(self):
        """Row u of the output holds the sources of its rev_cap nearest
        incoming edges, distance-ascending."""
        rng = np.random.RandomState(0)
        r, m, n, cap = 500, 6, 40, 5
        fwd = rng.randint(-1, n, size=(r, m)).astype(np.int32)
        d = rng.rand(r, m).astype(np.float32)
        rev, rev_d = map(
            np.asarray,
            reverse_scatter(jnp.asarray(fwd), jnp.asarray(d), n, cap),
        )
        assert rev.shape == (n, cap)
        for t in range(n):
            inc = sorted(
                (d[v, j], v)
                for v in range(r)
                for j in range(m)
                if fwd[v, j] == t
            )[:cap]
            got = [
                (rev_d[t, i], rev[t, i]) for i in range(cap) if rev[t, i] >= 0
            ]
            assert len(got) == len(inc)
            # multiset equality (distance ties may permute sources)
            assert sorted((round(float(a), 6), int(b)) for a, b in inc) == \
                sorted((round(float(a), 6), int(b)) for a, b in got)
            # ascending
            dd = [float(a) for a, _ in got]
            assert dd == sorted(dd)

    def test_deterministic(self):
        rng = np.random.RandomState(3)
        fwd = rng.randint(-1, 64, size=(256, 4)).astype(np.int32)
        d = rng.rand(256, 4).astype(np.float32)
        a = reverse_scatter(jnp.asarray(fwd), jnp.asarray(d), 64, 6)
        b = reverse_scatter(jnp.asarray(fwd), jnp.asarray(d), 64, 6)
        assert all(
            (np.asarray(x) == np.asarray(y)).all() for x, y in zip(a, b)
        )


@pytest.fixture(scope="module")
def built():
    n, dim = 4000, 24
    data = clustered(n, dim, n_clusters=32, seed=1)
    cfg = HnswConfig(dim=dim, M=12, ef_construction=80)
    g = bulk_build(data, cfg, knn_k=24, batch=1024)
    return data, cfg, g


class TestBulkGraph:
    def test_structure(self, built):
        data, cfg, g = built
        n = int(g.n)
        assert n == len(data)
        adj0 = np.asarray(g.adj0)
        levels = np.asarray(g.levels)[:n]
        # degree caps and no self-edges / duplicates at layer 0
        assert adj0.shape[1] == cfg.M_max0
        for i in range(0, n, 131):
            row = adj0[i][adj0[i] >= 0]
            assert len(set(row.tolist())) == len(row)
            assert i not in row
            assert (row < n).all()
        # level distribution follows the shared sampler stream
        rng = np.random.RandomState(cfg.seed)
        want = np.asarray(
            sample_levels(rng, n, cfg.mL, g.l_max_static))
        assert (levels == want).all()
        # entry point is the lowest id at the top level
        top = int(np.asarray(g.max_level))
        assert levels[int(np.asarray(g.entry))] == top

    def test_upper_arena_rows(self, built):
        data, cfg, g = built
        n = int(g.n)
        levels = np.asarray(g.levels)[:n]
        up_base = np.asarray(g.up_base)
        adj_up = np.asarray(g.adj_up)
        upper = np.nonzero(levels >= 1)[0]
        for v in upper[::7]:
            for lvl in range(1, levels[v] + 1):
                row = adj_up[up_base[v] + lvl - 1]
                row = row[row >= 0]
                assert len(row) <= cfg.M
                # neighbors at level l must themselves live at level >= l
                assert (levels[row] >= lvl).all()

    def test_deterministic(self, built):
        data, cfg, g = built
        g2 = bulk_build(data, cfg, knn_k=24, batch=1024)
        assert (np.asarray(g.adj0) == np.asarray(g2.adj0)).all()
        assert (np.asarray(g.adj_up) == np.asarray(g2.adj_up)).all()

    def test_recall_vs_incremental(self, built):
        """Bulk graph serves recall >= the incremental builder's at equal
        (M, ef) through the same query engine."""
        data, cfg, g = built
        q = queries_like(data, 200, seed=5)
        gt, _ = bruteforce_knn(data, q, 10)
        seeds = build_seed_index(g, "l2")
        ids, _ = knn_search(g, jnp.asarray(q), k=10, ef=64, metric="l2",
                            seeds=seeds)
        r_bulk = recall(np.asarray(ids), gt)
        from tests.conftest import built_state_cached

        st = built_state_cached("std4000x24", cfg, len(data), data,
                                round_size=512)
        seeds_i = build_seed_index(st.graph, "l2")
        ids_i, _ = knn_search(st.graph, jnp.asarray(q), k=10, ef=64,
                              metric="l2", seeds=seeds_i)
        r_inc = recall(np.asarray(ids_i), gt)
        assert r_bulk >= 0.93
        assert r_bulk >= r_inc - 0.01


class TestBulkDispatch:
    """BuildState.add routes a large first add() through bulk_build
    (build.py _bulk_eligible) and keeps every host-side invariant that the
    incremental path maintains."""

    def test_first_add_dispatches_and_streams_on(self, monkeypatch):
        n, dim = 1500, 16
        data = clustered(n, dim, n_clusters=16, seed=2)
        cfg = HnswConfig(dim=dim, M=8, ef_construction=40)
        monkeypatch.setattr(BuildState, "BULK_THRESHOLD", 1000)
        st = BuildState(cfg, 2500, round_size=256)
        st.add(data)
        # levels came from the state's own RNG stream (not config.seed's
        # position zero twice): a fresh stream sampled once must match
        rng = np.random.RandomState(cfg.seed)
        want = np.asarray(sample_levels(rng, n, cfg.mL, st.l_max))
        assert (np.asarray(st.graph.levels)[:n] == want).all()
        assert int(st.graph.n) == n
        assert st.host_n == n
        assert st.host_max_level == int(np.asarray(st.graph.max_level))
        assert st.host_up_n == int(st.graph.up_n)
        # streaming insert on top of the adopted bulk graph
        extra = clustered(300, dim, n_clusters=8, seed=3)
        st.add(extra)
        assert int(st.graph.n) == n + 300
        q = queries_like(data, 100, seed=9)
        gt, _ = bruteforce_knn(np.concatenate([data, extra]), q, 10)
        seeds = build_seed_index(st.graph, "l2")
        ids, _ = knn_search(st.graph, jnp.asarray(q), k=10, ef=64,
                            metric="l2", seeds=seeds)
        assert recall(np.asarray(ids), gt) >= 0.9

    def test_small_or_nondefault_modes_stay_incremental(self, monkeypatch):
        cfg = HnswConfig(dim=16, M=8, ef_construction=40)
        st = BuildState(cfg, 200_001, round_size=256)
        assert not st._bulk_eligible(st.BULK_THRESHOLD - 1)
        assert st._bulk_eligible(st.BULK_THRESHOLD + 1)
        st.host_n = 5  # non-empty index -> rounds
        assert not st._bulk_eligible(st.BULK_THRESHOLD + 1)
        st.host_n = 0
        st.bulk_first_add = False  # explicit opt-out
        assert not st._bulk_eligible(st.BULK_THRESHOLD + 1)
        cfg2 = HnswConfig(dim=16, M=8, ef_construction=40, select="simple")
        assert not BuildState(cfg2, 2500)._bulk_eligible(10**6)
        cfg3 = HnswConfig(dim=16, M=8, ef_construction=40,
                          extend_candidates=True)
        assert not BuildState(cfg3, 2500)._bulk_eligible(10**6)

    def test_sparse_first_add_keeps_round_path(self, monkeypatch):
        """A first batch much smaller than the index capacity would pay
        capacity-padded compute in every bulk pass — rounds instead."""
        cfg = HnswConfig(dim=16, M=8, ef_construction=40)
        monkeypatch.setattr(BuildState, "BULK_THRESHOLD", 1000)
        st = BuildState(cfg, 10_000, round_size=256)
        assert not st._bulk_eligible(1200)   # 2*1200 < 10_000
        assert st._bulk_eligible(5000)

    def test_hbm_guard_uses_capacity_not_batch(self):
        """The guard sizes the workspace from the padded index CAPACITY
        (what bulk_build allocates), not the first-batch row count — probed
        via the pure arithmetic, no tensor allocation."""
        from ocaml_hnsw_tpu.models.bulk import bulk_workspace_bytes
        from ocaml_hnsw_tpu.models.graph import capacity

        # 768-d 10M: workspace alone far exceeds the budget (16 GiB
        # fallback limit on a backend that reports none)
        need = bulk_workspace_bytes(capacity(10**7), 768, m=16, m_max0=32)
        assert need >= BuildState.bulk_budget_bytes()
        # 128-d 1M (the headline shape) comfortably fits
        need = bulk_workspace_bytes(capacity(10**6), 128, m=16, m_max0=32)
        assert need < BuildState.bulk_budget_bytes()
        # dim=96 pads to 128 lanes: equal workspace to dim=128
        assert bulk_workspace_bytes(capacity(10**6), 96, m=16, m_max0=32) \
            == need
