"""Native C++ baseline engine tests: recall vs brute force, agreement with the
NumPy oracle's quality, and a build-throughput sanity check (this engine is
the single-threaded CPU baseline that the 10× build target in BASELINE.json
is scored against)."""

import time

import numpy as np
import pytest

from ocaml_hnsw_tpu.oracle import bruteforce_knn, recall
from ocaml_hnsw_tpu.bench.datasets import clustered, queries_like

native = pytest.importorskip("ocaml_hnsw_tpu.native")
if not native.native_available():
    pytest.skip("g++ unavailable", allow_module_level=True)


def test_recall_vs_bruteforce():
    data = clustered(3000, 32, n_clusters=50, seed=0)
    q = queries_like(data, 200, seed=1)
    idx = native.NativeHNSW(dim=32, M=16, ef_construction=100)
    idx.add_items(data)
    assert idx.element_count == 3000
    gt, _ = bruteforce_knn(data, q, 10, "l2")
    ids, d = idx.knn_query(q, k=10, ef=64)
    assert recall(ids, gt) >= 0.98
    assert (np.diff(d, axis=1) >= -1e-6).all()


def test_cosine():
    data = clustered(1000, 16, n_clusters=16, seed=2)
    q = queries_like(data, 100, seed=3)
    idx = native.NativeHNSW(dim=16, metric="cosine", M=12, ef_construction=80)
    idx.add_items(data)
    gt, _ = bruteforce_knn(data, q, 10, "cosine")
    ids, _ = idx.knn_query(q, k=10, ef=64)
    assert recall(ids, gt) >= 0.95


def test_self_hits_and_padding():
    data = clustered(500, 8, n_clusters=8, seed=4)
    idx = native.NativeHNSW(dim=8, M=8, ef_construction=50)
    idx.add_items(data)
    ids, d = idx.knn_query(data[:20], k=1, ef=32)
    assert (ids[:, 0] == np.arange(20)).all()
    np.testing.assert_allclose(d[:, 0], 0.0, atol=1e-5)
    ids, d = idx.knn_query(data[:1], k=600, ef=600)
    assert (ids[0, 500:] == -1).all()


def test_build_rate_measured():
    # not an assertion on speed — just that the baseline measurement works
    data = clustered(2000, 128, n_clusters=32, seed=5)
    idx = native.NativeHNSW(dim=128, M=16, ef_construction=200)
    t0 = time.perf_counter()
    idx.add_items(data)
    vps = 2000 / (time.perf_counter() - t0)
    assert vps > 0
    print(f"native single-thread build: {vps:.0f} vps (128-d, efC=200)")


def _recall_parity(n: int, dim: int, round_size: int, efs) -> None:
    """North-star parity: recall@10 at equal (M, efC, ef) must match the
    single-threaded reference engine."""
    import jax.numpy as jnp
    from ocaml_hnsw_tpu.config import HnswConfig
    from ocaml_hnsw_tpu.models.build import BuildState
    from ocaml_hnsw_tpu.models.search import knn_search, build_seed_index

    data = clustered(n, dim, n_clusters=64, seed=3)
    q = queries_like(data, 200, seed=4)
    gt, _ = bruteforce_knn(data, q, 10, "l2")

    nat = native.NativeHNSW(dim=dim, M=12, ef_construction=100)
    nat.add_items(data)
    from tests.conftest import built_state_cached

    st = built_state_cached(
        f"nat{n}x{dim}", HnswConfig(dim=dim, M=12, ef_construction=100), n,
        data, round_size=round_size)
    seeds = build_seed_index(st.graph, "l2")
    qj = jnp.asarray(np.pad(q, ((0, 56), (0, 0))))  # 200 -> 256
    for ef in efs:
        n_ids, _ = nat.knn_query(q, k=10, ef=ef)
        t_ids, _ = knn_search(st.graph, qj, k=10, ef=ef, metric="l2",
                              seeds=seeds)
        r_nat = recall(n_ids, gt)
        r_tpu = recall(np.asarray(t_ids)[:200], gt)
        assert r_tpu >= r_nat - 0.02, (ef, r_tpu, r_nat)


def test_equal_settings_recall_parity_5k():
    """Default-lane parity check (one device-build, one ef)."""
    _recall_parity(5_000, 32, round_size=1024, efs=(48,))


@pytest.mark.slow
def test_equal_settings_recall_parity_20k():
    """Slow-lane version at 20k points, two efs (1,394 s on this machine —
    the single-core CPU device build dominates)."""
    _recall_parity(20_000, 32, round_size=1024, efs=(32, 64))
