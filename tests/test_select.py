"""ops/select.py::min_k against NumPy exact top-k: slabs that do not divide
N, +inf (tombstone) masking, k near N, bf16 scores, and the group-min
method's recall and fallback."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from ocaml_hnsw_tpu.ops.select import min_k


def _scores(b, n, seed=0, inf_frac=0.0):
    rng = np.random.RandomState(seed)
    s = rng.randn(b, n).astype(np.float32)
    if inf_frac:
        s[rng.rand(b, n) < inf_frac] = np.inf
    return s


def _run(s, k, **kw):
    blk = lambda st, w: jax.lax.dynamic_slice_in_dim(  # noqa: E731
        jnp.asarray(s), st, w, axis=1)
    vals, ids = jax.jit(lambda: min_k(blk, s.shape[1], k, **kw))()
    return np.asarray(vals), np.asarray(ids)


@pytest.mark.parametrize("n,k,slab", [
    (1000, 10, 256),    # 4 slabs, the last one shifted left
    (1000, 10, None),   # one block
    (300, 299, 128),    # k near N, k > slab
    (64, 64, None),     # k == N
    (4096, 97, 1024),   # the bulk build's k, slabs that divide N
])
def test_exact_matches_numpy(n, k, slab):
    s = _scores(8, n, seed=n)
    vals, ids = _run(s, k, method="exact", slab=slab)
    want = np.sort(s, axis=1)[:, :k]
    np.testing.assert_array_equal(vals, want)
    # ids address the returned values, each column at most once
    np.testing.assert_array_equal(np.take_along_axis(s, ids, 1), vals)
    assert all(len(set(r)) == k for r in ids)


@pytest.mark.parametrize("method", ["exact", "group"])
def test_inf_masked_columns_come_last(method):
    s = _scores(4, 2048, seed=1, inf_frac=0.5)
    k = 16
    vals, ids = _run(s, k, method=method, slab=512)
    finite = np.isfinite(np.take_along_axis(s, ids, 1))
    assert finite.all()  # half the columns are live: k live ones exist
    assert (np.diff(vals, axis=1) >= 0).all()


def test_all_masked_row_returns_inf():
    s = _scores(3, 512, seed=2)
    s[1] = np.inf
    vals, _ = _run(s, 8, method="exact", slab=128)
    assert np.isinf(vals[1]).all() and np.isfinite(vals[[0, 2]]).all()


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_group_recall(dtype):
    s = _scores(32, 1 << 15, seed=3)
    s = np.asarray(jnp.asarray(s, dtype).astype(jnp.float32))
    k = 16
    vals, _ = _run(s.astype(np.float32), k, method="group", slab=1 << 13,
                   group=16, loss=1.0)
    kth = np.sort(s, axis=1)[:, k - 1:k]
    # value recall: selected scores at most the exact k-th score
    assert np.mean(vals <= kth) >= 0.97


@pytest.mark.parametrize("n,k,loss", [
    (256, 32, 1.0),      # 16 bins < k
    (4096, 32, 0.002),   # expected loss over the bound: exact
])
def test_group_falls_back_to_exact(n, k, loss):
    s = _scores(4, n, seed=4)
    vals, _ = _run(s, k, method="group", group=16, loss=loss)
    np.testing.assert_array_equal(vals, np.sort(s, axis=1)[:, :k])


@pytest.mark.parametrize("n,k,want", [
    (1_003_520, 97, 16),   # the bulk build's kNN table
    (1_003_520, 128, 16),  # the flat engine's widest rerank
    (65536, 8, 16),        # the seed scan at 1M
    (20480, 8, 8),
    (4096, 32, 1),         # a small flat index selects exactly
])
def test_group_for(n, k, want):
    from ocaml_hnsw_tpu.ops.select import group_for

    assert group_for(n, k) == want


def test_rejects_unknown_method_and_k_over_n():
    s = _scores(2, 64)
    with pytest.raises(ValueError):
        _run(s, 4, method="nope")
    with pytest.raises(ValueError):
        _run(s, 65, method="exact")
