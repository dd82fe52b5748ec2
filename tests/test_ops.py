"""Unit tests for the device op layer: distances, visited bitset, dedup masks."""

import numpy as np
import jax.numpy as jnp

from ocaml_hnsw_tpu.ops import (
    dists_to_ids,
    query_norms,
    pairwise_dists,
    bitset_new,
    bitset_test,
    bitset_set,
    first_occurrence_mask,
)


class TestDistances:
    def test_l2_matches_numpy(self):
        rng = np.random.RandomState(0)
        x = rng.randn(64, 16).astype(np.float32)
        q = rng.randn(4, 16).astype(np.float32)
        ids = rng.randint(0, 64, size=(4, 7)).astype(np.int32)
        norms = np.sum(x * x, axis=1)
        ones = jnp.ones(64)
        d = dists_to_ids(jnp.asarray(x), ones, jnp.asarray(norms),
                         jnp.asarray(q), query_norms(jnp.asarray(q), "l2"),
                         jnp.asarray(ids), "l2")
        expect = np.sum((q[:, None, :] - x[ids]) ** 2, axis=2)
        np.testing.assert_allclose(np.asarray(d), expect, rtol=1e-4, atol=1e-4)

    def test_ip_matches_numpy(self):
        rng = np.random.RandomState(1)
        x = rng.randn(32, 8).astype(np.float32)
        q = rng.randn(3, 8).astype(np.float32)
        ids = rng.randint(0, 32, size=(3, 5)).astype(np.int32)
        z = jnp.zeros(32)
        d = dists_to_ids(jnp.asarray(x), jnp.ones(32), z, jnp.asarray(q),
                         query_norms(jnp.asarray(q), "ip"), jnp.asarray(ids),
                         "ip")
        expect = 1.0 - np.einsum("bkd,bd->bk", x[ids], q)
        np.testing.assert_allclose(np.asarray(d), expect, rtol=1e-4, atol=1e-4)

    def test_sentinel_gets_inf(self):
        x = jnp.ones((8, 4))
        ids = jnp.array([[0, -1, 3]], dtype=jnp.int32)
        d = dists_to_ids(x, jnp.ones(8), jnp.sum(x * x, 1), jnp.zeros((1, 4)),
                         jnp.zeros((1,)), ids, "l2")
        assert np.isinf(np.asarray(d)[0, 1])
        assert np.isfinite(np.asarray(d)[0, [0, 2]]).all()

    def test_pairwise_l2(self):
        rng = np.random.RandomState(2)
        x = rng.randn(2, 6, 4).astype(np.float32)
        n = np.sum(x * x, axis=2)
        d = pairwise_dists(jnp.asarray(x), jnp.asarray(n), "l2")
        expect = np.sum((x[:, :, None, :] - x[:, None, :, :]) ** 2, axis=3)
        # matmul-form ||a||²-2ab+||b||² cancels catastrophically in f32; the
        # engine only compares distances, so ~1e-3 relative error is fine
        np.testing.assert_allclose(np.asarray(d), expect, rtol=5e-3, atol=1e-2)


def _test(bits, ids):
    return bitset_test(bits, jnp.maximum(ids, 0), ids >= 0)


class TestBitset:
    def test_set_then_test(self):
        bits = bitset_new(2, 128)
        ids = jnp.array([[0, 31, 32, 127], [1, 1, 64, -1]], dtype=jnp.int32)
        mask = jnp.array([[True, True, True, True], [True, False, True, False]])
        bits = bitset_set(bits, ids, mask)
        got = np.asarray(_test(bits, ids))
        assert got[0].tolist() == [True, True, True, True]
        assert got[1].tolist() == [True, True, True, False]  # dup id reads set bit
        # untouched ids remain unset
        other = jnp.array([[5, 99], [0, 2]], dtype=jnp.int32)
        assert not np.asarray(_test(bits, other)).any()

    def test_rows_independent(self):
        bits = bitset_set(bitset_new(2, 64),
                          jnp.array([[7], [9]], dtype=jnp.int32),
                          jnp.ones((2, 1), dtype=bool))
        t = np.asarray(_test(bits, jnp.array([[9], [7]], dtype=jnp.int32)))
        assert not t.any()

    def test_same_word_different_bits(self):
        # ids 3 and 5 share word 0; scatter-add must behave as OR
        bits = bitset_set(bitset_new(1, 32),
                          jnp.array([[3, 5]], dtype=jnp.int32),
                          jnp.ones((1, 2), dtype=bool))
        t = np.asarray(_test(bits, jnp.array([[3, 5, 4]], dtype=jnp.int32)))
        assert t[0].tolist() == [True, True, False]

    def test_sentinel_never_set_or_read(self):
        bits = bitset_set(bitset_new(1, 32), jnp.array([[-1]], dtype=jnp.int32),
                          jnp.array([[False]]))
        assert np.asarray(bits).sum() == 0
        assert not np.asarray(_test(bits, jnp.array([[-1]], dtype=jnp.int32))).any()

    def test_hash_ids_range_and_determinism(self):
        from ocaml_hnsw_tpu.ops.bitset import hash_ids
        ids = jnp.asarray(np.random.RandomState(0).randint(0, 2**30, (4, 64)))
        h = np.asarray(hash_ids(ids, 18))
        assert (h >= 0).all() and (h < 2**18).all()
        np.testing.assert_array_equal(h, np.asarray(hash_ids(ids, 18)))
        # spread: on 256 random ids expect mostly-distinct hashes
        assert len(np.unique(h)) > 250


class TestFirstOccurrence:
    def test_dedup(self):
        ids = jnp.array([[4, 4, 7, 4, 7, 9]], dtype=jnp.int32)
        m = np.asarray(first_occurrence_mask(ids))
        assert m[0].tolist() == [True, False, True, False, False, True]

    def test_all_unique(self):
        ids = jnp.array([[1, 2, 3]], dtype=jnp.int32)
        assert np.asarray(first_occurrence_mask(ids)).all()


class TestQuantize:
    def test_int8_roundtrip_error_bounded(self):
        from ocaml_hnsw_tpu.ops.quantize import quantize_rows, dequantize_gathered
        rng = np.random.RandomState(0)
        x = (rng.randn(16, 32) * 5).astype(np.float32)
        q, s, n = quantize_rows(jnp.asarray(x), "int8")
        assert np.asarray(q).dtype == np.int8
        xd = np.asarray(q).astype(np.float32) * np.asarray(s)[:, None]
        err = np.abs(xd - x)
        bound = np.abs(x).max(axis=1, keepdims=True) / 127.0
        assert (err <= bound / 2 + 1e-6).all()
        np.testing.assert_allclose(np.asarray(n), (xd * xd).sum(1), rtol=1e-5)

    def test_int8_dists(self):
        from ocaml_hnsw_tpu.ops.quantize import quantize_rows
        rng = np.random.RandomState(1)
        x = rng.randn(64, 16).astype(np.float32)
        qv = rng.randn(4, 16).astype(np.float32)
        ids = rng.randint(0, 64, (4, 7)).astype(np.int32)
        rows, s, n = quantize_rows(jnp.asarray(x), "int8")
        d = dists_to_ids(rows, s, n, jnp.asarray(qv),
                         query_norms(jnp.asarray(qv), "l2"),
                         jnp.asarray(ids), "l2")
        expect = np.sum((qv[:, None, :] - x[ids]) ** 2, axis=2)
        np.testing.assert_allclose(np.asarray(d), expect, rtol=0.1, atol=0.1)

    def test_bf16_dists(self):
        from ocaml_hnsw_tpu.ops.quantize import quantize_rows
        rng = np.random.RandomState(2)
        x = rng.randn(64, 16).astype(np.float32)
        qv = rng.randn(4, 16).astype(np.float32)
        ids = rng.randint(0, 64, (4, 7)).astype(np.int32)
        rows, s, n = quantize_rows(jnp.asarray(x), "bf16")
        d = dists_to_ids(rows, s, n, jnp.asarray(qv),
                         query_norms(jnp.asarray(qv), "l2"),
                         jnp.asarray(ids), "l2")
        expect = np.sum((qv[:, None, :] - x[ids]) ** 2, axis=2)
        np.testing.assert_allclose(np.asarray(d), expect, rtol=0.03, atol=0.05)
