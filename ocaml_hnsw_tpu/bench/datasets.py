"""Synthetic dataset generators for the benchmark configs (README.md
"Benchmark configs").

The benchmark downloads nothing (SURVEY.md §6), so the configs use seeded
synthetic stand-ins of matching shape/metric.  Clustered
generation makes recall non-trivial (uniform random data is too easy for HNSW).
"""

from __future__ import annotations

import numpy as np


def random_uniform(n: int, dim: int, seed: int = 0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    return rng.rand(n, dim).astype(np.float32)


def clustered(n: int, dim: int, n_clusters: int = 100, seed: int = 0,
              spread: float = 0.15) -> np.ndarray:
    """Gaussian-mixture data: the shape real embedding datasets (SIFT/GloVe/CLIP)
    take, where the select-neighbors heuristic actually matters (SURVEY.md §3.4)."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(n_clusters, dim).astype(np.float32)
    assign = rng.randint(0, n_clusters, size=n)
    return (centers[assign] + spread * rng.randn(n, dim)).astype(np.float32)


def queries_like(data: np.ndarray, n_queries: int, seed: int = 1,
                 jitter: float = 0.1) -> np.ndarray:
    """Queries drawn near dataset points (ann-benchmarks train/test style)."""
    rng = np.random.RandomState(seed)
    picks = rng.randint(0, data.shape[0], size=n_queries)
    q = data[picks] + jitter * rng.randn(n_queries, data.shape[1]).astype(np.float32)
    return q.astype(np.float32)


def sift_shaped(n: int = 1_000_000, n_queries: int = 10_000, seed: int = 7):
    """Config 2 stand-in: SIFT1M-shaped — 128-d, clustered, L2."""
    data = clustered(n, 128, n_clusters=max(64, n // 2500), seed=seed)
    return data, queries_like(data, n_queries, seed=seed + 1)


def glove_shaped(n: int = 1_183_514, n_queries: int = 10_000, seed: int = 11):
    """Config 3 stand-in: GloVe-1.2M-shaped — 100-d, angular/cosine."""
    data = clustered(n, 100, n_clusters=max(64, n // 2500), seed=seed)
    return data, queries_like(data, n_queries, seed=seed + 1)


def deep_shaped(n: int = 10_000_000, n_queries: int = 10_000, seed: int = 13):
    """Config 4 stand-in: Deep10M-shaped — 96-d, L2, for int8 quantization."""
    data = clustered(n, 96, n_clusters=max(64, n // 2500), seed=seed)
    return data, queries_like(data, n_queries, seed=seed + 1)


def laion_shaped(n: int = 5_000_000, n_queries: int = 10_000, seed: int = 17):
    """Config 5 stand-in: LAION-5M CLIP-shaped — 768-d, cosine, streaming."""
    data = clustered(n, 768, n_clusters=max(64, n // 2500), seed=seed)
    return data, queries_like(data, n_queries, seed=seed + 1)


def clustered_device(n: int, dim: int, n_clusters: int = 100, seed: int = 0,
                     spread: float = 0.15, dtype=None):
    """Device-side clustered data + queries, generated on the accelerator
    so a 10M-row bench does not spend its set-up on host generation and
    transfer.  Returns (data [n, dim] on device, queries fn).

    dtype: storage dtype of the returned dataset (default f32).  Pass
    jnp.bfloat16 for memory-bound configs (5M x 768-d f32 alone is 15.4 GB);
    generation then runs in bf16 slabs via a fori_loop so the peak
    transient stays one slab, not a full-size f32 copy.  Sets larger than a
    quarter of the device memory limit are generated in slabs too."""
    import jax
    import jax.numpy as jnp

    dtype = dtype or jnp.float32
    kc, ka, kn = jax.random.split(jax.random.PRNGKey(seed), 3)
    centers = jax.random.normal(kc, (n_clusters, dim), jnp.float32)

    from ocaml_hnsw_tpu.utils.memory import budget_bytes

    if dtype == jnp.float32 and n * dim * 4 <= budget_bytes(0.25):
        assign = jax.random.randint(ka, (n,), 0, n_clusters)
        data = centers[assign] + spread * jax.random.normal(
            kn, (n, dim), jnp.float32)
    else:
        slab = 1 << 19
        n_pad = ((n + slab - 1) // slab) * slab

        @jax.jit
        def gen(centers):
            buf = jnp.zeros((n_pad, dim), dtype)

            def body(i, buf):
                start = i * slab
                ks = jax.random.fold_in(ka, i)
                kv = jax.random.fold_in(kn, i)
                a = jax.random.randint(ks, (slab,), 0, n_clusters)
                rows = centers[a] + spread * jax.random.normal(
                    kv, (slab, dim), jnp.float32)
                return jax.lax.dynamic_update_slice_in_dim(
                    buf, rows.astype(dtype), start, 0)

            return jax.lax.fori_loop(0, n_pad // slab, body, buf)

        data = gen(centers)[:n]

    def make_queries(n_queries: int, qseed: int = 1, jitter: float = 0.1):
        kp, kj = jax.random.split(jax.random.PRNGKey(qseed), 2)
        picks = jax.random.randint(kp, (n_queries,), 0, n)
        return (data[picks].astype(jnp.float32)
                + jitter * jax.random.normal(kj, (n_queries, dim),
                                             jnp.float32))

    return data, make_queries
