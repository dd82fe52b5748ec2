"""Tracing / profiling / observability (SURVEY.md §5.1, §5.5).

The reference has nothing beyond wall-clock timing in its bench harness;
this package provides:

- `trace(logdir)` / `annotate(name)`: jax.profiler capture (Perfetto/XProf
  viewable) around build and search sections,
- `sync(x)`: wait until every array in `x` is computed
  (`jax.block_until_ready`; JAX dispatch returns before the device
  finishes),
- `search_stats(...)`: per-batch structured counters — beam loop iterations
  (hops), node expansions, distance evaluations, gathered bytes — the numbers
  that explain a recall/QPS point (SURVEY.md §5.5).
"""

from __future__ import annotations

import contextlib
import time

import jax
import jax.numpy as jnp


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a jax.profiler trace of the enclosed block into `logdir`."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named region inside a trace (context manager)."""
    return jax.profiler.TraceAnnotation(name)


def sync(x) -> None:
    """Block until every array in the pytree `x` is computed."""
    jax.block_until_ready(x)


class Timer:
    """Wall-clock timer with a real sync at exit."""

    def __init__(self, name: str = ""):
        self.name = name
        self.seconds = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        return False


def search_stats(graph, queries, k: int, ef: int, metric: str,
                 expand: int = 4) -> dict:
    """Run one batched search and return its cost counters.

    Counters are exact for the lockstep engine: every iteration gathers
    B·expand·deg rows and evaluates that many distances (static shapes)."""
    from ocaml_hnsw_tpu.models.search import (
        beam_search_layer,
        descend,
        preprocess_queries,
    )
    from ocaml_hnsw_tpu.ops.distance import query_norms

    q = preprocess_queries(jnp.asarray(queries), metric)
    qn = query_norms(q, metric)
    cur, cur_d = descend(graph, q, qn, metric, stop_level=0)
    ids, d, iters = beam_search_layer(
        graph.vectors, graph.scales, graph.norms, graph.adj0, q, qn,
        cur[:, None], cur_d[:, None], max(ef, k), metric,
        expand=expand, visited_bits=0,
    )
    b = q.shape[0]
    deg = graph.adj0.shape[1]
    iters = int(iters)
    dists = b * iters * expand * deg
    row_bytes = graph.vectors.shape[1] * graph.vectors.dtype.itemsize
    return {
        "batch": b,
        "ef": max(ef, k),
        "expand": expand,
        "beam_iterations": iters,
        "expansions_per_query": iters * expand,
        "distance_evals": dists,
        "distance_evals_per_query": dists // b,
        "gathered_bytes": dists * row_bytes,
        "found_mean_dist": float(jnp.mean(jnp.where(jnp.isinf(d), 0.0, d))),
    }
