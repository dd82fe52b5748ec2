"""Metric registry — the tensor-program equivalent of the reference's DISTANCE/VALUE
functor parameter (SURVEY.md §2 "Value/Distance functor interface", §1 L0).

The OCaml reference is a functor: a user instantiates the library over their
own distance module.  Here the same extension point is a process-level
registry: ``register_metric`` adds a named metric that every layer consumes —
config validation, the oracle, the device HNSW engine, and the flat engine —
without editing any library file.  The built-in "l2" / "ip" / "cosine"
metrics are themselves registry entries, so a user metric is a first-class
citizen, not a side door.

A metric supplies:

  pair_dist(rows, q) -> d          REQUIRED.  rows f32[..., K, D], q
      f32[..., D] (broadcast against rows' leading dims) -> f32[..., K].
      Write it array-namespace-agnostic (operators + methods, e.g.
      ``((rows - q[..., None, :]) ** 2).sum(-1)``) so the SAME function runs
      as traced jnp inside jit on the device and on plain NumPy inside the
      oracle.
      If that's not possible, pass a separate ``np_pair_dist``.

  matmul_score(dot, x_norms) -> s  OPTIONAL.  Rank-equivalent scores from one
      matrix contraction: dot f32[B, N] = q·xᵀ, x_norms f32[N] = ‖x‖².
      Enables the flat engine's bf16/int8 scan and the HNSW seed-scan entry.
      Without it, the flat engine falls back to a chunked exact scan and the
      HNSW engine enters layer 0 by greedy descent — correct, slower.

  normalize_add / normalize_query  OPTIONAL.  Pre-normalize vectors at add /
      query time (how "cosine" reduces to "ip" on device).

  needs_norms                      OPTIONAL.  Store per-row ‖x‖² (required
      when matmul_score consumes x_norms, as l2's does).

jit note: the engine passes metrics by *name* (a hashable static argument);
the registry lookup happens at trace time, so a metric must be registered
before the first query that uses it in a given process.
"""

from __future__ import annotations

import dataclasses
from typing import Callable


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    pair_dist: Callable
    matmul_score: Callable | None = None
    np_pair_dist: Callable | None = None
    normalize_add: bool = False
    normalize_query: bool = False
    needs_norms: bool = False

    def pair_dist_np(self, rows, q):
        """Oracle-side (NumPy) pair distance."""
        fn = self.np_pair_dist or self.pair_dist
        return fn(rows, q)


_REGISTRY: dict[str, Metric] = {}


def register_metric(
    name: str,
    pair_dist: Callable,
    *,
    matmul_score: Callable | None = None,
    np_pair_dist: Callable | None = None,
    normalize_add: bool = False,
    normalize_query: bool = False,
    needs_norms: bool = False,
    overwrite: bool = False,
) -> Metric:
    """Register a user metric under `name` (see module docstring for the
    contract).  Returns the Metric record.  Built-in names cannot be
    overwritten unless overwrite=True (ablation/testing hook)."""
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"metric {name!r} already registered")
    m = Metric(
        name=name,
        pair_dist=pair_dist,
        matmul_score=matmul_score,
        np_pair_dist=np_pair_dist,
        normalize_add=normalize_add,
        normalize_query=normalize_query,
        needs_norms=needs_norms,
    )
    _REGISTRY[name] = m
    return m


def unregister_metric(name: str) -> None:
    """Remove a user-registered metric (built-ins are permanent).  Indexes
    already holding the name keep working until their process's jit caches
    are dropped — unregister is for test hygiene, not hot-swapping."""
    if name in _BUILTINS:
        raise ValueError(f"built-in metric {name!r} cannot be unregistered")
    _REGISTRY.pop(name, None)


def get_metric(name: str) -> Metric:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown metric {name!r}; registered: {sorted(_REGISTRY)} "
            "(register_metric() adds new ones)"
        ) from None


def is_metric(name: str) -> bool:
    return name in _REGISTRY


def registered_metrics() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


# --------------------------------------------------------------- built-ins
# Exact elementwise forms (namespace-agnostic: run on jnp tracers AND NumPy
# arrays).
# l2 is *squared* Euclidean; ip/cosine are 1 - dot with cosine rows/queries
# pre-normalized — the hnswlib conventions pinned in SURVEY.md §1 L0.
# Precision note (models/search.py / ops/distance.py): the pair forms stay
# elementwise-f32 because bf16 (or TF32) matmul error scrambles neighbor
# order;
# the matmul_score forms are only used where a HIGHEST/rescored contraction
# is in place (flat scan + rerank, seed scan + exact re-score).


def _l2_pair(rows, q):
    diff = rows - q[..., None, :]
    return (diff * diff).sum(-1)


def _dot_pair(rows, q):
    return 1.0 - (rows * q[..., None, :]).sum(-1)


register_metric(
    "l2",
    _l2_pair,
    matmul_score=lambda dot, x_norms: x_norms - 2.0 * dot,  # +‖q‖² rank-inv.
    needs_norms=True,
)
register_metric("ip", _dot_pair, matmul_score=lambda dot, x_norms: -dot)
register_metric(
    "cosine",
    _dot_pair,
    matmul_score=lambda dot, x_norms: -dot,
    normalize_add=True,
    normalize_query=True,
)

_BUILTINS = frozenset(_REGISTRY)
