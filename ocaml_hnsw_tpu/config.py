"""Frozen configuration for an HNSW index.

The reference exposes plain labelled arguments (SURVEY.md §5.6); the canonical
defaults below follow the de-facto standard hnswlib surface pinned in SURVEY.md
(M=16, ef_construction=200, random_seed=100, ef=10) and the paper's derived
constants (M_max0 = 2*M at layer 0, mL = 1/ln(M); arXiv:1603.09320 §4.1, Alg 1).
"""

from __future__ import annotations

import dataclasses
import math

#: built-in metrics; user metrics join via ops.metrics.register_metric (the
#: reference's DISTANCE-functor extension point)
METRICS = ("l2", "ip", "cosine")
STORAGES = ("f32", "bf16", "int8")


@dataclasses.dataclass(frozen=True)
class HnswConfig:
    """All build/search-time hyperparameters of an HNSW index.

    Attributes:
      dim: vector dimensionality.
      metric: one of "l2" (squared Euclidean), "ip" (1 - dot), "cosine"
        (1 - dot of normalized vectors; vectors are normalized at add time,
        matching hnswlib's convention).
      M: max out-degree per node on layers > 0 and target degree for new edges.
      M_max0: max out-degree on layer 0 (paper default 2*M).
      ef_construction: beam width used during insertion.
      ef: default beam width used at query time (search uses max(ef, k)).
      seed: RNG seed for level sampling (determinism hook; SURVEY.md §4).
      extend_candidates: Alg 4 "extendCandidates" flag.
      keep_pruned_connections: Alg 4 "keepPrunedConnections" flag (default off,
        matching hnswlib's heuristic).
      select: neighbor-selection algorithm — "heuristic" (Alg 4 diversity
        pruning, the default both here and in hnswlib/the reference) or
        "simple" (Alg 3: plain nearest-M; measurably worse recall on
        clustered data, provided for paper completeness and ablations).
      max_level_cap: static upper bound on the layer stack height; needed by the
        device engine for a static adjacency tensor stack.  None = derived from
        max_elements at index creation.
      storage: on-device dtype of the vector store — "f32" (exact), "bf16"
        (2× less gather bandwidth), or "int8" (4× less; symmetric per-vector
        quantization — the quantized-distance path of the deep10m config).
        The search is bound by its row gathers, so storage dtype is the main QPS
        lever; distances are always accumulated in f32.
    """

    dim: int
    metric: str = "l2"
    M: int = 16
    M_max0: int | None = None
    ef_construction: int = 200
    ef: int = 10
    seed: int = 100
    extend_candidates: bool = False
    keep_pruned_connections: bool = False
    select: str = "heuristic"
    max_level_cap: int | None = None
    storage: str = "f32"

    def __post_init__(self):
        from ocaml_hnsw_tpu.ops.metrics import is_metric, registered_metrics

        if not is_metric(self.metric):
            raise ValueError(
                f"metric must be one of {registered_metrics()} (see "
                f"ops.metrics.register_metric), got {self.metric!r}"
            )
        if self.storage not in STORAGES:
            raise ValueError(
                f"storage must be one of {STORAGES}, got {self.storage!r}"
            )
        if self.select not in ("heuristic", "simple"):
            raise ValueError(
                f"select must be 'heuristic' or 'simple', got {self.select!r}"
            )
        if self.M < 2:
            raise ValueError("M must be >= 2")
        if self.M_max0 is None:
            object.__setattr__(self, "M_max0", 2 * self.M)

    @property
    def mL(self) -> float:
        """Level-sampling multiplier mL = 1/ln(M) (Alg 1)."""
        return 1.0 / math.log(self.M)

    def derived_max_level(self, max_elements: int) -> int:
        """Static cap on layer index: P(level > L) = M^-L; pick L with expected
        count < 1 node above it, plus slack."""
        if self.max_level_cap is not None:
            return self.max_level_cap
        if max_elements <= 1:
            return 1
        return max(1, int(math.ceil(math.log(max_elements) / math.log(self.M))) + 1)
