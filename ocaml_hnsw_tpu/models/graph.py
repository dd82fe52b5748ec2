"""Device-resident index state: the reference's L1 "layered graph" (SURVEY.md
§1) re-designed as fixed-degree dense tensors in device memory.

The OCaml reference stores per-node neighbor *sets* behind pointers; batched
tensor programs cannot chase pointers, so layer 0 is one int32[N_cap, degree]
matrix with
-1 sentinels in empty slots (SURVEY.md §7 "Data layout").

Upper layers hold only ~N/M^ℓ nodes (paper §4.1), so they live in a single
**compact arena** `adj_up[T_cap, M]` instead of dense [l_max, N_cap, M]
tensors: a node at level L owns L consecutive arena rows starting at
`up_base[id]`, and its layer-ℓ adjacency is row `up_base[id] + (ℓ-1)`.
Expected total arena rows are N·Σ_{ℓ≥1} M^-ℓ = N/(M-1) — at 10M×M=16 that is
~170 MB (3x-margin capacity) where the dense layout needed ~4.5 GB of -1s
(SURVEY.md §7 "store a compact id-remap").  The last arena row is a reserved
scatter sink (all -1, never allocated), mirroring adj0's pad row.

Everything here is a plain NamedTuple → a JAX pytree that flows through jit,
shard_map, and checkpointing unchanged.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ocaml_hnsw_tpu.config import HnswConfig
from ocaml_hnsw_tpu.utils import round_up, pad_to


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class GraphTensors:
    """The whole index as arrays.  Shapes use N_cap = padded capacity.

    vectors:   [N_cap, D] in the configured storage dtype — f32 (default),
               bf16, or int8 (symmetric per-vector quantization; the int8
               distance path is BASELINE config 4).  The dtype selects the
               distance path in ops/distance.py.  cosine rows pre-normalized
               (before quantization); padding rows zero.
    scales:    f32[N_cap]    per-vector dequant scale (ones for f32/bf16)
    norms:     f32[N_cap]    ||x̂||² of the *dequantized* vector (zeros for
               ip/cosine) so l2 matmul-form paths stay consistent
    adj0:      i32[N_cap, M_max0]  layer-0 adjacency, -1 padded
    adj_up:    i32[T_cap, M_max]   upper-layer arena; node v's layer-ℓ row is
               adj_up[up_base[v] + (ℓ-1)] for 1 <= ℓ <= levels[v]; -1 padded.
               Row T_cap-1 is the reserved scatter sink (always all -1).
    up_base:   i32[N_cap]    first arena row per node (-1 for level-0 nodes)
    up_n:      i32[]         arena rows allocated so far
    levels:    i32[N_cap]    node level; -1 marks an unoccupied slot
    entry:     i32[]         entry point id (-1 while empty)
    max_level: i32[]         current top layer
    n:         i32[]         number of occupied slots
    deleted:   bool[N_cap]   tombstones (hnswlib mark_deleted semantics)
    l_max_static: int        static layer-stack height (NOT a tensor — part of
               the pytree's static treedef, like the array shapes)
    """

    vectors: jnp.ndarray
    scales: jnp.ndarray
    norms: jnp.ndarray
    adj0: jnp.ndarray
    adj_up: jnp.ndarray
    up_base: jnp.ndarray
    up_n: jnp.ndarray
    levels: jnp.ndarray
    entry: jnp.ndarray
    max_level: jnp.ndarray
    n: jnp.ndarray
    deleted: jnp.ndarray
    l_max_static: int = dataclasses.field(metadata=dict(static=True))

    # names of the array (pytree-leaf) fields, in declaration order — used by
    # sharding-spec construction and (de)serialization
    _fields = ("vectors", "scales", "norms", "adj0", "adj_up", "up_base",
               "up_n", "levels", "entry", "max_level", "n", "deleted")

    def _replace(self, **kw) -> "GraphTensors":
        return dataclasses.replace(self, **kw)

    @property
    def n_cap(self) -> int:
        return self.vectors.shape[0]

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]

    @property
    def l_max(self) -> int:
        return self.l_max_static

    @property
    def t_cap(self) -> int:
        return self.adj_up.shape[0]


def capacity(max_elements: int) -> int:
    """Pad capacity to a multiple of 128 (bitset words + lane alignment)."""
    return round_up(max(max_elements, 128), 128)


def arena_capacity(max_elements: int, m: int) -> int:
    """Upper-arena row capacity: expected total rows are
    N·Σ_{ℓ≥1} P(level ≥ ℓ) = N·Σ M^-ℓ = N/(M-1); 3x margin makes binomial
    overflow astronomically unlikely (BuildState also pre-checks each add()
    batch exactly against the sampled levels).  +1 reserves the sink row."""
    want = 3 * capacity(max_elements) // max(m - 1, 1) + 1
    return round_up(max(want, 256), 128)


class UpperView(NamedTuple):
    """Adjacency view of one upper layer over the compact arena: node v's
    neighbors at `level` are table[up_base[v] + level - 1] when
    levels[v] >= level, else no row (all -1).  Passed anywhere a dense
    [N_cap, deg] layer table used to go; `adj_take` dispatches on type."""

    table: jnp.ndarray  # i32[T_cap, M]
    up_base: jnp.ndarray  # i32[N_cap]
    levels: jnp.ndarray  # i32[N_cap]
    level: int  # static, >= 1

    @property
    def deg(self) -> int:
        return self.table.shape[1]

    def rows_of(self, safe_ids):
        """Arena row per node id (ids must be >= 0); sink row when the node
        has no row at this layer."""
        base = self.up_base[safe_ids]
        ok = (self.levels[safe_ids] >= self.level) & (base >= 0)
        return jnp.where(ok, base + (self.level - 1), self.table.shape[0] - 1)


def adj_take(adj, safe_ids):
    """Gather adjacency rows for node ids (>= 0) from either a dense layer-0
    table or an UpperView."""
    if isinstance(adj, UpperView):
        return adj.table[adj.rows_of(safe_ids)]
    return adj[safe_ids]


def upper_view(graph: GraphTensors, level: int) -> UpperView:
    return UpperView(table=graph.adj_up, up_base=graph.up_base,
                     levels=graph.levels, level=level)


def dense_upper(graph: GraphTensors, level: int) -> np.ndarray:
    """Materialize one upper layer as a host [n, M] matrix (tests/debug)."""
    n = int(graph.n)
    ub = np.asarray(graph.up_base[:n])
    lv = np.asarray(graph.levels[:n])
    table = np.asarray(graph.adj_up)
    out = np.full((n, table.shape[1]), -1, np.int32)
    ok = (lv >= level) & (ub >= 0)
    out[ok] = table[ub[ok] + level - 1]
    return out


def empty_graph(config: HnswConfig, max_elements: int) -> GraphTensors:
    from ocaml_hnsw_tpu.ops.quantize import storage_dtype

    n_cap = capacity(max_elements)
    l_max = config.derived_max_level(max_elements)
    t_cap = arena_capacity(max_elements, config.M)
    return GraphTensors(
        vectors=jnp.zeros((n_cap, config.dim), storage_dtype(config.storage)),
        scales=jnp.ones((n_cap,), jnp.float32),
        norms=jnp.zeros((n_cap,), jnp.float32),
        adj0=jnp.full((n_cap, config.M_max0), -1, jnp.int32),
        adj_up=jnp.full((t_cap, config.M), -1, jnp.int32),
        up_base=jnp.full((n_cap,), -1, jnp.int32),
        up_n=jnp.int32(0),
        levels=jnp.full((n_cap,), -1, jnp.int32),
        entry=jnp.int32(-1),
        max_level=jnp.int32(-1),
        n=jnp.int32(0),
        deleted=jnp.zeros((n_cap,), jnp.bool_),
        l_max_static=l_max,
    )


def from_oracle(oracle, max_elements: int | None = None) -> GraphTensors:
    """Convert an OracleHNSW (SURVEY.md §4 parity-oracle) into device tensors."""
    cfg: HnswConfig = oracle.config
    n = oracle.element_count
    n_cap = capacity(max_elements or n)
    l_max = cfg.derived_max_level(max_elements or max(n, 2))
    d = cfg.dim

    from ocaml_hnsw_tpu.ops.quantize import quantize_rows, storage_dtype

    vectors_f = np.zeros((n_cap, d), np.float32)
    if n:
        vectors_f[:n] = np.stack(oracle.vectors)
    qrows, qscales, qnorms = quantize_rows(jnp.asarray(vectors_f), cfg.storage)
    vectors = np.asarray(qrows)
    scales = np.asarray(qscales)
    from ocaml_hnsw_tpu.ops.metrics import get_metric

    if get_metric(cfg.metric).needs_norms:
        norms = np.asarray(qnorms)
    else:
        norms = np.zeros((n_cap,), np.float32)

    adj0 = np.full((n_cap, cfg.M_max0), -1, np.int32)
    t_cap = arena_capacity(max_elements or max(n, 2), cfg.M)
    adj_up = np.full((t_cap, cfg.M), -1, np.int32)
    up_base = np.full((n_cap,), -1, np.int32)
    levels = np.full((n_cap,), -1, np.int32)
    up_n = 0
    for i in range(n):
        lvl = min(oracle.levels[i], l_max)
        levels[i] = lvl
        if lvl >= 1:  # allocate the arena block in insertion order
            up_base[i] = up_n
            up_n += lvl
        for lc, nbrs in enumerate(oracle.adj[i]):
            if lc == 0:
                adj0[i] = pad_to(np.asarray(nbrs, np.int32), cfg.M_max0, -1)
            elif lc <= l_max:
                adj_up[up_base[i] + lc - 1] = pad_to(
                    np.asarray(nbrs, np.int32), cfg.M, -1)
    if up_n >= t_cap:
        raise RuntimeError(f"arena overflow converting oracle: {up_n} rows "
                           f"> capacity {t_cap}")

    deleted = np.zeros((n_cap,), np.bool_)
    for e in oracle.deleted:
        deleted[e] = True

    return GraphTensors(
        vectors=jnp.asarray(vectors),
        scales=jnp.asarray(scales),
        norms=jnp.asarray(norms),
        adj0=jnp.asarray(adj0),
        adj_up=jnp.asarray(adj_up),
        up_base=jnp.asarray(up_base),
        up_n=jnp.int32(up_n),
        levels=jnp.asarray(levels),
        entry=jnp.int32(oracle.entry),
        max_level=jnp.int32(min(max(oracle.max_level, 0), l_max) if n else -1),
        n=jnp.int32(n),
        deleted=jnp.asarray(deleted),
        l_max_static=l_max,
    )
