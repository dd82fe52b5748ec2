"""Public API — the reference's L3 layer (SURVEY.md §1) with the canonical
hnswlib-shaped surface pinned in SURVEY.md (init_index / add_items / knn_query /
set_ef / save_index / load_index / mark_deleted / resize_index), plus `BFIndex`,
the exact brute-force companion index.

The OCaml reference exposes a functor over DISTANCE/VALUE modules; the
equivalent pluggability here is the metric registry (built-ins "l2", "ip",
"cosine" plus any ops.metrics.register_metric entry) chosen by `space`.

Batch shapes are padded to power-of-two buckets so jit compiles a bounded set
of programs per (batch, k, ef).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ocaml_hnsw_tpu.config import HnswConfig
from ocaml_hnsw_tpu.models.build import BuildState
from ocaml_hnsw_tpu.models.search import knn_search
from ocaml_hnsw_tpu.models.graph import GraphTensors
from ocaml_hnsw_tpu import io as index_io


def _check_space(space: str) -> None:
    from ocaml_hnsw_tpu.ops.metrics import is_metric, registered_metrics

    if not is_metric(space):
        raise ValueError(
            f"space must be a registered metric {registered_metrics()} "
            f"(ops.metrics.register_metric adds new ones), got {space!r}"
        )


def _pad_batch(n: int) -> int:
    """Power-of-two batch buckets (floor 8) to bound jit recompiles."""
    b = 8
    while b < n:
        b *= 2
    return b


class Index:
    """HNSW index on the accelerator with the canonical hnswlib-style
    surface."""

    #: graphs at or above this size use the matmul seed scan for layer-0
    #: entry (below it, greedy descent's 1-entry beam is cheap and
    #: parity-exact)
    SEED_THRESHOLD = 4096
    #: graphs at or above this size auto-use the packed inline-int8 engine
    #: (models/packed.py) when its payload fits PACKED_BUDGET_SHARE of the
    #: device memory (utils/memory.py); small graphs keep the classic
    #: engine's exact oracle-parity trajectories
    PACKED_THRESHOLD = 100_000
    PACKED_BUDGET_SHARE = 0.5

    def __init__(self, space: str, dim: int):
        _check_space(space)
        self.space = space
        self.dim = dim
        self._state: BuildState | None = None
        self._labels = np.zeros((0,), dtype=np.int64)
        self._label_to_id: dict[int, int] = {}
        self._seeds = None  # SeedIndex cache; invalidated on every mutation
        self._packed = None  # PackedGraph cache; invalidated on every mutation
        self.ef = 10

    # ------------------------------------------------------------- lifecycle
    def init_index(
        self,
        max_elements: int,
        M: int = 16,
        ef_construction: int = 200,
        random_seed: int = 100,
        round_size: int = 1024,
        keep_pruned_connections: bool = False,
        extend_candidates: bool = False,
        select: str = "heuristic",
        storage: str = "f32",
        **_ignored,  # num_threads etc. accepted for source compatibility
    ) -> None:
        cfg = HnswConfig(
            dim=self.dim,
            metric=self.space,
            M=M,
            ef_construction=ef_construction,
            seed=random_seed,
            keep_pruned_connections=keep_pruned_connections,
            extend_candidates=extend_candidates,
            select=select,
            storage=storage,
        )
        self._state = BuildState(cfg, max_elements, round_size=round_size)

    def _require_init(self) -> BuildState:
        if self._state is None:
            raise RuntimeError("call init_index (or load_index) first")
        return self._state

    @property
    def config(self) -> HnswConfig:
        return self._require_init().config

    @property
    def graph(self) -> GraphTensors:
        return self._require_init().graph

    # ------------------------------------------------------------- mutation
    def add_items(self, data, ids=None, **_ignored) -> None:
        st = self._require_init()
        data = np.atleast_2d(np.asarray(data, dtype=np.float32))
        if data.shape[1] != self.dim:
            raise ValueError(f"expected dim {self.dim}, got {data.shape[1]}")
        n_new = data.shape[0]
        n_cur = int(st.graph.n)
        if n_cur + n_new > st.max_elements:
            raise RuntimeError(
                f"index is full: {n_cur} + {n_new} > max_elements "
                f"{st.max_elements}; call resize_index first"
            )
        if ids is None:
            labels = np.arange(n_cur, n_cur + n_new, dtype=np.int64)
        else:
            labels = np.asarray(ids, dtype=np.int64).reshape(-1)
            if labels.shape[0] != n_new:
                raise ValueError("ids length must match data rows")
        clash = [int(l) for l in labels if int(l) in self._label_to_id]
        if clash:
            raise ValueError(f"duplicate labels not supported: {clash[:5]}")
        st.add(data)
        self._seeds = None  # upper-layer membership may have changed
        self._packed = None  # adjacency changed
        for off, lab in enumerate(labels):
            self._label_to_id[int(lab)] = n_cur + off
        self._labels = np.concatenate([self._labels, labels])

    def mark_deleted(self, label: int) -> None:
        st = self._require_init()
        iid = self._id_of(label)
        st.graph = st.graph._replace(deleted=st.graph.deleted.at[iid].set(True))

    def unmark_deleted(self, label: int) -> None:
        st = self._require_init()
        iid = self._id_of(label)
        st.graph = st.graph._replace(deleted=st.graph.deleted.at[iid].set(False))

    def resize_index(self, new_max_elements: int) -> None:
        """Grow capacity in place (graph tensors are re-padded)."""
        st = self._require_init()
        if new_max_elements < int(st.graph.n):
            raise ValueError("cannot shrink below current element count")
        old = st.graph
        new_state = BuildState(st.config, new_max_elements,
                               round_size=st.round_size)
        g = new_state.graph
        n_cap_old, n_cap_new = old.n_cap, g.n_cap
        if n_cap_new < n_cap_old:
            raise ValueError("resize would shrink padded capacity")
        grow = n_cap_new - n_cap_old

        def pad2(a, fill):
            widths = [(0, grow)] + [(0, 0)] * (a.ndim - 1)
            return jnp.pad(a, widths, constant_values=fill)

        # arena: pad rows at the end (the reserved sink row moves to the new
        # last row; the old sink row is provably all -1, so it simply becomes
        # an allocatable empty row)
        t_grow = g.t_cap - old.t_cap
        if t_grow < 0:
            raise ValueError("resize would shrink the upper arena")
        adj_up = jnp.pad(old.adj_up, ((0, t_grow), (0, 0)),
                         constant_values=-1)
        new_state.graph = GraphTensors(
            vectors=pad2(old.vectors, 0),
            scales=pad2(old.scales, 1.0),
            norms=pad2(old.norms, 0.0),
            adj0=pad2(old.adj0, -1),
            adj_up=adj_up,
            up_base=pad2(old.up_base, -1),
            up_n=old.up_n,
            levels=pad2(old.levels, -1),
            entry=old.entry,
            max_level=old.max_level,
            n=old.n,
            deleted=pad2(old.deleted, False),
            l_max_static=max(g.l_max, old.l_max),
        )
        new_state.rng = st.rng  # continue the level-sampling stream
        new_state.l_max = new_state.graph.l_max
        new_state.adopt_graph(new_state.graph)
        self._state = new_state
        self._seeds = None
        self._packed = None

    # --------------------------------------------------------------- queries
    def set_ef(self, ef: int) -> None:
        self.ef = int(ef)

    def _seed_index(self):
        """Lazy SeedIndex for the matmul entry scan on large graphs (None
        when too small or no upper-layer nodes exist)."""
        st = self._require_init()
        if int(st.graph.n) < self.SEED_THRESHOLD:
            return None
        if self._seeds is None:
            from ocaml_hnsw_tpu.models.search import build_seed_index

            self._seeds = build_seed_index(st.graph, self.space)
        return self._seeds

    def _packed_index(self):
        """Lazy PackedGraph for the inline-int8 engine; None when the graph
        is small (classic path keeps exact oracle-parity trajectories), the
        metric has no matmul form, or the payload would exceed the memory
        budget (e.g. 768-d at tens of millions of nodes — the classic
        engine handles those)."""
        st = self._require_init()
        if int(st.graph.n) < self.PACKED_THRESHOLD:
            return None
        from ocaml_hnsw_tpu.ops.metrics import get_metric

        if get_metric(self.space).matmul_score is None:
            return None
        from ocaml_hnsw_tpu.models.packed import pack_d_pad, pack_graph
        from ocaml_hnsw_tpu.utils.memory import budget_bytes

        deg = st.graph.adj0.shape[1]
        if (st.graph.n_cap * deg * pack_d_pad(self.dim)
                > budget_bytes(self.PACKED_BUDGET_SHARE)):
            return None
        if self._packed is None:
            self._packed = pack_graph(st.graph, self.space)
        return self._packed

    #: one-time warning flag: the packed default expand changed 4 -> 2 in
    #: round 4 (paired with a doubled default iteration cap); callers who
    #: pinned max_iters under the old guidance get a heads-up once
    _warned_expand_pairing = False

    def knn_query(self, data, k: int = 1, ef: int | None = None,
                  max_iters: int | None = None,
                  compact_k: int | str | None = "auto",
                  engine: str = "auto",
                  expand: int | None = None,
                  expand_schedule: tuple | None = None,
                  rerank_k: int | None = None,
                  interleave: int = 1,
                  **_ignored):
        """Returns (labels i64[Q, k], dists f32[Q, k]); -1 label on padding.

        engine="auto" serves large matmul-metric indexes from the packed
        inline-int8 engine (models/packed.py — seed-scan entry, chunked
        payload gathers, bf16 scoring, exact-f32 rerank) and everything else
        from the classic engine with seed-scan entry plus candidate
        compaction (compact_k="auto" = the bench harness's 3/4·expand·M_max0
        rule on seed-scan-sized graphs; small-index results keep exact
        oracle-parity trajectories).  engine="classic"/"packed" forces a
        path (packed raises if unavailable).  max_iters bounds the lockstep
        beam loop (throughput knob; None = run to convergence).

        expand / expand_schedule (packed engine): frontier width per
        iteration (default 2: every per-iteration width halves against 4
        while the iteration count about doubles)."""
        st = self._require_init()
        if int(st.graph.n) == 0:
            raise RuntimeError("index is empty")
        if engine not in ("auto", "classic", "packed"):
            raise ValueError(f"engine must be auto|classic|packed, got {engine!r}")
        data = np.atleast_2d(np.asarray(data, dtype=np.float32))
        q_n = data.shape[0]
        b = _pad_batch(q_n)
        padded = np.zeros((b, self.dim), np.float32)
        padded[:q_n] = data
        seeds = self._seed_index()
        packed = self._packed_index() if engine in ("auto", "packed") else None
        if engine == "packed" and packed is None:
            raise RuntimeError(
                "packed engine unavailable: index too small, metric has no "
                "matmul form, or payload exceeds PACKED_BUDGET_SHARE of the "
                "device memory"
            )
        if packed is not None:
            from ocaml_hnsw_tpu.models.packed import knn_search_packed

            if expand is None:
                expand = 2
                if (max_iters is not None and expand_schedule is None
                        and not Index._warned_expand_pairing):
                    import warnings

                    warnings.warn(
                        "knn_query's default expand changed 4 -> 2 (round-4 "
                        "serving campaign); a max_iters pinned under the old "
                        "expand=4 guidance now explores ~half the candidates "
                        "per query — roughly double it, or pass expand=4 "
                        "explicitly.  (Warned once per process.)",
                        stacklevel=2,
                    )
                    Index._warned_expand_pairing = True
            ids, dists = knn_search_packed(
                st.graph,
                packed,
                jnp.asarray(padded),
                k=k,
                ef=max(ef if ef is not None else self.ef, k),
                metric=self.space,
                max_iters=max_iters,
                seeds=seeds,
                seed_e=8,
                expand=expand,
                expand_schedule=expand_schedule,
                rerank_k=rerank_k,
                interleave=interleave if b % max(interleave, 1) == 0 else 1,
            )
        else:
            if compact_k == "auto":
                m0 = st.config.M_max0
                compact_k = (3 * 4 * m0) // 4 if (
                    seeds is not None and 4 * m0 >= 128
                ) else None
            ids, dists = knn_search(
                st.graph,
                jnp.asarray(padded),
                k=k,
                ef=max(ef if ef is not None else self.ef, k),
                metric=self.space,
                max_iters=max_iters,
                seeds=seeds,
                compact_k=compact_k,
            )
        ids = np.asarray(ids)[:q_n]
        dists = np.asarray(dists)[:q_n]
        labels = np.where(ids >= 0, self._labels[np.maximum(ids, 0)], -1)
        return labels.astype(np.int64), dists

    # ------------------------------------------------------------ inspection
    def get_current_count(self) -> int:
        return int(self._require_init().graph.n)

    def get_max_elements(self) -> int:
        return self._require_init().max_elements

    def get_ids_list(self) -> list[int]:
        return self._labels.tolist()

    def get_items(self, ids) -> np.ndarray:
        """Stored vectors as f32 (int8 storage dequantized via per-row scales;
        cosine rows are the normalized form, matching hnswlib)."""
        from ocaml_hnsw_tpu.ops.distance import gather_dequant

        st = self._require_init()
        iids = np.array(
            [self._id_of(l) for l in np.asarray(ids).reshape(-1)],
            dtype=np.int64,
        )
        rows = gather_dequant(
            st.graph.vectors, st.graph.scales, jnp.asarray(iids[None, :])
        )[0]
        return np.asarray(rows, dtype=np.float32)

    def _id_of(self, label) -> int:
        try:
            return self._label_to_id[int(label)]
        except KeyError:
            raise KeyError(f"label {label} not in index") from None

    # ----------------------------------------------------------- checkpoints
    def save_index(self, path) -> None:
        st = self._require_init()
        index_io.save_index_file(
            path, st.graph, st.config, self._labels,
            rng_state=st.rng.get_state(), max_elements=st.max_elements,
            ef=self.ef,
        )

    def load_index(self, path, max_elements: int | None = None) -> None:
        (graph, config, labels, rng_state, saved_max,
         ef) = index_io.load_index_file(path)
        self.ef = ef
        if config.metric != self.space or config.dim != self.dim:
            raise ValueError(
                f"index file is ({config.metric}, dim={config.dim}), this "
                f"Index is ({self.space}, dim={self.dim})"
            )
        # round padding must stay inside the saved capacity headroom
        round_size = max(1, min(1024, graph.n_cap - saved_max - 1))
        st = BuildState(config, saved_max, round_size=round_size)
        st.adopt_graph(graph)
        st.l_max = graph.l_max
        if rng_state is not None:
            st.rng.set_state(rng_state)
        self._state = st
        self._seeds = None
        self._packed = None
        self._labels = labels
        self._label_to_id = {int(l): i for i, l in enumerate(labels)}
        if max_elements is not None and max_elements > saved_max:
            self.resize_index(max_elements)  # hnswlib resize-on-load


class FlatIndex:
    """Flat-scan index (models/flat.py): one bf16 matmul over the whole
    dataset, ops.select.min_k keeps rerank_k candidates, exact f32 rerank.
    Near-exact recall at a cost linear in N per query batch."""

    exact = False

    def __init__(self, space: str, dim: int):
        _check_space(space)
        self.space = space
        self.dim = dim
        self._flat = None
        self._labels = np.zeros((0,), dtype=np.int64)
        self._label_to_id: dict[int, int] = {}
        self.max_elements = 0
        self.rerank_k = 32

    def init_index(self, max_elements: int, rerank_k: int = 32,
                   scan_dtype: str = "bf16", rerank_dtype: str = "f32",
                   **_ignored) -> None:
        """scan_dtype: "bf16" or "int8" (config 4's quantized distances, 4x
        less scan memory); rerank_dtype: "f32" or "bf16" (memory-constrained
        high-dim datasets, e.g. 768-d CLIP at 5M+)."""
        from ocaml_hnsw_tpu.models.flat import empty_flat

        self.max_elements = max_elements
        self.rerank_k = rerank_k
        self._flat = empty_flat(self.dim, max_elements, scan_dtype=scan_dtype,
                                rerank_dtype=rerank_dtype)

    def _require_init(self):
        if self._flat is None:
            raise RuntimeError("call init_index (or load_index) first")
        return self._flat

    def add_items(self, data, ids=None, **_ignored) -> None:
        from ocaml_hnsw_tpu.models.flat import flat_add

        flat = self._require_init()
        data = np.atleast_2d(np.asarray(data, dtype=np.float32))
        if data.shape[1] != self.dim:
            raise ValueError(f"expected dim {self.dim}, got {data.shape[1]}")
        from ocaml_hnsw_tpu.ops.metrics import get_metric

        if get_metric(self.space).normalize_add:
            nrm = np.linalg.norm(data, axis=1, keepdims=True)
            data = data / np.where(nrm == 0, 1.0, nrm)
        n_new = data.shape[0]
        n_cur = int(flat.n)
        if n_cur + n_new > self.max_elements:
            raise RuntimeError("index is full; grow max_elements")
        if ids is None:
            labels = np.arange(n_cur, n_cur + n_new, dtype=np.int64)
        else:
            labels = np.asarray(ids, dtype=np.int64).reshape(-1)
            if labels.shape[0] != n_new:
                raise ValueError("ids length must match data rows")
        clash = [int(l) for l in labels if int(l) in self._label_to_id]
        if clash:
            raise ValueError(f"duplicate labels not supported: {clash[:5]}")
        chunk = 65536
        done = 0
        while done < n_new:
            c = min(chunk, n_new - done)
            rows = np.zeros((chunk, self.dim), np.float32)
            rows[:c] = data[done : done + c]
            flat = flat_add(flat, jnp.asarray(rows),
                            jnp.int32(n_cur + done), jnp.int32(c))
            done += c
        self._flat = flat
        for off, lab in enumerate(labels):
            self._label_to_id[int(lab)] = n_cur + off
        self._labels = np.concatenate([self._labels, labels])

    def resize_index(self, new_max_elements: int) -> None:
        """Grow capacity in place (tensors re-padded; norms pad to +inf so
        empty slots never score)."""
        flat = self._require_init()
        if new_max_elements < int(flat.n):
            raise ValueError("cannot shrink below current element count")
        self.max_elements = new_max_elements
        from ocaml_hnsw_tpu.utils import round_up

        n_cap_new = round_up(max(new_max_elements, 4096), 4096)
        grow = n_cap_new - flat.n_cap
        if grow <= 0:
            return

        def pad(a, fill):
            widths = [(0, grow)] + [(0, 0)] * (a.ndim - 1)
            return jnp.pad(a, widths, constant_values=fill)

        self._flat = flat._replace(
            scan=pad(flat.scan, 0),
            scales=pad(flat.scales, 1.0),
            rerank=pad(flat.rerank, 0),
            norms=pad(flat.norms, jnp.inf),
            deleted=pad(flat.deleted, False),
        )

    def knn_query(self, data, k: int = 1, rerank_k: int | None = None,
                  **_ignored):
        from ocaml_hnsw_tpu.models.flat import flat_search

        flat = self._require_init()
        if int(flat.n) == 0:
            raise RuntimeError("index is empty")
        data = np.atleast_2d(np.asarray(data, dtype=np.float32))
        q_n = data.shape[0]
        b = _pad_batch(q_n)
        padded = np.zeros((b, self.dim), np.float32)
        padded[:q_n] = data
        ids, dists = flat_search(
            flat, jnp.asarray(padded), k=k, metric=self.space,
            rerank_k=max(k, rerank_k if rerank_k is not None else self.rerank_k),
            exact=self.exact,
        )
        ids = np.asarray(ids)[:q_n]
        dists = np.asarray(dists)[:q_n]
        labels = np.where(ids >= 0, self._labels[np.maximum(ids, 0)], -1)
        return labels.astype(np.int64), dists

    def mark_deleted(self, label: int) -> None:
        flat = self._require_init()
        iid = self._label_to_id[int(label)]
        self._flat = flat._replace(deleted=flat.deleted.at[iid].set(True))

    delete_vector = mark_deleted  # hnswlib BFIndex spelling

    def unmark_deleted(self, label: int) -> None:
        flat = self._require_init()
        iid = self._label_to_id[int(label)]
        self._flat = flat._replace(deleted=flat.deleted.at[iid].set(False))

    def get_current_count(self) -> int:
        return 0 if self._flat is None else int(self._flat.n)

    def get_ids_list(self) -> list[int]:
        return self._labels.tolist()

    def save_index(self, path) -> None:
        flat = self._require_init()
        # numpy has no bfloat16: save bf16 arrays widened to f32 + a tag
        def widen(a):
            return np.asarray(a.astype(jnp.float32)) if a.dtype == jnp.bfloat16 \
                else np.asarray(a)

        arrays = dict(
            scan=widen(flat.scan),
            scan_dtype=np.frombuffer(str(flat.scan.dtype).encode(), np.uint8),
            rerank_dtype=np.frombuffer(
                str(flat.rerank.dtype).encode(), np.uint8
            ),
            scales=np.asarray(flat.scales),
            rerank=widen(flat.rerank),
            norms=np.asarray(flat.norms),
            n=np.asarray(flat.n),
            deleted=np.asarray(flat.deleted),
            labels=self._labels,
            max_elements=np.int64(self.max_elements),
            space=np.frombuffer(self.space.encode(), dtype=np.uint8),
        )
        # open handle: keep save("x.bin")/load("x.bin") symmetric (np.savez
        # appends ".npz" to bare string paths)
        with open(path, "wb") as f:
            np.savez(f, **arrays)

    def load_index(self, path, max_elements: int | None = None) -> None:
        with np.load(path) as z:
            space = bytes(z["space"]).decode()
            if space != self.space:
                raise ValueError(f"index file is {space}, this is {self.space}")
            from ocaml_hnsw_tpu.models.flat import FlatTensors

            sd = bytes(z["scan_dtype"]).decode() if "scan_dtype" in z else "float32"
            rd = bytes(z["rerank_dtype"]).decode() if "rerank_dtype" in z else "float32"
            rerank = jnp.asarray(np.asarray(z["rerank"])).astype(rd)
            scan = jnp.asarray(np.asarray(z["scan"])).astype(sd) if "scan" in z \
                else rerank
            self._flat = FlatTensors(
                scan=scan,
                scales=jnp.asarray(z["scales"]) if "scales" in z
                else jnp.ones((rerank.shape[0],), jnp.float32),
                rerank=rerank,
                norms=jnp.asarray(z["norms"]),
                n=jnp.asarray(z["n"]),
                deleted=jnp.asarray(z["deleted"]),
            )
            self._labels = np.asarray(z["labels"])
            self._label_to_id = {int(l): i for i, l in enumerate(self._labels)}
            self.max_elements = int(z["max_elements"])
        if max_elements is not None and max_elements > self.max_elements:
            # hnswlib resize-on-load: actually grow the tensors (the old
            # count-only bump let add_items overrun capacity)
            self.resize_index(max_elements)


class BFIndex(FlatIndex):
    """Exact brute-force index (hnswlib BFIndex parity): f32 HIGHEST-precision
    scan + exact top_k.  Same surface as FlatIndex."""

    exact = True
