"""Multi-device sharded index — the distributed layer the reference lacks
(SURVEY.md §2 "Distributed communication backend: none", §5.8): dataset and
graph sharded by node id over a `jax.sharding.Mesh`, queries replicated,
collectives over the device interconnect (NVLink between GPUs).

Design (SURVEY.md §5.8 "simpler: per-shard full searches + global top-k merge,
which is exact for sharded-by-partition indexes"):

- points are assigned **round-robin** to S shards (global id g ↔ shard g % S,
  local slot g // S), so every shard holds an unbiased sample of the data and
  per-shard recall matches single-shard recall at equal ef;
- each shard is an independent HNSW subindex; one `shard_map` step runs the
  single-device engine per device — **build** (insert_round, including the
  seed-scan entries via a per-shard seed bank) and **query** (knn_search with
  the same seed bank) both SPMD over the mesh;
- query merge: per-shard local top-k → `all_gather` over the shard axis
  → global top-k.  The merge is exact given the per-shard results, so recall
  composes; the only cross-chip traffic is [S, B, k] ids+dists.

The same stacked-graph pytree runs on one device (S=1), a CPU-simulated
8-device mesh (tests), or the GPUs of one host — only the Mesh changes.  Each
shard's tensors live on their own device (chip_smoke.py --four-cards checks
the placement).  Lifecycle parity with the single-device Index: save_index/load_index (one npz holding every
shard), resize_index, get_items, mark/unmark_deleted.
"""

from __future__ import annotations

import dataclasses
import json
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P, NamedSharding

from ocaml_hnsw_tpu.config import HnswConfig
from ocaml_hnsw_tpu.models.graph import GraphTensors, empty_graph
from ocaml_hnsw_tpu.models.search import knn_search, seed_index_from_bank
from ocaml_hnsw_tpu.models.build import (
    insert_round,
    insert_rounds_scan,
    bootstrap,
    sample_levels,
    seed_capacity,
)

AXIS = "shard"
FORMAT_VERSION = 2  # v2: compact upper-arena graphs (see models/graph.py)


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), axis_names=(AXIS,))


def _local(tree):
    """Strip the leading per-shard dim inside shard_map."""
    return jax.tree.map(lambda a: a[0], tree)


def _graph_specs(stacked: GraphTensors) -> GraphTensors:
    """PartitionSpecs for a stacked graph: every array field sharded on dim 0
    (the static l_max rides along as pytree aux data)."""
    return jax.tree.map(lambda _: P(AXIS), stacked)


@partial(
    jax.jit,
    static_argnames=("mesh", "k", "ef", "metric", "n_shards", "max_iters",
                     "compact_k"),
)
def sharded_knn(mesh: Mesh, stacked: GraphTensors, queries, k: int, ef: int,
                metric: str, n_shards: int, seed_bank=None, seed_n=None,
                max_iters: int | None = None, compact_k: int | None = None):
    """SPMD query step: local search per shard, all_gather + global top-k.

    queries are replicated; returns replicated (global_ids i32[B, k],
    dists f32[B, k]).  Local ids are mapped to global via g = l * S + s
    (round-robin placement).  When a seed bank is given, each shard uses the
    seed-scan entry path.

    Jitted with the (hashable) Mesh static: without the outer jit, every
    serving call re-traces the shard_map program.  Serving MUST hit a cached
    trace."""
    use_seeds = seed_bank is not None

    def step(local_stacked, q, *bank):
        g = _local(local_stacked)
        s = jax.lax.axis_index(AXIS)
        seeds = None
        if use_seeds:
            seeds = seed_index_from_bank(g, bank[0][0], bank[1][0], metric)
        ids, d = knn_search(g, q, k=k, ef=ef, metric=metric, seeds=seeds,
                            max_iters=max_iters, compact_k=compact_k)
        gids = jnp.where(ids >= 0, ids * n_shards + s, -1)
        all_ids = jax.lax.all_gather(gids, AXIS)  # [S, B, k]
        all_d = jax.lax.all_gather(d, AXIS)
        b = q.shape[0]
        flat_ids = jnp.moveaxis(all_ids, 0, 1).reshape(b, -1)
        flat_d = jnp.moveaxis(all_d, 0, 1).reshape(b, -1)
        neg, idx = jax.lax.top_k(-flat_d, k)
        return jnp.take_along_axis(flat_ids, idx, axis=1), -neg

    extra_in = (P(AXIS), P(AXIS)) if use_seeds else ()
    fn = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(_graph_specs(stacked), P()) + extra_in,
        out_specs=(P(), P()),
        check_vma=False,  # engine loop carries are not vma-annotated
    )
    args = (stacked, queries)
    if use_seeds:
        args += (seed_bank, seed_n)
    return fn(*args)


def sharded_pack(mesh: Mesh, stacked: GraphTensors, metric: str):
    """Pack every shard's inline-int8 serving payload in one SPMD step.
    Returns stacked (pay [S, n_cap*c, w], meta [S, n_cap, 2deg],
    scale [S]) for sharded_knn_packed."""
    from ocaml_hnsw_tpu.models.packed import pack_graph

    def step(local_stacked):
        g = _local(local_stacked)
        p = pack_graph(g, metric)
        return p.pay[None], p.meta[None], p.scale[None]

    fn = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(_graph_specs(stacked),),
        out_specs=(P(AXIS), P(AXIS), P(AXIS)),
        check_vma=False,
    )
    return fn(stacked)


@partial(
    jax.jit,
    static_argnames=("mesh", "k", "ef", "metric", "n_shards", "max_iters",
                     "expand", "rerank_k", "expand_schedule"),
)
def sharded_knn_packed(mesh: Mesh, stacked: GraphTensors, pay, meta, scale,
                       queries, k: int, ef: int, metric: str, n_shards: int,
                       seed_bank, seed_n, max_iters: int | None = None,
                       expand: int = 2, rerank_k: int = 32,
                       expand_schedule: tuple | None = None):
    """SPMD packed query step: each shard runs the single-device packed
    engine (models/packed.py) on its own subindex, then the exact
    all_gather + global top-k merge."""
    from ocaml_hnsw_tpu.models.packed import PackedGraph, knn_search_packed

    def step(local_stacked, lpay, lmeta, lscale, q, bank, bn):
        g = _local(local_stacked)
        p = PackedGraph(pay=lpay[0], meta=lmeta[0], scale=lscale[0],
                        dist=None)
        seeds = seed_index_from_bank(g, bank[0], bn[0], metric)
        ids, d = knn_search_packed(
            g, p, q, k=k, ef=ef, metric=metric, max_iters=max_iters,
            seeds=seeds, seed_e=8, rerank_k=rerank_k, expand=expand,
            expand_schedule=expand_schedule)
        s = jax.lax.axis_index(AXIS)
        gids = jnp.where(ids >= 0, ids * n_shards + s, -1)
        all_ids = jax.lax.all_gather(gids, AXIS)  # [S, B, k]
        all_d = jax.lax.all_gather(d, AXIS)
        b = q.shape[0]
        flat_ids = jnp.moveaxis(all_ids, 0, 1).reshape(b, -1)
        flat_d = jnp.moveaxis(all_d, 0, 1).reshape(b, -1)
        neg, idx = jax.lax.top_k(-flat_d, k)
        return jnp.take_along_axis(flat_ids, idx, axis=1), -neg

    fn = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(_graph_specs(stacked), P(AXIS), P(AXIS), P(AXIS), P(),
                  P(AXIS), P(AXIS)),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return fn(stacked, pay, meta, scale, queries, seed_bank, seed_n)


def sharded_insert_round(
    mesh: Mesh,
    stacked: GraphTensors,
    vecs,  # f32[S, R, D] per-shard round payload (already prepped)
    levels,  # i32[S, R]
    start,  # i32[S]
    count,  # i32[S]
    seed_bank,  # i32[S, U_cap]
    seed_n,  # i32[S]
    seed_vecs,  # bf16[S, U_cap, D] cached bank rows
    seed_norms,  # f32[S, U_cap]
    *,
    efc: int,
    m: int,
    m_max0: int,
    rev_cap: int,
    metric: str,
    keep_pruned: bool,
    extend: bool = False,
    heuristic: bool = True,
    storage: str = "f32",
):
    """SPMD build step: every device runs one insert_round on its own shard.
    No cross-shard edges exist (shards are independent subindexes), so the
    only collective is the implicit SPMD program itself."""

    def step(local_stacked, v, lv, st, ct, bank, bn, bvec, bnrm):
        g = _local(local_stacked)
        g2, bank2, bn2, bvec2, bnrm2, *_ = insert_round(
            g, v[0], lv[0], st[0], ct[0], bank[0], bn[0], bvec[0], bnrm[0],
            efc=efc, m=m, m_max0=m_max0, rev_cap=rev_cap, metric=metric,
            keep_pruned=keep_pruned, extend=extend, heuristic=heuristic,
            storage=storage,
        )
        expand = lambda a: jax.tree.map(lambda x: x[None], a)
        return (expand(g2), expand(bank2), expand(bn2), expand(bvec2),
                expand(bnrm2))

    fn = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(_graph_specs(stacked), P(AXIS), P(AXIS), P(AXIS), P(AXIS),
                  P(AXIS), P(AXIS), P(AXIS), P(AXIS)),
        out_specs=(_graph_specs(stacked), P(AXIS), P(AXIS), P(AXIS), P(AXIS)),
        check_vma=False,  # engine loop carries are not vma-annotated
    )
    return fn(stacked, vecs, levels, start, count, seed_bank, seed_n,
              seed_vecs, seed_norms)


def sharded_insert_rounds_scan(
    mesh: Mesh,
    stacked: GraphTensors,
    data,  # f32[S, Npad, D] per-shard round payload (already prepped)
    levels,  # i32[S, Npad]
    dones,  # i32[S, C] round offsets into data/levels per shard
    counts,  # i32[S, C] live rows per round per shard (0 = no-op round)
    seed_bank,  # i32[S, U_cap]
    seed_n,  # i32[S]
    seed_vecs,  # bf16[S, U_cap, D]
    seed_norms,  # f32[S, U_cap]
    *,
    rs: int,
    efc: int,
    m: int,
    m_max0: int,
    rev_cap: int,
    metric: str,
    keep_pruned: bool,
    extend: bool = False,
    heuristic: bool = True,
    storage: str = "f32",
):
    """SPMD scan-chunked build step: every device runs C insert_rounds on
    its own shard in ONE dispatch via the single-device
    `insert_rounds_scan`.
    Shards finish at different round counts; exhausted shards ride along
    with count=0 no-op rounds (insert_round masks every row by
    `arange(R) < count`, so a zero count leaves the graph untouched)."""

    def step(local_stacked, dat, lv, dn, ct, bank, bn, bvec, bnrm):
        g = _local(local_stacked)
        g2, bank2, bn2, bvec2, bnrm2, *_ = insert_rounds_scan(
            g, dat[0], lv[0], dn[0], ct[0], bank[0], bn[0], bvec[0],
            bnrm[0],
            rs=rs, efc=efc, m=m, m_max0=m_max0, rev_cap=rev_cap,
            metric=metric, keep_pruned=keep_pruned, storage=storage,
            build_mi=None, build_ck=None, build_expand=4, extend=extend,
            heuristic=heuristic, select_scan=None,
        )
        expand = lambda a: jax.tree.map(lambda x: x[None], a)
        return (expand(g2), expand(bank2), expand(bn2), expand(bvec2),
                expand(bnrm2))

    fn = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(_graph_specs(stacked), P(AXIS), P(AXIS), P(AXIS), P(AXIS),
                  P(AXIS), P(AXIS), P(AXIS), P(AXIS)),
        out_specs=(_graph_specs(stacked), P(AXIS), P(AXIS), P(AXIS), P(AXIS)),
        check_vma=False,
    )
    return fn(stacked, data, levels, dones, counts, seed_bank, seed_n,
              seed_vecs, seed_norms)


class ShardedIndex:
    """Dataset-sharded HNSW over a device mesh (phase-2 scale-out path).

    Each shard gets every S-th point (round-robin), its own seeded level
    stream (seed + shard), and builds independently; queries fan out to all
    shards and merge exactly.  On one host this also works with a single
    device (S=1) or the CPU-simulated mesh used in tests."""

    def __init__(self, space: str, dim: int, mesh: Mesh | None = None):
        from ocaml_hnsw_tpu.ops.metrics import is_metric, registered_metrics

        if not is_metric(space):
            raise ValueError(
                f"space must be a registered metric {registered_metrics()}, "
                f"got {space!r}"
            )
        self.space = space
        self.dim = dim
        self.mesh = mesh or make_mesh()
        self.n_shards = self.mesh.devices.size
        self._stacked: GraphTensors | None = None
        self._labels = np.zeros((0,), dtype=np.int64)
        self._packed_cache = None  # stacked (pay, meta, scale); lazy
        self.ef = 10

    #: total element count at which queries use the per-shard packed
    #: inline-int8 engine (same policy/threshold as api.Index)
    PACKED_THRESHOLD = 100_000
    #: rounds per scan dispatch for the SPMD build, largest-first (same
    #: ladder as BuildState.SCAN_CHUNKS); the < 8-round remainder runs
    #: through the per-round SPMD step
    SCAN_CHUNKS = (64, 8)

    def init_index(self, max_elements: int, M: int = 16,
                   ef_construction: int = 200, random_seed: int = 100,
                   round_size: int = 256, max_level_cap: int | None = None,
                   storage: str = "f32", **_ignored) -> None:
        s = self.n_shards
        per_shard = -(-max_elements // s)  # ceil
        self.config = HnswConfig(
            dim=self.dim, metric=self.space, M=M,
            ef_construction=ef_construction, seed=random_seed,
            max_level_cap=max_level_cap, storage=storage,
        )
        self.max_elements = max_elements
        self.round_size = round_size
        self.per_shard_cap = per_shard
        proto = empty_graph(self.config, per_shard + round_size + 1)
        self._init_device_state(proto)
        self._packed_cache = None
        self._rngs = [
            np.random.RandomState(random_seed + i) for i in range(s)
        ]
        self._shard_n = np.zeros(s, dtype=np.int64)  # host mirror of n
        self._host_max_level = np.full(s, -1, dtype=np.int64)
        self._host_upper = np.zeros(s, dtype=np.int64)
        self.rev_cap = 8

    def _init_device_state(self, proto: GraphTensors) -> None:
        s = self.n_shards
        u_cap = seed_capacity(proto.n_cap, self.config.M)
        stacked = jax.tree.map(
            lambda a: jnp.broadcast_to(a[None], (s,) + a.shape), proto
        )
        self._stacked = self._shard_put(stacked)
        self._seed_bank = self._shard_put(
            jnp.full((s, u_cap), -1, jnp.int32))
        self._seed_n = self._shard_put(jnp.zeros((s,), jnp.int32))
        self._seed_vecs = self._shard_put(
            jnp.zeros((s, u_cap, self.dim), jnp.bfloat16))
        self._seed_norms = self._shard_put(
            jnp.zeros((s, u_cap), jnp.float32))

    def _shard_put(self, tree):
        sharding = jax.tree.map(
            lambda _: NamedSharding(self.mesh, P(AXIS)), tree
        )
        return jax.device_put(tree, sharding)

    def _require_init(self):
        if self._stacked is None:
            raise RuntimeError("call init_index first")
        return self._stacked

    def add_items(self, data, ids=None) -> None:
        stacked = self._require_init()
        cfg = self.config
        s = self.n_shards
        data = np.atleast_2d(np.asarray(data, dtype=np.float32))
        from ocaml_hnsw_tpu.ops.metrics import get_metric

        if get_metric(cfg.metric).normalize_add:
            nrm = np.linalg.norm(data, axis=1, keepdims=True)
            data = data / np.where(nrm == 0, 1.0, nrm)
        n_new = data.shape[0]
        n_tot = int(self._shard_n.sum())
        if n_tot + n_new > self.max_elements:
            raise RuntimeError("index is full; grow max_elements")
        if ids is None:
            labels = np.arange(n_tot, n_tot + n_new, dtype=np.int64)
        else:
            labels = np.asarray(ids, dtype=np.int64).reshape(-1)
            if labels.shape[0] != n_new:
                raise ValueError("ids length must match data rows")
        clash = np.intersect1d(labels, self._labels)
        if clash.size:
            raise ValueError(
                f"duplicate labels not supported: {clash[:5].tolist()}"
            )
        self._labels = np.concatenate([self._labels, labels])

        # round-robin assignment by global insertion order
        gids = np.arange(n_tot, n_tot + n_new)
        shard_of = gids % s
        per_shard_data = [data[shard_of == i] for i in range(s)]
        l_max = stacked.l_max_static
        per_shard_levels = [
            sample_levels(self._rngs[i], len(per_shard_data[i]), cfg.mL,
                          l_max)
            for i in range(s)
        ]

        # bootstrap shards whose graph is still empty — DEVICE-side row
        # updates on the stacked tree (no round trip of the whole stacked
        # graph through host numpy)
        boot_needed = [
            i for i in range(s)
            if self._shard_n[i] == 0 and len(per_shard_data[i])
        ]
        if boot_needed:
            from ocaml_hnsw_tpu.ops.quantize import quantize_rows

            for i in boot_needed:
                lvl0 = int(per_shard_levels[i][0])
                v = jnp.asarray(per_shard_data[i][0], jnp.float32)[None, :]
                qrows, qscales, qnorms = quantize_rows(v, cfg.storage)
                if cfg.metric != "l2":
                    qnorms = jnp.zeros_like(qnorms)
                stacked = stacked._replace(
                    vectors=stacked.vectors.at[i, 0].set(
                        qrows[0].astype(stacked.vectors.dtype)),
                    scales=stacked.scales.at[i, 0].set(qscales[0]),
                    norms=stacked.norms.at[i, 0].set(qnorms[0]),
                    levels=stacked.levels.at[i, 0].set(lvl0),
                    up_base=stacked.up_base.at[i, 0].set(
                        0 if lvl0 >= 1 else -1),
                    up_n=stacked.up_n.at[i].set(lvl0),
                    entry=stacked.entry.at[i].set(0),
                    max_level=stacked.max_level.at[i].set(lvl0),
                    n=stacked.n.at[i].set(1),
                )
                if lvl0 >= 1:
                    self._seed_bank = self._seed_bank.at[i, 0].set(0)
                    self._seed_n = self._seed_n.at[i].set(1)
                    self._host_upper[i] += 1
                    deq = qrows[0].astype(jnp.float32) * qscales[0]
                    self._seed_vecs = self._seed_vecs.at[i, 0].set(
                        deq.astype(jnp.bfloat16))
                    self._seed_norms = self._seed_norms.at[i, 0].set(
                        qnorms[0])
                self._host_max_level[i] = max(self._host_max_level[i], lvl0)
                per_shard_data[i] = per_shard_data[i][1:]
                per_shard_levels[i] = per_shard_levels[i][1:]
                self._shard_n[i] += 1

        done = np.zeros(s, dtype=np.int64)
        todo = np.array([len(d) for d in per_shard_data])
        r = self.round_size
        from ocaml_hnsw_tpu.models.build import upper_round_width

        w_1 = upper_round_width(r, cfg.M, 1)
        w_2 = upper_round_width(r, cfg.M, 2)
        # host-side per-shard schedules (the same doubling rule the old
        # per-round loop applied).  Every shard gets an entry per global
        # round — exhausted shards ride with count=0 no-op rounds — so all
        # schedules share one length and the whole build can run as
        # scan-chunked SPMD dispatches, not a host loop of single-round
        # dispatches.
        shard_n = self._shard_n.copy()
        scheds: list[list[tuple[int, int]]] = [[] for _ in range(s)]
        while (done < todo).any():
            for i in range(s):
                c = int(min(r, todo[i] - done[i], max(shard_n[i], 1)))
                c = max(c, 0)
                if c:
                    lv_r = per_shard_levels[i][done[i]:done[i] + c]
                    c_1 = int((lv_r >= 1).sum())
                    c_2 = int((lv_r >= 2).sum())
                    if c_1 > w_1 or c_2 > w_2:
                        raise RuntimeError(
                            f"shard round has {c_1} points at level>=1 / "
                            f"{c_2} at level>=2 — exceeds the packed upper "
                            "widths"
                        )
                scheds[i].append((int(done[i]), c))
                done[i] += c
                shard_n[i] += c
        c_total = len(scheds[0]) if scheds else 0

        if c_total:
            # stack per-shard payloads once (each device holds only its own
            # slice under the P(AXIS) sharding); ONE put per add_items call
            npad = max(int(todo.max()), 1)
            dat = np.zeros((s, npad, self.dim), np.float32)
            lvl = np.zeros((s, npad), np.int32)
            for i in range(s):
                if todo[i]:
                    dat[i, :todo[i]] = per_shard_data[i]
                    lvl[i, :todo[i]] = per_shard_levels[i]
            dat_dev = self._shard_put(jnp.asarray(dat))
            lvl_dev = self._shard_put(jnp.asarray(lvl))
            dones = np.array([[d for d, _ in sc] for sc in scheds], np.int32)
            counts = np.array([[c for _, c in sc] for sc in scheds], np.int32)
            kw = dict(
                efc=cfg.ef_construction, m=cfg.M, m_max0=cfg.M_max0,
                rev_cap=self.rev_cap, metric=cfg.metric,
                keep_pruned=cfg.keep_pruned_connections,
                extend=cfg.extend_candidates,
                heuristic=cfg.select == "heuristic",
                storage=cfg.storage,
            )
            ci = 0
            while ci < c_total:
                chunk_len = next(
                    (cl for cl in self.SCAN_CHUNKS if c_total - ci >= cl),
                    None,
                )
                if chunk_len is not None:
                    (stacked, self._seed_bank, self._seed_n, self._seed_vecs,
                     self._seed_norms) = sharded_insert_rounds_scan(
                        self.mesh, stacked, dat_dev, lvl_dev,
                        jnp.asarray(dones[:, ci:ci + chunk_len]),
                        jnp.asarray(counts[:, ci:ci + chunk_len]),
                        self._seed_bank, self._seed_n,
                        self._seed_vecs, self._seed_norms, rs=r, **kw,
                    )
                    ci += chunk_len
                    continue
                # remainder rounds (< smallest scan chunk): per-round SPMD
                vecs = np.zeros((s, r, self.dim), np.float32)
                lvls = np.zeros((s, r), np.int32)
                start = np.zeros((s,), np.int32)
                count = np.zeros((s,), np.int32)
                for i in range(s):
                    d0, c = scheds[i][ci]
                    count[i] = c
                    start[i] = self._shard_n[i] + d0
                    if c:
                        vecs[i, :c] = per_shard_data[i][d0:d0 + c]
                        lvls[i, :c] = per_shard_levels[i][d0:d0 + c]
                (stacked, self._seed_bank, self._seed_n, self._seed_vecs,
                 self._seed_norms) = sharded_insert_round(
                    self.mesh, stacked,
                    jnp.asarray(vecs), jnp.asarray(lvls),
                    jnp.asarray(start), jnp.asarray(count),
                    self._seed_bank, self._seed_n,
                    self._seed_vecs, self._seed_norms, **kw,
                )
                ci += 1
        for i in range(s):
            if todo[i]:
                lv_i = per_shard_levels[i]
                self._host_max_level[i] = max(
                    self._host_max_level[i], int(lv_i.max())
                )
                self._host_upper[i] += int((lv_i >= 1).sum())
        self._shard_n += todo
        self._stacked = stacked
        self._packed_cache = None  # adjacency changed; repack lazily

    def set_ef(self, ef: int) -> None:
        self.ef = int(ef)

    def _packed_stacked(self):
        """Lazy per-shard packed payloads (None when below threshold, no
        matmul metric form, or some shard lacks seed-bank entries)."""
        from ocaml_hnsw_tpu.ops.metrics import get_metric

        if self.get_current_count() < self.PACKED_THRESHOLD:
            return None
        if get_metric(self.space).matmul_score is None:
            return None
        if int(np.asarray(self._seed_n).min()) <= 0:
            return None
        if self._packed_cache is None:
            self._packed_cache = sharded_pack(
                self.mesh, self._stacked, self.space)
        return self._packed_cache

    def knn_query(self, data, k: int = 1, ef: int | None = None,
                  max_iters: int | None = None, expand: int = 2,
                  rerank_k: int = 32, expand_schedule: tuple | None = None):
        """Same serving knobs as the single-chip api.Index.knn_query:
        expand / expand_schedule / rerank_k reach the per-shard packed
        engine."""
        stacked = self._require_init()
        data = np.atleast_2d(np.asarray(data, dtype=np.float32))
        q_n = data.shape[0]
        b = 8
        while b < q_n:
            b *= 2
        padded = np.zeros((b, self.dim), np.float32)
        padded[:q_n] = data
        use_seeds = int(np.asarray(self._seed_n).min()) > 0
        packed = self._packed_stacked()
        if packed is not None:
            pay, meta, scale = packed
            gids, d = sharded_knn_packed(
                self.mesh, stacked, pay, meta, scale, jnp.asarray(padded),
                k=k, ef=max(ef if ef is not None else self.ef, k),
                metric=self.space, n_shards=self.n_shards,
                seed_bank=self._seed_bank, seed_n=self._seed_n,
                max_iters=max_iters, expand=expand, rerank_k=rerank_k,
                expand_schedule=expand_schedule,
            )
            gids = np.asarray(gids)[:q_n]
            d = np.asarray(d)[:q_n]
            labels = np.where(gids >= 0,
                              self._labels[np.maximum(gids, 0)], -1)
            return labels.astype(np.int64), d
        gids, d = sharded_knn(
            self.mesh, stacked, jnp.asarray(padded), k=k,
            ef=max(ef if ef is not None else self.ef, k),
            metric=self.space, n_shards=self.n_shards,
            seed_bank=self._seed_bank if use_seeds else None,
            seed_n=self._seed_n if use_seeds else None,
            max_iters=max_iters,
        )
        gids = np.asarray(gids)[:q_n]
        d = np.asarray(d)[:q_n]
        labels = np.where(gids >= 0, self._labels[np.maximum(gids, 0)], -1)
        return labels.astype(np.int64), d

    # -------------------------------------------------------------- mutation
    def _locate(self, label: int):
        hits = np.where(self._labels == int(label))[0]
        if not hits.size:
            raise KeyError(f"label {label} not in index")
        gid = int(hits[0])
        return gid % self.n_shards, gid // self.n_shards

    def mark_deleted(self, label: int) -> None:
        stacked = self._require_init()
        s, l = self._locate(label)
        self._stacked = stacked._replace(
            deleted=stacked.deleted.at[s, l].set(True)
        )

    def unmark_deleted(self, label: int) -> None:
        stacked = self._require_init()
        s, l = self._locate(label)
        self._stacked = stacked._replace(
            deleted=stacked.deleted.at[s, l].set(False)
        )

    # ------------------------------------------------------------ inspection
    def get_current_count(self) -> int:
        return int(self._shard_n.sum())

    def get_max_elements(self) -> int:
        return self.max_elements

    def get_ids_list(self) -> list[int]:
        return self._labels.tolist()

    def get_items(self, ids) -> np.ndarray:
        """Stored vectors as f32, gathered DEVICE-side from the owning
        shard — only the requested rows cross the host link (
        the old path pulled the entire stacked vector tensor to host)."""
        stacked = self._require_init()
        ids_arr = np.atleast_1d(ids)
        loc = np.array([self._locate(lab) for lab in ids_arr],
                       np.int32).reshape(-1, 2)
        s_idx, l_idx = jnp.asarray(loc[:, 0]), jnp.asarray(loc[:, 1])
        rows = (stacked.vectors[s_idx, l_idx].astype(jnp.float32)
                * stacked.scales[s_idx, l_idx][:, None])
        return np.asarray(rows, dtype=np.float32)

    # ----------------------------------------------------------- checkpoints
    def save_index(self, path) -> None:
        stacked = self._require_init()
        meta = {
            "format_version": FORMAT_VERSION,
            "config": dataclasses.asdict(self.config),
            "n_shards": self.n_shards,
            "max_elements": self.max_elements,
            "round_size": self.round_size,
            "ef": self.ef,
            "rev_cap": self.rev_cap,
            "l_max": stacked.l_max_static,
        }
        arrays = {
            f"g_{name}": np.asarray(getattr(stacked, name))
            for name in GraphTensors._fields
        }
        arrays.update(
            seed_bank=np.asarray(self._seed_bank),
            seed_n=np.asarray(self._seed_n),
            labels=self._labels,
            shard_n=self._shard_n,
            host_max_level=self._host_max_level,
            host_upper=self._host_upper,
            rng_keys=np.stack(
                [r.get_state()[1] for r in self._rngs]
            ),
            rng_rest=np.array(
                [[r.get_state()[2], r.get_state()[3], r.get_state()[4]]
                 for r in self._rngs], dtype=np.float64
            ),
            meta_json=np.frombuffer(
                json.dumps(meta).encode("utf-8"), dtype=np.uint8
            ),
        )
        with open(path, "wb") as f:
            np.savez(f, **arrays)

    def load_index(self, path, max_elements: int | None = None) -> None:
        with np.load(path) as z:
            meta = json.loads(bytes(z["meta_json"]).decode("utf-8"))
            if meta["format_version"] > FORMAT_VERSION:
                raise ValueError("index file is newer than this library")
            if meta["n_shards"] != self.n_shards:
                raise ValueError(
                    f"index file has {meta['n_shards']} shards; this mesh "
                    f"has {self.n_shards} — shard counts must match"
                )
            cfg = HnswConfig(**meta["config"])
            if cfg.metric != self.space or cfg.dim != self.dim:
                raise ValueError("index file metric/dim mismatch")
            self.config = cfg
            self.max_elements = meta["max_elements"]
            self.round_size = meta["round_size"]
            self.ef = meta["ef"]
            self.rev_cap = meta["rev_cap"]
            self.per_shard_cap = -(-self.max_elements // self.n_shards)
            fields = {n: jnp.asarray(z[f"g_{n}"])
                      for n in GraphTensors._fields if f"g_{n}" in z}
            if "g_adj_upper" in z:  # format v1: dense upper layers, per shard
                from ocaml_hnsw_tpu.io import _arena_from_dense

                dense = np.asarray(z["g_adj_upper"])  # [S, L, cap, M]
                lv = np.asarray(z["g_levels"])
                nn = np.asarray(z["g_n"])
                per = [
                    _arena_from_dense(dense[i], lv[i], int(nn[i]),
                                      cfg.M, self.per_shard_cap)
                    for i in range(self.n_shards)
                ]
                fields["adj_up"] = jnp.asarray(np.stack([p[0] for p in per]))
                fields["up_base"] = jnp.asarray(np.stack([p[1] for p in per]))
                fields["up_n"] = jnp.asarray(
                    np.array([p[2] for p in per], np.int32))
                l_max_static = per[0][3]
            else:
                l_max_static = meta["l_max"]
            stacked = GraphTensors(**fields, l_max_static=l_max_static)
            self._stacked = self._shard_put(stacked)
            self._packed_cache = None
            self._seed_bank = self._shard_put(jnp.asarray(z["seed_bank"]))
            self._seed_n = self._shard_put(jnp.asarray(z["seed_n"]))
            self._rebuild_seed_cache()
            self._labels = np.asarray(z["labels"])
            self._shard_n = np.asarray(z["shard_n"]).copy()
            self._host_max_level = np.asarray(z["host_max_level"]).copy()
            self._host_upper = np.asarray(z["host_upper"]).copy()
            self._rngs = []
            for i in range(self.n_shards):
                r = np.random.RandomState()
                pos, hg, g = z["rng_rest"][i]
                r.set_state(("MT19937", z["rng_keys"][i].astype(np.uint32),
                             int(pos), int(hg), float(g)))
                self._rngs.append(r)
        if max_elements is not None and max_elements > self.max_elements:
            self.resize_index(max_elements)

    def resize_index(self, new_max_elements: int) -> None:
        """Grow capacity in place (per-shard tensors re-padded)."""
        stacked = self._require_init()
        if new_max_elements < self.get_current_count():
            raise ValueError("cannot shrink below current element count")
        s = self.n_shards
        per_shard = -(-new_max_elements // s)
        proto = empty_graph(self.config, per_shard + self.round_size + 1)
        old_cap = stacked.vectors.shape[1]
        new_cap = proto.n_cap
        if new_cap < old_cap:
            self.max_elements = new_max_elements
            self.per_shard_cap = per_shard
            return  # padded capacity already sufficient
        grow = new_cap - old_cap
        l_old = stacked.l_max_static
        l_new = proto.l_max

        def pad2(a, fill):
            widths = [(0, 0), (0, grow)] + [(0, 0)] * (a.ndim - 2)
            return jnp.pad(a, widths, constant_values=fill)

        t_grow = proto.t_cap - stacked.adj_up.shape[1]
        adj_up = stacked.adj_up
        if t_grow > 0:
            adj_up = jnp.pad(adj_up, ((0, 0), (0, t_grow), (0, 0)),
                             constant_values=-1)
        new_stacked = GraphTensors(
            vectors=pad2(stacked.vectors, 0),
            scales=pad2(stacked.scales, 1.0),
            norms=pad2(stacked.norms, 0.0),
            adj0=pad2(stacked.adj0, -1),
            adj_up=adj_up,
            up_base=pad2(stacked.up_base, -1),
            up_n=stacked.up_n,
            levels=pad2(stacked.levels, -1),
            entry=stacked.entry,
            max_level=stacked.max_level,
            n=stacked.n,
            deleted=pad2(stacked.deleted, False),
            l_max_static=max(l_new, l_old),
        )
        self._stacked = self._shard_put(new_stacked)
        self._packed_cache = None
        # seed bank capacity may need to grow with n_cap
        u_new = seed_capacity(new_cap, self.config.M)
        u_old = self._seed_bank.shape[1]
        if u_new > u_old:
            bank = jnp.pad(self._seed_bank, ((0, 0), (0, u_new - u_old)),
                           constant_values=-1)
            self._seed_bank = self._shard_put(bank)
            self._rebuild_seed_cache()
        self.max_elements = new_max_elements
        self.per_shard_cap = per_shard

    def _rebuild_seed_cache(self) -> None:
        """Recompute the bf16 bank-row cache from the stored vectors (one
        batched gather; used after load/resize)."""
        stacked = self._stacked
        safe = jnp.maximum(self._seed_bank, 0)  # [S, U]
        vecs = jnp.take_along_axis(
            stacked.vectors.astype(jnp.float32), safe[:, :, None], axis=1
        )
        vecs = vecs * jnp.take_along_axis(stacked.scales, safe, axis=1)[
            :, :, None]
        live = (self._seed_bank >= 0)[:, :, None]
        self._seed_vecs = self._shard_put(
            jnp.where(live, vecs, 0.0).astype(jnp.bfloat16))
        from ocaml_hnsw_tpu.ops.metrics import get_metric

        if get_metric(self.config.metric).needs_norms:
            nrm = jnp.sum(vecs * vecs, axis=2)
        else:
            nrm = jnp.zeros(vecs.shape[:2], jnp.float32)
        self._seed_norms = self._shard_put(
            jnp.where(live[:, :, 0], nrm, 0.0))
