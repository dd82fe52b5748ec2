"""Benchmark harness — the reference's L4 layer (SURVEY.md §1, §3.5):
ann-benchmarks-style protocol: build (timed), exact ground truth, recall@k
sweep, QPS at the target recall.  Emits structured JSON per run (SURVEY.md
§5.5 metrics/observability).

Two engines are measured — the HNSW graph index and the flat scan
(models/flat.py) — and the headline is the faster one that meets the recall
target; both results are reported, with the device they ran on.
"""

from __future__ import annotations

import json
import time

import numpy as np
import jax
import jax.numpy as jnp

from ocaml_hnsw_tpu.config import HnswConfig
from ocaml_hnsw_tpu.models.build import BuildState
from ocaml_hnsw_tpu.models.search import knn_search
from ocaml_hnsw_tpu.models.flat import empty_flat, flat_add, flat_search
from ocaml_hnsw_tpu.oracle.bruteforce import recall as recall_of
from ocaml_hnsw_tpu.bench import datasets


def device_info() -> dict:
    """The device a result was measured on, as JAX reports it."""
    d = jax.devices()[0]
    return {"backend": d.platform, "device_kind": d.device_kind,
            "device_count": len(jax.devices())}


def build_flat(data, metric: str, scan_dtype: str = "bf16",
               rerank_dtype: str = "f32"):
    """Load a dataset (host numpy or device array) into FlatTensors."""
    from ocaml_hnsw_tpu.ops.metrics import get_metric

    if not isinstance(data, jnp.ndarray):
        data = np.asarray(data, dtype=np.float32)
    if get_metric(metric).normalize_add:
        xp = jnp if isinstance(data, jnp.ndarray) else np
        nrm = xp.linalg.norm(data, axis=1, keepdims=True)
        data = data / xp.where(nrm == 0, 1.0, nrm)
    n = data.shape[0]
    flat = empty_flat(data.shape[1], n, scan_dtype=scan_dtype,
                      rerank_dtype=rerank_dtype)
    chunk = 262144
    if isinstance(data, jnp.ndarray):
        data = jnp.pad(data.astype(jnp.float32), ((0, chunk), (0, 0)))
        for i in range(0, n, chunk):
            rows = jax.lax.dynamic_slice_in_dim(data, i, chunk, axis=0)
            flat = flat_add(flat, rows, jnp.int32(i), jnp.int32(min(chunk, n - i)))
        return flat
    for i in range(0, n, chunk):
        c = min(chunk, n - i)
        rows = np.zeros((chunk, data.shape[1]), np.float32)
        rows[:c] = data[i : i + c]
        flat = flat_add(flat, jnp.asarray(rows), jnp.int32(i), jnp.int32(c))
    return flat


def _gt_slab(src, qc, k: int, metric: str, start, n_slab: int):
    """Exact top-k of one query chunk against one N-slab (f32 HIGHEST).

    `src` is either FlatTensors (rows = its rerank matrix, tombstones
    honored) or a raw [N, D] row matrix (rows normalized here for cosine).
    Passing the raw f32 dataset keeps GT exact even when the serving engine
    stores bf16/int8 rows — at 768-d the bf16-rounded "GT" mislabels ~2% of
    true top-10 at 20k rows (worse at 1M), an artificial recall ceiling."""
    from ocaml_hnsw_tpu.models.search import preprocess_queries
    from ocaml_hnsw_tpu.ops.distance import HIGHEST, INF

    from ocaml_hnsw_tpu.ops.metrics import get_metric

    m = get_metric(metric)
    q = preprocess_queries(qc, metric)
    raw = isinstance(src, jnp.ndarray)
    rows = jax.lax.dynamic_slice_in_dim(
        src if raw else src.rerank, start, n_slab, axis=0
    ).astype(jnp.float32)
    if raw and m.normalize_add:
        nrm = jnp.linalg.norm(rows, axis=1, keepdims=True)
        rows = rows / jnp.where(nrm == 0, 1.0, nrm)
    if m.matmul_score is not None:
        dot = jnp.einsum("bd,nd->bn", q, rows, precision=HIGHEST)
        nn = jnp.sum(rows * rows, axis=1) if m.needs_norms \
            else jnp.zeros((rows.shape[0],), jnp.float32)
        d = m.matmul_score(dot, nn[None, :])
    else:
        d = m.pair_dist(rows[None], q)  # exact VPU form, fused over the slab
    if not raw:
        ids_global = start + jnp.arange(n_slab)
        occupied = ids_global < src.n
        d = jnp.where(occupied[None, :] & ~src.deleted[ids_global][None, :],
                      d, INF)
    neg, idx = jax.lax.top_k(-d, k)
    return (start + idx).astype(jnp.int32), -neg


_gt_slab_jit = jax.jit(_gt_slab, static_argnames=("k", "metric", "n_slab"))


def device_ground_truth(src, queries, k: int, metric: str, chunk: int = 256,
                        n_slab: int = 1 << 20) -> np.ndarray:
    """Exact kNN on the accelerator, chunked over queries AND over N slabs so
    the [chunk, N] score matrix never exceeds ~1 GB (10M-row configs).

    `src`: FlatTensors, or the raw f32 [N, D] dataset (see _gt_slab)."""
    queries = jnp.asarray(queries)
    nq = queries.shape[0]
    queries = jnp.pad(queries, ((0, chunk), (0, 0)))
    n_cap = src.shape[0] if isinstance(src, jnp.ndarray) else src.n_cap
    n_slab = min(n_slab, n_cap)
    out = []
    for i in range(0, nq, chunk):
        qc = jax.lax.dynamic_slice_in_dim(queries, i, chunk, axis=0)
        slab_ids, slab_d = [], []
        for start in range(0, n_cap, n_slab):
            width = min(n_slab, n_cap - start)
            ids, d = _gt_slab_jit(src, qc, k=k, metric=metric,
                                  start=jnp.int32(start), n_slab=width)
            slab_ids.append(ids)
            slab_d.append(d)
        all_ids = jnp.concatenate(slab_ids, axis=1)
        all_d = jnp.concatenate(slab_d, axis=1)
        neg, idx = jax.lax.top_k(-all_d, k)
        ids = jnp.take_along_axis(all_ids, idx, axis=1)
        out.append(np.asarray(ids)[: min(chunk, nq - i)])
    return np.concatenate(out)


def measure_qps(search_fn, queries: np.ndarray, batch: int = 4096,
                warmup: int = 2, reps: int = 10) -> float:
    """Steady-state throughput of `search_fn(q_batch) -> ids` (queries tiled
    to fill whole batches; jit warmed first).

    reps=10: QPS is a steady-state metric; over more reps the first
    dispatch's host cost and the final wait are edge effects.  The window
    ends in `jax.block_until_ready` on the last batch, so it times the
    device work and not the enqueue."""
    q = jnp.asarray(queries)
    while q.shape[0] < batch:
        q = jnp.concatenate([q, q])
    q = q[:batch]
    for _ in range(warmup):
        jax.block_until_ready(search_fn(q))
    t0 = time.perf_counter()
    for _ in range(reps):
        ids = search_fn(q)
    jax.block_until_ready(ids)
    dt = time.perf_counter() - t0
    return batch * reps / dt


def run_streaming_config(
    name: str,
    n: int,
    dim: int,
    metric: str,
    n_queries: int = 1000,
    k: int = 10,
    M: int = 16,
    ef_construction: int = 200,
    round_size: int = 2048,
    # (ef, max_iters) operating points measured SIMULTANEOUSLY during ingest
    # (each step times one query batch per setting); the headline row is the
    # cheapest whose END-state recall meets target_recall (the 0.95-recall
    # streaming operating point, not a fixed knob).
    settings=((96, 16), (128, 24), (160, 32), (224, 48), (320, 80)),
    target_recall: float = 0.95,
    warm_frac: float = 0.5,
    n_steps: int = 10,
    qps_batch: int = 4096,
    seed: int = 7,
    storage: str = "f32",
    data_dtype: str = "f32",
    verbose: bool = True,
) -> dict:
    """The 768-d streaming configs measured AS streaming: interleaved timed
    insert rounds and query batches on one device.  Reports, per (ef, max_iters)
    setting, sustained query QPS during ingest and end-state recall; the
    headline is the cheapest setting meeting the recall target (or the best
    recall achieved if none does — reported honestly either way).

    storage / data_dtype: memory plan for the 5M x 768-d full-scale run —
    the f32 source alone would be 15.4 GB, so the dataset generates as bf16
    slabs and the graph stores int8 rows (build and query cast per
    round/slab; GT stays exact from the source rows at f32 compute)."""
    from ocaml_hnsw_tpu.models.search import build_seed_index

    def log(msg):
        if verbose:
            print(f"[stream:{name}] {msg}", flush=True)

    log("generating dataset on device")
    data, make_q = datasets.clustered_device(
        n, dim, n_clusters=max(64, n // 2500), seed=seed,
        dtype=jnp.bfloat16 if data_dtype == "bf16" else None,
    )
    queries = make_q(n_queries, qseed=seed + 1)
    qb = jnp.asarray(queries)
    while qb.shape[0] < qps_batch:
        qb = jnp.concatenate([qb, qb])
    qb = qb[:qps_batch]

    # exact GT up front from the raw f32 rows (a lossy-dtype flat engine
    # here put an artificial ~0.9x ceiling on measured recall at 768-d)
    log("computing exact ground truth on device")
    gt = device_ground_truth(data, queries, k, metric)

    cfg = HnswConfig(dim=dim, metric=metric, M=M,
                     ef_construction=ef_construction, storage=storage)
    state = BuildState(cfg, n, round_size=round_size)
    n_warm = int(n * warm_frac)
    t0 = time.perf_counter()
    # feed the warm build in 500k-row slices: state.add(data[:n_warm])
    # materializes the slice (3.9 GB for 2.5M x 768-d bf16)
    warm_chunk = 500_000
    for lo in range(0, n_warm, warm_chunk):
        state.add(data[lo: min(lo + warm_chunk, n_warm)])
        jax.block_until_ready(state.graph)
    warm_s = time.perf_counter() - t0
    log(f"warm build {n_warm} in {warm_s:.1f}s = {n_warm/warm_s:.0f} vps")

    step_n = (n - n_warm) // n_steps
    ins_s = 0.0
    q_s = {s: 0.0 for s in settings}
    q_done = {s: 0 for s in settings}
    compact = 3 * (4 * cfg.M_max0) // 4 if cfg.M_max0 * 4 >= 128 else None
    for i in range(n_steps):
        lo = n_warm + i * step_n
        t0 = time.perf_counter()
        state.add(data[lo : lo + step_n])
        jax.block_until_ready(state.graph)
        ins_s += time.perf_counter() - t0
        seeds = build_seed_index(state.graph, metric)
        for s in settings:
            ef, mi = s
            t0 = time.perf_counter()
            ids = knn_search(state.graph, qb, k=k, ef=ef, metric=metric,
                             max_iters=mi, seeds=seeds,
                             compact_k=compact)[0]
            jax.block_until_ready(ids)
            dt = time.perf_counter() - t0
            # first step pays the compile; skip it in the sustained number
            if i > 0:
                q_s[s] += dt
                q_done[s] += qps_batch
        log(f"step {i}: +{step_n} in {ins_s:.1f}s cum")

    # end-state recall per setting vs the precomputed exact GT
    seeds = build_seed_index(state.graph, metric)
    sweep = []
    chosen = None
    for s in settings:
        ef, mi = s
        ids, _ = knn_search(state.graph, jnp.asarray(queries), k=k, ef=ef,
                            metric=metric, max_iters=mi, seeds=seeds,
                            compact_k=compact)
        r = recall_of(np.asarray(ids), gt)
        qps = round(q_done[s] / q_s[s]) if q_s[s] else None
        sweep.append({"ef": ef, "max_iters": mi, "recall": round(r, 4),
                      "sustained_qps_during_ingest": qps})
        log(f"ef={ef} mi={mi}: end recall@{k}={r:.4f} sustained={qps}")
        if chosen is None and r >= target_recall:
            chosen = sweep[-1]
    best = chosen or max(sweep, key=lambda s: s["recall"])
    ingested = n - n_warm
    out = {
        "config": name,
        "n": n,
        "dim": dim,
        "metric": metric,
        "streaming": True,
        "target_recall": target_recall,
        "met_target": chosen is not None,
        "warm_build_vps": round(n_warm / warm_s),
        "ingest_vps": round(ingested / ins_s),
        "sustained_qps_during_ingest": best["sustained_qps_during_ingest"],
        "recall": best["recall"],
        "ef": best["ef"],
        "max_iters": best["max_iters"],
        "sweep": sweep,
        **device_info(),
    }
    log(json.dumps(out))
    return out


def run_config(
    name: str,
    n: int,
    dim: int,
    metric: str,
    n_queries: int = 1000,
    k: int = 10,
    M: int = 16,
    ef_construction: int = 200,
    round_size: int = 1024,
    # (ef, max_iters) pairs ordered by cost; None = run to convergence.
    # Recall is iteration-limited at these widths, so the sweep climbs
    # max_iters.
    ef_sweep=((48, 8), (64, 10), (96, 12), (96, 14), (96, 15), (96, 16),
              (96, 18), (96, 21), (96, 24), (128, 32), (128, None),
              (256, None)),
    # packed-engine sweep: (ef, max_iters, rerank_k, expand[, interleave]),
    # climbing recall; expand is an int or an ((e, iters), ...) schedule
    # (max_iters ignored for schedules).  Narrow expansion (e=2) halves
    # every per-iteration width while iterations only double; qps_batch is
    # served as interleave=2 sub-batches in ONE program (models/packed.py
    # duo loop).  The first row brackets the 0.95 crossing from below; the
    # tail is the safety ladder for harder datasets.  These operating
    # points were chosen before the GPU; re-sweeping them there is open.
    packed_sweep=(
        (64, 29, 32, 2, 2),
        (64, 30, 32, 2, 2),
        (64, 33, 32, 2, 2),
        (96, 38, 48, 2, 2),
        (128, 48, 64, 2, 2),
        (128, 56, 64, 2, 2),
        (160, 64, 96, 2, 2),
        (192, 80, 96, 2, 2),
        (256, None, 128, 4),
    ),
    rerank_sweep=(32, 64, 128),
    target_recall: float = 0.95,
    qps_batch: int = 8192,
    # serve the entry scan from at most this many seed-bank rows (highest
    # levels first + an even level-1 subsample; build_seed_index docstring)
    seed_cap: int | None = 16384,
    seed: int = 7,
    storage: str = "f32",
    scan_dtype: str = "bf16",
    rerank_dtype: str = "f32",
    engines=("hnsw", "flat"),
    # which hnsw query paths the sweep may use (packed preferred when its
    # availability policy holds; classic is the fallback ladder)
    hnsw_engines=("packed", "classic"),
    verbose: bool = True,
) -> dict:
    """Full ann-benchmarks protocol on a synthetic stand-in dataset."""

    def log(msg):
        if verbose:
            print(f"[bench:{name}] {msg}", flush=True)

    log("generating dataset on device")
    data, make_q = datasets.clustered_device(
        n, dim, n_clusters=max(64, n // 2500), seed=seed
    )
    queries = make_q(n_queries, qseed=seed + 1)

    # exact GT from the raw f32 rows BEFORE any lossy-dtype engine exists
    log("computing exact ground truth on device")
    gt = device_ground_truth(data, queries, k, metric)

    t0 = time.perf_counter()
    flat = build_flat(data, metric, scan_dtype=scan_dtype,
                      rerank_dtype=rerank_dtype)
    jax.block_until_ready(flat)
    flat_build_s = time.perf_counter() - t0
    log(f"flat loaded in {flat_build_s:.1f}s")
    if "hnsw" not in engines:
        data = make_q = None  # free the raw f32 dataset (memory at 10M)

    results = {}

    # Memory plan for sources over an eighth of the device memory limit
    # (utils/memory.py): the f32 source, the flat engine's scan+rerank rows
    # and the HNSW graph tensors need not all sit alongside the insert
    # rounds' workspace.  Free the flat engine for the duration of the
    # build and halve the source to bf16 (the build casts each round's
    # R-row slice back to f32 — only storage precision changes); the flat
    # engine is rebuilt for its own sweep afterwards.
    from ocaml_hnsw_tpu.utils.memory import budget_bytes

    big = "hnsw" in engines and data.nbytes > budget_bytes(1 / 8)
    if big:
        log("large source: freeing flat engine + bf16 build source during "
            "build")
        flat = None
        data = data.astype(jnp.bfloat16)

    if "hnsw" in engines:
        from ocaml_hnsw_tpu.models.search import build_seed_index

        cfg = HnswConfig(dim=dim, metric=metric, M=M,
                         ef_construction=ef_construction, storage=storage)
        # Compile warm-up, UNTIMED and labeled: without it the build number
        # rides on persistent-cache state nobody controls.  A first build of
        # the same data compiles every program family the timed build uses
        # (bulk passes pad to capacity and the _upper_level buckets key on
        # the observed level counts, so only a same-shape build warms them
        # all); the result is discarded and the timed region below then
        # measures device throughput regardless of cache state.  Gated to
        # the bulk-eligible headline sizes — at 10M the round-path build is
        # many minutes and doubling it buys nothing.
        if 100_000 <= n <= 2_000_000 and not big:
            log("compile warm-up: untimed same-shape build (result discarded)")
            t0 = time.perf_counter()
            state_w = BuildState(cfg, n, round_size=round_size)
            state_w.add(data)
            jax.block_until_ready(state_w.graph)
            del state_w
            log(f"warm-up done in {time.perf_counter() - t0:.1f}s")
        log(f"hnsw build: n={n} dim={dim} metric={metric} M={M} "
            f"efC={ef_construction} storage={storage}")
        t0 = time.perf_counter()
        state = BuildState(cfg, n, round_size=round_size)
        state.add(data)  # device-resident data: no host transfer
        jax.block_until_ready(state.graph)
        build_s = time.perf_counter() - t0
        log(f"hnsw built in {build_s:.1f}s = {n / build_s:.0f} vectors/s")
        seeds = build_seed_index(state.graph, metric, cap=seed_cap) \
            if n >= 4096 else None
        # packed inline-int8 engine (models/packed.py) for matmul metrics at
        # >=100k nodes whose payload fits the memory budget (same policy as
        # api.Index._packed_index)
        packed = None
        pack_s = 0.0
        if n >= 100_000 and "packed" in hnsw_engines:
            from ocaml_hnsw_tpu.ops.metrics import get_metric
            from ocaml_hnsw_tpu.models.packed import pack_d_pad, pack_graph

            packed = state.packed_graph()  # maintained by the packed build
            if packed is not None:
                log("packed payload reused from the build (0s)")
            else:
                from ocaml_hnsw_tpu.api import Index

                deg = state.graph.adj0.shape[1]
                fits = (state.graph.n_cap * deg * pack_d_pad(dim)
                        <= budget_bytes(Index.PACKED_BUDGET_SHARE))
                if get_metric(metric).matmul_score is not None and fits:
                    t0 = time.perf_counter()
                    packed = pack_graph(state.graph, metric)
                    jax.block_until_ready(packed)
                    pack_s = time.perf_counter() - t0
                    log(f"packed payload built in {pack_s:.1f}s "
                        f"({packed.pay.nbytes / 2**30:.2f} GiB)")
        sweep = []
        chosen = None
        if packed is not None:
            from ocaml_hnsw_tpu.models.packed import knn_search_packed

            for entry in packed_sweep:
                ef, mi, rk = entry[0], entry[1], entry[2]
                e = entry[3] if len(entry) > 3 else 4
                il = entry[4] if len(entry) > 4 else 1
                sched = e if isinstance(e, tuple) else None
                e_int = 4 if isinstance(e, tuple) else e
                # capped rows serve in fori mode (no convergence predicate);
                # uncapped ladder rows need the while_loop early exit
                ee = mi is None
                ids, _ = knn_search_packed(
                    state.graph, packed, queries, k=k, ef=ef, metric=metric,
                    max_iters=mi, seeds=seeds, seed_e=8, rerank_k=rk,
                    expand=e_int, expand_schedule=sched, early_exit=ee,
                    interleave=il)
                r = recall_of(np.asarray(ids), gt)
                qps = measure_qps(
                    lambda q, ef=ef, mi=mi, rk=rk, e_int=e_int, sched=sched,
                    ee=ee, il=il:
                    knn_search_packed(
                        state.graph, packed, q, k=k, ef=ef, metric=metric,
                        max_iters=mi, seeds=seeds, seed_e=8, rerank_k=rk,
                        expand=e_int, expand_schedule=sched, early_exit=ee,
                        interleave=il)[0],
                    queries, batch=qps_batch,
                )
                # typed JSON: int expands stay ints, schedules become
                # nested lists (comparable downstream)
                e_json = ([[int(a), int(b)] for a, b in e]
                          if isinstance(e, tuple) else int(e))
                sweep.append({"engine": "packed", "ef": ef, "max_iters": mi,
                              "rerank_k": rk, "expand": e_json,
                              "interleave": il,
                              "recall": round(r, 4), "qps": round(qps)})
                log(f"hnsw[packed] ef={ef} mi={mi} rk={rk} e={e} il={il}: "
                    f"recall@{k}={r:.4f} qps={qps:.0f}")
                if chosen is None and r >= target_recall:
                    chosen = sweep[-1]
                    break
        if chosen is None and "classic" in hnsw_engines:
            # compact only when the candidate block is wide enough to matter
            compact = 3 * (4 * cfg.M_max0) // 4 if 4 * cfg.M_max0 >= 128 else None
            for entry in ef_sweep:
                ef, mi = entry if isinstance(entry, tuple) else (entry, None)
                ids, _ = knn_search(state.graph, queries, k=k, ef=ef,
                                    metric=metric, max_iters=mi, seeds=seeds,
                                    compact_k=compact)
                r = recall_of(np.asarray(ids), gt)
                qps = measure_qps(
                    lambda q, ef=ef, mi=mi: knn_search(
                        state.graph, q, k=k, ef=ef, metric=metric, max_iters=mi,
                        seeds=seeds, compact_k=compact)[0],
                    queries, batch=qps_batch,
                )
                sweep.append({"engine": "classic", "ef": ef, "max_iters": mi,
                              "recall": round(r, 4), "qps": round(qps)})
                log(f"hnsw ef={ef} mi={mi}: recall@{k}={r:.4f} qps={qps:.0f}")
                if chosen is None and r >= target_recall:
                    chosen = sweep[-1]
                    break
        results["hnsw"] = {
            "build_seconds": round(build_s, 2),
            "pack_seconds": round(pack_s, 2),
            "build_vectors_per_second": round(n / build_s),
            "sweep": sweep,
            "best": chosen or sweep[-1],
        }

    if "flat" in engines and flat is None:
        log("rebuilding flat engine (freed during the hnsw build)")
        # free the graph + payload first: at this scale graph tensors, the
        # rebuilt flat pair and the bf16 source need not all fit
        if "hnsw" in engines:
            state = seeds = packed = None
        flat = build_flat(data, metric, scan_dtype=scan_dtype,
                          rerank_dtype=rerank_dtype)
        jax.block_until_ready(flat)
    if "flat" in engines:
        log(f"flat engine (loaded above in {flat_build_s:.1f}s)")
        sweep = []
        chosen = None
        for rk in rerank_sweep:
            ids, _ = flat_search(flat, queries, k=k,
                                 metric=metric, rerank_k=rk)
            r = recall_of(np.asarray(ids), gt)
            qps = measure_qps(
                lambda q, rk=rk: flat_search(flat, q, k=k, metric=metric,
                                             rerank_k=rk)[0],
                queries, batch=qps_batch,
            )
            sweep.append({"rerank_k": rk, "recall": round(r, 4),
                          "qps": round(qps)})
            log(f"flat rerank_k={rk}: recall@{k}={r:.4f} qps={qps:.0f}")
            if chosen is None and r >= target_recall:
                chosen = sweep[-1]
                break
        results["flat"] = {
            "build_seconds": round(flat_build_s, 2),
            "build_vectors_per_second": round(n / flat_build_s),
            "sweep": sweep,
            "best": chosen or sweep[-1],
        }

    # headline: fastest engine meeting the target
    meeting = {
        e: v for e, v in results.items() if v["best"]["recall"] >= target_recall
    }
    pool = meeting or results
    head = max(pool, key=lambda e: pool[e]["best"]["qps"])
    return {
        "config": name,
        "n": n,
        "dim": dim,
        "metric": metric,
        "target_recall": target_recall,
        "engine": head,
        "recall": results[head]["best"]["recall"],
        "qps": results[head]["best"]["qps"],
        "engines": results,
        **device_info(),
    }
