#!/usr/bin/env python3
"""Smoke run of the HNSW index on an NVIDIA GPU, through the public API, at
the SIFT1M shape (1,000,000 x 128-d float32, l2, M=16, ef_construction=200;
seeded clustered data, nothing downloaded).

    python chip_smoke.py                # phases 1-6 on one GPU
    python chip_smoke.py --four-cards   # phase 7 only: ShardedIndex, 4 GPUs

Phases: 1 device check, 2 build (Index.add_items, bulk constructor),
3 queries (packed and classic engines) against NumPy brute force,
4 guarantees (mark_deleted, save/load round trip), 5 flat engines
(FlatIndex, BFIndex), 6 top-k selection against np.argpartition and the
matmul precisions, 7 (option) ShardedIndex over a 4-device mesh.

Each phase prints its numbers on its own line.  The last line of stdout is
one JSON object {"ok": true, "device": {...}}; it is printed only when every
phase passed.  Without a GPU, or when a phase fails, the script exits
non-zero and prints no such line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402

K = 10
N_QUERIES = 1000
RECALL_MIN = 0.95


class PhaseFailed(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise PhaseFailed(msg)


def log(phase: str, **nums) -> None:
    body = " ".join(f"{k}={v}" for k, v in nums.items())
    print(f"[{phase}] {body}", flush=True)


# ------------------------------------------------------------------ phase 1
def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip() or out.stderr.strip()


def device_check(want: str = "gpu"):
    """Print the card and JAX's view of it; refuse any other platform."""
    import jax

    smi = nvidia_smi()
    for line in smi.splitlines():
        print(line, flush=True)
    devs = jax.devices()
    d = devs[0]
    log("device", platform=d.platform, kind=repr(d.device_kind),
        count=len(devs))
    check(d.platform == want,
          f"JAX platform is {d.platform!r}, not {want!r}: no accelerator")
    return devs


# ---------------------------------------------------------------- helpers
def make_data(n: int, dim: int, n_queries: int, seed: int):
    from ocaml_hnsw_tpu.bench.datasets import clustered, queries_like

    data = clustered(n, dim, n_clusters=max(64, n // 2500), seed=seed)
    return data, queries_like(data, n_queries, seed=seed + 1)


def brute_force(data, queries, k: int, metric: str = "l2",
                chunk: int = 100) -> np.ndarray:
    """The plain reference: NumPy exact kNN in query chunks of `chunk`."""
    from ocaml_hnsw_tpu.oracle import bruteforce_knn

    return np.concatenate([
        bruteforce_knn(data, queries[i:i + chunk], k, metric)[0]
        for i in range(0, len(queries), chunk)
    ])


def recall_at(found, gt) -> float:
    from ocaml_hnsw_tpu.oracle import recall

    return recall(found, gt)


# ------------------------------------------------------------------ phase 2
def phase_build(data, M: int = 16, ef_construction: int = 200):
    from ocaml_hnsw_tpu import Index

    idx = Index(space="l2", dim=data.shape[1])
    idx.init_index(max_elements=data.shape[0], M=M,
                   ef_construction=ef_construction)
    t0 = time.perf_counter()
    idx.add_items(data)
    idx.get_current_count()  # fetches graph.n: the build has finished
    dt = time.perf_counter() - t0
    check(idx.get_current_count() == data.shape[0], "build lost rows")
    log("build", n=data.shape[0], dim=data.shape[1], seconds=f"{dt:.3f}",
        vectors_per_second=f"{data.shape[0] / dt:.0f}",
        note="information only (includes compilation)")
    return idx


# ------------------------------------------------------------------ phase 3
def phase_query(idx, queries, gt, ef_auto: int = 128, ef_classic: int = 256):
    out = {}
    for engine, ef in (("auto", ef_auto), ("classic", ef_classic)):
        t0 = time.perf_counter()
        labels, dists = idx.knn_query(queries, k=K, ef=ef, engine=engine)
        dt = time.perf_counter() - t0
        check(labels.shape == (len(queries), K), f"{engine}: bad shape")
        check(np.isfinite(dists).all(), f"{engine}: non-finite distances")
        r = recall_at(labels, gt)
        log("query", engine=engine, ef=ef, queries=len(queries),
            recall_at_10=f"{r:.4f}", seconds=f"{dt:.3f}",
            note="first call includes compilation")
        check(r >= RECALL_MIN, f"{engine} recall {r:.4f} < {RECALL_MIN}")
        out[engine] = labels
    return out


# ------------------------------------------------------------------ phase 4
def phase_guarantees(idx, queries, gt, ef: int = 128):
    from ocaml_hnsw_tpu import Index

    victim = int(gt[0, 0])
    idx.mark_deleted(victim)
    labels, _ = idx.knn_query(queries[:1], k=K, ef=ef)
    check(victim not in labels[0].tolist(),
          f"deleted label {victim} still returned")
    log("guarantees", deleted_label=victim, gone=True)
    before, d_before = idx.knn_query(queries, k=K, ef=ef)
    with tempfile.TemporaryDirectory(dir=HERE, prefix=".smoke-") as tmp:
        path = os.path.join(tmp, "index.npz")
        t0 = time.perf_counter()
        idx.save_index(path)
        size = os.path.getsize(path)
        other = Index(space=idx.space, dim=idx.dim)
        other.load_index(path)
        dt = time.perf_counter() - t0
    after, d_after = other.knn_query(queries, k=K, ef=ef)
    same = bool(np.array_equal(before, after))
    log("guarantees", save_load_seconds=f"{dt:.3f}",
        file_mib=f"{size / 2**20:.1f}", identical_ids=same,
        identical_dists=bool(np.array_equal(d_before, d_after)))
    check(same, "save/load round trip changed the results")
    check(victim not in after.ravel().tolist(),
          "tombstone lost in the save/load round trip")
    idx.unmark_deleted(victim)


# ------------------------------------------------------------------ phase 5
def phase_flat(data, queries, gt, n_bf: int = 100, rerank_k: int = 32):
    from ocaml_hnsw_tpu import BFIndex, FlatIndex

    flat = FlatIndex(space="l2", dim=data.shape[1])
    flat.init_index(max_elements=data.shape[0], rerank_k=rerank_k)
    t0 = time.perf_counter()
    flat.add_items(data)
    labels, _ = flat.knn_query(queries, k=K)
    dt = time.perf_counter() - t0
    r = recall_at(labels, gt)
    log("flat", engine="FlatIndex", rerank_k=rerank_k,
        recall_at_10=f"{r:.4f}", seconds=f"{dt:.3f}",
        note="load + first query, includes compilation")
    check(r >= RECALL_MIN, f"FlatIndex recall {r:.4f} < {RECALL_MIN}")

    bf = BFIndex(space="l2", dim=data.shape[1])
    bf.init_index(max_elements=data.shape[0])
    bf.add_items(data)
    qs = queries[:n_bf]
    found, _ = bf.knn_query(qs, k=K)
    # NumPy reference in float64, so its own rounding cannot fake a tie
    x = data.astype(np.float64)
    q = qs.astype(np.float64)
    d64 = (np.sum(q * q, 1)[:, None] - 2.0 * q @ x.T
           + np.sum(x * x, 1)[None, :])
    true = np.argsort(d64, axis=1, kind="stable")[:, :K]
    mism = 0
    for i in range(len(qs)):
        d_true = d64[i, true[i]]
        d_found = np.sort(d64[i, found[i]])
        check(np.allclose(d_found, d_true, rtol=1e-5, atol=0.0),
              f"BFIndex row {i}: distances differ from brute force")
        mism += int(np.sum(found[i] != true[i]))
    log("flat", engine="BFIndex", queries=len(qs), ids_equal=mism == 0,
        tie_positions=mism, tie_rtol="1e-5")


# ------------------------------------------------------------------ phase 6
def _precision_probe():
    """Max relative error of an f32 matmul at DEFAULT and HIGHEST against
    float64: DEFAULT runs TF32 on an H100 (~1e-3), HIGHEST true f32."""
    import jax
    import jax.numpy as jnp

    rng = np.random.RandomState(0)
    a = rng.randn(256, 128).astype(np.float32)
    b = rng.randn(128, 1024).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    out = {}
    for name, p in (("DEFAULT", jax.lax.Precision.DEFAULT),
                    ("HIGHEST", jax.lax.Precision.HIGHEST)):
        got = np.asarray(jnp.dot(jnp.asarray(a), jnp.asarray(b),
                                 precision=p), np.float64)
        out[name] = float(np.max(np.abs(got - ref) / scale))
    return out


def phase_select(data, queries, k: int = 97, n_check: int = 64):
    """The bulk build's kNN batch: B queries scored in bf16 against all
    rows, min_k keeping knn_k + 1 + 32 = 97, checked against argpartition
    of the same scores on the host."""
    from functools import partial

    import jax
    import jax.numpy as jnp
    from ocaml_hnsw_tpu.models.flat import _scan_scores
    from ocaml_hnsw_tpu.models.bulk import flat_from_rows
    from ocaml_hnsw_tpu.ops import select

    flat = flat_from_rows(jnp.asarray(data), "l2")
    q = jnp.asarray(queries)
    n_cap = flat.n_cap
    exact = select.METHOD == "exact"

    # the index rides as an argument, never as a baked-in constant
    @jax.jit
    def run(flat, q):
        return select.min_k(partial(_scan_scores, flat, q, "l2", False),
                            n_cap, k)

    vals, ids = jax.block_until_ready(run(flat, q))
    t0 = time.perf_counter()
    vals, ids = jax.block_until_ready(run(flat, q))
    dt = time.perf_counter() - t0
    # the same score rows, materialised, for the host reference; and the
    # selection over exactly those scores
    rows = jnp.asarray(queries[:n_check])
    scores = jax.jit(lambda f, r: _scan_scores(f, r, "l2", False,
                                               jnp.int32(0), n_cap))(flat, rows)
    s_np = np.asarray(scores)
    v_same, i_same = jax.jit(
        lambda s: select.min_k(
            lambda st, w: jax.lax.dynamic_slice_in_dim(s, st, w, axis=1),
            n_cap, k))(scores)
    v_same, i_same = np.asarray(v_same), np.asarray(i_same)
    ids = np.asarray(ids)[:n_check]
    part = np.argpartition(s_np, k - 1, axis=1)[:, :k]
    true_vals = np.sort(np.take_along_axis(s_np, part, 1), axis=1)
    hit_same = sum(len(set(a) & set(b)) for a, b in zip(i_same, part))
    hit_batch = sum(len(set(a) & set(b)) for a, b in zip(ids, part))
    rec_same = hit_same / part.size
    rec_batch = hit_batch / part.size
    log("select", method=select.METHOD, batch=len(queries), n=n_cap, k=k,
        seconds=f"{dt:.4f}", rows_checked=n_check,
        candidate_recall_same_scores=f"{rec_same:.5f}",
        candidate_recall_full_batch=f"{rec_batch:.5f}",
        tolerance="exact" if exact else ">=0.99")
    if exact:
        check(np.array_equal(np.sort(v_same, axis=1), true_vals),
              "exact selection differs from argpartition")
    else:
        check(rec_same >= 0.99, f"candidate recall {rec_same:.4f} < 0.99")
        check(rec_batch >= 0.99,
              f"full-batch candidate recall {rec_batch:.4f} < 0.99")
    prec = _precision_probe()
    log("precision", scan="bf16 x bf16 -> f32 accumulate",
        exact_distances="Precision.HIGHEST",
        highest_max_rel_err=f"{prec['HIGHEST']:.2e}",
        build_pairwise="Precision.DEFAULT on f32",
        default_max_rel_err=f"{prec['DEFAULT']:.2e}",
        default_is_tf32=prec["DEFAULT"] > 1e-5)
    check(prec["HIGHEST"] < 1e-5, "Precision.HIGHEST is not true f32 here")


# ------------------------------------------------------------------ phase 7
def phase_sharded(n_cards: int, rows_per_card: int, n_queries: int,
                  seed: int = 7, round_size: int = 2048, ef: int = 128):
    import jax
    from ocaml_hnsw_tpu.parallel import ShardedIndex
    from ocaml_hnsw_tpu.parallel.sharded import make_mesh

    n = n_cards * rows_per_card
    data, queries = make_data(n, 128, n_queries, seed)
    mesh = make_mesh(n_cards)
    idx = ShardedIndex(space="l2", dim=128, mesh=mesh)
    idx.init_index(max_elements=n, M=16, ef_construction=200,
                   round_size=round_size)
    t0 = time.perf_counter()
    idx.add_items(data)
    jax.block_until_ready(idx._stacked)
    dt = time.perf_counter() - t0
    log("sharded", cards=n_cards, n=n, build_seconds=f"{dt:.1f}",
        vectors_per_second=f"{n / dt:.0f}", note="information only")
    # every shard's tensors live on their own card
    want = set(mesh.devices.ravel().tolist())
    for name in ("vectors", "adj0", "deleted"):
        arr = getattr(idx._stacked, name)
        shards = arr.addressable_shards
        placed = {s.device for s in shards}
        rows = sorted((s.index[0].start or 0) for s in shards)
        check(placed == want and len(shards) == n_cards,
              f"{name}: shards on {len(placed)} devices, want {n_cards}")
        check(rows == list(range(n_cards)),
              f"{name}: shard slices {rows} are not one per card")
    log("sharded", placement="one shard per card", devices=len(want))
    gt = brute_force(data, queries, K)
    t0 = time.perf_counter()
    labels, _ = idx.knn_query(queries, k=K, ef=ef)
    dt = time.perf_counter() - t0
    r = recall_at(labels, gt)
    log("sharded", queries=n_queries, ef=ef, recall_at_10=f"{r:.4f}",
        seconds=f"{dt:.3f}", note="first call includes compilation")
    check(r >= RECALL_MIN, f"sharded recall {r:.4f} < {RECALL_MIN}")


# -------------------------------------------------------------------- main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only phase 7, ShardedIndex over 4 cards")
    ap.add_argument("--rows", type=int, default=1_000_000,
                    help="rows (per card with --four-cards)")
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)

    devs = device_check()
    from ocaml_hnsw_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    if args.four_cards:
        check(len(devs) >= 4, f"{len(devs)} devices, --four-cards needs 4")
        phase_sharded(4, args.rows, N_QUERIES, seed=args.seed)
        count = 4
    else:
        data, queries = make_data(args.rows, 128, N_QUERIES, args.seed)
        t0 = time.perf_counter()
        gt = brute_force(data, queries, K)
        log("reference", engine="numpy brute force", queries=len(queries),
            seconds=f"{time.perf_counter() - t0:.1f}")
        idx = phase_build(data)
        phase_query(idx, queries, gt)
        phase_guarantees(idx, queries, gt)
        del idx
        phase_flat(data, queries, gt)
        from ocaml_hnsw_tpu.bench.datasets import queries_like

        phase_select(data, queries_like(data, 8192, seed=args.seed + 2))
        count = len(devs)
    d = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
