#!/usr/bin/env python3
"""Race the per-slab selection methods of ops/select.py on the accelerator.

Each case times one jitted scan + selection (the bf16 matmul over the
column slab is part of it, as in the engines) at the shapes the engines
run: the bulk build's kNN table (8192 queries against 1M rows, keeping
knn_k + 1 + 32 = 97), the flat engine (rerank_k 32 and 128) and the seed
scan (8 of 65,536 bank rows).  Candidate recall is against the "exact"
method on the same scores: by id, and by value (selected scores at most the
exact k-th score), which is the one that counts where bf16 scores tie.  One
JSON object per case goes to stdout and to chiprun_out/race_select.jsonl.

    python scripts/race_select.py            # on the GPU
    python scripts/race_select.py --small    # tiny shapes (any backend)
"""

import argparse
import json
import os
import subprocess
import sys
import time
from functools import partial

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ocaml_hnsw_tpu.ops.select import min_k  # noqa: E402


def _scores(x, xn, q, start, width):
    rows = jax.lax.dynamic_slice_in_dim(x, start, width)
    dot = jax.lax.dot_general(q, rows, (((1,), (1,)), ((), ())),
                              preferred_element_type=jnp.float32)
    return jax.lax.dynamic_slice_in_dim(xn, start, width)[None, :] - 2 * dot


@partial(jax.jit, static_argnames=("k", "method", "slab", "group", "bf16"))
def _run(x, xn, q, k, method, slab, group, bf16):
    n = x.shape[0]
    blk = partial(_scores, x, xn, q)
    if bf16:
        blk = lambda s, w: _scores(x, xn, q, s, w).astype(jnp.bfloat16)  # noqa
    if method == "approx_whole":
        vals, ids = jax.lax.approx_min_k(blk(jnp.int32(0), n), k)
        return vals.astype(jnp.float32), ids.astype(jnp.int32)
    # loss=1: race the named group as it is, not min_k's adaptive choice
    return min_k(blk, n, k, method=method, slab=slab, group=group, loss=1.0)


def _time(fn, reps):
    out = jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    jax.block_until_ready(out)
    return out, (time.perf_counter() - t0) / reps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if args.small:
        b, n, u = 64, 8192, 1024
        slabs = (2048,)
    else:
        b, n, u = 8192, 1_003_520, 65536  # bulk flat n_cap at 1M rows
        slabs = (1 << 17,)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        smi = "nvidia-smi unavailable"
    dev = jax.devices()[0]
    print(f"[race] {smi} | {dev.platform} {dev.device_kind}", flush=True)
    kx, kq = jax.random.split(jax.random.PRNGKey(0))
    centers = jax.random.normal(kx, (max(64, n // 2500), 128))
    assign = jax.random.randint(kq, (n,), 0, centers.shape[0])
    x32 = centers[assign] + 0.15 * jax.random.normal(kq, (n, 128))
    xn = jnp.sum(x32 * x32, axis=1)
    x = x32.astype(jnp.bfloat16)
    q = (x32[:b] + 0.1 * jax.random.normal(kx, (b, 128))).astype(jnp.bfloat16)

    # "exact" first in each group: it is the recall reference
    per_k = {
        97: [("exact", 0), ("group", 8), ("group", 16), ("group", 32)],
        32: [("exact", 0), ("group", 16), ("approx_whole", 0)],
        128: [("exact", 0), ("group", 16), ("group", 32)],
    }
    for k, cases in per_k.items():
        for slab in slabs:
            for method, group in cases:
                yield_case(x, xn, q, k, method, slab, group, False, args.reps)
    seed_x, seed_xn = x[:u], xn[:u]
    for method, group in (("exact", 0), ("group", 16), ("approx_whole", 0)):
        yield_case(seed_x, seed_xn, q, 8, method, u, group, True, args.reps)


_EXACT = {}


def yield_case(x, xn, q, k, method, slab, group, bf16, reps):
    rec = {"b": q.shape[0], "n": x.shape[0], "k": k, "method": method,
           "slab": slab, "group": group, "bf16_scores": bf16}
    key = (x.shape[0], k, bf16)
    try:
        (vals, ids), sec = _time(
            lambda: _run(x, xn, q, k=k, method=method, slab=slab or None,
                         group=group or 16, bf16=bf16), reps)
        rec["ms"] = sec * 1e3
        vals, ids = np.asarray(vals), np.asarray(ids)
        if method == "exact":
            _EXACT[key] = (vals, ids)
        if key in _EXACT:
            ex_vals, ex = _EXACT[key]
            hit = sum(len(set(a) & set(e)) for a, e in zip(ids, ex))
            rec["candidate_recall"] = hit / ex.size
            kth = ex_vals.max(axis=1, keepdims=True)
            rec["value_recall"] = float(np.mean(vals <= kth))
    except Exception as e:  # a shape XLA refuses is a result too
        rec["error"] = f"{type(e).__name__}: {str(e)[:200]}"
    line = json.dumps(rec)
    print(line, flush=True)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "race_select.jsonl"),
              "a") as f:
        f.write(line + "\n")


if __name__ == "__main__":
    main()
