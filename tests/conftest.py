"""Test bootstrap: force the CPU backend with a virtual 8-device mesh so every
test (including the sharded-index tests) runs without an accelerator
(SURVEY.md §4: "host-count simulation via xla_force_host_platform_device_count").

The platform is forced through jax.config, before any backend initializes,
so the tests stay on the CPU even on a machine whose default is a GPU.
Tests that need the card carry the `gpu` marker and skip here; the card's
own coverage is `python chip_smoke.py`.
"""

import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# Persistent XLA:CPU compile cache (round 5): the suite's wall-clock is
# almost entirely XLA:CPU compile time (one insert_round family = ~200 s,
# each knn_search variant 13-15 s, execution centiseconds), and the
# per-module jax.clear_caches() below forces recompiles.  The disk cache
# makes those reloads ~5x cheaper.  Round 1 reverted this after a SIGILL in
# cpu_aot_loader (machine-feature mismatch); re-validated on jax 0.9.0 this
# round: the loader prints "+prefer-no-gather ... could lead to SIGILL"
# warnings but reloads execute correctly (full suite green).  If a future
# toolchain regresses, set OHNSW_TEST_NO_CACHE=1.  An external
# JAX_COMPILATION_CACHE_DIR is left as it is.
if not (os.environ.get("OHNSW_TEST_NO_CACHE")
        or os.environ.get("JAX_COMPILATION_CACHE_DIR")):
    _cache_dir = os.path.join(os.path.dirname(__file__), "..",
                              ".pytest_cache", "xla-cpu")
    jax.config.update("jax_compilation_cache_dir", _cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _free_jax_executables():
    """XLA:CPU's LLVM JIT segfaults after enough live compiled executables
    accumulate in one process on this machine (observed deterministically
    ~30 tests into the suite, in backend_compile_and_load; each test passes
    in isolation).  Dropping jit caches between modules avoids the crash at
    the cost of cross-module recompiles.

    Round 5: re-tested with the persistent compile cache ON (above) in the
    hope that AOT-loaded executables would sidestep the accumulation bug —
    they do NOT (a no-clear full suite still hard-crashed mid-run), so the
    per-module clear stays.  The disk cache makes each post-clear reload
    ~5x cheaper than a fresh compile, which is where the round-5 speedup
    comes from.  OHNSW_TEST_KEEP_CACHES=1 skips the clear for single-module
    debugging runs."""
    yield
    if not os.environ.get("OHNSW_TEST_KEEP_CACHES"):
        jax.clear_caches()


# --------------------------------------------------------------------------
# Cross-run build cache: BuildState.add() on the CPU backend is the single
# biggest suite cost (compile + ~n/R insert rounds per module fixture, paid
# again after every clear_caches).  Modules request a built graph through
# this helper; the constructed GraphTensors is persisted to
# .pytest_cache/graphs/<key>.npz via the real checkpoint codec, so repeat
# runs (and other modules wanting the same shape) load in milliseconds.
# Keys encode every build input — bump _CACHE_TAG when the builder's
# semantics change so stale graphs are never reused.
_CACHE_TAG = "v1"


def built_state_cached(key: str, config, n: int, data, round_size: int):
    """BuildState over `data`, loaded from the on-disk cache when possible.

    The filename mixes the caller's human-readable key with a hash of every
    build input — config fields, n, round_size, and the data bytes — so two
    callers reusing a key with different inputs can never collide on a stale
    artifact.  Returns a fresh BuildState that ADOPTED the
    cached graph (host mirrors, seed bank and RNG stream all rebuilt), which
    is exactly the load_index path users hit — behaviorally equivalent to
    building."""
    import dataclasses
    import hashlib

    import numpy as np
    from ocaml_hnsw_tpu.models.build import BuildState
    from ocaml_hnsw_tpu.io import save_index_file, load_index_file

    data_np = np.asarray(data)
    h = hashlib.sha256()
    h.update(repr(sorted(dataclasses.asdict(config).items())).encode())
    h.update(f"|n={n}|rs={round_size}|{data_np.dtype}{data_np.shape}".encode())
    h.update(np.ascontiguousarray(data_np).tobytes())
    digest = h.hexdigest()[:16]

    cache_dir = os.path.join(os.path.dirname(__file__), "..", ".pytest_cache",
                             "graphs")
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, f"{_CACHE_TAG}-{key}-{digest}.npz")
    if os.path.exists(path):
        graph, cfg, _, rng_state, _, _ = load_index_file(path)
        assert cfg == config, (
            "graph-cache hash collision: loaded config differs from the "
            "requested one — delete .pytest_cache/graphs and rerun"
        )
        st = BuildState(cfg, n, round_size=round_size)
        st.adopt_graph(graph)
        if rng_state is not None:
            st.rng.set_state(rng_state)
        return st
    st = BuildState(config, n, round_size=round_size)
    st.add(data)
    save_index_file(path, st.graph, config,
                    np.arange(int(st.graph.n), dtype=np.int64),
                    rng_state=st.rng.get_state())
    return st
