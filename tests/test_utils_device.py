"""utils/cache.py (compile-cache directory) and utils/memory.py (budgets
from the device's memory limit)."""

import os

import jax
import pytest

from ocaml_hnsw_tpu.utils import cache, memory


@pytest.fixture
def config_updates(monkeypatch):
    """Record jax.config.update calls instead of changing the process."""
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.__setitem__(name, value))
    return calls


@pytest.mark.parametrize("env", [None, "/some/cache/dir"])
def test_enable_persistent_cache_directory(monkeypatch, config_updates, env):
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        monkeypatch.setattr(os, "makedirs", lambda *a, **k: None)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
    path = cache.enable_persistent_cache()
    if env is None:
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert path == os.path.join(repo, ".jaxcache")
        assert config_updates["jax_compilation_cache_dir"] == path
    else:
        # JAX reads the variable itself; the code sets no other directory
        assert path == env
        assert "jax_compilation_cache_dir" not in config_updates
    assert cache.cache_dir() == path


class _Dev:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("stats,limit", [
    (None, memory.FALLBACK_BYTES),               # CPU: no stats at all
    ({}, memory.FALLBACK_BYTES),                 # stats without a limit
    ({"bytes_limit": 60 << 30}, 60 << 30),       # a GPU's allocator limit
])
def test_budget_from_device_limit(monkeypatch, stats, limit):
    monkeypatch.setattr(jax, "devices", lambda: [_Dev(stats)])
    assert memory.device_bytes_limit() == limit
    assert memory.budget_bytes(0.5) == limit // 2


def test_cpu_backend_reports_no_limit():
    assert memory.device_bytes_limit() == memory.FALLBACK_BYTES
