"""chip_smoke.py: its phases at tiny sizes on the CPU, and its refusal to
run (non-zero exit, no result line) anywhere but on a GPU."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


@pytest.fixture(scope="module")
def small():
    data, queries = cs.make_data(3000, 16, 40, seed=7)
    return data, queries, cs.brute_force(data, queries, cs.K, chunk=16)


def test_main_refuses_the_cpu():
    with pytest.raises(cs.PhaseFailed, match="not 'gpu'"):
        cs.main([])


@pytest.mark.parametrize("alone", [False, True])
def test_script_exits_nonzero_without_gpu(tmp_path, alone):
    script = os.path.join(REPO, "chip_smoke.py")
    if alone:  # a directory holding chip_smoke.py and nothing else
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, env=env, cwd=tmp_path, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_brute_force_chunks_agree(small):
    from ocaml_hnsw_tpu.oracle import bruteforce_knn

    data, queries, gt = small
    np.testing.assert_array_equal(
        gt, bruteforce_knn(data, queries, cs.K, "l2")[0])


def test_phase_flat(small, capsys):
    data, queries, gt = small
    cs.phase_flat(data, queries, gt, n_bf=10)
    out = capsys.readouterr().out
    assert "engine=FlatIndex" in out and "ids_equal=True" in out


def test_phase_select(capsys):
    from ocaml_hnsw_tpu.bench.datasets import queries_like

    data, _ = cs.make_data(20000, 16, 1, seed=7)
    cs.phase_select(data, queries_like(data, 64, seed=3), k=8, n_check=16)
    out = capsys.readouterr().out
    assert "[select]" in out and "[precision]" in out


def test_phase_check_fails_loudly():
    with pytest.raises(cs.PhaseFailed):
        cs.check(False, "boom")


@pytest.mark.gpu
def test_select_phase_on_the_card():
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; run python chip_smoke.py there")
    from ocaml_hnsw_tpu.bench.datasets import queries_like

    data, _ = cs.make_data(200_000, 128, 1, seed=7)
    cs.phase_select(data, queries_like(data, 1024, seed=3))
