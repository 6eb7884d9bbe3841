"""The platform decisions (utils/platform.py), the compile-cache helper,
the peaks table, and the measurement entry points' refusal on a CPU."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

from sparsematrixvectormultiplication_tpu.bench.peaks import (
    PEAKS,
    peak_memory_bandwidth,
)
from sparsematrixvectormultiplication_tpu.utils import platform

REPO = platform.REPO_ROOT


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit, match="no GPU found.*cpu"):
        platform.require_gpu("measurement")


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_defaults_to_repo_root(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = platform.enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert os.path.isfile(os.path.join(REPO, "chip_smoke.py"))


def test_compile_cache_env_wins(monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", "/elsewhere")
    assert platform.enable_compile_cache() == str(tmp_path)
    # the helper sets no other directory; JAX reads the variable itself
    assert jax.config.jax_compilation_cache_dir == "/elsewhere"


def test_peaks_table():
    assert peak_memory_bandwidth("NVIDIA H100 80GB HBM3") == 3.35e12
    assert all(v["memory_bytes_per_s"] > 0 for v in PEAKS.values())


def test_unknown_device_has_no_peak():
    with pytest.raises(KeyError, match="no published peak"):
        peak_memory_bandwidth("TFRT_CPU")


def _run(args, cwd=REPO):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["bench.py", "chip_smoke.py"])
def test_measurement_scripts_refuse_cpu(script):
    r = _run([script])
    assert r.returncode != 0
    assert "no GPU found" in r.stderr
    assert '"ok"' not in r.stdout and '"metric"' not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Without the package beside it the script fails and prints no
    result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], cwd=tmp_path)
    assert r.returncode != 0 and '"ok"' not in r.stdout


def test_sweep_cli_refuses_cpu_unless_forced(tmp_path):
    from sparsematrixvectormultiplication_tpu.bench.cli import main

    with pytest.raises(SystemExit, match="no GPU found"):
        main(["--suite-entry", "road_like", "--output-dir", str(tmp_path)])
