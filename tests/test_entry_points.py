"""Entry points: chip_smoke's device gate and the compile-cache placement
shared by the CLI, the benchmarks and chip_smoke."""

import os
import subprocess
import sys

import jax
import pytest

import chip_smoke
from fries_tpu import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_chip_smoke_device_gate_refuses_cpu(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.device_gate()
    assert exc.value.code == 2
    out = capsys.readouterr().out
    assert "FAIL" in out and '"ok"' not in out


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_uses_variable_when_set(monkeypatch, tmp_path,
                                              restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_compile_cache_defaults_to_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(REPO, ".jax_cache")
    assert compile_cache.enable() == want
    assert jax.config.jax_compilation_cache_dir == want


def test_chip_smoke_exits_nonzero_without_gpu(tmp_path):
    """Run as the driver runs it, on a host whose JAX has no GPU."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
