"""Entry points: the compile-cache helper, and the GPU-only scripts refusing
to run (or print a result) on any other backend."""

import os
import sys
from pathlib import Path

import jax
import pytest

from ntt_aie.utils import compile_cache

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


@pytest.fixture
def config_updates(monkeypatch):
    """Record jax.config.update calls instead of applying them."""
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    return calls


def test_compile_cache_honours_env(monkeypatch, config_updates):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
    assert compile_cache.enable_compile_cache() == "/some/where"
    assert config_updates == []  # JAX reads the variable itself


def test_compile_cache_defaults_to_checkout(monkeypatch, config_updates):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == str(ROOT / ".jax_cache")
    assert config_updates == [("jax_compilation_cache_dir", path)]
    # the same fixed path on every call: no temp name, pid or time
    assert compile_cache.enable_compile_cache() == path


def test_chip_smoke_refuses_cpu(capsys):
    import chip_smoke

    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_bench_refuses_cpu(capsys, config_updates):
    import bench

    assert bench.main() != 0
    assert capsys.readouterr().out == ""


def test_graft_entry_requires_devices():
    import __graft_entry__ as ge

    with pytest.raises(RuntimeError, match="need 1000 devices"):
        ge._require_devices(1000)
