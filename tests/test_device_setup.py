"""Process set-up: where the persistent compile cache lives, and the smoke
test's refusal to run without a GPU."""

import json
import os

import jax
import pytest

import slam_framework_tpu


def test_compile_cache_env_var_wins(monkeypatch):
    """With JAX_COMPILATION_CACHE_DIR set, the package sets no directory:
    JAX reads the variable itself."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/x")
    monkeypatch.delenv("SLAM_NO_COMPILE_CACHE", raising=False)
    assert slam_framework_tpu.compile_cache_dir() is None


def test_compile_cache_fixed_path_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.delenv("SLAM_NO_COMPILE_CACHE", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(slam_framework_tpu.__file__)))
    assert slam_framework_tpu.compile_cache_dir() == os.path.join(repo, ".jax_cache")


def test_chip_smoke_refuses_cpu_backend(capsys):
    import chip_smoke

    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    out = capsys.readouterr().out
    assert '"ok"' not in out
    for line in out.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)
