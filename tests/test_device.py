"""Device selection and the compile-cache placement."""
import os

import jax
import pytest

import unires_tpu
from unires_tpu import Settings
from unires_tpu.settings import use_device


def test_device_defaults_to_gpu_and_accepts_cuda():
    assert Settings().device == "gpu"
    assert use_device("cpu").platform == "cpu"
    # 'cuda' is the reference's spelling of 'gpu'; a host without one is an
    # error, never a silent fall-back to the CPU
    for name in ("cuda", "gpu"):
        with pytest.raises(RuntimeError, match="no gpu device"):
            use_device(name)


def test_unknown_device_raises():
    with pytest.raises(ValueError, match="unknown device"):
        use_device("metal")


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_follows_env(monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert unires_tpu._enable_compilation_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_compile_cache_defaults_into_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(root, ".jax_cache")
    assert unires_tpu._enable_compilation_cache() == want
    assert jax.config.jax_compilation_cache_dir == want
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
