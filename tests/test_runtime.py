"""Process runtime: where the persistent compilation cache lives, and the
device record every measurement carries."""

import os

import jax

import exemplars_vc_tpu.runtime as rt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_dir_honours_jax_env(tmp_path, monkeypatch):
    """With JAX_COMPILATION_CACHE_DIR set, that directory is the cache and
    nothing is set in code."""
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
    assert rt.enable_persistent_compilation_cache() == str(tmp_path / "cc")
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_dir_default_is_fixed_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        got = rt.enable_persistent_compilation_cache()
        assert got == os.path.join(REPO, ".jax_cache") == rt.DEFAULT_CACHE_DIR
        assert jax.config.jax_compilation_cache_dir == got
        # idempotent, and the same path on every call
        assert rt.enable_persistent_compilation_cache() == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_cache_dir_is_ignored_by_git():
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_device_record_on_cpu():
    rec = rt.device_record()
    assert rec["platform"] == "cpu" and rec["count"] == len(jax.devices())
    assert isinstance(rec["kind"], str)


def test_require_gpu_refuses_cpu():
    import pytest

    with pytest.raises(SystemExit, match="no GPU"):
        rt.require_gpu()
