"""Where the persistent compilation cache lives (utils/compile_cache.py)."""

from __future__ import annotations

import os

import pytest

from image_denoising_filter.utils import compile_cache

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cache_config(monkeypatch):
    """Record jax.config.update calls instead of applying them."""
    import jax

    calls = {}
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.__setitem__(k, v))
    return calls


def test_default_dir_is_inside_the_checkout(monkeypatch):
    """Without JAX_COMPILATION_CACHE_DIR the cache is a fixed directory in
    the checkout (listed in .gitignore), never one under the home dir."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache.cache_dir() == os.path.join(_REPO, ".jax_cache")
    with open(os.path.join(_REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_env_var_wins_and_nothing_else_is_set(monkeypatch, tmp_path, cache_config):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it itself: enable()
    creates it and sets no other cache location in code."""
    target = tmp_path / "jaxcache"
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(target))
    assert compile_cache.enable() == str(target)
    assert target.is_dir()
    assert "jax_compilation_cache_dir" not in cache_config
    assert cache_config["jax_persistent_cache_min_compile_time_secs"] == 1.0


def test_enable_sets_the_default_dir(monkeypatch, tmp_path, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(compile_cache, "DEFAULT_DIR", str(tmp_path / "c"))
    assert compile_cache.enable() == str(tmp_path / "c")
    assert cache_config["jax_compilation_cache_dir"] == str(tmp_path / "c")


def test_enable_does_not_swallow_failures(monkeypatch, tmp_path):
    """A cache directory that cannot be created is an error, not a silent
    run without the cache."""
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(blocker / "sub"))
    with pytest.raises(OSError):
        compile_cache.enable()
