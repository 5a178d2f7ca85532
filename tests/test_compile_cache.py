"""Compile-cache location: JAX_COMPILATION_CACHE_DIR wins and nothing is
set in code; otherwise one fixed, git-ignored directory in the checkout."""

import jax

from pmv_tpu.utils import compile_cache


def test_env_variable_wins_and_nothing_is_set(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_fixed_directory_in_the_checkout(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        got = compile_cache.enable()
        assert got == str(compile_cache.DEFAULT_DIR)
        assert jax.config.jax_compilation_cache_dir == got
        assert compile_cache.DEFAULT_DIR.name == ".jax_cache"
        gitignore = (compile_cache.DEFAULT_DIR.parent / ".gitignore").read_text()
        assert ".jax_cache/" in gitignore.split()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
