"""Compile-cache placement: JAX_COMPILATION_CACHE_DIR wins, else a fixed
directory in the checkout."""

import os

import jax
import pytest

from video_codecs_tpu.utils import jax_cache


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_dir_is_left_to_jax(monkeypatch, tmp_path, restore_cache_dir):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(jax_cache.ENV, str(tmp_path))
    assert jax_cache.enable() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_unset_env_uses_checkout_dir(monkeypatch, restore_cache_dir):
    monkeypatch.delenv(jax_cache.ENV, raising=False)
    got = jax_cache.enable()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert got == os.path.join(repo, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got
