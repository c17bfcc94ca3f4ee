"""The persistent compilation cache helper (utils/compile_cache.py)."""

import jax
import pytest

from kss_icp.utils import compile_cache


@pytest.fixture()
def restore_cache_dir():
    saved = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", saved)


def test_unset_env_uses_fixed_checkout_dir(monkeypatch, restore_cache_dir):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    got = compile_cache.enable_compile_cache()
    want = compile_cache.CHECKOUT_CACHE_DIR
    assert got == str(want)
    assert jax.config.jax_compilation_cache_dir == str(want)
    assert want.name == ".jax_cache"
    assert want.parent == compile_cache.Path(__file__).resolve().parents[1]


def test_set_env_is_left_to_jax(monkeypatch, restore_cache_dir, tmp_path):
    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir is None


def test_checkout_cache_dir_is_git_ignored():
    gitignore = compile_cache.CHECKOUT_CACHE_DIR.parent / ".gitignore"
    assert ".jax_cache/" in gitignore.read_text().split()
