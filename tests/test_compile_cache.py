"""Placement of JAX's persistent compilation cache."""

import jax
import pytest

from warmup_fir_filter_tpu.utils import compile_cache


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_var_wins_and_nothing_is_set(monkeypatch, tmp_path,
                                         restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_checkout_jax_cache(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = compile_cache.enable_compile_cache()
    root = compile_cache.DEFAULT_DIR.parent
    assert got == str(root / ".jax_cache")
    assert (root / "warmup_fir_filter_tpu").is_dir()
    assert jax.config.jax_compilation_cache_dir == got


def test_cli_main_enables_cache(monkeypatch, tmp_path, restore_cache_dir):
    from warmup_fir_filter_tpu import cli

    called = []
    monkeypatch.setattr(cli, "enable_compile_cache",
                        lambda: called.append(True))
    with pytest.raises(FileNotFoundError):
        cli.main(["--image-dir", str(tmp_path / "missing"),
                  "--artifact-root", str(tmp_path / "a")])
    assert called == [True]
