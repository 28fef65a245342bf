"""utils/compile_cache.py: where JAX's persistent compile cache goes."""

import jax
import pytest

from turbosqueeze_tpu.utils import compile_cache


@pytest.fixture
def cache_config(monkeypatch):
    """Leave jax_compilation_cache_dir as it was, whatever a test sets."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_dir_is_left_to_jax(cache_config, monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path / "env")
    assert jax.config.jax_compilation_cache_dir == before


def test_checkout_dir_without_env(cache_config, monkeypatch, tmp_path):
    monkeypatch.setattr(compile_cache, "CHECKOUT", tmp_path)
    want = tmp_path / ".benchdata" / "jaxcache"
    assert compile_cache.enable_compile_cache() == str(want)
    assert want.is_dir()
    assert jax.config.jax_compilation_cache_dir == str(want)


def test_unwritable_checkout_runs_without_cache(cache_config, monkeypatch,
                                                tmp_path, capsys):
    # a checkout path below a regular file cannot be created, even by root
    # (for whom a read-only mode is no bar)
    blocker = tmp_path / "site-packages"
    blocker.write_bytes(b"")
    monkeypatch.setattr(compile_cache, "CHECKOUT", blocker / "pkg")
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir == before
    assert capsys.readouterr().err.count("no persistent compile cache") == 1


def test_cli_device_backend_on_unwritable_checkout(cache_config, monkeypatch,
                                                   tmp_path, capsys):
    from turbosqueeze_tpu import cli
    from turbosqueeze_tpu.runtime import native

    blocker = tmp_path / "site-packages"
    blocker.write_bytes(b"")
    monkeypatch.setattr(compile_cache, "CHECKOUT", blocker / "pkg")
    data = b"abcabcabd" * 5000
    src, tsq, out = tmp_path / "in", tmp_path / "in.tsq", tmp_path / "out"
    src.write_bytes(data)
    assert cli.main(["--backend", "device", "c", str(src), str(tsq)]) == 0
    assert cli.main(["--backend", "device", "d", str(tsq), str(out)]) == 0
    assert tsq.read_bytes() == native.compress(data, True, level=0)
    assert out.read_bytes() == data
