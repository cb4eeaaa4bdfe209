"""Placement of JAX's persistent compilation cache
(muchsalsa_tpu/utils/compile_cache.py)."""

import re
from pathlib import Path

import jax
import pytest

from muchsalsa_tpu.utils import compile_cache

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def restore_cache_config():
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    jax.config.update("jax_compilation_cache_dir", saved[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])


@pytest.fixture
def gpu_backend(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")


def test_env_var_is_honoured(tmp_path, monkeypatch, restore_cache_config,
                             gpu_backend):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert compile_cache.enable_compile_cache() == tmp_path / "c"
    assert jax.config.jax_compilation_cache_dir == str(tmp_path / "c")
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 0


def test_default_is_fixed_in_checkout(monkeypatch, restore_cache_config,
                                      gpu_backend):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == REPO / ".jax_cache"
    assert jax.config.jax_compilation_cache_dir == str(REPO / ".jax_cache")
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().splitlines()


def test_cpu_backend_is_left_alone(monkeypatch, restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir == before


def test_no_other_cache_directory_is_set():
    """Only the helper names a compile-cache directory; nothing else in
    the program, its scripts or its benchmark sets one."""
    pattern = re.compile(
        r"jax_compilation_cache_dir|JAX_COMPILATION_CACHE_DIR\"?\s*[,\]]?\s*=|"
        r"setdefault\(\s*\"JAX_COMPILATION_CACHE_DIR\"|set_cache_dir")
    sources = [p for p in REPO.glob("*.py")]
    for sub in ("muchsalsa_tpu", "scripts"):
        sources += list((REPO / sub).rglob("*.py"))
    setters = sorted(str(p.relative_to(REPO)) for p in sources
                     if pattern.search(p.read_text()))
    assert setters == ["muchsalsa_tpu/utils/compile_cache.py"]
