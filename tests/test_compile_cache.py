"""Placement of JAX's persistent compilation cache (compile_cache)."""

import os

import jax

from slimfastq_tpu import compile_cache


def _record_updates(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    return calls


def test_env_var_is_honoured(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = _record_updates(monkeypatch)
    assert compile_cache.cache_dir() == str(tmp_path)
    assert compile_cache.enable() == str(tmp_path)
    assert calls == []          # JAX reads the variable itself


def test_default_is_the_fixed_checkout_path(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = _record_updates(monkeypatch)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(repo, ".jax_cache")
    assert compile_cache.cache_dir() == want
    assert compile_cache.enable() == want
    assert calls == [("jax_compilation_cache_dir", want)]
