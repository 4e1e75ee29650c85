"""The native library cache key: a library is reused only when the
source, the compiler flags and the host CPU all match."""

import os

from slimfastq_tpu import native


def test_build_key_depends_on_source_flags_and_cpu():
    base = native.build_key(b"src", ("-O3",), "cpu A")
    assert base == native.build_key(b"src", ("-O3",), "cpu A")
    assert base != native.build_key(b"src2", ("-O3",), "cpu A")
    assert base != native.build_key(b"src", ("-O2",), "cpu A")
    assert base != native.build_key(b"src", ("-O3",), "cpu B")


def test_cpu_identity_is_stable():
    assert native.cpu_identity() == native.cpu_identity()
    assert native.cpu_identity()


def _fake_compiler(monkeypatch):
    calls = []

    def run(cmd, **_kw):
        calls.append(cmd)
        with open(cmd[cmd.index("-o") + 1], "wb") as f:
            f.write(b"built")

        class R:
            returncode = 0
        return R()
    monkeypatch.setattr(native.subprocess, "run", run)
    return calls


def test_matching_key_reuses_the_library(monkeypatch, tmp_path):
    calls = _fake_compiler(monkeypatch)
    first = native._build(str(tmp_path))
    assert len(calls) == 1 and os.path.exists(first)
    assert native._build(str(tmp_path)) == first
    assert len(calls) == 1          # no second compile


def test_mismatched_key_rebuilds(monkeypatch, tmp_path):
    calls = _fake_compiler(monkeypatch)
    first = native._build(str(tmp_path))
    monkeypatch.setattr(native, "cpu_identity", lambda: "another cpu")
    second = native._build(str(tmp_path))
    assert second != first and os.path.exists(second)
    assert len(calls) == 2
    assert os.path.basename(first) in os.listdir(tmp_path)
