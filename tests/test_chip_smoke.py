"""chip_smoke.py on CPU: its phases pass at a tiny size, and the script
refuses to run (non-zero exit, no ok line) without a GPU or without the
rest of the repo."""

import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke
from slimfastq_tpu.utils.synth import corpus

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "chip_smoke.py")


def _run(cwd, env):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=600)


def test_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = _run(ROOT, env)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_fails_alone_in_a_directory(tmp_path):
    shutil.copy(SCRIPT, tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = _run(tmp_path, env)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("phase", ["cli", "levels", "golden", "sharded",
                                   "spans"])
def test_phase_passes_on_cpu_at_tiny_size(phase, tmp_path, monkeypatch):
    if phase == "cli":
        out = chip_smoke.check_cli(corpus("illumina", 300, seed=1), 128,
                                   str(tmp_path))
        assert out["container"][:4] == b"SFQT"
    elif phase == "levels":
        out = chip_smoke.check_level(corpus("novaseq", 3072, seed=3), 4,
                                     need_match=True, lanes=64,
                                     aux_lanes=16, block_records=1536)
        assert any(out["match_used"])
    elif phase == "golden":
        chip_smoke.check_golden(levels=(2, 3))
    elif phase == "spans":
        # 64k-record blocks decode one at a time; tiny blocks would be
        # batched through the multi-block kernels unless told otherwise
        monkeypatch.setenv("SFQ_BATCH_BLOCKS", "1")
        out = chip_smoke.coder_spans(corpus("illumina", 256, seed=4), 256)
        assert out["sfq.encode.qual.coder"][0] == 1
        assert out["sfq.decode.seq.coder"][1] > 0
    else:
        out = chip_smoke.check_sharded(corpus("illumina", 2 * 4 * 96 + 40,
                                              seed=2), 96, 4, str(tmp_path))
        assert set(out["placements"]) == {"encode", "decode"}


def test_phase_failure_is_not_swallowed(monkeypatch):
    """A byte difference raises out of the phase (and so out of main)."""
    from slimfastq_tpu import api
    real = api.encode_fastq

    def corrupt(data, *a, **k):
        out = bytearray(real(data, *a, **k))
        out[-1] ^= 1
        return bytes(out)
    monkeypatch.setattr(api, "encode_fastq", corrupt)
    monkeypatch.setattr(api, "decode_fastq", lambda *a, **k: b"")
    with pytest.raises(RuntimeError, match="check failed"):
        chip_smoke.check_golden(levels=(3,))
