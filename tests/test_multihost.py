"""Multi-host building blocks that are testable single-process: block
range assignment, shard merging (byte-identical to single-run), and
streaming large-file encode with resume."""

import numpy as np

from slimfastq_tpu.api import (decode_fastq, encode_fastq,
                               encode_file_streaming)
from slimfastq_tpu.config import config_for_level
from slimfastq_tpu.parallel import multihost
from slimfastq_tpu.utils.fastq import parse_fastq_bytes, serialize_fastq
from slimfastq_tpu.utils.synth import synth_fastq
import pytest

CFG = dict(lanes=32, aux_lanes=8, block_records=128)


def test_process_block_ranges():
    # contiguous runs of blocks per process, in process order
    r = multihost.process_block_ranges(1000, 128, 3, 0)
    assert r == [(0, 128), (128, 256), (256, 384)]
    allr = sum((multihost.process_block_ranges(1000, 128, 3, p)
                for p in range(3)), [])
    # complete, ordered, non-overlapping cover without sorting
    assert allr[0][0] == 0 and allr[-1][1] == 1000
    for (a, b), (c, d) in zip(allr, allr[1:]):
        assert b == c
    # per-process counts differ by at most one block
    sizes = [len(multihost.process_block_ranges(1000, 128, 3, p))
             for p in range(3)]
    assert max(sizes) - min(sizes) <= 1


@pytest.mark.slow  # stress/scale coverage; core format suite skips
def test_merge_containers_equals_single_run():
    """Per-host shards (contiguous block runs) merged in process order are
    byte-identical to a single-process whole-file encode."""
    data = synth_fastq(660, read_len=40, seed=0, var_len=True)
    single = encode_fastq(data, level=3, **CFG)

    batch = parse_fastq_bytes(data)
    from slimfastq_tpu.api import _batch_slice
    shards = []
    for p in range(3):
        ranges = multihost.process_block_ranges(len(batch), 128, 3, p)
        part = b"".join(serialize_fastq(_batch_slice(batch, lo, hi))
                        for lo, hi in ranges)
        shards.append(encode_fastq(part, level=3, **CFG))
    merged = multihost.merge_containers(shards)
    assert merged == single
    assert decode_fastq(merged) == data


@pytest.mark.slow  # stress/scale coverage; core format suite skips
def test_streaming_encode_matches_whole_file(tmp_path):
    data = synth_fastq(700, read_len=50, seed=3, var_len=True)
    src = tmp_path / "in.fastq"
    src.write_bytes(data)
    dst = tmp_path / "out.sfq"
    encode_file_streaming(str(src), str(dst), level=3,
                          chunk_bytes=7000, **CFG)
    whole = encode_fastq(data, level=3, **CFG)
    assert dst.read_bytes() == whole
    assert decode_fastq(dst.read_bytes()) == data


@pytest.mark.slow  # stress/scale coverage; core format suite skips
def test_streaming_resume(tmp_path):
    data = synth_fastq(600, read_len=50, seed=4)
    src = tmp_path / "in.fastq"
    src.write_bytes(data)
    dst = tmp_path / "out.sfq"
    # full streaming run, then truncate to simulate crash after 2 blocks
    encode_file_streaming(str(src), str(dst), level=3, **CFG)
    full = dst.read_bytes()
    import io
    from slimfastq_tpu import container
    offs = container.read_index(io.BytesIO(full))
    dst.write_bytes(full[: offs[2]])
    encode_file_streaming(str(src), str(dst), level=3, resume=True, **CFG)
    assert dst.read_bytes() == full


def test_initialize_ignores_tpu_env_keys(monkeypatch):
    """Only coordinator keys trigger auto-initialisation; TPU runtime
    keys (TPU_WORKER_HOSTNAMES, MEGASCALE_COORDINATOR_ADDRESS) do not."""
    import jax
    for k in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("TPU_WORKER_HOSTNAMES", "host-a,host-b")
    monkeypatch.setenv("MEGASCALE_COORDINATOR_ADDRESS", "host-a:8080")
    calls = []
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda *a, **k: calls.append((a, k)))
    multihost.initialize()
    assert calls == []
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "localhost:1234")
    multihost.initialize()
    assert len(calls) == 1
