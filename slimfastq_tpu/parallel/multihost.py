"""Multi-host support (BASELINE.json config #5).

Blocks are fully independent (own adaptive state, delta chains reset per
block — see pipeline.py), so the multi-host strategy is embarrassingly
parallel and bit-exactly equal to a single-host run:

1. ``jax.distributed.initialize()`` (one process per host).
2. Every process takes the record ranges of its assigned blocks
   (``process_block_ranges`` — a *contiguous* run of blocks per process,
   so concatenating shards in process order reproduces global block
   order) and encodes them on its local devices (``parallel.sharded``
   within the host).
3. Each host writes its blocks to a shard container; host 0 (or any
   later job) merges shards with ``merge_containers`` in process order —
   a byte-level block concatenation + index rebuild, no re-encoding —
   yielding a container byte-identical to a single-host run.

Failure recovery: a lost host's blocks are just re-encoded anywhere
(SURVEY.md §5); ``container.Writer.resume`` handles partially written
shards.

The merge path and range assignment are fully tested single-process; the
``initialize`` glue requires a real multi-host slice.
"""

from __future__ import annotations

import io

from .. import container


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Thin wrapper over jax.distributed.initialize.

    With explicit arguments a failure RAISES (a multi-host run degrading
    silently to single-process was a round-1 finding); with no arguments it
    attempts env-based auto-detection and quietly stays single-process only
    when no coordinator is configured.

    Must be called before any jax computation (jax.distributed rule), so
    the already-initialised check must NOT touch the backend — re-calling
    after a successful init returns quietly."""
    import jax
    try:  # non-initialising "already distributed?" probe
        from jax._src import distributed as _dist
        if getattr(_dist.global_state, "client", None) is not None:
            return  # already initialised
    except (ImportError, AttributeError):  # private layout changed: fall
        pass             # through; the double-init RuntimeError covers it
    if coordinator_address is not None:
        if (num_processes is None or process_id is None
                or not 0 <= process_id < num_processes):
            raise ValueError(
                f"invalid distributed config: process_id={process_id} "
                f"num_processes={num_processes}")
        try:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes, process_id=process_id)
        except RuntimeError as e:
            if "already" in str(e) or "once" in str(e):
                return
            raise
        return
    import os
    auto = any(k in os.environ for k in
               ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS"))
    if not auto:
        return  # single-process run: nothing to initialise
    jax.distributed.initialize()


def process_block_ranges(total_records: int, block_records: int,
                         num_processes: int, process_id: int
                         ) -> list[tuple[int, int]]:
    """CONTIGUOUS assignment of blocks to processes (process p owns one
    run of consecutive blocks; sizes differ by at most one block), so that
    per-host shard containers concatenated in process order reproduce the
    global block order byte-for-byte. Every block boundary is a multiple
    of block_records, so per-process encoding is bit-identical to the same
    blocks of a single-process run."""
    n_blocks = max((total_records + block_records - 1) // block_records, 0)
    base, rem = divmod(n_blocks, num_processes)
    first = process_id * base + min(process_id, rem)
    count = base + (1 if process_id < rem else 0)
    out = []
    for b in range(first, first + count):
        lo = b * block_records
        hi = min(lo + block_records, total_records)
        out.append((lo, hi))
    return out


def merge_containers(shard_bytes: list[bytes]) -> bytes:
    """Merge per-host shard containers (listed in process order; each shard
    holds a contiguous run of global blocks per ``process_block_ranges``)
    into one container — byte-level block concatenation + index rebuild.
    O(total bytes): block extents come from each shard's index (blocks are
    stored contiguously between the header and the index), with no
    per-block re-parsing.

    All shards must share an identical header (same config/level)."""
    if not shard_bytes:
        raise ValueError("no shards to merge")
    headers = []
    all_offsets = []
    out = io.BytesIO()
    for i, sb in enumerate(shard_bytes):
        f = io.BytesIO(sb)
        cfg = container.read_header(f)
        if cfg.fmt != container.VERSION:
            # v1 shards have a different index tail layout; shards are
            # always produced by the current encoder, so reject clearly
            # rather than misparse (mirrors Writer.resume).
            raise ValueError(
                f"shard {i} is format v{cfg.fmt}; merge_containers only "
                f"accepts current-format (v{container.VERSION}) shards")
        header_end = f.tell()
        hdr = sb[:header_end]
        headers.append(hdr)
        if hdr != headers[0]:
            raise ValueError("shard headers differ; cannot merge")
        offsets = container.read_index(f)
        if i == 0:
            out.write(hdr)
        if not offsets:
            continue
        index_start = len(sb) - container.index_size(len(offsets))
        bounds = list(offsets) + [index_start]
        for j, off in enumerate(offsets):
            all_offsets.append(out.tell())
            out.write(sb[off:bounds[j + 1]])
    container.write_index(out, all_offsets)
    return out.getvalue()


def merge_container_files(shard_paths: list[str], out_path: str) -> None:
    shards = []
    for p in shard_paths:
        with open(p, "rb") as f:
            shards.append(f.read())
    merged = merge_containers(shards)
    with open(out_path, "wb") as f:
        f.write(merged)
