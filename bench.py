#!/usr/bin/env python
"""Benchmark: sfq encode+decode wall clock on one NVIDIA GPU.

    python bench.py                   # 64k-record x 100 bp blocks, level 3
    python bench.py table             # the four shapes of SHAPES
    python bench.py --blocks 4 --repeats 5

Everything runs in this one process, the only one that uses the card. For
each shape the input is generated from a seed (utils/synth: Illumina-like
100 bp reads), every kernel shape is compiled by one warm-up run, and then
``--repeats`` timed runs of the real ``api.encode_fastq`` and
``api.decode_fastq`` with the ``streams_jax`` backend follow. Both return
host bytes, so a timed run ends only when the device work and the copies
back are done. Each run is checked: the decode must equal the input.

One JSON line per shape gives the median, minimum and maximum seconds of
each direction, the sample count, the end-to-end rate (2 x raw bytes over
the sum of the two medians), the compressed size, and the device as JAX
reports it beside the card's name and power limit. The script fails when
JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

# (records per block, read length, level)
SHAPES = ((16384, 100, 3), (65536, 100, 3), (65536, 100, 1),
          (65536, 100, 4))


def run_shape(reads: int, read_len: int, level: int, blocks: int,
              repeats: int) -> dict:
    from slimfastq_tpu.api import decode_fastq, encode_fastq
    from slimfastq_tpu.ops import streams_jax
    from slimfastq_tpu.utils.synth import synth_fastq

    data = synth_fastq(reads * blocks, read_len=read_len, seed=0,
                       var_len=False, n_rate=0.0005)
    kw = dict(level=level, backend=streams_jax, lanes=1024, aux_lanes=64,
              block_records=reads)
    t0 = time.perf_counter()
    enc = encode_fastq(data, **kw)
    if decode_fastq(enc, backend=streams_jax) != data:
        raise RuntimeError("warm-up round trip mismatch")
    warm_s = time.perf_counter() - t0
    es, ds = [], []
    for _ in range(repeats):
        t0 = time.perf_counter()
        enc = encode_fastq(data, **kw)
        t1 = time.perf_counter()
        out = decode_fastq(enc, backend=streams_jax)
        t2 = time.perf_counter()
        if out != data:
            raise RuntimeError("round trip mismatch")
        es.append(t1 - t0)
        ds.append(t2 - t1)
    e_med, d_med = statistics.median(es), statistics.median(ds)
    return {
        "reads_per_block": reads, "read_len": read_len, "level": level,
        "blocks": blocks, "raw_bytes": len(data),
        "compressed_bytes": len(enc), "ratio": len(data) / len(enc),
        "samples": repeats, "warmup_s": warm_s,
        "encode_s": {"median": e_med, "min": min(es), "max": max(es)},
        "decode_s": {"median": d_med, "min": min(ds), "max": max(ds)},
        "gbps": 2 * len(data) / (e_med + d_med) / 1e9,
    }


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("table", nargs="?", choices=["table"],
                   help="run every shape of SHAPES")
    p.add_argument("--blocks", type=int, default=4)
    p.add_argument("--repeats", type=int, default=5)
    args = p.parse_args(argv)

    from slimfastq_tpu import compile_cache
    from slimfastq_tpu.utils import device
    compile_cache.enable()
    device.require_gpu()
    dev, card = device.describe(), device.card()
    shapes = SHAPES if args.table else ((65536, 100, 3),)
    for reads, read_len, level in shapes:
        row = run_shape(reads, read_len, level, args.blocks, args.repeats)
        row.update(device=dev, card=card)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
