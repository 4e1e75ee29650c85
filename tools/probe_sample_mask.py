#!/usr/bin/env python
"""Probe: the v5 matcher's seed-sampling density (SAMPLE_MASK) ratio vs
speed trade-off. Encoder policy only — decode reads explicit
descriptors, so this knob never affects decodability.

Measured on 8k-read probe corpora + the 64k 8x-coverage bench block
(match_find time relative to mask=7, quiet 4-core host):

  mask= 7 (1/8):  match_find  1.00x  (the round-4 frozen default)
  mask=15 (1/16): match_find  0.62x  container +0.157..0.226%
  mask=31 (1/32): match_find  0.46x  container +1.131..1.550%

mask=15 was adopted as the round-5 default: -38% match time for ~0.2%
size on every probed corpus (the sfq-4-vs-xz-6 margins are 8-27%, so
nothing flips). mask=31's >1% cost is visible; rejected.

Usage: python tools/probe_sample_mask.py [masks...]
"""
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

_CHILD = """
import sys, time
import numpy as np
from slimfastq_tpu import native
from slimfastq_tpu.api import encode_fastq
from slimfastq_tpu.utils.synth import corpus
pc = time.perf_counter
res = []
for name in ("novaseq", "illumina", "sra"):
    data = corpus(name, 8192, seed=4)
    enc = encode_fastq(data, level=4, lanes=1024, aux_lanes=64,
                       block_records=65536)
    res.append((name, len(data), len(enc)))
data = corpus("illumina", 65536, seed=0)
enc = encode_fastq(data, level=4, lanes=1024, aux_lanes=64,
                   block_records=65536)
res.append(("bench64k", len(data), len(enc)))
db = np.frombuffer(data, dtype=np.uint8)
idx, n = native.fastq_index(db)
best = 1e9
for _ in range(4):
    t0 = pc()
    native.match_find_arrays(db, idx["seq_off"][:n],
                             idx["seq_len"][:n].astype(np.int64), 48)
    best = min(best, pc() - t0)
print(repr((res, best)))
"""


def main():
    masks = [int(a) for a in sys.argv[1:]] or [7, 15, 31]
    out = {}
    for mask in masks:
        r = subprocess.run(
            [sys.executable, "-c", _CHILD], capture_output=True,
            text=True, env=dict(os.environ, JAX_PLATFORMS="cpu",
                                SFQ_MATCH_SAMPLE_MASK=str(mask)))
        if r.returncode != 0:
            print(f"mask={mask} FAILED:\n{r.stderr[-400:]}")
            continue
        out[mask] = eval(r.stdout.strip().splitlines()[-1])
    base = out[min(out)][0]
    for mask in sorted(out):
        res, best = out[mask]
        rows = "  ".join(f"{n}:{raw/c:.4f}x" for n, raw, c in res)
        print(f"mask={mask:3d} match_find={best*1e3:6.1f} ms  {rows}")
        if mask != min(out):
            d = "  ".join(f"{n}:{(c-bc)/bc*100:+.3f}%"
                          for (n, _, c), (_, _, bc) in zip(res, base))
            print(f"          container delta vs mask{min(out)}: {d}")


if __name__ == "__main__":
    main()
