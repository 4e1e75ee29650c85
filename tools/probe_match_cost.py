#!/usr/bin/env python
"""Probe: where does the v5 match search spend its time, and would
moving candidate SCORING onto the device help? (round-4 VERDICT next #2)

Runs native.match_find on the pinned bench corpus with SFQ_MATCH_STATS=1
(phase wall times + work counters printed by the C++ matcher) and prints
the derived analysis. CPU-only; run on a quiet host.

Measured verdict (64k x 100bp 8x-coverage bench corpus, 4-core host —
re-run this tool to reproduce; shares of match_find wall time):

  phases:   arena ~6% | sample ~10% | query ~54% | insert ~30%
  counters: 1,365,582 hash probes | 4,282,289 chain-entry walks |
            183,748 scorings | 59,576/64,512 reads matched

Why device scoring LOSES here (the checked-in negative result):

* Scoring is already a MINORITY cost. 183,748 m_score_mm calls at an
  average ~94-base span is ~17 MB of byte compares — the AVX2 loop does
  this inside the query phase alongside everything else. Even
  zeroing it cannot buy back more than a fraction of the query phase.
* The dominant costs are 1.37M hash-table probes and 4.3M chain walks —
  pointer-chasing over a ~16 MB index with data-dependent control flow
  (dedup, early-break, insertion-order semantics). That is the WRONG
  shape for the MXU: no matmul, no dense gather, and the index mutates
  serially between chunks (the frozen selection rule depends on
  insertion order), so the state cannot live on the device across the
  chunk loop without round-tripping every chunk.
* A device scoring pass would also split the encoder's host half around
  a device dispatch: candidates are discovered IN the probe walk, so
  shipping them out for scoring means materialising all ~4.3M candidate
  alignments (vs 184k reached after span/floor pruning — the pruning
  uses the running best, which a batched device pass cannot see),
  64 MB+ of extra traffic per block for work that is a fraction of the
  host's query phase.

What was done instead (same VERDICT item, host-side, selection
bit-identical — see git log): 8-byte index slots, two-sweep prefetched
probes, region-parallel radix insert with a raw-buffer arena, array
descriptors end-to-end, C++ MATCH-lane emission, duplicate-trial skip.
match_find time -55%; the full matcher+trials L4 overhead shrank
further via the Python-object elimination.
"""
import os
import sys
import time

os.environ["SFQ_MATCH_STATS"] = "1"
os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

from slimfastq_tpu import native  # noqa: E402
from slimfastq_tpu.utils.synth import synth_fastq  # noqa: E402


def main():
    reads = int(sys.argv[1]) if len(sys.argv) > 1 else 65536
    data_b = synth_fastq(reads, read_len=100, seed=0, var_len=False,
                         n_rate=0.0005)
    data = np.frombuffer(data_b, dtype=np.uint8)
    idx, n = native.fastq_index(data)
    seq_off = idx["seq_off"][:n]
    lengths = idx["seq_len"][:n].astype(np.int64)
    pc = time.perf_counter
    best = 1e9
    for _ in range(6):
        t0 = pc()
        arrs = native.match_find_arrays(data, seq_off, lengths, 48)
        best = min(best, pc() - t0)
    matched = int((arrs[0] >= 0).sum())
    print(f"match_find_arrays best {best*1e3:.1f} ms, "
          f"matched {matched}/{n}")
    print("(per-phase stats on stderr; see module docstring for the "
          "device-scoring analysis)")


if __name__ == "__main__":
    main()
