#!/usr/bin/env python
"""Probe: would CONTEXT MIXING give L4 real value on small corpora?
(round-4 VERDICT next #6, deferred since round 2.)

Background: L4's order-11 SEQ table cannot warm on <= 2k-read corpora,
so format v5 falls back to order 10 per block (effective_seq_order) and
L4 degenerates to L3 there. The mixing idea: code each SEQ bit under a
blend of the order-11 and order-10 node probabilities (both tables
updated by the frozen law) so the high-order table contributes once
warm without paying its cold-start cost.

Method (oracle-side, CPU, size-only — a cost model, not a real coder):
walk the actual SEQ coding schedule of each small corpus with BOTH
context models side by side, charge each bit -log2(p_eff) for the
variant's effective probability, and update both tables with the real
collision-capped/warm-up law (ranger_np.table_mark/table_update). The
range coder adds only lane-constant overhead (flush bytes), identical
across variants, so cost deltas here are what container deltas would
be.

Variants:
  o10   — order-10 alone (what v5's fallback ships today at L4)
  o11   — order-11 alone (what pre-fallback L4 did; loses on cold data)
  mix   — p = (p10 + p11) / 2
  gate  — p = p11 if the order-11 entry was visited before else p10
  lmix  — logistic-domain average (stretch/squash), the PAQ-style blend

MEASURED RESULT (2026-08-20, SEQ-stream bytes vs the shipped o10
fallback; adoption bar >= 2% on the small corpora):

  illumina n=500:   o11 +1.09%  mix +0.41%  gate -0.08%  lmix +0.32%
  novaseq  n=500:   o11 +0.22%  mix +0.01%  gate -0.19%  lmix -0.03%
  nheavy   n=500:   o11 +1.84%  mix +0.74%  gate +0.13%  lmix +0.60%
  sra      n=500:   o11 +1.09%  mix +0.41%  gate -0.08%  lmix +0.32%
  illumina n=16384: o11 -4.31%  mix -3.08%  gate -4.82%  lmix -3.51%

Conclusion: mixing LOSES at small scale. Plain and logistic averaging
are dragged by the cold order-11 estimate; the visit-gated blend is
the only variant that ever beats the fallback and its best small-corpus
gain is -0.19% — 10x under the adoption bar — while adding a per-bit
visit-count gather + select to the device hot loop (a compile-cliff
risk per docs/KERNEL_NOTES.md §3). At 16k reads `gate` would buy ~0.5%
of SEQ over the shipped order-11 — also not worth the kernel change.
The v5 per-block order fallback (effective_seq_order) stays.
"""
import math
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

from slimfastq_tpu.config import config_for_level  # noqa: E402
from slimfastq_tpu.ops import ranger_np as R  # noqa: E402
from slimfastq_tpu.ops import streams_np as SNP  # noqa: E402
from slimfastq_tpu.pipeline import stream_jobs  # noqa: E402
from slimfastq_tpu.utils.fastq import parse_fastq_bytes  # noqa: E402
from slimfastq_tpu.utils.synth import corpus  # noqa: E402

U32 = np.uint32
I32 = np.int32
_L2 = np.log2(np.arange(1, R.PROB_ONE + 1) / R.PROB_ONE)


def _bit_cost(p, bit, active):
    """-log2 cost of coding `bit` under P(bit=0) = p/4096, active lanes."""
    c0 = -_L2[np.clip(p, R.PROB_MIN, R.PROB_MAX) - 1]
    c1 = -_L2[R.PROB_ONE - np.clip(p, R.PROB_MIN, R.PROB_MAX) - 1]
    return float(np.where(active, np.where(bit.astype(bool), c1, c0),
                          0.0).sum())


_ST = None


def _stretch_tables():
    global _ST
    if _ST is None:
        x = np.arange(1, R.PROB_ONE) / R.PROB_ONE
        st = np.log(x / (1 - x))
        _ST = st
    return _ST


def seq_cost(syms, counts, pos, reset, geos, mode):
    """Total SEQ bit cost (bytes) coding through `mode` over the given
    context geometries (first = low order, second = high order)."""
    S, W = syms.shape
    syms = syms.astype(U32)
    Sp = R.pad_steps(S)
    counts = np.asarray(counts)
    tables = [R.table_init(g.table_size, g.sac_base) for g in geos]
    vtables = [np.zeros(g.table_size, dtype=I32)
               if 0 < getattr(g, "rate_lo", 0) < g.rate else None
               for g in geos]
    ctxers = [SNP.SeqCtx(g, W) for g in geos]
    z = np.zeros(W, dtype=U32)
    depth = geos[0].depth
    st = _stretch_tables()
    cost = 0.0
    for t in range(Sp):
        active = counts > t
        p_t = pos[t] if t < S else z
        r_t = reset[t] if t < S else z
        ctxs = []
        for ct, g in zip(ctxers, geos):
            c = ct.step_ctx(t, p_t, r_t)
            ctxs.append(np.where(active, c, U32(g.num_ctx)))
        sym = np.where(active, syms[t], 0).astype(U32) if t < S else z
        nodes_ = [ctx.astype(np.int64) * ((1 << depth) - 1)
                  for ctx in ctxs]
        node = np.ones(W, dtype=np.int64)
        for i in range(depth - 1, -1, -1):
            bit = ((sym >> U32(i)) & U32(1)).astype(U32)
            ps, markeds, idxs, viss = [], [], [], []
            for k, g in enumerate(geos):
                idx = nodes_[k] + node - 1
                R.table_mark(tables[k], idx, g.sac_base)
                marked = tables[k][idx]
                p = np.clip(marked & I32((1 << R.CNT_SHIFT) - 1),
                            R.PROB_MIN, R.PROB_MAX)
                idxs.append(idx)
                markeds.append(marked)
                ps.append(p.astype(np.int64))
                viss.append(vtables[k][idx]
                            if vtables[k] is not None else None)
            if mode == "lo":
                p_eff = ps[0]
            elif mode == "hi":
                p_eff = ps[1]
            elif mode == "mix":
                p_eff = (ps[0] + ps[1]) >> 1
            elif mode == "gate":
                cold = (viss[1] if viss[1] is not None
                        else np.zeros(W, dtype=I32)) == 0
                p_eff = np.where(cold, ps[0], ps[1])
            elif mode == "lmix":
                # logistic-domain average of x = P(bit==0) = p/4096:
                # stretch both, mean, squash back (sigmoid)
                sa = st[np.clip(ps[0], 1, R.PROB_ONE - 1) - 1]
                sb = st[np.clip(ps[1], 1, R.PROB_ONE - 1) - 1]
                m = (sa + sb) / 2
                p_eff = np.clip((R.PROB_ONE * (np.exp(m)
                                               / (1 + np.exp(m)))
                                 ).astype(np.int64),
                                R.PROB_MIN, R.PROB_MAX)
            cost += _bit_cost(p_eff, bit, active)
            for k, g in enumerate(geos):
                R.table_update(tables[k], idxs[k], markeds[k], bit,
                               g.rate, g.sac_base, vtable=vtables[k],
                               rate_lo=getattr(g, "rate_lo", 0))
            node = 2 * node + bit.astype(np.int64)
        for ct in ctxers:
            ct.advance(sym)
    return cost / 8.0


def main():
    from dataclasses import replace
    specs = [("illumina", 500), ("novaseq", 500), ("nheavy", 500),
             ("sra", 500), ("illumina", 16384)]
    cfg = config_for_level(4, lanes=32, aux_lanes=8, block_records=65536)
    g11 = replace(cfg.seq, match_bits=0)
    assert g11.order == 11, g11
    g10 = replace(g11, order=10)
    print(f"L4 seq geometry: o11 rate={g11.rate} rate_lo={g11.rate_lo}; "
          "modes: o10(=v5 fallback) o11 mix gate lmix")
    for name, n in specs:
        data = corpus(name, n, seed=1)
        batch = parse_fastq_bytes(data)
        jobs, _, _, _, _ = stream_jobs(batch, cfg)
        _, _, syms, counts, pos, reset = jobs["SEQ"]
        res = {}
        for mode, geos in (("o10", [g10, g10]), ("o11", [g10, g11]),
                           ("mix", [g10, g11]), ("gate", [g10, g11]),
                           ("lmix", [g10, g11])):
            m = {"o10": "lo", "o11": "hi"}.get(mode, mode)
            res[mode] = seq_cost(syms, counts, pos, reset, geos, m)
        base = res["o10"]
        print(f"{name:9s} n={n:6d} SEQ bytes: " + "  ".join(
            f"{k}={v:9.0f} ({(v-base)/base*100:+5.2f}%)"
            for k, v in res.items()))


if __name__ == "__main__":
    main()
