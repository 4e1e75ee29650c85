"""JAX device implementation of the lane-interleaved codec (fast path).

Byte-identical to the NumPy oracle (``streams_np``) — the equivalence suite
in tests/test_jax_equivalence.py is the gate. All coder state is
uint32/int32; no float anywhere (SURVEY.md §7 hard-part (a)).

Design:
  * The adaptive table, the coder state and, on decode, the word-packed
    payload are loop-carried values; all indexing is flat 1-D.
  * The pad-coded lockstep format (ranger_np docstring) removes every
    per-lane mask from the hot loop: padded steps code through the pinned
    sacrificial context row, so the kernel is a pure unmasked coder.
  * ENCODE precomputes the entire (table-index, bit) schedule outside the
    sequential loop (contexts are closed-form in shifted symbol arrays;
    the tree path of a known symbol is node_j = (1 << j) | (sym >> (d-j))),
    then runs chunks of K symbol-steps, emitting renorm bytes into a small
    per-chunk buffer sized to the hard worst case (3 bytes/bit-step) —
    dense scan outputs, no scatter into device memory, no overflow path.
    The chunks are then compacted into per-lane byte streams.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import ranger_np as R

U32 = jnp.uint32
I32 = jnp.int32

TOP_C = 1 << 24
BOT_C = 1 << 16
PROB_BITS = R.PROB_BITS
PROB_ONE = R.PROB_ONE
PROB_MIN = R.PROB_MIN
PROB_MAX = R.PROB_MAX

_CHUNK_SYMS = 8  # symbol-steps per emission chunk (must divide STEP_BUCKET)


def _chunk_bytes(depth: int, hard: bool) -> int:
    """Per-lane emission capacity for one chunk. The hard bound is 3 bytes
    per bit-step (32-bit state, 8-bit renorm); the optimistic bound
    (~1 byte/bit-step + slack) is almost never exceeded — the driver
    detects overflow on-device and retries with the hard build."""
    bits = _CHUNK_SYMS * depth
    b = (3 * bits + 8) if hard else (bits + 16)
    return (b + 15) // 16 * 16


# ---------------------------------------------------------------------------
# context functions
# ---------------------------------------------------------------------------

def _shift_t(x, n):
    """x[t-n] along the step axis, zero-filled (lane streams start at 0)."""
    if n == 0:
        return x
    z = jnp.zeros((n,) + x.shape[1:], x.dtype)
    return jnp.concatenate([z, x[:-n]], axis=0)


def _qdelta_code(a, b):
    """2-bit quantised q1-q2 delta (frozen format rule, config.QualGeom):
    0: equal; 1: up by <=3; 2: down by <=3; 3: |delta| > 3."""
    diff = a.astype(I32) - b.astype(I32)
    return jnp.where(diff == 0, U32(0),
                     jnp.where((diff > 0) & (diff <= 3), U32(1),
                               jnp.where((diff < 0) & (diff >= -3),
                                         U32(2), U32(3))))


def _seq_offsets(k: int) -> np.ndarray:
    return (((np.uint32(1) << (2 * np.arange(k + 1, dtype=np.uint32)))
             - np.uint32(1)) // np.uint32(3)).astype(np.uint32)


def _ctx_precompute(kind: str, geom, syms, pos, reset, mflag=None):
    """Closed-form [T, W] context streams for the ENCODE path. Must equal
    the oracle's carried-state contexts at every active step. mflag
    (seq only, format v5): 1 at positions inside a match span — those
    use the dedicated match-context family."""
    rs = reset == U32(1)
    if kind == "qual":
        a = jnp.where(rs, U32(0), _shift_t(syms, 1))
        b = jnp.where(rs | (_shift_t(reset, 1) == U32(1)), U32(0),
                      _shift_t(syms, 2))
        ctx = a
        shift = geom.depth
        if geom.q2_bits:
            ctx = ctx | ((b >> U32(geom.depth - geom.q2_bits)) << U32(shift))
            shift += geom.q2_bits
        if getattr(geom, "delta_bits", 0):
            ctx = ctx | (_qdelta_code(a, b) << U32(shift))
            shift += geom.delta_bits
        if geom.pos_bits:
            posb = jnp.minimum(pos >> U32(geom.pos_shift),
                               U32((1 << geom.pos_bits) - 1))
            ctx = ctx | (posb.astype(U32) << U32(shift))
        return ctx
    if kind == "seq":
        k = geom.order
        h = jnp.zeros_like(syms)
        for j in range(1, k + 1):
            h = h | jnp.where(pos >= U32(j),
                              _shift_t(syms, j) << U32(2 * (j - 1)), U32(0))
        offsets = jnp.asarray(_seq_offsets(k))
        j = jnp.minimum(pos.astype(I32), I32(k))
        ctx = h + offsets[j]
        if mflag is not None and geom.match_bits:
            mctx = (U32(geom.tree_ctx)
                    + (h & U32((1 << geom.match_bits) - 1)))
            ctx = jnp.where(mflag == U32(1), mctx, ctx)
        return ctx
    if kind == "byte":
        return _shift_t(syms, 1) if geom.order else jnp.zeros_like(syms)
    if kind == "flag":
        hb = geom.hist_bits
        h = jnp.zeros_like(syms)
        for j in range(1, hb + 1):
            h = h | (_shift_t(syms, j) << U32(j - 1))
        return h & U32((1 << hb) - 1)
    raise ValueError(kind)


def _ctx_init(kind: str, W: int):
    if kind == "qual":
        return (jnp.zeros(W, U32), jnp.zeros(W, U32))
    return (jnp.zeros(W, U32),)


def _ctx_step(kind: str, geom, cst, pos_t, reset_t, mflag_t=None):
    """Online (decode) context: mirrors streams_np step_ctx exactly."""
    rs = reset_t == U32(1)
    if kind == "qual":
        a, b = cst
        a = jnp.where(rs, U32(0), a)
        b = jnp.where(rs, U32(0), b)
        ctx = a
        shift = geom.depth
        if geom.q2_bits:
            ctx = ctx | ((b >> U32(geom.depth - geom.q2_bits)) << U32(shift))
            shift += geom.q2_bits
        if getattr(geom, "delta_bits", 0):
            ctx = ctx | (_qdelta_code(a, b) << U32(shift))
            shift += geom.delta_bits
        if geom.pos_bits:
            posb = jnp.minimum(pos_t >> U32(geom.pos_shift),
                               U32((1 << geom.pos_bits) - 1))
            ctx = ctx | (posb.astype(U32) << U32(shift))
        return ctx, (a, b)
    if kind == "seq":
        (h,) = cst
        h = jnp.where(rs, U32(0), h)
        offsets = jnp.asarray(_seq_offsets(geom.order))
        j = jnp.minimum(pos_t.astype(I32), I32(geom.order))
        ctx = h + offsets[j]
        if mflag_t is not None and geom.match_bits:
            mctx = (U32(geom.tree_ctx)
                    + (h & U32((1 << geom.match_bits) - 1)))
            ctx = jnp.where(mflag_t == U32(1), mctx, ctx)
        return ctx, (h,)
    if kind == "byte":
        (pb,) = cst
        return (pb if geom.order else jnp.zeros_like(pb)), (pb,)
    if kind == "flag":
        (hist,) = cst
        return hist, (hist,)
    raise ValueError(kind)


def _ctx_advance(kind: str, geom, cst, sym):
    if kind == "qual":
        a, b = cst
        return (sym.astype(U32), a)
    if kind == "seq":
        (h,) = cst
        mask = U32((1 << (2 * geom.order)) - 1)
        return (((h << U32(2)) | sym.astype(U32)) & mask,)
    if kind == "byte":
        return (sym.astype(U32),)
    if kind == "flag":
        (hist,) = cst
        m = U32((1 << geom.hist_bits) - 1)
        return (((hist << U32(1)) | sym.astype(U32)) & m,)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# encode: schedule precompute (one jit) + proto-shaped coder (another jit)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=256)
def _build_schedule(kind: str, geom, Sp: int, W: int,
                    with_mflag: bool = False):
    depth = geom.depth
    num_ctx = geom.num_ctx
    KD = _CHUNK_SYMS * depth
    NC = Sp // _CHUNK_SYMS

    @jax.jit
    def run(syms, poss, resets, counts, mflag=None):
        syms = syms.astype(U32)     # uint8 boundary: upcast once, pre-scan
        steps = jax.lax.broadcasted_iota(I32, (Sp, W), 0)
        active = steps < counts[None, :].astype(I32)
        ctx = _ctx_precompute(kind, geom, syms, poss, resets,
                              mflag=(mflag.astype(U32)
                                     if mflag is not None else None))
        ctx = jnp.where(active, ctx, U32(num_ctx)).astype(I32)
        sym = jnp.where(active, syms, U32(0))
        nodes = (1 << depth) - 1
        base = ctx * I32(nodes)
        idx_list, bit_list = [], []
        for j in range(depth):
            node = I32(1 << j) | (sym >> U32(depth - j)).astype(I32)
            idx_list.append(base + node - 1)
            bit_list.append(((sym >> U32(depth - 1 - j)) & U32(1))
                            .astype(I32))
        idx_all = jnp.stack(idx_list, axis=1).reshape(NC, KD, W)
        bit_all = jnp.stack(bit_list, axis=1).reshape(NC, KD, W)
        return idx_all, bit_all

    # with_mflag only keys the cache: calls without mflag trace to the
    # exact historical program (the mflag branch is a Python-level check)
    return run


def _pos_reset_device(lane_lens, Sp: int, S: int, W: int):
    """Device-side equivalent of streams_np.build_pos_reset, padded to Sp.
    lane_lens: [Rpl, W] int32."""
    Rpl = lane_lens.shape[0]
    starts = jnp.concatenate(
        [jnp.zeros((1, W), I32),
         jnp.cumsum(lane_lens[:-1].astype(I32), axis=0)], axis=0) \
        if Rpl > 1 else jnp.zeros((Rpl, W), I32)
    lane_ids = jax.lax.broadcasted_iota(I32, (Rpl, W), 1)
    valid = (lane_lens > 0) & (starts < S)
    flat = jnp.where(valid, starts * W + lane_ids, Sp * W)
    reset_flat = jnp.zeros(Sp * W + 1, I32).at[flat.reshape(-1)].set(1)
    reset = reset_flat[:-1].reshape(Sp, W)
    t_idx = jax.lax.broadcasted_iota(I32, (Sp, W), 0)
    marks = jnp.where(reset == 1, t_idx, I32(-1))
    last = jax.lax.associative_scan(jnp.maximum, marks, axis=0)
    pos = (t_idx - jnp.maximum(last, 0)).astype(U32)
    return pos, reset.astype(U32)


@functools.lru_cache(maxsize=256)
def _build_schedule_ll(kind: str, geom, Sp: int, S: int, W: int, Rpl: int,
                       with_mflag: bool = False):
    """Schedule builder that derives pos/reset on device from the per-lane
    record-length matrix — no [Sp, W] aux transfers from the host."""
    depth = geom.depth
    num_ctx = geom.num_ctx
    KD = _CHUNK_SYMS * depth
    NC = Sp // _CHUNK_SYMS

    @jax.jit
    def run(syms, lane_lens, counts, mflag=None):
        syms = syms.astype(U32)     # uint8 boundary: upcast once, pre-scan
        poss, resets = _pos_reset_device(lane_lens, Sp, S, W)
        steps = jax.lax.broadcasted_iota(I32, (Sp, W), 0)
        active = steps < counts[None, :].astype(I32)
        ctx = _ctx_precompute(kind, geom, syms, poss, resets,
                              mflag=(mflag.astype(U32)
                                     if mflag is not None else None))
        ctx = jnp.where(active, ctx, U32(num_ctx)).astype(I32)
        sym = jnp.where(active, syms, U32(0))
        nodes = (1 << depth) - 1
        base = ctx * I32(nodes)
        idx_list, bit_list = [], []
        for j in range(depth):
            node = I32(1 << j) | (sym >> U32(depth - j)).astype(I32)
            idx_list.append(base + node - 1)
            bit_list.append(((sym >> U32(depth - 1 - j)) & U32(1))
                            .astype(I32))
        idx_all = jnp.stack(idx_list, axis=1).reshape(NC, KD, W)
        bit_all = jnp.stack(bit_list, axis=1).reshape(NC, KD, W)
        return idx_all, bit_all

    return run


@functools.lru_cache(maxsize=256)
def _build_encode(kind: str, geom, Sp: int, W: int, hard: bool):
    # The `warm` conditionals below are Python-level: a geometry without
    # the v4 visit-count warm-up traces to a program without the visit
    # table.
    depth, rate = geom.depth, geom.rate
    rate_lo = getattr(geom, "rate_lo", 0)
    warm = 0 < rate_lo < rate
    tsize = geom.table_size
    sac_base = geom.sac_base
    CB = _chunk_bytes(depth, hard)
    KD = _CHUNK_SYMS * depth
    lane_off_np = np.arange(W, dtype=np.int32) * CB

    @jax.jit
    def run(idx_c, bit_c):
        table = jnp.full(tsize, R.PROB_INIT, I32)
        table = table.at[sac_base:].set(I32(PROB_MAX))
        low = jnp.zeros(W, U32)
        rngs = jnp.full(W, 0xFFFFFFFF, U32)
        loff = jnp.asarray(lane_off_np)

        def chunk(carry, xs):
            if warm:
                low, rngs, table, vtab = carry
            else:
                low, rngs, table = carry
                vtab = None
            idxs, bits = xs
            ebuf = jnp.zeros(W * CB + 1, I32)
            eptr = jnp.zeros(W, I32)

            def bitstep(i, st):
                if warm:
                    low, rngs, table, vtab, ebuf, eptr = st
                else:
                    low, rngs, table, ebuf, eptr = st
                    vtab = None
                idx = idxs[i]
                bit = bits[i]
                # collision-capped law step A: deposit count markers
                minc = jnp.where(idx < sac_base, I32(1 << R.CNT_SHIFT),
                                 I32(0))
                table = table.at[idx].add(minc)
                marked = table[idx]
                p = jnp.clip(marked & I32((1 << R.CNT_SHIFT) - 1),
                             PROB_MIN, PROB_MAX).astype(U32)
                split = (rngs >> U32(PROB_BITS)) * p
                is1 = bit == 1
                low = jnp.where(is1, low + split, low)
                rngs = jnp.where(is1, rngs - split, split)
                for _ in range(R.RENORM_ITERS):
                    agree = ((low ^ (low + rngs)) & U32(0xFFFFFFFF)) \
                        < U32(TOP_C)
                    under = rngs < U32(BOT_C)
                    do = agree | under
                    clamp = do & ~agree
                    rngs = jnp.where(clamp, (U32(0) - low) & U32(0xFFFF),
                                     rngs)
                    byte = (low >> U32(24)).astype(I32)
                    tgt = jnp.where(do & (eptr < CB), loff + eptr, W * CB)
                    ebuf = ebuf.at[tgt].set(byte)
                    eptr = eptr + do.astype(I32)
                    low = jnp.where(do, low << U32(8), low)
                    rngs = jnp.where(do, rngs << U32(8), rngs)
                p32 = p.astype(I32)
                cnt = marked >> I32(R.CNT_SHIFT)
                if warm:
                    # v4 visit-count warm-up (ranger_np.table_update law)
                    vis = jnp.minimum(vtab[idx], I32(1024))
                    lgv = jnp.zeros_like(vis)
                    for j in range(10):
                        lgv = lgv + (vis + I32(1) > (1 << j)).astype(I32)
                    reff = jnp.minimum(I32(rate), I32(rate_lo) + lgv)
                    delta = jnp.where(is1, -(p32 >> reff),
                                      (I32(PROB_ONE) - p32) >> reff)
                    vtab = vtab.at[idx].add(
                        jnp.where(idx < sac_base, I32(1), I32(0)))
                else:
                    delta = jnp.where(is1, -(p32 >> rate),
                                      (I32(PROB_ONE) - p32) >> rate)
                lg = jnp.zeros_like(cnt)
                for j in range(10):
                    lg = lg + (cnt > (1 << j)).astype(I32)
                delta = delta >> jnp.maximum(lg - R.CAP_LOG2, 0)
                delta = jnp.where(idx < sac_base,
                                  delta - I32(1 << R.CNT_SHIFT), I32(0))
                table = table.at[idx].add(delta)
                v = table[idx]
                table = table.at[idx].set(jnp.clip(v, PROB_MIN, PROB_MAX))
                if warm:
                    return (low, rngs, table, vtab, ebuf, eptr)
                return (low, rngs, table, ebuf, eptr)

            if warm:
                low, rngs, table, vtab, ebuf, eptr = jax.lax.fori_loop(
                    0, KD, bitstep, (low, rngs, table, vtab, ebuf, eptr))
                return (low, rngs, table, vtab), (ebuf[:-1], eptr)
            low, rngs, table, ebuf, eptr = jax.lax.fori_loop(
                0, KD, bitstep, (low, rngs, table, ebuf, eptr))
            return (low, rngs, table), (ebuf[:-1], eptr)

        carry0 = (low, rngs, table)
        if warm:
            carry0 = carry0 + (jnp.zeros(tsize, I32),)
        _carry, (ebufs, eptrs) = jax.lax.scan(chunk, carry0,
                                              (idx_c, bit_c))
        low = _carry[0]
        # single whole-array cast: transfer u8, not i32 (4x less d2h)
        return ebufs.astype(jnp.uint8), eptrs, low, eptrs.max()

    return run


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=256)
def _build_decode(kind: str, geom, Sp: int, W: int, Lw: int,
                  with_mflag: bool = False):
    """Lw: payload words (uint32) per lane. with_mflag (seq, format v5):
    the kernel takes an extra chunked [NC, K, W] match-span flag input
    and selects the match-context family at flagged steps — a separate
    cache entry, so non-match streams compile without the flag input."""
    depth, rate = geom.depth, geom.rate
    rate_lo = getattr(geom, "rate_lo", 0)
    warm = 0 < rate_lo < rate   # v4 visit-count warm-up (see encode)
    tsize = geom.table_size
    sac_base = geom.sac_base
    num_ctx = geom.num_ctx
    K = _CHUNK_SYMS
    NC = Sp // K
    word_off_np = np.arange(W, dtype=np.int32) * Lw

    @jax.jit
    def run(paywords, lens, acts, poss, resets, mflags=None):
        # acts/poss/resets: [NC, K, W]. paywords/lens travel in the scan
        # carry with the table and coder state.
        table = jnp.full(tsize, R.PROB_INIT, I32)
        table = table.at[sac_base:].set(I32(PROB_MAX))
        woff = jnp.asarray(word_off_np)
        lens0 = lens.astype(I32)
        low = jnp.zeros(W, U32)
        rngs = jnp.full(W, 0xFFFFFFFF, U32)
        ptr = jnp.zeros(W, I32)
        code = jnp.zeros(W, U32)

        def read_bytes(words, lens32, ptr, do):
            wi = woff + jnp.minimum(ptr >> 2, I32(Lw - 1))
            word = words[wi]
            nxt = (word >> (U32(8) * (ptr.astype(U32) & U32(3)))) & U32(255)
            nxt = jnp.where((ptr < lens32) & do, nxt, U32(0))
            return nxt, ptr + do.astype(I32)

        ones = jnp.ones(W, bool)
        for _ in range(4):
            nxt, ptr = read_bytes(paywords, lens0, ptr, ones)
            code = (code << U32(8)) | nxt

        cst0 = _ctx_init(kind, W)

        def chunk(carry, xs):
            if warm:
                low, rngs, code, ptr, table, vtab, cst, words, \
                    lens32 = carry
            else:
                low, rngs, code, ptr, table, cst, words, lens32 = carry
                vtab = None
            if mflags is None:
                acts_c, poss_c, resets_c = xs
                mflags_c = None
            else:
                acts_c, poss_c, resets_c, mflags_c = xs
            sbuf = jnp.zeros((K, W), U32)

            def symstep(i, st):
                if warm:
                    (low, rngs, code, ptr, table, vtab, cst, sbuf, words,
                     lens32) = st
                else:
                    (low, rngs, code, ptr, table, cst, sbuf, words,
                     lens32) = st
                    vtab = None
                act = acts_c[i] == 1
                ctx, cst = _ctx_step(kind, geom, cst, poss_c[i], resets_c[i],
                                     mflag_t=(mflags_c[i] if mflags_c
                                              is not None else None))
                ctx = jnp.where(act, ctx, U32(num_ctx))
                nodes = (1 << depth) - 1
                base = ctx.astype(I32) * I32(nodes)
                node = jnp.ones(W, I32)
                sym = jnp.zeros(W, U32)
                for _ in range(depth):
                    idx = base + node - 1
                    minc = jnp.where(idx < sac_base,
                                     I32(1 << R.CNT_SHIFT), I32(0))
                    table = table.at[idx].add(minc)
                    marked = table[idx]
                    p = jnp.clip(marked & I32((1 << R.CNT_SHIFT) - 1),
                                 PROB_MIN, PROB_MAX).astype(U32)
                    split = (rngs >> U32(PROB_BITS)) * p
                    diff = (code - low) & U32(0xFFFFFFFF)
                    bit = (diff >= split).astype(I32)
                    is1 = bit == 1
                    low = jnp.where(is1, low + split, low)
                    rngs = jnp.where(is1, rngs - split, split)
                    for _ in range(R.RENORM_ITERS):
                        agree = ((low ^ (low + rngs)) & U32(0xFFFFFFFF)) \
                            < U32(TOP_C)
                        under = rngs < U32(BOT_C)
                        do = agree | under
                        clamp = do & ~agree
                        rngs = jnp.where(clamp,
                                         (U32(0) - low) & U32(0xFFFF), rngs)
                        nxt, ptr = read_bytes(words, lens32, ptr, do)
                        code = jnp.where(do, (code << U32(8)) | nxt, code)
                        low = jnp.where(do, low << U32(8), low)
                        rngs = jnp.where(do, rngs << U32(8), rngs)
                    p32 = p.astype(I32)
                    cnt = marked >> I32(R.CNT_SHIFT)
                    if warm:
                        vis = jnp.minimum(vtab[idx], I32(1024))
                        lgv = jnp.zeros_like(vis)
                        for j in range(10):
                            lgv = lgv + (vis + I32(1)
                                         > (1 << j)).astype(I32)
                        reff = jnp.minimum(I32(rate), I32(rate_lo) + lgv)
                        delta = jnp.where(is1, -(p32 >> reff),
                                          (I32(PROB_ONE) - p32) >> reff)
                        vtab = vtab.at[idx].add(
                            jnp.where(idx < sac_base, I32(1), I32(0)))
                    else:
                        delta = jnp.where(is1, -(p32 >> rate),
                                          (I32(PROB_ONE) - p32) >> rate)
                    lg = jnp.zeros_like(cnt)
                    for j in range(10):
                        lg = lg + (cnt > (1 << j)).astype(I32)
                    delta = delta >> jnp.maximum(lg - R.CAP_LOG2, 0)
                    delta = jnp.where(idx < sac_base,
                                      delta - I32(1 << R.CNT_SHIFT), I32(0))
                    table = table.at[idx].add(delta)
                    v = table[idx]
                    table = table.at[idx].set(
                        jnp.clip(v, PROB_MIN, PROB_MAX))
                    node = 2 * node + bit
                    sym = (sym << U32(1)) | bit.astype(U32)
                sym = jnp.where(act, sym, U32(0))
                cst = _ctx_advance(kind, geom, cst, sym)
                sbuf = jax.lax.dynamic_update_slice(sbuf, sym[None, :],
                                                    (i, 0))
                if warm:
                    return (low, rngs, code, ptr, table, vtab, cst, sbuf,
                            words, lens32)
                return (low, rngs, code, ptr, table, cst, sbuf, words,
                        lens32)

            if warm:
                (low, rngs, code, ptr, table, vtab, cst, sbuf, words,
                 lens32) = jax.lax.fori_loop(
                    0, K, symstep,
                    (low, rngs, code, ptr, table, vtab, cst, sbuf, words,
                     lens32))
                return (low, rngs, code, ptr, table, vtab, cst, words,
                        lens32), sbuf
            (low, rngs, code, ptr, table, cst, sbuf, words,
             lens32) = jax.lax.fori_loop(
                0, K, symstep,
                (low, rngs, code, ptr, table, cst, sbuf, words, lens32))
            return (low, rngs, code, ptr, table, cst, words, lens32), sbuf

        if warm:
            carry = (low, rngs, code, ptr, table, jnp.zeros(tsize, I32),
                     cst0, paywords, lens0)
        else:
            carry = (low, rngs, code, ptr, table, cst0, paywords, lens0)
        xs = (acts, poss, resets) if mflags is None else \
            (acts, poss, resets, mflags)
        carry, sbufs = jax.lax.scan(chunk, carry, xs)
        # uint8 boundary: whole-array downcast AFTER the scan (symbols fit
        # in a byte at every depth <= 8) -> 4x smaller device->host copy
        return sbufs.reshape(Sp, W).astype(jnp.uint8)

    return run


@functools.lru_cache(maxsize=256)
def _build_decode_ll(kind: str, geom, Sp: int, S: int, W: int, Rpl: int,
                     Lw: int, with_mflag: bool = False):
    """Decode with acts/pos/reset derived on device from counts and the
    per-lane record-length matrix. with_mflag: takes the [S, W] match
    flag matrix (host-built from the MATCH descriptors) as an extra arg."""
    inner = _build_decode(kind, geom, Sp, W, Lw, with_mflag=with_mflag)
    K = _CHUNK_SYMS
    NC = Sp // K

    @jax.jit
    def run(paywords, lens, lane_lens, counts, mflag=None):
        poss, resets = _pos_reset_device(lane_lens, Sp, S, W)
        steps = jax.lax.broadcasted_iota(I32, (Sp, W), 0)
        acts = (steps < counts[None, :].astype(I32)).astype(I32)
        if mflag is None:
            return inner(paywords, lens, acts.reshape(NC, K, W),
                         poss.reshape(NC, K, W), resets.reshape(NC, K, W))
        mf = jnp.zeros((Sp, W), U32).at[:mflag.shape[0]].set(
            mflag.astype(U32))
        return inner(paywords, lens, acts.reshape(NC, K, W),
                     poss.reshape(NC, K, W), resets.reshape(NC, K, W),
                     mf.reshape(NC, K, W))

    return run


# ---------------------------------------------------------------------------
# public drivers (streams_np-compatible)
# ---------------------------------------------------------------------------

def _pad2(x, Sp, W):
    dt = np.uint8 if (x is not None and x.dtype == np.uint8) else np.uint32
    out = np.zeros((Sp, W), dtype=dt)
    if x is not None and x.shape[0]:
        out[: x.shape[0]] = x
    return out


def encode_stream(kind: str, geom, syms: np.ndarray, counts: np.ndarray,
                  pos: np.ndarray | None = None,
                  reset: np.ndarray | None = None,
                  mflag: np.ndarray | None = None):
    S, W = syms.shape
    counts = np.asarray(counts)
    Sp = R.pad_steps(S)
    if Sp == 0 or not (counts > 0).any():
        return np.zeros((W, 0), dtype=np.uint8), np.zeros(W, dtype=np.int64)
    from ..utils.stats import trace
    sched = _build_schedule(kind, geom, Sp, W, with_mflag=mflag is not None)
    with trace(f"sfq.encode.{kind}.schedule") as span:
        args = (jnp.asarray(_pad2(syms, Sp, W)),
                jnp.asarray(_pad2(pos, Sp, W)),
                jnp.asarray(_pad2(reset, Sp, W)),
                jnp.asarray(counts.astype(np.int32)))
        if mflag is not None:
            args = args + (jnp.asarray(_pad2(mflag, Sp, W)),)
        idx_c, bit_c = span.wait_for(sched(*args))
    for hard in (False, True):
        run = _build_encode(kind, geom, Sp, W, hard)
        with trace(f"sfq.encode.{kind}.coder") as span:
            ebufs, eptrs, low, emax = span.wait_for(run(idx_c, bit_c))
        if int(emax) <= _chunk_bytes(geom.depth, hard):
            return _compact(ebufs, eptrs, low, counts)
    raise AssertionError("encode chunk overflow even with hard buffers")


def _flush_append(pay: np.ndarray, totals_np: np.ndarray, low, counts):
    """Compacted per-lane payload [W, >=max total] + per-lane byte totals
    -> final (payload [W, maxlen], lens) with the FLUSH_BYTES coder-tail
    bytes appended. C++ when available (the vectorised-NumPy mask path
    below is the fallback)."""
    counts = np.asarray(counts)
    W = len(counts)
    act = counts > 0
    lens = np.where(act, totals_np + R.FLUSH_BYTES, 0).astype(np.int64)
    maxlen = int(lens.max()) if lens.size else 0
    from .. import native
    if native.available() and R.FLUSH_BYTES == 4:
        return native.flush_append(pay, totals_np, np.asarray(low),
                                   counts, maxlen), lens
    payload = np.zeros((W, maxlen), dtype=np.uint8)
    span = min(maxlen, pay.shape[1])
    cols = np.arange(span)[None, :]
    mask = act[:, None] & (cols < totals_np[:, None])
    payload[:, :span][mask] = pay[:, :span][mask]
    if maxlen and act.any():
        lowh = np.asarray(low).astype(np.uint64)
        rows = np.nonzero(act)[0]
        fcols = totals_np[rows, None] + np.arange(R.FLUSH_BYTES)[None, :]
        shifts = (24 - 8 * np.arange(R.FLUSH_BYTES, dtype=np.uint64))
        fvals = (lowh[rows, None] >> shifts[None, :]) & np.uint64(0xFF)
        payload[np.repeat(rows, R.FLUSH_BYTES), fcols.ravel()] = \
            fvals.ravel().astype(np.uint8)
    return payload, lens


def _compact(ebufs, eptrs, low, counts):
    """Coder emission chunks (device arrays from _build_encode) -> final
    (payload [W, maxlen], lens): the chunks are compacted on the device
    (ops/compact_xla), so only the per-lane totals (4 KB at W=1024) and
    about the compressed payload cross to the host, which appends the
    coder's flush bytes."""
    from ..utils.stats import trace
    from . import compact_xla
    with trace("sfq.encode.compact"):
        totals_np = np.asarray(jnp.sum(eptrs, axis=0)).astype(np.int64)
        Bmax = int(totals_np.max()) if totals_np.size else 0
        # quantise the (data-dependent) payload bound to 4 KB buckets so
        # the kernel compiles once per bucket, not once per block
        Bmax = ((Bmax + R.FLUSH_BYTES + 4095) // 4096) * 4096 + 128
        pay_dev, _ = compact_xla.compact_device(ebufs, eptrs, Bmax)
        return _flush_append(np.asarray(pay_dev), totals_np,
                             np.asarray(low), counts)


def encode_stream_ll(kind: str, geom, syms: np.ndarray,
                     lane_len_mat: np.ndarray, counts: np.ndarray,
                     mflag: np.ndarray | None = None):
    """encode_stream variant for per-read streams (qual/seq): pos/reset
    are derived on device from the per-lane record-length matrix, so the
    host ships only symbols + the small length matrix."""
    S, W = syms.shape
    counts = np.asarray(counts)
    Sp = R.pad_steps(S)
    if Sp == 0 or not (counts > 0).any():
        return np.zeros((W, 0), dtype=np.uint8), np.zeros(W, dtype=np.int64)
    Rpl = max(lane_len_mat.shape[0], 1)
    ll = np.zeros((Rpl, W), dtype=np.int32)
    ll[: lane_len_mat.shape[0]] = lane_len_mat
    from ..utils.stats import trace
    sched = _build_schedule_ll(kind, geom, Sp, S, W, Rpl,
                               with_mflag=mflag is not None)
    with trace(f"sfq.encode.{kind}.schedule") as span:
        args = (jnp.asarray(_pad2(syms, Sp, W)), jnp.asarray(ll),
                jnp.asarray(counts.astype(np.int32)))
        if mflag is not None:
            args = args + (jnp.asarray(_pad2(mflag, Sp, W)),)
        idx_c, bit_c = span.wait_for(sched(*args))
    for hard in (False, True):
        run = _build_encode(kind, geom, Sp, W, hard)
        with trace(f"sfq.encode.{kind}.coder") as span:
            ebufs, eptrs, low, emax = span.wait_for(run(idx_c, bit_c))
        if int(emax) <= _chunk_bytes(geom.depth, hard):
            return _compact(ebufs, eptrs, low, counts)
    raise AssertionError("encode chunk overflow even with hard buffers")


def decode_stream_ll(kind: str, geom, payload: np.ndarray, lens: np.ndarray,
                     lane_len_mat: np.ndarray, counts: np.ndarray,
                     num_steps: int,
                     mflag: np.ndarray | None = None) -> np.ndarray:
    """decode_stream variant with device-derived acts/pos/reset."""
    W = payload.shape[0]
    counts = np.asarray(counts)
    S = num_steps
    Sp = R.pad_steps(S)
    if Sp == 0 or not (counts > 0).any():
        return np.zeros((S, W), dtype=np.uint8)
    Lb = max(int(payload.shape[1]), 1)
    Lb = ((Lb + 2047) // 2048) * 2048
    # np.empty: every byte at ptr >= lane len is masked to 0 inside the
    # decode kernel (read_bytes), so the pad region is never observed
    pay = np.empty((W, Lb), dtype=np.uint8)
    pay[:, : payload.shape[1]] = payload
    Lw = Lb // 4
    words = pay.view("<u4").reshape(W * Lw)
    Rpl = max(lane_len_mat.shape[0], 1)
    ll = np.zeros((Rpl, W), dtype=np.int32)
    ll[: lane_len_mat.shape[0]] = lane_len_mat
    from ..utils.stats import trace
    run = _build_decode_ll(kind, geom, Sp, S, W, Rpl, Lw,
                           with_mflag=mflag is not None)
    with trace(f"sfq.decode.{kind}.coder") as span:
        args = (jnp.asarray(words), jnp.asarray(lens.astype(np.int32)),
                jnp.asarray(ll), jnp.asarray(counts.astype(np.int32)))
        if mflag is not None:
            args = args + (jnp.asarray(np.ascontiguousarray(mflag)),)
        syms = span.wait_for(run(*args))
    out = np.asarray(syms)[:S]
    mask = np.arange(S)[:, None] < counts[None, :]
    return np.where(mask, out, np.uint8(0))


def decode_stream(kind: str, geom, payload: np.ndarray, lens: np.ndarray,
                  counts: np.ndarray, num_steps: int,
                  pos: np.ndarray | None = None,
                  reset: np.ndarray | None = None,
                  mflag: np.ndarray | None = None) -> np.ndarray:
    W = payload.shape[0]
    counts = np.asarray(counts)
    S = num_steps
    Sp = R.pad_steps(S)
    if Sp == 0 or not (counts > 0).any():
        return np.zeros((S, W), dtype=np.uint8)
    # word-pack the payload (little-endian) and bucket its width
    # (np.empty: bytes at ptr >= lane len are masked inside the kernel)
    Lb = max(int(payload.shape[1]), 1)
    Lb = ((Lb + 2047) // 2048) * 2048
    pay = np.empty((W, Lb), dtype=np.uint8)
    pay[:, : payload.shape[1]] = payload
    Lw = Lb // 4
    words = pay.view("<u4").reshape(W * Lw)
    K = _CHUNK_SYMS
    NC = Sp // K
    steps = np.arange(Sp)[:, None]
    acts = (steps < counts[None, :]).astype(np.int32).reshape(NC, K, W)
    poss = _pad2(pos, Sp, W).reshape(NC, K, W)
    resets = _pad2(reset, Sp, W).reshape(NC, K, W)
    from ..utils.stats import trace
    run = _build_decode(kind, geom, Sp, W, Lw,
                        with_mflag=mflag is not None)
    with trace(f"sfq.decode.{kind}.coder") as span:
        args = (jnp.asarray(words), jnp.asarray(lens.astype(np.int32)),
                jnp.asarray(acts), jnp.asarray(poss), jnp.asarray(resets))
        if mflag is not None:
            args = args + (jnp.asarray(
                _pad2(mflag, Sp, W).astype(np.uint32).reshape(NC, K, W)),)
        syms = span.wait_for(run(*args))
    out = np.asarray(syms)[:S]
    mask = np.arange(S)[:, None] < counts[None, :]
    return np.where(mask, out, np.uint8(0))


# ---------------------------------------------------------------------------
# Device-raw SEQ+QUAL drivers: the raw block bytes cross to the device
# once and the lane pack/unpack happens there (ops/pack_jax) — the host
# never builds the [S, W] matrices (they were its largest prep cost).
# ---------------------------------------------------------------------------


def encode_seq_qual_raw(seq_geom, qual_geom, data: np.ndarray,
                        seq_offs: np.ndarray, qual_offs: np.ndarray,
                        lengths: np.ndarray, W: int, seq_map: np.ndarray,
                        qual_bias: int, ll_mat: np.ndarray,
                        counts: np.ndarray, padded: bool = False,
                        seq_mflag: np.ndarray | None = None,
                        only: tuple = ("SEQ", "QUAL")):
    """Encode the SEQ and QUAL streams from raw block bytes with
    on-device lane packing. Returns {"SEQ": (payload, lens), "QUAL": ...}
    byte-identical to encode_stream_ll on host-packed matrices.
    padded=True: `data` is already zero-padded to a pack_jax.pad_flat
    boundary (so a pipelined caller pays the pad copy in its host half).
    only: restrict to a subset of the two streams (the v5 match trial
    re-codes SEQ alone — QUAL bytes are independent of the e-transform)."""
    from . import pack_jax
    from ..utils.stats import trace
    counts = np.asarray(counts)
    S = int(counts.max()) if counts.size else 0
    Sp = R.pad_steps(S)
    if Sp == 0 or not (counts > 0).any():
        z = (np.zeros((W, 0), dtype=np.uint8), np.zeros(W, dtype=np.int64))
        return {"SEQ": z, "QUAL": (z[0].copy(), z[1].copy())}
    if padded and len(data) == pack_jax.pad_flat(len(data)):
        dpad = data
    else:
        Dp = pack_jax.pad_flat(len(data))
        dpad = np.zeros(Dp, dtype=np.uint8)
        dpad[: len(data)] = data
    data_dev = jax.device_put(dpad)
    with trace("sfq.encode.pack_pair") as span:
        seq_syms, qual_syms = span.wait_for(pack_jax.pack_pair_device(
            data_dev, seq_offs, qual_offs, lengths, W, Sp, seq_map,
            qual_bias))
    Rpl = max(ll_mat.shape[0], 1)
    ll = np.zeros((Rpl, W), dtype=np.int32)
    ll[: ll_mat.shape[0]] = ll_mat
    ll_dev = jnp.asarray(ll)
    counts_dev = jnp.asarray(counts.astype(np.int32))
    out = {}
    for name, kind, geom, syms in (("SEQ", "seq", seq_geom, seq_syms),
                                   ("QUAL", "qual", qual_geom, qual_syms)):
        if name not in only:
            continue
        use_mf = name == "SEQ" and seq_mflag is not None
        sched = _build_schedule_ll(kind, geom, Sp, S, W, Rpl,
                                   with_mflag=use_mf)
        with trace(f"sfq.encode.{kind}.schedule") as span:
            args = (syms, ll_dev, counts_dev)
            if use_mf:
                args = args + (jnp.asarray(_pad2(seq_mflag, Sp, W)),)
            idx_c, bit_c = span.wait_for(sched(*args))
        for hard in (False, True):
            run = _build_encode(kind, geom, Sp, W, hard)
            with trace(f"sfq.encode.{kind}.coder") as span:
                ebufs, eptrs, low, emax = span.wait_for(run(idx_c, bit_c))
            if int(emax) <= _chunk_bytes(geom.depth, hard):
                out[name] = _compact(ebufs, eptrs, low, counts)
                break
        else:
            raise AssertionError(
                "encode chunk overflow even with hard buffers")
    return out


def decode_seq_qual_raw(seq_geom, qual_geom,
                        seq_payload: np.ndarray, seq_lens: np.ndarray,
                        qual_payload: np.ndarray, qual_lens: np.ndarray,
                        ll_mat: np.ndarray, counts: np.ndarray, S: int,
                        rec_starts: np.ndarray, lengths: np.ndarray,
                        total: int, seq_map: np.ndarray, qual_bias: int,
                        seq_mflag: np.ndarray | None = None):
    """Decode SEQ and QUAL and unpack them on device straight to
    record-major flat byte buffers (seq through seq_map, qual + bias).
    Returns (seq_bytes, qual_bytes) of length `total`."""
    from . import pack_jax
    from ..utils.stats import trace
    W = seq_payload.shape[0]
    counts = np.asarray(counts)
    Sp = R.pad_steps(S)
    if Sp == 0 or not (counts > 0).any() or total == 0:
        return (np.zeros(total, dtype=np.uint8),
                np.zeros(total, dtype=np.uint8))
    Rpl = max(ll_mat.shape[0], 1)
    ll = np.zeros((Rpl, W), dtype=np.int32)
    ll[: ll_mat.shape[0]] = ll_mat
    ll_dev = jnp.asarray(ll)
    counts_dev = jnp.asarray(counts.astype(np.int32))
    dev_syms = []
    for kind, geom, payload, lens in (("seq", seq_geom, seq_payload,
                                       seq_lens),
                                      ("qual", qual_geom, qual_payload,
                                       qual_lens)):
        Lb = max(int(payload.shape[1]), 1)
        Lb = ((Lb + 2047) // 2048) * 2048
        pay = np.empty((W, Lb), dtype=np.uint8)  # kernel masks past-end
        pay[:, : payload.shape[1]] = payload
        Lw = Lb // 4
        words = pay.view("<u4").reshape(W * Lw)
        use_mf = kind == "seq" and seq_mflag is not None
        run = _build_decode_ll(kind, geom, Sp, S, W, Rpl, Lw,
                               with_mflag=use_mf)
        with trace(f"sfq.decode.{kind}.coder") as span:
            args = (jnp.asarray(words), jnp.asarray(lens.astype(np.int32)),
                    ll_dev, counts_dev)
            if use_mf:
                args = args + (jnp.asarray(
                    np.ascontiguousarray(seq_mflag)),)
            dev_syms.append(span.wait_for(run(*args)))
    with trace("sfq.decode.unpack_pair") as span:
        seq_flat, qual_flat = span.wait_for(pack_jax.unpack_pair_device(
            dev_syms[0], dev_syms[1], rec_starts, lengths, W, total,
            seq_map, qual_bias))
    # both are read-only views: SEQX exception runs are patched into the
    # assembled FASTQ output (native.fastq_assemble), never into these
    # buffers — saves two ~6.5 MB copies per block
    return (np.asarray(seq_flat)[:total],
            np.asarray(qual_flat)[:total])


# ---------------------------------------------------------------------------
# Batched multi-block entry points (round-5 small-block batching, VERDICT
# next #3): the mesh path's vmapped kernels built WITHOUT a mesh — plain
# jit(vmap) on the one local device — so api.encode_fastq/decode_fastq can
# amortise per-dispatch cost when blocks underfill the W lanes (16k-record
# blocks run the 1024-lane kernels 4x underfilled). Signatures match
# parallel/sharded._MeshBatch, so parallel/sharded's window orchestration
# serves both the sharded and the single-chip path; the bench replay
# backend tapes these like any other backend call.
# ---------------------------------------------------------------------------

def encode_seq_qual_raw_blocks(sgeoms, raw_list, counts_list, qgeoms,
                               minqs, seq_map):
    from ..parallel import mesh as pmesh
    return pmesh.encode_seq_qual_raw_blocks(sgeoms, None, raw_list,
                                            counts_list, qgeoms, minqs,
                                            seq_map)


def encode_stream_blocks(kind, geom, syms_list, counts_list,
                         pos_list=None, reset_list=None):
    from ..parallel import mesh as pmesh
    return pmesh.encode_stream_blocks(kind, geom, None, syms_list,
                                      counts_list, pos_list, reset_list)


def decode_seq_qual_raw_blocks(sgeoms, pay_s, lens_s, pay_q, lens_q,
                               ll_list, counts_list, starts_list,
                               lengths_list, totals, qgeoms, minqs,
                               seq_map):
    from ..parallel import mesh as pmesh
    return pmesh.decode_seq_qual_raw_blocks(
        sgeoms, None, pay_s, lens_s, pay_q, lens_q, ll_list, counts_list,
        starts_list, lengths_list, totals, qgeoms, minqs, seq_map)


def decode_stream_blocks(kind, geom, payload_list, lens_list, counts_list,
                         steps_list, pos_list=None, reset_list=None):
    from ..parallel import mesh as pmesh
    return pmesh.decode_stream_blocks(kind, geom, None, payload_list,
                                      lens_list, counts_list, steps_list,
                                      pos_list, reset_list)
