"""Fast host pipeline: C++ (native/) + vectorised NumPy block assembly.

Byte-format identical to pipeline.py (the behavioural oracle) — tests
assert container equality between the two paths. Works directly on the
raw FASTQ buffer + index arrays, never materialising per-record Python
objects (SURVEY.md §3.5: hosts own parsing; keep it native).
"""

from __future__ import annotations

import numpy as np

from . import native
from .config import CodecConfig
from .pipeline import (MATCH_USED, QUAL_NODELTA, STREAMS, EncodedBlock,
                       EncodedStream, _seq_symbol_layout,
                       _to_lane_streams_perlane, streams_for,
                       _BASE_TO_CODE, _CODE_TO_BASE)
from .utils.bits import get_varint, put_varint
from .ops import streams_np

# device-side byte<->symbol maps (full 256-entry tables, gather-friendly):
# encode maps non-ACGT to symbol 0 (the SEQX stream patches them back on
# decode); decode maps any symbol byte through its low 2 bits
_BASE_TO_CODE_DEV = np.where(_BASE_TO_CODE == 255, 0,
                             _BASE_TO_CODE).astype(np.uint8)
_CODE_TO_BASE_FULL = _CODE_TO_BASE[np.arange(256) & 3].astype(np.uint8)


def _group_order(n: int, W: int) -> np.ndarray:
    """Stable grouping of records by lane (record r -> lane r % W);
    closed form, cheaper than an argsort."""
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    Rpl = (n + W - 1) // W
    grid = (np.arange(W, dtype=np.int64)[:, None]
            + np.arange(Rpl, dtype=np.int64)[None, :] * W).ravel()
    return grid[grid < n]


def _lanes_to_mat(lanes_b, Wa: int):
    """Per-lane byte buffers -> ([S, Wa] u8 matrix, counts). Row-major
    fill (contiguous memcpy per lane) + one blocked C++ transpose — the
    column-strided fill this replaces was slower."""
    counts = np.array([len(b) for b in lanes_b], dtype=np.int64)
    S = int(counts.max()) if counts.size else 0
    if S == 0:
        return np.zeros((0, Wa), dtype=np.uint8), counts
    symsT = np.zeros((Wa, S), dtype=np.uint8)
    for w, b in enumerate(lanes_b):
        if len(b):
            symsT[w, : len(b)] = b
    return native.transpose_mat(symsT), counts




def stream_jobs_fast(data: np.ndarray, idx: dict, lo: int, hi: int,
                     cfg: CodecConfig, want_pos_reset: bool = True,
                     device_pack: bool = False):
    """Native/vectorised twin of pipeline.stream_jobs: builds every
    stream's (kind, geom, syms, counts, pos, reset) coding job straight
    from the raw buffer + index arrays (no per-record Python objects).
    Returns (jobs, n, minq, qual_depth, ll_mat). With
    want_pos_reset=False, SEQ/QUAL jobs carry pos=reset=None and callers
    derive them on device from ll_mat (encode_stream_ll). With
    device_pack=True, SEQ/QUAL jobs carry syms=None too — the lane pack
    happens on the device (backend.encode_seq_qual_raw) and the host
    only runs the non-ACGT census (native.scan_bad) for SEQX."""
    n = hi - lo
    W, Wa = cfg.lanes, cfg.aux_lanes
    sl = slice(lo, hi)
    id_off = idx["id_off"][sl]
    id_len = idx["id_len"][sl]
    seq_off = idx["seq_off"][sl]
    plus_off = idx["plus_off"][sl]
    plus_len = idx["plus_len"][sl]
    qual_off = idx["qual_off"][sl]
    lengths = idx["seq_len"][sl].astype(np.int64)

    jobs: dict[str, tuple] = {}
    prev_step = Wa if cfg.fmt >= 3 else 1  # delta baseline (frozen/fmt)

    # --- LEN ---------------------------------------------------------------
    lsyms, lcounts = _lanes_to_mat(native.lens_encode(lengths, Wa,
                                                      prev_step), Wa)
    jobs["LEN"] = ("byte", cfg.bytes_, lsyms, lcounts, None, None)

    # --- IDs + plus: flags/IDD/IDX -----------------------------------------
    bidx = {"id_off": np.ascontiguousarray(id_off),
            "id_len": np.ascontiguousarray(id_len),
            "plus_off": np.ascontiguousarray(plus_off),
            "plus_len": np.ascontiguousarray(plus_len)}
    flags, dl, xl = native.ids_encode(data, bidx, n, Wa, prev_step)
    # FLAG stream: 3 symbols per record, lane-grouped (row-major fill +
    # one transpose, in place of an int64 fancy-index reorder)
    f3 = flags.reshape(n, 3)
    rec_per_lane = ((n - np.arange(Wa) + Wa - 1) // Wa
                    if n else np.zeros(Wa, dtype=np.int64))
    fcounts = (3 * rec_per_lane).astype(np.int64)
    maxrec = int(rec_per_lane.max()) if n else 0
    if maxrec:
        fT = np.zeros((Wa, 3 * maxrec), dtype=np.uint8)
        for w in range(Wa):
            sub = f3[w::Wa]
            if sub.size:
                fT[w, : sub.size] = sub.ravel()
        fsyms = native.transpose_mat(fT)
    else:
        fsyms = np.zeros((0, Wa), dtype=np.uint8)
    jobs["FLAG"] = ("flag", cfg.flags, fsyms, fcounts, None, None)

    for name, lanes_b in (("IDD", dl), ("IDX", xl)):
        syms, counts = _lanes_to_mat(lanes_b, Wa)
        jobs[name] = ("byte", cfg.bytes_, syms, counts, None, None)

    # --- SEQ + SEQX ---------------------------------------------------------
    from .pipeline import _lane_lengths_matrix
    ll_mat = _lane_lengths_matrix(lengths, W)
    scounts = ll_mat.sum(axis=0)
    S = int(scounts.max()) if scounts.size else 0
    pos = reset = None
    if want_pos_reset:
        _, scounts, S, pos, reset = _seq_symbol_layout(lengths, W)
    if device_pack:
        sq = None
        nbad, rec_bad = native.scan_bad(data, seq_off, lengths)
    else:
        sq, _, nbad, rec_bad = native.pack_lanes(data, seq_off, lengths, W,
                                                 S, map256=_BASE_TO_CODE,
                                                 dtype=np.uint8)
    if nbad:
        # rare path: run-length exception lane streams, emitted in C++
        # byte-identically to pipeline.stream_jobs (format v2); only the
        # records pack_lanes flagged are rescanned
        seqx_lane = native.seqx_encode(data, seq_off, lengths, Wa,
                                       rec_bad=rec_bad, nbad=nbad)
    else:
        seqx_lane = [np.zeros(0, dtype=np.uint8)] * Wa
    sxsyms, sx_counts = _lanes_to_mat(seqx_lane, Wa)
    jobs["SEQX"] = ("byte", cfg.bytes_, sxsyms, sx_counts, None, None)

    # --- v5: per-block SEQ order fallback + long-range matches -------------
    extra = {"seq_order": 0, "matches": None, "seq_off_local": None,
             "qual_nodelta": False}
    sgeom = cfg.seq
    if cfg.fmt >= 5:
        from dataclasses import replace as _replace

        from .models import matcher as M
        eff = M.effective_seq_order(cfg.seq.order, int(lengths.sum()))
        if eff != cfg.seq.order:
            sgeom = _replace(cfg.seq, order=eff)
            extra["seq_order"] = eff
        jobs["MATCH"] = ("byte", cfg.bytes_,
                         np.zeros((0, Wa), dtype=np.uint8),
                         np.zeros(Wa, dtype=np.int64), None, None)
        if getattr(cfg, "match", False) and sgeom.match_bits \
                and n > M.MATCH_CHUNK:
            if native.has_matcher():
                # production representation: (ref, orient, v, score)
                # arrays end to end — the per-read tuple list costs
                # Python object churn per read
                m_arrs = native.match_find_arrays(
                    data, seq_off, lengths, min(M.THRESHOLDS))
                extra["matches"] = m_arrs if bool((m_arrs[0] >= 0).any()) \
                    else None
            else:
                codes8 = [M._B2C0[data[seq_off[r]: seq_off[r] + lengths[r]]]
                          for r in range(n)]
                extra["matches"] = M.find_matches(codes8)
                if not any(m is not None for m in extra["matches"]):
                    extra["matches"] = None
            extra["seq_off_local"] = seq_off
    jobs["SEQ"] = ("seq", sgeom, sq, scounts, pos, reset)

    # --- QUAL ---------------------------------------------------------------
    if n and int(lengths.sum()):
        minq, maxq = native.minmax_ranges(data, qual_off, lengths)
    else:
        minq = maxq = 33
    qrange = maxq - minq + 1
    qual_depth = 6 if qrange <= 64 else (7 if qrange <= 128 else 8)
    if device_pack:
        qs = None
    else:
        qs, _, _, _ = native.pack_lanes(data, qual_off, lengths, W, S,
                                        bias=minq, dtype=np.uint8)
    from dataclasses import replace
    qdelta = cfg.qual.delta_bits
    if cfg.fmt >= 5 and qdelta:
        from .models import matcher as M
        qdelta = M.effective_qual_delta(qdelta, int(lengths.sum()))
        extra["qual_nodelta"] = qdelta == 0
    qgeom = replace(cfg.qual, depth=qual_depth, delta_bits=qdelta)
    jobs["QUAL"] = ("qual", qgeom, qs, scounts, pos, reset)

    return jobs, n, minq, qual_depth, ll_mat, extra


def _e_rewrite_letters(dst: np.ndarray, src: np.ndarray,
                       seq_off: np.ndarray, lengths: np.ndarray,
                       matches, min_score: int) -> None:
    """Rewrite matched spans of dst (a copy of src) with e-transform
    LETTERS: letters(e) = C2B[(B2C0[read] - B2C0[ref]) & 3]. Reads refs
    from the UNMODIFIED src (refs may already be rewritten in dst).
    `matches` is either the native (ref, orient, v, score) array bundle
    or the oracle per-read tuple list."""
    from .models import matcher as M
    if isinstance(matches, tuple):
        native.match_apply_arrays(dst, np.ascontiguousarray(src), seq_off,
                                  lengths, matches, min_score)
        return
    if native.has_matcher():
        native.match_apply(dst, np.ascontiguousarray(src), seq_off,
                           lengths, matches, min_score)
        return
    for r, m in enumerate(matches):
        if m is None or m[3] < min_score:
            continue
        ref, orient, v, _ = m
        L = int(lengths[r])
        c_ref = M._B2C0[src[int(seq_off[ref]):
                            int(seq_off[ref]) + int(lengths[ref])]]
        lo_, hi_, pred = M.pred_span(c_ref, orient, v, L)
        if hi_ <= lo_:
            continue
        o = int(seq_off[r])
        c = M._B2C0[src[o + lo_: o + hi_]]
        dst[o + lo_: o + hi_] = _CODE_TO_BASE[(c - pred) & 3]


def _match_trials(pre_jobs_extra, data, idx, lo, hi, cfg,
                  raw_args, sq_plain, ll_mat):
    """Build the per-threshold SEQ alternatives for encode_prepared_block's
    trial: [(min_score, raw_args_e | sq_e, match_syms, match_counts,
    mflag [S, W])]."""
    from .models import matcher as M
    matches = pre_jobs_extra["matches"]
    n = hi - lo
    sl = slice(lo, hi)
    seq_off = idx["seq_off"][sl]
    lengths = idx["seq_len"][sl].astype(np.int64)
    rec_starts = np.zeros(n, dtype=np.int64)
    rec_starts[1:] = np.cumsum(lengths[:-1])
    total = int(lengths.sum())
    scounts = np.asarray(ll_mat).sum(axis=0)
    S = int(scounts.max()) if scounts.size else 0
    is_arr = isinstance(matches, tuple)
    if is_arr and raw_args is None:
        # rare host-pack fallback (raw span >= 2 GiB): run the list form
        refs, orients, vs, scores = matches
        matches = [None if refs[r] < 0
                   else (int(refs[r]), int(orients[r]), int(vs[r]),
                         int(scores[r])) for r in range(n)]
        is_arr = False
    trials = []
    prev_acc = None
    for t in M.THRESHOLDS:
        if is_arr:
            refs, orients, vs, scores = matches
            acc = (refs >= 0) & (scores >= t)
            if not acc.any():
                continue
            if prev_acc is not None and np.array_equal(acc, prev_acc):
                # identical accepted set => byte-identical SEQ/MATCH
                # trial, which can never win the strict `< best_total`
                # test against its twin — skip the duplicate work
                # (common on high-coverage blocks where most scores are
                # perfect; container bytes are unchanged by the skip)
                continue
            prev_acc = acc
            mlanes = native.match_encode_lanes(matches, t, n,
                                               cfg.aux_lanes)
            msyms, mcounts = _lanes_to_mat(mlanes, cfg.aux_lanes)
            recs = np.flatnonzero(acc)
            los, his = _match_span_bounds(
                (recs, refs[recs], orients[recs], vs[recs]), lengths)
            # fused C++ flag build (bit-identical to the span-diff /
            # cumsum / pack_lanes chain, which was slow inside the
            # pipeline)
            mflag = native.match_mflag(recs, los, his, lengths,
                                       cfg.lanes, S)
        else:
            if not any(m is not None and m[3] >= t for m in matches):
                continue
            mlanes = M.encode_match_lanes(matches, t, n, cfg.aux_lanes)
            msyms, mcounts = _lanes_to_mat(mlanes, cfg.aux_lanes)
            per_read = [m[:3] if (m and m[3] >= t) else None
                        for m in matches]
            flag_flat = M.span_flags_flat(M.spans(per_read, lengths),
                                          rec_starts, total)
            mflag, _, _, _ = native.pack_lanes(flag_flat, rec_starts,
                                               lengths, cfg.lanes, S,
                                               dtype=np.uint8)
        if raw_args is not None:
            dpad, offs_s, offs_q, lens = raw_args
            dpad_e = dpad.copy()
            _e_rewrite_letters(dpad_e, dpad, offs_s, lens, matches, t)
            alt = (dpad_e, offs_s, offs_q, lens)
        else:
            # rare host-pack fallback (raw span >= 2 GiB): rewrite the
            # letters in a copy of the block bytes, then repack
            base = int(idx["id_off"][lo]) - 1
            last = hi - 1
            end = int(idx["qual_off"][last] + idx["qual_len"][last])
            blk_bytes = np.array(data[base:end], copy=True)
            _e_rewrite_letters(blk_bytes, data[base:end],
                               seq_off - base, lengths, matches, t)
            W = cfg.lanes
            S = sq_plain.shape[0] if sq_plain is not None else 0
            alt, _, _, _ = native.pack_lanes(blk_bytes, seq_off - base,
                                             lengths, W, S,
                                             map256=_BASE_TO_CODE,
                                             dtype=np.uint8)
        trials.append((t, alt, msyms, mcounts, mflag))
    return trials


def prepare_block_fast(data: np.ndarray, idx: dict, lo: int, hi: int,
                       cfg: CodecConfig, backend):
    """Host-only half of encode_block_fast (stream modeling + aux lane
    matrices). The returned opaque tuple feeds encode_prepared_block —
    split so a pipelined caller can prep block k+1 while block k is on
    the device (both halves release the GIL in their hot parts)."""
    ll_capable = hasattr(backend, "encode_stream_ll")
    raw_capable = hi > lo and hasattr(backend, "encode_seq_qual_raw") \
        and native.available()
    if raw_capable:
        # device offsets are int32: blocks whose raw byte span exceeds
        # 2 GiB (possible only with raised block_records x very long
        # reads) take the host-pack path instead of silently wrapping
        base = int(idx["id_off"][lo]) - 1  # the record's '@'
        last = hi - 1
        end = int(idx["qual_off"][last] + idx["qual_len"][last])
        raw_capable = (end - base) < (1 << 31)
    jobs, n, minq, qual_depth, ll_mat, extra = stream_jobs_fast(
        data, idx, lo, hi, cfg, want_pos_reset=not ll_capable,
        device_pack=raw_capable)
    raw_args = None
    if raw_capable:
        # the block's raw byte range ships to the device once (padded to
        # the shape bucket HERE, in the pipelined host half); offsets
        # become block-local
        from .ops import pack_jax
        sl = slice(lo, hi)
        lengths = idx["seq_len"][sl].astype(np.int64)
        span = end - base
        # np.empty + tail-only zero: a full np.zeros pass would write a
        # 16 MB block of bytes that are immediately overwritten
        dpad = np.empty(pack_jax.pad_flat(span), dtype=np.uint8)
        dpad[:span] = data[base:end]
        dpad[span:] = 0
        raw_args = (dpad, idx["seq_off"][sl] - base,
                    idx["qual_off"][sl] - base, lengths)
    v5 = None
    if cfg.fmt >= 5:
        v5 = {"seq_order": extra["seq_order"], "trials": [],
              "qual_nodelta": extra["qual_nodelta"]}
        if extra["matches"] is not None:
            v5["trials"] = _match_trials(extra, data, idx, lo, hi, cfg,
                                         raw_args, jobs["SEQ"][2], ll_mat)
    return (jobs, n, minq, qual_depth, ll_mat, raw_args, ll_capable, v5)


def encode_prepared_block(pre, cfg: CodecConfig, backend) -> EncodedBlock:
    """Device half of encode_block_fast: code every stream of a prepared
    block and assemble the EncodedBlock. For format v5 blocks with match
    trials, the SEQ stream is coded per trial variant and the smallest
    seq+match total wins (flags bit0 records the choice)."""
    jobs, n, minq, qual_depth, ll_mat, raw_args, ll_capable, v5 = pre
    raw_out = None
    if raw_args is not None:
        blk_bytes, seq_offs, qual_offs, lengths = raw_args
        raw_out = backend.encode_seq_qual_raw(
            jobs["SEQ"][1], jobs["QUAL"][1], blk_bytes, seq_offs,
            qual_offs, lengths, cfg.lanes, _BASE_TO_CODE_DEV, minq,
            ll_mat, jobs["SEQ"][3], padded=True)
    streams: dict[str, EncodedStream] = {}
    flags = 0
    for name in streams_for(cfg.fmt):
        kind, geom, syms, counts, pos, reset = jobs[name]
        if name not in ("SEQ", "QUAL") and syms.shape[0] == 0:
            # all-empty lane stream (e.g. the MATCH slot when no trial
            # wins): byte-identical to coding zero steps, no device call
            c64 = np.asarray(counts).astype(np.int64)
            streams[name] = EncodedStream(
                c64, np.zeros_like(c64),
                np.zeros((len(c64), 0), dtype=np.uint8))
            continue
        if raw_out is not None and name in ("SEQ", "QUAL"):
            payload, lens = raw_out[name]
        elif ll_capable and name in ("SEQ", "QUAL"):
            payload, lens = backend.encode_stream_ll(kind, geom, syms,
                                                     ll_mat, counts)
        else:
            payload, lens = backend.encode_stream(kind, geom, syms, counts,
                                                  pos=pos, reset=reset)
        streams[name] = EncodedStream(np.asarray(counts).astype(np.int64),
                                      lens, payload)
    if v5 is not None and v5["trials"]:
        sgeom = jobs["SEQ"][1]
        counts = jobs["SEQ"][3]
        best_total = int(np.asarray(streams["SEQ"].lane_lens).sum())
        for (t, alt, msyms, mcounts, mflag) in v5["trials"]:
            if raw_args is not None:
                out_e = backend.encode_seq_qual_raw(
                    sgeom, jobs["QUAL"][1], alt[0], alt[1], alt[2],
                    alt[3], cfg.lanes, _BASE_TO_CODE_DEV, minq, ll_mat,
                    counts, padded=True, seq_mflag=mflag,
                    only=("SEQ",))
                ep, el = out_e["SEQ"]
            elif ll_capable:
                ep, el = backend.encode_stream_ll("seq", sgeom, alt,
                                                  ll_mat, counts,
                                                  mflag=mflag)
            else:
                _pos, _reset = jobs["SEQ"][4], jobs["SEQ"][5]
                ep, el = backend.encode_stream("seq", sgeom, alt, counts,
                                               pos=_pos, reset=_reset,
                                               mflag=mflag)
            mp, ml = backend.encode_stream("byte", cfg.bytes_, msyms,
                                           mcounts)
            total = int(np.asarray(el).sum()) + int(np.asarray(ml).sum())
            if total < best_total:
                best_total = total
                flags = MATCH_USED
                streams["SEQ"] = EncodedStream(
                    np.asarray(counts).astype(np.int64), el, ep)
                streams["MATCH"] = EncodedStream(
                    np.asarray(mcounts).astype(np.int64), ml, mp)
    if v5 is not None and v5["qual_nodelta"]:
        flags |= QUAL_NODELTA
    return EncodedBlock(n, minq, qual_depth, streams, flags=flags,
                        seq_order=(v5 or {}).get("seq_order", 0))


def encode_block_fast(data: np.ndarray, idx: dict, lo: int, hi: int,
                      cfg: CodecConfig, backend) -> EncodedBlock:
    return encode_prepared_block(
        prepare_block_fast(data, idx, lo, hi, cfg, backend), cfg, backend)


def decode_block_device(blk: EncodedBlock, cfg: CodecConfig, backend,
                        skip_seq_qual: bool = False):
    """Device half of block decode: entropy-decode all seven streams and
    lane-unpack SEQ/QUAL to record-major byte buffers. Returns an opaque
    intermediate for decode_block_finish (the host-heavy half: ID chain
    decode, SEQX patch, FASTQ assembly) — split so a pipelined caller
    can overlap block k's host finish with block k+1's device work.
    skip_seq_qual=True decodes only the aux streams (the sharded driver
    batches SEQ/QUAL across blocks) — the intermediate carries None in
    the seq/qual byte slots and the caller patches them in."""
    n = blk.num_records
    W, Wa = cfg.lanes, cfg.aux_lanes
    if n == 0:
        return None

    def dec_lanes(name, kind="byte", geom=None, counts=None, pos=None,
                  reset=None):
        es = blk.streams[name]
        g = geom if geom is not None else cfg.bytes_
        c = counts if counts is not None else es.sym_counts
        S = int(np.asarray(c).max()) if len(c) else 0
        syms = backend.decode_stream(kind, g, es.payload, es.lane_lens,
                                     c, S, pos=pos, reset=reset)
        if syms.size:  # one blocked transpose, then zero-copy row views
            rows = native.transpose_mat(np.ascontiguousarray(syms))
            if rows.dtype != np.uint8:  # numpy-oracle backend: one
                rows = rows.astype(np.uint8)  # whole-matrix downcast
            return [rows[w, : c[w]] for w in range(len(c))]
        return [np.zeros(0, dtype=np.uint8) for _ in range(len(c))]

    prev_step = Wa if cfg.fmt >= 3 else 1  # delta baseline (frozen/fmt)

    # 1. lengths
    len_lanes = dec_lanes("LEN")
    lengths = native.lens_decode(len_lanes, n, Wa, prev_step)

    # 2. flags (implicit counts: 3 per record)
    rec_per_lane = (n - np.arange(Wa) + Wa - 1) // Wa
    fcounts = 3 * rec_per_lane
    flag_lanes = dec_lanes("FLAG", kind="flag", geom=cfg.flags,
                           counts=fcounts)
    # back to record order: lane-grouped triples -> [n, 3] (C++ gather)
    f_grouped = np.concatenate([fl for fl in flag_lanes]) if n else \
        np.zeros(0, np.uint8)
    flags = native.flags_reorder(f_grouped, n, Wa)

    # 3. ID delta/exception streams (the chain decode itself is in the
    # finish half)
    idd_lanes = dec_lanes("IDD")
    idx_lanes = dec_lanes("IDX")

    # 4. seq exceptions (parsed + patched in C++ in the finish half)
    sx_lanes = dec_lanes("SEQX")

    # 4b. v5 long-range match descriptors: parsed HERE because the match
    # spans select the SEQ coder's dedicated context family (the
    # reconstruction itself happens in the finish half)
    m_arr = None
    seq_mflag = None
    if cfg.fmt >= 5 and (blk.flags & MATCH_USED):
        m_lanes = dec_lanes("MATCH")
        m_arr = _parse_match_lanes(m_lanes, Wa, n)

    # 5/6. seq + qual -> record-major flat byte buffers
    from .pipeline import _lane_lengths_matrix
    ss = blk.streams["SEQ"]
    qs = blk.streams["QUAL"]
    from dataclasses import replace
    qgeom = replace(cfg.qual, depth=blk.qual_depth,
                    delta_bits=0 if (blk.flags & QUAL_NODELTA)
                    else cfg.qual.delta_bits)
    sgeom = (replace(cfg.seq, order=blk.seq_order)
             if (cfg.fmt >= 5 and blk.seq_order) else cfg.seq)
    rec_starts = np.zeros(n, dtype=np.int64)
    rec_starts[1:] = np.cumsum(lengths[:-1])
    total = int(lengths.sum())

    if skip_seq_qual:
        return (n, prev_step, lengths, flags, idd_lanes, idx_lanes,
                sx_lanes, rec_starts, None, None, m_arr)

    if (hasattr(backend, "decode_seq_qual_raw") and native.available()
            and total < (1 << 31)):   # int32 device offsets (see encode)
        # device-raw path: decode + lane-unpack on device, d2h two flat
        # record-major buffers (no [S, W] matrices on the host)
        ll_mat = _lane_lengths_matrix(lengths, W)
        scounts = ll_mat.sum(axis=0)
        S = int(scounts.max()) if scounts.size else 0
        if m_arr is not None:
            seq_mflag = _match_mflag(m_arr, rec_starts, lengths, W,
                                     scounts)
        seq_bytes, qual_bytes = backend.decode_seq_qual_raw(
            sgeom, qgeom, ss.payload, ss.lane_lens, qs.payload,
            qs.lane_lens, ll_mat, scounts, S, rec_starts, lengths, total,
            _CODE_TO_BASE_FULL, blk.minq, seq_mflag=seq_mflag)
    else:
        if hasattr(backend, "decode_stream_ll"):
            ll_mat = _lane_lengths_matrix(lengths, W)
            scounts = ll_mat.sum(axis=0)
            S = int(scounts.max()) if scounts.size else 0
            if m_arr is not None:
                seq_mflag = _match_mflag(m_arr, rec_starts, lengths, W,
                                         scounts)
            seq_syms = backend.decode_stream_ll("seq", sgeom, ss.payload,
                                                ss.lane_lens, ll_mat,
                                                scounts, S,
                                                mflag=seq_mflag)
            qual_syms = backend.decode_stream_ll("qual", qgeom, qs.payload,
                                                 qs.lane_lens, ll_mat,
                                                 scounts, S)
        else:
            _, scounts, S, pos, reset = _seq_symbol_layout(lengths, W)
            if m_arr is not None:
                seq_mflag = _match_mflag(m_arr, rec_starts, lengths, W,
                                         scounts)
            seq_syms = backend.decode_stream("seq", sgeom, ss.payload,
                                             ss.lane_lens, scounts, S,
                                             pos=pos, reset=reset,
                                             mflag=seq_mflag)
            qual_syms = backend.decode_stream("qual", qgeom, qs.payload,
                                              qs.lane_lens, scounts, S,
                                              pos=pos, reset=reset)
        base_map = np.zeros(256, dtype=np.uint8)
        base_map[:4] = _CODE_TO_BASE
        seq_bytes = native.unpack_lanes(seq_syms & 3, lengths, W,
                                        rec_starts, total, map256=base_map)
        qual_bytes = native.unpack_lanes(qual_syms, lengths, W, rec_starts,
                                         total, bias=blk.minq)

    return (n, prev_step, lengths, flags, idd_lanes, idx_lanes, sx_lanes,
            rec_starts, seq_bytes, qual_bytes, m_arr)


def _parse_match_lanes(m_lanes, Wa: int, n: int):
    """Parse the decoded MATCH lane byte rows into record-sorted arrays
    (recs, refs, orients, vs)."""
    if native.has_matcher():
        return native.match_parse(m_lanes, Wa, n)
    from .models import matcher as M
    per: list[tuple[int, int, int, int]] = []
    for w in range(Wa):
        for ordinal, rd, orient, v in M.parse_match_lane(
                np.asarray(m_lanes[w]).tobytes()):
            r = w + ordinal * Wa
            per.append((r, r - rd, orient, v))
    per.sort()
    return (np.array([p[0] for p in per], dtype=np.int64),
            np.array([p[1] for p in per], dtype=np.int64),
            np.array([p[2] for p in per], dtype=np.uint8),
            np.array([p[3] for p in per], dtype=np.int64))


def _match_span_bounds(m_arr, lengths):
    """Vectorised frozen span rule -> (los, his) in read coords."""
    recs, refs, orients, vs = m_arr
    L = lengths[recs]
    Lref = lengths[refs]
    o1 = orients.astype(bool)
    los = np.where(o1, np.maximum(0, L + vs - Lref), np.maximum(0, -vs))
    his = np.where(o1, np.minimum(L, L + vs), np.minimum(L, Lref - vs))
    return los, his


def _match_mflag(m_arr, rec_starts, lengths, W: int, scounts) -> np.ndarray:
    """[S, W] match-span flag matrix for the SEQ decode kernel."""
    from .models import matcher as M
    recs = m_arr[0]
    los, his = _match_span_bounds(m_arr, np.asarray(lengths))
    S = int(np.asarray(scounts).max()) if len(scounts) else 0
    if native.available() and hasattr(native.lib, "match_mflag"):
        # fused C++ flag build (see _match_trials)
        return native.match_mflag(recs, los, his, np.asarray(lengths),
                                  W, S)
    total = int(np.asarray(lengths).sum())
    d = np.zeros(total + 1, dtype=np.int32)
    keep = his > los
    starts = np.asarray(rec_starts)[recs[keep]]
    np.add.at(d, starts + los[keep], 1)
    np.add.at(d, starts + his[keep], -1)
    flag_flat = (np.cumsum(d[:-1]) > 0).astype(np.uint8)
    if native.available():
        mflag, _, _, _ = native.pack_lanes(flag_flat, rec_starts, lengths,
                                           W, S, dtype=np.uint8)
        return mflag
    from .pipeline import _gather_record_symbols  # noqa: F401 (fallback)
    mfl = [flag_flat[int(rec_starts[r]): int(rec_starts[r])
                     + int(lengths[r])].astype(np.uint32)
           for r in range(len(lengths))]
    from .pipeline import _scatter_record_symbols
    return _scatter_record_symbols(mfl, W, S, np.asarray(scounts))


def _match_reconstruct_letters(seq_bytes: np.ndarray, rec_starts, lengths,
                               m_arr, n: int) -> np.ndarray:
    """Undo the v5 e-transform on the record-major LETTER buffer, in
    record order (refs are reconstructed before their dependents)."""
    from .models import matcher as M
    if native.has_matcher():
        return native.match_reconstruct_arrays(seq_bytes, rec_starts,
                                               lengths, m_arr)
    out = np.array(seq_bytes, copy=True)
    recs, refs, orients, vs = m_arr
    for i in range(len(recs)):  # record order: refs reconstruct first
        r, ref, orient, v = (int(recs[i]), int(refs[i]), int(orients[i]),
                             int(vs[i]))
        o = int(rec_starts[r])
        L = int(lengths[r])
        c_ref = M._B2C0[out[int(rec_starts[ref]):
                            int(rec_starts[ref]) + int(lengths[ref])]]
        lo_, hi_, pred = M.pred_span(c_ref, orient, v, L)
        if hi_ <= lo_:
            continue
        e = M._B2C0[out[o + lo_: o + hi_]]
        out[o + lo_: o + hi_] = _CODE_TO_BASE[(e + pred) & 3]
    return out


def decode_block_finish(inter, cfg: CodecConfig) -> memoryview | bytes:
    """Host half of block decode: ID chain decode, v5 match
    reconstruction, SEQX patch, FASTQ assembly. Returns a bytes-like
    (memoryview, zero-copy)."""
    if inter is None:
        return b""
    (n, prev_step, lengths, flags, idd_lanes, idx_lanes, sx_lanes,
     rec_starts, seq_bytes, qual_bytes, m_arr) = inter
    if m_arr is not None:
        seq_bytes = _match_reconstruct_letters(
            np.asarray(seq_bytes), rec_starts, lengths, m_arr, n)
    ida, ioff, ilen, pla, poff, plen = native.ids_decode(
        n, cfg.aux_lanes, flags, idd_lanes, idx_lanes, prev_step)
    # SEQX exception runs are patched into the ASSEMBLED output's seq
    # fields (closed-form offsets), so seq/qual stay read-only views —
    # no 6.5 MB writable copy per block just to patch a few runs
    return native.fastq_assemble(
        n, ida, ioff, ilen,
        np.ascontiguousarray(seq_bytes), rec_starts,
        np.ascontiguousarray(qual_bytes), lengths,
        pla, poff, plen, sx_lanes=sx_lanes, fmt=cfg.fmt)


def decode_block_fast(blk: EncodedBlock, cfg: CodecConfig,
                      backend) -> memoryview | bytes:
    """Decode one block straight to FASTQ bytes (native assembly)."""
    return decode_block_finish(decode_block_device(blk, cfg, backend), cfg)
