"""Multi-device block parallelism over a JAX mesh.

The reference is single-threaded with no comm backend (SURVEY.md §2
"Parallelism strategies in the reference: NONE"); scaling here is
*introduced by design*:

  * lane parallelism (intra-chip): W interleaved coder streams — the
    sequence-parallel analogue, implemented inside the stream kernels;
  * block data-parallelism (this module): record-blocks sharded over a 1-D
    ``Mesh(("blocks",))`` with ``shard_map``; every block carries its own
    adaptive model state, so shards need zero communication during coding;
  * ordered gather: per-block payloads are fixed-shape (worst-case padded)
    device buffers; true lengths travel as a [B, W] array. Device->host
    gather preserves block order, and the host writes the container index
    in input order — bit-identical to the sequential path.

Multi-host: ``jax.distributed.initialize`` + the same mesh spanning all
processes; ``multihost_utils.process_allgather`` collects lengths, and each
host slices out its addressable shards (blocks are independent, so hosts
can also write disjoint container shards and merge indexes).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import ranger_np as R
from ..ops import streams_jax


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), ("blocks",))


@functools.lru_cache(maxsize=64)
def _build_sharded_encode(kind: str, geom, S: int, W: int, hard: bool,
                          mesh: Mesh | None):
    """mesh=None builds the single-device jit(vmap) form — the batched
    multi-block kernel the single-chip small-block path reuses
    (pipeline_native window batching; round-4 VERDICT next #3)."""
    sched = streams_jax._build_schedule(kind, geom, S, W)
    run = streams_jax._build_encode(kind, geom, S, W, hard)

    def one_block(syms, poss, resets, counts):
        idx_c, bit_c = sched(syms, poss, resets, counts)
        return run(idx_c, bit_c)

    vrun = jax.vmap(one_block)

    @jax.jit
    def sharded(syms, poss, resets, counts):
        if mesh is not None:
            spec = NamedSharding(mesh, P("blocks"))
            syms = jax.lax.with_sharding_constraint(syms, spec)
        ebufs, eptrs, low, emax = vrun(syms, poss, resets, counts)
        if mesh is None:
            return ebufs, eptrs, low, emax
        spec = NamedSharding(mesh, P("blocks"))
        return (jax.lax.with_sharding_constraint(ebufs, spec),
                jax.lax.with_sharding_constraint(eptrs, spec),
                low, emax)

    return sharded


@functools.lru_cache(maxsize=64)
def _build_sharded_decode(kind: str, geom, S: int, W: int, Lw: int,
                          mesh: Mesh | None):
    run = streams_jax._build_decode(kind, geom, S, W, Lw)
    vrun = jax.vmap(run)

    @jax.jit
    def sharded(paywords, lens, acts, poss, resets):
        if mesh is None:
            return vrun(paywords, lens, acts, poss, resets)
        spec = NamedSharding(mesh, P("blocks"))
        paywords = jax.lax.with_sharding_constraint(paywords, spec)
        syms = vrun(paywords, lens, acts, poss, resets)
        return jax.lax.with_sharding_constraint(syms, spec)

    return sharded


def _block_views(arr) -> list:
    """Per-block device arrays of a [B, ...] array, each left on the
    device that holds its block (so compaction runs where the block
    was coded)."""
    views: list = [None] * arr.shape[0]
    for shard in arr.addressable_shards:
        start = shard.index[0].start or 0
        for j in range(shard.data.shape[0]):
            views[start + j] = shard.data[j]
    return views


def _pad_blocks(arrs: list[np.ndarray], n: int) -> int:
    """Number of dummy blocks needed so B divides the mesh size."""
    B = len(arrs)
    return (-B) % n


def encode_stream_blocks(kind: str, geom, mesh: Mesh,
                         syms_list: list[np.ndarray],
                         counts_list: list[np.ndarray],
                         pos_list=None, reset_list=None):
    """Encode many blocks' worth of one stream, sharded over the mesh.

    Blocks are grouped by their own pad_steps bucket before batching: the
    lockstep step count is part of the bit format (flush position), so
    batching a short block with longer ones would change its bytes
    (ADVICE.md round-1 medium finding). Within a group every block shares
    pad_steps, so padding is a no-op format-wise. Output is a list of
    (payload, lens) per block, byte-identical to per-block sequential
    encoding (the correctness gate in tests/test_parallel.py).
    """
    B = len(syms_list)
    if B == 0:
        return []
    groups: dict[int, list[int]] = {}
    for b, s in enumerate(syms_list):
        groups.setdefault(R.pad_steps(max(s.shape[0], 1)), []).append(b)
    if len(groups) > 1:
        results: list = [None] * B
        for sp, idxs in groups.items():
            sub = encode_stream_blocks(
                kind, geom, mesh,
                [syms_list[b] for b in idxs],
                [counts_list[b] for b in idxs],
                None if pos_list is None else [pos_list[b] for b in idxs],
                None if reset_list is None else [reset_list[b] for b in idxs])
            for i, b in enumerate(idxs):
                results[b] = sub[i]
        return results
    W = syms_list[0].shape[1]
    S = max((s.shape[0] for s in syms_list), default=0)
    Sp = R.pad_steps(max(S, 1))
    nd = mesh.devices.size if mesh is not None else 1
    pad = _pad_blocks(syms_list, nd)
    Bp = B + pad

    syms = np.zeros((Bp, Sp, W), dtype=np.uint32)
    counts = np.zeros((Bp, W), dtype=np.int32)
    poss = np.zeros((Bp, Sp, W), dtype=np.uint32)
    resets = np.zeros((Bp, Sp, W), dtype=np.uint32)
    for b in range(B):
        s = syms_list[b]
        syms[b, : s.shape[0]] = s
        counts[b] = counts_list[b]
        if pos_list is not None and pos_list[b] is not None:
            p = pos_list[b]
            poss[b, : p.shape[0]] = p
        if reset_list is not None and reset_list[b] is not None:
            r = reset_list[b]
            resets[b, : r.shape[0]] = r

    for hard in (False, True):
        fn = _build_sharded_encode(kind, geom, Sp, W, hard, mesh)
        ebufs, eptrs, low, emax = fn(jnp.asarray(syms), jnp.asarray(poss),
                                     jnp.asarray(resets),
                                     jnp.asarray(counts))
        if int(np.asarray(emax).max()) <= streams_jax._chunk_bytes(
                geom.depth, hard):
            ebufs, eptrs = _block_views(ebufs), _block_views(eptrs)
            low = np.asarray(low)
            return [streams_jax._compact(ebufs[b], eptrs[b], low[b],
                                         counts_list[b])
                    for b in range(B)]
    raise AssertionError("encode chunk overflow even with hard buffers")


@functools.lru_cache(maxsize=32)
def _build_sharded_raw_encode(seq_geom, qual_geom, Sp: int, S: int,
                              W: int, Rpl: int, Dp: int, hard: bool,
                              mesh: Mesh):
    """Device-resident SEQ+QUAL encode for a batch of blocks: lane pack
    (gather), schedule and coder all vmapped over the block axis and
    sharded over the mesh — the multi-device twin of
    streams_jax.encode_seq_qual_raw (the single-chip raw path). The host
    never builds [S, W] symbol matrices; each block ships its raw bytes
    plus [Rpl, W] offset/length matrices."""
    from ..ops import pack_jax
    pack = pack_jax._build_pack_pair(Sp, W, Rpl, Dp)
    sched_s = streams_jax._build_schedule_ll("seq", seq_geom, Sp, S, W,
                                             Rpl)
    sched_q = streams_jax._build_schedule_ll("qual", qual_geom, Sp, S, W,
                                             Rpl)
    enc_s = streams_jax._build_encode("seq", seq_geom, Sp, W, hard)
    enc_q = streams_jax._build_encode("qual", qual_geom, Sp, W, hard)

    def one(data, off_s, off_q, ll, counts, smap, qbias):
        seq_syms, qual_syms = pack(data, off_s, off_q, ll, smap, qbias)
        es, ps, ls, ms = enc_s(*sched_s(seq_syms, ll, counts))
        eq, pq, lq, mq = enc_q(*sched_q(qual_syms, ll, counts))
        return es, ps, ls, ms, eq, pq, lq, mq

    vrun = jax.vmap(one, in_axes=(0, 0, 0, 0, 0, None, 0))

    @jax.jit
    def sharded(data, off_s, off_q, ll, counts, smap, qbias):
        if mesh is not None:
            spec = NamedSharding(mesh, P("blocks"))
            data = jax.lax.with_sharding_constraint(data, spec)
        es, ps, ls, ms, eq, pq, lq, mq = vrun(data, off_s, off_q, ll,
                                              counts, smap, qbias)
        if mesh is None:
            return es, ps, ls, ms.max(), eq, pq, lq, mq.max()
        spec = NamedSharding(mesh, P("blocks"))
        return (jax.lax.with_sharding_constraint(es, spec),
                jax.lax.with_sharding_constraint(ps, spec), ls, ms.max(),
                jax.lax.with_sharding_constraint(eq, spec),
                jax.lax.with_sharding_constraint(pq, spec), lq, mq.max())

    return sharded


def encode_seq_qual_raw_blocks(sgeom_list, mesh: Mesh, raw_list,
                               counts_list, qgeom_list,
                               minq_list, seq_map):
    """Encode SEQ+QUAL for many blocks with on-device lane packing,
    sharded over the mesh. raw_list[b] = (padded raw bytes, seq_offs,
    qual_offs, lengths) as produced by pipeline_native.prepare_block_fast.
    sgeom_list[b] is the block's effective SEQ geometry (format v5 order
    fallback can differ per block). Returns a list of
    {"SEQ": (payload, lens), "QUAL": ...} per block, byte-identical to
    the sequential encode_seq_qual_raw."""
    from ..ops import pack_jax
    B = len(raw_list)
    if B == 0:
        return []
    W = counts_list[0].shape[0]
    # group by every compile-shape + format-affecting parameter: the
    # lockstep step count (pad_steps) is part of the bit format, the
    # qual/seq geometries vary per block (6/7/8-bit depth; v5 order
    # fallback), Rpl/Dp are compile shapes
    groups: dict[tuple, list[int]] = {}
    results: list = [None] * B
    for b in range(B):
        counts = np.asarray(counts_list[b])
        if not (counts > 0).any():  # nothing codable: empty streams
            z = (np.zeros((W, 0), dtype=np.uint8),
                 np.zeros(W, dtype=np.int64))
            results[b] = {"SEQ": z, "QUAL": (z[0].copy(), z[1].copy())}
            continue
        S = int(counts.max())
        Sp = R.pad_steps(max(S, 1))
        n = len(raw_list[b][3])
        Rpl = max((n + W - 1) // W, 1)
        Dp = int(raw_list[b][0].shape[0])
        key = (sgeom_list[b], qgeom_list[b], Sp, Rpl, Dp)
        groups.setdefault(key, []).append(b)
    for (seq_geom, qgeom, Sp, Rpl, Dp), idxs in groups.items():
        Bg = len(idxs)
        nd = mesh.devices.size if mesh is not None else 1
        pad = (-Bg) % nd
        Bp = Bg + pad
        data = np.zeros((Bp, Dp), dtype=np.uint8)
        off_s = np.zeros((Bp, Rpl, W), dtype=np.int32)
        off_q = np.zeros((Bp, Rpl, W), dtype=np.int32)
        ll = np.zeros((Bp, Rpl, W), dtype=np.int32)
        counts = np.zeros((Bp, W), dtype=np.int32)
        qbias = np.zeros(Bp, dtype=np.int32)
        Smax = 1
        for i, b in enumerate(idxs):
            dpad, soffs, qoffs, lengths = raw_list[b]
            data[i] = dpad
            off_s[i], ll[i] = pack_jax._mats(soffs, lengths, W, Rpl)
            off_q[i], _ = pack_jax._mats(qoffs, lengths, W, Rpl)
            counts[i] = counts_list[b]
            qbias[i] = minq_list[b]
            Smax = max(Smax, int(np.asarray(counts_list[b]).max()))
        for hard in (False, True):
            fn = _build_sharded_raw_encode(seq_geom, qgeom, Sp, Smax, W,
                                           Rpl, Dp, hard, mesh)
            es, ps, ls, ms, eq, pq, lq, mq = fn(
                jnp.asarray(data), jnp.asarray(off_s), jnp.asarray(off_q),
                jnp.asarray(ll), jnp.asarray(counts),
                jnp.asarray(seq_map), jnp.asarray(qbias))
            CB_s = streams_jax._chunk_bytes(seq_geom.depth, hard)
            CB_q = streams_jax._chunk_bytes(qgeom.depth, hard)
            if int(np.asarray(ms).max()) <= CB_s and \
                    int(np.asarray(mq).max()) <= CB_q:
                es, ps = _block_views(es), _block_views(ps)
                eq, pq = _block_views(eq), _block_views(pq)
                ls, lq = np.asarray(ls), np.asarray(lq)
                for i, b in enumerate(idxs):
                    cb = np.asarray(counts_list[b])
                    results[b] = {
                        "SEQ": streams_jax._compact(es[i], ps[i], ls[i], cb),
                        "QUAL": streams_jax._compact(eq[i], pq[i], lq[i],
                                                     cb)}
                break
        else:
            raise AssertionError(
                "encode chunk overflow even with hard buffers")
    return results


@functools.lru_cache(maxsize=32)
def _build_sharded_raw_decode(seq_geom, qual_geom, Sp: int, S: int,
                              W: int, Rpl: int, Lw_s: int, Lw_q: int,
                              Tp: int, mesh: Mesh):
    """Batched SEQ+QUAL decode + on-device lane unpack: the multi-device
    twin of streams_jax.decode_seq_qual_raw. Returns record-major flat
    byte buffers [B, Tp] for both streams."""
    from ..ops import pack_jax
    dec_s = streams_jax._build_decode_ll("seq", seq_geom, Sp, S, W, Rpl,
                                         Lw_s)
    dec_q = streams_jax._build_decode_ll("qual", qual_geom, Sp, S, W,
                                         Rpl, Lw_q)
    unpack = pack_jax._build_unpack_pair(Sp, W, Rpl, Tp)

    def one(words_s, lens_s, words_q, lens_q, ll, counts, off_o, smap,
            qbias):
        syms_s = dec_s(words_s, lens_s, ll, counts)
        syms_q = dec_q(words_q, lens_q, ll, counts)
        return unpack(syms_s, syms_q, off_o, ll, smap, qbias)

    vrun = jax.vmap(one, in_axes=(0, 0, 0, 0, 0, 0, 0, None, 0))

    @jax.jit
    def sharded(words_s, lens_s, words_q, lens_q, ll, counts, off_o,
                smap, qbias):
        if mesh is None:
            return vrun(words_s, lens_s, words_q, lens_q, ll, counts,
                        off_o, smap, qbias)
        spec = NamedSharding(mesh, P("blocks"))
        words_s = jax.lax.with_sharding_constraint(words_s, spec)
        words_q = jax.lax.with_sharding_constraint(words_q, spec)
        seq_flat, qual_flat = vrun(words_s, lens_s, words_q, lens_q, ll,
                                   counts, off_o, smap, qbias)
        return (jax.lax.with_sharding_constraint(seq_flat, spec),
                jax.lax.with_sharding_constraint(qual_flat, spec))

    return sharded


def decode_seq_qual_raw_blocks(sgeom_list, mesh: Mesh, pay_s, lens_s,
                               pay_q, lens_q, ll_list, counts_list,
                               starts_list, lengths_list, totals,
                               qgeom_list, minq_list, seq_map):
    """Decode SEQ+QUAL of many blocks and lane-unpack them on device,
    sharded over the mesh. Returns a list of (seq_bytes, qual_bytes)
    record-major buffers per block, identical to the sequential
    decode_seq_qual_raw. sgeom_list[b] is the block's effective SEQ
    geometry (v5 order fallback)."""
    from ..ops import pack_jax
    B = len(pay_s)
    if B == 0:
        return []
    W = counts_list[0].shape[0]
    groups: dict[tuple, list[int]] = {}
    results: list = [None] * B
    for b in range(B):
        counts = np.asarray(counts_list[b])
        total = int(totals[b])
        if not (counts > 0).any() or total == 0:
            results[b] = (np.zeros(total, dtype=np.uint8),
                          np.zeros(total, dtype=np.uint8))
            continue
        S = int(counts.max())
        Sp = R.pad_steps(max(S, 1))
        n = len(lengths_list[b])
        Rpl = max((n + W - 1) // W, 1)
        Tp = pack_jax.pad_flat(total)
        key = (sgeom_list[b], qgeom_list[b], Sp, Rpl, Tp)
        groups.setdefault(key, []).append(b)

    def _lb(pays, idxs):
        L = max(max((int(pays[b].shape[1]) for b in idxs), default=1), 1)
        return ((L + 2047) // 2048) * 2048

    for (seq_geom, qgeom, Sp, Rpl, Tp), idxs in groups.items():
        Bg = len(idxs)
        nd = mesh.devices.size if mesh is not None else 1
        Bp = Bg + ((-Bg) % nd)
        Lb_s, Lb_q = _lb(pay_s, idxs), _lb(pay_q, idxs)
        words_s = np.zeros((Bp, W * (Lb_s // 4)), dtype=np.uint32)
        words_q = np.zeros((Bp, W * (Lb_q // 4)), dtype=np.uint32)
        wlens_s = np.zeros((Bp, W), dtype=np.int32)
        wlens_q = np.zeros((Bp, W), dtype=np.int32)
        ll = np.zeros((Bp, Rpl, W), dtype=np.int32)
        counts = np.zeros((Bp, W), dtype=np.int32)
        off_o = np.zeros((Bp, Rpl, W), dtype=np.int32)
        qbias = np.zeros(Bp, dtype=np.int32)
        Smax = 1
        for i, b in enumerate(idxs):
            for pays, lens, words, wlens, Lb in (
                    (pay_s, lens_s, words_s, wlens_s, Lb_s),
                    (pay_q, lens_q, words_q, wlens_q, Lb_q)):
                p = pays[b]
                pad = np.zeros((W, Lb), dtype=np.uint8)
                pad[:, : p.shape[1]] = p
                words[i] = pad.view("<u4").reshape(-1)
                wlens[i] = np.asarray(lens[b]).astype(np.int32)
            off_o[i], ll[i] = pack_jax._mats(starts_list[b],
                                             lengths_list[b], W, Rpl)
            counts[i] = counts_list[b]
            qbias[i] = minq_list[b]
            Smax = max(Smax, int(np.asarray(counts_list[b]).max()))
        fn = _build_sharded_raw_decode(seq_geom, qgeom, Sp, Smax, W, Rpl,
                                       Lb_s // 4, Lb_q // 4, Tp, mesh)
        seq_flat, qual_flat = fn(
            jnp.asarray(words_s), jnp.asarray(wlens_s),
            jnp.asarray(words_q), jnp.asarray(wlens_q),
            jnp.asarray(ll), jnp.asarray(counts), jnp.asarray(off_o),
            jnp.asarray(seq_map), jnp.asarray(qbias))
        seq_flat, qual_flat = np.asarray(seq_flat), np.asarray(qual_flat)
        for i, b in enumerate(idxs):
            total = int(totals[b])
            results[b] = (seq_flat[i, :total].copy(),
                          qual_flat[i, :total].copy())
    return results


def decode_stream_blocks(kind: str, geom, mesh: Mesh,
                         payload_list, lens_list, counts_list,
                         steps_list, pos_list=None, reset_list=None):
    """Decode many blocks of one stream, sharded over the mesh."""
    B = len(payload_list)
    if B == 0:
        return []
    W = payload_list[0].shape[0]
    S = max(steps_list)
    Sp = R.pad_steps(max(S, 1))
    Lb = max(max((int(p.shape[1]) for p in payload_list), default=1), 1)
    Lb = ((Lb + 2047) // 2048) * 2048
    Lw = Lb // 4
    nd = mesh.devices.size if mesh is not None else 1
    pad = (-B) % nd
    Bp = B + pad
    K = streams_jax._CHUNK_SYMS
    NC = Sp // K

    words = np.zeros((Bp, W * Lw), dtype=np.uint32)
    lens = np.zeros((Bp, W), dtype=np.int32)
    acts = np.zeros((Bp, Sp, W), dtype=np.int32)
    poss = np.zeros((Bp, Sp, W), dtype=np.uint32)
    resets = np.zeros((Bp, Sp, W), dtype=np.uint32)
    for b in range(B):
        p = payload_list[b]
        pay = np.zeros((W, Lb), dtype=np.uint8)
        pay[:, : p.shape[1]] = p
        words[b] = pay.view("<u4").reshape(-1)
        lens[b] = lens_list[b]
        acts[b] = np.arange(Sp)[:, None] < counts_list[b][None, :]
        if pos_list is not None and pos_list[b] is not None:
            q = pos_list[b]
            poss[b, : q.shape[0]] = q
        if reset_list is not None and reset_list[b] is not None:
            r = reset_list[b]
            resets[b, : r.shape[0]] = r

    fn = _build_sharded_decode(kind, geom, Sp, W, Lw, mesh)
    syms = np.asarray(fn(jnp.asarray(words), jnp.asarray(lens),
                         jnp.asarray(acts.reshape(Bp, NC, K, W)),
                         jnp.asarray(poss.reshape(Bp, NC, K, W)),
                         jnp.asarray(resets.reshape(Bp, NC, K, W))))
    out = []
    for b in range(B):
        Sb = steps_list[b]
        o = syms[b, :Sb].astype(np.uint32)
        mask = np.arange(Sb)[:, None] < counts_list[b][None, :]
        out.append(np.where(mask, o, np.uint32(0)))
    return out
