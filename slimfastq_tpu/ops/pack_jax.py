"""Device-side lane pack/unpack: raw FASTQ bytes <-> [Sp, W] symbol
matrices, as whole-array XLA gather/scatter kernels.

Rationale: the bulk layout transform that turns record-major
sequence/quality bytes into lane-major symbol matrices is a pure gather
(encode) / scatter (decode). It belongs on the device at device-memory
bandwidth, not on the host CPU where it was the largest encode-prep cost.
The reference packs on the host because its coder runs there
(SURVEY.md §2 sequence/quality codecs, `seqs.cpp`/`quals.cpp`
§unverified); here the coder is on the device, so the layout transform
moves with it and the host ships only raw bytes + offset arrays.

Index math (all on device, O(Sp*W) whole-array ops — NOT inside the
coder scan, docs/KERNEL_NOTES.md §4):

  record r -> lane w = r % W, ordinal j = r // W    (frozen format rule)
  ll[j, w]   = record length          (reshape of the lengths array)
  cum[j, w]  = exclusive per-lane cumsum of ll  (record's start row)
  adj[j, w]  = src_off[j, w] - cum[j, w]
  For row s of lane w the owning record is the last j with
  cum[j, w] <= s, so scatter-adding the adj *deltas* at rows cum[j, w]
  and cumsum-ing down the rows reconstructs adj(s, w) everywhere, and
      IDX[s, w] = s + adj(s, w)
  is the flat source byte for every (s, w) — the same boundary-scatter +
  cumsum trick as streams_jax._pos_reset_device. Zero-length records
  collide their delta onto the next record's row; the sum telescopes, so
  the last record starting at a row wins, which is exactly the pack
  order. Rows past a lane's total are inactive (the coder masks them via
  counts); their IDX is clipped in range and the gathered garbage never
  reaches the bit stream.

Shapes are bucket-quantised (data length to 1 MB, flat output likewise)
so each geometry compiles once, not once per block.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

I32 = jnp.int32
U8 = jnp.uint8

_BUCKET = 1 << 20  # flat-buffer length quantum (1 MB)


def pad_flat(nbytes: int) -> int:
    return max(_BUCKET, ((nbytes + _BUCKET - 1) // _BUCKET) * _BUCKET)


def _adj_rows(off_mat, ll_mat, Sp: int, W: int):
    """[Sp, W] adj(s, w) from per-record offsets/lengths (see module doc)."""
    Rpl = ll_mat.shape[0]
    if Rpl > 1:
        cum = jnp.concatenate(
            [jnp.zeros((1, W), I32), jnp.cumsum(ll_mat[:-1], axis=0)],
            axis=0)
    else:
        cum = jnp.zeros((Rpl, W), I32)
    adj = off_mat - cum
    deltas = jnp.concatenate([adj[:1], adj[1:] - adj[:-1]], axis=0)
    lane_ids = jax.lax.broadcasted_iota(I32, (Rpl, W), 1)
    flat = jnp.where(cum < Sp, cum * W + lane_ids, Sp * W)
    acc = jnp.zeros(Sp * W + 1, I32).at[flat.reshape(-1)].add(
        deltas.reshape(-1))
    return jnp.cumsum(acc[:-1].reshape(Sp, W), axis=0)


@functools.lru_cache(maxsize=256)
def _build_pack(Sp: int, W: int, Rpl: int, Dp: int, use_map: bool):
    """data [Dp] u8, off/ll [Rpl, W] i32, aux (map [256] u8 | bias i32)
    -> syms [Sp, W] u8."""

    @jax.jit
    def run(data, off_mat, ll_mat, aux):
        adj = _adj_rows(off_mat, ll_mat, Sp, W)
        s_idx = jax.lax.broadcasted_iota(I32, (Sp, W), 0)
        idx = jnp.clip(s_idx + adj, 0, Dp - 1)
        raw = data[idx.reshape(-1)].reshape(Sp, W)
        if use_map:
            return aux[raw.astype(I32)]
        return (raw.astype(I32) - aux).astype(U8)

    return run


@functools.lru_cache(maxsize=256)
def _build_unpack(Sp: int, W: int, Rpl: int, Tp: int, use_map: bool):
    """syms [Sp, W] u8, out-offset/ll [Rpl, W] i32, aux -> flat [Tp] u8
    (record-major)."""

    @jax.jit
    def run(syms, off_mat, ll_mat, aux):
        adj = _adj_rows(off_mat, ll_mat, Sp, W)
        s_idx = jax.lax.broadcasted_iota(I32, (Sp, W), 0)
        counts = jnp.sum(ll_mat, axis=0)
        active = s_idx < counts[None, :]
        idx = jnp.where(active, jnp.clip(s_idx + adj, 0, Tp - 1), Tp)
        flat = jnp.zeros(Tp + 1, U8).at[idx.reshape(-1)].set(
            syms.reshape(-1))[:-1]
        if use_map:
            return aux[flat.astype(I32)]
        return (flat.astype(I32) + aux).astype(U8)

    return run


def _adj_rows_pair(off_a, off_b, ll_mat, Sp: int, W: int):
    """Two adj grids (shared boundary rows) in one scatter + cumsum:
    [Sp, W, 2]. Used to pack/unpack SEQ and QUAL together — they share
    the lane layout (same lengths), only the source offsets differ."""
    Rpl = ll_mat.shape[0]
    if Rpl > 1:
        cum = jnp.concatenate(
            [jnp.zeros((1, W), I32), jnp.cumsum(ll_mat[:-1], axis=0)],
            axis=0)
    else:
        cum = jnp.zeros((Rpl, W), I32)
    adj = jnp.stack([off_a - cum, off_b - cum], axis=-1)  # [Rpl, W, 2]
    deltas = jnp.concatenate([adj[:1], adj[1:] - adj[:-1]], axis=0)
    lane_ids = jax.lax.broadcasted_iota(I32, (Rpl, W), 1)
    flat = jnp.where(cum < Sp, cum * W + lane_ids, Sp * W)
    acc = jnp.zeros((Sp * W + 1, 2), I32).at[flat.reshape(-1)].add(
        deltas.reshape(-1, 2))
    return jnp.cumsum(acc[:-1].reshape(Sp, W, 2), axis=0)


@functools.lru_cache(maxsize=256)
def _build_pack_pair(Sp: int, W: int, Rpl: int, Dp: int):
    """data [Dp] u8, seq/qual offsets + ll [Rpl, W] i32, seq map [256] u8,
    qual bias i32 -> (seq_syms, qual_syms) [Sp, W] u8."""

    @jax.jit
    def run(data, off_s, off_q, ll_mat, smap, qbias):
        adj = _adj_rows_pair(off_s, off_q, ll_mat, Sp, W)
        s_idx = jax.lax.broadcasted_iota(I32, (Sp, W), 0)
        idx = jnp.clip(s_idx[:, :, None] + adj, 0, Dp - 1)
        raw = data[idx.reshape(-1)].reshape(Sp, W, 2)
        seq = smap[raw[:, :, 0].astype(I32)]
        qual = (raw[:, :, 1].astype(I32) - qbias).astype(U8)
        return seq, qual

    return run


@functools.lru_cache(maxsize=256)
def _build_unpack_pair(Sp: int, W: int, Rpl: int, Tp: int):
    """(seq_syms, qual_syms) [Sp, W] u8, out-offset/ll [Rpl, W] i32,
    seq map [256] u8, qual bias -> (seq_flat, qual_flat) [Tp] u8
    (record-major; same output offsets for both)."""

    @jax.jit
    def run(seq_syms, qual_syms, off_mat, ll_mat, smap, qbias):
        adj = _adj_rows(off_mat, ll_mat, Sp, W)
        s_idx = jax.lax.broadcasted_iota(I32, (Sp, W), 0)
        counts = jnp.sum(ll_mat, axis=0)
        active = s_idx < counts[None, :]
        idx = jnp.where(active, jnp.clip(s_idx + adj, 0, Tp - 1), Tp)
        pair = jnp.stack([seq_syms, qual_syms], axis=-1)  # [Sp, W, 2]
        flat = jnp.zeros((Tp + 1, 2), U8).at[idx.reshape(-1)].set(
            pair.reshape(-1, 2))[:-1]
        seq = smap[flat[:, 0].astype(I32)]
        qual = (flat[:, 1].astype(I32) + qbias).astype(U8)
        return seq, qual

    return run


def pack_pair_device(data_dev, seq_offs, qual_offs, lengths, W: int,
                     Sp: int, seq_map: np.ndarray, qual_bias):
    """SEQ + QUAL lane pack in one fused kernel (shared index math)."""
    n = len(seq_offs)
    Rpl = max((n + W - 1) // W, 1)
    off_s, ll_mat = _mats(seq_offs, lengths, W, Rpl)
    off_q, _ = _mats(qual_offs, lengths, W, Rpl)
    run = _build_pack_pair(Sp, W, Rpl, int(data_dev.shape[0]))
    return run(data_dev, jnp.asarray(off_s), jnp.asarray(off_q),
               jnp.asarray(ll_mat), jnp.asarray(seq_map),
               jnp.int32(qual_bias))


def unpack_pair_device(seq_syms, qual_syms, out_offs, lengths, W: int,
                       total: int, seq_map: np.ndarray, qual_bias):
    """SEQ + QUAL lane unpack in one fused kernel. Returns two device
    [pad_flat(total)] u8 record-major buffers."""
    n = len(out_offs)
    Sp = int(seq_syms.shape[0])
    Rpl = max((n + W - 1) // W, 1)
    off_mat, ll_mat = _mats(out_offs, lengths, W, Rpl)
    Tp = pad_flat(total)
    run = _build_unpack_pair(Sp, W, Rpl, Tp)
    return run(seq_syms, qual_syms, jnp.asarray(off_mat),
               jnp.asarray(ll_mat), jnp.asarray(seq_map),
               jnp.int32(qual_bias))


def _mats(offs: np.ndarray, lengths: np.ndarray, W: int, Rpl: int):
    """Host-side [Rpl, W] i32 reshapes of per-record offsets/lengths."""
    n = len(offs)
    off_mat = np.zeros(Rpl * W, dtype=np.int32)
    ll_mat = np.zeros(Rpl * W, dtype=np.int32)
    off_mat[:n] = offs
    ll_mat[:n] = lengths
    return off_mat.reshape(Rpl, W), ll_mat.reshape(Rpl, W)


def pack_device(data_dev, offs: np.ndarray, lengths: np.ndarray, W: int,
                Sp: int, map256: np.ndarray | None = None, bias: int = 0):
    """Gather record-major bytes into the [Sp, W] lane-major symbol
    matrix on device. data_dev: device u8 array of pad_flat length;
    offs are relative to its start. Returns a device array."""
    n = len(offs)
    Rpl = max((n + W - 1) // W, 1)
    off_mat, ll_mat = _mats(offs, lengths, W, Rpl)
    run = _build_pack(Sp, W, Rpl, int(data_dev.shape[0]), map256 is not None)
    aux = jnp.asarray(map256) if map256 is not None else jnp.int32(bias)
    return run(data_dev, jnp.asarray(off_mat), jnp.asarray(ll_mat), aux)


def unpack_device(syms_dev, out_offs: np.ndarray, lengths: np.ndarray,
                  W: int, total: int, map256: np.ndarray | None = None,
                  bias: int = 0):
    """Scatter the [Sp, W] lane-major symbols back to a record-major flat
    device buffer of pad_flat(total) bytes (only the first `total` are
    meaningful)."""
    n = len(out_offs)
    Sp = int(syms_dev.shape[0])
    Rpl = max((n + W - 1) // W, 1)
    off_mat, ll_mat = _mats(out_offs, lengths, W, Rpl)
    Tp = pad_flat(total)
    run = _build_unpack(Sp, W, Rpl, Tp, map256 is not None)
    aux = jnp.asarray(map256) if map256 is not None else jnp.int32(bias)
    return run(syms_dev, jnp.asarray(off_mat), jnp.asarray(ll_mat), aux)
