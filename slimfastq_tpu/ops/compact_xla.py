"""Whole-array XLA compaction of chunked emission buffers.

The coder scan emits each chunk's renorm bytes densely into a fixed
[NC, W, CB] buffer; this turns them into per-lane byte streams on the
device with three one-shot XLA ops (whole-array 1-D scatter/gather
outside the coder scan, docs/KERNEL_NOTES.md §4):

1. Scatter-ADD a 1 at every chunk's start position ``w*Bmax + off[c, w]``;
   an inclusive per-lane cumsum then yields, at every output byte b, the
   NUMBER of chunk starts at or before b — minus one, the owning chunk id
   (empty chunks share their successor's start and the sum walks past
   them, so duplicates resolve deterministically).
2. Gather each position's flat *source base* ``c*W*CB + w*CB - off[c, w]``
   from the small [NC, W] base table at the owning chunk id.
3. One flat 1-D gather ``ebufs_u8[base + b]`` materialises the compacted
   [W, Bmax] payload, straight in uint8.

Positions at or beyond a lane's byte total gather garbage that lies
beyond the lane's recorded length; consumers read only up to it
(streams_jax._compact, which then appends the flush bytes). Byte
equality with ``compact_host_reference`` is pinned by
tests/test_compact_xla.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

I32 = jnp.int32


@functools.lru_cache(maxsize=64)
def _build(NC: int, W: int, CB: int, Bmax: int):
    @jax.jit
    def run(ebufs_u8, eptrs):
        # per-lane exclusive prefix offsets [NC, W] + totals [W]
        ep = eptrs.astype(I32)
        offs = jnp.cumsum(ep, axis=0) - ep
        totals = jnp.sum(ep, axis=0)
        lanes = jax.lax.broadcasted_iota(I32, (NC, W), 1)
        # 1. +1 at every chunk start; cumsum - 1 = owning chunk id at
        #    every output byte (one extra slot absorbs any off == Bmax
        #    start from an empty trailing chunk)
        tgt = jnp.where(offs < I32(Bmax), lanes * I32(Bmax) + offs,
                        I32(W * Bmax))
        starts = jnp.zeros(W * Bmax + 1, I32).at[tgt.reshape(-1)].add(1)
        cid = jnp.cumsum(starts[:-1].reshape(W, Bmax), axis=1) - 1
        cid = jnp.clip(cid, 0, I32(NC - 1))
        # 2. source base per position, from the small [NC, W] base table
        chunk_ids = jax.lax.broadcasted_iota(I32, (NC, W), 0)
        src_base = chunk_ids * I32(W * CB) + lanes * I32(CB) - offs
        lane_of = jax.lax.broadcasted_iota(I32, (W, Bmax), 0)
        base_map = src_base.reshape(NC * W)[
            (cid * I32(W) + lane_of).reshape(-1)].reshape(W, Bmax)
        # 3. flat gather, uint8 in and out
        b = jax.lax.broadcasted_iota(I32, (W, Bmax), 1)
        src = jnp.clip(base_map + b, 0, I32(NC * W * CB - 1))
        out = ebufs_u8.reshape(NC * W * CB)[src.reshape(-1)]
        return out.reshape(W, Bmax), totals

    return run


def compact_device(ebufs, eptrs, Bmax: int):
    """ebufs: [NC, W*CB] (or [NC, W, CB]) uint8 device array from the
    encode coder scan; eptrs: [NC, W] int32 valid counts. Returns
    (payload_u8 [W, Bmax], lane_totals [W] int32) — byte-identical to
    compact_host_reference up to tail garbage beyond each lane's
    total."""
    NC, W = eptrs.shape
    CB = ebufs.shape[-1] // W if ebufs.ndim == 2 else ebufs.shape[-1]
    eb = ebufs.reshape(NC, W * CB)
    if eb.dtype != jnp.uint8:
        eb = eb.astype(jnp.uint8)
    run = _build(NC, W, CB, int(Bmax))
    return run(eb, eptrs)


def compact_host_reference(ebufs, eptrs, Bmax: int):
    """NumPy oracle for tests: dense chunk buffers -> [W, Bmax] payload
    (zeros beyond each lane's total, unlike the device tail garbage)."""
    ebufs = np.asarray(ebufs)
    eptrs = np.asarray(eptrs)
    NC, W = eptrs.shape
    CB = ebufs.shape[-1] // W if ebufs.ndim == 2 else ebufs.shape[-1]
    eb = ebufs.reshape(NC, W, CB).astype(np.uint8)
    out = np.zeros((W, Bmax), dtype=np.uint8)
    totals = eptrs.sum(axis=0)
    for w in range(W):
        off = 0
        for c in range(NC):
            k = int(eptrs[c, w])
            out[w, off: off + k] = eb[c, w, :k]
            off += k
    return out, totals
