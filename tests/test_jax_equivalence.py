"""Device (JAX scan) vs NumPy-oracle equivalence: byte-identical compressed
output and identical decode on random + adversarial inputs (SURVEY.md §4
item 2 — the central correctness gate for every device kernel)."""

import numpy as np
import pytest

from slimfastq_tpu.config import config_for_level
from slimfastq_tpu.ops import streams_jax, streams_np
from slimfastq_tpu.pipeline import _seq_symbol_layout, _scatter_record_symbols


def _compare_stream(kind, geom, syms, counts, pos=None, reset=None):
    p_np, l_np = streams_np.encode_stream(kind, geom, syms, counts,
                                          pos=pos, reset=reset)
    p_jx, l_jx = streams_jax.encode_stream(kind, geom, syms, counts,
                                           pos=pos, reset=reset)
    assert np.array_equal(l_np, l_jx), "lane lengths differ"
    assert np.array_equal(p_np, p_jx), "payload bytes differ"
    S = syms.shape[0]
    d_np = streams_np.decode_stream(kind, geom, p_np, l_np, counts, S,
                                    pos=pos, reset=reset)
    d_jx = streams_jax.decode_stream(kind, geom, p_np, l_np, counts, S,
                                     pos=pos, reset=reset)
    assert np.array_equal(d_np, d_jx)
    mask = np.arange(S)[:, None] < counts[None, :]
    assert np.array_equal(d_jx[mask], syms[mask])


@pytest.fixture(scope="module")
def cfg():
    return config_for_level(2, lanes=16, aux_lanes=8)


def _ragged(rng, S, W, hi):
    counts = rng.integers(0, S + 1, size=W)
    counts[0] = 0
    counts[-1] = S
    syms = rng.integers(0, hi, size=(S, W)).astype(np.uint32)
    return syms, counts


def test_byte_stream_equivalence(cfg):
    rng = np.random.default_rng(0)
    syms, counts = _ragged(rng, 300, 8, 256)
    _compare_stream("byte", cfg.bytes_, syms, counts)


def test_flag_stream_equivalence(cfg):
    rng = np.random.default_rng(1)
    syms, counts = _ragged(rng, 500, 8, 2)
    _compare_stream("flag", cfg.flags, syms, counts)


def _read_layout(rng, n, W, maxlen):
    lengths = rng.integers(0, maxlen + 1, size=n).astype(np.int64)
    _, counts, S, pos, reset = _seq_symbol_layout(lengths, W)
    return lengths, counts, S, pos, reset


def test_seq_stream_equivalence(cfg):
    rng = np.random.default_rng(2)
    W = cfg.lanes
    lengths, counts, S, pos, reset = _read_layout(rng, 100, W, 60)
    recs = [rng.integers(0, 4, size=L).astype(np.uint32) for L in lengths]
    syms = _scatter_record_symbols(recs, W, S, counts)
    _compare_stream("seq", cfg.seq, syms, counts, pos=pos, reset=reset)


def test_qual_stream_equivalence(cfg):
    rng = np.random.default_rng(3)
    W = cfg.lanes
    lengths, counts, S, pos, reset = _read_layout(rng, 100, W, 60)
    recs = []
    for L in lengths:
        q = np.clip(38 + np.cumsum(rng.integers(-2, 3, size=L)), 0, 63)
        recs.append(q.astype(np.uint32))
    syms = _scatter_record_symbols(recs, W, S, counts)
    _compare_stream("qual", cfg.qual, syms, counts, pos=pos, reset=reset)


def test_qual_adversarial_constant(cfg):
    W = cfg.lanes
    lengths = np.full(64, 40, dtype=np.int64)
    _, counts, S, pos, reset = _seq_symbol_layout(lengths, W)
    recs = [np.full(40, 30, dtype=np.uint32) for _ in lengths]
    syms = _scatter_record_symbols(recs, W, S, counts)
    _compare_stream("qual", cfg.qual, syms, counts, pos=pos, reset=reset)


def test_qual_equivalence_production_geometry_w128():
    """Production-shaped case (round-1 VERDICT weak #2): W=128 lanes with
    the TRUE level-3 quality geometry (full q2, 8k contexts), so the
    equivalence suite pins a kernel in the same geometry class the real
    encoder compiles (toy-scale W=8-32/level-2 cases can miss
    shape-dependent compile/codegen bugs)."""
    cfg3 = config_for_level(3, lanes=128, aux_lanes=8)
    rng = np.random.default_rng(21)
    W = 128
    lengths, counts, S, pos, reset = _read_layout(rng, 300, W, 80)
    recs = []
    for L in lengths:
        q = np.clip(38 + np.cumsum(rng.integers(-3, 4, size=L)), 0, 63)
        recs.append(q.astype(np.uint32))
    syms = _scatter_record_symbols(recs, W, S, counts)
    _compare_stream("qual", cfg3.qual, syms, counts, pos=pos, reset=reset)


def test_seq_equivalence_level4_table():
    """Level-4 sequence geometry (order-11, 67MB table as a loop carry) at
    reduced step count: pins the deep-table kernel path byte-for-byte."""
    cfg4 = config_for_level(4, lanes=32, aux_lanes=8)
    rng = np.random.default_rng(22)
    W = 32
    lengths, counts, S, pos, reset = _read_layout(rng, 64, W, 50)
    recs = [rng.integers(0, 4, size=L).astype(np.uint32) for L in lengths]
    syms = _scatter_record_symbols(recs, W, S, counts)
    _compare_stream("seq", cfg4.seq, syms, counts, pos=pos, reset=reset)


def test_full_file_backend_equivalence(cfg):
    """encode/decode through the whole pipeline must be byte-identical
    across backends."""
    from slimfastq_tpu.api import decode_fastq, encode_fastq
    from slimfastq_tpu.utils.synth import synth_fastq

    data = synth_fastq(300, read_len=50, seed=11, var_len=True, n_rate=0.01)
    kw = dict(lanes=16, aux_lanes=8, block_records=128)
    enc_np = encode_fastq(data, level=2, backend=streams_np, **kw)
    enc_jx = encode_fastq(data, level=2, backend=streams_jax, **kw)
    assert enc_np == enc_jx
    assert decode_fastq(enc_jx, backend=streams_jax) == data
    assert decode_fastq(enc_np, backend=streams_jax) == data


def test_ll_variants_match_oracle(cfg):
    """encode/decode_stream_ll (device-derived pos/reset) must be
    byte-identical to the oracle path."""
    rng = np.random.default_rng(5)
    W = cfg.lanes
    from slimfastq_tpu.pipeline import _lane_lengths_matrix
    lengths = rng.integers(0, 60, size=100).astype(np.int64)
    ll_mat = _lane_lengths_matrix(lengths, W)
    counts = ll_mat.sum(axis=0)
    S = int(counts.max())
    _, counts2, S2, pos, reset = _seq_symbol_layout(lengths, W)
    assert np.array_equal(counts, counts2) and S == S2
    recs = [np.clip(30 + np.cumsum(rng.integers(-2, 3, size=L)),
                    0, 63).astype(np.uint32) for L in lengths]
    syms = _scatter_record_symbols(recs, W, S, counts)

    p_np, l_np = streams_np.encode_stream("qual", cfg.qual, syms, counts,
                                          pos=pos, reset=reset)
    p_ll, l_ll = streams_jax.encode_stream_ll("qual", cfg.qual, syms,
                                              ll_mat, counts)
    assert np.array_equal(l_np, l_ll)
    assert np.array_equal(p_np, p_ll)
    d_ll = streams_jax.decode_stream_ll("qual", cfg.qual, p_np, l_np,
                                        ll_mat, counts, S)
    mask = np.arange(S)[:, None] < counts[None, :]
    assert np.array_equal(d_ll[mask], syms[mask])


def test_hard_buffer_variant_identical(cfg):
    """The overflow-insurance encode build (hard=True, worst-case chunk
    buffers) must emit byte-identical streams to the optimistic build."""
    import jax.numpy as jnp
    from slimfastq_tpu.ops import ranger_np as R

    rng = np.random.default_rng(8)
    W, S = 8, 300
    syms = rng.integers(0, 64, size=(S, W)).astype(np.uint32)
    counts = np.full(W, S)
    Sp = R.pad_steps(S)
    sched = streams_jax._build_schedule("qual", cfg.qual, Sp, W)
    sc = sched(jnp.asarray(streams_jax._pad2(syms, Sp, W)),
               jnp.asarray(streams_jax._pad2(None, Sp, W)),
               jnp.asarray(streams_jax._pad2(None, Sp, W)),
               jnp.asarray(counts.astype(np.int32)))
    outs = {}
    for hard in (False, True):
        run = streams_jax._build_encode("qual", cfg.qual, Sp, W, hard)
        ebufs, eptrs, low, emax = run(*sc)
        CB = streams_jax._chunk_bytes(cfg.qual.depth, hard)
        assert int(emax) <= CB
        outs[hard] = streams_jax._compact(ebufs, eptrs, low, counts)
    assert np.array_equal(outs[False][1], outs[True][1])
    assert np.array_equal(outs[False][0], outs[True][0])
