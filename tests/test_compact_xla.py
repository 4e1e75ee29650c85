"""XLA whole-array emission compaction (ops/compact_xla), the only
compaction path: the coder's dense per-chunk emission buffers become
per-lane byte streams on the device."""

import numpy as np
import pytest

import jax.numpy as jnp

from slimfastq_tpu.ops import compact_xla as CX


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compact_xla_matches_reference(seed):
    rng = np.random.default_rng(seed)
    NC = int(rng.integers(2, 12))
    W = int(rng.choice([8, 16, 64]))
    CB = int(rng.choice([16, 32, 64]))
    eptrs = rng.integers(0, CB + 1, size=(NC, W)).astype(np.int32)
    eptrs[rng.random((NC, W)) < 0.3] = 0   # empty chunks share starts
    eptrs[:, 0] = 0                        # a fully-empty lane
    ebufs = rng.integers(0, 256, size=(NC, W * CB)).astype(np.uint8)
    totals = eptrs.sum(axis=0)
    Bmax = int(totals.max()) + 128
    out, tot = CX.compact_device(jnp.asarray(ebufs), jnp.asarray(eptrs),
                                 Bmax)
    out, tot = np.asarray(out), np.asarray(tot)
    ref, rtot = CX.compact_host_reference(ebufs, eptrs, Bmax)
    assert np.array_equal(tot, rtot)
    for w in range(W):
        t = int(rtot[w])
        assert np.array_equal(out[w, :t], ref[w, :t]), f"lane {w}"


def test_compact_xla_int32_input_and_all_empty():
    # coder scans may hand int32-valued byte buffers; all-empty is legal
    NC, W, CB = 4, 8, 16
    out, tot = CX.compact_device(
        jnp.zeros((NC, W * CB), jnp.int32),
        jnp.zeros((NC, W), jnp.int32), 64)
    assert int(np.asarray(tot).sum()) == 0
    assert np.asarray(out).shape == (W, 64)


@pytest.mark.parametrize("hard", [False, True],
                         ids=["optimistic", "hard"])
def test_compaction_matches_reference_at_production_width(hard):
    """streams_jax._compact at W=1024 with the coder's chunk bound equals
    compact_host_reference plus the coder's four flush bytes per active
    lane."""
    from slimfastq_tpu.ops import ranger_np as R
    from slimfastq_tpu.ops import streams_jax

    rng = np.random.default_rng(11 + hard)
    W, NC, depth = 1024, 6, 6
    CB = streams_jax._chunk_bytes(depth, hard)
    bound = 3 * streams_jax._CHUNK_SYMS * depth if hard else CB
    eptrs = rng.integers(0, min(bound, CB) + 1,
                         size=(NC, W)).astype(np.int32)
    eptrs[rng.random((NC, W)) < 0.2] = 0
    ebufs = rng.integers(0, 256, size=(NC, W * CB)).astype(np.uint8)
    low = rng.integers(0, 1 << 32, size=W, dtype=np.uint64) \
        .astype(np.uint32)
    counts = rng.integers(0, 5, size=W)
    counts[:3] = 0                         # lanes with nothing to code
    pay, lens = streams_jax._compact(jnp.asarray(ebufs), jnp.asarray(eptrs),
                                     jnp.asarray(low), counts)
    ref, totals = CX.compact_host_reference(ebufs, eptrs,
                                            int(eptrs.sum(0).max()))
    act = counts > 0
    assert np.array_equal(lens, np.where(act, totals + R.FLUSH_BYTES, 0))
    for w in range(W):
        if not act[w]:
            continue
        t = int(totals[w])
        flush = [(int(low[w]) >> (24 - 8 * j)) & 0xFF
                 for j in range(R.FLUSH_BYTES)]
        assert np.array_equal(pay[w, :t], ref[w, :t]), f"lane {w}"
        assert list(pay[w, t:t + R.FLUSH_BYTES]) == flush, f"lane {w}"


def test_device_compact_full_encode_path_identical():
    """The encode path (encode_stream_ll -> _compact) reproduces the
    NumPy oracle's payload and lane lengths."""
    from slimfastq_tpu.config import config_for_level
    from slimfastq_tpu.ops import streams_jax, streams_np
    from slimfastq_tpu.pipeline import _lane_lengths_matrix

    rng = np.random.default_rng(3)
    cfg = config_for_level(2, lanes=16, aux_lanes=8)
    W = cfg.lanes
    lengths = rng.integers(0, 50, size=80).astype(np.int64)
    ll = _lane_lengths_matrix(lengths, W)
    counts = ll.sum(axis=0)
    S = int(counts.max())
    syms = np.zeros((S, W), dtype=np.uint32)
    offs = np.zeros(W, dtype=np.int64)
    for r, L in enumerate(lengths):
        w = r % W
        syms[offs[w]: offs[w] + L, w] = rng.integers(0, 64, L)
        offs[w] += L

    p_dev, l_dev = streams_jax.encode_stream_ll("qual", cfg.qual, syms,
                                                ll, counts)
    pos, reset = streams_np.build_pos_reset(ll, S)
    p_ref, l_ref = streams_np.encode_stream("qual", cfg.qual, syms, counts,
                                            pos=pos, reset=reset)
    assert np.array_equal(l_ref, l_dev)
    assert np.array_equal(p_ref[:, :p_dev.shape[1]], p_dev)
