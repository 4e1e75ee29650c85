"""Sharded block container — the block-parallel replacement for slimfastq's
single-file multiplexed "filer" (SURVEY.md §2 "Container"): instead of
interleaved per-stream pages in one serial file, the container is a header +
a sequence of independently-decodable record-blocks + a trailing index of
block byte-ranges. Independent blocks are what enable data-parallel device
encode/decode, ordered multi-host gather, resumable partial output, and
bounded-memory streaming decode (SURVEY.md §5 failure detection /
checkpoint-resume).

Format VERSION 5 = VERSION 4 + the long-range read-match stream and the
per-block SEQ order fallback (round-3 VERDICT items #4/#5):
  * blocks carry an 8th stream, MATCH (models/matcher.py is the frozen
    descriptor + e-transform rule); the block-header reserved u16 becomes
    u8 flags (bit0: SEQ symbols are e-transformed; bit1: QUAL coded with
    delta_bits=0) + u8 seq_order (the SEQ context order actually used;
    0 = the header geometry's default). Both bytes were always written
    as zero by v2-v4 encoders, so the block framing is layout-compatible.
  * SEQ positions inside a match span use a dedicated match-context
    family (config.SeqGeom.match_bits; ctx = tree_ctx + low bits of the
    rolling e-symbol history).
  * The header appends one geometry byte (seq.match_bits) after v4's
    rate_lo pair.
v1-v4 containers keep decoding (their stream inventory has no MATCH and
their flag/seq_order bytes are zero).

Format VERSION 4 = VERSION 3 streams + the visit-count adaptation
warm-up (ranger_np.table_update: entries adapt at shift min(rate,
rate_lo + ceil_log2(visits+1)) when a geometry sets 0 < rate_lo < rate).
The header grows two geometry bytes (qual.rate_lo, seq.rate_lo); block
framing and the ID/LEN baseline rule are unchanged from v3. v1/v2/v3
containers keep decoding (their geometries carry rate_lo = 0).

Format VERSION 3 = VERSION 2 layout with the ID/LEN delta baseline moved
from the globally previous record r-1 to the aux-lane-local previous
record r-Wa (pipeline.py stream_jobs), which makes the host-side ID/LEN
decode chains independent per lane and therefore lane-parallel. The
container framing is byte-identical to v2 apart from the version field.

Format VERSION 2 layout (all little-endian):
  header:  magic 'SFQT' | u16 version | u8 level | u8 flags
           | u32 lanes | u32 aux_lanes | u32 block_records
           | geometry (11 bytes: qual depth,q2_bits,pos_bits,pos_shift,rate;
             seq order,rate; byte order,rate; flag hist_bits,rate)
           | u8 reserved | u32 crc32(header so far)
  block:   u32 crc32(body) | u32 body_len | body:
           u32 num_records | u8 minq | u8 qual_depth | u16 reserved
           then per stream (fixed STREAMS order):
             varint-delta u32 array: sym_counts  (omitted for streams whose
               counts are derivable: FLAG/SEQ/QUAL)
             varint-delta u32 array: lane_lens
             lane payload bytes (concatenated, unpadded)
  index:   u64 block_offsets[n] | u32 n | u32 crc32(offsets|n) | magic 'SFQE'

The geometry block makes every context-model knob self-describing (a round-1
finding: containers encoded with geometry overrides silently decoded with
the level's defaults); the header/index CRCs mean any single corrupt byte
anywhere in a container raises a clean ValueError. The u32 body_len prefix
is what makes single-pass bounded-memory recovery and streaming decode
possible (no index needed to find block extents).

VERSION 1 (round-1) containers remain readable: 20-byte header without
geometry/CRC, blocks without the body_len prefix, index without CRC, and
per-base (not run-length) SEQX exception coding — see pipeline.py.

varint-delta array: varint(n), then varint(a[0]), then svarint(a[i]-a[i-1]).
"""

from __future__ import annotations

import io
import struct
import zlib
from dataclasses import replace
from typing import BinaryIO, Iterator

import numpy as np

from .config import (ByteGeom, CodecConfig, FlagGeom, QualGeom, SeqGeom,
                     config_for_level)
from .pipeline import STREAMS, EncodedBlock, EncodedStream, streams_for
from .utils.bits import (get_varint, get_varint_arr, put_varint,
                         put_varint_arr, unzigzag_arr, zigzag_arr)

MAGIC = b"SFQT"
END_MAGIC = b"SFQE"
VERSION = 5

HEADER_SIZE = {1: 20, 2: 36, 3: 36, 4: 38, 5: 39}

# streams whose per-lane symbol counts the decoder can derive (FLAG from
# record count; SEQ/QUAL from decoded read lengths) — not stored
IMPLICIT_COUNTS = frozenset({"FLAG", "SEQ", "QUAL"})


def _crc32(buf) -> int:
    """zlib-compatible CRC32; large block bodies take the chunk-parallel
    native path (identical values — pinned by tests), small headers stay
    on zlib."""
    if len(buf) >= (1 << 16):
        from . import native
        if native.available():
            return native.crc32(buf)
    return zlib.crc32(buf)


def _read_exact(f: BinaryIO, n: int) -> bytes:
    buf = f.read(n)
    if len(buf) != n:
        raise ValueError("container truncated (unexpected EOF)")
    return buf


def _write_u32_array(out: bytearray, arr: np.ndarray) -> None:
    put_varint(out, len(arr))
    a = np.asarray(arr, dtype=np.int64)
    deltas = np.diff(a, prepend=np.int64(0))
    out += put_varint_arr(zigzag_arr(deltas)).tobytes()


def _read_u32_array(buf: bytes, pos: int) -> tuple[np.ndarray, int]:
    n, pos = get_varint(buf, pos)
    if n > (1 << 20):
        raise ValueError(f"implausible lane-array length {n}")
    u, pos = get_varint_arr(buf, pos, n)
    arr = np.cumsum(unzigzag_arr(u), dtype=np.int64)
    return arr, pos


def write_header(f: BinaryIO, cfg: CodecConfig) -> None:
    # The written version must match the stream rules the encoder applies
    # (pipeline keys the ID/LEN delta baseline off cfg.fmt): encoding
    # with a cfg read from an old container keeps that container's rules
    # and stamps its version. cfg.fmt<=2 (including 1) encodes v2 streams
    # with v2 framing — stream emission is identical for v1/v2 cfgs.
    # cfg.fmt >= 3 encodes the current stream rules; a v3 cfg (read from
    # a round-2 container) re-encodes as v4 only if a geometry actually
    # uses the warm-up — otherwise its streams are bit-identical to v3
    # and the stamp stays 3, so round-2 decoders keep working.
    if cfg.fmt >= 5:
        ver = 5
    elif cfg.fmt >= 3:
        warm = (0 < cfg.qual.rate_lo < cfg.qual.rate
                or 0 < cfg.seq.rate_lo < cfg.seq.rate)
        ver = 4 if (cfg.fmt >= 4 or warm) else 3
    else:
        ver = 2
    hdr = bytearray()
    hdr += MAGIC
    hdr += struct.pack("<HBBIII", ver, cfg.level, 0,
                       cfg.lanes, cfg.aux_lanes, cfg.block_records)
    q, s, b, fl = cfg.qual, cfg.seq, cfg.bytes_, cfg.flags
    hdr += struct.pack("<12B", q.depth, q.q2_bits, q.delta_bits, q.pos_bits,
                       q.pos_shift, q.rate, s.order, s.rate, b.order,
                       b.rate, fl.hist_bits, fl.rate)
    if ver >= 4:
        hdr += struct.pack("<2B", q.rate_lo, s.rate_lo)
    if ver >= 5:
        hdr += struct.pack("<B", s.match_bits)
    hdr += struct.pack("<I", zlib.crc32(bytes(hdr)))
    f.write(bytes(hdr))


def read_header(f: BinaryIO) -> CodecConfig:
    magic = _read_exact(f, 4)
    if magic != MAGIC:
        raise ValueError("not an sfq container (bad magic)")
    (version,) = struct.unpack("<H", _read_exact(f, 2))
    if version == 1:
        level, _flags, lanes, aux, blockrec = struct.unpack(
            "<BBIII", _read_exact(f, 14))
        # v1 headers carry no geometry: reconstruct from the FROZEN
        # round-1 level table (config.LEVELS_V1), never the live one —
        # level geometries may evolve under format v2+ (which serializes
        # them) without breaking old containers.
        from .config import LEVELS_V1
        base = LEVELS_V1[level]
        return replace(base, lanes=lanes, aux_lanes=aux,
                       block_records=blockrec, fmt=1)
    if version not in (2, 3, 4, 5):
        raise ValueError(f"unsupported sfq version {version}")
    hsize = HEADER_SIZE[version]
    rest = _read_exact(f, hsize - 6)
    hdr = magic + struct.pack("<H", version) + rest
    (crc,) = struct.unpack_from("<I", hdr, hsize - 4)
    if zlib.crc32(hdr[: hsize - 4]) != crc:
        raise ValueError("container header CRC mismatch (corrupt file)")
    level, _flags, lanes, aux, blockrec = struct.unpack_from("<BBIII", hdr, 6)
    (qd, qq2, qdb, qpb, qps, qr, so, sr, bo, br, fh, fr) = \
        struct.unpack_from("<12B", hdr, 20)
    qlo = slo = smb = 0
    if version >= 4:
        qlo, slo = struct.unpack_from("<2B", hdr, 32)
    if version >= 5:  # v5 appends the seq match-context width
        (smb,) = struct.unpack_from("<B", hdr, 34)
    base = config_for_level(level, lanes=lanes, aux_lanes=aux,
                            block_records=blockrec)
    return replace(base, fmt=version,
                   qual=QualGeom(depth=qd, q2_bits=qq2, delta_bits=qdb,
                                 pos_bits=qpb, pos_shift=qps, rate=qr,
                                 rate_lo=qlo),
                   seq=SeqGeom(order=so, rate=sr, rate_lo=slo,
                               match_bits=smb),
                   bytes_=ByteGeom(order=bo, rate=br),
                   flags=FlagGeom(hist_bits=fh, rate=fr))


def _block_body(blk: EncodedBlock) -> bytes:
    body = io.BytesIO()
    # v5 uses the formerly-reserved u16 as (flags, seq_order); v2-v4
    # blocks carry zeros there, so the layout is unchanged
    body.write(struct.pack("<IBBBB", blk.num_records, blk.minq,
                           blk.qual_depth, blk.flags, blk.seq_order))
    for name in blk.stream_order():
        es = blk.streams[name]
        hdr = bytearray()
        if name not in IMPLICIT_COUNTS:
            _write_u32_array(hdr, es.sym_counts)
        _write_u32_array(hdr, es.lane_lens)
        body.write(hdr)
        # per-lane unpadded payload concat
        lens = np.asarray(es.lane_lens, dtype=np.int64)
        maxlen = es.payload.shape[1]
        if lens.size and maxlen:
            from . import native
            if native.available():
                body.write(native.ragged_pack_rows(es.payload, lens))
            else:
                mask = np.arange(maxlen)[None, :] < lens[:, None]
                body.write(es.payload[mask].tobytes())
    return body.getvalue()


def write_block(f: BinaryIO, blk: EncodedBlock) -> int:
    """Append one encoded block (CRC32-protected, length-prefixed);
    returns its start offset."""
    off = f.tell()
    raw = _block_body(blk)
    f.write(struct.pack("<II", _crc32(raw), len(raw)))
    f.write(raw)
    return off


def _parse_body(buf: bytes, pos: int, fmt: int = VERSION):
    """Parse one block body starting at pos. Returns (EncodedBlock, end)."""
    if len(buf) - pos < 8:
        raise ValueError("container truncated (short block body)")
    num_records, minq, qual_depth, bflags, seq_order = struct.unpack_from(
        "<IBBBB", buf, pos)
    pos += 8
    streams = {}
    for name in streams_for(fmt):
        if name not in IMPLICIT_COUNTS:
            sym_counts, pos = _read_u32_array(buf, pos)
        else:
            sym_counts = None
        lane_lens, pos = _read_u32_array(buf, pos)
        if (lane_lens < 0).any():
            raise ValueError("negative lane length (corrupt container)")
        maxlen = int(lane_lens.max()) if len(lane_lens) else 0
        total = int(lane_lens.sum())
        if pos + total > len(buf):
            raise ValueError("container truncated (short lane payload)")
        if total:
            flat = np.frombuffer(buf, dtype=np.uint8, count=total,
                                 offset=pos)
            from . import native
            if native.available():
                payload = native.ragged_unpack_rows(flat, lane_lens,
                                                    maxlen)
            else:
                payload = np.zeros((len(lane_lens), maxlen),
                                   dtype=np.uint8)
                mask = np.arange(maxlen)[None, :] < lane_lens[:, None]
                payload[mask] = flat
            pos += total
        else:
            payload = np.zeros((len(lane_lens), maxlen), dtype=np.uint8)
        streams[name] = EncodedStream(sym_counts, lane_lens, payload)
    return EncodedBlock(num_records, minq, qual_depth, streams,
                        flags=bflags, seq_order=seq_order), pos


def _read_block_v1(buf: bytes, pos: int):
    """VERSION 1 block: u32 crc | body (no length prefix)."""
    if len(buf) - pos < 4:
        raise ValueError("container truncated (short block)")
    (crc,) = struct.unpack_from("<I", buf, pos)
    start = pos + 4
    blk, end = _parse_body(buf, start, fmt=1)
    if _crc32(buf[start:end]) != crc:
        raise ValueError("block CRC mismatch (corrupt container)")
    return blk, end


def read_block(f: BinaryIO, fmt: int = VERSION) -> EncodedBlock:
    """Read one block at the current position. VERSION 2 blocks are
    length-prefixed, so this reads exactly one block's bytes (bounded
    memory); VERSION 1 falls back to parsing the remaining buffer."""
    if fmt == 1:
        start = f.tell()
        buf = f.read()
        blk, used = _read_block_v1(buf, 0)
        f.seek(start + used)
        return blk
    crc, blen = struct.unpack("<II", _read_exact(f, 8))
    raw = _read_exact(f, blen)
    if _crc32(raw) != crc:
        raise ValueError("block CRC mismatch (corrupt container)")
    blk, used = _parse_body(raw, 0, fmt=fmt)
    if used != blen:
        raise ValueError("block length prefix mismatch (corrupt container)")
    return blk


def index_size(n_blocks: int, fmt: int = VERSION) -> int:
    """On-disk size of the trailing index for n blocks."""
    return 8 * n_blocks + (12 if fmt >= 2 else 8)


def write_index(f: BinaryIO, offsets: list[int]) -> None:
    body = b"".join(struct.pack("<Q", off) for off in offsets)
    body += struct.pack("<I", len(offsets))
    f.write(body)
    f.write(struct.pack("<I", zlib.crc32(body)))
    f.write(END_MAGIC)


def read_index(f: BinaryIO, fmt: int = VERSION) -> list[int]:
    f.seek(0, 2)
    fsize = f.tell()
    tail = 12 if fmt >= 2 else 8
    if fsize < tail:
        raise ValueError("container truncated (no index)")
    f.seek(-tail, 2)
    if fmt >= 2:
        n, crc, magic = struct.unpack("<II4s", _read_exact(f, 12))
    else:
        n, magic = struct.unpack("<I4s", _read_exact(f, 8))
        crc = None
    if magic != END_MAGIC:
        raise ValueError("container truncated (bad end magic); "
                         "use recover_blocks() for partial output")
    if index_size(n, fmt) > fsize:
        raise ValueError("implausible index block count (corrupt container)")
    f.seek(-index_size(n, fmt), 2)
    body = _read_exact(f, 8 * n + 4)
    if crc is not None and zlib.crc32(body) != crc:
        raise ValueError("index CRC mismatch (corrupt container)")
    offs = list(struct.unpack_from(f"<{n}Q", body, 0))
    f.seek(HEADER_SIZE.get(fmt, HEADER_SIZE[VERSION]))
    return offs


def iter_blocks(f: BinaryIO, cfg: CodecConfig | None = None
                ) -> Iterator[EncodedBlock]:
    """Yield blocks in order. VERSION 2: seek-based, one block resident at
    a time (bounded memory for 100GB-class containers). VERSION 1 keeps the
    legacy whole-buffer path."""
    if cfg is None:
        f.seek(0)
        cfg = read_header(f)
    offsets = read_index(f, cfg.fmt)
    if cfg.fmt == 1:
        f.seek(0, 2)
        end = f.tell()
        f.seek(0)
        buf = f.read(end)
        for off in offsets:
            blk, _ = _read_block_v1(buf, off)
            yield blk
        return
    for off in offsets:
        f.seek(off)
        yield read_block(f, cfg.fmt)


class Writer:
    """Streaming, resumable container writer.

    Blocks are appended as they are encoded; the index is written at
    close(). If a run is interrupted, the file has blocks but no index —
    ``Writer.resume(path)`` re-scans it (recover_blocks) and continues
    after the last complete block, which is the checkpoint/resume story
    for large multi-block runs (SURVEY.md §5): block granularity, no
    partial state to reconstruct.
    """

    def __init__(self, f: BinaryIO, cfg: CodecConfig,
                 offsets: list[int] | None = None):
        self.f = f
        self.cfg = cfg
        self.offsets = offsets or []
        self.closed = False

    @classmethod
    def create(cls, path: str, cfg: CodecConfig) -> "Writer":
        f = open(path, "wb")
        write_header(f, cfg)
        return cls(f, cfg)

    @classmethod
    def resume(cls, path: str) -> tuple["Writer", int]:
        """Reopen an interrupted container. Returns (writer,
        records_already_written). Bounded memory: scans block headers via
        the length prefixes without materialising payloads."""
        with open(path, "rb") as rf:
            cfg, offsets, end = recover_blocks(rf)
            if cfg.fmt < 2:
                raise ValueError("cannot resume a legacy v1 container")
            done_records = 0
            for off in offsets:
                rf.seek(off + 8)  # skip CRC + length prefix
                done_records += struct.unpack("<I", _read_exact(rf, 4))[0]
        f = open(path, "r+b")
        f.seek(end)
        f.truncate()
        return cls(f, cfg, offsets), done_records

    def append(self, blk: EncodedBlock) -> None:
        assert not self.closed
        self.offsets.append(write_block(self.f, blk))
        self.f.flush()

    def close(self) -> None:
        if not self.closed:
            write_index(self.f, self.offsets)
            self.f.close()
            self.closed = True


def recover_blocks(f: BinaryIO) -> tuple[CodecConfig, list[int], int]:
    """Scan a truncated container (no index) and return (cfg, offsets of
    every complete block, end offset of the last complete block) — the
    resume path for interrupted multi-host runs (SURVEY.md §5
    checkpoint/resume). VERSION 2 scans block-at-a-time via the length
    prefixes (bounded memory, CRC-verified); VERSION 1 keeps the legacy
    whole-buffer parse."""
    f.seek(0)
    cfg = read_header(f)
    start = f.tell()
    f.seek(0, 2)
    end = f.tell()
    offsets = []
    pos = start
    if cfg.fmt == 1:
        f.seek(0)
        buf = f.read(end)
        while pos < end:
            try:
                _blk, newpos = _read_block_v1(buf, pos)
                if newpos > end:
                    break
            except (struct.error, IndexError, ValueError):
                break
            offsets.append(pos)
            pos = newpos
        return cfg, offsets, pos
    f.seek(start)
    while pos + 8 <= end:
        crc, blen = struct.unpack("<II", _read_exact(f, 8))
        if blen < 8 or pos + 8 + blen > end:
            break
        raw = _read_exact(f, blen)
        if _crc32(raw) != crc:
            break
        offsets.append(pos)
        pos += 8 + blen
        f.seek(pos)
    return cfg, offsets, pos
