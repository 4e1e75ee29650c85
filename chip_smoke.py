#!/usr/bin/env python
"""Smoke test of sfq on NVIDIA GPUs at production geometry.

    python chip_smoke.py              # one GPU
    python chip_smoke.py --four-gpus  # the sharded paths over four GPUs

One GPU, in one process:

1. the device is a GPU and the native host library is loaded;
2. the `sfq` CLI encodes four 64k-record x 100 bp blocks at the default
   level and decodes them; the round trip equals the input and the
   container equals the NumPy oracle's (``api.encode_fastq`` with the
   ``streams_np`` backend, under the same host pipeline);
3. one 64k-record block at each of levels 1, 2 and 4 through
   ``api.encode_fastq`` / ``decode_fastq`` with the ``streams_jax``
   backend equals the oracle container; the level-4 block uses the
   read matcher (``MATCH_USED``); the golden v5 containers are
   re-encoded and decoded on the card;
4. smoke timings (not a benchmark): compile and steady seconds per phase,
   per-stream device seconds, peak device memory.

``--four-gpus`` runs only the sharded paths (in-memory, streaming, the
ragged all-gather) over a four-device mesh, compares them with the
single-card container, and checks that every card held its blocks.

Every comparison is exact byte equality: the codec is integer-only. The
last line of standard output is ``{"ok": true, "device": {...}}``, printed
only when every phase passed; without a GPU the script exits non-zero.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import tempfile
import time

BLOCK = 65536       # records per block, the default block_records
SEED = 7
GOLDEN_GEOM = dict(lanes=32, aux_lanes=8, block_records=160)
DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "data")


def log(msg: str) -> None:
    print(msg, flush=True)


def expect(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


class CompileCounter:
    """Counts programs compiled and the seconds spent lowering and
    compiling them, from JAX's monitoring events. (Tracing is left out:
    its events nest for jitted functions called inside others.)"""

    _EVENTS = ("/jax/core/compile/jaxpr_to_mlir_module_duration",
               "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        self.programs = 0
        self.seconds = 0.0

    def __call__(self, event: str, duration: float, **_kw) -> None:
        if event in self._EVENTS:
            self.seconds += duration
            self.programs += event.endswith("backend_compile_duration")

    def install(self) -> "CompileCounter":
        from jax import monitoring
        monitoring.register_event_duration_secs_listener(self)
        return self


def run_phase(name: str, counter: CompileCounter, fn, *args, **kw):
    """Run one phase; print its wall, compile and steady seconds."""
    p0, s0 = counter.programs, counter.seconds
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    wall = time.perf_counter() - t0
    comp = counter.seconds - s0
    log(f"phase {name}: ok; wall {wall:.3f} s, compile {comp:.3f} s "
        f"({counter.programs - p0} programs), wall - compile "
        f"{wall - comp:.3f} s")
    return out


# ---------------------------------------------------------------------------
# phases (each takes its sizes, so the CPU tests run them small)
# ---------------------------------------------------------------------------

def check_device() -> dict:
    """The first device is a GPU and the native host path is loaded."""
    import jax
    from slimfastq_tpu import native
    from slimfastq_tpu.utils import device
    device.require_gpu()
    expect(native.available(), "native host library loaded")
    log(f"card: {device.card()}")
    desc = device.describe()
    log(f"jax {jax.__version__}; device_kind {desc['kind']}; "
        f"devices {desc['count']}")
    return desc


def check_cli(data: bytes, block_records: int, workdir: str) -> dict:
    """`sfq` encode at the default level, then `sfq -d`: the round trip
    equals the input and the container equals the oracle's."""
    from slimfastq_tpu import api, cli
    from slimfastq_tpu.ops import streams_np
    src = os.path.join(workdir, "in.fastq")
    enc = os.path.join(workdir, "in.sfq")
    back = os.path.join(workdir, "back.fastq")
    with open(src, "wb") as f:
        f.write(data)
    t0 = time.perf_counter()
    expect(cli.main([src, "-o", enc, "-f", "--block-records",
                     str(block_records)]) == 0, "sfq encode exit 0")
    t1 = time.perf_counter()
    expect(cli.main(["-d", enc, "-o", back, "-f"]) == 0, "sfq -d exit 0")
    t2 = time.perf_counter()
    with open(enc, "rb") as f:
        container = f.read()
    with open(back, "rb") as f:
        expect(f.read() == data, "CLI round trip equals the input")
    oracle = api.encode_fastq(data, level=3, backend=streams_np,
                              block_records=block_records)
    expect(container == oracle, "CLI container equals the oracle's")
    log(f"  cli: {len(data)} -> {len(container)} bytes, equal to the "
        f"oracle; encode {t1 - t0:.3f} s, decode {t2 - t1:.3f} s (cold)")
    return {"container": container, "encode_s": t1 - t0,
            "decode_s": t2 - t1}


def steady_round_trip(data: bytes, block_records: int, container: bytes,
                      level: int = 3) -> dict:
    """Encode and decode again with every shape compiled."""
    from slimfastq_tpu import api
    from slimfastq_tpu.ops import streams_jax
    t0 = time.perf_counter()
    enc = api.encode_fastq(data, level=level, backend=streams_jax,
                           block_records=block_records)
    t1 = time.perf_counter()
    out = api.decode_fastq(enc, backend=streams_jax)
    t2 = time.perf_counter()
    expect(enc == container, "steady encode equals the first")
    expect(out == data, "steady round trip equals the input")
    log(f"  steady: encode {t1 - t0:.3f} s, decode {t2 - t1:.3f} s")
    return {"encode_s": t1 - t0, "decode_s": t2 - t1}


def match_used(container: bytes) -> list[bool]:
    from slimfastq_tpu import container as C
    from slimfastq_tpu.pipeline import MATCH_USED
    f = io.BytesIO(container)
    cfg = C.read_header(f)
    return [bool(b.flags & MATCH_USED) for b in C.iter_blocks(f, cfg)]


def check_level(data: bytes, level: int, need_match: bool = False,
                **geom) -> dict:
    """One level through the API with the device backend: the container
    equals the oracle's and decodes to the input on the device."""
    from slimfastq_tpu import api
    from slimfastq_tpu.ops import streams_jax, streams_np
    enc = api.encode_fastq(data, level=level, backend=streams_jax, **geom)
    oracle = api.encode_fastq(data, level=level, backend=streams_np, **geom)
    expect(enc == oracle, f"level {level} container equals the oracle's")
    expect(api.decode_fastq(enc, backend=streams_jax) == data,
           f"level {level} round trip on the device")
    used = match_used(enc)
    if need_match:
        expect(any(used), f"level {level} block uses the matcher")
    log(f"  level {level}: {len(data)} -> {len(enc)} bytes, equal to the "
        f"oracle; MATCH_USED {used}")
    return {"container": enc, "match_used": used}


def check_golden(levels=(1, 2, 3, 4)) -> None:
    """The golden v5 containers re-encode identically and decode on the
    device."""
    from slimfastq_tpu import api
    from slimfastq_tpu.ops import streams_jax
    with open(os.path.join(DATA_DIR, "golden_v2.fastq"), "rb") as f:
        data = f.read()
    for lv in levels:
        with open(os.path.join(DATA_DIR, f"golden_v5_l{lv}.sfq"),
                  "rb") as f:
            golden = f.read()
        enc = api.encode_fastq(data, level=lv, backend=streams_jax,
                               **GOLDEN_GEOM)
        expect(enc == golden, f"golden_v5_l{lv}.sfq re-encoded")
        expect(api.decode_fastq(golden, backend=streams_jax) == data,
               f"golden_v5_l{lv}.sfq decodes")
    log(f"  golden v5 containers L{min(levels)}-L{max(levels)} reproduced "
        "and decoded")


def coder_spans(data: bytes, block_records: int) -> dict:
    """Per-span seconds of one steady level-3 encode+decode, from the
    codec's trace spans (``utils.stats.record_spans``: each span waits
    for its device result), and the coder's cost per bit-step."""
    from slimfastq_tpu import api, native
    from slimfastq_tpu import container as C
    from slimfastq_tpu.ops import ranger_np as R
    from slimfastq_tpu.ops import streams_jax
    from slimfastq_tpu.pipeline import _lane_lengths_matrix
    from slimfastq_tpu.utils import stats
    kw = dict(level=3, backend=streams_jax, block_records=block_records)
    api.decode_fastq(api.encode_fastq(data, **kw), backend=streams_jax)
    with stats.record_spans() as spans:
        enc = api.encode_fastq(data, **kw)
        out = api.decode_fastq(enc, backend=streams_jax)
    expect(out == data, "traced round trip equals the input")
    f = io.BytesIO(enc)
    cfg = C.read_header(f)
    blocks = list(C.iter_blocks(f, cfg))
    idx, n = native.fastq_index(data)
    lengths = idx["seq_len"]
    steps = sum(R.pad_steps(int(_lane_lengths_matrix(
        lengths[lo:lo + block_records], cfg.lanes).sum(axis=0).max()))
        for lo in range(0, n, block_records))
    for name, (k, secs) in sorted(spans.items()):
        log(f"  span {name}: {k} calls, {secs:.4f} s")
    for kind, depth in (("seq", cfg.seq.depth),
                        ("qual", blocks[0].qual_depth)):
        for way in ("encode", "decode"):
            n, secs = spans.get(f"sfq.{way}.{kind}.coder", (0, 0.0))
            if n:
                log(f"  {way} {kind} coder: {secs:.4f} s over "
                    f"{steps} x {depth} bit-steps = "
                    f"{secs / (steps * depth) * 1e6:.3f} us per bit-step")
    return spans


class _ShardRecorder:
    """Wraps the mesh builders' jitted functions to record where each
    output array's shards live, so the check can see that every device
    held its own blocks."""

    def __init__(self):
        self.placements: dict[str, list] = {}

    def wrap(self, name: str, builder):
        rec = self

        def build(*args, **kw):
            fn = builder(*args, **kw)

            def run(*a):
                out = fn(*a)
                arr = out[0]
                rec.placements.setdefault(name, []).append(
                    (arr.shape[0], sorted(
                        (s.device.id, s.data.shape[0])
                        for s in arr.addressable_shards)))
                return out
            return run
        return build


def check_sharded(data: bytes, block_records: int, n_devices: int,
                  workdir: str) -> dict:
    """The sharded in-memory and streaming paths over an n-device mesh
    equal the single-device container and round-trip; the ragged
    all-gather reassembles the container; every device held blocks."""
    import jax
    from slimfastq_tpu import api
    from slimfastq_tpu.config import config_for_level
    from slimfastq_tpu.ops import streams_jax
    from slimfastq_tpu.parallel import gather, mesh as pmesh, sharded
    expect(len(jax.devices()) >= n_devices, f"{n_devices} devices present")
    mesh = pmesh.make_mesh(n_devices)
    cfg = config_for_level(3, block_records=block_records)
    single = api.encode_fastq(data, cfg=cfg, backend=streams_jax)

    rec = _ShardRecorder()
    orig = (pmesh._build_sharded_raw_encode, pmesh._build_sharded_raw_decode)
    pmesh._build_sharded_raw_encode = rec.wrap("encode", orig[0])
    pmesh._build_sharded_raw_decode = rec.wrap("decode", orig[1])
    try:
        shd = sharded.encode_fastq_sharded(data, cfg, mesh)
        expect(shd == single, "sharded container equals single-device")
        expect(sharded.decode_fastq_sharded(shd, mesh) == data,
               "sharded decode round trip")
        src = os.path.join(workdir, "in.fastq")
        dst = os.path.join(workdir, "stream.sfq")
        back = os.path.join(workdir, "stream.fastq")
        with open(src, "wb") as f:
            f.write(data)
        sharded.encode_file_streaming_sharded(
            src, dst, level=3, mesh=mesh, block_records=block_records)
        with open(dst, "rb") as f:
            expect(f.read() == single,
                   "streaming sharded container equals single-device")
        sharded.decode_file_streaming_sharded(dst, back, mesh=mesh)
        with open(back, "rb") as f:
            expect(f.read() == data, "streaming sharded decode round trip")
    finally:
        pmesh._build_sharded_raw_encode, pmesh._build_sharded_raw_decode = \
            orig

    # ragged all-gather: one uneven slice of the container per device
    cuts = [0] + [len(shd) * (2 * k + 1) // (2 * n_devices + 1)
                  for k in range(1, n_devices)] + [len(shd)]
    parts = [shd[cuts[k]:cuts[k + 1]] for k in range(n_devices)]
    expect(gather.ragged_all_gather(mesh, parts) == shd,
           "ragged all-gather reassembles the container")

    # placement: each window's arrays are split over all n devices,
    # one equal slice of the block axis each
    mesh_ids = sorted(d.id for d in mesh.devices.flat)
    for name, calls in rec.placements.items():
        for blocks, shards in calls:
            expect(sorted(i for i, _ in shards) == mesh_ids
                   and all(b == blocks // n_devices for _, b in shards),
                   f"sharded {name}: {blocks} blocks spread over "
                   f"{n_devices} devices (got {shards})")
    expect(set(rec.placements) == {"encode", "decode"},
           "both sharded kernels ran")
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use")
             for d in mesh.devices.flat]
    if all(p is not None for p in peaks):
        expect(min(peaks) >= max(peaks) // 4,
               f"every device did comparable work (peak bytes {peaks})")
    log(f"  sharded over {n_devices} devices: {len(data)} -> {len(shd)} "
        f"bytes, equal to single-device; windows "
        f"{ {k: [c[0] for c in v] for k, v in rec.placements.items()} }; "
        f"peak bytes per device {peaks}")
    return {"container": shd, "placements": rec.placements, "peaks": peaks}


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------

def smoke_data(blocks: int, seed: int = SEED) -> bytes:
    from slimfastq_tpu.utils.synth import corpus
    return corpus("illumina", blocks * BLOCK, seed=seed)


def peak_bytes() -> int | None:
    import jax
    return (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")


def main_one(counter: CompileCounter) -> None:
    data = smoke_data(4)
    with tempfile.TemporaryDirectory() as work:
        r = run_phase("cli L3, 4 x 64k records", counter, check_cli, data,
                      BLOCK, work)
    run_phase("steady L3, 4 x 64k records", counter, steady_round_trip,
              data, BLOCK, r["container"])
    block = smoke_data(1, seed=SEED + 1)
    for lv in (1, 2, 4):
        run_phase(f"level {lv}, 64k records", counter, check_level, block,
                  lv, need_match=lv == 4, block_records=BLOCK)
    run_phase("golden v5", counter, check_golden)
    run_phase("coder spans, L3 64k records", counter, coder_spans, block,
              BLOCK)
    log(f"peak_bytes_in_use {peak_bytes()}")


def main_four(counter: CompileCounter) -> None:
    # two blocks per device plus a ragged tail block
    import jax
    n = 4
    from slimfastq_tpu.utils.synth import corpus
    data = corpus("illumina", 2 * n * BLOCK + BLOCK // 3, seed=SEED)
    with tempfile.TemporaryDirectory() as work:
        run_phase(f"sharded over {n} devices", counter, check_sharded, data,
                  BLOCK, n, work)
    log(f"devices used {len(jax.devices())}")


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four-gpus", action="store_true",
                   help="run only the sharded paths over four GPUs")
    args = p.parse_args(argv)
    from slimfastq_tpu import compile_cache
    cache = compile_cache.enable()
    desc = check_device()
    log(f"compile cache {cache}")
    counter = CompileCounter().install()
    if args.four_gpus:
        expect(desc["count"] >= 4, "four GPUs present")
        main_four(counter)
    else:
        main_one(counter)
    log(f"compiled {counter.programs} programs in {counter.seconds:.3f} s")
    print(json.dumps({"ok": True, "device": desc}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
