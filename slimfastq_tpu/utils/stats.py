"""Structured observability: per-stream size reports and throughput
counters (SURVEY.md §5 "Metrics / logging": the reference prints per-stream
compressed sizes with a verbose flag; here it's a structured dict usable by
the CLI, tests and dashboards)."""

from __future__ import annotations

import contextvars
import io
import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field


def container_report(encoded: bytes) -> dict:
    """Per-stream compressed byte totals + container overhead for one
    encoded container."""
    from .. import container
    f = io.BytesIO(encoded)
    cfg = container.read_header(f)
    totals: dict[str, int] = {}
    nrec = 0
    nblocks = 0
    for blk in container.iter_blocks(f, cfg):
        nrec += blk.num_records
        nblocks += 1
        for name, es in blk.streams.items():
            totals[name] = totals.get(name, 0) + int(es.lane_lens.sum())
    payload = sum(totals.values())
    return {
        "records": nrec,
        "blocks": nblocks,
        "compressed_bytes": len(encoded),
        "stream_bytes": totals,
        "header_overhead_bytes": len(encoded) - payload,
    }


@dataclass
class Counters:
    """Throughput/byte counters for an encode or decode run."""
    raw_bytes: int = 0
    coded_bytes: int = 0
    stage_seconds: dict = field(default_factory=dict)

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stage_seconds[name] = (self.stage_seconds.get(name, 0.0)
                                        + time.perf_counter() - t0)

    def report(self) -> dict:
        total = sum(self.stage_seconds.values())
        return {
            "raw_bytes": self.raw_bytes,
            "coded_bytes": self.coded_bytes,
            "ratio": (self.raw_bytes / self.coded_bytes
                      if self.coded_bytes else None),
            "seconds": round(total, 4),
            "mb_per_s": (round(self.raw_bytes / total / 1e6, 2)
                         if total else None),
            "stages": {k: round(v, 4)
                       for k, v in sorted(self.stage_seconds.items())},
        }


_SPAN_SECONDS: contextvars.ContextVar[dict | None] = contextvars.ContextVar(
    "sfq_span_seconds", default=None)


class Span:
    """Handle yielded by ``trace``. ``wait_for(result)`` names the device
    arrays the span stands for and returns them unchanged; only while
    ``record_spans`` is active does the span wait for them before it
    ends, so its seconds cover the device work, not just the dispatch."""

    __slots__ = ("result",)

    def __init__(self):
        self.result = None

    def wait_for(self, result):
        self.result = result
        return result


@contextmanager
def record_spans():
    """Collect {span name: [count, seconds]} for every ``trace`` span
    entered in this context (the device stage of the api pipelines runs
    on the calling thread)."""
    sink: dict = {}
    token = _SPAN_SECONDS.set(sink)
    try:
        yield sink
    finally:
        _SPAN_SECONDS.reset(token)


@contextmanager
def trace(name: str):
    """jax.profiler annotation (no-op when profiling is off) so device
    traces show codec stages (SURVEY.md §5 "Tracing/profiling"); yields a
    ``Span``. Under ``record_spans`` it also records the span's seconds.

    NOTE: only the *import/annotation setup* is allowed to fail silently;
    exceptions raised by the body must propagate (a previous version
    caught them and double-yielded, masking every kernel error as
    "generator didn't stop after throw()")."""
    sink = _SPAN_SECONDS.get()
    span = Span()
    try:
        from jax.profiler import TraceAnnotation
        ann = TraceAnnotation(name)
    except Exception:
        ann = nullcontext()
    t0 = time.perf_counter()
    with ann:
        yield span
        if sink is not None and span.result is not None:
            import jax
            jax.block_until_ready(span.result)
    if sink is not None:
        rec = sink.setdefault(name, [0, 0.0])
        rec[0] += 1
        rec[1] += time.perf_counter() - t0
