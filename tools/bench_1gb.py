#!/usr/bin/env python
"""Sustained >= 1 GB streaming benchmark (round-4 VERDICT next #4):
drive `sfq --streaming` encode + decode over a ~1 GB synthetic corpus,
recording wall time, PEAK RSS (the bounded-memory claim, asserted),
ratio at scale, and an xz -6 comparison at the same scale.

What this run validates: bounded RSS over ~64 windows, resumable-writer
behaviour at GB scale, ratio when the corpus dwarfs every model table,
and the xz comparison at a size where xz's window is not the limiting
factor. The wall times are whatever device JAX finds; `kernel_backend`
and `device` in the output name it.

One process per card: this parent never imports JAX. It runs the `sfq`
encode and decode children one after the other, so at most one process
uses the device at a time.

Usage: python tools/bench_1gb.py [gigabytes] [--level N] [--keep]
Prints one JSON line; asserts peak RSS < SFQ_1GB_RSS_BOUND (default
6 GiB — input file is streamed in 256 MiB chunks; the encoder holds
O(pipe depth) prepared blocks).
"""
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _peak_rss_watch(pid, out, stop):
    peak = 0
    while not stop.is_set():
        try:
            with open(f"/proc/{pid}/status") as f:
                for line in f:
                    if line.startswith("VmRSS:"):
                        peak = max(peak, int(line.split()[1]) * 1024)
                        break
        except OSError:
            break
        time.sleep(0.2)
    out["peak"] = max(out.get("peak", 0), peak)


def _run_watched(cmd, env):
    p = subprocess.Popen(cmd, env=env)
    out = {}
    stop = threading.Event()
    w = threading.Thread(target=_peak_rss_watch, args=(p.pid, out, stop))
    w.start()
    t0 = time.perf_counter()
    rc = p.wait()
    dt = time.perf_counter() - t0
    stop.set()
    w.join()
    assert rc == 0, f"{cmd} failed rc={rc}"
    return dt, out.get("peak", 0)


def main():
    gb = float(sys.argv[1]) if len(sys.argv) > 1 and \
        not sys.argv[1].startswith("-") else 1.0
    level = 3
    if "--level" in sys.argv:
        level = int(sys.argv[sys.argv.index("--level") + 1])
    keep = "--keep" in sys.argv
    rss_bound = int(os.environ.get("SFQ_1GB_RSS_BOUND",
                                   str(6 << 30)))
    work = tempfile.mkdtemp(prefix="sfq_1gb_")
    src = os.path.join(work, "in.fastq")
    dst = os.path.join(work, "out.sfq")
    back = os.path.join(work, "roundtrip.fastq")

    # synth the corpus to disk in bounded pieces (distinct seeds so
    # blocks differ; ~248 B/record at 100 bp)
    from slimfastq_tpu.utils.synth import synth_fastq
    target = int(gb * (1 << 30))
    written = 0
    piece = 0
    t0 = time.perf_counter()
    with open(src, "wb") as f:
        while written < target:
            data = synth_fastq(262144, read_len=100, seed=piece,
                               var_len=False, n_rate=0.0005)
            f.write(data)
            written += len(data)
            piece += 1
    print(f"synth: {written/1e9:.2f} GB in {time.perf_counter()-t0:.0f}s",
          file=sys.stderr)

    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    cli = [sys.executable, "-m", "slimfastq_tpu.cli"]
    enc_s, enc_rss = _run_watched(
        cli + [src, "-o", dst, f"-{level}", "-f", "--streaming"], env)
    dec_s, dec_rss = _run_watched(
        cli + ["-d", dst, "-o", back, "-f", "--streaming"], env)

    # bit-exact round trip at scale (streamed compare)
    t0 = time.perf_counter()
    rc = subprocess.run(["cmp", src, back]).returncode
    assert rc == 0, "1GB round-trip MISMATCH"
    cmp_s = time.perf_counter() - t0

    comp = os.path.getsize(dst)
    out = {
        "metric": "streaming_1gb",
        "raw_bytes": written,
        "compressed_bytes": comp,
        "ratio": round(written / comp, 4),
        "level": level,
        "encode_wall_s": round(enc_s, 1),
        "decode_wall_s": round(dec_s, 1),
        "cmp_s": round(cmp_s, 1),
        "encode_peak_rss_bytes": enc_rss,
        "decode_peak_rss_bytes": dec_rss,
        "rss_bound_bytes": rss_bound,
        "kernel_backend": os.environ.get("JAX_PLATFORMS", "default"),
    }
    # xz comparison at the same scale (multithreaded to keep it sane)
    if shutil.which("xz") and "--no-xz" not in sys.argv:
        xzp = src + ".xz"
        t0 = time.perf_counter()
        subprocess.run(["xz", "-6", "-T4", "-k", "-f", src], check=True)
        out["xz6_wall_s"] = round(time.perf_counter() - t0, 1)
        out["xz6_bytes"] = os.path.getsize(xzp)
        out["xz6_ratio"] = round(written / out["xz6_bytes"], 4)
        os.remove(xzp)

    assert enc_rss < rss_bound and dec_rss < rss_bound, \
        f"peak RSS exceeded bound: enc={enc_rss} dec={dec_rss}"
    if not keep:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
