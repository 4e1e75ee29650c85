"""``sfq`` command-line interface.

Capability parity with slimfastq's CLI (SURVEY.md §2 "Entry / CLI": encode/
decode mode, compression level 1-4, stdin/stdout mode, force-overwrite,
version/usage, per-stream stats), running the codec through JAX on the
accelerator.

Usage:
  sfq [-1|-2|-3|-4] in.fastq [-o out.sfq]        # encode
  sfq -d in.sfq [-o out.fastq]                   # decode
  sfq -d in.sfq                                  # decode to stdout
  cat in.fastq | sfq - -o out.sfq                # stdin encode
"""

from __future__ import annotations

import argparse
import io
import os
import sys

from . import __version__, compile_cache
from .api import decode_fastq, encode_fastq


def _pick_backend(name: str):
    if name == "oracle":
        from .ops import streams_np
        return streams_np
    from .ops import streams_jax
    return streams_jax


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sfq",
        description="lossless FASTQ codec on a JAX accelerator "
                    "(slimfastq-class compression)")
    p.add_argument("input", help="input file, or '-' for stdin")
    p.add_argument("-o", "--output",
                   help="output file (default: input+'.sfq' on encode, "
                        "stdout on decode)")
    p.add_argument("-d", "--decode", action="store_true",
                   help="decompress instead of compress")
    for lv in (1, 2, 3, 4):
        p.add_argument(f"-{lv}", dest="level", action="store_const",
                       const=lv, help=f"compression level {lv}"
                       + (" (default)" if lv == 3 else ""))
    p.add_argument("-f", "--force", action="store_true",
                   help="overwrite existing output file")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="print per-stream statistics")
    p.add_argument("--backend", choices=["jax", "oracle"], default="jax",
                   help="compute backend (default: jax)")
    p.add_argument("--streaming", action="store_true",
                   help="bounded-memory streaming encode/decode for huge "
                        "files (encode is resumable: rerun with --resume "
                        "after a crash)")
    p.add_argument("--sharded", action="store_true",
                   help="encode/decode with record blocks sharded across "
                        "all local devices (output identical to "
                        "sequential)")
    p.add_argument("--resume", action="store_true",
                   help="with --streaming: continue an interrupted output")
    p.add_argument("--block-records", type=int, default=None,
                   metavar="N",
                   help="records per independently-decodable block "
                        "(encode only; default 65536). Smaller blocks "
                        "shard/recover at finer grain, larger blocks "
                        "compress better")
    p.add_argument("--version", action="version",
                   version=f"sfq {__version__}")
    p.set_defaults(level=3)
    return p


def _stats(encoded: bytes, raw_len: int, out=None) -> None:
    out = out if out is not None else sys.stderr
    from .utils.stats import container_report
    rep = container_report(encoded)
    print(f"records:         {rep['records']}  "
          f"(blocks: {rep['blocks']})", file=out)
    print(f"raw bytes:       {raw_len}", file=out)
    print(f"compressed:      {rep['compressed_bytes']}"
          f"  (ratio {raw_len / max(rep['compressed_bytes'], 1):.3f})",
          file=out)
    for name, b in sorted(rep["stream_bytes"].items(),
                          key=lambda kv: -kv[1]):
        print(f"  {name:<6} {b:>12}", file=out)
    print(f"  {'(hdrs)':<6} {rep['header_overhead_bytes']:>12}", file=out)


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    compile_cache.enable()
    if args.sharded and args.backend != "jax":
        # the sharded path IS the jax mesh path; silently running jax
        # kernels under --backend oracle would defeat backend bisection
        print("sfq: --sharded requires the jax backend "
              f"(got --backend {args.backend})", file=sys.stderr)
        return 2
    backend = _pick_backend(args.backend)

    if args.streaming and args.decode:
        if args.input == "-" or not args.output:
            print("sfq: --streaming needs a file input and -o output",
                  file=sys.stderr)
            return 2
        if not os.path.exists(args.input):
            print(f"sfq: {args.input}: no such file", file=sys.stderr)
            return 2
        if os.path.exists(args.output) and not args.force:
            print(f"sfq: {args.output} exists (use -f to overwrite)",
                  file=sys.stderr)
            return 2
        try:
            if args.sharded:
                from .parallel.sharded import decode_file_streaming_sharded
                decode_file_streaming_sharded(args.input, args.output)
            else:
                from .api import decode_file_streaming
                decode_file_streaming(args.input, args.output,
                                      backend=backend)
        except (ValueError, OSError) as e:
            print(f"sfq: {e}", file=sys.stderr)
            return 1
        return 0

    overrides = {}
    if args.block_records:
        overrides["block_records"] = args.block_records

    if args.streaming and not args.decode:
        if args.input == "-" or not args.output:
            print("sfq: --streaming needs a file input and -o output",
                  file=sys.stderr)
            return 2
        if (os.path.exists(args.output) and not args.force
                and not args.resume):
            print(f"sfq: {args.output} exists (use -f to overwrite)",
                  file=sys.stderr)
            return 2
        try:
            if args.sharded:
                from .parallel.sharded import encode_file_streaming_sharded
                encode_file_streaming_sharded(args.input, args.output,
                                              level=args.level,
                                              resume=args.resume,
                                              **overrides)
            else:
                from .api import encode_file_streaming
                encode_file_streaming(args.input, args.output,
                                      level=args.level, backend=backend,
                                      resume=args.resume, **overrides)
        except ValueError as e:
            print(f"sfq: {e}", file=sys.stderr)
            return 1
        return 0

    if args.input == "-":
        data = sys.stdin.buffer.read()
    else:
        if not os.path.exists(args.input):
            print(f"sfq: {args.input}: no such file", file=sys.stderr)
            return 2
        with open(args.input, "rb") as f:
            data = f.read()

    try:
        if args.decode and args.sharded:
            from .parallel.sharded import decode_fastq_sharded
            result = decode_fastq_sharded(data)
        elif args.decode:
            result = decode_fastq(data, backend=backend)
        elif args.sharded:
            from .config import config_for_level
            from .parallel.sharded import encode_fastq_sharded
            result = encode_fastq_sharded(
                data, config_for_level(args.level, **overrides))
        else:
            result = encode_fastq(data, level=args.level, backend=backend,
                                  **overrides)
    except ValueError as e:
        print(f"sfq: {e}", file=sys.stderr)
        return 1

    if args.output:
        dst = args.output
    elif args.decode:
        dst = "-"
    else:
        dst = (args.input + ".sfq") if args.input != "-" else "-"

    if dst == "-":
        sys.stdout.buffer.write(result)
    else:
        if os.path.exists(dst) and not args.force:
            print(f"sfq: {dst} exists (use -f to overwrite)",
                  file=sys.stderr)
            return 2
        with open(dst, "wb") as f:
            f.write(result)

    if args.verbose and not args.decode:
        _stats(result, len(data))
    return 0


if __name__ == "__main__":
    sys.exit(main())
