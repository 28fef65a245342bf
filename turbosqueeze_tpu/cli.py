"""tsq command-line interface.

Verb parity with the upstream sample CLI (sample/main.cpp:117-169):
    tsq c <input> <output> [--no-ext]     compress
    tsq d <input> <output>                decompress
    tsq b [path]                          benchmark
plus framework verbs:
    tsq info <file.tsq>                   container inspection
    tsq verify <input> <file.tsq>         roundtrip check
Options: --backend {auto,native,oracle,device}, --threads N, --level N
(0 = upstream-identical greedy parse; 1 = exact candidate parse; >= 2 =
lazy best-of-chain parse — smaller output, same format; the upstream
plumbs this flag but never reads it), --ext/--no-ext.
"""

from __future__ import annotations

import argparse
import sys
import time


def _human(n: float) -> str:
    return f"{n / 1e6:,.1f} MB"


def _read_dict(args):
    if getattr(args, "dict", None):
        return open(args.dict, "rb").read()
    return None


def _native_streaming(backend: str) -> bool:
    try:
        from .runtime import native

        return native.streaming_ok(backend)
    except Exception:
        return False


def cmd_compress(args) -> int:
    import os

    t0 = time.perf_counter()
    dictionary = _read_dict(args)
    in_size = os.path.getsize(args.input)
    if dictionary is None and _native_streaming(args.backend):
        # stream block windows through the native file pipeline: bounded
        # memory on arbitrarily large inputs (tsq_threads.cpp:90-99 parity)
        from .runtime import native

        out_size = native.compress_file(args.input, args.output,
                                        not args.no_ext, args.level,
                                        args.threads)
    else:
        from .runtime.api import compress

        data = open(args.input, "rb").read()
        stream = compress(data, ext=not args.no_ext, backend=args.backend,
                          level=args.level, dictionary=dictionary)
        with open(args.output, "wb") as f:
            f.write(stream)
        out_size = len(stream)
    dt = time.perf_counter() - t0
    print(f"{_human(in_size)} -> {_human(out_size)} "
          f"({100.0 * out_size / max(in_size, 1):.2f}%) "
          f"in {dt:.2f}s ({in_size / 1e6 / dt:,.0f} MB/s)")
    return 0


def cmd_decompress(args) -> int:
    import os

    t0 = time.perf_counter()
    dictionary = _read_dict(args)
    in_size = os.path.getsize(args.input)
    if dictionary is None and _native_streaming(args.backend):
        from .runtime import native

        out_size = native.decompress_file(args.input, args.output,
                                          args.threads)
    elif args.backend == "device":
        # sharded decode with per-host ordered writes (each process
        # writes its own shards at their fixed 4 MiB offsets)
        from .parallel import pipeline

        stream = open(args.input, "rb").read()
        out_size = pipeline.decompress_to_file(stream, args.output,
                                               dictionary=dictionary)
    else:
        from .runtime.api import decompress

        stream = open(args.input, "rb").read()
        data = decompress(stream, backend=args.backend,
                          dictionary=dictionary)
        with open(args.output, "wb") as f:
            f.write(data)
        out_size = len(data)
    dt = time.perf_counter() - t0
    print(f"{_human(in_size)} -> {_human(out_size)} "
          f"in {dt:.2f}s ({out_size / 1e6 / dt:,.0f} MB/s)")
    return 0


def cmd_bench(args) -> int:
    """MT benchmark over a file or the synthetic enwik stand-in
    (upstream `tsq b` benchmarks enwik9, sample/main.cpp:43-114 — but with
    CPU-time clocks; we report wall time)."""
    from .runtime.api import compress, decompress

    if args.input:
        data = open(args.input, "rb").read()
        name = args.input
    else:
        from .utils.corpus import synthetic_text

        size = args.size << 20
        data = synthetic_text(size, seed=1234)
        name = f"synthetic-text[{size >> 20} MiB]"

    for ext in (False, True):
        t0 = time.perf_counter()
        stream = compress(data, ext=ext, backend=args.backend)
        t1 = time.perf_counter()
        out = decompress(stream, backend=args.backend)
        t2 = time.perf_counter()
        ok = out == data
        print(f"{name} ext={int(ext)}: "
              f"compress {len(data) / 1e6 / (t1 - t0):,.0f} MB/s, "
              f"decompress {len(data) / 1e6 / (t2 - t1):,.0f} MB/s, "
              f"ratio {100.0 * len(stream) / max(len(data), 1):.2f}%, "
              f"roundtrip {'OK' if ok else 'FAIL'}")
        if not ok:
            return 1
    return 0


def cmd_info(args) -> int:
    from .format import CONTAINER_HEADER_SZ, ContainerHeader, scan_block_table

    stream = open(args.input, "rb").read()
    hdr, table = scan_block_table(stream)
    payload = sum(sz for _, sz, _ in table)
    print(f"TSQ1 container: {hdr.n_blocks} blocks, "
          f"{hdr.total_size:,} bytes uncompressed, "
          f"{len(stream):,} bytes compressed "
          f"({100.0 * len(stream) / max(hdr.total_size, 1):.2f}%)")
    ext_blocks = sum(1 for _, _, ext in table if ext)
    print(f"extensions: {ext_blocks}/{hdr.n_blocks} blocks; "
          f"payload {payload:,} B; overhead "
          f"{len(stream) - payload - CONTAINER_HEADER_SZ:,} B headers")
    if args.blocks:
        for b, (off, sz, ext) in enumerate(table):
            print(f"  block {b}: offset {off:,}, {sz:,} B, ext={int(ext)}")
    ContainerHeader  # referenced for doc purposes
    return 0


def cmd_verify(args) -> int:
    from .runtime.api import decompress

    data = open(args.input, "rb").read()
    out = decompress(open(args.tsq, "rb").read(), backend=args.backend)
    if out == data:
        print("OK: bit-exact roundtrip")
        return 0
    print("MISMATCH")
    return 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="tsq",
        description="Turbosqueeze .tsq compression on host or device")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "native", "oracle", "device"])
    p.add_argument("--threads", type=int, default=0)
    sub = p.add_subparsers(dest="verb", required=True)

    pc = sub.add_parser("c", help="compress")
    pc.add_argument("input")
    pc.add_argument("output")
    pc.add_argument("--no-ext", action="store_true")
    pc.add_argument("--level", type=int, default=0,
                    help="0 = upstream-parity parse; 1 = exact candidate "
                         "parse; 2 = lazy best-of-chain (best ratio); "
                         "3/4 = lazy with capped chain walks (faster, "
                         "slightly larger)")
    pc.add_argument("--dict", help="preset dictionary file (<=64 KiB; "
                                   "framework extension)")
    pc.set_defaults(fn=cmd_compress)

    pd = sub.add_parser("d", help="decompress")
    pd.add_argument("input")
    pd.add_argument("output")
    pd.add_argument("--dict", help="preset dictionary used at compression")
    pd.set_defaults(fn=cmd_decompress)

    pb = sub.add_parser("b", help="benchmark")
    pb.add_argument("input", nargs="?", default=None)
    pb.add_argument("--size", type=int, default=64, help="synthetic MiB")
    pb.set_defaults(fn=cmd_bench)

    pi = sub.add_parser("info", help="inspect a .tsq container")
    pi.add_argument("input")
    pi.add_argument("--blocks", action="store_true")
    pi.set_defaults(fn=cmd_info)

    pv = sub.add_parser("verify", help="verify a .tsq against its source")
    pv.add_argument("input")
    pv.add_argument("tsq")
    pv.set_defaults(fn=cmd_verify)

    args = p.parse_args(argv)
    if args.backend == "device":
        from .utils.compile_cache import enable_compile_cache

        enable_compile_cache()
    try:
        return args.fn(args)
    except (OSError, ValueError) as e:  # FormatError is a ValueError
        print(f"tsq: error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
