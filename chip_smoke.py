#!/usr/bin/env python3
"""Smoke test of the device path on NVIDIA GPUs, at full block size.

    python3 chip_smoke.py [--mib 256] [--cards 4]

With no option it runs every public device entry point on one card over a
synthetic corpus of --mib MiB (64 full 4 MiB blocks by default) and the
four bundled real files, and compares every output byte for byte with the
native core or with the input:

  * tsq.compress(backend="device") at levels 0, 1 and 2 (level 2 on at
    most 64 MiB: its lazy parse runs on the host), with and without ext,
    against native.compress;
  * tsq.decompress(backend="device") and pipeline.decompress_to_file on
    each of those containers;
  * a preset dictionary through the device backend;
  * pipeline.decompress_to_words, whose result must stay on the device;
  * the CLI's c/d verbs with --backend device;
  * decode_batch_xla and find_candidates on one block and one window of 4
    against the native core.

It prints the card, each phase with its bytes, wall time and result, the
compiled memory of the two device programs, first and warm compile times
and the peak device memory (bench.py times the programs). --cards 4 runs
only the four-card path: compress and decode over a 4-device mesh,
compared with the native core, and the blocks each card held.

Any mismatch or error ends the run with a nonzero exit code and no result
line. Without a GPU it exits nonzero before any work. The last line of a
passing run is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
SEED = 1234  # the synthetic corpus


def say(*parts) -> None:
    print(*parts, flush=True)


def compile_report(mesh, stream: bytes) -> None:
    """Memory analysis and compile seconds of the sharded decode and
    candidate programs at the real window shape (4 blocks/device): the
    first compile in this process (cold unless the persistent cache
    already holds the program), then again after clearing the in-memory
    caches (warm: a persistent cache hit)."""
    import jax
    import numpy as np

    from turbosqueeze_tpu.format import BLOCK_SZ, scan_block_table
    from turbosqueeze_tpu.kernels import decode_xla as DXL
    from turbosqueeze_tpu.parallel import mesh as mesh_mod
    from turbosqueeze_tpu.parallel import pipeline
    from turbosqueeze_tpu.runtime import native

    B = 4 * mesh.devices.size
    sharding = mesh_mod.block_sharding(mesh)
    _, table = scan_block_table(stream)
    t_max = max(len(native.tokenize_block(stream[o:o + n], e)[0])
                for o, n, e in table[:B])
    T = -(-(t_max + 1) // 8192) * 8192

    def spec(shape, dtype):
        return jax.ShapeDtypeStruct(shape, dtype, sharding=sharding)

    programs = {
        f"decode_xla (B={B}, T={T})": (
            pipeline._sharded_decode_xla(mesh, DXL.OUT_N),
            [spec((B, T), np.int32)] * 4 + [spec((B, DXL.PAY_N), np.uint8)]),
        f"find_candidates (B={B})": (
            pipeline._sharded_candidates(mesh),
            [spec((B, BLOCK_SZ), np.uint8)]),
    }
    for name, (prog, args) in programs.items():
        t0 = time.perf_counter()
        compiled = prog.lower(*args).compile()
        first = time.perf_counter() - t0
        jax.clear_caches()
        t0 = time.perf_counter()
        prog.lower(*args).compile()
        warm = time.perf_counter() - t0
        m = compiled.memory_analysis()
        say(f"memory {name}: argument {m.argument_size_in_bytes} B, "
            f"output {m.output_size_in_bytes} B, "
            f"temp {m.temp_size_in_bytes} B, "
            f"generated code {m.generated_code_size_in_bytes} B")
        say(f"compile {name}: first {first:.3f} s, warm {warm:.3f} s")


def check_programs(data: bytes) -> None:
    """decode_batch_xla and find_candidates as compiled for the card, on
    one block and on one window of 4, against the native core."""
    from tests import device_checks as C
    from turbosqueeze_tpu.format import BLOCK_SZ, iter_container
    from turbosqueeze_tpu.runtime import native

    blocks = [data[k * BLOCK_SZ:(k + 1) * BLOCK_SZ] for k in range(4)]
    payloads = [(p, e) for _, p, e in
                iter_container(native.compress(b"".join(blocks), True))]
    for B in (1, 4):
        C.check_decode_batch(payloads[:B], blocks[:B])
        say(f"decode_batch_xla B={B}: exact")
        C.check_find_candidates(blocks[:B])
        say(f"find_candidates B={B}: exact")


def one_card(mib: int) -> None:
    """Every public device entry point on one card, byte-checked."""
    import jax

    from tests import device_checks as C
    from turbosqueeze_tpu.parallel import mesh as mesh_mod
    from turbosqueeze_tpu.runtime import native
    from turbosqueeze_tpu.utils.corpus import real_files, synthetic_text

    work = HERE / ".benchdata" / "smoke"
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    data = synthetic_text(mib << 20, seed=SEED)
    say(f"corpus: synthetic_text {len(data)} B (seed {SEED}) "
        f"in {time.perf_counter() - t0:.1f} s")
    compile_report(mesh_mod.block_mesh(),
                   native.compress(data, True, level=0))

    # containers to decode: name -> (container, original bytes)
    streams = {}
    for level in (0, 1, 2):
        part = data if level < 2 else data[:64 << 20]
        for ext in (True, False):
            stream, rec = C.check_compress(part, level, ext)
            say(json.dumps(rec))
            streams[f"synthetic l{level} ext={int(ext)}"] = (stream, part)
    files = real_files()
    for name, blob in files.items():
        for level in (0, 1, 2):
            stream, rec = C.check_compress(blob, level, True)
            say(json.dumps({**rec, "phase": f"{rec['phase']} {name}"}))
            streams[f"{name} l{level}"] = (stream, blob)

    for name, (stream, part) in streams.items():
        say(json.dumps(C.check_decompress(stream, part, name)))
        say(json.dumps(C.check_decompress_to_file(
            stream, part, work / "out.bin", name)))

    dictionary = synthetic_text(32_000, seed=500)
    say(json.dumps(C.check_dictionary(data, dictionary, True)))
    say(json.dumps(C.check_words(streams["synthetic l0 ext=1"][0], data)))
    say(json.dumps(C.check_cli(files["real-source"], work, "real-source")))

    check_programs(data)
    # end to end again, with every program compiled
    for level in (1, 0):
        stream, rec = C.check_compress(data, level, True)
        say(json.dumps({**rec, "phase": "warm " + rec["phase"]}))
        rec = C.check_decompress(stream, data, f"synthetic l{level} ext=1")
        say(json.dumps({**rec, "phase": "warm " + rec["phase"]}))
    for d in jax.local_devices():
        stats = d.memory_stats() or {}
        say(f"peak memory {d}: {stats.get('peak_bytes_in_use')} B "
            f"of {stats.get('bytes_limit')} B")


def four_cards(mib: int) -> None:
    """Compress and decode over a 4-device mesh, against the native core,
    and the blocks each card held."""
    import jax

    from tests import device_checks as C
    from turbosqueeze_tpu.runtime import native
    from turbosqueeze_tpu.utils.corpus import synthetic_text

    devices = jax.devices()
    if len(devices) != 4:
        raise SystemExit(f"--cards 4 needs 4 GPUs, JAX sees {len(devices)}")
    work = HERE / ".benchdata" / "smoke"
    work.mkdir(parents=True, exist_ok=True)
    data = synthetic_text(mib << 20, seed=SEED)
    n_blocks = -(-len(data) // (1 << 22))
    if n_blocks < 16:
        raise SystemExit(f"--cards 4 needs >= 16 blocks, --mib gives "
                         f"{n_blocks}")
    # the default mesh spans every device, so the public entry points
    # below shard their blocks over all four cards
    say(f"corpus: synthetic_text {len(data)} B, {n_blocks} blocks, "
        f"mesh over {[d.id for d in devices]}")
    for level in (1, 2):
        say(json.dumps(C.check_compress(data, level, True)[1]))
    for level in (0, 1):
        stream = native.compress(data, True, level=level)
        say(json.dumps(C.check_decompress(stream, data, f"l{level}")))
        say(json.dumps(C.check_decompress_to_file(
            stream, data, work / "out.bin", f"l{level}")))
        rec = C.check_words(stream, data)
        say(json.dumps(rec))
        held = rec["blocks_per_device"]
        if len(held) != 4 or min(held.values()) == 0:
            raise C.CheckFailed(f"blocks did not reach every card: {held}")
        for dev_id, n in sorted(held.items()):
            say(f"device {dev_id}: {n} block shards")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mib", type=int, default=256,
                    help="synthetic corpus size in MiB (default 256)")
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the four-card path")
    args = ap.parse_args()

    import jax

    if jax.default_backend() != "gpu" or jax.devices()[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX backend {jax.default_backend()!r})",
              file=sys.stderr)
        return 1
    if not (HERE / "build" / "libtsq_core.so").exists():
        subprocess.run(["make", "-C", str(HERE / "csrc"), "-j4"],
                       check=True, stdout=sys.stderr)
    sys.path.insert(0, str(HERE))
    from turbosqueeze_tpu.runtime import native
    from turbosqueeze_tpu.utils.compile_cache import enable_compile_cache

    if not native.available():
        raise SystemExit("chip_smoke: native core did not build")
    cache = enable_compile_cache()
    # cache every program, so the warm compile below reads the cache
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    for line in card.splitlines():
        say(f"card: {line}")
    dev = jax.devices()[0]
    say(f"jax {jax.__version__}: {len(jax.devices())} x {dev.device_kind} "
        f"({dev.platform}); compile cache {cache}")

    t0 = time.perf_counter()
    (four_cards if args.cards == 4 else one_card)(args.mib)
    say(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
