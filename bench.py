#!/usr/bin/env python3
"""Device benchmark on an NVIDIA GPU. Prints ONE JSON line to stdout:
  {"metric": ..., "value": N, "unit": "MB/s", "vs_baseline": N,
   "device": {...}, "extras": {...}}

Headline: end-to-end device decode, `pipeline.decompress` of a level-0
container of the seeded enwik9-class synthetic corpus (utils/corpus.py),
from container bytes in host memory to decoded bytes in host memory, warm
(every program compiled). vs_baseline divides it by the native core's
multithreaded decode of the same container, measured in the same run.

Extras: the XLA programs' marginal rates (decode_batch_xla and
find_candidates, batch-slope over 1, 2 and 4 blocks, each batch verified
byte-exact before timing), end-to-end device compress at level 1, and the
native core's encode and decode. Without a GPU the bench exits nonzero; it
never falls back to the CPU.

Env knob: TSQ_BENCH_MB (corpus MiB, default 256).
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

import numpy as np


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def get_corpus(size_mb: int) -> bytes:
    from turbosqueeze_tpu.utils.corpus import synthetic_text

    cache = REPO / ".benchdata" / f"enwik_syn_{size_mb}.bin"
    if cache.exists():
        return cache.read_bytes()
    t0 = time.time()
    data = synthetic_text(size_mb << 20, seed=1234)
    cache.parent.mkdir(exist_ok=True)
    cache.write_bytes(data)
    log(f"corpus: generated {size_mb} MiB in {time.time() - t0:.0f}s")
    return data


def ensure_native():
    from turbosqueeze_tpu.runtime import native

    if not native.available():
        subprocess.run(["make", "-C", str(REPO / "csrc")], check=True,
                       capture_output=True)
        native._SEARCHED = False
    return native


class SlopeRejected(RuntimeError):
    """The batch-slope fit failed its sanity gates (non-monotone or
    non-positive marginal time) — the measurement is dispatch noise, not
    a program's rate, and MUST NOT be published as a throughput."""


def slope_fit(points):
    """Least-squares marginal cost from >= 3 (bytes, seconds) points.

    A two-point slope through dispatch noise has no defense, so this fit
    requires (a) min-of-N per point (caller), (b) strictly increasing
    times across increasing batch sizes, (c) a positive fitted slope, and
    returns (slope_sec_per_byte, rel_residual) where rel_residual is the
    RMS fit error over the fitted time range — reported in extras so a
    sloppy fit is visible, not hidden.
    """
    pts = sorted(points)
    if len(pts) < 3:
        raise SlopeRejected(f"need >= 3 batch points, got {len(pts)}")
    for (s0, t0), (s1, t1) in zip(pts, pts[1:]):
        if not (s1 > s0 and t1 > t0):
            raise SlopeRejected(
                f"non-monotone timings: t({s0 / 1e6:.0f}MB)={t0 * 1e3:.2f}ms"
                f" >= t({s1 / 1e6:.0f}MB)={t1 * 1e3:.2f}ms")
    xs = np.array([p[0] for p in pts], np.float64)
    ts = np.array([p[1] for p in pts], np.float64)
    slope, icept = np.polyfit(xs, ts, 1)
    if slope <= 0:
        raise SlopeRejected(f"non-positive fitted slope {slope:.3e}")
    pred = slope * xs + icept
    rel = float(np.sqrt(np.mean((ts - pred) ** 2)) / (ts.max() - ts.min()))
    return float(slope), rel


def best_of(fn, reps: int = 6) -> float:
    """Min-of-N wall seconds of fn() with its result on the device."""
    import jax

    jax.block_until_ready(fn())  # compile + warm
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def program_rates(data: bytes, native) -> dict:
    """Marginal MB/s of decode_batch_xla and find_candidates over 1, 2
    and 4 full blocks (batch slope); every batch is checked first."""
    import jax

    from tests import device_checks as C
    from turbosqueeze_tpu.format import BLOCK_SZ, iter_container
    from turbosqueeze_tpu.kernels import decode_xla as DXL
    from turbosqueeze_tpu.kernels import encode_xla

    blocks = [data[k * BLOCK_SZ:(k + 1) * BLOCK_SZ] for k in range(4)]
    payloads = [(p, e) for _, p, e in
                iter_container(native.compress(b"".join(blocks), True))]
    fc = jax.jit(jax.vmap(encode_xla.find_candidates))
    dec, cand = [], []
    for B in (1, 2, 4):
        args = C.check_decode_batch(payloads[:B], blocks[:B])
        dec.append((B * BLOCK_SZ,
                    best_of(lambda: DXL.decode_batch_xla(*args))))
        dev = C.check_find_candidates(blocks[:B])
        cand.append((B * BLOCK_SZ, best_of(lambda: fc(dev))))
    out = {}
    for name, pts in (("decode_batch_xla", dec), ("find_candidates", cand)):
        per_byte, resid = slope_fit(pts)
        out[f"{name}_mbps"] = round(1e-6 / per_byte, 1)
        out[f"{name}_fit_residual"] = round(resid, 4)
        log(f"{name}: {1e-6 / per_byte:.1f} MB/s marginal "
            f"(points {[(s, round(t * 1e3, 3)) for s, t in pts]} ms)")
    return out


def main():
    import jax

    from turbosqueeze_tpu.utils.compile_cache import enable_compile_cache

    dev = jax.devices()[0]
    if jax.default_backend() != "gpu" or dev.platform != "gpu":
        raise SystemExit(f"bench.py: no GPU (JAX backend "
                         f"{jax.default_backend()!r}); nothing measured")
    enable_compile_cache()
    size_mb = int(os.environ.get("TSQ_BENCH_MB", "256"))
    native = ensure_native()
    data = get_corpus(size_mb)
    mb = len(data) / 1e6
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    log(f"card: {card}; jax {jax.__version__}, {len(jax.devices())} x "
        f"{dev.device_kind}")

    from turbosqueeze_tpu.parallel import pipeline

    # native core, same corpus (best of three warm passes)
    enc = dec = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        stream = native.compress(data, True, level=0)
        t1 = time.perf_counter()
        out = native.decompress(stream)
        t2 = time.perf_counter()
        enc, dec = min(enc, t1 - t0), min(dec, t2 - t1)
    assert out == data, "native roundtrip mismatch"
    log(f"native: encode {mb / enc:.0f} MB/s, decode {mb / dec:.0f} MB/s")

    extras = {"native_encode_mbps": round(mb / enc, 1),
              "native_decode_mbps": round(mb / dec, 1),
              "card": card, "corpus_mib": size_mb}
    extras.update(program_rates(data, native))

    # end to end through the public pipeline, warm
    out = pipeline.decompress(stream)
    assert out == data, "device decode mismatch"
    t0 = time.perf_counter()
    out = pipeline.decompress(stream)
    e2e_dec = mb / (time.perf_counter() - t0)
    assert out == data, "device decode mismatch"
    want = native.compress(data, True, level=1)
    got = pipeline.compress(data, True, level=1)
    assert got == want, "device compress differs from native level 1"
    t0 = time.perf_counter()
    pipeline.compress(data, True, level=1)
    extras["e2e_compress_l1_mbps"] = round(
        mb / (time.perf_counter() - t0), 1)
    log(f"e2e: decompress {e2e_dec:.1f} MB/s, compress level 1 "
        f"{extras['e2e_compress_l1_mbps']} MB/s")

    print(json.dumps({
        "metric": "e2e device decode, pipeline.decompress of level-0 "
                  "enwik9-class synthetic (MB/s, host bytes to host bytes)",
        "value": round(e2e_dec, 1),
        "unit": "MB/s",
        "vs_baseline": round(e2e_dec / (mb / dec), 3),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "extras": extras,
    }))


if __name__ == "__main__":
    main()
