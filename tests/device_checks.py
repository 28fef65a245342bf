"""Byte-exact checks of the device path, shared by chip_smoke.py and the
tests marked ``gpu``.

Each check drives a public entry point (``tsq.compress``/``decompress``
with ``backend="device"``, ``parallel/pipeline.py``, the CLI), compares the
result byte for byte with the native core or with the original bytes, and
returns a record of what it did. A mismatch raises ``CheckFailed``; no
check catches anything, so a caller that lets exceptions through fails
on the first wrong byte.
"""

from __future__ import annotations

import time
from pathlib import Path

import jax
import numpy as np

from turbosqueeze_tpu import cli
from turbosqueeze_tpu.format import BLOCK_SZ
from turbosqueeze_tpu.kernels import decode_xla as DXL
from turbosqueeze_tpu.kernels import encode_xla
from turbosqueeze_tpu.parallel import mesh as mesh_mod
from turbosqueeze_tpu.parallel import pipeline
from turbosqueeze_tpu.runtime import api, native


class CheckFailed(AssertionError):
    """A device result differs from its reference."""


def _expect(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def _record(phase: str, nbytes: int, seconds: float, **extra) -> dict:
    return {"phase": phase, "bytes": nbytes,
            "seconds": round(seconds, 4), "exact": True, **extra}


def check_compress(data: bytes, level: int, ext: bool):
    """Device-backend compress must equal native.compress at `level`.
    Returns (container, record)."""
    want = native.compress(data, ext, level=level)
    t0 = time.perf_counter()
    got = api.compress(data, ext=ext, backend="device", level=level)
    dt = time.perf_counter() - t0
    _expect(got == want, f"compress level {level} ext {ext}: device "
                         f"container ({len(got)} B) differs from native "
                         f"({len(want)} B)")
    return got, _record(f"compress l{level} ext={int(ext)}", len(data), dt,
                        out_bytes=len(got))


def check_decompress(stream: bytes, data: bytes, name: str) -> dict:
    """Device-backend decompress must give back `data`."""
    t0 = time.perf_counter()
    out = api.decompress(stream, backend="device")
    dt = time.perf_counter() - t0
    _expect(out == data, f"decompress {name}: device output differs")
    return _record(f"decompress {name}", len(data), dt)


def check_decompress_to_file(stream: bytes, data: bytes, path: Path,
                             name: str) -> dict:
    """pipeline.decompress_to_file must write `data` to `path`."""
    t0 = time.perf_counter()
    n = pipeline.decompress_to_file(stream, str(path))
    dt = time.perf_counter() - t0
    _expect(n == len(data) and Path(path).read_bytes() == data,
            f"decompress_to_file {name}: file differs")
    Path(path).unlink()
    return _record(f"decompress_to_file {name}", len(data), dt)


def check_dictionary(data: bytes, dictionary: bytes, ext: bool) -> dict:
    """Dictionary compress and decode through the device backend, against
    native.compress_dict (the dictionary parse starts at level 1)."""
    want = native.compress_dict(data, dictionary, ext, level=1)
    t0 = time.perf_counter()
    got = api.compress(data, ext=ext, backend="device", level=1,
                       dictionary=dictionary)
    t1 = time.perf_counter()
    _expect(got == want, "dictionary compress differs from native")
    out = api.decompress(got, backend="device", dictionary=dictionary)
    t2 = time.perf_counter()
    _expect(out == data, "dictionary decode differs from the input")
    return _record(f"dictionary ext={int(ext)}", len(data), t2 - t0,
                   compress_s=round(t1 - t0, 4),
                   decompress_s=round(t2 - t1, 4), out_bytes=len(got))


def block_shards(arr: jax.Array, n_blocks: int) -> dict:
    """Real (non-padding) blocks each device holds of a block-sharded
    array, keyed by device id."""
    held = {}
    for shard in arr.addressable_shards:
        lo = shard.index[0].start or 0
        rows = shard.data.shape[0]
        held[shard.device.id] = held.get(shard.device.id, 0) + max(
            0, min(lo + rows, n_blocks) - lo)
    return held


def check_words(stream: bytes, data: bytes) -> dict:
    """decompress_to_words must leave the decoded blocks on the device,
    sharded over the block axis of the default mesh, and hold `data`."""
    mesh = mesh_mod.block_mesh()
    t0 = time.perf_counter()
    words, sizes, hdr = pipeline.decompress_to_words(stream, mesh)
    jax.block_until_ready(words)
    dt = time.perf_counter() - t0
    _expect(words.sharding.is_equivalent_to(mesh_mod.block_sharding(mesh),
                                            words.ndim),
            "decoded words are not sharded over the block axis")
    _expect({s.device for s in words.addressable_shards}
            == set(mesh.devices.flat), "decoded words left some device")
    held = block_shards(words, len(sizes))
    host = np.asarray(words)
    got = b"".join(host[b, :sizes[b]].tobytes() for b in range(len(sizes)))
    _expect(hdr.total_size == len(data) and got == data,
            "decompress_to_words bytes differ")
    return _record("decompress_to_words", len(data), dt,
                   blocks_per_device=held)


def check_cli(data: bytes, workdir: Path, name: str, level: int = 1) -> dict:
    """`tsq --backend device c` then `d` must round-trip `data` and write
    native's container."""
    src, tsq, out = (workdir / f"{name}.in", workdir / f"{name}.tsq",
                     workdir / f"{name}.out")
    src.write_bytes(data)
    t0 = time.perf_counter()
    rc_c = cli.main(["--backend", "device", "c", str(src), str(tsq),
                     "--level", str(level)])
    rc_d = cli.main(["--backend", "device", "d", str(tsq), str(out)])
    dt = time.perf_counter() - t0
    _expect(rc_c == 0 and rc_d == 0, f"cli {name}: exit codes {rc_c} {rc_d}")
    _expect(tsq.read_bytes() == native.compress(data, True, level=level),
            f"cli {name}: container differs from native")
    _expect(out.read_bytes() == data, f"cli {name}: roundtrip differs")
    for f in (src, tsq, out):
        f.unlink()
    return _record(f"cli l{level} {name}", len(data), dt)


def check_decode_batch(payloads_ext, datas, n_out: int = DXL.OUT_N):
    """decode_batch_xla on one batch of block payloads must give `datas`.
    Returns the jitted call's arguments for timing."""
    parsed, pays = [], []
    for payload, ext in payloads_ext:
        dst, src, ln, lit, _size = native.tokenize_block(payload, ext)
        parsed.append((dst, src, ln, lit))
        pays.append(payload)
    args = (*DXL.pack_token_batch(parsed, n_out),
            DXL.pack_payload_batch(pays, DXL.PAY_N))
    args = tuple(jax.device_put(a) for a in args)
    out = np.asarray(DXL.decode_batch_xla(*args, n_out=n_out))
    for b, d in enumerate(datas):
        _expect(out[b, :len(d)].tobytes() == d,
                f"decode_batch_xla block {b} differs")
    return args


def check_find_candidates(blocks):
    """find_candidates over a (B, BLOCK_SZ) batch must equal the native
    hash-chain candidates. Returns the batch on the device."""
    batch = np.zeros((len(blocks), BLOCK_SZ), np.int32)
    for b, blk in enumerate(blocks):
        batch[b, :len(blk)] = np.frombuffer(blk, np.uint8)
    dev = jax.device_put(batch)
    got = np.asarray(jax.vmap(encode_xla.find_candidates)(dev))
    for b, blk in enumerate(blocks):
        _expect(np.array_equal(got[b, :len(blk)],
                               native.build_candidates(blk)),
                f"find_candidates block {b} differs from native")
    return dev
