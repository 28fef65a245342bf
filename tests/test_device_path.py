"""Device codec path: XLA programs, sharded pipeline, backends.

Runs on the 8-virtual-device CPU mesh (conftest sets
xla_force_host_platform_device_count=8); the same XLA programs compile for
the GPU in production.
"""

import subprocess

import jax
import numpy as np
import pytest

from turbosqueeze_tpu import reference_codec as rc
from turbosqueeze_tpu.block import decode_block_device
from turbosqueeze_tpu.parallel import mesh as mesh_mod
from turbosqueeze_tpu.parallel import pipeline
from turbosqueeze_tpu.utils.corpus import synthetic_binary, synthetic_text


@pytest.fixture(scope="module", autouse=True)
def _native():
    from turbosqueeze_tpu.runtime import native

    if not native.available():
        subprocess.run(["make", "-C", "csrc"], check=True)
        native._SEARCHED = False
    assert native.available()


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("ext", [False, True])
def test_single_block_device_decode(corpus_cases, ext):
    for data in corpus_cases[:6]:
        payload = rc.encode_block(data, ext)
        assert decode_block_device(payload, ext) == data


def test_sharded_decompress_multiblock():
    """11 blocks over 8 devices, mixed sizes, ordered reassembly."""
    data = synthetic_text(10 * (1 << 22) + 54321, seed=17)
    from turbosqueeze_tpu.runtime import native

    stream = native.compress(data, True)
    out = pipeline.decompress(stream)
    assert out == data


@pytest.mark.slow
def test_pipeline_per_block_progress():
    """Progress fires once per completed BLOCK, not per device window —
    the upstream writer thread's cadence (tsq_threads.cpp:248-254)."""
    from turbosqueeze_tpu.runtime import native

    data = synthetic_text(2 * (1 << 22) + 999, seed=57)  # 3 blocks
    stream = native.compress(data, True)
    ticks = []
    out = pipeline.decompress(stream,
                              progress=lambda d, t: ticks.append((d, t)))
    assert out == data
    assert ticks == [(k + 1, 3) for k in range(3)]

    ticks = []
    stream2 = pipeline.compress(
        data, ext=True, progress=lambda d, t: ticks.append((d, t)))
    assert native.decompress(stream2) == data
    assert ticks == [(k + 1, 3) for k in range(3)]


def test_sharded_decompress_reference_stream(golden_harness, tmp_path):
    """Device pipeline must decode upstream-encoder-produced containers."""
    data = synthetic_binary(3 * (1 << 22), seed=23)
    fin = tmp_path / "in"
    ftsq = tmp_path / "a.tsq"
    fin.write_bytes(data)
    subprocess.run([str(golden_harness), "c", "1", str(fin), str(ftsq)],
                   check=True)
    assert pipeline.decompress(ftsq.read_bytes()) == data


@pytest.mark.slow
def test_device_compress_roundtrip():
    data = synthetic_text(2 * (1 << 22) + 999, seed=29)
    stream = pipeline.compress(data, ext=True)
    assert stream[:4] == b"TSQ1"
    from turbosqueeze_tpu.runtime import native

    # native and oracle both decode the device-compressed stream
    assert native.decompress(stream) == data
    assert pipeline.decompress(stream) == data


@pytest.mark.slow
def test_device_compress_ratio_beats_reference_parse():
    """The device candidate parse (level>=1) must compress at least as well
    as the reference's lossy hash-table parse on the bench corpora."""
    from turbosqueeze_tpu.runtime import native

    for data in (synthetic_text(1 << 22, seed=3),
                 synthetic_binary(1 << 22, seed=4)):
        ref_size = len(native.compress(data, True, level=0))
        dev_size = len(pipeline.compress(data, ext=True))
        assert dev_size <= ref_size


def test_device_matches_host_candidates():
    from ctypes import c_uint32

    import ctypes

    from turbosqueeze_tpu.kernels.encode_xla import find_candidates_host
    from turbosqueeze_tpu.runtime import native

    data = synthetic_text(100_000, seed=31)
    lib = native._load()
    lib.tsq_build_candidates.restype = None
    lib.tsq_build_candidates.argtypes = [
        ctypes.c_char_p, c_uint32, ctypes.c_void_p]
    host = np.empty(len(data), dtype=np.int32)
    lib.tsq_build_candidates(data + bytes(8), len(data), host.ctypes.data)
    dev = find_candidates_host(data)
    assert np.array_equal(host, dev)


@pytest.mark.slow
def test_device_backend_via_api():
    from turbosqueeze_tpu.runtime.api import compress, decompress

    data = synthetic_text(300_000, seed=37)
    stream = compress(data, ext=True, backend="device")
    assert decompress(stream, backend="device") == data
    # cross-backend
    assert decompress(stream, backend="native") == data


@pytest.mark.parametrize("ext", [False, True])
def test_device_compress_level0_matches_native(ext):
    """Level 0 through the device backend is the upstream parse: the
    container is byte-identical to native level 0 (and not to level 1)."""
    from turbosqueeze_tpu.runtime import native
    from turbosqueeze_tpu.runtime.api import compress

    data = synthetic_text((1 << 22) + 300_000, seed=37)  # 2 blocks
    stream = compress(data, ext=ext, backend="device", level=0)
    assert stream == native.compress(data, ext, level=0)
    assert stream != native.compress(data, ext, level=1)
    assert pipeline.decompress(stream) == data


def test_decompress_to_words_stays_sharded():
    """Decoded words keep the block sharding (device-resident consumers)."""
    data = synthetic_text(8 * (1 << 22), seed=41)
    from turbosqueeze_tpu.runtime import native

    stream = native.compress(data, True)
    mesh = mesh_mod.block_mesh()
    words, sizes, hdr = pipeline.decompress_to_words(stream, mesh)
    assert words.shape[0] == 8 and len(sizes) == 8
    assert hdr.total_size == len(data)
    shard_devs = {s.device.id for s in words.addressable_shards}
    assert len(shard_devs) == 8
    host = np.asarray(words)
    assert b"".join(host[b, :sizes[b]].tobytes()
                    for b in range(8)) == data


@pytest.mark.slow
def test_decompress_to_file_per_host_writes(tmp_path):
    """decompress_to_file writes blocks at their fixed offsets from each
    process's addressable shards (single-process degenerate case here;
    the true 2-process run is tests/test_multihost.py)."""
    from turbosqueeze_tpu.parallel import pipeline
    from turbosqueeze_tpu.runtime import native
    from turbosqueeze_tpu.utils.corpus import synthetic_text

    data = synthetic_text((1 << 22) + 70_000, seed=71)  # 2 blocks
    stream = native.compress(data, True)
    out = tmp_path / "out.bin"
    n = pipeline.decompress_to_file(stream, str(out))
    assert n == len(data)
    assert out.read_bytes() == data
