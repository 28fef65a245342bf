"""Native C++ core: byte-parity vs the oracle codec, MT roundtrips, files."""

import subprocess
from pathlib import Path

import numpy as np
import pytest

from turbosqueeze_tpu import reference_codec as rc
from turbosqueeze_tpu.utils.corpus import synthetic_binary, synthetic_text

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="session")
def native():
    from turbosqueeze_tpu.runtime import native as mod

    if not mod.available():
        subprocess.run(["make", "-C", str(REPO / "csrc")], check=True)
        mod._SEARCHED = False  # re-probe
    assert mod.available()
    return mod


@pytest.mark.parametrize("ext", [False, True])
def test_container_byte_parity_vs_oracle(native, corpus_cases, ext):
    for n, data in enumerate(corpus_cases):
        assert native.compress(data, ext) == rc.compress(data, ext), \
            f"case {n} len={len(data)}"


@pytest.mark.parametrize("ext", [False, True])
def test_multiblock_roundtrip(native, ext):
    data = synthetic_text(2 * (1 << 22) + 12345, seed=8)  # 3 blocks
    stream = native.compress(data, ext)
    assert native.decompress(stream) == data
    # cross-backend
    assert rc.decompress(stream) == data


def test_empty(native):
    assert native.decompress(native.compress(b"")) == b""


def test_threads_deterministic(native):
    data = synthetic_binary(6 << 20, seed=3)
    s1 = native.compress(data, True, n_threads=1)
    s4 = native.compress(data, True, n_threads=4)
    assert s1 == s4


def test_array_api(native):
    data = np.frombuffer(synthetic_text(100_000), dtype=np.uint8)
    comp = native.compress_array(data, ext=True)
    out = native.decompress_array(comp)
    assert np.array_equal(out, data)


def test_file_roundtrip(native, tmp_path):
    data = synthetic_text(5 << 20, seed=21)
    src = tmp_path / "src"
    tsq = tmp_path / "a.tsq"
    dst = tmp_path / "dst"
    src.write_bytes(data)
    native.compress_file(str(src), str(tsq), ext=True)
    native.decompress_file(str(tsq), str(dst))
    assert dst.read_bytes() == data
    # file bytes identical to memory API
    assert tsq.read_bytes() == native.compress(data, True)


def test_file_matches_golden(native, golden_harness, tmp_path):
    """Our file container must be decodable by the upstream binary."""
    data = synthetic_text(1 << 20, seed=31)
    src = tmp_path / "src"
    tsq = tmp_path / "a.tsq"
    dst = tmp_path / "dst"
    src.write_bytes(data)
    native.compress_file(str(src), str(tsq), ext=False)
    subprocess.run([str(golden_harness), "d", str(tsq), str(dst)], check=True)
    assert dst.read_bytes() == data


def test_corrupt_stream_errors(native):
    data = synthetic_text(50_000)
    stream = bytearray(native.compress(data, True))
    with pytest.raises(Exception):
        native.decompress(bytes(stream[: len(stream) // 2]))
    stream[0:4] = b"XXXX"
    with pytest.raises(Exception):
        native.decompress(bytes(stream))


def test_level2_lazy_parse(native, golden_harness, tmp_path):
    """Level 2 = lazy one-step-deferred parse: same format (the upstream
    binary decodes it), roundtrips exactly, and compresses at least as well
    as greedy on compressible data."""
    for seed, gen in ((71, synthetic_text), (72, synthetic_binary)):
        data = gen((1 << 22) + 70_000, seed=seed)
        s0 = native.compress(data, True, level=0)
        s1 = native.compress(data, True, level=1)
        s2 = native.compress(data, True, level=2)
        assert native.decompress(s2) == data
        assert len(s2) <= len(s1) <= len(s0)
        # cross-decode by the upstream reference binary
        ftsq = tmp_path / f"l2_{seed}.tsq"
        fout = tmp_path / f"l2_{seed}.out"
        ftsq.write_bytes(s2)
        subprocess.run([str(golden_harness), "d", str(ftsq), str(fout)],
                       check=True)
        assert fout.read_bytes() == data


def test_level34_effort_dial(native, golden_harness, tmp_path):
    """Levels 3/4 cap the lazy chain walk at 8/4 entries: same format
    (upstream binary decodes them), exact roundtrip, ratio between the
    full lazy parse and the greedy candidate parse."""
    data = synthetic_text((1 << 22) + 9_000, seed=73)
    s1 = native.compress(data, True, level=1)
    s2 = native.compress(data, True, level=2)
    s3 = native.compress(data, True, level=3)
    s4 = native.compress(data, True, level=4)
    for s in (s3, s4):
        assert native.decompress(s) == data
    assert len(s2) <= len(s3) <= len(s4) <= len(s1)
    ftsq = tmp_path / "l3.tsq"
    fout = tmp_path / "l3.out"
    ftsq.write_bytes(s3)
    subprocess.run([str(golden_harness), "d", str(ftsq), str(fout)],
                   check=True)
    assert fout.read_bytes() == data


def test_level2_pathological_inputs(native):
    """Lazy parse on adversarial shapes: runs, tiny blocks, incompressible."""
    cases = [b"", b"a", b"\x00" * 100_000, bytes(range(256)) * 4,
             np.random.default_rng(9).integers(0, 256, 70_000,
                                               np.uint8).tobytes()]
    for data in cases:
        s2 = native.compress(data, True, level=2)
        assert native.decompress(s2) == data
        s2n = native.compress(data, False, level=2)
        assert native.decompress(s2n) == data


def test_concurrent_first_load(native):
    """The first native calls may come from many emission threads at once
    (pipeline.compress): every one of them must find the core."""
    import sys
    import threading

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(20):
            native._LIB, native._SEARCHED = None, False
            barrier = threading.Barrier(16)
            seen = []

            def probe():
                barrier.wait(timeout=30)
                seen.append(native.available())

            threads = [threading.Thread(target=probe) for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            assert not any(t.is_alive() for t in threads)
            assert seen == [True] * 16
    finally:
        sys.setswitchinterval(interval)
