"""XLA scatter/gather decode formulation (kernels/decode_xla.py).

Plain XLA: runs identically on the CPU test mesh and on the GPU.
Exactness is cross-checked against the oracle codec and the native core,
including adversarial chain depths (the pointer-doubling worst case).
"""

import numpy as np
import pytest

from turbosqueeze_tpu import reference_codec as rc
from turbosqueeze_tpu.kernels import decode_xla as DX
from turbosqueeze_tpu.utils.corpus import synthetic_binary, synthetic_text

N_OUT = 1 << 17  # small static shape keeps CPU tests fast


def _decode_via_xla(payloads_and_ext, n_out=N_OUT):
    parsed, payloads, sizes = [], [], []
    for payload, ext in payloads_and_ext:
        dst, src, ln, lit, size = rc.tokenize_block(payload, ext)
        parsed.append(tuple(np.asarray(x, np.int32)
                            for x in (dst, src, ln, lit)))
        payloads.append(payload)
        sizes.append(size)
    d, s, l, q = DX.pack_token_batch(parsed, n_out=n_out)
    pay = DX.pack_payload_batch(payloads)
    out = np.asarray(DX.decode_batch_xla(d, s, l, q, pay, n_out=n_out))
    return [out[b, :sizes[b]].tobytes() for b in range(len(sizes))]


@pytest.mark.parametrize("ext", [False, True])
def test_roundtrip_corpus(corpus_cases, ext):
    cases = [c for c in corpus_cases if 0 < len(c) <= N_OUT][:6]
    payloads = [(rc.encode_block(c, ext), ext) for c in cases]
    got = _decode_via_xla(payloads)
    for g, want in zip(got, cases):
        assert g == want


def test_mixed_ext_batch():
    """ext and no-ext blocks decode together in one flat batch."""
    a = synthetic_text(60_000, seed=51)
    b = synthetic_binary(90_000, seed=52)
    got = _decode_via_xla([(rc.encode_block(a, True), True),
                           (rc.encode_block(b, False), False)])
    assert got == [a, b]


def test_deep_chain_rle():
    """Adversarial chain depth: long runs make match-of-match chains that
    only full-depth pointer doubling resolves."""
    data = (b"ab" * 4096 + b"\x00" * 50_000 + b"xyz" * 9999)[:N_OUT]
    # level-1 candidate parse produces real matches on runs
    from turbosqueeze_tpu.runtime import native

    stream = native.compress(data, True, level=1)
    from turbosqueeze_tpu.format import iter_container

    blocks = list(iter_container(stream))
    assert len(blocks) == 1
    _, payload, ext = blocks[0]
    got = _decode_via_xla([(payload, ext)])
    assert got[0] == data


def test_insufficient_rounds_garbage_but_safe():
    """With rounds=0 deep chains stay unresolved — output wrong, no crash
    (mirrors upstream's garbage-tolerance on corrupt streams)."""
    data = b"ab" * 30_000
    from turbosqueeze_tpu.runtime import native

    stream = native.compress(data, True, level=1)
    from turbosqueeze_tpu.format import iter_container

    _, payload, ext = next(iter(iter_container(stream)))
    dst, src, ln, lit, size = rc.tokenize_block(payload, ext)
    parsed = [tuple(np.asarray(x, np.int32) for x in (dst, src, ln, lit))]
    d, s, l, q = DX.pack_token_batch(parsed, n_out=N_OUT)
    pay = DX.pack_payload_batch([payload])
    out = np.asarray(DX.decode_batch_xla(d, s, l, q, pay, n_out=N_OUT,
                                         rounds=0))
    assert out.shape == (1, N_OUT)  # executed, bounded, no exception


def test_matches_native_decoder_on_reference_stream(golden_harness, tmp_path):
    """Upstream-encoder streams decode bit-exactly through the XLA path."""
    import subprocess

    data = synthetic_text(100_000, seed=53)
    fin = tmp_path / "in"
    ftsq = tmp_path / "a.tsq"
    fin.write_bytes(data)
    subprocess.run([str(golden_harness), "c", "1", str(fin), str(ftsq)],
                   check=True)
    from turbosqueeze_tpu.format import iter_container

    stream = ftsq.read_bytes()
    _, payload, ext = next(iter(iter_container(stream)))
    got = _decode_via_xla([(payload, ext)])
    assert got[0] == data


def test_device_path_rejects_corrupt_streams():
    """Corrupt containers fail loudly through the device pipeline (the
    tokenizer validates structure before anything ships to the mesh)."""
    from turbosqueeze_tpu.format import FormatError
    from turbosqueeze_tpu.parallel import pipeline
    from turbosqueeze_tpu.runtime import native

    data = synthetic_text(100_000, seed=55)
    stream = bytearray(native.compress(data, True))
    with pytest.raises(FormatError):
        pipeline.decompress(bytes(stream[:40]))  # truncated
    bad = bytes(stream[:16]) + b"\xff\xff\x7f" + bytes(stream[19:])
    with pytest.raises(FormatError):
        pipeline.decompress(bad)  # block header claims a huge payload
