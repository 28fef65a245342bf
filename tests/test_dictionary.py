"""Preset-dictionary mode (framework extension; BASELINE config 4).

Shared <=64 KiB context virtually precedes every block; matches may reach
back into it. The on-disk format is unchanged; both ends must supply the
same dictionary.
"""

import subprocess
from pathlib import Path

import pytest

from turbosqueeze_tpu.utils.corpus import synthetic_text

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def native():
    from turbosqueeze_tpu.runtime import native as mod

    if not mod.available():
        subprocess.run(["make", "-C", str(REPO / "csrc")], check=True)
        mod._SEARCHED = False
    assert mod.available()
    return mod


@pytest.fixture(scope="module")
def dictionary():
    return synthetic_text(32_000, seed=500)


def test_dict_roundtrip(native, dictionary):
    data = synthetic_text(150_000, seed=501)
    stream = native.compress_dict(data, dictionary, ext=True)
    assert native.decompress_dict(stream, dictionary) == data


def test_dict_improves_ratio_on_shared_context(native, dictionary):
    """Data drawn from the same distribution as the dictionary compresses
    better with it — the whole point of preset dictionaries."""
    # small payload: dictionary context dominates
    data = synthetic_text(8_000, seed=500)[4_000:]  # overlaps dict content
    plain = native.compress(data, True, level=1)
    with_dict = native.compress_dict(data, dictionary, ext=True)
    assert len(with_dict) < len(plain)


def test_dict_multiblock(native, dictionary):
    """Every block gets the same shared dictionary (broadcast semantics)."""
    data = synthetic_text(2 * (1 << 22) + 777, seed=502)
    stream = native.compress_dict(data, dictionary, ext=False)
    assert native.decompress_dict(stream, dictionary) == data


def test_oracle_decodes_dict_stream(native, dictionary):
    from turbosqueeze_tpu import reference_codec as rc

    data = synthetic_text(50_000, seed=503)
    stream = native.compress_dict(data, dictionary, ext=True)
    assert rc.decompress(stream, dictionary=dictionary) == data


def test_wrong_dict_corrupts(native, dictionary):
    data = synthetic_text(6_000, seed=500)[:5_000]
    stream = native.compress_dict(data, dictionary, ext=True)
    wrong = synthetic_text(32_000, seed=999)
    out = native.decompress_dict(stream, wrong)
    assert out != data  # garbage-in contract, like zstd raw dicts


def test_dict_validation(native):
    with pytest.raises(ValueError):
        native.compress_dict(b"x", b"")
    with pytest.raises(ValueError):
        native.compress_dict(b"x", bytes(70_000))


def test_api_and_cli_dict(native, dictionary, tmp_path):
    from turbosqueeze_tpu.cli import main
    from turbosqueeze_tpu.runtime.api import compress, decompress

    data = synthetic_text(40_000, seed=504)
    stream = compress(data, dictionary=dictionary, backend="native")
    assert decompress(stream, dictionary=dictionary) == data

    dpath = tmp_path / "dict.bin"
    src = tmp_path / "src"
    tsq = tmp_path / "a.tsq"
    out = tmp_path / "out"
    dpath.write_bytes(dictionary)
    src.write_bytes(data)
    assert main(["c", str(src), str(tsq), "--dict", str(dpath)]) == 0
    assert main(["d", str(tsq), str(out), "--dict", str(dpath)]) == 0
    assert out.read_bytes() == data


@pytest.mark.slow
def test_device_dict_compress(native, dictionary):
    """Device backend: dictionary broadcast across the mesh + device
    candidate search over concat(dict, block)."""
    from turbosqueeze_tpu.parallel import pipeline

    data = synthetic_text(300_000, seed=505)
    stream = pipeline.compress(data, ext=True, dictionary=dictionary)
    assert native.decompress_dict(stream, dictionary) == data
    # device parse with dict must match the host dict parse byte-for-byte
    host_stream = native.compress_dict(data, dictionary, ext=True)
    assert stream == host_stream


def test_device_dict_decode(native, dictionary):
    """Dict streams decode on the device mesh: the dictionary is staged by
    synthetic literal tokens (block.tokenize_with_dict)."""
    from turbosqueeze_tpu.parallel import pipeline

    data = synthetic_text(300_000, seed=97)
    stream = native.compress_dict(data, dictionary, True)
    assert pipeline.decompress(stream, dictionary=dictionary) == data
    # api routing
    from turbosqueeze_tpu.runtime.api import decompress

    assert decompress(stream, backend="device",
                      dictionary=dictionary) == data


def test_device_dict_decode_multiblock(native, dictionary):
    from turbosqueeze_tpu.parallel import pipeline

    data = synthetic_text(2 * (1 << 22) + 4321, seed=98)
    stream = native.compress_dict(data, dictionary, True)
    assert pipeline.decompress(stream, dictionary=dictionary) == data


@pytest.mark.slow
def test_dict_level2_lazy_parse(native, dictionary):
    """level >= 2 selects the lazy best-of-chain parse in dictionary mode
    too (level used to silently stay greedy with a dict)."""
    data = synthetic_text(200_000, seed=506)
    greedy = native.compress_dict(data, dictionary, True, level=1)
    lazy = native.compress_dict(data, dictionary, True, level=2)
    assert native.decompress_dict(lazy, dictionary) == data
    assert len(lazy) < len(greedy)

    from turbosqueeze_tpu.parallel import pipeline

    dev_lazy = pipeline.compress(data, ext=True, level=2,
                                 dictionary=dictionary)
    assert dev_lazy == lazy
