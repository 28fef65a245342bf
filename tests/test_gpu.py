"""The device path on an NVIDIA GPU, through the same checks chip_smoke.py
runs at full size (tests/device_checks.py), on a small
3-block corpus.

Marked ``gpu``: without a card they skip. On a GPU machine run
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu.py``.
"""

import pytest

from tests import device_checks as C
from turbosqueeze_tpu.format import BLOCK_SZ, iter_container
from turbosqueeze_tpu.runtime import native
from turbosqueeze_tpu.utils.corpus import synthetic_text

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def data():
    return synthetic_text(2 * BLOCK_SZ + 70_000, seed=7)  # 3 blocks


@pytest.mark.parametrize("level", [0, 1, 2])
@pytest.mark.parametrize("ext", [False, True])
def test_compress_and_decode(gpu, data, tmp_path, level, ext):
    stream, _ = C.check_compress(data, level, ext)
    C.check_decompress(stream, data, f"l{level}")
    C.check_decompress_to_file(stream, data, tmp_path / "out.bin",
                               f"l{level}")


def test_dictionary(gpu, data):
    C.check_dictionary(data, synthetic_text(32_000, seed=500), True)


def test_decompress_to_words(gpu, data):
    C.check_words(native.compress(data, True), data)


def test_cli(gpu, data, tmp_path):
    C.check_cli(data, tmp_path, "gpu")


def test_xla_programs(gpu, data):
    blocks = [data[:BLOCK_SZ], data[BLOCK_SZ:2 * BLOCK_SZ]]
    payloads = [(p, e) for _, p, e in
                iter_container(native.compress(b"".join(blocks), True))]
    C.check_decode_batch(payloads, blocks)
    C.check_find_candidates(blocks)
