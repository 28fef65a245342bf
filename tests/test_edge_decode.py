"""Device decode (kernels/decode_xla.py) on edge-case blocks.

Every case of tests/edge_cases.py is compressed by the native core at
levels 0, 1 and 2, and each block payload is decoded through
block.decode_block_device, whose output plane is bucketed to a small power
of two so the suite stays fast on the CPU. The decoded bytes must equal
the input.
"""

import subprocess
from pathlib import Path

import pytest

from tests.edge_cases import CASES, DICT_CASE
from turbosqueeze_tpu.block import decode_block_device
from turbosqueeze_tpu.format import iter_container

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def native():
    from turbosqueeze_tpu.runtime import native as mod

    if not mod.available():
        subprocess.run(["make", "-C", str(REPO / "csrc")], check=True)
        mod._SEARCHED = False
    assert mod.available()
    return mod


@pytest.mark.parametrize("ext", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_device_decode_edge_case(native, case, ext):
    data = CASES[case]()
    for level in (0, 1, 2):
        [(_, payload, e)] = iter_container(
            native.compress(data, ext, level=level))
        assert decode_block_device(payload, e) == data, f"level {level}"


@pytest.mark.parametrize("size,plane", [(4096, 4096), (4097, 8192),
                                        (65536, 65536)])
def test_device_decode_output_plane(native, monkeypatch, size, plane):
    """A block whose size is a power of two decodes into a plane of
    exactly that size; one byte more takes the next power of two."""
    from turbosqueeze_tpu.kernels import decode_xla as DXL
    from turbosqueeze_tpu.utils.corpus import synthetic_text

    seen = []
    real = DXL.decode_batch_xla

    def spy(*args, n_out):
        seen.append(n_out)
        return real(*args, n_out=n_out)

    monkeypatch.setattr(DXL, "decode_batch_xla", spy)
    data = synthetic_text(size, seed=size)
    [(_, payload, e)] = iter_container(native.compress(data, True))
    assert decode_block_device(payload, e) == data
    assert seen == [plane]


@pytest.mark.parametrize("ext", [False, True])
def test_device_decode_dictionary_identity(native, ext):
    d, blk = DICT_CASE[0](), DICT_CASE[1]()
    for level in (1, 2):
        [(_, payload, e)] = iter_container(
            native.compress_dict(blk, d, ext, level=level))
        assert decode_block_device(payload, e, dictionary=d) == blk, \
            f"level {level}"
