"""Device-candidate compress on edge-case blocks: byte identity with the
native core at levels 0, 1 and 2.

Level 0 goes through pipeline.compress, which emits the upstream parse
with no device phase. Levels 1 and 2 take the device candidates
(encode_xla.find_candidates, run on a power-of-two bucket of the block so
the suite stays fast on the CPU) through pipeline.emit_block, the
emission the pipeline runs for every block; the payload must equal the
native core's.
"""

import subprocess
from pathlib import Path

import pytest

from tests.edge_cases import CASES, DICT_CASE
from turbosqueeze_tpu.format import iter_container
from turbosqueeze_tpu.kernels.encode_xla import find_candidates_host
from turbosqueeze_tpu.parallel import pipeline

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
def candidates():
    """Device candidates per case; they do not depend on ext."""
    cache = {}

    def get(case, data):
        if case not in cache:
            cache[case] = find_candidates_host(data)
        return cache[case]

    return get


def _payload(stream):
    [(_, payload, _)] = iter_container(stream)
    return payload


@pytest.mark.parametrize("ext", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_device_compress_edge_case(native, candidates, case, ext):
    data = CASES[case]()
    assert (pipeline.compress(data, ext, level=0)
            == native.compress(data, ext, level=0))
    cand = candidates(case, data)
    for level in (1, 2):
        assert (pipeline.emit_block(data, cand, ext, level)
                == _payload(native.compress(data, ext, level=level))), \
            f"level {level}"


@pytest.mark.parametrize("ext", [False, True])
def test_device_compress_dictionary_identity(native, ext):
    d, blk = DICT_CASE[0](), DICT_CASE[1]()
    cand = find_candidates_host(d + blk)
    for level in (1, 2):
        want = _payload(native.compress_dict(blk, d, ext, level=level))
        assert pipeline.emit_block(blk, cand, ext, level,
                                   dictionary=d) == want, f"level {level}"
    # the dictionary actually helps
    assert len(want) < len(_payload(native.compress(blk, ext, level=2)))
