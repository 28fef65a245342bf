"""Randomized roundtrip property tests across parse levels.

An offset-window-wrap bug (the window_edge cases of tests/edge_cases.py)
was a data-dependent silent mis-encode that survived 88 structured tests
and a 256 MiB bench corpus before a 1 GiB run exposed it. These fuzz cases
mix content classes whose boundaries produce the hazardous shapes: long
unique runs ending at window-edge repeats, dense short matches, zero
runs, and abrupt entropy switches.
"""

import subprocess
from pathlib import Path

import numpy as np
import pytest

from tests.edge_cases import mixed_case

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def native():
    from turbosqueeze_tpu.runtime import native as mod

    if not mod.available():
        subprocess.run(["make", "-C", str(REPO / "csrc")], check=True)
        mod._SEARCHED = False
    assert mod.available()
    return mod


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_fuzz_roundtrip_all_levels(native, seed):
    rng = np.random.default_rng(seed)
    data = mixed_case(rng, int(rng.integers(150_000, 400_000)))
    for ext in (True, False):
        for level in (0, 1, 2):
            s = native.compress(data, ext, level=level)
            assert native.decompress(s) == data, \
                f"seed={seed} ext={ext} level={level}"
    # dictionary mode over the same content
    d = data[:40_000]
    sd = native.compress_dict(data, d, True, level=2)
    assert native.decompress_dict(sd, d) == data
