"""The bench's batch-slope instrument must be unable to publish garbage.

A two-point slope through dispatch noise has no defense: it once
published negative throughputs (-936 / -2000 MB/s). slope_fit is the
hardened replacement: >= 3 points, monotone, positive slope, residual
reported.
"""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import bench  # noqa: E402


def test_slope_fit_clean_fit():
    # exactly linear: t = 1e-9 * bytes + 5ms fixed dispatch
    pts = [(b, 1e-9 * b + 5e-3) for b in (4e6, 32e6, 64e6)]
    slope, resid = bench.slope_fit(pts)
    assert abs(slope - 1e-9) < 1e-15
    assert resid < 1e-9


def test_slope_fit_reports_residual():
    pts = [(4e6, 9.2e-3), (32e6, 37.5e-3), (64e6, 68.1e-3)]
    slope, resid = bench.slope_fit(pts)
    assert slope > 0
    assert 0 <= resid < 1  # RMS error relative to the fitted range


def test_slope_fit_rejects_nonmonotone():
    # the round-3 failure shape: t(B=16) < t(B=1) through dispatch noise
    with pytest.raises(bench.SlopeRejected, match="non-monotone"):
        bench.slope_fit([(4e6, 20e-3), (32e6, 15e-3), (64e6, 30e-3)])


def test_slope_fit_rejects_two_points():
    with pytest.raises(bench.SlopeRejected, match=">= 3 batch points"):
        bench.slope_fit([(4e6, 10e-3), (64e6, 20e-3)])


def test_slope_fit_rejects_negative_slope():
    # strictly decreasing fails monotonicity first; craft a monotone-in-
    # size but flat-times set via equal times -> also rejected
    with pytest.raises(bench.SlopeRejected):
        bench.slope_fit([(4e6, 10e-3), (32e6, 10e-3), (64e6, 10e-3)])
