"""Test configuration: an 8-device virtual CPU mesh unless a platform is
named.

Multi-device sharding logic is tested on the CPU via
XLA_FLAGS=--xla_force_host_platform_device_count=8 (SURVEY.md §4). Tests
marked ``gpu`` need an NVIDIA GPU and skip elsewhere; on a GPU machine run
them with ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu.py``.
"""

import os
import subprocess
import sys
from pathlib import Path

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

REFERENCE_DIR = Path("/root/reference")
REF_BUILD = REPO / ".ref_build"
HARNESS = REF_BUILD / "golden_harness"


@pytest.fixture(scope="session")
def golden_harness():
    """Build (once) and return the reference-codec golden harness binary.

    Skips golden cross-tests when the upstream reference isn't mounted.
    """
    if HARNESS.exists():
        return HARNESS
    if not REFERENCE_DIR.exists():
        pytest.skip("upstream reference not available")
    REF_BUILD.mkdir(exist_ok=True)
    shim = REF_BUILD / "shim"
    shim.mkdir(exist_ok=True)
    (shim / "stdbit.h").write_text(
        "#pragma once\n"
        "static inline int stdc_trailing_zeros_ull(unsigned long long v)"
        "{ return v ? __builtin_ctzll(v) : 64; }\n"
    )
    srcs = [
        REPO / "tests/golden/harness.cpp",
        REFERENCE_DIR / "tsq_encode.cpp",
        REFERENCE_DIR / "tsq_decode.cpp",
        REFERENCE_DIR / "turbosqueeze.cpp",
        REFERENCE_DIR / "tsq_context.cpp",
        REFERENCE_DIR / "tsq_threads.cpp",
    ]
    subprocess.run(
        ["g++", "-O2", "-std=c++17", f"-I{shim}", f"-I{REFERENCE_DIR}",
         "-o", str(HARNESS)] + [str(s) for s in srcs] + ["-pthread"],
        check=True,
    )
    return HARNESS


@pytest.fixture
def gpu():
    """Skips the test unless JAX runs on an NVIDIA GPU."""
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda)")


@pytest.fixture(scope="session")
def corpus_cases():
    """Deterministic mixed corpus: text, runs, random, structured, tiny."""
    from turbosqueeze_tpu.utils.corpus import standard_cases

    return standard_cases()
