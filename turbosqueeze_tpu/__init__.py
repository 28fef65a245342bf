"""turbosqueeze_tpu — a lossless compression framework for accelerators.

A from-scratch JAX/XLA + C++ implementation of the Turbosqueeze `.tsq`
realtime compression format (LZ77-family, independent 4 MiB blocks, TSQ1
container):

  * blocks are the unit of data parallelism, sharded over a
    ``jax.sharding.Mesh`` across devices and hosts (the reference's
    reader/workers/writer thread pipeline, re-expressed as SPMD);
  * the decode and the encoder's match search run as XLA programs on the
    device (an NVIDIA GPU in production);
  * a native C++ core (csrc/) provides the host-side runtime: exact codec,
    multithreaded block scheduler, container I/O — the moral equivalent of
    the reference's tsq_threads.cpp engine;
  * a pure-Python oracle codec serves as the executable format spec.
"""

__version__ = "0.1.0"

from . import format  # noqa: F401
from .format import BLOCK_SZ, OUTPUT_SZ, FormatError  # noqa: F401


def compress(data: bytes, ext: bool = True, backend: str = "auto",
             level: int = 0, dictionary: bytes = None) -> bytes:
    """Compress bytes into a .tsq container. Backend: auto|native|oracle|device.

    level: 0 = upstream-identical greedy parse, 1 = exact candidate parse,
    >= 2 = lazy best-of-chain (smaller, same format). dictionary: <= 64 KiB
    preset context shared by every block (framework extension; both ends
    must supply the same one).
    """
    from .runtime.api import compress as _compress

    return _compress(data, ext=ext, backend=backend, level=level,
                     dictionary=dictionary)


def decompress(stream: bytes, backend: str = "auto",
               dictionary: bytes = None) -> bytes:
    """Decompress a .tsq container. Backend: auto|native|oracle|device."""
    from .runtime.api import decompress as _decompress

    return _decompress(stream, backend=backend, dictionary=dictionary)
