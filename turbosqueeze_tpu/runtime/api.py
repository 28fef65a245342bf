"""Public blocking compress/decompress API with backend dispatch.

Backends:
  * ``oracle`` — pure-Python exact codec (slow; the executable spec).
  * ``native`` — C++ multithreaded core via ctypes (host production path,
    the equivalent of tsqCompress_MT/tsqDecompress_MT).
  * ``device`` — JAX device pipeline (blocks sharded over the mesh).
  * ``auto``   — best available: native if built, else oracle.
"""

from __future__ import annotations

from ..format import FormatError


def _native_available() -> bool:
    try:
        from . import native

        return native.available()
    except Exception:
        return False


def _resolve(backend: str) -> str:
    if backend == "auto":
        return "native" if _native_available() else "oracle"
    if backend not in ("oracle", "native", "device"):
        raise ValueError(f"unknown backend: {backend!r}")
    return backend


def compress(data: bytes, ext: bool = True, backend: str = "auto",
             level: int = 0, dictionary: bytes = None,
             progress=None) -> bytes:
    """Compress bytes into a .tsq container.

    ``level`` selects the parse: 0 reproduces the upstream greedy parse
    bit-for-bit (the upstream plumbs the flag but never reads it,
    SURVEY.md §5); >=1 uses the exact candidate parse (better ratio).
    ``dictionary`` (framework extension, <=64 KiB) supplies shared context
    virtually preceding every block; both ends must use the same one.
    """
    b = _resolve(backend)
    if dictionary is not None:
        if b == "oracle":
            raise NotImplementedError(
                "dictionary mode needs the native or device backend")
        if b == "native":
            from . import native

            return native.compress_dict(data, dictionary, ext,
                                        level=max(level, 1),
                                        progress=progress)
        from ..parallel import pipeline

        return pipeline.compress(data, ext, level=max(level, 1),
                                 dictionary=dictionary, progress=progress)
    if b == "oracle":
        from .. import reference_codec

        return reference_codec.compress(data, ext)
    if b == "native":
        from . import native

        return native.compress(data, ext, level=level, progress=progress)
    from ..parallel import pipeline

    return pipeline.compress(data, ext, level=level, progress=progress)


def decompress(stream: bytes, backend: str = "auto",
               dictionary: bytes = None, progress=None) -> bytes:
    """Decompress a .tsq container."""
    if len(stream) < 16 or stream[:4] != b"TSQ1":
        raise FormatError("not a TSQ1 stream")
    b = _resolve(backend)
    if dictionary is not None:
        if b == "device":
            from ..parallel import pipeline

            return pipeline.decompress(stream, dictionary=dictionary,
                                       progress=progress)
        if b == "oracle":
            from .. import reference_codec

            return reference_codec.decompress(stream, dictionary=dictionary)
        from . import native

        return native.decompress_dict(stream, dictionary,
                                      progress=progress)
    if b == "oracle":
        from .. import reference_codec

        return reference_codec.decompress(stream)
    if b == "native":
        from . import native

        return native.decompress(stream, progress=progress)
    from ..parallel import pipeline

    return pipeline.decompress(stream, progress=progress)
