"""ctypes bindings to the C++ native core (libtsq_core.so).

The native core is built from csrc/ (see csrc/Makefile). Until it is built,
``available()`` returns False and the auto backend falls back to the oracle.
"""

from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path
from typing import Optional

_LIB: Optional[ctypes.CDLL] = None
_SEARCHED = False
# the device pipeline's first native calls can come from several emission
# threads at once; without the lock a thread could see _SEARCHED set
# before _LIB is and report the core as missing
_LOAD_LOCK = threading.Lock()

# Zero-copy result buffers: decode sizes are exact (the container header
# declares them), so the native core can write straight into a freshly
# allocated Python bytes object — the standard CPython refcount-1 idiom —
# instead of staging through numpy and paying a full-stream copy.
_py_new_bytes = ctypes.pythonapi.PyBytes_FromStringAndSize
_py_new_bytes.argtypes = [ctypes.c_void_p, ctypes.c_ssize_t]
_py_new_bytes.restype = ctypes.py_object
_py_bytes_ptr = ctypes.pythonapi.PyBytes_AsString
_py_bytes_ptr.argtypes = [ctypes.py_object]
_py_bytes_ptr.restype = ctypes.c_void_p


_py_resize_bytes = ctypes.pythonapi._PyBytes_Resize
_py_resize_bytes.argtypes = [ctypes.POINTER(ctypes.py_object),
                             ctypes.c_ssize_t]
_py_resize_bytes.restype = ctypes.c_int


# Large fresh PyBytes buffers fault in 4 KiB pages as the native core
# writes them; advising transparent huge pages first cuts the fault count
# 512x and the kernel's page zeroing runs at THP speed (measured on this
# box: 64 MiB decode output 52 -> 38 ms end to end, +39% wrapper decode
# throughput — numpy already does the same for its own big allocations,
# which is why np.empty outputs never showed the penalty).
_HUGE_MIN = 8 << 20       # advise only when it can span several 2 MiB pages
_HUGE_ALIGN = 2 << 20
_MADV_HUGEPAGE = 14       # linux uapi mman.h
_libc = None


def _advise_hugepages(ptr: int, n: int) -> None:
    """Best-effort madvise(MADV_HUGEPAGE) on the 2 MiB-aligned interior of
    [ptr, ptr+n). No-op on failure or non-Linux."""
    global _libc
    if n < _HUGE_MIN or not ptr:
        return
    try:
        if _libc is None:
            _libc = ctypes.CDLL(None, use_errno=True)
        a0 = (ptr + _HUGE_ALIGN - 1) & ~(_HUGE_ALIGN - 1)
        ln = (ptr + n - a0) & ~(_HUGE_ALIGN - 1)
        if ln > 0:
            _libc.madvise(ctypes.c_void_p(a0), ctypes.c_size_t(ln),
                          _MADV_HUGEPAGE)
    except Exception:
        pass


def _alloc_exact_bytes(n: int):
    """Uninitialized bytes of length n plus its writable buffer address."""
    b = _py_new_bytes(None, n)
    ptr = _py_bytes_ptr(b)
    _advise_hugepages(ptr, n)
    return b, ptr


def _shrink_bytes(obj: ctypes.py_object, n: int) -> bytes:
    """In-place shrink of a refcount-1 bytes held ONLY by ``obj``."""
    if _py_resize_bytes(ctypes.byref(obj), n) != 0:
        raise MemoryError("bytes resize failed")
    return obj.value


def _find_library() -> Optional[Path]:
    here = Path(__file__).resolve().parent.parent.parent
    candidates = [  # an explicit override outranks the repo builds
        Path(os.environ.get("TSQ_CORE_LIB", "/nonexistent")),
        here / "build" / "libtsq_core.so",
        here / "csrc" / "libtsq_core.so",
    ]
    for c in candidates:
        if c.exists():
            return c
    return None


def _load() -> Optional[ctypes.CDLL]:
    with _LOAD_LOCK:
        if not _SEARCHED:
            _bind()
        return _LIB


def _bind() -> None:
    global _LIB, _SEARCHED
    _SEARCHED = True
    path = _find_library()
    if path is None:
        return
    lib = ctypes.CDLL(str(path))
    lib.tsq_compress_bound.restype = ctypes.c_uint64
    lib.tsq_compress_bound.argtypes = [ctypes.c_uint64]
    lib.tsq_compress_mt.restype = ctypes.c_int64
    lib.tsq_compress_mt.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64,        # input
        ctypes.c_void_p, ctypes.c_uint64,        # output buffer, capacity
        ctypes.c_int, ctypes.c_uint32, ctypes.c_int,  # ext, level, n_threads
    ]
    lib.tsq_decompress_mt.restype = ctypes.c_int64
    lib.tsq_decompress_mt.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64,
        ctypes.c_void_p, ctypes.c_uint64,
        ctypes.c_int,
    ]
    lib.tsq_decompressed_size.restype = ctypes.c_int64
    lib.tsq_decompressed_size.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    lib.tsq_tokenize_block.restype = ctypes.c_int64
    lib.tsq_tokenize_block.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint32,
    ]
    lib.tsq_build_candidates.restype = None
    lib.tsq_build_candidates.argtypes = [
        ctypes.c_char_p, ctypes.c_uint32, ctypes.c_void_p]
    lib.tsq_encode_block_candidates.restype = ctypes.c_int64
    lib.tsq_encode_block_candidates.argtypes = [
        ctypes.c_char_p, ctypes.c_uint32, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int]
    lib.tsq_encode_block_lazy.restype = ctypes.c_int64
    lib.tsq_encode_block_lazy.argtypes = [
        ctypes.c_char_p, ctypes.c_uint32, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_uint32]
    lib.tsq_compress_mt_dict.restype = ctypes.c_int64
    lib.tsq_compress_mt_dict.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_uint32,
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint32, PROGRESS_CFUNC, ctypes.c_void_p]
    lib.tsq_decompress_mt_dict.restype = ctypes.c_int64
    lib.tsq_decompress_mt_dict.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_uint32,
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int, PROGRESS_CFUNC,
        ctypes.c_void_p]
    lib.tsq_compress_mt_cb.restype = ctypes.c_int64
    lib.tsq_compress_mt_cb.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_uint64,
        ctypes.c_int, ctypes.c_uint32, ctypes.c_int, PROGRESS_CFUNC,
        ctypes.c_void_p]
    lib.tsq_decompress_mt_cb.restype = ctypes.c_int64
    lib.tsq_decompress_mt_cb.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_uint64,
        ctypes.c_int, PROGRESS_CFUNC, ctypes.c_void_p]
    lib.tsq_compress_file_cb.restype = ctypes.c_int64
    lib.tsq_compress_file_cb.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_uint32,
        ctypes.c_int, PROGRESS_CFUNC, ctypes.c_void_p]
    lib.tsq_decompress_file_cb.restype = ctypes.c_int64
    lib.tsq_decompress_file_cb.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, PROGRESS_CFUNC,
        ctypes.c_void_p]
    lib.tsq_encode_block_dict.restype = ctypes.c_int64
    lib.tsq_encode_block_dict.argtypes = [
        ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32]
    _LIB = lib

MAX_DICT = 65536 - 4


def compress_dict(data: bytes, dictionary: bytes, ext: bool = True,
                  n_threads: int = 0, level: int = 1,
                  progress=None) -> bytes:
    """Compress with a preset dictionary (shared 64 KiB context virtually
    preceding every block; framework extension — see csrc/tsq_core.h)."""
    import numpy as np

    lib = _load()
    if lib is None:
        raise RuntimeError("native core not built (run `make -C csrc`)")
    if not (0 < len(dictionary) <= MAX_DICT):
        raise ValueError(f"dictionary must be 1..{MAX_DICT} bytes")
    bound = lib.tsq_compress_bound(len(data))
    out = np.empty(bound, dtype=np.uint8)
    cb, _keep = _wrap_progress(progress)
    n = lib.tsq_compress_mt_dict(data, len(data), dictionary,
                                 len(dictionary), _as_ptr(out), bound,
                                 1 if ext else 0, n_threads, level, cb,
                                 None)
    if n < 0:
        raise RuntimeError(f"native dict compress failed (code {n})")
    return out[:n].tobytes()


def decompress_dict(stream: bytes, dictionary: bytes,
                    n_threads: int = 0, progress=None) -> bytes:
    from ..format import FormatError

    lib = _load()
    if lib is None:
        raise RuntimeError("native core not built (run `make -C csrc`)")
    if not (0 < len(dictionary) <= MAX_DICT):
        raise ValueError(f"dictionary must be 1..{MAX_DICT} bytes")
    size = lib.tsq_decompressed_size(stream, len(stream))
    if size < 0:
        raise FormatError(f"bad .tsq stream (code {size})")
    out, ptr = _alloc_exact_bytes(size)
    cb, _keep = _wrap_progress(progress)
    n = lib.tsq_decompress_mt_dict(stream, len(stream), dictionary,
                                   len(dictionary), ptr, size, n_threads,
                                   cb, None)
    if n < 0:
        raise FormatError(f"native dict decompress failed (code {n})")
    if n != size:
        raise FormatError(f"native dict decompress short ({n} != {size})")
    return out


def encode_block_dict(block: bytes, dictionary: bytes, cand,
                      ext: bool, level: int = 1) -> bytes:
    """Emit one block payload from concat-buffer candidates (device encode
    path with dictionary: candidates come from find_candidates over
    dictionary+block). level >= 2 selects the lazy best-of-chain parse,
    same as the non-dict emission."""
    import numpy as np

    lib = _load()
    if lib is None:
        raise RuntimeError("native core not built (run `make -C csrc`)")
    cand = np.ascontiguousarray(cand, dtype=np.int32)
    if len(cand) != len(dictionary) + len(block):
        raise ValueError("candidates must cover dictionary + block")
    out = np.empty((1 << 22) + (1 << 20) + 64, dtype=np.uint8)
    psz = lib.tsq_encode_block_dict(
        dictionary + block + bytes(80), len(dictionary), len(block),
        cand.ctypes.data, out.ctypes.data, 1 if ext else 0, level)
    if psz < 0:
        raise RuntimeError(f"dict emission failed (code {psz})")
    return out[:psz].tobytes()


def build_candidates(block: bytes):
    """Host hash-chain candidate array for one block (int32, -1 = none)."""
    import numpy as np

    lib = _load()
    if lib is None:
        raise RuntimeError("native core not built (run `make -C csrc`)")
    cand = np.empty(len(block), dtype=np.int32)
    lib.tsq_build_candidates(block + bytes(8), len(block), cand.ctypes.data)
    return cand


def encode_block_candidates(block: bytes, cand, ext: bool,
                            level: int = 1) -> bytes:
    """Emission from a candidate array -> one block payload (the device
    encode phase B): level 1 = nearest-predecessor greedy, level >= 2 =
    lazy best-of-chain parse."""
    import numpy as np

    lib = _load()
    if lib is None:
        raise RuntimeError("native core not built (run `make -C csrc`)")
    cand = np.ascontiguousarray(cand, dtype=np.int32)
    if len(cand) != len(block):
        raise ValueError("candidate array length must equal block length")
    out = np.empty((1 << 22) + (1 << 20) + 64, dtype=np.uint8)
    if level >= 2:
        psz = lib.tsq_encode_block_lazy(
            block + bytes(80), len(block), cand.ctypes.data,
            out.ctypes.data, 1 if ext else 0, level)
    else:
        psz = lib.tsq_encode_block_candidates(
            block + bytes(80), len(block), cand.ctypes.data,
            out.ctypes.data, 1 if ext else 0)
    if psz < 0:
        raise RuntimeError(f"candidate emission failed (code {psz})")
    return out[:psz].tobytes()


def tokenize_block(payload: bytes, ext: bool, dict_len: int = 0):
    """Parse one block payload into token arrays (dst, src, len, lit) plus
    the uncompressed size. Phase A of the device decode path. With dict_len,
    positions come out in the dict-extended output space [0, dict_len+size)
    so dictionary-reaching match sources stay non-negative."""
    import numpy as np

    from ..format import FormatError

    lib = _load()
    if lib is None:
        raise RuntimeError("native core not built (run `make -C csrc`)")
    padded = payload + bytes(64)
    # worst case ~1 token / 4 output bytes, plus tail slack
    max_tokens = (1 << 20) + 64
    dst = np.empty(max_tokens, dtype=np.uint32)
    src = np.empty(max_tokens, dtype=np.uint32)
    ln = np.empty(max_tokens, dtype=np.uint16)
    lit = np.empty(max_tokens, dtype=np.uint8)
    size = ctypes.c_uint32(0)
    n = lib.tsq_tokenize_block(
        padded, len(payload), 1 if ext else 0,
        dst.ctypes.data, src.ctypes.data, ln.ctypes.data, lit.ctypes.data,
        max_tokens, ctypes.byref(size), dict_len)
    if n < 0:
        raise FormatError(f"tokenize failed (code {n})")
    return (dst[:n].astype(np.int32), src[:n].astype(np.int32),
            ln[:n].astype(np.int32), lit[:n].astype(np.int32),
            int(size.value))


# Per-block progress callback plumbing (the upstream writer thread's
# per-block fractions, tsq_threads.cpp:248-254): the C core calls back from
# worker threads with a monotone done count; ctypes re-acquires the GIL.
PROGRESS_CFUNC = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_uint64,
                                  ctypes.c_uint64)
_NULL_PROGRESS = PROGRESS_CFUNC()


def _wrap_progress(progress):
    """python callable (done, total) -> (cfunc, keepalive)."""
    if progress is None:
        return _NULL_PROGRESS, None

    def trampoline(_ctx, done, total):
        try:
            progress(int(done), int(total))
        except Exception:
            pass  # in-band contract: callbacks never raise across C

    cf = PROGRESS_CFUNC(trampoline)
    return cf, cf


def available() -> bool:
    return _load() is not None


def streaming_ok(backend: str) -> bool:
    """True when `backend` resolves to this native core (the streaming
    file pipeline / per-block progress fast paths apply). Single source of
    truth for the CLI and the JobEngine."""
    if backend not in ("auto", "native"):
        return False
    try:
        return available()
    except Exception:
        return False


def _as_ptr(arr) -> ctypes.c_char_p:
    return ctypes.cast(arr.ctypes.data, ctypes.c_char_p)


def compress(data: bytes, ext: bool = True, level: int = 0,
             n_threads: int = 0, progress=None) -> bytes:
    lib = _load()
    if lib is None:
        raise RuntimeError("native core not built (run `make -C csrc`)")
    bound = lib.tsq_compress_bound(len(data))
    # write into a bound-size bytes, then shrink in place (refcount-1 idiom:
    # `obj` must stay the only reference until the shrink)
    obj = ctypes.py_object(_py_new_bytes(None, bound))
    out_ptr = _py_bytes_ptr(obj)
    _advise_hugepages(out_ptr, bound)
    if progress is not None:
        cb, _keep = _wrap_progress(progress)
        n = lib.tsq_compress_mt_cb(data, len(data), out_ptr,
                                   bound, 1 if ext else 0, level, n_threads,
                                   cb, None)
    else:
        n = lib.tsq_compress_mt(data, len(data), out_ptr,
                                bound, 1 if ext else 0, level, n_threads)
    if n < 0:
        raise RuntimeError(f"native compress failed (code {n})")
    return _shrink_bytes(obj, n)


def compress_array(arr, ext: bool = True, level: int = 0,
                   n_threads: int = 0):
    """Compress a numpy uint8 array -> numpy uint8 array (single copy-free
    native call; output is a trimmed view of a fresh buffer)."""
    import numpy as np

    lib = _load()
    if lib is None:
        raise RuntimeError("native core not built (run `make -C csrc`)")
    bound = lib.tsq_compress_bound(arr.nbytes)
    out = np.empty(bound, dtype=np.uint8)
    n = lib.tsq_compress_mt(_as_ptr(arr), arr.nbytes, _as_ptr(out), bound,
                            1 if ext else 0, level, n_threads)
    if n < 0:
        raise RuntimeError(f"native compress failed (code {n})")
    return out[:n]


def decompress_array(stream_arr, n_threads: int = 0):
    """Decompress a numpy uint8 .tsq array -> numpy uint8 array."""
    import numpy as np

    from ..format import FormatError

    lib = _load()
    if lib is None:
        raise RuntimeError("native core not built (run `make -C csrc`)")
    size = lib.tsq_decompressed_size(_as_ptr(stream_arr), stream_arr.nbytes)
    if size < 0:
        raise FormatError(f"bad .tsq stream (code {size})")
    out = np.empty(max(size, 1), dtype=np.uint8)
    n = lib.tsq_decompress_mt(_as_ptr(stream_arr), stream_arr.nbytes,
                              _as_ptr(out), size, n_threads)
    if n < 0:
        raise FormatError(f"native decompress failed (code {n})")
    return out[:n]


def compress_file(in_path: str, out_path: str, ext: bool = True,
                  level: int = 0, n_threads: int = 0, progress=None) -> int:
    lib = _load()
    if lib is None:
        raise RuntimeError("native core not built (run `make -C csrc`)")
    cb, _keep = _wrap_progress(progress)
    n = lib.tsq_compress_file_cb(in_path.encode(), out_path.encode(),
                                 1 if ext else 0, level, n_threads, cb, None)
    if n < 0:
        raise RuntimeError(f"native file compress failed (code {n})")
    return n


def decompress_file(in_path: str, out_path: str, n_threads: int = 0,
                    progress=None) -> int:
    from ..format import FormatError

    lib = _load()
    if lib is None:
        raise RuntimeError("native core not built (run `make -C csrc`)")
    cb, _keep = _wrap_progress(progress)
    n = lib.tsq_decompress_file_cb(in_path.encode(), out_path.encode(),
                                   n_threads, cb, None)
    if n < 0:
        raise FormatError(f"native file decompress failed (code {n})")
    return n


def decompress(stream: bytes, n_threads: int = 0, progress=None) -> bytes:
    from ..format import FormatError

    lib = _load()
    if lib is None:
        raise RuntimeError("native core not built (run `make -C csrc`)")
    size = lib.tsq_decompressed_size(stream, len(stream))
    if size < 0:
        raise FormatError(f"bad .tsq stream (code {size})")
    out, ptr = _alloc_exact_bytes(size)
    if progress is not None:
        cb, _keep = _wrap_progress(progress)
        n = lib.tsq_decompress_mt_cb(stream, len(stream), ptr, size,
                                     n_threads, cb, None)
    else:
        n = lib.tsq_decompress_mt(stream, len(stream), ptr, size, n_threads)
    if n < 0:
        raise FormatError(f"native decompress failed (code {n})")
    if n != size:  # decompress_mt returns total or an error code
        raise FormatError(f"native decompress short ({n} != {size})")
    return out
