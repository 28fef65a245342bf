"""Device block codec glue: host token parse + device reconstruction.

This is the single-block device path (SURVEY.md §7 step 4: one stream
decompressed on the device). The multi-block sharded engine lives in
parallel/pipeline.py.
"""

from __future__ import annotations

import numpy as np

from .format import FormatError
from .kernels import decode_xla as DXL


def dict_prefix_tokens(payload_len: int, dict_len: int):
    """Synthetic literal tokens staging a preset dictionary on-device.

    The device decoders know nothing about dictionaries: the dictionary is
    appended AFTER the payload and these tokens copy it to output positions
    [0, dict_len) like ordinary literals; the real stream's tokens (emitted
    in dict-extended coordinates by tokenize_block(dict_len=...)) then
    reference it as decoded history.
    Returns (dst, src, ln, lit) int32 arrays.
    """
    dsts, srcs, lns = [], [], []
    off = 0
    while off < dict_len:
        ln = min(16, dict_len - off)
        dsts.append(off)
        srcs.append(payload_len + off)
        lns.append(ln)
        off += ln
    n = len(dsts)
    return (np.asarray(dsts, np.int32), np.asarray(srcs, np.int32),
            np.asarray(lns, np.int32), np.ones(n, np.int32))


def tokenize_with_dict(payload: bytes, ext: bool, dictionary: bytes | None):
    """Tokenize a payload for the device decoders, staging the dictionary.

    Returns (extended_payload, dst, src, ln, lit, size, base) where
    positions live in the dict-extended output space [0, base + size).
    """
    from .runtime import native

    base = len(dictionary) if dictionary else 0
    dst, src, ln, lit, size = native.tokenize_block(payload, ext, base)
    if not base:
        return payload, dst, src, ln, lit, size, 0
    pd, ps, pl, pq = dict_prefix_tokens(len(payload), base)
    return (payload + dictionary,
            np.concatenate([pd, np.asarray(dst, np.int32)]),
            np.concatenate([ps, np.asarray(src, np.int32)]),
            np.concatenate([pl, np.asarray(ln, np.int32)]),
            np.concatenate([pq, np.asarray(lit, np.int32)]),
            size, base)


def decode_block_device(payload: bytes, ext: bool, *,
                        dictionary: bytes | None = None) -> bytes:
    """Decode one block payload with the device decode (kernels/decode_xla).

    Phase A (token parse) runs on host via the native tokenizer; phase B
    (all byte movement) runs on the device. The output plane is bucketed
    to a power of two so blocks of nearby sizes share one compiled program.
    With ``dictionary`` the preset context is staged by synthetic literal
    tokens (guard-region decode, the device twin of csrc
    decode_block_dict).
    """
    pay2, dst, src, ln, lit, size, base = tokenize_with_dict(
        payload, ext, dictionary)
    n_out = max(4096, 1 << (base + size - 1).bit_length())
    planes = DXL.pack_token_batch([(dst, src, ln, lit)], n_out)
    out = DXL.decode_batch_xla(*planes, DXL.pack_payload_batch([pay2]),
                               n_out=n_out)
    out = np.asarray(out[0, base:base + size]).tobytes()
    if len(out) != size:
        raise FormatError("device decode size mismatch")
    return out


def decode_block_reference_tokens(payload: bytes, ext: bool) -> bytes:
    """Pure-numpy token replay (used to validate the tokenizer contract)."""
    from .runtime import native

    dst, src, ln, lit, size = native.tokenize_block(payload, ext)
    out = np.zeros(size + 80, dtype=np.uint8)
    pay = np.frombuffer(payload, dtype=np.uint8)
    pay = np.concatenate([pay, np.zeros(64, np.uint8)])
    for d, s, l, is_lit in zip(dst, src, ln, lit):
        if is_lit:
            out[d:d + l] = pay[s:s + l]
        else:
            out[d:d + l] = out[s:s + l]
    return out[:size].tobytes()
