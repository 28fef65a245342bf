"""Edge-case blocks for the device decode and compress identity suites.

Each builder returns one block of at most 4 MiB whose shape once broke, or
exercises, a corner of the format: the size-slot and control-slot tails of
tiny blocks, maximum-length chained matches, expansion of incompressible
data, the 16-bit offset window, the level-0 tail loop's dead size slot,
long zero fills, matches that reach across the decoder's 2 MiB halves,
and mixed-class fuzz. Shared by test_edge_decode.py and
test_edge_compress.py so both check the same inputs.
"""

from __future__ import annotations

import numpy as np

from turbosqueeze_tpu.utils.corpus import synthetic_binary, synthetic_text


def mixed_case(rng, size):
    """Content with abrupt class switches at random boundaries."""
    parts = []
    n = 0
    while n < size:
        kind = rng.integers(0, 5)
        ln = int(rng.integers(500, 70_000))
        if kind == 0:
            parts.append(rng.bytes(ln))                   # incompressible
        elif kind == 1:
            parts.append(bytes(ln))                       # zeros
        elif kind == 2:
            parts.append(synthetic_text(ln, seed=int(rng.integers(1e6))))
        elif kind == 3:
            parts.append(synthetic_binary(ln, seed=int(rng.integers(1e6))))
        else:                                             # re-quote earlier
            prev = b"".join(parts)[-70_000:] or b"seed"
            parts.append((prev * 3)[:ln])
        n += ln
    return b"".join(parts)[:size]


def window_edge_case(q):
    """Candidate at the 16-bit window edge + an anchor-advancing trailing
    literal flush: a match validated just inside 65534 becomes
    unrepresentable after the flush moves the anchor, and an unvalidated
    emit wraps the offset mod 2^16."""
    P = bytes(range(65, 81))
    out = bytearray()
    c = 0
    while len(out) < q - 16:                  # all 4-byte windows unique
        out += bytes(((c >> 16) & 127 | 128, (c >> 8) & 255, c & 255))
        c += 1
    filler = bytes(out[:q - 16])
    return P + filler + P + bytes(300)


def dead_size_slot_blocks():
    """Blocks whose level-0 parse ends on a match with n_sym even and
    n_sym % 8 != 0, so the trailing EMPTY size slot gets the upstream tail
    loop's residue << 4 (tsq_encode.cpp:330-339)."""
    rng = np.random.default_rng(1)
    for _ in range(40):
        n = int(rng.integers(40, 400))
        words = [rng.integers(33, 127, int(rng.integers(3, 9)),
                              dtype=np.uint8).tobytes() for _ in range(4)]
        parts = []
        while sum(map(len, parts)) < n:
            parts.append(words[int(rng.integers(0, 4))])
        yield b"".join(parts)[:n]


def _dense_alternation():
    """1-literal/1-match alternation: the densest token stream."""
    rng = np.random.default_rng(3)
    parts = []
    for _ in range(1200):
        parts.append(rng.integers(0, 256, 3, dtype=np.uint8).tobytes())
        parts.append(b"QWERTYUI")
    return b"".join(parts)


def _two_window_tail_reach():
    """Straddles the 2 MiB midpoint with matches reaching ~64 KiB back
    across it."""
    base = synthetic_text(64 * 1024, seed=11)
    return (base * ((3 << 20) // len(base) + 1))[: (1 << 21) + 200_000]


def _anchor_before_window_edge():
    """A pair whose anchor sits just before the 2 MiB midpoint while its
    second symbol's dst lands after it."""
    rng = np.random.default_rng(23)
    return rng.bytes(1 << 21) + bytes(100_000) + rng.bytes(50_000)


def _dead_slot(k):
    return lambda: list(dead_size_slot_blocks())[k]


def _fuzz(seed):
    def build():
        rng = np.random.default_rng(seed)
        return mixed_case(rng, int(rng.integers(60_000, 140_000)))

    return build


CASES = {
    **{f"tiny_{n}": (lambda n=n: synthetic_text(2_000, seed=40)[:n])
       for n in (1, 2, 3, 5, 8, 17, 33, 64, 513, 1025)},
    "text": lambda: synthetic_text(40_000, seed=31),
    "zeros": lambda: bytes(128 * 1024),
    "random": lambda: np.random.default_rng(7).integers(
        0, 256, 16_384, dtype=np.uint8).tobytes(),
    "dense_alternation": _dense_alternation,
    **{f"window_edge_{q}": (lambda q=q: window_edge_case(q))
       for q in (65_500, 65_534, 65_544, 65_560)},
    **{f"dead_size_slot_{k}": _dead_slot(k) for k in range(6)},
    "fills_ext": lambda: (synthetic_text(3_000, seed=45) + bytes(9_000)
                          + synthetic_text(2_000, seed=46)),
    "mixed_fills": lambda: (synthetic_text(9_000, seed=51) + bytes(600)
                            + synthetic_text(5_000, seed=52)),
    "max_matches": lambda: bytes(20_000),
    "incompressible": lambda: np.random.default_rng(5).bytes(40_000),
    "far_offsets": lambda: (synthetic_text(65_300, seed=33) * 2)[:100_000],
    "two_window_tail_reach": _two_window_tail_reach,
    "anchor_before_window_edge": _anchor_before_window_edge,
    **{f"fuzz_{s}": _fuzz(s) for s in (11, 12)},
}

# dictionary identity: a block that quotes its shared dictionary
DICT_CASE = (lambda: synthetic_text(30_000, seed=34),
             lambda: synthetic_text(8_000, seed=34)[4_000:] + bytes(2_000))
