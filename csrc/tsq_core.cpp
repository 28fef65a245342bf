// Block codec implementation. Format spec: turbosqueeze_tpu/format.py and
// reference_codec.py (upstream behavior documented at tsq_encode.cpp:48-342,
// tsq_decode.cpp:42-315 — re-derived here, not copied).
#include "tsq_core.h"

#include <cstring>

namespace tsq {
namespace {

inline uint32_t load32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;  // little-endian hosts only (x86/ARM)
}

inline uint64_t load64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

inline uint32_t hash4(uint32_t v) { return (v ^ (v >> 12)) & kHashMask; }

inline int tz_bytes(uint64_t x) {
  return x ? __builtin_ctzll(x) >> 3 : 8;
}

// Match length k (4..64) -> 4-bit size code. k in [4,16] -> k-1;
// [17,31] -> 15 (copy 16); [32,47] -> 0 (32); [48,63] -> 1 (48); 64 -> 2.
inline uint32_t len_code(uint32_t k) {
  static constexpr uint8_t kCodes[65] = {
      0, 0, 0, 0, 3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15,
      15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
      0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,
      1, 1, 1, 1, 1,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1,  2};
  return kCodes[k];
}

// Decoded/consumed width of a match size code.
inline uint32_t code_width(uint32_t c) { return c < 3 ? (c + 2) << 4 : c + 1; }

// Bitstream writer: owns the interleaved ctrl/size slot bookkeeping.
// Control bits fill MSB-first, one per symbol; size nibbles pack two per
// byte (first of the pair in the high nibble). Fresh ctrl slot every 8
// symbols, fresh size slot every 2; slots are reserved in-stream at the
// write cursor, ctrl slot first. The `anchor` snapshots the input cursor
// after every even symbol — match offsets are relative to it.
struct TokenSink {
  uint8_t* __restrict out;
  uint32_t j;
  uint32_t ctrl_at;
  uint32_t size_at;
  uint32_t n_sym = 0;
  uint32_t anchor = 0;
  // Register accumulators: ctrl bits / size nibbles are shifted in here and
  // stored to their reserved slots only when a group completes (or at
  // finish) — 8 bits / 2 nibbles always shift through, so final bytes never
  // depend on prior slot contents.
  uint32_t ctrl_acc = 0;
  uint32_t size_acc = 0;
  // Exclusive end of bytes actually stored so far. Reserved ctrl/size slots
  // below this mark keep the bytes a literal over-copy deposited (part of
  // the byte-exact contract); slots at/above it start from zero. This makes
  // output independent of prior buffer contents without a full memset.
  uint32_t hwm;

  // `anchor0` seats the anchor in the input coordinate system: 0 for plain
  // blocks, dict_len when the block is parsed with dictionary context (the
  // decoder's rep_last_j stays block-relative; offsets are computed against
  // anchor in the same coordinates as match positions).
  explicit TokenSink(uint8_t* o, uint32_t block_size, uint32_t anchor0 = 0)
      : out(o), anchor(anchor0) {
    out[0] = block_size & 0xFF;
    out[1] = (block_size >> 8) & 0xFF;
    out[2] = (block_size >> 16) & 0xFF;
    j = 3;
    hwm = 3;
    ctrl_at = reserve();
    size_at = reserve();
  }

  inline uint32_t reserve() {
    if (j >= hwm) out[j] = 0;
    return j++;
  }

  inline void account(uint32_t ctrl_bit, uint32_t nibble, uint32_t cursor) {
    ++n_sym;
    ctrl_acc = (ctrl_acc << 1) | ctrl_bit;
    if ((n_sym & 7) == 0) {
      out[ctrl_at] = (uint8_t)ctrl_acc;
      ctrl_at = reserve();
    }
    size_acc = (size_acc << 4) | nibble;
    if ((n_sym & 1) == 0) {
      out[size_at] = (uint8_t)size_acc;
      size_at = reserve();
      anchor = cursor;
    }
  }

  // Flush [from, upto) as literal runs of <=16 bytes. Always stores a full
  // 16-byte chunk (the over-copy is part of the byte-exact contract: it can
  // pre-fill reserved trailing slots with input bytes).
  inline void literals(const uint8_t* in, uint32_t from, uint32_t upto) {
    while (upto - from > 0) {
      uint32_t run = upto - from > 16 ? 16 : upto - from;
      std::memcpy(&out[j], &in[from], 16);
      if (j + 16 > hwm) hwm = j + 16;
      from += run;
      j += run;
      account(1, run - 1, from);
    }
  }

  inline void match(uint32_t offset, uint32_t code, uint32_t new_cursor) {
    out[j] = (uint8_t)(offset & 0xFF);
    out[j + 1] = (uint8_t)(offset >> 8);
    if (j + 2 > hwm) hwm = j + 2;
    j += 2;
    account(0, code, new_cursor);
  }

  // Pad the final control byte with literal bits; a half-filled size byte
  // pads its low nibble with zero. The upstream tail loop
  // (tsq_encode.cpp:330-339) shifts the MOST RECENT size slot left one
  // nibble at its first odd-n_sym iteration even when that slot is a
  // freshly reserved EMPTY one (n_sym even): the slot's reserve-time
  // residue (a literal over-copy deposit, or 0 above the high-water
  // mark) survives shifted. Only n_sym % 8 == 0 streams skip the loop
  // and leave dead slots exactly as reserve() left them.
  inline uint32_t finish() {
    if ((n_sym & 7) != 0) {
      if ((n_sym & 1) != 0)
        out[size_at] = (uint8_t)(size_acc << 4);
      else
        out[size_at] = (uint8_t)(out[size_at] << 4);
      while ((n_sym & 7) != 0) {
        ctrl_acc = (ctrl_acc << 1) | 1;
        ++n_sym;
      }
      out[ctrl_at] = (uint8_t)ctrl_acc;
    }
    return j;
  }
};

// Hash probe: map the stored 16-bit position into the 64 KiB window ending
// at i, then record i. Returns the candidate position (always < i).
inline uint32_t probe(uint16_t* table, uint32_t h, uint32_t i) {
  uint32_t p16 = table[h];
  uint32_t hi = i & 0xFFFF0000u;
  uint32_t pos = p16 >= (i & 0xFFFFu) ? p16 + hi - 65536 : p16 + hi;
  table[h] = (uint16_t)i;
  return pos;
}

template <bool kExt>
uint32_t encode_impl(uint16_t* table, const uint8_t* in, uint32_t size,
                     uint8_t* out) {
  TokenSink sink(out, size);
  uint32_t i = 0;

  for (;;) {
    uint32_t run_start = i;
    uint32_t current, pos, offset;

    // Scan: probe every position until a verified 4-byte match with a
    // representable offset. Literal runs flush every 32 scanned bytes.
    for (;;) {
      ++i;
      current = load32(&in[i]);
      pos = probe(table, hash4(current), i);
      offset = sink.anchor - pos;
      if (i - run_start > 31) {
        sink.literals(in, run_start, i);
        run_start = i;
      }
      if (!(i < size &&
            !(current == load32(&in[pos]) && offset - 4 < 0xFFFB)))
        break;
    }
    sink.literals(in, run_start, i);
    if (!(i < size)) break;

    // Match emission, with immediate re-probe chaining.
    for (;;) {
      uint32_t k = (uint32_t)tz_bytes(load64(&in[i]) ^ load64(&in[pos]));
      if (k == 8) {
        if constexpr (kExt) {
          uint32_t nb, m = 1;
          do {
            nb = (uint32_t)tz_bytes(load64(&in[i + 8 * m]) ^
                                    load64(&in[pos + 8 * m]));
            k += nb;
            ++m;
          } while (nb == 8 && k < 64);
        } else {
          k += (uint32_t)tz_bytes(load64(&in[i + 8]) ^ load64(&in[pos + 8]));
        }
      }

      // The decoder copies in wide chunks; the source must end strictly
      // before the pair anchor so every copied byte is already final.
      uint32_t window = sink.anchor - pos;
      if (k > window) k = window - 1;
      if (k < 4) break;
      offset = sink.anchor - pos;  // anchor may have moved since the probe
      if (!(offset - 4 < 0xFFFB)) break;

      uint32_t code = len_code(k);
      i += code_width(code);
      sink.match(offset, code, i);

      current = load32(&in[i]);
      pos = probe(table, hash4(current), i);
      offset = sink.anchor - pos;
      if (!((i < size - 5) && current == load32(&in[pos]) &&
            offset - 4 < 0xFFFB))
        break;
    }
    if (!(i < size)) break;
  }

  return sink.finish();
}

}  // namespace

uint32_t encode_block(EncoderState& st, const uint8_t* in, uint32_t in_size,
                      uint8_t* out, bool ext) {
  st.reset();
  return ext ? encode_impl<true>(st.table.data(), in, in_size, out)
             : encode_impl<false>(st.table.data(), in, in_size, out);
}

void build_candidates(const uint8_t* in, uint32_t in_size, int32_t* cand) {
  // Hash-chain pass: head[h] = most recent position with hash h, link[i] =
  // previous same-hash position. Exact (no 16-bit aliasing), includes every
  // position (the reference's table skips match interiors) — the host twin
  // of kernels/encode_xla.find_candidates.
  std::vector<int32_t> head(kHashEntries, -1);
  for (uint32_t i = 0; i < in_size; ++i) {
    uint32_t v = load32(&in[i]);
    uint32_t h = hash4(v);
    int32_t p = head[h];
    // verify the 4 bytes (collision pruning, mirroring the device kernel)
    cand[i] = (p >= 0 && load32(&in[p]) == v) ? p : -1;
    head[h] = (int32_t)i;
  }
}

namespace {

// Walk the candidate chain to the nearest predecessor usable against the
// current anchor: offset = anchor - pos must be in [4, 65534].
inline uint32_t usable_candidate(const int32_t* cand, uint32_t i,
                                 uint32_t anchor) {
  int32_t p = cand[i];
  while (p >= 0 && (uint32_t)p + 4 > anchor) p = cand[p];
  if (p < 0 || anchor - (uint32_t)p > 65534) return UINT32_MAX;
  return (uint32_t)p;
}

// Greedy emission over [base, base+size) of a (possibly dict-prefixed)
// buffer; `base` = dictionary length (0 for plain blocks). All cursors and
// candidate positions are in buffer coordinates; the anchor starts at
// `base`, which keeps offsets identical to the decoder's block-relative
// rep_last_j arithmetic.
template <bool kExt>
uint32_t encode_candidates_impl(const uint8_t* in, uint32_t base,
                                uint32_t size, const int32_t* cand,
                                uint8_t* out) {
  TokenSink sink(out, size, base);
  const uint32_t end = base + size;
  uint32_t i = base;

  for (;;) {
    uint32_t run_start = i;
    uint32_t pos;

    for (;;) {
      ++i;
      pos = i < end ? usable_candidate(cand, i, sink.anchor) : UINT32_MAX;
      if (i - run_start > 31) {
        sink.literals(in, run_start, i);
        run_start = i;
        // the anchor may have advanced past pos; re-validate
        if (pos != UINT32_MAX)
          pos = usable_candidate(cand, i, sink.anchor);
      }
      if (!(i < end) || pos != UINT32_MAX) break;
    }
    sink.literals(in, run_start, i);
    if (!(i < end)) break;
    // The trailing flush can advance the anchor past the candidate's
    // 16-bit offset reach; an unvalidated emit would wrap the offset mod
    // 2^16 and corrupt the stream (the upstream re-checks here too,
    // tsq_encode.cpp:298 "rep_last_i might have changed"). Re-walk the
    // chain under the new anchor; rescan when nothing usable remains.
    if (sink.anchor - pos > 65534) {
      pos = usable_candidate(cand, i, sink.anchor);
      if (pos == UINT32_MAX) continue;
    }

    for (;;) {
      uint32_t k = (uint32_t)tz_bytes(load64(&in[i]) ^ load64(&in[pos]));
      if (k == 8) {
        if constexpr (kExt) {
          uint32_t nb, m = 1;
          do {
            nb = (uint32_t)tz_bytes(load64(&in[i + 8 * m]) ^
                                    load64(&in[pos + 8 * m]));
            k += nb;
            ++m;
          } while (nb == 8 && k < 64);
        } else {
          k += (uint32_t)tz_bytes(load64(&in[i + 8]) ^ load64(&in[pos + 8]));
        }
      }
      uint32_t window = sink.anchor - pos;
      if (k > window) k = window - 1;
      if (k < 4) break;

      uint32_t offset = sink.anchor - pos;
      uint32_t code = len_code(k);
      i += code_width(code);
      sink.match(offset, code, i);

      if (!(i < end - 5)) break;
      pos = usable_candidate(cand, i, sink.anchor);
      if (pos == UINT32_MAX) break;
    }
    if (!(i < end)) break;
  }

  return sink.finish();
}

// Common-prefix length of in[i..] and in[pos..], capped by the format's
// anchor window (match source must end strictly before the pair anchor;
// offsets must fit 4..65534). Returns 0 when unusable.
template <bool kExt>
inline uint32_t extend_match(const uint8_t* in, uint32_t i, uint32_t pos,
                             uint32_t anchor) {
  uint32_t offset = anchor - pos;
  if (!(offset - 4 < 0xFFFB)) return 0;
  uint32_t k = (uint32_t)tz_bytes(load64(&in[i]) ^ load64(&in[pos]));
  if (k == 8) {
    if constexpr (kExt) {
      uint32_t nb, m = 1;
      do {
        nb = (uint32_t)tz_bytes(load64(&in[i + 8 * m]) ^
                                load64(&in[pos + 8 * m]));
        k += nb;
        ++m;
      } while (nb == 8 && k < 64);
    } else {
      k += (uint32_t)tz_bytes(load64(&in[i + 8]) ^ load64(&in[pos + 8]));
    }
  }
  uint32_t window = anchor - pos;
  if (k > window) k = window - 1;
  return k;
}

// Best usable match in the candidate chain at position i: the NEAREST
// same-window predecessor maximizes the raw byte extension but minimizes
// the anchor-window length cap (k <= anchor - p - 1), so the longest
// EMITTABLE match is often a farther chain entry. Walks a bounded number
// of steps scoring each usable candidate. Returns the best capped length
// (0 if none) and writes the position.
template <bool kExt>
inline uint32_t best_in_chain(const uint8_t* in, const int32_t* cand,
                              uint32_t i, uint32_t anchor,
                              uint32_t* best_pos, int max_steps = 16) {
  int32_t p = cand[i];
  while (p >= 0 && (uint32_t)p + 4 > anchor) p = cand[p];  // skip unusable
  uint32_t best_k = 0;
  for (int steps = 0; p >= 0 && steps < max_steps; ++steps, p = cand[p]) {
    if (anchor - (uint32_t)p > 65534) break;  // chain only gets farther
    uint32_t k = extend_match<kExt>(in, i, (uint32_t)p, anchor);
    if (k > best_k) {
      best_k = k;
      *best_pos = (uint32_t)p;
      if (k >= (kExt ? 64u : 16u)) break;  // format max — can't do better
    }
  }
  return best_k;
}

// Post-flush anchor prediction: what TokenSink::anchor will be after
// literals(from, upto) runs — simulates the same 16-byte split and the
// even-symbol anchor updates without emitting anything. Lets the lazy
// parse walk each candidate chain ONCE under the exact anchor instead
// of an optimistic prefilter walk plus a post-flush re-walk (the
// round-4 structure cost two full chain walks per emitted match —
// measured 33 MB/s; the single-walk form measures ~2x that).
inline uint32_t predict_anchor(uint32_t n_sym, uint32_t anchor,
                               uint32_t from, uint32_t upto) {
  while (upto - from > 0) {
    uint32_t run = upto - from > 16 ? 16 : upto - from;
    from += run;
    if ((++n_sym & 1) == 0) anchor = from;
  }
  return anchor;
}

// Lazy one-step-deferred parse over best-of-chain matches (compression
// level >= 2, a live knob where the upstream's `level` is plumbed but dead
// — SURVEY.md §5): before emitting a match at i, peek i+1; when the next
// position holds a sufficiently longer match, emit one literal instead and
// take the longer match. Same bitstream format, smaller output than the
// greedy candidate parse.
// `max_steps` is the chain-walk effort dial mapped from the compression
// level (2 -> 16, 3 -> 8, >= 4 -> 4): the r5 sweep on 32 MiB level-0
// text measured 42/62/89 MB/s at ratios 34.17/36.56/38.87% — all the
// same format, all decodable by the upstream binary.
template <bool kExt>
uint32_t encode_lazy_impl(const uint8_t* in, uint32_t base, uint32_t size,
                          const int32_t* cand, uint8_t* out,
                          int max_steps = 16) {
  TokenSink sink(out, size, base);
  const uint32_t end = base + size;
  uint32_t i = base;
  uint32_t run_start = base;
  bool deferred = false;

  while (i < end) {
    // Flush literal runs every 32 scanned bytes: offsets are relative to
    // the pair anchor, which only advances with emitted symbols — without
    // the flush the window never covers recent history (the same rule the
    // greedy parse and the reference follow, tsq_encode.cpp:232).
    if (i - run_start > 31) {
      sink.literals(in, run_start, i);
      run_start = i;
    }
    // ONE walk under the EXACT post-flush anchor (predicted — nothing is
    // emitted yet): the result both filters and emits, and a reject skips
    // WITHOUT flushing, so literal runs stay coalesced (the round-4
    // optimistic prefilter flushed first and fragmented runs whenever the
    // exact walk then failed).
    const uint32_t anchor_p =
        predict_anchor(sink.n_sym, sink.anchor, run_start, i);
    uint32_t pos = 0;
    uint32_t k = best_in_chain<kExt>(in, cand, i, anchor_p, &pos,
                                     max_steps);
    if (k < 4) {
      ++i;
      continue;
    }
    sink.literals(in, run_start, i);
    run_start = i;
    // sink.anchor now equals anchor_p (same split simulated), so (k, pos)
    // is exactly the walk the round-4 code re-ran here.
    // Lazy peek, one-step deferral only (cascading defers convert whole
    // repeat regions into literals). Peek only SHORT matches: deferring
    // k >= 12 measured both slower (extra walk per match) and very
    // slightly larger output than emitting greedily (r5 sweep:
    // threshold 32 -> 42 MB/s at 34.168%, threshold 12 -> 56 MB/s at
    // 34.159% on 32 MiB text).
    if (k < 12 && !deferred && i + 1 < end - 5) {
      uint32_t pos2;
      if (best_in_chain<kExt>(in, cand, i + 1, sink.anchor, &pos2,
                              max_steps) > k + 1) {
        ++i;  // defer: the next position matches longer
        deferred = true;
        continue;
      }
    }
    deferred = false;
    uint32_t code = len_code(k);
    uint32_t offset = sink.anchor - pos;
    i += code_width(code);
    sink.match(offset, code, i);
    run_start = i;
  }
  if (run_start < end) sink.literals(in, run_start, end);
  return sink.finish();
}

}  // namespace

uint32_t encode_block_candidates(const uint8_t* in, uint32_t in_size,
                                 const int32_t* cand, uint8_t* out,
                                 bool ext) {
  return ext ? encode_candidates_impl<true>(in, 0, in_size, cand, out)
             : encode_candidates_impl<false>(in, 0, in_size, cand, out);
}

static inline int lazy_steps(uint32_t level) {
  return level >= 4 ? 4 : level == 3 ? 8 : 16;
}

uint32_t encode_block_lazy(const uint8_t* in, uint32_t in_size,
                           const int32_t* cand, uint8_t* out, bool ext,
                           uint32_t level) {
  const int steps = lazy_steps(level);
  return ext ? encode_lazy_impl<true>(in, 0, in_size, cand, out, steps)
             : encode_lazy_impl<false>(in, 0, in_size, cand, out, steps);
}

uint32_t encode_block_dict(const uint8_t* concat, uint32_t dict_len,
                           uint32_t in_size, const int32_t* cand,
                           uint8_t* out, bool ext, uint32_t level) {
  if (level >= 2) {
    const int steps = lazy_steps(level);
    return ext ? encode_lazy_impl<true>(concat, dict_len, in_size, cand,
                                        out, steps)
               : encode_lazy_impl<false>(concat, dict_len, in_size, cand,
                                         out, steps);
  }
  return ext
             ? encode_candidates_impl<true>(concat, dict_len, in_size, cand,
                                            out)
             : encode_candidates_impl<false>(concat, dict_len, in_size, cand,
                                             out);
}

namespace {

// `base` bytes of already-valid context (the preset dictionary) sit at
// out[0, base); decoding appends at out[base, base+size). Match reads at
// positions below `base` hit the dictionary, exactly the guard-region
// mechanism the upstream decoder reserves (turbosqueeze.cpp:128-136).
//
// Structure: an UNCHECKED fast loop decodes whole control groups with wide
// over-copies while the write frontier is > 640 bytes from the block end
// (a full group advances <= 512 bytes and its widest copy extends <= 64
// more, so fast-loop writes provably stay inside [0, base+size) — the
// decoder never scribbles past the block, which lets the MT scheduler
// decode blocks DIRECTLY into the shared output with no per-block staging
// copy). An exact-width validated loop finishes the tail.
int64_t decode_impl(const uint8_t* in, size_t in_size, uint8_t* out,
                    size_t out_capacity, bool ext, uint32_t base) {
  if (in_size < 5) return kErrBadPayload;
  uint32_t size = in[0] | (in[1] << 8) | ((uint32_t)in[2] << 16);
  if (size > kBlockSize) return kErrBlockTooBig;
  if (out_capacity < base + size) return kErrOutputTooSmall;

  size_t i = 3;
  uint32_t j = base;
  const uint32_t end = base + size;

  // Fast loop: no per-symbol bounds checks. Group input consumption is
  // <= 1 + 4*(1 + 2*16) = 133 bytes, prechecked per group; writes stay
  // below `end` by the 640-byte margin above.
  if (size > 1024) {
    const uint32_t fast_end = end - 640;
    while (j < fast_end && i + 133 <= in_size) {
      uint32_t ctrl = in[i++];
      for (int pair = 0; pair < 4; ++pair) {
        uint32_t size_byte = in[i++];
        const uint32_t pair_anchor = j;
        for (int half = 0; half < 2; ++half) {
          uint32_t nibble = half == 0 ? size_byte >> 4 : size_byte & 15;
          bool literal = (ctrl >> (7 - pair * 2 - half)) & 1;
          if (literal) {
            uint32_t sz = nibble + 1;
            std::memcpy(&out[j], &in[i], 16);
            j += sz;
            i += sz;
          } else {
            uint32_t off = in[i] | (in[i + 1] << 8);
            i += 2;
            if (off > pair_anchor) return kErrBadPayload;
            uint32_t src = pair_anchor - off;
            uint32_t sz = ext && nibble < 3 ? 32 + 16 * nibble : nibble + 1;
            // Wide copy: the encoder caps match sources strictly before
            // the pair anchor, so every copied byte is already final and
            // the 16..64-byte chunks are safe and branch-free. Over-copied
            // bytes land at >= j+sz and are overwritten by later symbols.
            std::memcpy(&out[j], &out[src], 16);
            if (sz > 16) {
              std::memcpy(&out[j + 16], &out[src + 16], 16);
              std::memcpy(&out[j + 32], &out[src + 32], 32);
            }
            j += sz;
          }
        }
      }
    }
  }

  // Exact tail: validated, exact-width copies — never writes past `end`.
  while (j < end) {
    if (i >= in_size) return kErrTruncated;
    uint32_t ctrl = in[i++];
    for (int pair = 0; pair < 4; ++pair) {
      uint32_t size_byte = in[i++];
      const uint32_t pair_anchor = j;
      for (int half = 0; half < 2; ++half) {
        uint32_t nibble = half == 0 ? size_byte >> 4 : size_byte & 15;
        bool literal = (ctrl >> (7 - pair * 2 - half)) & 1;
        uint32_t sz;
        if (literal) {
          sz = nibble + 1;
          if (j + sz > end) sz = end - j;  // corrupt-stream clamp
          std::memcpy(&out[j], &in[i], sz);
          j += sz;
          i += nibble + 1;
          if (i > in_size + 48) return kErrTruncated;
        } else {
          uint32_t off = in[i] | (in[i + 1] << 8);
          i += 2;
          if (off > pair_anchor) return kErrBadPayload;
          uint32_t src = pair_anchor - off;
          sz = ext && nibble < 3 ? 32 + 16 * nibble : nibble + 1;
          if (j + sz > end) sz = end - j;  // corrupt-stream clamp
          std::memmove(&out[j], &out[src], sz);
          j += sz;
        }
      }
      if (j >= end) break;
    }
  }
  return size;
}

}  // namespace

int64_t decode_block(const uint8_t* in, size_t in_size, uint8_t* out,
                     size_t out_capacity, bool ext) {
  return decode_impl(in, in_size, out, out_capacity, ext, 0);
}

int64_t decode_block_dict(const uint8_t* in, size_t in_size,
                          const uint8_t* dict, uint32_t dict_len,
                          uint8_t* out, size_t out_capacity, bool ext) {
  if (dict_len > kMaxDict) return kErrBadPayload;
  if (out_capacity < dict_len) return kErrOutputTooSmall;
  std::memcpy(out, dict, dict_len);
  return decode_impl(in, in_size, out, out_capacity, ext, dict_len);
}

size_t compress_bound(size_t in_size) {
  // Per-block slot: header + worst-case payload + 32 bytes of isolation so
  // concurrently encoding workers' 16-byte-wide literal over-copies can
  // never cross into a neighbor's staged slot (compress_mt encodes blocks
  // in place at this spacing, then compacts).
  size_t n_blocks = (in_size + kBlockSize - 1) / kBlockSize;
  if (n_blocks == 0) n_blocks = 1;
  return kContainerHeaderSize +
         n_blocks * (kBlockHeaderSize + kOutputSize + 32) + 64;
}

int64_t decompressed_size(const uint8_t* in, size_t in_size) {
  if (in_size < kContainerHeaderSize) return kErrTruncated;
  if (std::memcmp(in, "TSQ1", 4) != 0) return kErrBadMagic;
  uint64_t total;
  std::memcpy(&total, in + 8, 8);
  return (int64_t)total;
}

int64_t tokenize_block(const uint8_t* in, size_t in_size, bool ext,
                       Token* tokens, size_t max_tokens,
                       uint32_t* uncompressed_size, uint32_t base) {
  if (in_size < 5) return kErrBadPayload;
  uint32_t size = in[0] | (in[1] << 8) | ((uint32_t)in[2] << 16);
  if (size > kBlockSize) return kErrBlockTooBig;
  *uncompressed_size = size;

  // `base` = preset-dictionary length: positions are emitted in the
  // dict-extended output space [0, base + size) so match sources reaching
  // into the dictionary stay non-negative (the device decoders stage the
  // dictionary as synthetic literal tokens at [0, base)).
  size_t i = 3, n = 0;
  uint32_t j = base;
  const uint32_t size_end = base + size;
  while (j < size_end) {
    if (i >= in_size) return kErrTruncated;
    uint32_t ctrl = in[i++];
    for (int pair = 0; pair < 4 && j < size_end; ++pair) {
      if (i >= in_size) return kErrTruncated;
      uint32_t size_byte = in[i++];
      const uint32_t pair_anchor = j;
      for (int half = 0; half < 2; ++half) {
        uint32_t nibble = half == 0 ? size_byte >> 4 : size_byte & 15;
        bool literal = (ctrl >> (7 - pair * 2 - half)) & 1;
        uint32_t sz, src;
        if (literal) {
          sz = nibble + 1;
          src = (uint32_t)i;
          i += sz;
        } else {
          uint32_t off = in[i] | (in[i + 1] << 8);
          i += 2;
          if (off > pair_anchor) return kErrBadPayload;
          src = pair_anchor - off;
          sz = ext && nibble < 3 ? 32 + 16 * nibble : nibble + 1;
        }
        if (n >= max_tokens) return kErrOutputTooSmall;
        tokens[n++] = Token{j, src, (uint16_t)sz, (uint16_t)literal};
        j += sz;
      }
    }
  }
  return (int64_t)n;
}

}  // namespace tsq
