// tsq_core: from-scratch native core for the turbosqueeze_tpu framework.
//
// Implements the Turbosqueeze .tsq bitstream (format spec:
// turbosqueeze_tpu/format.py and reference_codec.py) with a modern C++
// runtime: block codec, multithreaded block scheduler, container I/O, and a
// C ABI consumed by the Python layer over ctypes.
//
// This is NOT a copy of the upstream C++: the code is structured around an
// explicit TokenSink bitstream writer and a std::atomic work-stealing block
// scheduler rather than the upstream's ring-buffer thread pipeline. Output
// bytes are identical by construction (the format demands it).
#pragma once

#include <cstddef>
#include <cstdint>
#include <vector>

namespace tsq {

// Format constants (spec: turbosqueeze_tpu/format.py; upstream
// turbosqueeze.h:37-43).
constexpr uint32_t kBlockBits = 22;
constexpr uint32_t kBlockSize = 1u << kBlockBits;            // 4 MiB
constexpr uint32_t kOutputSize = kBlockSize + (kBlockSize >> 2);  // 5 MiB
constexpr uint32_t kHashBits = 17;
constexpr uint32_t kHashEntries = 1u << kHashBits;
constexpr uint32_t kHashMask = kHashEntries - 1;
constexpr uint32_t kExtFlag = 0x800000;
constexpr uint32_t kPayloadMask = 0x7FFFFF;
constexpr size_t kContainerHeaderSize = 16;
constexpr size_t kBlockHeaderSize = 3;

// Scratch state for one encoder worker: the 2^17-entry 16-bit position
// table, reset per block (blocks are pure functions of their bytes).
struct EncoderState {
  std::vector<uint16_t> table;
  EncoderState() : table(kHashEntries, 0) {}
  void reset() { std::fill(table.begin(), table.end(), 0); }
};

// --- Block codec -----------------------------------------------------------

// Buffer slack demanded by the wide load/store paths:
constexpr size_t kEncInSlack = 80;    // encode reads up to in_size+80 (zeroed)
constexpr size_t kDecInSlack = 64;    // decode reads up to payload+64
constexpr size_t kDecOutSlack = 80;   // decode writes up to size+80

// Compress one block (1..kBlockSize bytes) into `out` (capacity >=
// kOutputSize + 32; prior contents don't matter). `in` must be
// readable for in_size + kEncInSlack bytes with the tail ZEROED — the match
// probe reads ahead and zeros pin output determinism (the format spec's
// convention; see reference_codec.py).
// Returns the payload size in bytes.
uint32_t encode_block(EncoderState& st, const uint8_t* in, uint32_t in_size,
                      uint8_t* out, bool ext);

// Decompress one block payload. `in` must be readable for in_size +
// kDecInSlack bytes; `out` needs capacity for the declared uncompressed
// size + kDecOutSlack (wide copies and trailing padded symbols overshoot).
// Returns the uncompressed size, or a negative Status on malformed input.
int64_t decode_block(const uint8_t* in, size_t in_size, uint8_t* out,
                     size_t out_capacity, bool ext);

// --- Whole-container API ---------------------------------------------------

enum Status : int64_t {
  kOk = 0,
  kErrBadMagic = -1,
  kErrTruncated = -2,
  kErrBlockTooBig = -3,
  kErrOutputTooSmall = -4,
  kErrBadPayload = -5,
  kErrIo = -6,
};

// Worst-case container size for `in_size` input bytes.
size_t compress_bound(size_t in_size);

// Total uncompressed size declared by a .tsq container (validates magic).
int64_t decompressed_size(const uint8_t* in, size_t in_size);

// Per-block progress callback: invoked (from worker threads, completion
// order) with a monotonically increasing done count — the framework twin
// of the upstream writer thread's per-block fractions
// (tsq_threads.cpp:248-254).
using ProgressFn = void (*)(void* ctx, uint64_t done, uint64_t total);

// Multithreaded memory-to-memory codec. n_threads == 0 => hardware
// concurrency. Returns bytes written or negative Status.
int64_t compress_mt(const uint8_t* in, size_t in_size, uint8_t* out,
                    size_t out_capacity, bool ext, uint32_t level,
                    int n_threads, ProgressFn progress = nullptr,
                    void* progress_ctx = nullptr);
int64_t decompress_mt(const uint8_t* in, size_t in_size, uint8_t* out,
                      size_t out_capacity, int n_threads,
                      ProgressFn progress = nullptr,
                      void* progress_ctx = nullptr);

// Streaming file-to-file codec with I/O overlapped against the worker pool
// (the upstream reader/workers/writer pipeline, rebuilt on std::async).
int64_t compress_file(const char* in_path, const char* out_path, bool ext,
                      uint32_t level, int n_threads,
                      ProgressFn progress = nullptr,
                      void* progress_ctx = nullptr);
int64_t decompress_file(const char* in_path, const char* out_path,
                        int n_threads, ProgressFn progress = nullptr,
                        void* progress_ctx = nullptr);

// --- Candidate-based encoding (device match finder + host emission) ---------
//
// Device encode splits into: phase A on device (exact windowed predecessor
// search, kernels/encode_xla.py) producing cand[i] = nearest j < i with the
// same verified 4-byte window (-1 if none); phase B here: greedy emission
// with the format's rep-anchor rules, walking the candidate chain when the
// nearest predecessor is too close to the anchor. Compression level >= 1 on
// the host path computes the same candidates with a hash-chain pass.

// Build exact nearest-predecessor candidates on host. cand must hold
// in_size int32s; scratch semantics match find_candidates on device.
void build_candidates(const uint8_t* in, uint32_t in_size, int32_t* cand);

// Encode one block from a candidate array. Same buffer contracts as
// encode_block. Returns payload size.
uint32_t encode_block_candidates(const uint8_t* in, uint32_t in_size,
                                 const int32_t* cand, uint8_t* out, bool ext);

// Lazy one-step-deferred candidate parse (compression level >= 2): peeks
// the next position before committing a match. Same format, better ratio.
// `level` is the chain-walk effort dial: 2 = full 16-step walks (best
// ratio), 3 = 8 steps, >= 4 = 4 steps (faster, a bit larger).
uint32_t encode_block_lazy(const uint8_t* in, uint32_t in_size,
                           const int32_t* cand, uint8_t* out, bool ext,
                           uint32_t level = 2);

// --- Preset dictionary (framework extension) ---------------------------------
//
// The upstream decoder reserves a 64 KiB guard region before each block and
// notes it "could be used to store a pre-determined dictionary"
// (turbosqueeze.cpp:128-135) but never implements it. Here it is: up to
// 64 KiB of shared context virtually preceding every block. Match offsets
// may then reach back into the dictionary (position < 0 relative to the
// block). The on-disk format is unchanged; both ends must supply the same
// dictionary (zstd-style out-of-band contract), so dict-compressed streams
// are NOT decodable by the upstream binary.
constexpr uint32_t kMaxDict = 65536 - 4;

// Encode with dictionary context. `concat` holds dict_len dictionary bytes
// followed by in_size block bytes (padded +kEncInSlack zeros); `cand` was
// built over the whole concat buffer (build_candidates). level <= 1 uses
// the greedy candidate parse, level >= 2 the lazy best-of-chain parse
// (same knob as the non-dict emission). Returns payload size.
uint32_t encode_block_dict(const uint8_t* concat, uint32_t dict_len,
                           uint32_t in_size, const int32_t* cand,
                           uint8_t* out, bool ext, uint32_t level = 1);

// Decode with dictionary context. `out` needs capacity for
// dict_len + declared size + kDecOutSlack; on success the decoded block
// starts at out + dict_len (the dictionary is staged before it).
int64_t decode_block_dict(const uint8_t* in, size_t in_size,
                          const uint8_t* dict, uint32_t dict_len,
                          uint8_t* out, size_t out_capacity, bool ext);

// Whole-container dict variants (memory to memory).
int64_t compress_mt_dict(const uint8_t* in, size_t in_size,
                         const uint8_t* dict, uint32_t dict_len,
                         uint8_t* out, size_t out_capacity, bool ext,
                         int n_threads, uint32_t level = 1,
                         ProgressFn progress = nullptr,
                         void* progress_ctx = nullptr);
int64_t decompress_mt_dict(const uint8_t* in, size_t in_size,
                           const uint8_t* dict, uint32_t dict_len,
                           uint8_t* out, size_t out_capacity,
                           int n_threads, ProgressFn progress = nullptr,
                           void* progress_ctx = nullptr);

// --- Token extraction (device feeding) --------------------------------------
//
// Parses one block payload into fixed-width token arrays for the device
// decode (kernels/decode_xla.py): per symbol {dst, src, len, is_literal} where
// literal src indexes the payload and match src indexes the output.
struct Token {
  uint32_t dst;
  uint32_t src;
  uint16_t len;
  uint16_t literal;
};
// `base` = preset-dictionary length: tokens come out in the dict-extended
// output space [0, base + size) so dictionary-reaching match sources stay
// non-negative (0 for plain streams).
int64_t tokenize_block(const uint8_t* in, size_t in_size, bool ext,
                       Token* tokens, size_t max_tokens,
                       uint32_t* uncompressed_size, uint32_t base = 0);

}  // namespace tsq
