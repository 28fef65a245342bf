// C ABI consumed by the Python layer over ctypes (runtime/native.py) and by
// the async jobs engine (runtime/jobs.py). Mirrors the upstream public
// surface (turbosqueeze.h:458-670) with a flat, FFI-friendly shape.
#include <cstdint>

#include "tsq_core.h"

extern "C" {

uint64_t tsq_compress_bound(uint64_t in_size) {
  return tsq::compress_bound(in_size);
}

int64_t tsq_decompressed_size(const uint8_t* in, uint64_t in_size) {
  return tsq::decompressed_size(in, in_size);
}

typedef void (*tsq_progress_fn)(void* ctx, uint64_t done, uint64_t total);

int64_t tsq_compress_mt_cb(const uint8_t* in, uint64_t in_size, uint8_t* out,
                           uint64_t out_capacity, int ext, uint32_t level,
                           int n_threads, tsq_progress_fn cb, void* ctx) {
  return tsq::compress_mt(in, in_size, out, out_capacity, ext != 0, level,
                          n_threads, cb, ctx);
}

int64_t tsq_decompress_mt_cb(const uint8_t* in, uint64_t in_size,
                             uint8_t* out, uint64_t out_capacity,
                             int n_threads, tsq_progress_fn cb, void* ctx) {
  return tsq::decompress_mt(in, in_size, out, out_capacity, n_threads, cb,
                            ctx);
}

int64_t tsq_compress_file_cb(const char* in_path, const char* out_path,
                             int ext, uint32_t level, int n_threads,
                             tsq_progress_fn cb, void* ctx) {
  return tsq::compress_file(in_path, out_path, ext != 0, level, n_threads,
                            cb, ctx);
}

int64_t tsq_decompress_file_cb(const char* in_path, const char* out_path,
                               int n_threads, tsq_progress_fn cb,
                               void* ctx) {
  return tsq::decompress_file(in_path, out_path, n_threads, cb, ctx);
}

int64_t tsq_compress_mt(const uint8_t* in, uint64_t in_size, uint8_t* out,
                        uint64_t out_capacity, int ext, uint32_t level,
                        int n_threads) {
  return tsq::compress_mt(in, in_size, out, out_capacity, ext != 0, level,
                          n_threads);
}

int64_t tsq_decompress_mt(const uint8_t* in, uint64_t in_size, uint8_t* out,
                          uint64_t out_capacity, int n_threads) {
  return tsq::decompress_mt(in, in_size, out, out_capacity, n_threads);
}

int64_t tsq_compress_file(const char* in_path, const char* out_path, int ext,
                          uint32_t level, int n_threads) {
  return tsq::compress_file(in_path, out_path, ext != 0, level, n_threads);
}

int64_t tsq_decompress_file(const char* in_path, const char* out_path,
                            int n_threads) {
  return tsq::decompress_file(in_path, out_path, n_threads);
}

// Single-block primitives (used by tests and by the device-feeding path).
int64_t tsq_encode_block(const uint8_t* in_padded, uint32_t in_size,
                         uint8_t* out, int ext) {
  tsq::EncoderState st;
  return tsq::encode_block(st, in_padded, in_size, out, ext != 0);
}

void tsq_build_candidates(const uint8_t* in_padded, uint32_t in_size,
                          int32_t* cand) {
  tsq::build_candidates(in_padded, in_size, cand);
}

int64_t tsq_compress_mt_dict(const uint8_t* in, uint64_t in_size,
                             const uint8_t* dict, uint32_t dict_len,
                             uint8_t* out, uint64_t out_capacity, int ext,
                             int n_threads, uint32_t level,
                             tsq_progress_fn cb, void* ctx) {
  return tsq::compress_mt_dict(in, in_size, dict, dict_len, out,
                               out_capacity, ext != 0, n_threads, level,
                               cb, ctx);
}

int64_t tsq_decompress_mt_dict(const uint8_t* in, uint64_t in_size,
                               const uint8_t* dict, uint32_t dict_len,
                               uint8_t* out, uint64_t out_capacity,
                               int n_threads, tsq_progress_fn cb,
                               void* ctx) {
  return tsq::decompress_mt_dict(in, in_size, dict, dict_len, out,
                                 out_capacity, n_threads, cb, ctx);
}

int64_t tsq_encode_block_dict(const uint8_t* concat_padded,
                              uint32_t dict_len, uint32_t in_size,
                              const int32_t* cand, uint8_t* out, int ext,
                              uint32_t level) {
  return tsq::encode_block_dict(concat_padded, dict_len, in_size, cand, out,
                                ext != 0, level);
}

int64_t tsq_decode_block_dict(const uint8_t* in_padded, uint64_t in_size,
                              const uint8_t* dict, uint32_t dict_len,
                              uint8_t* out, uint64_t out_capacity, int ext) {
  return tsq::decode_block_dict(in_padded, in_size, dict, dict_len, out,
                                out_capacity, ext != 0);
}

int64_t tsq_encode_block_candidates(const uint8_t* in_padded,
                                    uint32_t in_size, const int32_t* cand,
                                    uint8_t* out, int ext) {
  return tsq::encode_block_candidates(in_padded, in_size, cand, out,
                                      ext != 0);
}

int64_t tsq_encode_block_lazy(const uint8_t* in_padded, uint32_t in_size,
                              const int32_t* cand, uint8_t* out, int ext,
                              uint32_t level) {
  return tsq::encode_block_lazy(in_padded, in_size, cand, out, ext != 0,
                                level);
}

int64_t tsq_decode_block(const uint8_t* in_padded, uint64_t in_size,
                         uint8_t* out, uint64_t out_capacity, int ext) {
  return tsq::decode_block(in_padded, in_size, out, out_capacity, ext != 0);
}

// Token extraction for the device decode: fills parallel arrays
// (dst, src, len, literal-flag), returns token count or negative Status.
int64_t tsq_tokenize_block(const uint8_t* in_padded, uint64_t in_size,
                           int ext, uint32_t* dst, uint32_t* src,
                           uint16_t* len, uint8_t* lit, uint64_t max_tokens,
                           uint32_t* uncompressed_size, uint32_t base) {
  std::vector<tsq::Token> tokens(max_tokens);
  int64_t n = tsq::tokenize_block(in_padded, in_size, ext != 0, tokens.data(),
                                  max_tokens, uncompressed_size, base);
  if (n < 0) return n;
  for (int64_t k = 0; k < n; ++k) {
    dst[k] = tokens[k].dst;
    src[k] = tokens[k].src;
    len[k] = tokens[k].len;
    lit[k] = (uint8_t)tokens[k].literal;
  }
  return n;
}

}  // extern "C"
