// Single-core encode head-to-head: our encode_block vs the upstream
// tsqEncode (compiled from /root/reference at build time, like the golden
// harness — nothing vendored), same blocks, same process, rdtsc + wall.
//
// Build/run:
//   g++ -O3 -march=native -std=c++17 -I.ref_build/shim -I/root/reference \
//     bench/encode_headtohead.cpp csrc/tsq_core.cpp \
//     /root/reference/tsq_encode.cpp /root/reference/tsq_context.cpp \
//     -o .ref_build/enc_h2h && .ref_build/enc_h2h corpus.bin [reps]
//
// Purpose: the host MT encode once trailed the same-box upstream by ~9%;
// this isolates the level-0 hot loop
// (tsq_encode.cpp:216-326 upstream vs csrc/tsq_core.cpp encode_impl)
// from pipeline/runtime effects.
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "tsq_core.h"
#include "turbosqueeze.h"

static double now() {
  using namespace std::chrono;
  return duration<double>(steady_clock::now().time_since_epoch()).count();
}

int main(int argc, char** argv) {
  if (argc < 2) {
    std::fprintf(stderr, "usage: %s corpus.bin [reps]\n", argv[0]);
    return 2;
  }
  FILE* f = std::fopen(argv[1], "rb");
  if (!f) return 2;
  std::fseek(f, 0, SEEK_END);
  long fsz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  // zero-padded read slack: both encoders read a few bytes past the end
  std::vector<uint8_t> data(fsz + 128, 0);
  if (std::fread(data.data(), 1, fsz, f) != (size_t)fsz) return 2;
  std::fclose(f);
  int reps = argc > 2 ? std::atoi(argv[2]) : 4;

  const uint32_t kBlock = 1u << 22;
  size_t n_blocks = (fsz + kBlock - 1) / kBlock;
  std::vector<uint8_t> out(kBlock + (kBlock >> 2) + 1024);

  // ---- ours -----------------------------------------------------------
  tsq::EncoderState st;
  double best_ours = 1e30;
  size_t sz_ours = 0;
  for (int r = 0; r < reps; ++r) {
    double t0 = now();
    sz_ours = 0;
    for (size_t b = 0; b < n_blocks; ++b) {
      uint32_t in_sz = (uint32_t)std::min<long>(kBlock, fsz - b * kBlock);
      sz_ours += tsq::encode_block(st, data.data() + b * kBlock, in_sz,
                                   out.data(), true);
    }
    double dt = now() - t0;
    if (dt < best_ours) best_ours = dt;
  }

  // ---- upstream -------------------------------------------------------
  TSQCompressionContext* ctx = tsqAllocateContext();
  double best_up = 1e30;
  size_t sz_up = 0;
  for (int r = 0; r < reps; ++r) {
    double t0 = now();
    sz_up = 0;
    for (size_t b = 0; b < n_blocks; ++b) {
      uint32_t in_sz = (uint32_t)std::min<long>(kBlock, fsz - b * kBlock);
      uint32_t osz = 0;
      tsqInit(ctx);
      tsqEncode(ctx, data.data() + b * kBlock, out.data(), &osz, in_sz, 1);
      sz_up += osz;
    }
    double dt = now() - t0;
    if (dt < best_up) best_up = dt;
  }
  tsqDeallocateContext(ctx);

  double mb = fsz / 1e6;
  std::printf("ours:     %7.1f MB/s  (%zu bytes)\n", mb / best_ours, sz_ours);
  std::printf("upstream: %7.1f MB/s  (%zu bytes)\n", mb / best_up, sz_up);
  std::printf("ratio ours/upstream: %.3f\n", best_up / best_ours);
  return 0;
}
