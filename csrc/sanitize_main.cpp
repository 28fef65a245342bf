// Sanitizer stress driver for the MT runtime (`make tsan` / `make asan`).
//
// The upstream's thread safety rests on `volatile` cursors that TSan (and
// the C++ memory model) reject (turbosqueeze.h:142-182, SURVEY.md §5); this
// repo's scheduler uses proper atomics and disjoint in-place writes
// (tsq_runtime.cpp) — claims a sanitizer should CHECK, not assert. This
// driver drives every concurrent path with enough iterations for TSan's
// happens-before tracker to see the handoffs:
//   * compress_mt / decompress_mt memory codec (work-stealing atomic
//     cursor pool; decode writes disjoint regions of one shared output)
//   * the streaming windowed file codec (I/O overlapped with workers)
//   * dictionary MT codec (shared read-only dict across workers)
// Exit code 0 = all roundtrips byte-exact and no sanitizer report (the
// sanitizers abort the process on findings).
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include "tsq_core.h"

namespace {

// xorshift-based compressible test data: repeated phrases + noise
std::vector<uint8_t> make_data(size_t n, uint64_t seed) {
  std::vector<uint8_t> v(n);
  uint64_t s = seed * 0x9E3779B97F4A7C15ull + 1;
  const char* words[] = {"the quick brown fox ", "lorem ipsum dolor ",
                         "0123456789abcdef", "turbosqueeze native core "};
  size_t i = 0;
  while (i < n) {
    s ^= s << 13;
    s ^= s >> 7;
    s ^= s << 17;
    const char* w = words[s & 3];
    size_t len = std::strlen(w);
    if ((s >> 8 & 15) == 0) {  // sprinkle incompressible bytes
      for (size_t k = 0; k < 8 && i < n; ++k, ++i) v[i] = (s >> (8 * k));
    }
    for (size_t k = 0; k < len && i < n; ++k, ++i) v[i] = w[k];
  }
  return v;
}

bool roundtrip_mem(const std::vector<uint8_t>& data, bool ext,
                   uint32_t level, int threads) {
  std::vector<uint8_t> comp(tsq::compress_bound(data.size()));
  int64_t csz = tsq::compress_mt(data.data(), data.size(), comp.data(),
                                 comp.size(), ext, level, threads);
  if (csz <= 0) return false;
  std::vector<uint8_t> out(data.size() + 64);
  int64_t dsz = tsq::decompress_mt(comp.data(), csz, out.data(), data.size(),
                                   threads);
  if (dsz != (int64_t)data.size()) return false;
  return std::memcmp(out.data(), data.data(), data.size()) == 0;
}

bool roundtrip_file(const std::vector<uint8_t>& data, int threads) {
  std::string in = "/tmp/tsq_sanitize_in.bin";
  std::string tsq = "/tmp/tsq_sanitize.tsq";
  std::string out = "/tmp/tsq_sanitize_out.bin";
  FILE* f = std::fopen(in.c_str(), "wb");
  if (!f) return false;
  std::fwrite(data.data(), 1, data.size(), f);
  std::fclose(f);
  if (tsq::compress_file(in.c_str(), tsq.c_str(), true, 1, threads) <= 0)
    return false;
  if (tsq::decompress_file(tsq.c_str(), out.c_str(), threads) !=
      (int64_t)data.size())
    return false;
  f = std::fopen(out.c_str(), "rb");
  if (!f) return false;
  std::vector<uint8_t> back(data.size());
  size_t rd = std::fread(back.data(), 1, back.size(), f);
  std::fclose(f);
  return rd == data.size() &&
         std::memcmp(back.data(), data.data(), data.size()) == 0;
}

bool roundtrip_dict(const std::vector<uint8_t>& data, int threads) {
  std::vector<uint8_t> dict = make_data(40000, 77);
  std::vector<uint8_t> comp(tsq::compress_bound(data.size()));
  int64_t csz =
      tsq::compress_mt_dict(data.data(), data.size(), dict.data(),
                            dict.size(), comp.data(), comp.size(), true,
                            threads, 2);
  if (csz <= 0) return false;
  std::vector<uint8_t> out(data.size() + 64);
  int64_t dsz = tsq::decompress_mt_dict(comp.data(), csz, dict.data(),
                                        dict.size(), out.data(), data.size(),
                                        threads);
  return dsz == (int64_t)data.size() &&
         std::memcmp(out.data(), data.data(), data.size()) == 0;
}

}  // namespace

int main() {
  // multi-block (3 x 4 MiB + tail) so the pool actually contends; 4
  // threads oversubscribe small CI boxes on purpose (more interleavings)
  std::vector<uint8_t> big = make_data((3u << 22) + 12345, 42);
  int fails = 0;
  for (int iter = 0; iter < 3; ++iter) {
    for (int threads : {2, 4}) {
      if (!roundtrip_mem(big, true, 0, threads)) ++fails;
      if (!roundtrip_mem(big, false, 1, threads)) ++fails;
      if (!roundtrip_mem(big, true, 2, threads)) ++fails;
      if (!roundtrip_dict(big, threads)) ++fails;
    }
    if (!roundtrip_file(big, 4)) ++fails;
  }
  if (fails) {
    std::fprintf(stderr, "sanitize_main: %d roundtrip failures\n", fails);
    return 1;
  }
  std::puts("sanitize_main: all MT roundtrips byte-exact");
  return 0;
}
