// Native host data plane: colio load/dump + threaded seed-stable datagen.
//
// The reference is a native C++ program (BASELINE.json:L5); in this
// framework the device compute path is JAX/XLA and the native layer owns
// the host-side runtime around it (SURVEY.md §2.3): zero-copy columnar
// file IO (mmap) and benchmark-relation generation that saturates host
// cores instead of a single numpy stream. Exposed through a C ABI and
// loaded with ctypes (tpq/colio.py, tpq/datagen.py) — no pybind11 in the
// image.
//
// The datagen bitstream contract is shared with tpq/datagen.py and
// oracle/datagen.h: splitmix64 over a salted counter, zipf via double
// inverse-CDF summed in index order (SURVEY.md §4.4.3). Byte-identical
// output is tested in tests/test_native.py.
//
// Build: g++ -std=c++17 -O3 -shared -fPIC -pthread -o libtpqio.so tpqio.cc

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

constexpr uint64_t kGolden = 0x9E3779B97F4A7C15ull;
constexpr uint64_t kStreamMul = 0xD1342543DE82EF95ull;
constexpr uint64_t kPayloadSalt = 0xA5A5A5A5DEADBEEFull;

inline uint64_t splitmix64(uint64_t x) {
  uint64_t z = x + kGolden;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

inline uint64_t stream(uint64_t seed, uint64_t idx) {
  return splitmix64(seed ^ (idx * kStreamMul));
}

void parallel_for(uint64_t n, const std::function<void(uint64_t, uint64_t)>& body) {
  unsigned nt = std::max(1u, std::thread::hardware_concurrency());
  if (n < 1u << 16) nt = 1;
  std::vector<std::thread> ts;
  uint64_t chunk = (n + nt - 1) / nt;
  for (unsigned t = 0; t < nt; t++) {
    uint64_t lo = t * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back(body, lo, hi);
  }
  for (auto& th : ts) th.join();
}

}  // namespace

extern "C" {

// keys[i] = splitmix64-stream % nkeys, i in [0, rows)
void tpqio_gen_uniform(int64_t* out, uint64_t rows, uint64_t nkeys, uint64_t seed) {
  parallel_for(rows, [&](uint64_t lo, uint64_t hi) {
    for (uint64_t i = lo; i < hi; i++)
      out[i] = (int64_t)(stream(seed, i) % nkeys);
  });
}

// zipf(theta) ranks via inverse CDF; cdf computed once (index order).
void tpqio_gen_zipf(int64_t* out, uint64_t rows, uint64_t nkeys, double theta,
                    uint64_t seed) {
  std::vector<double> cdf(nkeys);
  double acc = 0;
  for (uint64_t k = 0; k < nkeys; k++) {
    acc += std::pow((double)(k + 1), -theta);
    cdf[k] = acc;
  }
  const double total = cdf[nkeys - 1];
  parallel_for(rows, [&](uint64_t lo, uint64_t hi) {
    for (uint64_t i = lo; i < hi; i++) {
      const double u = (double)(stream(seed, i) >> 11) * (1.0 / 9007199254740992.0);
      auto it = std::upper_bound(cdf.begin(), cdf.end(), u * total);
      uint64_t k = (uint64_t)(it - cdf.begin());
      if (k > nkeys - 1) k = nkeys - 1;
      out[i] = (int64_t)k;
    }
  });
}

// payload column j of ncols
void tpqio_gen_payload(int64_t* out, uint64_t rows, uint64_t ncols, uint64_t j,
                       uint64_t seed) {
  parallel_for(rows, [&](uint64_t lo, uint64_t hi) {
    for (uint64_t i = lo; i < hi; i++)
      out[i] = (int64_t)(stream(seed ^ kPayloadSalt, i * ncols + j) >> 1);
  });
}

// Fast multithreaded canonical-order check helper: lexicographic "is row a
// < row b" over ncols int64 columns laid out contiguously — used by bench
// verification at scales where python canonicalization is the bottleneck.
// Sorts `perm` (size n, preinitialized 0..n-1) by rows.
void tpqio_lexsort_rows(const int64_t* const* cols, uint32_t ncols, uint64_t n,
                        uint32_t* perm) {
  std::sort(perm, perm + n, [&](uint32_t a, uint32_t b) {
    for (uint32_t c = 0; c < ncols; c++) {
      if (cols[c][a] != cols[c][b]) return cols[c][a] < cols[c][b];
    }
    return false;
  });
}

}  // extern "C"
