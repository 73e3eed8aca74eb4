// Shared helpers for the sherman_tpu native runtime library.
//
// The reference system is 100% native C++ (SURVEY.md §2); these sources are
// the TPU build's native runtime ring: everything host-side that sits on the
// operation hot path but outside the XLA-compiled data plane.  Exposed to
// Python through a plain C ABI (ctypes), no pybind11.
#pragma once

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>

#if defined(__GNUC__)
#define SHN_EXPORT extern "C" __attribute__((visibility("default")))
#else
#define SHN_EXPORT extern "C"
#endif

namespace shn {

// xorshift128+ — fast per-object PRNG (workload gen, eviction sampling).
struct Rng {
  uint64_t s0, s1;
  explicit Rng(uint64_t seed) {
    // splitmix64 seeding
    uint64_t z = seed + 0x9e3779b97f4a7c15ull;
    auto mix = [&z]() {
      z += 0x9e3779b97f4a7c15ull;
      uint64_t x = z;
      x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
      x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
      return x ^ (x >> 31);
    };
    s0 = mix();
    s1 = mix();
    if (s0 == 0 && s1 == 0) s0 = 1;
  }
  inline uint64_t next() {
    uint64_t x = s0, y = s1;
    s0 = y;
    x ^= x << 23;
    s1 = x ^ y ^ (x >> 17) ^ (y >> 26);
    return s1 + y;
  }
  inline double next_double() {  // [0, 1)
    return (next() >> 11) * (1.0 / 9007199254740992.0);
  }
};

}  // namespace shn
