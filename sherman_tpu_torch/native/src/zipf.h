// Zipfian / uniform rank samplers — shared by the standalone generator
// (zipf.cc) and the fused batch-prep pipeline (prep.cc).
//
// Role parity: the reference benchmark's zipf generator (test/zipf.h,
// mehcached_zipf_init/next) feeding the YCSB driver (test/benchmark.cpp).
// Distinct design: classical Gray/Jain rejection-free inverse-CDF
// approximation with an exact zeta(n, theta) partial sum computed once at
// construction, and bulk APIs so callers amortize per-call overhead.
#pragma once

#include <cmath>

#include "common.h"

namespace shn {

// Fast x^a for x in (0, 1] via exp2(a * log2(x)) with polynomial
// approximations (atanh series for log2, 8-term Taylor for exp2).
// Relative rank error at theta=0.99 (a ~= 100) is ~1e-3 — a workload
// generator's inverse-CDF tolerance; the reference's own sampler uses an
// approximate pow the same way (test/zipf.h, MICA fast-pow role).
inline double fast_log2(double x) {
  uint64_t bits;
  memcpy(&bits, &x, 8);
  int e = (int)((bits >> 52) & 0x7ff) - 1023;
  bits = (bits & 0x000fffffffffffffull) | 0x3ff0000000000000ull;
  double m;
  memcpy(&m, &bits, 8);  // m in [1, 2)
  double t = (m - 1.0) / (m + 1.0);
  double t2 = t * t;
  // 2/ln2 * atanh-series through t^9
  double p = t * (2.885390081777927 +
                  t2 * (0.961796693925976 +
                        t2 * (0.577078016355585 +
                              t2 * (0.412198595302989 +
                                    t2 * 0.320598812316461))));
  return (double)e + p;
}

inline double fast_exp2(double y) {
  double fi = __builtin_floor(y);
  double f = y - fi;
  double z = f * 0.6931471805599453;  // f*ln2; e^z via Taylor to z^7
  double r = 1.0 +
             z * (1.0 +
                  z * (0.5 +
                       z * (1.0 / 6 +
                            z * (1.0 / 24 +
                                 z * (1.0 / 120 +
                                      z * (1.0 / 720 + z / 5040))))));
  uint64_t ebits = (uint64_t)(int64_t)((int)fi + 1023) << 52;
  double scale;
  memcpy(&scale, &ebits, 8);
  return r * scale;
}

struct Zipf {
  uint64_t n;
  double theta;
  double zetan;     // sum_{i=1..n} 1/i^theta
  double alpha;     // 1 / (1 - theta)
  double eta;
  double half_pow;  // 1 + 0.5^theta
  Rng rng;

  Zipf(uint64_t n_, double theta_, uint64_t seed)
      : n(n_), theta(theta_), rng(seed) {
    double z = 0.0;
    for (uint64_t i = 1; i <= n; ++i) z += std::pow((double)i, -theta);
    zetan = z;
    double zeta2 = 1.0 + std::pow(2.0, -theta);
    alpha = 1.0 / (1.0 - theta);
    eta = (1.0 - std::pow(2.0 / (double)n, 1.0 - theta)) /
          (1.0 - zeta2 / zetan);
    half_pow = 1.0 + std::pow(0.5, theta);
  }

  inline uint64_t next() {
    double u = rng.next_double();
    double uz = u * zetan;
    if (uz < 1.0) return 0;
    if (uz < half_pow) return 1;
    uint64_t r =
        (uint64_t)((double)n * std::pow(eta * u - eta + 1.0, alpha));
    return r >= n ? n - 1 : r;
  }

  // Hot-loop variant: fast_exp2/fast_log2 instead of std::pow (~4x).
  inline uint64_t next_fast() {
    double u = rng.next_double();
    double uz = u * zetan;
    if (uz < 1.0) return 0;
    if (uz < half_pow) return 1;
    double x = eta * u - eta + 1.0;
    uint64_t r = (uint64_t)((double)n * fast_exp2(alpha * fast_log2(x)));
    return r >= n ? n - 1 : r;
  }
};

struct UniformGen {
  uint64_t n;
  Rng rng;
  UniformGen(uint64_t n_, uint64_t seed) : n(n_), rng(seed) {}
  inline uint64_t next() {
    // Lemire-style rejection-free enough for workload gen: 128-bit multiply.
    return (uint64_t)(((__uint128_t)rng.next() * n) >> 64);
  }
};

}  // namespace shn
