// Latency histogram — fixed 0.1 µs buckets, thread-safe, percentile reduce.
//
// Role parity: the reference's per-thread latency windows
// (latency[MAX_APP_THREAD][LATENCY_WINDOWS], src/Tree.cpp:17) reduced to
// p50..p999 by cal_latency (test/benchmark.cpp:207-249).  Design here:
// one shared atomic bucket array (records are a single relaxed fetch-add,
// so many Python / native threads can record concurrently), percentiles by
// a single pass over the cumulative sum.
#include <new>

#include "common.h"

namespace {

constexpr uint64_t kBucketNs = 100;     // 0.1 µs per bucket
constexpr uint64_t kBuckets = 1 << 20;  // covers up to ~105 ms

struct Hist {
  std::atomic<uint64_t> total{0};
  std::atomic<uint64_t> buckets[kBuckets];
  Hist() {
    for (uint64_t i = 0; i < kBuckets; ++i)
      buckets[i].store(0, std::memory_order_relaxed);
  }
};

}  // namespace

SHN_EXPORT void* shn_hist_new() { return new (std::nothrow) Hist(); }

SHN_EXPORT void shn_hist_free(void* h) { delete (Hist*)h; }

SHN_EXPORT void shn_hist_reset(void* h) {
  auto* hist = (Hist*)h;
  hist->total.store(0, std::memory_order_relaxed);
  for (uint64_t i = 0; i < kBuckets; ++i)
    hist->buckets[i].store(0, std::memory_order_relaxed);
}

static inline void record_one(Hist* hist, uint64_t ns) {
  uint64_t b = ns / kBucketNs;
  if (b >= kBuckets) b = kBuckets - 1;
  hist->buckets[b].fetch_add(1, std::memory_order_relaxed);
  hist->total.fetch_add(1, std::memory_order_relaxed);
}

SHN_EXPORT void shn_hist_record(void* h, uint64_t ns) {
  record_one((Hist*)h, ns);
}

SHN_EXPORT void shn_hist_record_many(void* h, const uint64_t* ns,
                                     uint64_t count) {
  auto* hist = (Hist*)h;
  for (uint64_t i = 0; i < count; ++i) record_one(hist, ns[i]);
}

// Record `count` ops that together took `span_ns` (a batched step): each op's
// latency is the span (they completed together), weight = count.
SHN_EXPORT void shn_hist_record_batch(void* h, uint64_t span_ns,
                                      uint64_t count) {
  auto* hist = (Hist*)h;
  uint64_t b = span_ns / kBucketNs;
  if (b >= kBuckets) b = kBuckets - 1;
  hist->buckets[b].fetch_add(count, std::memory_order_relaxed);
  hist->total.fetch_add(count, std::memory_order_relaxed);
}

SHN_EXPORT uint64_t shn_hist_count(void* h) {
  return ((Hist*)h)->total.load(std::memory_order_relaxed);
}

// qs in (0,1], ascending; out_us[i] = bucket midpoint latency in µs.
SHN_EXPORT void shn_hist_percentiles(void* h, const double* qs, uint64_t nq,
                                     double* out_us) {
  auto* hist = (Hist*)h;
  uint64_t total = hist->total.load(std::memory_order_relaxed);
  if (total == 0) {
    for (uint64_t i = 0; i < nq; ++i) out_us[i] = 0.0;
    return;
  }
  uint64_t cum = 0, qi = 0;
  for (uint64_t b = 0; b < kBuckets && qi < nq; ++b) {
    cum += hist->buckets[b].load(std::memory_order_relaxed);
    while (qi < nq && (double)cum >= qs[qi] * (double)total) {
      out_us[qi] = ((double)b + 0.5) * (double)kBucketNs / 1000.0;
      ++qi;
    }
  }
  while (qi < nq) out_us[qi++] = (double)(kBuckets * kBucketNs) / 1000.0;
}
