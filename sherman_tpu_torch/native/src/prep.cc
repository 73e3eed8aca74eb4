// BatchPrep — fused native batch preparation: zipf sample -> key map ->
// duplicate combining (unique + inverse) -> index-cache probe, one pass.
//
// Role parity: the reference's clients generate and issue each op inline in
// the open benchmark loop (test/benchmark.cpp:159-188) — nothing is hoisted
// out of the timed window.  The batched TPU engine's per-batch equivalent of
// that inline work is exactly this pipeline; the former numpy implementation
// (sort-based np.unique + separate router gather, three passes over 4 M
// keys) cost ~670 ms/batch on a 1-core host and was measured separately
// from the device step.  This version is a streaming dedup pass plus a
// pipelined probe pass:
//
//   rank   = zipf.next_fast()                 (inverse-CDF, fast pow)
//   key    = keyspace[rank]  OR  mix64(rank ^ salt)   (synthetic mode:
//            an arithmetic rank->key bijection, the reference benchmark's
//            own convention — its key IS the zipf rank — so no 800 MB
//            random gather sits in the serving loop)
//   slot   = hash-probe(key)                  (epoch-tagged open addressing,
//            16-byte slots so a probe touches ONE cache line, THP-backed,
//            load factor <= .5, software-prefetched in 256-op blocks)
//   new?   -> assign unique id, split key into (hi, lo) int32 words
//   inv[i] = unique id                        (the fan-out map)
//   then: for each fresh unique, probe router table[min(key >> shift,
//         nb-1)] (the CN cache lookup, IndexCache.h:134-184 role) in a
//         second prefetch-pipelined pass over just the uniques.
//
// The hash table is epoch-tagged so per-batch reset is O(1), not a 128 MB
// memset.
#include <sys/mman.h>

#include <new>

#include "zipf.h"

#if defined(__x86_64__)
#include <immintrin.h>
#endif

namespace {

constexpr uint64_t kBlock = 128;

inline uint64_t mix64(uint64_t x) {
  // splitmix64 finalizer — full-avalanche, 3 multiplies
  x ^= x >> 30;
  x *= 0xbf58476d1ce4e5b9ull;
  x ^= x >> 27;
  x *= 0x94d049bb133111ebull;
  x ^= x >> 31;
  return x;
}

// Anonymous mapping (over-allocated so a 2 MB-aligned view fits inside)
// with MADV_HUGEPAGE: the hash table and unique-key scratch are
// random-access; 4 KB pages would pay a TLB walk per probe.  Returns the
// RAW mapping (munmap target); callers align their view into it.
void* big_alloc(size_t bytes, size_t* mapped) {
  const size_t kHuge = 2ull << 20;
  size_t sz = ((bytes + kHuge - 1) & ~(kHuge - 1)) + kHuge;
  void* raw = mmap(nullptr, sz, PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
  if (raw == MAP_FAILED) return nullptr;
  madvise(raw, sz, MADV_HUGEPAGE);
  *mapped = sz;
  return raw;
}

template <class T>
T* align_huge(void* raw) {
  const uintptr_t kHuge = 2ull << 20;
  return (T*)(((uintptr_t)raw + kHuge - 1) & ~(kHuge - 1));
}

struct Slot {  // one cache line holds 4 slots; a probe touches one line
  uint64_t key;
  uint32_t epoch;
  uint32_t id;
};
static_assert(sizeof(Slot) == 16, "slot packing");

struct Prep {
  uint64_t* keybuf = nullptr;  // sampled client keys staging
  void* kb_raw = nullptr;
  size_t kb_mapped = 0;
  uint64_t batch;
  uint64_t capacity;   // max unique keys per run (output array length)
  uint64_t slots;      // pow2 >= 2*batch
  uint64_t mask;
  uint64_t salt;       // synthetic rank->key mode when != 0
  uint32_t epoch = 0;
  Slot* tab = nullptr;
  void* tab_raw = nullptr;
  size_t tab_mapped = 0;
  uint64_t* ukeys = nullptr;  // unique keys scratch for the probe pass
  void* uk_raw = nullptr;
  size_t uk_mapped = 0;
  shn::Zipf* zipf = nullptr;
  shn::UniformGen* uni = nullptr;
  bool ok = false;

  Prep(uint64_t n_keys, double theta, uint64_t seed, uint64_t batch_,
       uint64_t capacity_, uint64_t salt_)
      : batch(batch_), capacity(capacity_), salt(salt_) {
    slots = 64;
    while (slots < 2 * batch) slots <<= 1;
    mask = slots - 1;
    tab_raw = big_alloc(slots * sizeof(Slot), &tab_mapped);
    uk_raw = big_alloc(capacity * sizeof(uint64_t), &uk_mapped);
    kb_raw = big_alloc(batch * sizeof(uint64_t), &kb_mapped);
    if (!tab_raw || !uk_raw || !kb_raw) return;
    keybuf = align_huge<uint64_t>(kb_raw);
    tab = align_huge<Slot>(tab_raw);
    ukeys = align_huge<uint64_t>(uk_raw);
    memset(tab, 0, slots * sizeof(Slot));  // epoch 0 = never-used
    if (n_keys) {
      if (theta > 0.0)
        zipf = new (std::nothrow) shn::Zipf(n_keys, theta, seed);
      else
        uni = new (std::nothrow) shn::UniformGen(n_keys, seed);
      if (!zipf && !uni) return;
    }
    ok = true;
  }

  ~Prep() {
    if (tab_raw) munmap(tab_raw, tab_mapped);
    if (uk_raw) munmap(uk_raw, uk_mapped);
    if (kb_raw) munmap(kb_raw, kb_mapped);
    delete zipf;
    delete uni;
  }

  inline void bump_epoch() {
    if (++epoch == 0) {  // wrapped: one real reset every 2^32 batches
      memset(tab, 0, slots * sizeof(Slot));
      epoch = 1;
    }
  }

  // Dedup the generated stream.  Gen yields the next client key (stateful;
  // gather-style generators prefetch their own lookahead).  A rolling
  // D-deep software pipeline keeps ~D probe lines in flight continuously —
  // burst-phase (generate-all-then-probe-all) pipelining measured ~70 ms
  // slower per 4 M batch: the probe burst stalls on whatever the burst of
  // prefetches had not finished, while the generator sits idle.
  // Returns n_unique or -1 on capacity overflow.
  template <class Gen>
  int64_t dedup(Gen&& gen, uint64_t n, int32_t* khi, int32_t* klo,
                int32_t* inv) {
    bump_epoch();
    const uint32_t cur = epoch;
    uint64_t nu = 0;
    constexpr uint64_t D = 32;  // pipeline depth ~ MSHR budget
    uint64_t kq[D], hq[D];
    const uint64_t fill = n < D ? n : D;
    for (uint64_t j = 0; j < fill; ++j) {
      const uint64_t k = gen();
      kq[j] = k;
      hq[j] = mix64(k) & mask;
      __builtin_prefetch(&tab[hq[j]], 0, 1);
    }
    for (uint64_t i = 0; i < n; ++i) {
      const uint64_t r = i % D;
      const uint64_t k = kq[r];
      uint64_t s = hq[r];
      if (i + D < n) {  // refill the ring before probing (issue the miss)
        const uint64_t k2 = gen();
        kq[r] = k2;
        hq[r] = mix64(k2) & mask;
        __builtin_prefetch(&tab[hq[r]], 0, 1);
      }
      for (;;) {
        Slot& sl = tab[s];
        if (sl.epoch != cur) {  // empty this batch: claim
          if (nu >= capacity) return -1;
          sl.epoch = cur;
          sl.key = k;
          sl.id = (uint32_t)nu;
          ukeys[nu] = k;
          khi[nu] = (int32_t)(uint32_t)(k >> 32);
          klo[nu] = (int32_t)(uint32_t)k;
          inv[i] = (int32_t)nu;
          ++nu;
          break;
        }
        if (sl.key == k) {
          inv[i] = (int32_t)sl.id;
          break;
        }
        s = (s + 1) & mask;
      }
    }
    return (int64_t)nu;
  }

  // Router-table probe over just the uniques, prefetch-pipelined.
  void probe(uint64_t nu, const int32_t* table, uint64_t nb, uint32_t shift,
             int32_t default_start, int32_t* start) {
    if (!table) {
      for (uint64_t i = 0; i < nu; ++i) start[i] = default_start;
      return;
    }
    uint64_t b[kBlock];
    for (uint64_t base = 0; base < nu; base += kBlock) {
      const uint64_t m = (nu - base < kBlock) ? nu - base : kBlock;
      for (uint64_t j = 0; j < m; ++j) {
        uint64_t bk = ukeys[base + j] >> shift;
        if (bk >= nb) bk = nb - 1;
        b[j] = bk;
        __builtin_prefetch(&table[bk], 0, 1);
      }
      for (uint64_t j = 0; j < m; ++j) start[base + j] = table[b[j]];
    }
  }

  int64_t finish(int64_t nu_s, const int32_t* table, uint64_t nb,
                 uint32_t shift, int32_t default_start, int32_t* khi,
                 int32_t* klo, int32_t* start, uint8_t* active) {
    if (nu_s < 0) return nu_s;
    const uint64_t nu = (uint64_t)nu_s;
    probe(nu, table, nb, shift, default_start, start);
    memset(active, 0, capacity);
    memset(active, 1, nu);
    // pad rows: inactive, but give them a harmless in-bounds start seed
    for (uint64_t i = nu; i < capacity; ++i) {
      khi[i] = 0;
      klo[i] = 0;
      start[i] = default_start;
    }
    return nu_s;
  }
};

inline uint64_t sample_one(shn::Zipf* z) { return z->next_fast(); }
inline uint64_t sample_one(shn::UniformGen* u) { return u->next(); }

#if defined(__x86_64__)
// 8-wide AVX-512 zipf sampler fused with the synthetic key map: rank ->
// mix64(rank ^ salt).  The scalar pow chain costs ~26 ns/sample and is the
// prep bottleneck (measured 108 ms of a ~205 ms 4 M-op batch); this runs
// the whole inverse-CDF (exponent-extract log2 with sqrt2 range reduction
// + deg-10 polynomial, exp2 as floor + deg-7 polynomial + exponent
// assembly) and the splitmix64 finisher on 8 lanes of independent
// xorshift128+ streams.  Lane seeds derive from the generator's scalar
// RNG, so the stream stays deterministic per (seed, call sequence).
// Polynomial abs err: log2 1.2e-9, exp2 5.8e-11 -> rank relative error
// ~1e-6 at theta=0.99 (alpha ~= 100) — far inside workload-gen tolerance
// (the reference's MICA sampler uses a coarser fast-pow).
__attribute__((target("avx512f,avx512dq")))
void zipf_fill_keys_avx512(shn::Zipf* z, uint64_t salt, uint64_t n,
                           uint64_t* out) {
  alignas(64) uint64_t seed[16];
  for (int l = 0; l < 16; ++l) seed[l] = z->rng.next();
  __m512i s0 = _mm512_load_si512(seed);
  __m512i s1 = _mm512_load_si512(seed + 8);
  const __m512d vzetan = _mm512_set1_pd(z->zetan);
  const __m512d vhalf = _mm512_set1_pd(z->half_pow);
  const __m512d veta = _mm512_set1_pd(z->eta);
  const __m512d v1me = _mm512_set1_pd(1.0 - z->eta);
  const __m512d valpha = _mm512_set1_pd(z->alpha);
  const __m512d vn = _mm512_set1_pd((double)z->n);
  const __m512d vnm1 = _mm512_set1_pd((double)(z->n - 1));
  const __m512d vsqrt2 = _mm512_set1_pd(1.4142135623730951);
  const __m512d vhalfc = _mm512_set1_pd(0.5);
  const __m512d v2_53 = _mm512_set1_pd(1.0 / 9007199254740992.0);
  const __m512i vmant = _mm512_set1_epi64(0x000fffffffffffffull);
  const __m512i vonee = _mm512_set1_epi64(0x3ff0000000000000ull);
  const __m512i v1023 = _mm512_set1_epi64(1023);
  const __m512i vsalt = _mm512_set1_epi64((long long)salt);
  const __m512i vc1 = _mm512_set1_epi64((long long)0xbf58476d1ce4e5b9ull);
  const __m512i vc2 = _mm512_set1_epi64((long long)0x94d049bb133111ebull);
  // log2(1+z) on [1/sqrt2-1, sqrt2-1], low->high (fit err 1.2e-9)
  const double L[11] = {-9.953058253149826e-10, 1.442695036014125,
                        -0.7213470203588495,    0.48089872672209055,
                        -0.3607143286287836,    0.2885602359470694,
                        -0.23929769546910243,   0.20452211479439902,
                        -0.19315336620869378,   0.18741281050237493,
                        -0.10700663883393477};
  // 2^f on [0,1), low->high (fit err 5.8e-11)
  const double E[8] = {0.999999999943856,      0.6931471877102315,
                       0.24022635776975182,    0.05550529197743555,
                       0.009613535732759894,   0.001342981070631923,
                       0.0001429940125774305,  2.1651724410663057e-05};
  uint64_t i = 0;
  for (; i + 8 <= n; i += 8) {
    // xorshift128+ (8 lanes)
    __m512i x = s0;
    const __m512i y = s1;
    s0 = y;
    x = _mm512_xor_si512(x, _mm512_slli_epi64(x, 23));
    s1 = _mm512_xor_si512(
        _mm512_xor_si512(_mm512_xor_si512(x, y), _mm512_srli_epi64(x, 17)),
        _mm512_srli_epi64(y, 26));
    const __m512i r64 = _mm512_add_epi64(s1, y);
    // u in [0, 1)
    const __m512d u = _mm512_mul_pd(
        _mm512_cvtepi64_pd(_mm512_srli_epi64(r64, 11)), v2_53);
    const __m512d uz = _mm512_mul_pd(u, vzetan);
    const __m512d xv = _mm512_fmadd_pd(veta, u, v1me);  // in (1-eta, 1]
    // log2(xv): exponent + mantissa poly with sqrt2 range reduction
    const __m512i bits = _mm512_castpd_si512(xv);
    __m512i eI = _mm512_sub_epi64(_mm512_srli_epi64(bits, 52), v1023);
    __m512d m = _mm512_castsi512_pd(
        _mm512_or_si512(_mm512_and_si512(bits, vmant), vonee));
    const __mmask8 big = _mm512_cmp_pd_mask(m, vsqrt2, _CMP_GT_OQ);
    m = _mm512_mask_mul_pd(m, big, m, vhalfc);
    eI = _mm512_mask_add_epi64(eI, big, eI, _mm512_set1_epi64(1));
    const __m512d zq = _mm512_sub_pd(m, _mm512_set1_pd(1.0));
    __m512d p = _mm512_set1_pd(L[10]);
    for (int c = 9; c >= 0; --c)
      p = _mm512_fmadd_pd(p, zq, _mm512_set1_pd(L[c]));
    const __m512d l2 = _mm512_add_pd(_mm512_cvtepi64_pd(eI), p);
    // exp2(alpha * l2)
    const __m512d yv = _mm512_mul_pd(valpha, l2);  // in [~-28, 0]
    const __m512d fi =
        _mm512_roundscale_pd(yv, _MM_FROUND_TO_NEG_INF | _MM_FROUND_NO_EXC);
    const __m512d f = _mm512_sub_pd(yv, fi);
    __m512d ef = _mm512_set1_pd(E[7]);
    for (int c = 6; c >= 0; --c)
      ef = _mm512_fmadd_pd(ef, f, _mm512_set1_pd(E[c]));
    const __m512d scale = _mm512_castsi512_pd(_mm512_slli_epi64(
        _mm512_add_epi64(_mm512_cvtpd_epi64(fi), v1023), 52));
    __m512d rank_d = _mm512_mul_pd(vn, _mm512_mul_pd(ef, scale));
    rank_d = _mm512_min_pd(rank_d, vnm1);
    __m512i rank = _mm512_cvttpd_epi64(rank_d);
    // head special cases (uz < 1 -> 0; uz < 1 + 0.5^theta -> 1)
    const __mmask8 m1 = _mm512_cmp_pd_mask(uz, vhalf, _CMP_LT_OQ);
    const __mmask8 m0 = _mm512_cmp_pd_mask(uz, _mm512_set1_pd(1.0),
                                           _CMP_LT_OQ);
    rank = _mm512_mask_mov_epi64(rank, m1, _mm512_set1_epi64(1));
    rank = _mm512_mask_mov_epi64(rank, m0, _mm512_setzero_si512());
    // key = mix64(rank ^ salt)
    __m512i k = _mm512_xor_si512(rank, vsalt);
    k = _mm512_xor_si512(k, _mm512_srli_epi64(k, 30));
    k = _mm512_mullo_epi64(k, vc1);
    k = _mm512_xor_si512(k, _mm512_srli_epi64(k, 27));
    k = _mm512_mullo_epi64(k, vc2);
    k = _mm512_xor_si512(k, _mm512_srli_epi64(k, 31));
    _mm512_storeu_si512(out + i, k);
  }
  for (; i < n; ++i) out[i] = mix64(z->next_fast() ^ salt);
}

inline bool have_avx512() {
  static const bool ok = __builtin_cpu_supports("avx512f") &&
                         __builtin_cpu_supports("avx512dq");
  return ok;
}
#endif  // __x86_64__

// Stage A for synthetic zipf mode: vectorized when the CPU allows.
inline void fill_synthetic_zipf(shn::Zipf* z, uint64_t salt, uint64_t n,
                                uint64_t* out) {
#if defined(__x86_64__)
  if (have_avx512()) {
    zipf_fill_keys_avx512(z, salt, n, out);
    return;
  }
#endif
  for (uint64_t i = 0; i < n; ++i) out[i] = mix64(z->next_fast() ^ salt);
}

// Stateful generator: samples ranks R ahead and prefetches the keyspace
// gather targets, so by the time a rank's key is consumed its cache line
// is (usually) resident.
template <class Sampler>
struct RankAhead {
  Sampler* s;
  const uint64_t* keyspace;
  static constexpr uint64_t R = 16;
  uint64_t ring[R];
  uint64_t head = 0;

  RankAhead(Sampler* s_, const uint64_t* ks) : s(s_), keyspace(ks) {
    for (uint64_t j = 0; j < R; ++j) {
      ring[j] = sample_one(s);
      __builtin_prefetch(&keyspace[ring[j]], 0, 1);
    }
  }

  inline uint64_t operator()() {
    const uint64_t r = ring[head];
    ring[head] = sample_one(s);
    __builtin_prefetch(&keyspace[ring[head]], 0, 1);
    head = (head + 1) % R;
    return keyspace[r];
  }
};

}  // namespace

SHN_EXPORT void* shn_prep_new(uint64_t n_keys, double theta, uint64_t seed,
                              uint64_t batch, uint64_t capacity,
                              uint64_t salt) {
  if (batch == 0 || capacity == 0) return nullptr;
  auto* p = new (std::nothrow) Prep(n_keys, theta, seed, batch, capacity,
                                    salt);
  if (p && !p->ok) {
    delete p;
    return nullptr;
  }
  return p;
}

SHN_EXPORT void shn_prep_free(void* h) { delete (Prep*)h; }

// Phase-attribution hook: run stage A (sampling) alone.  Benchmarks only.
SHN_EXPORT int64_t shn_prep_sample_only(void* h) {
  auto* p = (Prep*)h;
  if (!p || !p->salt || (!p->zipf && !p->uni)) return -2;
  uint64_t* kb = p->keybuf;
  const uint64_t n = p->batch;
  const uint64_t salt = p->salt;
  if (p->zipf) {
    fill_synthetic_zipf(p->zipf, salt, n, kb);
  } else {
    auto* u = p->uni;
    for (uint64_t i = 0; i < n; ++i) kb[i] = mix64(u->next() ^ salt);
  }
  return (int64_t)n;
}

SHN_EXPORT int64_t shn_prep_run_keys(void* h, const uint64_t* keys,
                                     uint64_t n, const int32_t* table,
                                     uint64_t nb, uint32_t shift,
                                     int32_t default_start, int32_t* khi,
                                     int32_t* klo, int32_t* start,
                                     uint8_t* active, int32_t* inv) {
  auto* p = (Prep*)h;
  if (!p || n > p->batch) return -2;
  uint64_t i = 0;
  int64_t nu = p->dedup([keys, &i]() { return keys[i++]; }, n, khi, klo,
                        inv);
  return p->finish(nu, table, nb, shift, default_start, khi, klo, start,
                   active);
}

SHN_EXPORT int64_t shn_prep_run_zipf(void* h, const uint64_t* keyspace,
                                     uint64_t* out_keys,
                                     const int32_t* table, uint64_t nb,
                                     uint32_t shift, int32_t default_start,
                                     int32_t* khi, int32_t* klo,
                                     int32_t* start, uint8_t* active,
                                     int32_t* inv) {
  auto* p = (Prep*)h;
  if (!p || (!p->zipf && !p->uni)) return -2;
  if (!keyspace && !p->salt) return -2;
  // Stage A: sample the whole batch into the staging buffer in a TIGHT
  // loop (the pow polynomial keeps every register; fusing it into the
  // probe loop measured ~70 ms/batch slower from spill pressure), then
  // Stage B: dedup streams the staging buffer like an external key batch.
  uint64_t* kb = p->keybuf;
  const uint64_t n = p->batch;
  if (keyspace && p->zipf) {
    // internal rank lookahead so the keyspace gather is prefetched
    RankAhead<shn::Zipf> g{p->zipf, keyspace};
    for (uint64_t i = 0; i < n; ++i) kb[i] = g();
  } else if (keyspace) {
    RankAhead<shn::UniformGen> g{p->uni, keyspace};
    for (uint64_t i = 0; i < n; ++i) kb[i] = g();
  } else if (p->zipf) {
    fill_synthetic_zipf(p->zipf, p->salt, n, kb);
  } else {
    const uint64_t salt = p->salt;
    auto* u = p->uni;
    for (uint64_t i = 0; i < n; ++i) kb[i] = mix64(u->next() ^ salt);
  }
  if (out_keys) memcpy(out_keys, kb, n * sizeof(uint64_t));
  uint64_t i = 0;
  int64_t nu = p->dedup([kb, &i]() { return kb[i++]; }, n, khi, klo,
                        inv);
  return p->finish(nu, table, nb, shift, default_start, khi, klo, start,
                   active);
}
