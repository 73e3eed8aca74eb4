// IndexCache — the compute-node range -> leaf-address cache, native.
//
// Role parity: the reference's IndexCache (include/IndexCache.h) +
// CacheEntry (include/CacheEntry.h): a concurrent skiplist of key-range
// entries that lets a cache hit skip every internal tree level
// (Tree.cpp:415-427), with CAS invalidation, an epoch-style delay-free
// list (~30 µs, IndexCache.h:137-149), 2-random-choice eviction by
// frequency (IndexCache.h:227-259), and hit/miss statistics.
//
// TPU-first difference: the reference caches whole 1 KB level-1 page
// *contents* and re-scans them per lookup; here an entry maps a child
// range [from, to) directly to the child (leaf) address — same remote-read
// savings (internal levels skipped, one leaf read per hit), no page scan,
// and the same entry granularity the device-side LeafRouter consumes, so
// the host cache can seed the router table.
//
// Concurrency: arena slots are recycled (delay-free ring), so each entry
// carries a seqlock version — writers bump it odd around a slot rewrite,
// readers snapshot it before/after and treat any movement as a miss (the
// caller just descends normally; a spurious miss never breaks anything).
#include <chrono>
#include <new>

#include "skiplist.h"

namespace {

using shn::kNil;

struct Entry {
  std::atomic<uint32_t> ver{0};   // seqlock: odd = being rewritten
  std::atomic<uint32_t> freq{0};  // lookup popularity (eviction signal)
  std::atomic<uint32_t> live{0};  // 1 while the slot's [from,to) is current
  std::atomic<uint64_t> from{0};  // inclusive
  std::atomic<uint64_t> to{0};    // exclusive
  std::atomic<uint64_t> ptr{0};   // leaf address (0 = invalidated)
};

struct FreeSlot {
  uint32_t idx;
  uint64_t t_ns;  // when it was invalidated (delay-free epoch)
};

inline uint64_t now_ns() {
  return (uint64_t)std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

constexpr uint64_t kDelayFreeNs = 30'000;  // ~30 µs, IndexCache.h:137-149

struct IndexCache {
  uint32_t capacity;
  shn::SkipList index;  // key = entry.to, value = arena slot
  Entry* arena;
  std::atomic<uint32_t> used{0};
  // delay-free ring, guarded by a tiny spinlock (reuse/eviction is rare
  // and off the hot lookup path)
  FreeSlot* free_ring;
  uint32_t free_cap;
  std::atomic<uint32_t> free_head{0}, free_tail{0};
  std::atomic<uint32_t> free_lock{0};
  // stats
  std::atomic<uint64_t> hits{0}, misses{0}, adds{0}, evictions{0},
      invalidates{0}, add_fails{0};

  explicit IndexCache(uint32_t cap)
      // skiplist sized 4x: arena slots are reused but skiplist nodes are
      // append-only (lost-CAS nodes + re-added ranges consume fresh nodes);
      // the factory bounds cap so the multiply cannot wrap
      : capacity(cap), index(cap * 4) {
    arena = new (std::nothrow) Entry[cap];
    free_cap = cap + 1;
    free_ring = (FreeSlot*)std::calloc(free_cap, sizeof(FreeSlot));
  }
  ~IndexCache() {
    delete[] arena;
    std::free(free_ring);
  }
  bool ok() const { return arena && free_ring && index.ok(); }

  void spin_lock() {
    uint32_t e = 0;
    while (!free_lock.compare_exchange_weak(e, 1u,
                                            std::memory_order_acquire))
      e = 0;
  }
  void spin_unlock() { free_lock.store(0, std::memory_order_release); }

  void push_free(uint32_t idx) {
    spin_lock();
    uint32_t t = free_tail.load(std::memory_order_relaxed);
    uint32_t nt = (t + 1) % free_cap;
    if (nt != free_head.load(std::memory_order_relaxed)) {
      free_ring[t] = {idx, now_ns()};
      free_tail.store(nt, std::memory_order_relaxed);
    }
    spin_unlock();
  }

  // Pop a slot whose delay-free epoch has passed; kNil if none ready.
  uint32_t pop_free() {
    spin_lock();
    uint32_t h = free_head.load(std::memory_order_relaxed);
    uint32_t idx = kNil;
    if (h != free_tail.load(std::memory_order_relaxed) &&
        now_ns() - free_ring[h].t_ns >= kDelayFreeNs) {
      idx = free_ring[h].idx;
      free_head.store((h + 1) % free_cap, std::memory_order_relaxed);
    }
    spin_unlock();
    return idx;
  }

  // 2-random-choice: invalidate the less-popular of two sampled live slots
  // and queue it for delayed reuse (IndexCache.h:227-259 semantics).
  void evict_one() {
    static thread_local shn::Rng rng{0xe71c ^ (uint64_t)(uintptr_t)&rng};
    uint32_t n = used.load(std::memory_order_relaxed);
    if (n == 0) return;
    if (n > capacity) n = capacity;
    for (int attempt = 0; attempt < 16; ++attempt) {
      uint32_t a = (uint32_t)(rng.next() % n);
      uint32_t b = (uint32_t)(rng.next() % n);
      uint32_t victim =
          arena[a].freq.load(std::memory_order_relaxed) <=
                  arena[b].freq.load(std::memory_order_relaxed)
              ? a
              : b;
      uint32_t one = 1;
      if (arena[victim].live.compare_exchange_strong(
              one, 0u, std::memory_order_acq_rel)) {
        arena[victim].ptr.store(0, std::memory_order_release);
        push_free(victim);
        evictions.fetch_add(1, std::memory_order_relaxed);
        return;
      }
    }
  }

  uint32_t alloc_slot() {
    uint32_t i = used.load(std::memory_order_relaxed);
    while (i < capacity) {
      if (used.compare_exchange_weak(i, i + 1,
                                     std::memory_order_acq_rel))
        return i;
    }
    uint32_t f = pop_free();
    if (f != kNil) return f;
    evict_one();
    f = pop_free();  // may still be in its delay window
    return f;        // kNil -> caller drops the add (cache full)
  }

  // Insert or refresh [from, to) -> ptr.  >= 0 ok, < 0 dropped.
  int add(uint64_t from, uint64_t to, uint64_t ptr) {
    if (to <= from || ptr == 0) return -2;
    adds.fetch_add(1, std::memory_order_relaxed);
    // fast path: same range already present -> refresh its ptr
    uint32_t n = index.seek_ge(to);
    if (n != kNil && index.arena[n].key == to) {
      uint32_t slot =
          (uint32_t)index.arena[n].value.load(std::memory_order_acquire);
      if (slot < capacity &&
          arena[slot].live.load(std::memory_order_acquire) &&
          arena[slot].from.load(std::memory_order_relaxed) == from &&
          arena[slot].to.load(std::memory_order_relaxed) == to) {
        arena[slot].ptr.store(ptr, std::memory_order_release);
        return 1;
      }
    }
    uint32_t slot = alloc_slot();
    if (slot == kNil) {
      add_fails.fetch_add(1, std::memory_order_relaxed);
      return -1;
    }
    // seqlock write: odd while the slot's identity is in flux
    arena[slot].ver.fetch_add(1, std::memory_order_acq_rel);
    arena[slot].from.store(from, std::memory_order_relaxed);
    arena[slot].to.store(to, std::memory_order_relaxed);
    arena[slot].freq.store(1, std::memory_order_relaxed);
    arena[slot].ptr.store(ptr, std::memory_order_relaxed);
    arena[slot].live.store(1, std::memory_order_relaxed);
    arena[slot].ver.fetch_add(1, std::memory_order_release);
    if (index.insert(to, slot) < 0) {
      // skiplist node arena exhausted: roll the slot back so it is not a
      // live-but-unreachable leak, and report the drop to the caller
      uint32_t one = 1;
      if (arena[slot].live.compare_exchange_strong(
              one, 0u, std::memory_order_acq_rel)) {
        arena[slot].ptr.store(0, std::memory_order_release);
        push_free(slot);
      }
      add_fails.fetch_add(1, std::memory_order_relaxed);
      return -1;
    }
    return 0;
  }

  // -> leaf ptr or 0.  Bumps freq + hit/miss counters.
  uint64_t lookup(uint64_t key) {
    // entry covers key iff from <= key < to; index key is `to`, so the
    // candidate is the first node with to > key i.e. seek_ge(key + 1)
    uint32_t n = index.seek_ge(key + 1);
    if (n != kNil) {
      uint32_t slot =
          (uint32_t)index.arena[n].value.load(std::memory_order_acquire);
      if (slot < capacity) {
        Entry& e = arena[slot];
        uint32_t v1 = e.ver.load(std::memory_order_acquire);
        if (!(v1 & 1) && e.live.load(std::memory_order_acquire) &&
            e.to.load(std::memory_order_relaxed) == index.arena[n].key &&
            e.from.load(std::memory_order_relaxed) <= key &&
            key < e.to.load(std::memory_order_relaxed)) {
          uint64_t p = e.ptr.load(std::memory_order_acquire);
          if (p != 0 &&
              e.ver.load(std::memory_order_acquire) == v1) {
            e.freq.fetch_add(1, std::memory_order_relaxed);
            hits.fetch_add(1, std::memory_order_relaxed);
            return p;
          }
        }
      }
    }
    misses.fetch_add(1, std::memory_order_relaxed);
    return 0;
  }

  // CAS-null the entry covering key (stale hit detected: IndexCache.h:209).
  int invalidate(uint64_t key) {
    uint32_t n = index.seek_ge(key + 1);
    if (n == kNil) return 0;
    uint32_t slot =
        (uint32_t)index.arena[n].value.load(std::memory_order_acquire);
    if (slot >= capacity ||
        arena[slot].from.load(std::memory_order_relaxed) > key ||
        key >= arena[slot].to.load(std::memory_order_relaxed))
      return 0;
    uint32_t one = 1;
    if (arena[slot].live.compare_exchange_strong(one, 0u,
                                                 std::memory_order_acq_rel)) {
      arena[slot].ptr.store(0, std::memory_order_release);
      push_free(slot);
      invalidates.fetch_add(1, std::memory_order_relaxed);
      return 1;
    }
    return 0;
  }
};

}  // namespace

SHN_EXPORT void* shn_cache_new(uint64_t capacity) {
  // bound so cap*4 (skiplist) and cap+1 (free ring) fit in uint32
  if (capacity == 0 || capacity > (1ull << 28)) return nullptr;
  auto* c = new (std::nothrow) IndexCache((uint32_t)capacity);
  if (c && !c->ok()) {
    delete c;
    return nullptr;
  }
  return c;
}

SHN_EXPORT void shn_cache_free(void* h) { delete (IndexCache*)h; }

SHN_EXPORT int shn_cache_add(void* h, uint64_t from, uint64_t to,
                             uint64_t ptr) {
  return ((IndexCache*)h)->add(from, to, ptr);
}

SHN_EXPORT void shn_cache_add_many(void* h, const uint64_t* from,
                                   const uint64_t* to, const uint64_t* ptr,
                                   uint64_t n) {
  auto* c = (IndexCache*)h;
  for (uint64_t i = 0; i < n; ++i) c->add(from[i], to[i], ptr[i]);
}

SHN_EXPORT uint64_t shn_cache_lookup(void* h, uint64_t key) {
  return ((IndexCache*)h)->lookup(key);
}

SHN_EXPORT void shn_cache_lookup_many(void* h, const uint64_t* keys,
                                      uint64_t n, uint64_t* out_ptrs) {
  auto* c = (IndexCache*)h;
  for (uint64_t i = 0; i < n; ++i) out_ptrs[i] = c->lookup(keys[i]);
}

SHN_EXPORT int shn_cache_invalidate(void* h, uint64_t key) {
  return ((IndexCache*)h)->invalidate(key);
}

// out[9] = hits, misses, adds, evictions, invalidates, used_slots,
//          capacity, skiplist_nodes, add_fails
SHN_EXPORT void shn_cache_stats(void* h, uint64_t* out) {
  auto* c = (IndexCache*)h;
  out[0] = c->hits.load(std::memory_order_relaxed);
  out[1] = c->misses.load(std::memory_order_relaxed);
  out[2] = c->adds.load(std::memory_order_relaxed);
  out[3] = c->evictions.load(std::memory_order_relaxed);
  out[4] = c->invalidates.load(std::memory_order_relaxed);
  uint32_t u = c->used.load(std::memory_order_relaxed);
  out[5] = u < c->capacity ? u : c->capacity;
  out[6] = c->capacity;
  out[7] = c->index.used.load(std::memory_order_relaxed);
  out[8] = c->add_fails.load(std::memory_order_relaxed);
}
