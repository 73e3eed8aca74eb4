// C ABI for the concurrent skiplist (skiplist.h) — standalone use from
// Python (the reference's skiplist_test is the one host-only unit test,
// test/skiplist_test.cpp; tests/test_native.py mirrors it).
#include <new>

#include "skiplist.h"

using shn::SkipList;

SHN_EXPORT void* shn_skl_new(uint64_t capacity) {
  if (capacity == 0 || capacity > 0xFFFFFFF0ull) return nullptr;
  auto* sl = new (std::nothrow) SkipList((uint32_t)capacity);
  if (sl && !sl->ok()) {
    delete sl;
    return nullptr;
  }
  return sl;
}

SHN_EXPORT void shn_skl_free(void* h) { delete (SkipList*)h; }

SHN_EXPORT int shn_skl_insert(void* h, uint64_t key, uint64_t value) {
  return ((SkipList*)h)->insert(key, value);
}

// -> 1 found (first entry with key >= target), 0 none.
SHN_EXPORT int shn_skl_seek_ge(void* h, uint64_t key, uint64_t* out_key,
                               uint64_t* out_value) {
  auto* sl = (SkipList*)h;
  uint32_t n = sl->seek_ge(key);
  if (n == shn::kNil) return 0;
  *out_key = sl->arena[n].key;
  *out_value = sl->arena[n].value.load(std::memory_order_acquire);
  return 1;
}

SHN_EXPORT uint64_t shn_skl_count(void* h) {
  auto* sl = (SkipList*)h;
  uint64_t c = 0;
  uint32_t x = sl->arena[sl->head].next[0].load(std::memory_order_acquire);
  while (x != shn::kNil) {
    ++c;
    x = sl->arena[x].next[0].load(std::memory_order_acquire);
  }
  return c;
}
