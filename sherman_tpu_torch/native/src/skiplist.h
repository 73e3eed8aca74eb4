// Concurrent skiplist — lock-free insert, wait-free seek, arena-backed.
// (See skiplist.cc for the C ABI; index_cache.cc embeds the structure.)
//
// Role parity: the reference's third_party/inlineskiplist.h.  Original
// design: fixed node arena addressed by 32-bit indices (cheap atomics, no
// ABA — nodes are never freed), towers inline, links CAS-published bottom-up.
#pragma once

#include "common.h"

namespace shn {

constexpr int kMaxHeight = 16;
constexpr uint32_t kNil = 0xFFFFFFFFu;

struct SklNode {
  uint64_t key;
  std::atomic<uint64_t> value;
  int32_t height;
  std::atomic<uint32_t> next[kMaxHeight];
};

struct SkipList {
  uint32_t capacity;
  std::atomic<uint32_t> used{0};
  std::atomic<int> max_height{1};
  SklNode* arena;
  uint32_t head;  // sentinel, acts as key = -inf

  explicit SkipList(uint32_t cap) : capacity(cap + 1) {
    arena = (SklNode*)std::calloc(capacity, sizeof(SklNode));
    if (!arena) {  // caller checks ok(); keep the object inert
      capacity = 0;
      head = kNil;
      return;
    }
    head = alloc_node(0, 0, kMaxHeight);
  }
  bool ok() const { return arena != nullptr; }
  ~SkipList() { std::free(arena); }
  SkipList(const SkipList&) = delete;

  uint32_t alloc_node(uint64_t key, uint64_t value, int height) {
    uint32_t i = used.fetch_add(1, std::memory_order_relaxed);
    if (i >= capacity) return kNil;
    SklNode& n = arena[i];
    n.key = key;
    n.value.store(value, std::memory_order_relaxed);
    n.height = height;
    for (int h = 0; h < height; ++h)
      n.next[h].store(kNil, std::memory_order_relaxed);
    return i;
  }

  int random_height() {
    // thread-local PRNG: insert() is concurrent, a shared generator would
    // race (and correlate tower heights across threads)
    static thread_local Rng rng{0x5eed ^ (uint64_t)(uintptr_t)&rng};
    int h = 1;
    while (h < kMaxHeight && (rng.next() & 3) == 0) ++h;  // p = 1/4
    return h;
  }

  // Greatest node with key < target at each level.  Fills ALL kMaxHeight
  // levels (not just the current max): a taller-than-max new node needs
  // valid preds above max_height, and the head tower spans full height.
  void find_preds(uint64_t target, uint32_t preds[kMaxHeight],
                  uint32_t succs[kMaxHeight]) {
    uint32_t x = head;
    for (int h = kMaxHeight - 1; h >= 0; --h) {
      while (true) {
        uint32_t nxt = arena[x].next[h].load(std::memory_order_acquire);
        if (nxt != kNil && arena[nxt].key < target)
          x = nxt;
        else {
          preds[h] = x;
          succs[h] = nxt;
          break;
        }
      }
    }
  }

  // Insert; overwrites value when key exists.  0 ok, -1 full, 1 updated.
  int insert(uint64_t key, uint64_t value) {
    uint32_t preds[kMaxHeight], succs[kMaxHeight];
    while (true) {
      find_preds(key, preds, succs);
      if (succs[0] != kNil && arena[succs[0]].key == key) {
        arena[succs[0]].value.store(value, std::memory_order_release);
        return 1;
      }
      int h = random_height();
      uint32_t node = alloc_node(key, value, h);
      if (node == kNil) return -1;
      int cur_max = max_height.load(std::memory_order_relaxed);
      while (h > cur_max &&
             !max_height.compare_exchange_weak(cur_max, h,
                                               std::memory_order_acq_rel)) {
      }
      // bottom level first: the node becomes visible atomically
      arena[node].next[0].store(succs[0], std::memory_order_relaxed);
      if (!arena[preds[0]].next[0].compare_exchange_strong(
              succs[0], node, std::memory_order_acq_rel))
        continue;  // bottom CAS lost: recompute (node index is wasted)
      for (int lvl = 1; lvl < h; ++lvl) {
        while (true) {
          arena[node].next[lvl].store(succs[lvl],
                                      std::memory_order_relaxed);
          if (arena[preds[lvl]].next[lvl].compare_exchange_strong(
                  succs[lvl], node, std::memory_order_acq_rel))
            break;
          find_preds(key, preds, succs);
        }
      }
      return 0;
    }
  }

  // First node with key >= target; kNil if none.
  uint32_t seek_ge(uint64_t target) {
    uint32_t preds[kMaxHeight], succs[kMaxHeight];
    find_preds(target, preds, succs);
    return succs[0];
  }
};

}  // namespace shn
