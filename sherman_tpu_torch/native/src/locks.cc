// Local hierarchical lock table — ticket locks with bounded hand-over.
//
// Role parity: Sherman technique #1's local tier (Tree.cpp:1124-1173 +
// LocalLockNode, Tree.h:12-16): same-node contention on a global lock
// collapses onto a node-local ticket lock; the holder may hand the lock
// to the next local waiter up to kMaxHandOverTime=8 times (Common.h:101),
// so only one global CAS is paid per hand-over train.
//
// acquire(i) blocks (spin) until the caller holds local lock i, returning
// 1 when the *global* lock was handed over with it (skip the remote CAS).
// release(i, handover_ok) decides whether to pass the global lock on.
#include <new>

#include "common.h"

namespace {

constexpr uint32_t kMaxHandOver = 8;  // Common.h:101 parity

inline void cpu_relax() {
#if defined(__x86_64__)
  __builtin_ia32_pause();
#else
  std::atomic_signal_fence(std::memory_order_seq_cst);
#endif
}

struct alignas(64) LocalLock {
  std::atomic<uint32_t> ticket{0};
  std::atomic<uint32_t> current{0};
  // written only by the holder, read by the next holder under the ticket
  // ordering, so plain fields are fine with acq/rel on `current`
  uint8_t handed_over{0};
  uint32_t hand_time{0};
};

struct LockTable {
  uint64_t n;
  LocalLock* locks;
  explicit LockTable(uint64_t n_) : n(n_) {
    locks = new (std::nothrow) LocalLock[n];
  }
  ~LockTable() { delete[] locks; }
};

}  // namespace

SHN_EXPORT void* shn_lt_new(uint64_t n_locks) {
  auto* t = new (std::nothrow) LockTable(n_locks);
  if (t && !t->locks) {  // inner array alloc failed: report, don't segfault
    delete t;
    return nullptr;
  }
  return t;
}

SHN_EXPORT void shn_lt_free(void* h) { delete (LockTable*)h; }

// Blocks until local lock i is held; -> 1 if the global lock came with it.
SHN_EXPORT int shn_lt_acquire(void* h, uint64_t i) {
  auto& l = ((LockTable*)h)->locks[i];
  uint32_t my = l.ticket.fetch_add(1, std::memory_order_relaxed);
  while (l.current.load(std::memory_order_acquire) != my) {
    cpu_relax();  // holders run whole DSM steps; don't starve their core
  }
  return l.handed_over ? 1 : 0;
}

// Holder-only probe: would release(handover_ok=1) hand the lock over right
// now?  Lets the holder decide BEFORE its protected write step whether to
// coalesce the global unlock into the step (no waiter) or omit it (a
// hand-over train keeps the global lock).  The answer can only flip
// false -> true between probe and release (ticket waiters block and only
// the holder writes hand_time), so: probe true  -> release(1) is
// guaranteed to hand over; probe false -> caller coalesced the global
// unlock and must call release(0) so a late-arriving waiter is NOT handed
// a global lock that was just released.
SHN_EXPORT int shn_lt_can_handover(void* h, uint64_t i) {
  auto& l = ((LockTable*)h)->locks[i];
  uint32_t my = l.current.load(std::memory_order_relaxed);
  uint32_t next = l.ticket.load(std::memory_order_acquire);
  return (next != my + 1 && l.hand_time < kMaxHandOver) ? 1 : 0;
}

// Release local lock i.  handover_ok != 0 when the caller is willing to
// pass the global lock on.  -> 1 if handed over (caller must NOT release
// the global lock), 0 otherwise (caller releases the global lock).
SHN_EXPORT int shn_lt_release(void* h, uint64_t i, int handover_ok) {
  auto& l = ((LockTable*)h)->locks[i];
  uint32_t my = l.current.load(std::memory_order_relaxed);
  uint32_t next = l.ticket.load(std::memory_order_acquire);
  // hand over only if someone is waiting and the train isn't too long
  // (can_hand_over, Tree.cpp:1149-1167)
  bool waiter = next != my + 1;
  bool pass = handover_ok && waiter && l.hand_time < kMaxHandOver;
  if (pass) {
    l.handed_over = 1;
    l.hand_time++;
  } else {
    l.handed_over = 0;
    l.hand_time = 0;
  }
  l.current.store(my + 1, std::memory_order_release);
  return pass ? 1 : 0;
}

// ---------------------------------------------------------------------------
// WRLock — spinning writer-preference reader/writer lock (WRLock.h parity:
// the reference guards its DSM singleton and the IndexCache delay-free list
// with it).  Writers announce intent via the high bit; new readers then
// spin until the writer cycles through.
// ---------------------------------------------------------------------------

namespace {

struct WRLock {
  static constexpr uint32_t kWriter = 1u << 31;
  std::atomic<uint32_t> state{0};  // kWriter bit | reader count
};

}  // namespace

SHN_EXPORT void* shn_rw_new() { return new (std::nothrow) WRLock(); }
SHN_EXPORT void shn_rw_free(void* h) { delete (WRLock*)h; }

SHN_EXPORT void shn_rw_rlock(void* h) {
  auto& s = ((WRLock*)h)->state;
  for (;;) {
    uint32_t v = s.load(std::memory_order_relaxed);
    if (!(v & WRLock::kWriter) &&
        s.compare_exchange_weak(v, v + 1, std::memory_order_acquire))
      return;
    cpu_relax();
  }
}

SHN_EXPORT void shn_rw_runlock(void* h) {
  ((WRLock*)h)->state.fetch_sub(1, std::memory_order_release);
}

SHN_EXPORT void shn_rw_wlock(void* h) {
  auto& s = ((WRLock*)h)->state;
  // announce writer intent (writer preference: blocks new readers)...
  for (;;) {
    uint32_t v = s.load(std::memory_order_relaxed);
    if (!(v & WRLock::kWriter) &&
        s.compare_exchange_weak(v, v | WRLock::kWriter,
                                std::memory_order_acquire))
      break;
    cpu_relax();
  }
  // ...then drain the readers
  while (s.load(std::memory_order_acquire) != WRLock::kWriter) cpu_relax();
}

SHN_EXPORT void shn_rw_wunlock(void* h) {
  ((WRLock*)h)->state.store(0, std::memory_order_release);
}
