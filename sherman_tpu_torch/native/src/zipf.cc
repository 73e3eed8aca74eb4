// Zipfian rank sampler — native workload generator (C ABI over zipf.h).
//
// The samplers themselves live in zipf.h so the fused batch-prep pipeline
// (prep.cc) inlines them into its streaming loop.
#include <new>

#include "zipf.h"

using shn::UniformGen;
using shn::Zipf;

namespace {
using Uniform = UniformGen;
}  // namespace

SHN_EXPORT void* shn_zipf_new(uint64_t n, double theta, uint64_t seed) {
  if (n == 0) return nullptr;
  if (theta <= 0.0) return (void*)(new (std::nothrow) Uniform(n, seed));
  // tag zipf pointers with bit 0 (allocations are >= 8-aligned)
  auto* z = new (std::nothrow) Zipf(n, theta, seed);
  if (!z) return nullptr;
  return (void*)((uintptr_t)z | 1u);
}

SHN_EXPORT void shn_zipf_fill(void* h, uint64_t* out, uint64_t count) {
  if (!h) return;
  if ((uintptr_t)h & 1u) {
    auto* z = (Zipf*)((uintptr_t)h & ~(uintptr_t)1u);
    for (uint64_t i = 0; i < count; ++i) out[i] = z->next();
  } else {
    auto* u = (Uniform*)h;
    for (uint64_t i = 0; i < count; ++i) out[i] = u->next();
  }
}

SHN_EXPORT void shn_zipf_free(void* h) {
  if (!h) return;
  if ((uintptr_t)h & 1u)
    delete (Zipf*)((uintptr_t)h & ~(uintptr_t)1u);
  else
    delete (Uniform*)h;
}
