// K4, the exchange all-to-all for Hopper (sm_90a): the CUDA counterpart of
// sherman_tpu/parallel/transport_pallas.py::exchange_pallas (_exchange_kernel).
//
// The TPU kernel posts, on every node, one local DMA for its own bucket and
// N-1 one-sided remote writes after a barrier.  On one card the emulated
// nodes share device memory, so the whole exchange is one block permutation
// of the stacked send buffers x[N (source), N*C, W]:
//
//     out[d, s*C:(s+1)*C, :] = x[s, d*C:(d+1)*C, :]     for all (s, d)
//
// Each (s, d) pair is one contiguous run of C*W int32 words in both the
// source and the destination.
//
// When the nodes span R processes ("ranks") of L = N/R nodes each, a rank
// holds only its own nodes' send buffers x[L, N*C, W], and one
// all_to_all_single of the process group carries whatever crosses ranks.
// The same kernel then lays the blocks out on both sides of that
// collective, as the general block transpose out[j, i] = x[i, j] of an
// [A, B] grid of runs:
//
//     before:  x [L, R, L*C*W] -> send [R, L, L*C*W]   (A=L,   B=R)
//     after:   recv [R*L, L, C*W] -> out [L, R*L, C*W] (A=R*L, B=L)
//
// so that out[d_loc, s*C:(s+1)*C] = x_owner(s)[s_loc, d*C:(d+1)*C].  At
// R == 1 the exchange is the one N x N launch above.
//
// The kernel is bound by bytes: it reads every word once and writes it
// once, 2*A*B*run*4 bytes at 3.35 TB/s (2*N*N*C*W*4 for one rank; the same
// count for each of the two launches around a cross-rank exchange).  Its
// design meets that with straight coalesced copies: a 1-D grid over (pair,
// chunk), each block moving one chunk of a pair's run with 16-byte vectors
// when the run and both base pointers allow it (run % 4 == 0), 4-byte
// words otherwise, and UNROLL independent loads in flight per thread.
//
// This file holds no PyTorch header.  The launcher is called by
// ops/csrc/page_kernels.cpp, which checks the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;  // elements per thread per chunk
constexpr int64_t CHUNK = THREADS * UNROLL;

template <typename V>
__global__ void __launch_bounds__(THREADS)
exchange_kernel(const V* __restrict__ x, V* __restrict__ out, int64_t a,
                int64_t b, int64_t run, int64_t chunks_per_pair) {
  const int64_t blk = blockIdx.x;
  const int64_t pair = blk / chunks_per_pair;
  const int64_t chunk = blk - pair * chunks_per_pair;
  const int64_t s = pair / b;
  const int64_t d = pair - s * b;
  const V* src = x + (s * b + d) * run;
  V* dst = out + (d * a + s) * run;
  const int64_t base = chunk * CHUNK + threadIdx.x;
  V v[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int64_t i = base + u * THREADS;
    if (i < run) v[u] = __ldg(src + i);
  }
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int64_t i = base + u * THREADS;
    if (i < run) dst[i] = v[u];
  }
}

template <typename V>
void launch(const void* x, void* out, int64_t a, int64_t b, int64_t run,
            cudaStream_t stream) {
  const int64_t chunks = (run + CHUNK - 1) / CHUNK;
  const int64_t grid = a * b * chunks;
  exchange_kernel<V><<<(unsigned)grid, THREADS, 0, stream>>>(
      static_cast<const V*>(x), static_cast<V*>(out), a, b, run, chunks);
}

}  // namespace

// x: [a, b, words] and out: [b, a, words] int32, contiguous; one run of
// ``words`` moves from (i, j) to (j, i).  The one-rank exchange of
// [N, N*C, W] buffers is a = b = N, words = C*W.
void sherman_launch_exchange(const int32_t* x, int32_t* out, int64_t a,
                             int64_t b, int64_t words, cudaStream_t stream) {
  if (a == 0 || b == 0 || words == 0) return;
  const bool vec = words % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % sizeof(int4) == 0 &&
                   reinterpret_cast<uintptr_t>(out) % sizeof(int4) == 0;
  if (vec) {
    launch<int4>(x, out, a, b, words / 4, stream);
  } else {
    launch<int>(x, out, a, b, words, stream);
  }
}
