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
// source and the destination.  The kernel is bound by bytes: it reads every
// word once and writes it once, 2*N*N*C*W*4 bytes at 3.35 TB/s.  Its design
// meets that with straight coalesced copies: a 1-D grid over (pair, chunk),
// each block moving one chunk of a pair's run with 16-byte vectors when the
// run and both base pointers allow it (C*W % 4 == 0), 4-byte words
// otherwise, and UNROLL independent loads in flight per thread.
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
exchange_kernel(const V* __restrict__ x, V* __restrict__ out, int64_t n_nodes,
                int64_t run, int64_t chunks_per_pair) {
  const int64_t b = blockIdx.x;
  const int64_t pair = b / chunks_per_pair;
  const int64_t chunk = b - pair * chunks_per_pair;
  const int64_t s = pair / n_nodes;
  const int64_t d = pair - s * n_nodes;
  const V* src = x + (s * n_nodes + d) * run;
  V* dst = out + (d * n_nodes + s) * run;
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
void launch(const void* x, void* out, int64_t n_nodes, int64_t run,
            cudaStream_t stream) {
  const int64_t chunks = (run + CHUNK - 1) / CHUNK;
  const int64_t grid = n_nodes * n_nodes * chunks;
  exchange_kernel<V><<<(unsigned)grid, THREADS, 0, stream>>>(
      static_cast<const V*>(x), static_cast<V*>(out), n_nodes, run, chunks);
}

}  // namespace

// x and out: [n_nodes, n_nodes * rows_per_peer, width] int32, contiguous.
void sherman_launch_exchange(const int32_t* x, int32_t* out, int64_t n_nodes,
                             int64_t rows_per_peer, int64_t width,
                             cudaStream_t stream) {
  const int64_t words = rows_per_peer * width;  // one (source, dest) run
  if (n_nodes == 0 || words == 0) return;
  const bool vec = words % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % sizeof(int4) == 0 &&
                   reinterpret_cast<uintptr_t>(out) % sizeof(int4) == 0;
  if (vec) {
    launch<int4>(x, out, n_nodes, words / 4, stream);
  } else {
    launch<int>(x, out, n_nodes, words, stream);
  }
}
