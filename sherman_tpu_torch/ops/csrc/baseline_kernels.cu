// The first Hopper designs of descent_round and writeback, kept beside the
// current ones (page_kernels.cu) as timing yardsticks: chip_smoke.py times
// them on the same inputs as the current kernels (``ms_before``) and runs
// two ablations of the descent round.  Nothing on the serving path calls
// them.
//
//   descent_round: one warp per row, active or not; the page is loaded into
//     the warp's shared buffer, searched in five strided passes with three
//     __reduce_add_sync and two __any_sync, and lane 0 stores seven words.
//     mode 0 runs it as it was; mode 1 (ablation) fetches the page and
//     stores header words, with no search.
//   writeback: one thread per (row, lane), each reading applied[row].
//
// Plain C interface (no PyTorch header): chip_smoke.py builds this file
// with nvcc alone and binds it with ctypes.  Each entry point returns the
// launch's cudaGetLastError() as an int.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PW = 256;
constexpr int32_t ADDR_PAGE_MASK = (1 << 24) - 1;
constexpr int W_LEFTMOST = 1;
constexpr int W_SIBLING = 2;
constexpr int W_LEVEL = 3;
constexpr int W_NKEYS = 4;
constexpr int W_HIGH_HI = 7;
constexpr int W_HIGH_LO = 8;
constexpr int W_ENTRIES = 9;
constexpr int ICAP = 82;
constexpr int LCAP = 49;
constexpr int I_KHI_W = W_ENTRIES;
constexpr int I_KLO_W = I_KHI_W + ICAP;
constexpr int I_PTR_W = I_KLO_W + ICAP;
constexpr int L_VER_W = W_ENTRIES;
constexpr int L_KHI_W = L_VER_W + LCAP;
constexpr int L_KLO_W = L_KHI_W + LCAP;
constexpr int L_VHI_W = L_KLO_W + LCAP;
constexpr int L_VLO_W = L_VHI_W + LCAP;

constexpr int WARPS = 8;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool key_lt(uint32_t ahi, uint32_t alo,
                                       uint32_t bhi, uint32_t blo) {
  return ahi < bhi || (ahi == bhi && alo < blo);
}

__device__ __forceinline__ bool key_le(uint32_t ahi, uint32_t alo,
                                       uint32_t bhi, uint32_t blo) {
  return ahi < bhi || (ahi == bhi && alo <= blo);
}

__device__ __forceinline__ void load_page(int4* dst, const int32_t* pool,
                                          int64_t page, bool ok, int lane) {
  if (ok) {
    const int4* src = reinterpret_cast<const int4*>(pool + page * PW);
    int4 a = __ldg(src + lane);
    int4 b = __ldg(src + lane + 32);
    dst[lane] = a;
    dst[lane + 32] = b;
  } else {
    int4 z = make_int4(0, 0, 0, 0);
    dst[lane] = z;
    dst[lane + 32] = z;
  }
}

template <bool SEARCH>
__global__ void __launch_bounds__(WARPS * 32)
descent_round_kernel(const int32_t* __restrict__ pool, int64_t P,
                     const int32_t* __restrict__ addr,
                     const int32_t* __restrict__ khi,
                     const int32_t* __restrict__ klo,
                     const bool* __restrict__ active, int64_t B,
                     int stop_level, int32_t* __restrict__ nxt_out,
                     bool* __restrict__ leaf_out, bool* __restrict__ chase_out,
                     bool* __restrict__ ok_out, bool* __restrict__ found_out,
                     int32_t* __restrict__ vhi_out,
                     int32_t* __restrict__ vlo_out) {
  __shared__ __align__(16) int32_t smem[WARPS][PW];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * WARPS + warp;
  if (row >= B) return;

  const int64_t page = addr[row] & ADDR_PAGE_MASK;
  const bool ok = active[row] && page < P;
  int32_t* pg = smem[warp];
  load_page(reinterpret_cast<int4*>(pg), pool, page, ok, lane);
  __syncwarp();

  const uint32_t kh = (uint32_t)khi[row];
  const uint32_t kl = (uint32_t)klo[row];
  const bool chase = !key_lt(kh, kl, (uint32_t)pg[W_HIGH_HI],
                             (uint32_t)pg[W_HIGH_LO]);
  if (!SEARCH) {
    if (lane == 0) {
      nxt_out[row] = chase ? pg[W_SIBLING] : pg[W_LEFTMOST];
      leaf_out[row] = pg[W_LEVEL] == stop_level && !chase;
      chase_out[row] = chase;
      ok_out[row] = ok;
      found_out[row] = false;
      vhi_out[row] = pg[W_NKEYS];
      vlo_out[row] = pg[lane + 32];
    }
    return;
  }
  const int32_t n = pg[W_NKEYS];

  uint32_t csum = 0;
  bool any_le = false;
  for (int s = lane; s < ICAP; s += 32) {
    const bool le = s < n && key_le((uint32_t)pg[I_KHI_W + s],
                                    (uint32_t)pg[I_KLO_W + s], kh, kl);
    const bool le_next = s + 1 < ICAP && s + 1 < n &&
                         key_le((uint32_t)pg[I_KHI_W + s + 1],
                                (uint32_t)pg[I_KLO_W + s + 1], kh, kl);
    if (le && !le_next) csum += (uint32_t)pg[I_PTR_W + s];
    any_le |= le;
  }
  csum = __reduce_add_sync(FULL, csum);
  any_le = __any_sync(FULL, any_le);

  uint32_t sh = 0, sl = 0;
  bool hit_any = false;
  for (int s = lane; s < LCAP; s += 32) {
    const int32_t v = pg[L_VER_W + s];
    const int32_t fv = (v >> 16) & 0xFFFF;
    const int32_t rv = v & 0xFFFF;
    const bool hit = fv == rv && fv != 0 &&
                     (uint32_t)pg[L_KHI_W + s] == kh &&
                     (uint32_t)pg[L_KLO_W + s] == kl;
    if (hit) {
      sh += (uint32_t)pg[L_VHI_W + s];
      sl += (uint32_t)pg[L_VLO_W + s];
    }
    hit_any |= hit;
  }
  sh = __reduce_add_sync(FULL, sh);
  sl = __reduce_add_sync(FULL, sl);
  hit_any = __any_sync(FULL, hit_any);

  if (lane == 0) {
    const int32_t child = any_le ? (int32_t)csum : pg[W_LEFTMOST];
    nxt_out[row] = chase ? pg[W_SIBLING] : child;
    leaf_out[row] = pg[W_LEVEL] == stop_level && !chase;
    chase_out[row] = chase;
    ok_out[row] = ok;
    found_out[row] = hit_any;
    vhi_out[row] = (int32_t)sh;
    vlo_out[row] = (int32_t)sl;
  }
}

struct FieldW {
  int w[5];
};

__global__ void writeback_kernel(int32_t* __restrict__ pool, int64_t P,
                                 const int32_t* __restrict__ page,
                                 const int32_t* __restrict__ slot,
                                 const bool* __restrict__ applied,
                                 const int32_t* __restrict__ ent, int64_t M,
                                 int L, FieldW fw) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= M * L) return;
  const int64_t r = t / L;
  const int l = (int)(t - r * L);
  if (!applied[r]) return;
  int64_t pg = page[r];
  pg = pg < 0 ? 0 : (pg > P - 1 ? P - 1 : pg);
  pool[pg * PW + fw.w[l] + slot[r]] = ent[t];
}

}  // namespace

extern "C" {

int baseline_descent_round(int mode, const void* pool, int64_t P,
                           const void* addr, const void* khi, const void* klo,
                           const void* active, int64_t B, int stop_level,
                           void* nxt, void* is_leaf, void* chase, void* ok,
                           void* found, void* vhi, void* vlo, void* stream) {
  if (B == 0) return 0;
  const unsigned grid = (unsigned)((B + WARPS - 1) / WARPS);
  auto s = static_cast<cudaStream_t>(stream);
  auto kernel = mode == 0 ? descent_round_kernel<true>
                          : descent_round_kernel<false>;
  kernel<<<grid, WARPS * 32, 0, s>>>(
      static_cast<const int32_t*>(pool), P, static_cast<const int32_t*>(addr),
      static_cast<const int32_t*>(khi), static_cast<const int32_t*>(klo),
      static_cast<const bool*>(active), B, stop_level,
      static_cast<int32_t*>(nxt), static_cast<bool*>(is_leaf),
      static_cast<bool*>(chase), static_cast<bool*>(ok),
      static_cast<bool*>(found), static_cast<int32_t*>(vhi),
      static_cast<int32_t*>(vlo));
  return (int)cudaGetLastError();
}

int baseline_writeback(void* pool, int64_t P, const void* page,
                       const void* slot, const void* applied, const void* ent,
                       int64_t M, int L, const int* field_w, void* stream) {
  if (M == 0) return 0;
  FieldW fw{};
  for (int l = 0; l < L; ++l) fw.w[l] = field_w[l];
  const int threads = 256;
  const unsigned grid = (unsigned)((M * L + threads - 1) / threads);
  writeback_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(pool), P, static_cast<const int32_t*>(page),
      static_cast<const int32_t*>(slot), static_cast<const bool*>(applied),
      static_cast<const int32_t*>(ent), M, L, fw);
  return (int)cudaGetLastError();
}

}  // extern "C"
