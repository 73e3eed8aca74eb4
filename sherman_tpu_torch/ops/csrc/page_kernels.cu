// Page-engine kernels for Hopper (sm_90a): the CUDA counterparts of the
// Pallas kernels in sherman_tpu/ops/pallas_page.py.
//
//   descent_round  <- pallas_page.py::descent_round (_descent_kernel)
//   gather_pages   <- pallas_page.py::gather_pages  (_gather_kernel)
//   writeback      <- pallas_page.py::writeback     (_writeback_kernel)
//
// All three are bound by device-memory bytes, not operations, on their
// inputs; what each design does about the work it is handed:
//
// descent_round.  Bound: each active row's addr, khi and klo (12 B), one
//   mask byte and 16 B of verdicts per row, and 1 KB per distinct page the
//   ok rows read; ~6 integer operations on each of the 82 entry and 49
//   slot words of an ok row stay far below the bytes (at the YCSB-C round
//   1, 4,194,304 rows of which 1,509,712 active: ~1.29 GB, 0.384 ms at
//   3.35 TB/s).  A row that is not ok (inactive, or its page past the
//   pool) has constant verdicts -- the search of a zero page: nxt = 0,
//   chase = true (no unsigned key is below (0, 0)), the rest false or 0 --
//   so it never gets a warp.  A block of 256 threads takes a tile of 256
//   rows (fewer, down to 32, where the batch is too small to give every
//   block slot of the card a tile): one thread a row reads `active` (and
//   `addr` only where active), the ok rows are compacted into a shared
//   list with a ballot and a popc, and their keys are loaded there,
//   coalesced.  Each of the 8 warps then walks
//   every 8th listed row with a 3-deep ring of 1 KB page buffers filled by
//   16-byte cp.async copies, so two pages are in flight while one is
//   searched.  The search is one ballot per 32 entry slots (the `le` bits
//   of all 82 slots in three words, the edge bits `le & ~le_next` from
//   them with shifts: one pass over the entry keys, no second read for
//   `le_next`), one ballot-free pass over the 49 leaf slots and three
//   __reduce_add_sync.  Verdicts are staged in shared memory and stored by
//   one thread a row, one coalesced store per output array.
//
// gather_pages.  Copies 1 KB per row; one warp per row, two 16-byte loads
//   per lane.
//
// writeback.  Bound: the mask (1 B a row), and per applied row its page,
//   slot and L entry words read and L words written: M + n_app * (8 + 8L)
//   bytes (12.9 MB on one node, 0.0039 ms; below a launch's overhead).
//   What holds it in practice is the scattered 4-byte stores, each to its
//   own 32-byte sector of a random page, and on a sparse mask the launch
//   and the pass over the mask.  One thread a row: it reads its mask byte
//   and leaves when the row is not applied; an applied row's page, slot
//   and L entries are loaded before its L stores.  No thread is spent on a
//   lane, no divide by L is made at run time, and a dense run of applied
//   rows (an owner's incoming buffer holds its rows in runs) is spread
//   over as many threads, and blocks, as it has rows.  Wider threads
//   measured slower on the card: 16 rows a thread with a warp's applied
//   rows listed in shared memory (a dense run falls on a few warps that
//   make several dependent passes each), and 4 rows a thread each with
//   its own rows (a cheaper pass over the mask, but a dense run crowds
//   fewer SMs).  Contract: two applied rows may target the same word only
//   with equal values (the delete clears a key's version word once for
//   each of its rows); their stores then race harmlessly, so no row is
//   deduplicated here.
//
// This file holds no PyTorch header: it compiles in seconds with nvcc.
// The launchers below are called by page_kernels.cpp, which checks every
// launch with C10_CUDA_KERNEL_LAUNCH_CHECK.  Index math is 64-bit
// (page * 256 passes 2^31 words at 8 M pages).

#include <cuda_runtime.h>
#include <stdint.h>

#include <stdexcept>

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

constexpr int WARPS = 8;            // warps per block
constexpr int ROWS = WARPS * 32;    // descent rows per block, one a thread
constexpr int STAGES = 3;           // page buffers per warp
constexpr unsigned FULL = 0xffffffffu;

// An unsigned (hi, lo) key pair as one 64-bit value: pair order is the
// order of these values.
__device__ __forceinline__ uint64_t key64(int32_t hi, int32_t lo) {
  return ((uint64_t)(uint32_t)hi << 32) | (uint32_t)lo;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 1) : "memory");
}

// Start the copy of one 1 KB page into a warp's ring buffer: two 16-byte
// cp.async per lane.
__device__ __forceinline__ void fetch_page(int32_t* dst, const int32_t* pool,
                                           int32_t page, int lane) {
  const int4* src = reinterpret_cast<const int4*>(pool + (int64_t)page * PW);
  int4* d = reinterpret_cast<int4*>(dst);
  cp_async16(d + lane, src + lane);
  cp_async16(d + lane + 32, src + lane + 32);
}

// Verdicts of one ok row, staged for the block's coalesced store.
struct Staged {
  int32_t nxt[ROWS];
  int32_t vhi[ROWS];
  int32_t vlo[ROWS];
  uint8_t flags[ROWS];   // bit 0 is_leaf, bit 1 chase, bit 2 found
};

// Search one page with the whole warp; lane 0 stages the verdicts of block
// row ``t``.  Bit-exact with layout.py on any page, garbage included: the
// child is the int32-wrapping sum of ptr over every edge slot (``le`` masked
// by the signed slot < nkeys), leftmost when no slot is le; the leaf values
// are the wrapping sums over every live slot holding the key.
__device__ __forceinline__ void search_page(const int32_t* pg, int32_t khi,
                                            int32_t klo, int stop_level,
                                            int lane, int t, Staged& out) {
  const uint64_t key = key64(khi, klo);
  const bool chase = !(key < key64(pg[W_HIGH_HI], pg[W_HIGH_LO]));
  const int32_t n = pg[W_NKEYS];

  // le bits of slots [32j, 32j + 32) in le_bits[j]; slots >= ICAP are 0.
  unsigned le_bits[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int s = lane + 32 * j;
    const bool le = s < ICAP && s < n &&
                    key64(pg[I_KHI_W + s], pg[I_KLO_W + s]) <= key;
    le_bits[j] = __ballot_sync(FULL, le);
  }
  uint32_t csum = 0;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const unsigned le_next =
        (le_bits[j] >> 1) | (j < 2 ? le_bits[j + 1] << 31 : 0u);
    if (((le_bits[j] & ~le_next) >> lane) & 1u)
      csum += (uint32_t)pg[I_PTR_W + lane + 32 * j];
  }

  uint32_t sh = 0, sl = 0;
  bool hit_any = false;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int s = lane + 32 * j;
    if (s < LCAP) {
      const uint32_t v = (uint32_t)pg[L_VER_W + s];
      // live iff fver == rver != 0
      if ((v >> 16) == (v & 0xFFFFu) && v != 0 && pg[L_KHI_W + s] == khi &&
          pg[L_KLO_W + s] == klo) {
        sh += (uint32_t)pg[L_VHI_W + s];
        sl += (uint32_t)pg[L_VLO_W + s];
        hit_any = true;
      }
    }
  }
  csum = __reduce_add_sync(FULL, csum);
  sh = __reduce_add_sync(FULL, sh);
  sl = __reduce_add_sync(FULL, sl);
  hit_any = __any_sync(FULL, hit_any);

  if (lane == 0) {
    const bool any_le = (le_bits[0] | le_bits[1] | le_bits[2]) != 0;
    const int32_t child = any_le ? (int32_t)csum : pg[W_LEFTMOST];
    out.nxt[t] = chase ? pg[W_SIBLING] : child;
    out.vhi[t] = (int32_t)sh;
    out.vlo[t] = (int32_t)sl;
    out.flags[t] = (uint8_t)((pg[W_LEVEL] == stop_level && !chase) |
                             (chase << 1) | (hit_any << 2));
  }
}

__global__ void __launch_bounds__(ROWS)
descent_round_kernel(const int32_t* __restrict__ pool, int64_t P,
                     const int32_t* __restrict__ addr,
                     const int32_t* __restrict__ khi,
                     const int32_t* __restrict__ klo,
                     const bool* __restrict__ active, int64_t B,
                     int stop_level, int32_t* __restrict__ nxt_out,
                     bool* __restrict__ leaf_out, bool* __restrict__ chase_out,
                     bool* __restrict__ ok_out, bool* __restrict__ found_out,
                     int32_t* __restrict__ vhi_out,
                     int32_t* __restrict__ vlo_out, int tile) {
  __shared__ __align__(16) int32_t ring[WARPS][STAGES][PW];
  __shared__ int32_t list_page[ROWS];   // the block's ok rows, compacted
  __shared__ int32_t list_khi[ROWS];
  __shared__ int32_t list_klo[ROWS];
  __shared__ uint8_t list_t[ROWS];      // ... and their thread (row) index
  __shared__ int warp_ok[WARPS];
  __shared__ Staged out;

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int64_t row = (int64_t)blockIdx.x * tile + t;

  // 1. One thread a row: validity, then the ok rows' list.
  const bool in = t < tile && row < B;
  const bool act = in && active[row];
  const int32_t page = act ? (addr[row] & ADDR_PAGE_MASK) : 0;
  const bool ok = act && page < P;
  const unsigned ok_bits = __ballot_sync(FULL, ok);
  if (lane == 0) warp_ok[warp] = __popc(ok_bits);
  __syncthreads();
  int n_ok = 0, base = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    base += w < warp ? warp_ok[w] : 0;
    n_ok += warp_ok[w];
  }
  if (ok) {
    const int i = base + __popc(ok_bits & ((1u << lane) - 1u));
    list_page[i] = page;
    list_khi[i] = khi[row];
    list_klo[i] = klo[row];
    list_t[i] = (uint8_t)t;
  }
  __syncthreads();

  // 2. Warp w searches listed rows w, w + 8, ...: the fetch of the row
  // STAGES - 1 turns ahead is started before the current row's page is
  // waited for.  Row k of the warp is in cp.async group k (one commit per
  // turn, empty when there is nothing left to fetch).
  int32_t(*buf)[PW] = ring[warp];
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) {
    const int i = warp + k * WARPS;
    if (i < n_ok) fetch_page(buf[k], pool, list_page[i], lane);
    cp_async_commit();
  }
  int cur = 0;
  for (int i = warp; i < n_ok; i += WARPS) {
    const int ahead = i + (STAGES - 1) * WARPS;
    const int fill = cur == 0 ? STAGES - 1 : cur - 1;
    if (ahead < n_ok) fetch_page(buf[fill], pool, list_page[ahead], lane);
    cp_async_commit();
    cp_async_wait_ring();
    __syncwarp();
    search_page(buf[cur], list_khi[i], list_klo[i], stop_level, lane,
                list_t[i], out);
    __syncwarp();   // the buffer is refilled next turn
    cur = cur == STAGES - 1 ? 0 : cur + 1;
  }
  __syncthreads();

  // 3. One thread a row: the verdicts, coalesced; constants where not ok.
  if (in) {
    int32_t nxt = 0, vh = 0, vl = 0;
    unsigned fl = 2u;   // chase
    if (ok) {
      nxt = out.nxt[t];
      vh = out.vhi[t];
      vl = out.vlo[t];
      fl = out.flags[t];
    }
    nxt_out[row] = nxt;
    leaf_out[row] = fl & 1u;
    chase_out[row] = (fl >> 1) & 1u;
    ok_out[row] = ok;
    found_out[row] = (fl >> 2) & 1u;
    vhi_out[row] = vh;
    vlo_out[row] = vl;
  }
}

// Snapshot gather: out[r] = pool[clip(rows[r], 0, P-1)], or a zero row
// where ``ok`` is given and false (read_pages_local's contract, fused).
__global__ void __launch_bounds__(WARPS * 32)
gather_pages_kernel(const int32_t* __restrict__ pool, int64_t P,
                    const int32_t* __restrict__ rows,
                    const bool* __restrict__ ok, int64_t M,
                    int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (r >= M) return;
  int64_t page = rows[r];
  page = page < 0 ? 0 : (page > P - 1 ? P - 1 : page);
  int4* dst = reinterpret_cast<int4*>(out + r * PW);
  if (ok == nullptr || ok[r]) {
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

struct FieldW {
  int w[5];
};

// In-place multi-lane write-back: one thread a row.  A thread whose row is
// applied loads the row's page, slot and L entries, all before its first
// store, then makes its L stores.
template <int L>
__global__ void __launch_bounds__(WARPS * 32)
writeback_kernel(int32_t* __restrict__ pool, int64_t P,
                 const int32_t* __restrict__ page,
                 const int32_t* __restrict__ slot,
                 const bool* __restrict__ applied,
                 const int32_t* __restrict__ ent, int64_t M, FieldW fw) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= M || !applied[r]) return;
  int64_t pg = page[r];
  const int32_t s = slot[r];
  int32_t e[L];
#pragma unroll
  for (int l = 0; l < L; ++l) e[l] = ent[r * L + l];
  pg = pg < 0 ? 0 : (pg > P - 1 ? P - 1 : pg);
  int32_t* dst = pool + pg * PW + s;
#pragma unroll
  for (int l = 0; l < L; ++l) dst[fw.w[l]] = e[l];
}

}  // namespace

void sherman_launch_descent_round(const int32_t* pool, int64_t P,
                                  const int32_t* addr, const int32_t* khi,
                                  const int32_t* klo, const bool* active,
                                  int64_t B, int stop_level, int32_t* nxt,
                                  bool* is_leaf, bool* chase, bool* ok,
                                  bool* found, int32_t* vhi, int32_t* vlo,
                                  cudaStream_t stream) {
  if (B == 0) return;
  if (reinterpret_cast<uintptr_t>(pool) % 16 != 0)
    throw std::invalid_argument("descent_round: pool is not 16-byte aligned");
  // Rows per block: 256, or fewer (a multiple of 32) where that many rows
  // would not give every block slot of the card a block.
  static const int blocks_per_sm = [] {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, descent_round_kernel,
                                                  ROWS, 0);
    return n > 0 ? n : 1;
  }();
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t slots = (int64_t)(sms > 0 ? sms : 1) * blocks_per_sm;
  int64_t tile = ((B + slots - 1) / slots + 31) / 32 * 32;
  tile = tile < ROWS ? tile : ROWS;
  const int64_t grid = (B + tile - 1) / tile;
  descent_round_kernel<<<(unsigned)grid, ROWS, 0, stream>>>(
      pool, P, addr, khi, klo, active, B, stop_level, nxt, is_leaf, chase,
      ok, found, vhi, vlo, (int)tile);
}

void sherman_launch_gather_pages(const int32_t* pool, int64_t P,
                                 const int32_t* rows, const bool* ok,
                                 int64_t M, int32_t* out,
                                 cudaStream_t stream) {
  if (M == 0) return;
  const int64_t grid = (M + WARPS - 1) / WARPS;
  gather_pages_kernel<<<(unsigned)grid, WARPS * 32, 0, stream>>>(
      pool, P, rows, ok, M, out);
}

void sherman_launch_writeback(int32_t* pool, int64_t P, const int32_t* page,
                              const int32_t* slot, const bool* applied,
                              const int32_t* ent, int64_t M, int L,
                              const int* field_w, cudaStream_t stream) {
  if (M == 0) return;
  FieldW fw{};
  for (int l = 0; l < L; ++l) fw.w[l] = field_w[l];
  const unsigned grid = (unsigned)((M + WARPS * 32 - 1) / (WARPS * 32));
  switch (L) {
#define SHERMAN_WB(n)                                                      \
  case n:                                                                  \
    writeback_kernel<n><<<grid, WARPS * 32, 0, stream>>>(                  \
        pool, P, page, slot, applied, ent, M, fw);                         \
    break;
    SHERMAN_WB(1)
    SHERMAN_WB(2)
    SHERMAN_WB(3)
    SHERMAN_WB(4)
    SHERMAN_WB(5)
#undef SHERMAN_WB
    default:
      throw std::invalid_argument("writeback: want 1..5 lanes");
  }
}
