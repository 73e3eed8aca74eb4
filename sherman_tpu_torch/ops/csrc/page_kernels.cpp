// C binding of the page kernels (page_kernels.cu) and of the exchange
// all-to-all (parallel/csrc/exchange.cu).  Each entry point runs
// on PyTorch's current stream of the tensors' device, checks the launch
// with C10_CUDA_KERNEL_LAUNCH_CHECK, and reports a failure as a nonzero
// return with the message copied into ``err`` (the Python wrapper raises
// KernelUnavailableError with it).  Only c10's CUDA headers are included,
// not torch/extension.h, so the binding compiles in seconds.
//
// Pointers arrive as raw device addresses from tensor.data_ptr(); the
// Python wrapper has already checked device, dtype, shape and contiguity.

#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>

#include <cstdint>
#include <cstring>
#include <exception>

void sherman_launch_descent_round(const int32_t* pool, int64_t P,
                                  const int32_t* addr, const int32_t* khi,
                                  const int32_t* klo, const bool* active,
                                  int64_t B, int stop_level, int32_t* nxt,
                                  bool* is_leaf, bool* chase, bool* ok,
                                  bool* found, int32_t* vhi, int32_t* vlo,
                                  cudaStream_t stream);
void sherman_launch_gather_pages(const int32_t* pool, int64_t P,
                                 const int32_t* rows, const bool* ok,
                                 int64_t M, int32_t* out,
                                 cudaStream_t stream);
void sherman_launch_writeback(int32_t* pool, int64_t P, const int32_t* page,
                              const int32_t* slot, const bool* applied,
                              const int32_t* ent, int64_t M, int L,
                              const int* field_w, cudaStream_t stream);
void sherman_launch_exchange(const int32_t* x, int32_t* out, int64_t a,
                             int64_t b, int64_t words, cudaStream_t stream);

namespace {

template <typename F>
int guarded(int device, char* err, int64_t err_len, F&& launch) {
  try {
    c10::cuda::CUDAGuard guard(static_cast<c10::DeviceIndex>(device));
    cudaStream_t stream =
        c10::cuda::getCurrentCUDAStream(static_cast<c10::DeviceIndex>(device))
            .stream();
    launch(stream);
    C10_CUDA_KERNEL_LAUNCH_CHECK();
    return 0;
  } catch (const std::exception& e) {
    if (err != nullptr && err_len > 0) {
      std::strncpy(err, e.what(), static_cast<size_t>(err_len - 1));
      err[err_len - 1] = '\0';
    }
    return 1;
  }
}

}  // namespace

extern "C" {

int sherman_descent_round(int device, const void* pool, int64_t P,
                          const void* addr, const void* khi, const void* klo,
                          const void* active, int64_t B, int stop_level,
                          void* nxt, void* is_leaf, void* chase, void* ok,
                          void* found, void* vhi, void* vlo, char* err,
                          int64_t err_len) {
  return guarded(device, err, err_len, [&](cudaStream_t s) {
    sherman_launch_descent_round(
        static_cast<const int32_t*>(pool), P,
        static_cast<const int32_t*>(addr), static_cast<const int32_t*>(khi),
        static_cast<const int32_t*>(klo), static_cast<const bool*>(active), B,
        stop_level, static_cast<int32_t*>(nxt), static_cast<bool*>(is_leaf),
        static_cast<bool*>(chase), static_cast<bool*>(ok),
        static_cast<bool*>(found), static_cast<int32_t*>(vhi),
        static_cast<int32_t*>(vlo), s);
  });
}

int sherman_gather_pages(int device, const void* pool, int64_t P,
                         const void* rows, const void* ok, int64_t M,
                         void* out, char* err, int64_t err_len) {
  return guarded(device, err, err_len, [&](cudaStream_t s) {
    sherman_launch_gather_pages(
        static_cast<const int32_t*>(pool), P,
        static_cast<const int32_t*>(rows), static_cast<const bool*>(ok), M,
        static_cast<int32_t*>(out), s);
  });
}

int sherman_writeback(int device, void* pool, int64_t P, const void* page,
                      const void* slot, const void* applied, const void* ent,
                      int64_t M, int L, const int* field_w, char* err,
                      int64_t err_len) {
  return guarded(device, err, err_len, [&](cudaStream_t s) {
    sherman_launch_writeback(
        static_cast<int32_t*>(pool), P, static_cast<const int32_t*>(page),
        static_cast<const int32_t*>(slot), static_cast<const bool*>(applied),
        static_cast<const int32_t*>(ent), M, L, field_w, s);
  });
}

int sherman_exchange(int device, const void* x, void* out, int64_t a,
                     int64_t b, int64_t words, char* err, int64_t err_len) {
  return guarded(device, err, err_len, [&](cudaStream_t s) {
    sherman_launch_exchange(static_cast<const int32_t*>(x),
                            static_cast<int32_t*>(out), a, b, words, s);
  });
}

}  // extern "C"
