// Helpers several kernels share: the 16-byte cp.async into shared memory
// and its wait (K0, K03, K13, K1, K4), and the size of one resident wave of
// blocks of threads (K1, K4).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace jdtc_common {

// 16 bytes from device memory to shared memory, both 16-byte aligned, in
// flight until cp_async_wait_all.
static __device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

static __device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One resident wave of `kernel`'s blocks of threads (`smem` bytes of
// dynamic shared memory each) for `n_tiles` tiles: as many blocks as the
// card holds at once, at most n_tiles.
template <typename Kernel>
static cudaError_t wave(Kernel kernel, int threads, int64_t n_tiles, int smem, unsigned* blocks) {
  int dev = 0;
  int sms = 0;
  int per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  const int64_t w = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  *blocks = static_cast<unsigned>(n_tiles < w ? n_tiles : w);
  return cudaSuccess;
}

}  // namespace jdtc_common
