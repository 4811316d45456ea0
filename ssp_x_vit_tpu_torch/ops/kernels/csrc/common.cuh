// Shared helpers for the kernels: dtype codes, float <-> storage conversions,
// warp reductions, cp.async and the split-K policy of the GEMMs. Every kernel
// computes in fp32 and stores in the operand dtype (fp32 or bf16), as the
// Pallas kernels it replaces do.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>

namespace ssp {

// Must match DTYPE_CODES in ops/kernels/build.py.
enum DType { kF32 = 0, kBF16 = 1 };

constexpr int kMaxDevices = 64;

// Index of the current device, or -1 if none can be read.
inline int current_device() {
  int device = 0;
  return cudaGetDevice(&device) == cudaSuccess && device < kMaxDevices ? device : -1;
}

// Multiprocessor count of the current device, read from the driver once per device.
inline int sm_count() {
  static std::atomic<int> cached[kMaxDevices];
  const int device = current_device();
  if (device < 0) return 132;
  int sms = cached[device].load(std::memory_order_relaxed);
  if (sms == 0) {
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
      sms = 132;
    cached[device].store(sms, std::memory_order_relaxed);
  }
  return sms;
}

// Split K when a GEMM's output tiles alone make less than two waves on the
// card (small batches): aim for ~4 blocks per SM, each split keeping at least
// 4 K tiles of depth bk, at most 16 splits.
inline int split_count(long long tiles, int k, int bk) {
  const int sms = sm_count();
  if (tiles >= 2LL * sms) return 1;
  const long long want = (4LL * sms + tiles - 1) / tiles;
  const long long most = k / (4 * bk);
  return static_cast<int>(std::max(1LL, std::min({want, most, 16LL})));
}

// K chunk of each split under that policy (a multiple of bk) and the splits it makes.
inline void split_k(long long tiles, int k, int bk, int& splits, int& chunk) {
  const int want = split_count(tiles, k, bk);
  const int k_tiles = (k + bk - 1) / bk;
  chunk = std::max(1, (k_tiles + want - 1) / want) * bk;
  splits = std::max(1, (k + chunk - 1) / chunk);
}

// Opts `kernel` into the device's whole per-block dynamic shared memory (what
// its static shared memory leaves of it). The attribute persists, so the call
// is made once per (kernel, device) and later launches skip it; `done` keeps
// one bit per device for this kernel.
template <typename Kernel>
cudaError_t allow_max_dynamic_smem(Kernel kernel, std::atomic<unsigned long long>& done) {
  const int device = current_device();
  if (device < 0) return cudaErrorInvalidDevice;
  const unsigned long long bit = 1ull << device;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  int optin = 0;
  cudaFuncAttributes attr{};
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - static_cast<int>(attr.sharedSizeBytes));
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

// allow_max_dynamic_smem, and the largest shared-memory carveout: a kernel
// whose blocks share an SM needs it, since the carveout the driver picks by
// default may hold only one of them.
template <typename Kernel>
cudaError_t allow_shared_blocks(Kernel kernel, std::atomic<unsigned long long>& done) {
  const int device = current_device();
  if (device >= 0 && (done.load(std::memory_order_acquire) & (1ull << device))) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                           static_cast<int>(cudaSharedmemCarveoutMaxShared));
  return err != cudaSuccess ? err : allow_max_dynamic_smem(kernel, done);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 16-byte global -> shared copy that bypasses registers; valid == false
// zero-fills the 16 bytes and reads nothing.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace ssp
