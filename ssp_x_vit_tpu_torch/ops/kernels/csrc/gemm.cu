// Tiled GEMM with the fused epilogues of the ViT block kernels, plus the
// LayerNorm pass that feeds it.
//
// Replaces the matrix products inside the Pallas kernels
//   ssp_x_vit_tpu/ops/pallas/fused_attn_block.py : _kernel_v2 / _kernel
//     (LN1 -> QKV projection, out projection + gated residual)
//   ssp_x_vit_tpu/ops/pallas/fused_ffn.py : _ffn_block_kernel / _ffn_kernel
//     (LN2 -> fc1 -> GELU -> importance stats -> neuron mask, fc2 + gated residual)
//
// C[M, N] = epilogue(A[M, K] @ B[K, N]); A and C row-major activations, B a
// row-major [in, out] weight (the JAX layout).
//
//   epilogue  0 (bias):      c = acc + bias
//             1 (gelu):      h = gelu_erf(acc + bias); stats[img, n] += h^2 over
//                            the rows of image img (pre-mask, fp32);
//                            c = h * mask[n]
//             2 (residual):  c = resid + gate * (acc + bias), gate read from a
//                            device pointer (no host sync per block).
//
// ssp_layer_norm writes y = LN(x) in the operand dtype (fp32 statistics, as the
// Pallas kernels compute y in fp32 and cast it to x.dtype before the product).
//
// What bounds it on the H100: at ViT widths (M = b*197; K, N >= 768) the
// products are compute-bound (~200-400 FLOP per byte moved). bf16 runs on the
// tensor cores through WMMA (16x16x16, fp32 accumulate) on 128x128x64 tiles,
// 8 warps of 64x32, fed by a 3-stage cp.async pipeline of 16-byte copies (when
// K and N are multiples of 8; otherwise the same pipeline with synchronous
// element loads). fp32 runs a SIMT 64x64 tile with 4x8 outputs per thread, so
// fp32 stays exact fp32 (no TF32). The epilogue goes through an fp32 tile in
// shared memory. WMMA caps this below the card's wgmma/TMA rate; that, and
// keeping the [M, f] activation out of HBM between fc1 and fc2, is later work.
//
// M-tiles may span two images; the stats epilogue walks each column's rows in
// order and flushes one atomicAdd per (image, column) run, so rows are never
// padded and no stats row is shared between images.
//
// When the output tiles make less than two waves on the card (small batches,
// e.g. the b=1 latency forward), K is split over blockIdx.z: each split writes fp32
// partial sums to a caller-allocated workspace and one elementwise kernel sums
// them and applies the epilogue.

#include <mma.h>

#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace ssp {

enum Epilogue { kEpiBias = 0, kEpiGelu = 1, kEpiResidual = 2 };

struct GemmArgs {
  const void* a;
  const void* b;
  void* c;
  int m, n, k;
  int epi;
  const void* bias;   // [n] or null
  const void* resid;  // [m, n] (residual epilogue)
  const float* gate;  // scalar on device (residual epilogue), null = 1
  const float* mask;  // [n] fp32 or null (gelu epilogue)
  float* stats;       // [m / seq, n] fp32 or null (gelu epilogue)
  int seq;            // rows per image, for stats
  float* partial;     // split-K: [splits, m, n] fp32 partial sums, null = no split
  int k_chunk;        // split-K: K range of blockIdx.z, a multiple of the K tile
};

// One output element from its fp32 sum: bias, then the epilogue, stored to C.
// Returns the pre-mask GELU activation (the stats input), else 0.
template <typename T>
__device__ __forceinline__ float epilogue_element(const GemmArgs& p, float gate, int gr, int gc,
                                                  float v) {
  T* C = static_cast<T*>(p.c);
  const T* bias = static_cast<const T*>(p.bias);
  if (bias) v += to_f(bias[gc]);
  const size_t o = (size_t)gr * p.n + gc;
  if (p.epi == kEpiGelu) {
    const float h = 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
    C[o] = from_f<T>(p.mask ? h * p.mask[gc] : h);
    return h;
  }
  if (p.epi == kEpiResidual)
    C[o] = from_f<T>(to_f(static_cast<const T*>(p.resid)[o]) + gate * v);
  else
    C[o] = from_f<T>(v);
  return 0.f;
}

// Epilogue over a BM x BN fp32 tile in shared memory (row stride ldc), then
// the stats pass; under split-K, the raw tile goes to this split's partial
// sums instead. Needs THREADS == 2 * BN.
template <typename T, int BM, int BN, int THREADS>
__device__ void epilogue(const GemmArgs& p, float* cs, int ldc, int m0, int n0) {
  const int tid = threadIdx.x;
  if (p.partial) {
    float* part = p.partial + (size_t)blockIdx.z * p.m * p.n;
    for (int e = tid; e < BM * BN; e += THREADS) {
      const int r = e / BN, c = e % BN, gr = m0 + r, gc = n0 + c;
      if (gr < p.m && gc < p.n) part[(size_t)gr * p.n + gc] = cs[r * ldc + c];
    }
    return;
  }
  const float gate = p.gate ? *p.gate : 1.f;
  for (int e = tid; e < BM * BN; e += THREADS) {
    const int r = e / BN, c = e % BN, gr = m0 + r, gc = n0 + c;
    if (gr >= p.m || gc >= p.n) continue;
    // keep the pre-mask activation for the stats pass
    cs[r * ldc + c] = epilogue_element<T>(p, gate, gr, gc, cs[r * ldc + c]);
  }
  if (p.stats) {
    __syncthreads();
    // thread (half, c) walks rows [half*BM/2, (half+1)*BM/2) of column c.
    const int c = tid % BN, half = tid / BN, gc = n0 + c;
    if (gc < p.n) {
      float sum = 0.f;
      int img = -1;
      for (int r = half * (BM / 2); r < (half + 1) * (BM / 2); ++r) {
        const int gr = m0 + r;
        if (gr >= p.m) break;
        const int im = gr / p.seq;
        if (im != img) {
          if (img >= 0) atomicAdd(&p.stats[(size_t)img * p.n + gc], sum);
          img = im;
          sum = 0.f;
        }
        const float h = cs[r * ldc + c];
        sum = fmaf(h, h, sum);
      }
      if (img >= 0) atomicAdd(&p.stats[(size_t)img * p.n + gc], sum);
    }
  }
}

// Split-K: sum the partials of one element, then the same epilogue; stats
// take one atomicAdd per element.
template <typename T>
__global__ void split_reduce_kernel(GemmArgs p, int splits) {
  const size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  const size_t mn = (size_t)p.m * p.n;
  if (e >= mn) return;
  float v = 0.f;
  for (int z = 0; z < splits; ++z) v += p.partial[z * mn + e];
  const int gr = static_cast<int>(e / p.n), gc = static_cast<int>(e % p.n);
  const float h = epilogue_element<T>(p, p.gate ? *p.gate : 1.f, gr, gc, v);
  if (p.stats) atomicAdd(&p.stats[(size_t)(gr / p.seq) * p.n + gc], h * h);
}

// ---------------------------------------------------------------- fp32 ----
// SIMT: 64x64x32 tiles, 128 threads, thread (ty, tx) owns rows ty*4+r and
// columns tx+8*c.
namespace f32 {
constexpr int BM = 64, BN = 64, BK = 32, THREADS = 128;

__global__ void __launch_bounds__(THREADS) gemm_kernel(GemmArgs p) {
  __shared__ float as[BM][BK + 1];
  __shared__ float bs[BK][BN];
  __shared__ float cs[BM][BN + 4];
  const float* A = static_cast<const float*>(p.a);
  const float* B = static_cast<const float*>(p.b);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN, tid = threadIdx.x;
  const int ty = tid / 8, tx = tid % 8;
  float acc[4][8] = {};
  const int k_lo = static_cast<int>(blockIdx.z) * p.k_chunk, k_hi = min(p.k, k_lo + p.k_chunk);
  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK, gr = m0 + r, gc = k0 + c;
      as[r][c] = (gr < p.m && gc < p.k) ? A[(size_t)gr * p.k + gc] : 0.f;
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int r = e / BN, c = e % BN, gr = k0 + r, gc = n0 + c;
      bs[r][c] = (gr < p.k && gc < p.n) ? B[(size_t)gr * p.n + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[8];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = as[ty * 4 + r][kk];
#pragma unroll
      for (int c = 0; c < 8; ++c) b[c] = bs[kk][tx + 8 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) cs[ty * 4 + r][tx + 8 * c] = acc[r][c];
  __syncthreads();
  epilogue<float, BM, BN, THREADS>(p, &cs[0][0], BN + 4, m0, n0);
}
}  // namespace f32

// ---------------------------------------------------------------- bf16 ----
// WMMA: 128x128x64 tiles, 8 warps as 2 (M) x 4 (N), warp tile 64x32 = 4x2
// fragments, two blocks per SM; a STAGES-deep ring of A/B tiles in dynamic
// shared memory, reused for the fp32 epilogue tile once the main loop is done.
namespace bf16 {
using T = __nv_bfloat16;
constexpr int BM = 128, BN = 128, BK = 64, THREADS = 256, STAGES = 3;
constexpr int LDA = BK + 8, LDB = BN + 8, LDC = BN + 4;
constexpr int A_STAGE = BM * LDA, B_STAGE = BK * LDB;  // elements
constexpr size_t PIPE_BYTES = sizeof(T) * STAGES * (A_STAGE + B_STAGE);
constexpr size_t EPI_BYTES = sizeof(float) * BM * LDC;
constexpr size_t SMEM_BYTES = PIPE_BYTES > EPI_BYTES ? PIPE_BYTES : EPI_BYTES;

// Stage K tile kt of A and B into the ring slot at (as, bs): 16-byte cp.async
// when ALIGNED (K and N multiples of 8), else synchronous element loads.
// Out-of-range elements become zeros.
template <bool ALIGNED>
__device__ void load_tiles(const GemmArgs& p, T* as, T* bs, int m0, int n0, int kt) {
  const T* A = static_cast<const T*>(p.a);
  const T* B = static_cast<const T*>(p.b);
  const int k0 = kt * BK, tid = threadIdx.x;
  if (ALIGNED) {
    for (int e = tid; e < BM * BK / 8; e += THREADS) {
      const int r = e / (BK / 8), c = (e % (BK / 8)) * 8, gr = m0 + r, gc = k0 + c;
      const bool ok = gr < p.m && gc < p.k;
      cp_async16(as + r * LDA + c, ok ? A + (size_t)gr * p.k + gc : A, ok);
    }
    for (int e = tid; e < BK * BN / 8; e += THREADS) {
      const int r = e / (BN / 8), c = (e % (BN / 8)) * 8, gr = k0 + r, gc = n0 + c;
      const bool ok = gr < p.k && gc < p.n;
      cp_async16(bs + r * LDB + c, ok ? B + (size_t)gr * p.n + gc : B, ok);
    }
  } else {
    const T zero = __float2bfloat16(0.f);
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK, gr = m0 + r, gc = k0 + c;
      as[r * LDA + c] = (gr < p.m && gc < p.k) ? A[(size_t)gr * p.k + gc] : zero;
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int r = e / BN, c = e % BN, gr = k0 + r, gc = n0 + c;
      bs[r * LDB + c] = (gr < p.k && gc < p.n) ? B[(size_t)gr * p.n + gc] : zero;
    }
  }
}

template <bool ALIGNED>
__global__ void __launch_bounds__(THREADS, 2) gemm_kernel(GemmArgs p) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  T* as = reinterpret_cast<T*>(smem);
  T* bs = as + STAGES * A_STAGE;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, wm = warp / 4, wn = warp % 4;
  const int kt_lo = static_cast<int>(blockIdx.z) * p.k_chunk / BK;
  const int k_hi = min(p.k, static_cast<int>(blockIdx.z + 1) * p.k_chunk);
  const int kt_count = (k_hi - kt_lo * BK + BK - 1) / BK;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < kt_count)
      load_tiles<ALIGNED>(p, as + s * A_STAGE, bs + s * B_STAGE, m0, n0, kt_lo + s);
    cp_async_commit();
  }
  for (int kt = 0; kt < kt_count; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile kt landed; slot (kt-1) % STAGES is free again
    const int next = kt + STAGES - 1;
    if (next < kt_count)
      load_tiles<ALIGNED>(p, as + (next % STAGES) * A_STAGE, bs + (next % STAGES) * B_STAGE,
                          m0, n0, kt_lo + next);
    cp_async_commit();
    const T* a_t = as + (kt % STAGES) * A_STAGE;
    const T* b_t = bs + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> af[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> bf[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(af[i], a_t + (wm * 64 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bf[j], b_t + kk * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: reuse it for the fp32 epilogue tile
  float* cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(cs + (wm * 64 + i * 16) * LDC + wn * 32 + j * 16, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();
  epilogue<T, BM, BN, THREADS>(p, cs, LDC, m0, n0);
}

template <bool ALIGNED>
cudaError_t launch(const GemmArgs& p, cudaStream_t s) {
  static std::atomic<unsigned long long> smem_allowed{0};
  const cudaError_t err = allow_max_dynamic_smem(gemm_kernel<ALIGNED>, smem_allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.n + BN - 1) / BN, (p.m + BM - 1) / BM,
                  std::max(1, (p.k + p.k_chunk - 1) / p.k_chunk));
  gemm_kernel<ALIGNED><<<grid, THREADS, SMEM_BYTES, s>>>(p);
  return cudaGetLastError();
}
}  // namespace bf16

// LayerNorm, one warp per row: fp32 mean, then the mean squared deviation (two
// passes, as layer_norm in ops/common.py); y cast to the operand dtype.
template <typename T>
__global__ void layer_norm_kernel(const T* x, const T* g, const T* b, T* y, int m, int n,
                                  float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32, lane = threadIdx.x % 32;
  if (row >= m) return;
  const T* xr = x + (size_t)row * n;
  float s = 0.f;
  for (int i = lane; i < n; i += 32) s += to_f(xr[i]);
  const float mu = warp_sum(s) / n;
  float q = 0.f;
  for (int i = lane; i < n; i += 32) {
    const float d = to_f(xr[i]) - mu;
    q = fmaf(d, d, q);
  }
  const float rstd = rsqrtf(warp_sum(q) / n + eps);
  T* yr = y + (size_t)row * n;
  for (int i = lane; i < n; i += 32)
    yr[i] = from_f<T>((to_f(xr[i]) - mu) * rstd * to_f(g[i]) + to_f(b[i]));
}

}  // namespace ssp

extern "C" int ssp_layer_norm(int dtype, const void* x, const void* g, const void* b, void* y,
                              int m, int n, float eps, void* stream) {
  using namespace ssp;
  const int rows_per_block = 8;
  const dim3 grid((m + rows_per_block - 1) / rows_per_block);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    layer_norm_kernel<float><<<grid, 32 * rows_per_block, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g),
        static_cast<const float*>(b), static_cast<float*>(y), m, n, eps);
  else
    layer_norm_kernel<__nv_bfloat16><<<grid, 32 * rows_per_block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g),
        static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(y), m, n, eps);
  return static_cast<int>(cudaGetLastError());
}

namespace ssp {
// Split count of a GEMM of this dtype and shape (policy in common.cuh).
int split_count(int dtype, int m, int n, int k) {
  const int bm = dtype == kF32 ? f32::BM : bf16::BM, bn = dtype == kF32 ? f32::BN : bf16::BN;
  const int bk = dtype == kF32 ? f32::BK : bf16::BK;
  return split_count((long long)((m + bm - 1) / bm) * ((n + bn - 1) / bn), k, bk);
}
}  // namespace ssp

// fp32 workspace (in floats) that ssp_gemm needs for these shapes; 0 = none.
extern "C" long long ssp_gemm_workspace_floats(int dtype, int m, int n, int k) {
  const int splits = ssp::split_count(dtype, m, n, k);
  return splits > 1 ? (long long)splits * m * n : 0;
}

extern "C" int ssp_gemm(int dtype, const void* a, const void* b, void* c, int m, int n, int k,
                        int epi, const void* bias, const void* resid, const float* gate,
                        const float* mask, float* stats, int seq, float* workspace,
                        void* stream) {
  using namespace ssp;
  const int bk = dtype == kF32 ? f32::BK : bf16::BK;
  const int k_tiles = (k + bk - 1) / bk;
  const int splits = workspace ? split_count(dtype, m, n, k) : 1;
  const int k_chunk = std::max(1, (k_tiles + splits - 1) / splits) * bk;
  const int nsplit = std::max(1, (k + k_chunk - 1) / k_chunk);
  const bool split = nsplit > 1;
  GemmArgs p{a, b, c, m, n, k, epi, bias, resid, gate, mask, stats, seq,
             split ? workspace : nullptr, k_chunk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stats) {
    const cudaError_t err = cudaMemsetAsync(stats, 0, sizeof(float) * (size_t)(m / seq) * n, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaError_t err;
  if (dtype == kF32) {
    const dim3 grid((n + f32::BN - 1) / f32::BN, (m + f32::BM - 1) / f32::BM, nsplit);
    f32::gemm_kernel<<<grid, f32::THREADS, 0, s>>>(p);
    err = cudaGetLastError();
  } else {
    // 16-byte copies need every row start of A and B 16-byte aligned.
    const bool aligned = k % 8 == 0 && n % 8 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(b) % 16 == 0;
    err = aligned ? bf16::launch<true>(p, s) : bf16::launch<false>(p, s);
  }
  if (err != cudaSuccess || !split) return static_cast<int>(err);
  const size_t mn = (size_t)m * n;
  const dim3 rgrid(static_cast<unsigned>((mn + 255) / 256));
  if (dtype == kF32)
    split_reduce_kernel<float><<<rgrid, 256, 0, s>>>(p, nsplit);
  else
    split_reduce_kernel<__nv_bfloat16><<<rgrid, 256, 0, s>>>(p, nsplit);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ssp_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
