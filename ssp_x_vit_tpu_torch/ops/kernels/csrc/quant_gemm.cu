// Weight-only quantized GEMM: out[M, N] = (x[M, K] @ dequant(w)) * scale[N].
//
// Replaces the Pallas kernels of ssp_x_vit_tpu/ops/pallas/quant_matmul.py
// (_run: quant_matmul / _qmm_kernel, quant4_matmul / _qmm4_kernel and its two
// float-unpack variants, which exist only because that compiler lacks int8
// shifts; one integer unpack is enough here).
//
//   bits = 8: w is int8 [K, N].
//   bits = 4: w is int8 [K/2, N], split-half packed: byte = 16*hi + (lo + 8),
//             row r of the byte holds logical row r in its low nibble (biased
//             by +8) and logical row r + K/2 in its high nibble (two's
//             complement). lo = (byte & 15) - 8, hi = byte >> 4 (arithmetic).
//
// x and out are fp32 or bf16 (one dtype), scale is fp32 per output column.
// The product accumulates x @ w.to(x.dtype) in fp32 (integers up to 127 are
// exact in bf16), the epilogue multiplies each column by its scale and stores
// in x's dtype. The dequantised weight never exists in device memory: a K
// tile's bytes are copied to shared memory as they are and turned into bf16
// (or fp32) there on the way to the product. The K loop walks logical rows, so
// for int4 each stored row is fetched twice, once for logical row r (low
// nibble) and once for r + K/2 (high nibble): K*N bytes pass through L2 and
// shared memory for either width, and int4 halves only the weight's footprint
// in device memory (K*N/2 bytes, which a second fetch finds in L2 when the
// weight fits there). Walking stored rows and feeding both halves from one
// staged tile is later work.
//
// bf16 reuses the tile pipeline of gemm.cu: 128x128x64 tiles, 8 warps of
// 64x32 on WMMA 16x16x16, a 3-stage cp.async ring for the activation tile and
// the raw weight bytes (16-byte copies when K % 8 == 0 resp. N % 16 == 0,
// else element loads), one bf16 weight tile converted per K step, the fp32
// epilogue tile in the ring's memory, and split-K (policy in common.cuh)
// when the output tiles make less than two waves (M = 1 up to a few hundred
// rows). fp32 runs a SIMT 64x64x32 tile in exact fp32.
//
// What bounds it on the H100: 2*M*N*K FLOPs against M*K + M*N activations and
// K*N (or K*N/2) stored weight bytes. At the perplexity path's M = 2048 and up
// it is operations-bound (Llama-2-7B gate projection: 185 GFLOP against
// 22.5 MB of int4 weights plus 62 MB of activations); at M = 1 it is bound by
// the weight bytes it fetches, which for int4 is K*N as long as each stored
// row is fetched twice. WMMA on mma.sync and the extra shared-memory pass of the convert
// keep it below the tensor-core peak; wgmma with in-register dequant is later
// work.

#include <mma.h>

#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace ssp {
namespace qg {

struct Args {
  const void* x;
  const signed char* w;
  const float* scale;
  void* out;
  int m, n, k;
  int bits;        // 8 or 4
  float* partial;  // split-K: [splits, m, n] fp32 partial sums, null = no split
  int k_chunk;     // split-K: K range of blockIdx.z, a multiple of the K tile
  int x_aligned;   // 16-byte copies of x rows are safe
  int w_aligned;   // 16-byte copies of weight rows are safe
};

// Stored row that holds logical weight row gr.
__device__ __forceinline__ int stored_row(const Args& p, int gr) {
  return (p.bits == 8 || gr < p.k / 2) ? gr : gr - p.k / 2;
}

// Integer value of logical row gr from its stored byte; 0 past K.
__device__ __forceinline__ float weight_value(const Args& p, signed char byte, int gr) {
  if (gr >= p.k) return 0.f;
  const int v = byte;
  if (p.bits == 8) return static_cast<float>(v);
  return static_cast<float>(gr < p.k / 2 ? (v & 15) - 8 : v >> 4);
}

// Store one fp32 tile (row stride ldc) as scaled output, or as this split's partial sums.
template <typename T, int BM, int BN, int THREADS>
__device__ void epilogue(const Args& p, const float* cs, int ldc, int m0, int n0) {
  T* out = static_cast<T*>(p.out);
  float* part = p.partial ? p.partial + (size_t)blockIdx.z * p.m * p.n : nullptr;
  for (int e = threadIdx.x; e < BM * BN; e += THREADS) {
    const int r = e / BN, c = e % BN, gr = m0 + r, gc = n0 + c;
    if (gr >= p.m || gc >= p.n) continue;
    const size_t o = (size_t)gr * p.n + gc;
    if (part)
      part[o] = cs[r * ldc + c];
    else
      out[o] = from_f<T>(cs[r * ldc + c] * p.scale[gc]);
  }
}

template <typename T>
__global__ void split_reduce_kernel(Args p, int splits) {
  const size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  const size_t mn = (size_t)p.m * p.n;
  if (e >= mn) return;
  float v = 0.f;
  for (int z = 0; z < splits; ++z) v += p.partial[z * mn + e];
  static_cast<T*>(p.out)[e] = from_f<T>(v * p.scale[e % p.n]);
}

// ---------------------------------------------------------------- fp32 ----
namespace f32 {
constexpr int BM = 64, BN = 64, BK = 32, THREADS = 128;

__global__ void __launch_bounds__(THREADS) kernel(Args p) {
  __shared__ float as[BM][BK + 1];
  __shared__ float bs[BK][BN];
  __shared__ float cs[BM][BN + 4];
  const float* A = static_cast<const float*>(p.x);
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
      bs[r][c] = (gr < p.k && gc < p.n)
                     ? weight_value(p, p.w[(size_t)stored_row(p, gr) * p.n + gc], gr)
                     : 0.f;
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
namespace bf16 {
using T = __nv_bfloat16;
constexpr int BM = 128, BN = 128, BK = 64, THREADS = 256, STAGES = 3;
constexpr int LDA = BK + 8, LDB = BN + 8, LDC = BN + 4;
constexpr int A_STAGE = BM * LDA;  // bf16 elements
constexpr int W_STAGE = BK * BN;   // raw weight bytes
constexpr size_t W_OFF = sizeof(T) * STAGES * A_STAGE;
constexpr size_t B_OFF = W_OFF + (size_t)STAGES * W_STAGE;
constexpr size_t PIPE_BYTES = B_OFF + sizeof(T) * BK * LDB;
constexpr size_t EPI_BYTES = sizeof(float) * BM * LDC;
constexpr size_t SMEM_BYTES = PIPE_BYTES > EPI_BYTES ? PIPE_BYTES : EPI_BYTES;
static_assert(W_OFF % 128 == 0 && B_OFF % 128 == 0, "tile regions must stay 128-byte aligned");

// Stage K tile kt: the activation tile into `as`, the stored weight bytes of
// its 64 logical rows into `ws`. Out-of-range elements become zeros.
__device__ void load_tiles(const Args& p, T* as, signed char* ws, int m0, int n0, int kt) {
  const T* A = static_cast<const T*>(p.x);
  const int k0 = kt * BK, tid = threadIdx.x;
  if (p.x_aligned) {
    for (int e = tid; e < BM * BK / 8; e += THREADS) {
      const int r = e / (BK / 8), c = (e % (BK / 8)) * 8, gr = m0 + r, gc = k0 + c;
      const bool ok = gr < p.m && gc < p.k;
      cp_async16(as + r * LDA + c, ok ? A + (size_t)gr * p.k + gc : A, ok);
    }
  } else {
    const T zero = __float2bfloat16(0.f);
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK, gr = m0 + r, gc = k0 + c;
      as[r * LDA + c] = (gr < p.m && gc < p.k) ? A[(size_t)gr * p.k + gc] : zero;
    }
  }
  if (p.w_aligned) {
    for (int e = tid; e < BK * BN / 16; e += THREADS) {
      const int r = e / (BN / 16), c = (e % (BN / 16)) * 16, gr = k0 + r, gc = n0 + c;
      const bool ok = gr < p.k && gc < p.n;
      cp_async16(ws + r * BN + c, ok ? p.w + (size_t)stored_row(p, gr) * p.n + gc : p.w, ok);
    }
  } else {
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int r = e / BN, c = e % BN, gr = k0 + r, gc = n0 + c;
      ws[r * BN + c] =
          (gr < p.k && gc < p.n) ? p.w[(size_t)stored_row(p, gr) * p.n + gc] : (signed char)0;
    }
  }
}

// Raw bytes of K tile kt -> the bf16 weight tile the products read.
__device__ void convert_tile(const Args& p, const signed char* ws, T* bs, int kt) {
  const int k0 = kt * BK;
  for (int e = threadIdx.x; e < BK * BN / 4; e += THREADS) {
    const int r = e / (BN / 4), c = (e % (BN / 4)) * 4, gr = k0 + r;
    const char4 raw = *reinterpret_cast<const char4*>(ws + r * BN + c);
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(bs + r * LDB + c);
    dst[0] = __floats2bfloat162_rn(weight_value(p, raw.x, gr), weight_value(p, raw.y, gr));
    dst[1] = __floats2bfloat162_rn(weight_value(p, raw.z, gr), weight_value(p, raw.w, gr));
  }
}

__global__ void __launch_bounds__(THREADS, 2) kernel(Args p) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  T* as = reinterpret_cast<T*>(smem);
  signed char* ws = reinterpret_cast<signed char*>(smem + W_OFF);
  T* bs = reinterpret_cast<T*>(smem + B_OFF);
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
    if (s < kt_count) load_tiles(p, as + s * A_STAGE, ws + s * W_STAGE, m0, n0, kt_lo + s);
    cp_async_commit();
  }
  for (int kt = 0; kt < kt_count; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile kt landed; every warp is past the products of tile kt-1
    const int next = kt + STAGES - 1;
    if (next < kt_count)
      load_tiles(p, as + (next % STAGES) * A_STAGE, ws + (next % STAGES) * W_STAGE, m0, n0,
                 kt_lo + next);
    cp_async_commit();
    convert_tile(p, ws + (kt % STAGES) * W_STAGE, bs, kt_lo + kt);
    __syncthreads();  // the bf16 weight tile is complete
    const T* a_t = as + (kt % STAGES) * A_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> af[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> bf[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(af[i], a_t + (wm * 64 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bf[j], bs + kk * LDB + wn * 32 + j * 16, LDB);
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
}  // namespace bf16

int splits_for(int dtype, int m, int n, int k) {
  const int bm = dtype == kF32 ? f32::BM : bf16::BM, bn = dtype == kF32 ? f32::BN : bf16::BN;
  const int bk = dtype == kF32 ? f32::BK : bf16::BK;
  return split_count((long long)((m + bm - 1) / bm) * ((n + bn - 1) / bn), k, bk);
}

}  // namespace qg
}  // namespace ssp

// fp32 workspace (in floats) that ssp_quant_gemm needs for these shapes; 0 = none.
extern "C" long long ssp_quant_gemm_workspace_floats(int dtype, int m, int n, int k) {
  const int splits = ssp::qg::splits_for(dtype, m, n, k);
  return splits > 1 ? (long long)splits * m * n : 0;
}

// out[m, n] = (x[m, k] @ dequant(w)) * scale; bits 8: w [k, n], bits 4: w [k/2, n] packed.
extern "C" int ssp_quant_gemm(int dtype, int bits, const void* x, const void* w,
                              const float* scale, void* out, int m, int n, int k,
                              float* workspace, void* stream) {
  using namespace ssp;
  using namespace ssp::qg;
  if ((bits != 8 && bits != 4) || (bits == 4 && k % 2 != 0) || m <= 0 || n <= 0 || k <= 0 ||
      (dtype != kF32 && dtype != kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  const int bk = dtype == kF32 ? f32::BK : bf16::BK;
  const int k_tiles = (k + bk - 1) / bk;
  const int splits = workspace ? splits_for(dtype, m, n, k) : 1;
  const int k_chunk = std::max(1, (k_tiles + splits - 1) / splits) * bk;
  const int nsplit = std::max(1, (k + k_chunk - 1) / k_chunk);
  const bool split = nsplit > 1;
  const auto is16 = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; };
  Args p{x, static_cast<const signed char*>(w), scale, out, m, n, k, bits,
         split ? workspace : nullptr, k_chunk, k % 8 == 0 && is16(x), n % 16 == 0 && is16(w)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kF32) {
    const dim3 grid((n + f32::BN - 1) / f32::BN, (m + f32::BM - 1) / f32::BM, nsplit);
    f32::kernel<<<grid, f32::THREADS, 0, s>>>(p);
    err = cudaGetLastError();
  } else {
    static std::atomic<unsigned long long> smem_allowed{0};
    err = allow_max_dynamic_smem(bf16::kernel, smem_allowed);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((n + bf16::BN - 1) / bf16::BN, (m + bf16::BM - 1) / bf16::BM, nsplit);
    bf16::kernel<<<grid, bf16::THREADS, bf16::SMEM_BYTES, s>>>(p);
    err = cudaGetLastError();
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
