// The tile pipeline of the weight-only quantized GEMMs: quant_gemm.cu runs all
// of its products through it, quant_fused_mlp.cu its wide (m > 16) path.
//
//   out[m, n] = (x[m, k] @ w) * scale[n]     fp32 accumulator and scale
//
// x and out are fp32 or bf16 (one dtype). The weight source is either
//   - one matrix: int8 [k, n] (bits 8), or split-half packed int4 [k/2, n]
//     (bits 4; the layout is described in quant_gemm.cu), or
//   - a pair (w1 set, bits 8): tile columns [0, BN/2) come from w and
//     [BN/2, BN) from w1 at the same output columns, so one fp32 tile holds
//     the gate and up products of those columns and the epilogue stores
//     out = silu(g * scale) * (u * scale1) (the SwiGLU of quant_fused_mlp.cu).
//
// bf16 uses the tile pipeline of gemm.cu: 128x128x64 tiles, 8 warps of 64x32
// on WMMA 16x16x16, a 3-stage cp.async ring for the activation tile and the
// raw weight bytes (16-byte copies when k % 8 == 0 resp. n % 16 == 0 and the
// rows start on 16 bytes, else element loads), one bf16 weight tile converted
// per K step (integers up to 127 are exact in bf16), the fp32 epilogue tile in
// the ring's memory. fp32 runs a SIMT 64x64x32 tile in exact fp32. A single
// matrix splits K (the policy of common.cuh) when the output tiles make less
// than two waves; the splits' fp32 partial sums are added in order by a
// second pass, so the result is the same bits on every run. A pair never
// splits: its epilogue needs the whole sums. The weight source is a template
// parameter (PAIR) of the kernels, so the single-matrix tiles carry no code of
// the pair's.

#pragma once

#include <mma.h>

#include <cstdint>

#include "common.cuh"

namespace ssp {
namespace qtile {
// Internal linkage: each library that includes this header owns its kernels
// and the once-per-device shared-memory opt-in of launch_tiles() (a static of a
// template function with external linkage would be one object across every
// loaded library, and the second library would skip its own opt-in).
namespace {

struct Args {
  const void* x;          // [m, k]
  const signed char* w;   // [k, n] (bits 8) or [k/2, n] (bits 4)
  const signed char* w1;  // [k, n]: the second matrix of a pair, or null
  const float* scale;     // [n]
  const float* scale1;    // [n] of w1
  void* out;              // [m, n]
  int m, n, k;
  int bits;               // 8 or 4
  float* partial;         // split-K: [splits, m, n] fp32 partial sums, null = no split
  int k_chunk;            // split-K: K range of blockIdx.z, a multiple of the K tile
  int x_aligned;          // 16-byte copies of x rows are safe
  int w_aligned;          // 16-byte copies of weight rows are safe
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

// Output columns one tile covers.
template <bool PAIR>
__host__ __device__ constexpr int tile_cols(int bn) {
  return PAIR ? bn / 2 : bn;
}

// Stored byte of logical K row gr at column c of the tile whose first output
// column is n0; null outside the matrix.
template <bool PAIR, int BN>
__device__ __forceinline__ const signed char* weight_at(const Args& p, int gr, int n0, int c) {
  const signed char* w = p.w;
  int gc = n0 + c;
  if constexpr (PAIR) {
    if (c >= BN / 2) {
      w = p.w1;
      gc -= BN / 2;
    }
  }
  if (gr >= p.k || gc >= p.n) return nullptr;
  return w + (size_t)(PAIR ? gr : stored_row(p, gr)) * p.n + gc;
}

__device__ __forceinline__ float silu(float g) { return g / (1.f + expf(-g)); }

// Value of a staged weight byte of logical row gr: a pair's int8 code as it
// is (the loads zero-fill rows past K), else decoded by weight_value.
template <bool PAIR>
__device__ __forceinline__ float weight_code(const Args& p, signed char byte, int gr) {
  if constexpr (PAIR) return static_cast<float>(byte);
  return weight_value(p, byte, gr);
}

// Store one fp32 tile (row stride ldc): the pair's SwiGLU, the scaled output,
// or this split's partial sums.
template <typename T, int BM, int BN, int THREADS, bool PAIR>
__device__ void epilogue(const Args& p, const float* cs, int ldc, int m0, int n0) {
  T* out = static_cast<T*>(p.out);
  if constexpr (PAIR) {
    for (int e = threadIdx.x; e < BM * (BN / 2); e += THREADS) {
      const int r = e / (BN / 2), c = e % (BN / 2), gr = m0 + r, gc = n0 + c;
      if (gr >= p.m || gc >= p.n) continue;
      const float g = cs[r * ldc + c] * p.scale[gc], u = cs[r * ldc + c + BN / 2] * p.scale1[gc];
      out[(size_t)gr * p.n + gc] = from_f<T>(silu(g) * u);
    }
    return;
  }
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

// Sum the splits' partials [splits, m, n] in order; out = sum * scale.
template <typename T>
__global__ void scale_reduce_kernel(const float* part, const float* scale, T* out, int m, int n,
                                    int splits) {
  const size_t mn = (size_t)m * n;
  const size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  if (e >= mn) return;
  float v = 0.f;
  for (int z = 0; z < splits; ++z) v += part[z * mn + e];
  out[e] = from_f<T>(v * scale[e % n]);
}

// ---------------------------------------------------------------- fp32 ----
namespace f32 {
constexpr int BM = 64, BN = 64, BK = 32, THREADS = 128;

template <bool PAIR>
__global__ void __launch_bounds__(THREADS) kernel(Args p) {
  __shared__ float as[BM][BK + 1];
  __shared__ float bs[BK][BN];
  __shared__ float cs[BM][BN + 4];
  const float* A = static_cast<const float*>(p.x);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * tile_cols<PAIR>(BN), tid = threadIdx.x;
  const int ty = tid / 8, tx = tid % 8;
  float acc[4][8] = {};
  const int k_lo = static_cast<int>(blockIdx.z) * p.k_chunk, k_hi = min(p.k, k_lo + p.k_chunk);
  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK, gr = m0 + r, gc = k0 + c;
      as[r][c] = (gr < p.m && gc < p.k) ? A[(size_t)gr * p.k + gc] : 0.f;
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      const signed char* src = weight_at<PAIR, BN>(p, k0 + r, n0, c);
      bs[r][c] = src ? weight_code<PAIR>(p, *src, k0 + r) : 0.f;
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
  epilogue<float, BM, BN, THREADS, PAIR>(p, &cs[0][0], BN + 4, m0, n0);
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
static_assert((BN / 2) % 16 == 0, "a 16-byte weight copy must not straddle a pair's matrices");

// Stage K tile kt: the activation tile into `as`, the stored weight bytes of
// its 64 logical rows into `ws`. Out-of-range elements become zeros.
template <bool PAIR>
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
      const int r = e / (BN / 16), c = (e % (BN / 16)) * 16;
      const signed char* src = weight_at<PAIR, BN>(p, k0 + r, n0, c);
      cp_async16(ws + r * BN + c, src ? src : p.w, src != nullptr);
    }
  } else {
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      const signed char* src = weight_at<PAIR, BN>(p, k0 + r, n0, c);
      ws[r * BN + c] = src ? *src : static_cast<signed char>(0);
    }
  }
}

// Raw bytes of K tile kt -> the bf16 weight tile the products read.
template <bool PAIR>
__device__ void convert_tile(const Args& p, const signed char* ws, T* bs, int kt) {
  const int k0 = kt * BK;
  for (int e = threadIdx.x; e < BK * BN / 4; e += THREADS) {
    const int r = e / (BN / 4), c = (e % (BN / 4)) * 4, gr = k0 + r;
    const char4 raw = *reinterpret_cast<const char4*>(ws + r * BN + c);
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(bs + r * LDB + c);
    const float w0 = weight_code<PAIR>(p, raw.x, gr), w1 = weight_code<PAIR>(p, raw.y, gr);
    const float w2 = weight_code<PAIR>(p, raw.z, gr), w3 = weight_code<PAIR>(p, raw.w, gr);
    dst[0] = __floats2bfloat162_rn(w0, w1);
    dst[1] = __floats2bfloat162_rn(w2, w3);
  }
}

template <bool PAIR>
__global__ void __launch_bounds__(THREADS, 2) kernel(Args p) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  T* as = reinterpret_cast<T*>(smem);
  signed char* ws = reinterpret_cast<signed char*>(smem + W_OFF);
  T* bs = reinterpret_cast<T*>(smem + B_OFF);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * tile_cols<PAIR>(BN);
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
    if (s < kt_count) load_tiles<PAIR>(p, as + s * A_STAGE, ws + s * W_STAGE, m0, n0, kt_lo + s);
    cp_async_commit();
  }
  for (int kt = 0; kt < kt_count; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile kt landed; every warp is past the products of tile kt-1
    const int next = kt + STAGES - 1;
    if (next < kt_count)
      load_tiles<PAIR>(p, as + (next % STAGES) * A_STAGE, ws + (next % STAGES) * W_STAGE, m0, n0,
                 kt_lo + next);
    cp_async_commit();
    convert_tile<PAIR>(p, ws + (kt % STAGES) * W_STAGE, bs, kt_lo + kt);
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
  epilogue<T, BM, BN, THREADS, PAIR>(p, cs, LDC, m0, n0);
}
}  // namespace bf16

// ---------------------------------------------------------------- host ----
struct Plan {
  int splits, chunk;  // K splits and the K range of each
};

// The split plan of a single matrix: a pure function of the shapes and the SM
// count, so a workspace query and the launch agree.
inline Plan plan(int dtype, int m, int n, int k) {
  const int bm = dtype == kF32 ? f32::BM : bf16::BM, bn = dtype == kF32 ? f32::BN : bf16::BN;
  const int bk = dtype == kF32 ? f32::BK : bf16::BK;
  Plan pl{};
  split_k((long long)((m + bm - 1) / bm) * ((n + bn - 1) / bn), k, bk, pl.splits, pl.chunk);
  return pl;
}

inline Plan no_split(int k) { return Plan{1, k}; }

// fp32 workspace (in floats) that a launch with this plan needs; 0 = none.
inline long long workspace_floats(const Plan& pl, int m, int n) {
  return pl.splits > 1 ? (long long)pl.splits * m * n : 0;
}

// Launch the tiles of p with its weight source fixed at compile time.
template <typename T, bool PAIR>
cudaError_t launch_tiles(const Args& p, int splits, cudaStream_t s) {
  constexpr bool kF32Tile = sizeof(T) == 4;
  constexpr int bm = kF32Tile ? f32::BM : bf16::BM;
  constexpr int cols = tile_cols<PAIR>(kF32Tile ? f32::BN : bf16::BN);
  const dim3 grid((p.n + cols - 1) / cols, (p.m + bm - 1) / bm, splits);
  if constexpr (kF32Tile) {
    f32::kernel<PAIR><<<grid, f32::THREADS, 0, s>>>(p);
  } else {
    static std::atomic<unsigned long long> smem_allowed{0};
    const cudaError_t err = allow_max_dynamic_smem(bf16::kernel<PAIR>, smem_allowed);
    if (err != cudaSuccess) return err;
    bf16::kernel<PAIR><<<grid, bf16::THREADS, bf16::SMEM_BYTES, s>>>(p);
  }
  return cudaGetLastError();
}

// Launch the tiles of p (T = float or __nv_bfloat16) with plan pl, and the
// pass that sums the splits when there are several. `workspace` holds
// workspace_floats(pl, m, n) floats. A pair takes no_split.
template <typename T>
cudaError_t launch(Args p, const Plan& pl, float* workspace, cudaStream_t s) {
  const bool split = pl.splits > 1;
  if ((split && (workspace == nullptr || p.w1)) || (p.w1 && p.bits != 8))
    return cudaErrorInvalidValue;
  const auto is16 = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; };
  p.partial = split ? workspace : nullptr;
  p.k_chunk = pl.chunk;
  p.x_aligned = p.k % 8 == 0 && is16(p.x);
  p.w_aligned = p.n % 16 == 0 && is16(p.w) && (p.w1 == nullptr || is16(p.w1));
  const cudaError_t err = p.w1 ? launch_tiles<T, true>(p, pl.splits, s)
                               : launch_tiles<T, false>(p, pl.splits, s);
  if (err != cudaSuccess || !split) return err;
  const size_t mn = (size_t)p.m * p.n;
  scale_reduce_kernel<T><<<static_cast<unsigned>((mn + 255) / 256), 256, 0, s>>>(
      workspace, p.scale, static_cast<T*>(p.out), p.m, p.n, pl.splits);
  return cudaGetLastError();
}

}  // namespace
}  // namespace qtile
}  // namespace ssp
