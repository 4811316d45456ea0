// Fused int8 SwiGLU MLP: out[m, d] = (silu((x @ gq) * gs) * ((x @ uq) * us)) @ dq * ds.
//
// Replaces the Pallas kernel of ssp_x_vit_tpu/ops/pallas/quant_fused_mlp.py
// (fused_mlp_int8, pallas_call at line 68), whose contract is the int8 SwiGLU
// epilogue of serve._layer_step:
//
//   g = (x @ gq) * gs, u = (x @ uq) * us   fp32 accumulators and scales
//   h = silu(g) * u                        rounded once to x's dtype
//   out = (h @ dq) * ds                    fp32 accumulator, stored in x's dtype
//
// x, h and out are fp32 or bf16 (one dtype); gq, uq are int8 [d, f] with fp32
// per-column scales [f]; dq is int8 [f, d] with an fp32 scale [d]. Any d and f
// (a 2SSP-pruned f such as 8253): ragged column tiles are masked, rows whose
// start is off 16 (8) bytes take element loads.
//
// What bounds it on the H100: at decode (m = the batch, a handful of rows) the
// 3*d*f weight bytes (Llama-2-7B: 135.3 MB per layer call, 0.0404 ms at
// 3.35 TB/s); at prefill (m in the thousands) the 6*m*d*f operations
// (m = 4096: 1.11 TFLOP, 1.12 ms at 989 TFLOP/s bf16).
//
// Design. The TPU kernel walks f in order and carries the [m, d] accumulator in
// VMEM across its grid; blocks here run in no order, so the MLP is two phases
// with h [m, f] in device memory between them (at m = 8, f = 11008: 176 KB in
// bf16 against 90 MB of gate and up weights), and no atomics: every sum is
// taken in a fixed order, so a result is the same bits on every run.
//
// - m <= 16 (decode, speculative windows, beams): the skinny product. A block
//   owns 64 output columns of one weight matrix and 8 activation rows; its 256
//   threads stream the weight rows, 8 bytes (8 columns) per thread and four
//   rows in flight, convert the int8 codes in registers and multiply them into
//   fp32 accumulators against x rows staged in shared memory as fp32. The four
//   weight rows of a warp reduce by shuffles, the eight warps through shared
//   memory in warp order. Phase 1 runs gate and up as two matrices of one
//   launch, phase 2 the down projection; when the column tiles alone make less
//   than two waves (phase 2 at d = 4096: 64 tiles for 132 SMs) K is split and a
//   second pass sums the splits in order. Each product writes fp32 partial sums;
//   the epilogue pass applies the scales (phase 1: and silu * u) and rounds.
//   Weight bytes are read once for m <= 8 (rows 9-16 read them a second time).
// - m > 16 (prefill): the tile pipeline of qgemm_tile.cuh, which quant_gemm.cu
//   runs too (bf16: wgmma with the int8 weight converted to bf16 in registers
//   as the A operand, TMA loads into a 4-6 stage ring; fp32: a 64x64x32 SIMT
//   tile). Phase 1 gives it gq and uq as a pair: each consumer warpgroup
//   multiplies the gate and the up columns of the same f columns, so g and u
//   of an output sit in one thread and the epilogue computes h from the
//   registers. Phase 2 is the int8 dequant GEMM of quant_gemm.cu, with its
//   split-K plan.
//
// Not yet: one launch for the skinny phase 1 epilogue (4 launches per call at
// decode, 2-3 at prefill).

#include <algorithm>
#include <cstdint>

#include "common.cuh"
#include "qgemm_tile.cuh"

namespace ssp {
namespace fm {

constexpr int kSkinnyMaxM = 16;

// ------------------------------------------------------------- skinny ----
namespace sk {
constexpr int ROWS = 8, NT = 64, THREADS = 256, KC = 512;
constexpr int PASS = THREADS / (NT / 8);  // weight rows one pass of the block covers: 32

struct Args {
  const void* x;          // [m, k]
  const signed char* w0;  // [k, n]
  const signed char* w1;  // [k, n] or null (one matrix)
  float* partial;         // [mats][splits][m][n]
  int m, n, k;
  int k_chunk, splits, row_groups;
  int vec;                // 8-byte weight loads are safe
};

// Eight int8 codes of weight row gk at columns gc..gc+7 as floats (0 past n).
__device__ __forceinline__ void load8(const Args& p, const signed char* w, int gk, int gc,
                                      float (&wv)[8]) {
  const signed char* row = w + (size_t)gk * p.n;
  if (p.vec && gc + 8 <= p.n) {
    const int2 raw = *reinterpret_cast<const int2*>(row + gc);
    const unsigned lo = static_cast<unsigned>(raw.x), hi = static_cast<unsigned>(raw.y);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wv[j] = static_cast<float>(static_cast<signed char>(lo >> (8 * j)));
      wv[4 + j] = static_cast<float>(static_cast<signed char>(hi >> (8 * j)));
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) wv[j] = gc + j < p.n ? static_cast<float>(row[gc + j]) : 0.f;
  }
}

// grid (column tiles, splits, mats * row_groups): fp32 partial sums, no scale.
template <typename T>
__global__ void __launch_bounds__(THREADS) kernel(Args p) {
  __shared__ float xs[ROWS][KC];
  __shared__ float red[THREADS / 32][ROWS][NT];
  const int n0 = blockIdx.x * NT, split = blockIdx.y;
  const int mat = blockIdx.z / p.row_groups, r0 = (blockIdx.z % p.row_groups) * ROWS;
  const int rows = min(ROWS, p.m - r0);
  const signed char* w = mat ? p.w1 : p.w0;
  const T* X = static_cast<const T*>(p.x);
  const int tid = threadIdx.x, kr = tid / (NT / 8), gc = n0 + (tid % (NT / 8)) * 8;
  const int k_lo = split * p.k_chunk, k_hi = min(p.k, k_lo + p.k_chunk);
  float acc[ROWS][8];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

  for (int kc = k_lo; kc < k_hi; kc += KC) {
    const int kn = min(KC, k_hi - kc);
    __syncthreads();  // every thread is done with the previous chunk
    for (int e = tid; e < ROWS * KC; e += THREADS) {
      const int r = e / KC, c = e % KC;
      xs[r][c] = (r < rows && c < kn) ? to_f(X[(size_t)(r0 + r) * p.k + kc + c]) : 0.f;
    }
    __syncthreads();
    for (int kk = kr; kk < kn; kk += 4 * PASS) {
      float wv[4][8];
#pragma unroll
      for (int u = 0; u < 4; ++u) {  // four weight rows in flight before any product
        if (kk + u * PASS < kn) {
          load8(p, w, kc + kk + u * PASS, gc, wv[u]);
        } else {
#pragma unroll
          for (int c = 0; c < 8; ++c) wv[u][c] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int kx = min(kk + u * PASS, KC - 1);  // rows past kn carry zero weights
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float xv = xs[r][kx];
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(xv, wv[u][c], acc[r][c]);
        }
      }
    }
  }
  // the four weight rows of a warp (lanes l, l^8, l^16, l^24), then the warps in order
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float v = acc[r][c];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[r][c] = v;
    }
  if (lane < NT / 8) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) red[warp][r][lane * 8 + c] = acc[r][c];
  }
  __syncthreads();
  for (int e = tid; e < ROWS * NT; e += THREADS) {
    const int r = e / NT, c = e % NT;
    if (r >= rows || n0 + c >= p.n) continue;
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < THREADS / 32; ++wi) s += red[wi][r][c];
    p.partial[(((size_t)mat * p.splits + split) * p.m + r0 + r) * p.n + n0 + c] = s;
  }
}
}  // namespace sk

// Sum the splits in order; h = silu(g * gs) * (u * us) (gate partials, then up).
template <typename T>
__global__ void swiglu_reduce_kernel(const float* part, const float* gs, const float* us, T* h,
                                     int m, int n, int splits) {
  const size_t mn = (size_t)m * n;
  const size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  if (e >= mn) return;
  float g = 0.f, u = 0.f;
  for (int z = 0; z < splits; ++z) g += part[z * mn + e];
  for (int z = 0; z < splits; ++z) u += part[(splits + z) * mn + e];
  const int col = static_cast<int>(e % n);
  h[e] = from_f<T>(qtile::silu(g * gs[col]) * (u * us[col]));
}

// The launch plan of one call: a pure function of the shapes and the SM count,
// so the workspace query and the launch agree.
struct Plan {
  bool skinny;
  int row_groups;
  int splits1, chunk1;  // skinny phase 1
  int splits2, chunk2;  // skinny phase 2
  qtile::Plan wide2;    // wide phase 2 (wide phase 1 is a pair and does not split)
  long long ws_floats;
};

inline Plan plan_for(int dtype, int m, int d, int f, int wide) {
  Plan pl{};
  pl.skinny = m <= kSkinnyMaxM && !wide;
  if (pl.skinny) {
    pl.row_groups = (m + sk::ROWS - 1) / sk::ROWS;
    split_k(2LL * pl.row_groups * ((f + sk::NT - 1) / sk::NT), d, sk::PASS, pl.splits1, pl.chunk1);
    split_k((long long)pl.row_groups * ((d + sk::NT - 1) / sk::NT), f, sk::PASS, pl.splits2,
            pl.chunk2);
    pl.ws_floats = std::max(2LL * pl.splits1 * m * f, (long long)pl.splits2 * m * d);
    return pl;
  }
  pl.wide2 = qtile::plan(dtype, 8, m, d, f);
  pl.ws_floats = qtile::workspace_floats(pl.wide2, m, d);
  return pl;
}

template <typename T>
cudaError_t run_skinny(const Plan& pl, const void* x, const signed char* gq, const float* gs,
                       const signed char* uq, const float* us, const signed char* dq,
                       const float* ds, T* h, T* out, int m, int d, int f, float* ws,
                       cudaStream_t s) {
  const auto al8 = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 8 == 0; };
  sk::Args a1{x, gq, uq, ws, m, f, d, pl.chunk1, pl.splits1, pl.row_groups,
              f % 8 == 0 && al8(gq) && al8(uq)};
  sk::kernel<T><<<dim3((f + sk::NT - 1) / sk::NT, pl.splits1, 2 * pl.row_groups), sk::THREADS, 0,
                  s>>>(a1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t mf = (size_t)m * f, md = (size_t)m * d;
  swiglu_reduce_kernel<T><<<static_cast<unsigned>((mf + 255) / 256), 256, 0, s>>>(
      ws, gs, us, h, m, f, pl.splits1);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  sk::Args a2{h, dq, nullptr, ws, m, d, f, pl.chunk2, pl.splits2, pl.row_groups,
              d % 8 == 0 && al8(dq)};
  sk::kernel<T><<<dim3((d + sk::NT - 1) / sk::NT, pl.splits2, pl.row_groups), sk::THREADS, 0,
                  s>>>(a2);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  qtile::scale_reduce_kernel<T><<<static_cast<unsigned>((md + 255) / 256), 256, 0, s>>>(
      ws, ds, out, m, d, pl.splits2);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_wide(const Plan& pl, const void* x, const signed char* gq, const float* gs,
                     const signed char* uq, const float* us, const signed char* dq,
                     const float* ds, T* h, T* out, int m, int d, int f, float* ws,
                     cudaStream_t s) {
  const qtile::Args a1{x, gq, uq, gs, us, h, m, f, d, 8};
  const cudaError_t err = qtile::launch_pair<T>(a1, s);
  if (err != cudaSuccess) return err;
  const qtile::Args a2{h, dq, nullptr, ds, nullptr, out, m, d, f, 8};
  return qtile::launch<T, 8>(a2, pl.wide2, ws, s);
}

}  // namespace fm
}  // namespace ssp

// fp32 workspace (in floats) that ssp_fused_mlp_int8 needs for these shapes; 0 = none.
extern "C" long long ssp_fused_mlp_int8_workspace_floats(int dtype, int m, int d, int f, int wide) {
  return ssp::fm::plan_for(dtype, m, d, f, wide).ws_floats;
}

// out[m, d] = (silu((x @ gq) * gs) * ((x @ uq) * us)) @ dq * ds, through h [m, f].
// wide = 1 takes the tile pipeline at any m. It is a measurement hook only: the
// skinny product's yardstick at m <= 16 (ROADMAP B.7.2, which replaces it with
// a size-based route). The serving path never sets it.
extern "C" int ssp_fused_mlp_int8(int dtype, const void* x, const void* gq, const float* gs,
                                  const void* uq, const float* us, const void* dq,
                                  const float* ds, void* h, void* out, int m, int d, int f,
                                  int wide, float* workspace, void* stream) {
  using namespace ssp;
  using namespace ssp::fm;
  if (m <= 0 || d <= 0 || f <= 0 || (dtype != kF32 && dtype != kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan pl = plan_for(dtype, m, d, f, wide);
  if (pl.ws_floats > 0 && workspace == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const auto* g = static_cast<const signed char*>(gq);
  const auto* u = static_cast<const signed char*>(uq);
  const auto* dn = static_cast<const signed char*>(dq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kF32) {
    auto* hh = static_cast<float*>(h);
    auto* oo = static_cast<float*>(out);
    err = pl.skinny ? run_skinny<float>(pl, x, g, gs, u, us, dn, ds, hh, oo, m, d, f, workspace, s)
                    : run_wide<float>(pl, x, g, gs, u, us, dn, ds, hh, oo, m, d, f, workspace, s);
  } else {
    auto* hh = static_cast<__nv_bfloat16*>(h);
    auto* oo = static_cast<__nv_bfloat16*>(out);
    err = pl.skinny
              ? run_skinny<__nv_bfloat16>(pl, x, g, gs, u, us, dn, ds, hh, oo, m, d, f, workspace, s)
              : run_wide<__nv_bfloat16>(pl, x, g, gs, u, us, dn, ds, hh, oo, m, d, f, workspace, s);
  }
  return static_cast<int>(err);
}
