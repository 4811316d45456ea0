// Flash attention forward: softmax(q k^T * scale [softcap] [causal] [window]) v
// for q [b, h, s, hd] and k, v [b, hkv, s, hd] (GQA-native: query head h reads
// KV head h / (h / hkv); K/V are never repeated in device memory).
//
// Replaces the three Pallas forwards of
//   ssp_x_vit_tpu/ops/pallas/flash_attention.py : flash_attention
//     (_flash_forward, _flash_forward_multihead, _flash_forward_streaming)
// which are one function in three on-chip-memory regimes. Here it is one
// kernel: a block owns one (batch, query head, 64-row query tile), walks the
// key/value tiles it needs and keeps an online softmax per query row (running
// max and sum in fp32, fp32 output accumulator, one divide per row at the
// end, as the Pallas kernel divides after P V). Numerics follow the Pallas
// kernel and sdpa_reference: fp32 logits, softcap on the scaled logits before
// the mask, mask by absolute row and column (col <= row, row - col < window,
// col < s), p rounded to v's dtype before P V, the row sum taken in fp32.
//
// Key tiles wholly above the diagonal or wholly outside the window are
// skipped, so causal attention costs about half the rectangle and a window
// O(s * window). A row may see a tile in which all its keys are masked (the
// oldest tile of a window): its running max stays -inf and the update is
// guarded, so no NaN arises.
//
// - bf16: 4 warps of 16 query rows. Q and a two-stage ring of 64-key K/V
//   tiles sit in dynamic shared memory (16-byte cp.async when hd % 8 == 0,
//   else element loads; the head dimension is zero-padded in shared memory to
//   the next of 64/80/128/256, never in device memory). S = Q K^T and
//   O += P V run on the tensor cores (WMMA 16x16x16, fp32 accumulate). The
//   logits go through a per-warp fp32 tile for the softmax (two lanes per
//   row); P comes back in bf16 through the same tile. O stays in accumulator
//   fragments; the per-row rescale and the final 1/l are applied by
//   multiplying with a fragment loaded from a 16x16 tile whose row r holds
//   the factor of row r (all accumulator fragments share one layout).
// - fp32: SIMT in exact fp32 (no TF32): 128 threads, thread (ty, tx) owns
//   query rows ty*4.. and strided columns tx + 8c of the logits tile and of O.
//
// With a non-null lse pointer (the training path) each row also stores
// m + log(l), its log-sum-exp, which the backward kernels
// (csrc/flash_attention_bwd.cu) use to recompute the probabilities.
//
// What bounds it on the H100: 4*hd FLOPs per unmasked (query, key) pair
// against q, k, v and o read or written once: operations-bound at every LLM
// shape (Llama-2-7B b=1 s=2048: 34 GFLOP against 67 MB). WMMA on mma.sync
// and a softmax that round-trips shared memory keep it well below the
// tensor-core peak; wgmma, TMA and register-resident softmax are later work.

#include <cmath>
#include <cstdint>

#include <mma.h>

#include "common.cuh"

namespace ssp {
namespace flash {

constexpr int BQ = 64, WARPS = 4, THREADS = WARPS * 32;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;     // [b, h, s] log-sum-exp of each row's logits, or null
  int b, h, hkv, s, hd;
  float scale;
  int causal;     // 0 / 1
  int window;     // <= 0: none
  float softcap;  // <= 0: none
  int aligned;    // 16-byte row starts (bf16 cp.async path)
};

// Key tiles [lo, hi) of width bk that the query rows [q0, q0 + BQ) need.
__device__ __forceinline__ void tile_range(const Args& p, int q0, int bk, int& lo, int& hi) {
  const int n_tiles = (p.s + bk - 1) / bk;
  hi = p.causal ? min(n_tiles, (min(q0 + BQ, p.s) - 1) / bk + 1) : n_tiles;
  lo = (p.causal && p.window > 0) ? max(0, q0 - p.window + 1) / bk : 0;
}

// Scaled, soft-capped logit of (row, col), or -inf where the mask removes it.
__device__ __forceinline__ float logit(const Args& p, float raw, int row, int col) {
  float x = raw * p.scale;
  if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
  bool ok = col < p.s;
  if (p.causal) {
    ok = ok && col <= row;
    if (p.window > 0) ok = ok && (row - col < p.window);
  }
  return ok ? x : -INFINITY;
}

// ------------------------------------------------ bf16 tensor-core path ---
namespace tc {
using T = __nv_bfloat16;
constexpr int BK = 64;
constexpr int LDS = BK + 4;  // fp32 logits row stride
constexpr int LDP = BK + 8;  // bf16 P row stride
// Per-warp scratch: the 16 x 64 fp32 logits; once every lane has read its
// logits, the same bytes hold P (bf16) followed by the 16x16 row-factor tile.
constexpr size_t WARP_REGION = sizeof(float) * 16 * LDS;
constexpr size_t FACTOR_OFF = sizeof(T) * 16 * LDP;
static_assert(FACTOR_OFF + sizeof(float) * 256 <= WARP_REGION, "P and the factor tile must fit");

template <int HDP>
struct Layout {
  static constexpr int LD = HDP + 8;
  static constexpr size_t Q_BYTES = sizeof(T) * BQ * LD;
  static constexpr size_t KV_STAGE = sizeof(T) * BK * LD;
  static constexpr size_t K_OFF = Q_BYTES;
  static constexpr size_t V_OFF = K_OFF + 2 * KV_STAGE;
  static constexpr size_t W_OFF = V_OFF + 2 * KV_STAGE;
  static constexpr size_t BYTES = W_OFF + WARPS * WARP_REGION;
  // the fp32 output staging of all four warps reuses the K ring at the end
  static_assert(2 * KV_STAGE >= sizeof(float) * BQ * HDP, "output staging must fit the K ring");
};

// Stage `nrows` rows of one head, starting at row0, into dst (row stride
// HDP + 8): zeros past s and past hd.
template <int HDP>
__device__ __forceinline__ void load_rows(const Args& p, T* dst, const T* src, int row0,
                                          int nrows) {
  constexpr int LD = HDP + 8;
  if (p.aligned) {
    constexpr int CH = HDP / 8;
    for (int e = threadIdx.x; e < nrows * CH; e += THREADS) {
      const int r = e / CH, c = (e % CH) * 8, gr = row0 + r;
      const bool ok = gr < p.s && c < p.hd;
      cp_async16(dst + r * LD + c, ok ? src + (size_t)gr * p.hd + c : src, ok);
    }
  } else {
    const T zero = __float2bfloat16(0.f);
    for (int e = threadIdx.x; e < nrows * HDP; e += THREADS) {
      const int r = e / HDP, c = e % HDP, gr = row0 + r;
      dst[r * LD + c] = (gr < p.s && c < p.hd) ? src[(size_t)gr * p.hd + c] : zero;
    }
  }
}

template <int HDP>
__global__ void __launch_bounds__(THREADS) kernel(Args p) {
  using namespace nvcuda;
  using L = Layout<HDP>;
  constexpr int LD = L::LD, NF = HDP / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = reinterpret_cast<T*>(smem + L::K_OFF);
  T* vs = reinterpret_cast<T*>(smem + L::V_OFF);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, r0 = warp * 16;
  unsigned char* region = smem + L::W_OFF + warp * WARP_REGION;
  float* ss = reinterpret_cast<float*>(region);
  T* ps = reinterpret_cast<T*>(region);
  float* fs = reinterpret_cast<float*>(region + FACTOR_OFF);

  // the last query tiles of a causal head have the most key tiles: start them first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ, head = blockIdx.y, batch = blockIdx.z;
  const int kvh = head / (p.h / p.hkv);
  const size_t q_off = ((size_t)batch * p.h + head) * p.s * p.hd;
  const size_t kv_off = ((size_t)batch * p.hkv + kvh) * p.s * p.hd;
  const T* Q = static_cast<const T*>(p.q) + q_off;
  const T* K = static_cast<const T*>(p.k) + kv_off;
  const T* V = static_cast<const T*>(p.v) + kv_off;
  T* O = static_cast<T*>(p.o) + q_off;
  int kt_lo, kt_hi;
  tile_range(p, q0, BK, kt_lo, kt_hi);

  load_rows<HDP>(p, qs, Q, q0, BQ);
  load_rows<HDP>(p, ks, K, kt_lo * BK, BK);
  load_rows<HDP>(p, vs, V, kt_lo * BK, BK);
  cp_async_commit();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[NF], factor;
#pragma unroll
  for (int n = 0; n < NF; ++n) wmma::fill_fragment(o[n], 0.f);
  // lanes 2r and 2r+1 share query row r of this warp; columns interleave
  const int row = lane / 2, half = lane % 2, grow = q0 + r0 + row;
  float m_run = -INFINITY, l_run = 0.f;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int st = (kt - kt_lo) & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile kt landed; every warp is done with the other stage
    if (kt + 1 < kt_hi) {
      load_rows<HDP>(p, ks + (st ^ 1) * BK * LD, K, (kt + 1) * BK, BK);
      load_rows<HDP>(p, vs + (st ^ 1) * BK * LD, V, (kt + 1) * BK, BK);
    }
    cp_async_commit();
    const T* k_t = ks + st * BK * LD;
    const T* v_t = vs + st * BK * LD;

    // S = Q K^T for this warp's 16 rows (K row-major is K^T column-major)
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < NF; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> bfr;
        wmma::load_matrix_sync(a, qs + r0 * LD + kk * 16, LD);
        wmma::load_matrix_sync(bfr, k_t + n * 16 * LD + kk * 16, LD);
        wmma::mma_sync(acc, a, bfr, acc);
      }
      wmma::store_matrix_sync(ss + n * 16, acc, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax update of row `row`, 32 interleaved columns per lane
    float sv[BK / 2];
    float mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const int c = 2 * j + half;
      sv[j] = logit(p, ss[row * LDS + c], grow, kt * BK + c);
      mt = fmaxf(mt, sv[j]);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    const float m_new = fmaxf(m_run, mt);
    float alpha = 1.f, sum = 0.f;
    if (m_new == -INFINITY) {  // every key of this row masked so far
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) sv[j] = 0.f;
    } else {
      alpha = expf(m_run - m_new);  // 0 while m_run is still -inf
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        sv[j] = expf(sv[j] - m_new);  // 0 for masked keys
        sum += sv[j];
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_run = l_run * alpha + sum;
    m_run = m_new;
    __syncwarp();  // every lane holds its logits in registers: reuse the tile
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) ps[row * LDP + 2 * j + half] = from_f<T>(sv[j]);
#pragma unroll
    for (int c = 0; c < 8; ++c) fs[row * 16 + half * 8 + c] = alpha;
    __syncwarp();

    // O = alpha * O + P V
    wmma::load_matrix_sync(factor, fs, 16, wmma::mem_row_major);
#pragma unroll
    for (int n = 0; n < NF; ++n)
#pragma unroll
      for (int e = 0; e < factor.num_elements; ++e) o[n].x[e] *= factor.x[e];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
      wmma::load_matrix_sync(a, ps + kk * 16, LDP);
#pragma unroll
      for (int n = 0; n < NF; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> bfr;
        wmma::load_matrix_sync(bfr, v_t + kk * 16 * LD + n * 16, LD);
        wmma::mma_sync(o[n], a, bfr, o[n]);
      }
    }
    __syncwarp();  // P and the factor tile are read: the next logits may overwrite them
  }

  cp_async_wait<0>();
  __syncthreads();  // the K ring is free: stage the fp32 output there
  const float inv = l_run > 0.f ? 1.f / l_run : 0.f;
  if (p.lse != nullptr && half == 0 && grow < p.s)
    p.lse[((size_t)batch * p.h + head) * p.s + grow] = l_run > 0.f ? m_run + logf(l_run) : -INFINITY;
#pragma unroll
  for (int c = 0; c < 8; ++c) fs[row * 16 + half * 8 + c] = inv;
  __syncwarp();
  wmma::load_matrix_sync(factor, fs, 16, wmma::mem_row_major);
  float* os = reinterpret_cast<float*>(smem + L::K_OFF) + warp * 16 * HDP;
#pragma unroll
  for (int n = 0; n < NF; ++n) {
#pragma unroll
    for (int e = 0; e < factor.num_elements; ++e) o[n].x[e] *= factor.x[e];
    wmma::store_matrix_sync(os + n * 16, o[n], HDP, wmma::mem_row_major);
  }
  __syncwarp();
  for (int e = lane; e < 16 * HDP; e += 32) {
    const int r = e / HDP, c = e % HDP, gr = q0 + r0 + r;
    if (gr < p.s && c < p.hd) O[(size_t)gr * p.hd + c] = from_f<T>(os[r * HDP + c]);
  }
}

template <int HDP>
cudaError_t launch(const Args& p, cudaStream_t stream) {
  static std::atomic<unsigned long long> smem_allowed{0};
  const cudaError_t err = allow_max_dynamic_smem(kernel<HDP>, smem_allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.s + BQ - 1) / BQ, p.h, p.b);
  kernel<HDP><<<grid, THREADS, Layout<HDP>::BYTES, stream>>>(p);
  return cudaGetLastError();
}
}  // namespace tc

// ------------------------------------------------------- fp32 SIMT path ---
namespace simt {

template <int HDP, int BK>
struct Layout {
  static constexpr int LDH = HDP + 1, LDS = BK + 1;
  static constexpr int Q_OFF = 0, K_OFF = BQ * LDH, V_OFF = K_OFF + BK * LDH;
  static constexpr int S_OFF = V_OFF + BK * LDH, F_OFF = S_OFF + BQ * LDS;
  static constexpr size_t BYTES = sizeof(float) * (F_OFF + BQ);
};

template <int HDP>
__device__ __forceinline__ void load_rows(const Args& p, float* dst, const float* src, int row0,
                                          int nrows) {
  constexpr int LDH = HDP + 1;
  for (int e = threadIdx.x; e < nrows * HDP; e += THREADS) {
    const int r = e / HDP, c = e % HDP, gr = row0 + r;
    dst[r * LDH + c] = (gr < p.s && c < p.hd) ? src[(size_t)gr * p.hd + c] : 0.f;
  }
}

template <int HDP, int BK>
__global__ void __launch_bounds__(THREADS) kernel(Args p) {
  using L = Layout<HDP, BK>;
  constexpr int LDH = L::LDH, LDS = L::LDS, SC = BK / 8, OC = HDP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  float* qs = sm + L::Q_OFF;
  float* ks = sm + L::K_OFF;
  float* vs = sm + L::V_OFF;
  float* ss = sm + L::S_OFF;
  float* fac = sm + L::F_OFF;
  const int tid = threadIdx.x, ty = tid / 8, tx = tid % 8;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ, head = blockIdx.y, batch = blockIdx.z;
  const int kvh = head / (p.h / p.hkv);
  const size_t q_off = ((size_t)batch * p.h + head) * p.s * p.hd;
  const size_t kv_off = ((size_t)batch * p.hkv + kvh) * p.s * p.hd;
  const float* Q = static_cast<const float*>(p.q) + q_off;
  const float* K = static_cast<const float*>(p.k) + kv_off;
  const float* V = static_cast<const float*>(p.v) + kv_off;
  float* O = static_cast<float*>(p.o) + q_off;
  int kt_lo, kt_hi;
  tile_range(p, q0, BK, kt_lo, kt_hi);

  float o[4][OC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < OC; ++c) o[i][c] = 0.f;
  // threads 2r and 2r+1 keep the online softmax state of query row r
  const int prow = tid / 2, phalf = tid % 2;
  float m_run = -INFINITY, l_run = 0.f;

  load_rows<HDP>(p, qs, Q, q0, BQ);
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    __syncthreads();  // the previous tile's K, V and P are read
    load_rows<HDP>(p, ks, K, kt * BK, BK);
    load_rows<HDP>(p, vs, V, kt * BK, BK);
    __syncthreads();

    float acc[4][SC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < SC; ++c) acc[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HDP; ++d) {
      float a[4], bcol[SC];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty * 4 + i) * LDH + d];
#pragma unroll
      for (int c = 0; c < SC; ++c) bcol[c] = ks[(tx + 8 * c) * LDH + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < SC; ++c) acc[i][c] = fmaf(a[i], bcol[c], acc[i][c]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < SC; ++c)
        ss[(ty * 4 + i) * LDS + tx + 8 * c] =
            logit(p, acc[i][c], q0 + ty * 4 + i, kt * BK + tx + 8 * c);
    __syncthreads();

    {
      float* srow = ss + prow * LDS;
      float mt = -INFINITY;
      for (int j = phalf; j < BK; j += 2) mt = fmaxf(mt, srow[j]);
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      const float m_new = fmaxf(m_run, mt);
      float alpha = 1.f, sum = 0.f;
      if (m_new == -INFINITY) {
        for (int j = phalf; j < BK; j += 2) srow[j] = 0.f;
      } else {
        alpha = expf(m_run - m_new);
        for (int j = phalf; j < BK; j += 2) {
          const float e = expf(srow[j] - m_new);
          srow[j] = e;
          sum += e;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      l_run = l_run * alpha + sum;
      m_run = m_new;
      if (phalf == 0) fac[prow] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = fac[ty * 4 + i];
#pragma unroll
      for (int c = 0; c < OC; ++c) o[i][c] *= a;
    }
#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ss[(ty * 4 + i) * LDS + j];
#pragma unroll
      for (int c = 0; c < OC; ++c) {
        const float vv = vs[j * LDH + tx + 8 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i][c] = fmaf(pv[i], vv, o[i][c]);
      }
    }
  }
  __syncthreads();
  if (phalf == 0) fac[prow] = l_run > 0.f ? 1.f / l_run : 0.f;
  if (p.lse != nullptr && phalf == 0 && q0 + prow < p.s)
    p.lse[((size_t)batch * p.h + head) * p.s + q0 + prow] =
        l_run > 0.f ? m_run + logf(l_run) : -INFINITY;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = q0 + ty * 4 + i;
    if (gr >= p.s) continue;
    const float inv = fac[ty * 4 + i];
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      const int gc = tx + 8 * c;
      if (gc < p.hd) O[(size_t)gr * p.hd + gc] = o[i][c] * inv;
    }
  }
}

template <int HDP, int BK>
cudaError_t launch(const Args& p, cudaStream_t stream) {
  static std::atomic<unsigned long long> smem_allowed{0};
  const cudaError_t err = allow_max_dynamic_smem(kernel<HDP, BK>, smem_allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.s + BQ - 1) / BQ, p.h, p.b);
  kernel<HDP, BK><<<grid, THREADS, Layout<HDP, BK>::BYTES, stream>>>(p);
  return cudaGetLastError();
}
}  // namespace simt

}  // namespace flash
}  // namespace ssp

// q [b, h, s, hd], k/v [b, hkv, s, hd], o [b, h, s, hd], all contiguous and of
// one dtype. window <= 0 and softcap <= 0 mean none. hd up to 256. lse, when
// not null, receives the fp32 [b, h, s] log-sum-exp of each row's logits (-inf
// for a row with no key) for the backward kernels; the no-grad callers pass null.
extern "C" int ssp_flash_attention(int dtype, const void* q, const void* k, const void* v,
                                   void* o, int b, int h, int hkv, int s, int hd, float scale,
                                   int causal, int window, float softcap, float* lse,
                                   void* stream) {
  using namespace ssp;
  using namespace ssp::flash;
  if (b <= 0 || h <= 0 || hkv <= 0 || s <= 0 || hd <= 0 || hd > 256 || h % hkv != 0 ||
      h > 65535 || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto is16 = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; };
  const int aligned = hd % 8 == 0 && is16(q) && is16(k) && is16(v);
  const Args p{q, k, v, o, lse, b, h, hkv, s, hd, scale, causal, window, softcap, aligned};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kBF16) {
    if (hd <= 64) err = tc::launch<64>(p, st);
    else if (hd <= 80) err = tc::launch<80>(p, st);
    else if (hd <= 128) err = tc::launch<128>(p, st);
    else err = tc::launch<256>(p, st);
  } else if (dtype == kF32) {
    if (hd <= 64) err = simt::launch<64, 64>(p, st);
    else if (hd <= 80) err = simt::launch<80, 64>(p, st);
    else if (hd <= 128) err = simt::launch<128, 64>(p, st);
    else err = simt::launch<256, 32>(p, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
