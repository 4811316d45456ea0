// Flash attention backward: dq, dk, dv of out = softmax(mask(softcap(q k^T *
// scale))) v from (q, k, v, out, dout) and the forward's fp32 row
// log-sum-exp lse [b, h, s], for q [b, h, s, hd] and k, v [b, hkv, s, hd].
//
// Replaces the Pallas backwards of
//   ssp_x_vit_tpu/ops/pallas/flash_attention.py : _flash_backward_pallas
//     (single pass, K/V resident) and _flash_backward_streaming (a dq pass that
//     also emits lse and delta, then a dk/dv pass)
// which are one function in two on-chip-memory regimes. Here the forward
// stores lse, and two kernels cover every shape:
//
// - dq kernel: one block per (batch, query head, 64-row query tile). Its
//   prologue computes delta = rowsum(dout * out) in fp32 for the tile's rows
//   and stores it for the dk/dv kernel. It walks the key tiles the causal mask
//   and the window leave, recomputes p = exp(logit - lse) and
//   ds = p * (dp - delta) with dp = dout . v (times 1 - tanh^2 under a
//   softcap), and accumulates ds k in fp32.
// - dk/dv kernel: one block per (batch, KV head, 64-row key tile), which walks
//   every member of the query group and every query tile that reaches the key
//   tile: dv += p^T dout, dk += ds^T q, both in fp32. The GQA group sum
//   happens inside the block, K/V are never repeated and no atomics are used,
//   so the backward is deterministic.
//
// Numerics follow the Pallas kernels: fp32 logits, softcap on the scaled
// logits before the mask, p and ds rounded to the operand dtype before their
// products (fp32 accumulate), dq and dk scaled once at the end. A row that no
// key reaches has lse = -inf and gets p = 0 (the Pallas denominator guard);
// rows and columns past s are masked, never read as data.
//
// - bf16: 4 warps of 16 rows, WMMA 16x16x16 with fp32 accumulators. Q/dO (dq
//   kernel) or K/V (dk/dv kernel) stay in shared memory; the other pair
//   streams through a two-stage cp.async ring (one stage at head_dim 256).
//   The logits and dp go through per-warp fp32 tiles for the elementwise step;
//   p and ds come back in bf16 tiles for the next products. At head_dim 256
//   the dk/dv kernel splits the output columns over two blocks (128 each), so
//   its accumulators fit the registers; each block recomputes the logits.
// - fp32: SIMT in exact fp32 (no TF32), 128 threads, thread (ty, tx) owning
//   rows ty*4.. and strided columns tx + 8c, as the forward.
//
// What bounds it on the H100: the function needs 10*hd FLOPs per unmasked
// (query, key) pair (logits, dp, dq, dk, dv: 2*hd each, as the Pallas cost
// estimate counts) against q, k, v, o, dout, dq, dk, dv moved once, so it is
// operations-bound at every LLM shape. The two kernels execute 14*hd (both
// recompute the logits and dp); WMMA on mma.sync and the shared-memory
// elementwise step keep it below the tensor-core peak; wgmma, TMA and
// register-resident tiles are later work.

#include <cmath>
#include <cstdint>
#include <initializer_list>

#include <mma.h>

#include "common.cuh"

namespace ssp {
namespace flash_bwd {

constexpr int BQ = 64, BKV = 64, WARPS = 4, THREADS = WARPS * 32;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // [b, h, s] from the forward
  float* delta;      // [b, h, s]: written by the dq kernel, read by the dk/dv kernel
  void* dq;
  void* dk;
  void* dv;
  int b, h, hkv, s, hd;
  float scale;
  int causal;     // 0 / 1
  int window;     // <= 0: none
  float softcap;  // <= 0: none
  int aligned;    // 16-byte row starts (bf16 cp.async path)
};

// Key tiles [lo, hi) of width bk that query rows [q0, q0 + BQ) reach.
__device__ __forceinline__ void key_range(const Args& p, int q0, int bk, int& lo, int& hi) {
  const int n = (p.s + bk - 1) / bk;
  hi = p.causal ? min(n, (min(q0 + BQ, p.s) - 1) / bk + 1) : n;
  lo = (p.causal && p.window > 0) ? max(0, q0 - p.window + 1) / bk : 0;
}

// Query tiles [lo, hi) of height bq that reach key rows [k0, k0 + BKV).
__device__ __forceinline__ void query_range(const Args& p, int k0, int bq, int& lo, int& hi) {
  const int n = (p.s + bq - 1) / bq;
  lo = p.causal ? k0 / bq : 0;
  hi = n;
  if (p.causal && p.window > 0) {
    const int kend = min(k0 + BKV, p.s) - 1;
    hi = min(n, (kend + p.window - 1) / bq + 1);
  }
}

// ds of one (query row, key col) pair from its raw q.k product and dp = dout.v;
// prob receives p. Both are 0 where the mask removes the pair, past s, or for
// a row that no key reaches (lse = -inf).
__device__ __forceinline__ float grad_logit(const Args& p, float raw, float dp, int row, int col,
                                            float lse, float delta, float& prob) {
  float x = raw * p.scale, dcap = 1.f;
  if (p.softcap > 0.f) {
    const float t = tanhf(x / p.softcap);
    x = p.softcap * t;
    dcap = 1.f - t * t;
  }
  bool ok = col < p.s && row < p.s && lse != -INFINITY;
  if (p.causal) {
    ok = ok && col <= row;
    if (p.window > 0) ok = ok && (row - col < p.window);
  }
  prob = ok ? expf(x - lse) : 0.f;
  return prob * (dp - delta) * dcap;
}

// ------------------------------------------------ bf16 tensor-core path ---
namespace tc {
using T = __nv_bfloat16;
constexpr int LDS = BKV + 4;  // fp32 tile row stride
constexpr int LDP = BKV + 8;  // bf16 tile row stride
constexpr size_t F32_TILE = sizeof(float) * 16 * LDS;
constexpr size_t BF_TILE = sizeof(T) * 16 * LDP;

// Shared memory of both kernels: two resident 64-row tiles (Q and dO, or K and
// V), two rings of ST 64-row tiles (K and V, or Q and dO), per-warp scratch
// (logits, dp: fp32; p, ds: bf16), then ST x 64 lse and delta values.
template <int HDP>
struct Layout {
  static constexpr int LD = HDP + 8;
  static constexpr int ST = HDP <= 128 ? 2 : 1;
  static constexpr size_t TILE = sizeof(T) * 64 * LD;
  static constexpr size_t RING_OFF = 2 * TILE;
  static constexpr size_t RING2_OFF = RING_OFF + ST * TILE;
  static constexpr size_t W_OFF = RING2_OFF + ST * TILE;
  static constexpr size_t WARP_BYTES = 2 * F32_TILE + 2 * BF_TILE;
  static constexpr size_t STAT_OFF = W_OFF + WARPS * WARP_BYTES;
  static constexpr size_t BYTES = STAT_OFF + sizeof(float) * 2 * ST * 64;
  // the fp32 output staging of all four warps reuses the two rings at the end
  static_assert(2 * ST * TILE >= sizeof(float) * 64 * HDP, "output staging must fit the rings");
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

using Acc = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>;
using RowA = nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16, T, nvcuda::wmma::row_major>;
using RowB = nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16, T, nvcuda::wmma::row_major>;
using ColB = nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16, T, nvcuda::wmma::col_major>;

// s_out = a_rows b_rows^T and d_out = c_rows d_rows^T for one warp's 16 rows
// against 64 tile rows (row-major [64, HDP] is the transpose column-major),
// stored as fp32 16 x 64 tiles of row stride LDS.
template <int HDP>
__device__ __forceinline__ void two_products(const T* a, const T* b, const T* c, const T* d,
                                             float* s_out, float* d_out) {
  using namespace nvcuda;
  constexpr int LD = HDP + 8, NF = HDP / 16;
#pragma unroll
  for (int n = 0; n < BKV / 16; ++n) {
    Acc sacc, dacc;
    wmma::fill_fragment(sacc, 0.f);
    wmma::fill_fragment(dacc, 0.f);
#pragma unroll
    for (int kk = 0; kk < NF; ++kk) {
      RowA fa;
      ColB fb;
      wmma::load_matrix_sync(fa, a + kk * 16, LD);
      wmma::load_matrix_sync(fb, b + n * 16 * LD + kk * 16, LD);
      wmma::mma_sync(sacc, fa, fb, sacc);
      wmma::load_matrix_sync(fa, c + kk * 16, LD);
      wmma::load_matrix_sync(fb, d + n * 16 * LD + kk * 16, LD);
      wmma::mma_sync(dacc, fa, fb, dacc);
    }
    wmma::store_matrix_sync(s_out + n * 16, sacc, LDS, wmma::mem_row_major);
    wmma::store_matrix_sync(d_out + n * 16, dacc, LDS, wmma::mem_row_major);
  }
}

// Write one warp's 16 x NC fp32 accumulators (times `mul`) to rows row0.. and
// columns c0.. of a [s, hd] bf16 matrix through the warp's staging tile.
template <int NC>
__device__ __forceinline__ void store_rows(const Args& p, Acc* acc, float mul, float* stage,
                                           T* dst, int row0, int c0) {
  using namespace nvcuda;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int n = 0; n < NC / 16; ++n) {
#pragma unroll
    for (int e = 0; e < acc[n].num_elements; ++e) acc[n].x[e] *= mul;
    wmma::store_matrix_sync(stage + n * 16, acc[n], NC, wmma::mem_row_major);
  }
  __syncwarp();
  for (int e = lane; e < 16 * NC; e += 32) {
    const int r = e / NC, c = e % NC, gr = row0 + r;
    if (gr < p.s && c0 + c < p.hd) dst[(size_t)gr * p.hd + c0 + c] = from_f<T>(stage[r * NC + c]);
  }
  __syncwarp();
}

template <int HDP>
__global__ void __launch_bounds__(THREADS) dq_kernel(Args p) {
  using namespace nvcuda;
  using L = Layout<HDP>;
  constexpr int LD = L::LD, NF = HDP / 16, ST = L::ST;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = reinterpret_cast<T*>(smem + L::TILE);
  T* ks = reinterpret_cast<T*>(smem + L::RING_OFF);
  T* vs = reinterpret_cast<T*>(smem + L::RING2_OFF);
  float* dl = reinterpret_cast<float*>(smem + L::STAT_OFF);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, r0 = warp * 16;
  unsigned char* region = smem + L::W_OFF + warp * L::WARP_BYTES;
  float* ss = reinterpret_cast<float*>(region);
  float* dps = reinterpret_cast<float*>(region + F32_TILE);
  T* dss = reinterpret_cast<T*>(region + 2 * F32_TILE);

  // the last query tiles of a causal head have the most key tiles: start them first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ, head = blockIdx.y, batch = blockIdx.z;
  const int kvh = head / (p.h / p.hkv);
  const size_t row_off = ((size_t)batch * p.h + head) * p.s;
  const size_t kv_off = ((size_t)batch * p.hkv + kvh) * p.s * p.hd;
  const T* Q = static_cast<const T*>(p.q) + row_off * p.hd;
  const T* dO = static_cast<const T*>(p.dout) + row_off * p.hd;
  const T* O = static_cast<const T*>(p.o) + row_off * p.hd;
  const T* K = static_cast<const T*>(p.k) + kv_off;
  const T* V = static_cast<const T*>(p.v) + kv_off;
  int kt_lo, kt_hi;
  key_range(p, q0, BKV, kt_lo, kt_hi);

  load_rows<HDP>(p, qs, Q, q0, BQ);
  load_rows<HDP>(p, dos, dO, q0, BQ);
  load_rows<HDP>(p, ks, K, kt_lo * BKV, BKV);
  load_rows<HDP>(p, vs, V, kt_lo * BKV, BKV);
  cp_async_commit();

  // delta = rowsum(dout * out) of this warp's 16 rows, lanes over the head dim
  for (int r = 0; r < 16; ++r) {
    const int gr = q0 + r0 + r;
    float acc = 0.f;
    if (gr < p.s)
      for (int c = lane; c < p.hd; c += 32)
        acc += to_f(dO[(size_t)gr * p.hd + c]) * to_f(O[(size_t)gr * p.hd + c]);
    acc = warp_sum(acc);
    if (lane == 0) {
      dl[r0 + r] = acc;
      if (gr < p.s) p.delta[row_off + gr] = acc;
    }
  }
  __syncwarp();
  // lanes 2r and 2r+1 share query row r of this warp; columns interleave
  const int row = lane / 2, half = lane % 2, grow = q0 + r0 + row;
  const float lse = grow < p.s ? p.lse[row_off + grow] : -INFINITY;
  const float delta = dl[r0 + row];

  Acc acc[NF];
#pragma unroll
  for (int n = 0; n < NF; ++n) wmma::fill_fragment(acc[n], 0.f);

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int st = ST == 2 ? (kt - kt_lo) & 1 : 0;
    cp_async_wait<0>();
    __syncthreads();  // tile kt landed; every warp is done with the other stage
    if (ST == 2) {
      if (kt + 1 < kt_hi) {
        load_rows<HDP>(p, ks + (st ^ 1) * BKV * LD, K, (kt + 1) * BKV, BKV);
        load_rows<HDP>(p, vs + (st ^ 1) * BKV * LD, V, (kt + 1) * BKV, BKV);
      }
      cp_async_commit();
    }
    const T* k_t = ks + st * BKV * LD;
    const T* v_t = vs + st * BKV * LD;

    two_products<HDP>(qs + r0 * LD, k_t, dos + r0 * LD, v_t, ss, dps);
    __syncwarp();
#pragma unroll 4
    for (int j = 0; j < BKV / 2; ++j) {
      const int c = 2 * j + half;
      float prob;
      const float ds = grad_logit(p, ss[row * LDS + c], dps[row * LDS + c], grow, kt * BKV + c,
                                  lse, delta, prob);
      dss[row * LDP + c] = from_f<T>(ds);
    }
    __syncwarp();

    // dq += ds k
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      RowA fa;
      wmma::load_matrix_sync(fa, dss + kk * 16, LDP);
#pragma unroll
      for (int n = 0; n < NF; ++n) {
        RowB fb;
        wmma::load_matrix_sync(fb, k_t + kk * 16 * LD + n * 16, LD);
        wmma::mma_sync(acc[n], fa, fb, acc[n]);
      }
    }
    if (ST == 1) {
      __syncthreads();  // every warp is done with the single stage
      if (kt + 1 < kt_hi) {
        load_rows<HDP>(p, ks, K, (kt + 1) * BKV, BKV);
        load_rows<HDP>(p, vs, V, (kt + 1) * BKV, BKV);
      }
      cp_async_commit();
    }
  }

  cp_async_wait<0>();
  __syncthreads();  // the rings are free: stage the fp32 output there
  float* stage = reinterpret_cast<float*>(smem + L::RING_OFF) + warp * 16 * HDP;
  store_rows<HDP>(p, acc, p.scale, stage, static_cast<T*>(p.dq) + row_off * p.hd, q0 + r0, 0);
}

template <int HDP>
__global__ void __launch_bounds__(THREADS) dkv_kernel(Args p) {
  using namespace nvcuda;
  using L = Layout<HDP>;
  constexpr int LD = L::LD, ST = L::ST;
  constexpr int NC = HDP < 128 ? HDP : 128, NCF = NC / 16, CHUNKS = HDP / NC;
  extern __shared__ __align__(128) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = reinterpret_cast<T*>(smem + L::TILE);
  T* qs = reinterpret_cast<T*>(smem + L::RING_OFF);
  T* dos = reinterpret_cast<T*>(smem + L::RING2_OFF);
  float* lse_s = reinterpret_cast<float*>(smem + L::STAT_OFF);
  float* delta_s = lse_s + ST * 64;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, r0 = warp * 16;
  unsigned char* region = smem + L::W_OFF + warp * L::WARP_BYTES;
  float* ss = reinterpret_cast<float*>(region);
  float* dps = reinterpret_cast<float*>(region + F32_TILE);
  T* pts = reinterpret_cast<T*>(region + 2 * F32_TILE);
  T* dsts = reinterpret_cast<T*>(region + 2 * F32_TILE + BF_TILE);

  const int k0 = (blockIdx.x / CHUNKS) * BKV, c0 = (blockIdx.x % CHUNKS) * NC;
  const int kvh = blockIdx.y, batch = blockIdx.z, rep = p.h / p.hkv;
  const size_t kv_off = ((size_t)batch * p.hkv + kvh) * p.s * p.hd;
  const T* K = static_cast<const T*>(p.k) + kv_off;
  const T* V = static_cast<const T*>(p.v) + kv_off;
  int qt_lo, qt_hi;
  query_range(p, k0, BQ, qt_lo, qt_hi);
  const int nqt = qt_hi - qt_lo, n_it = rep * nqt;

  // (group member, query tile) of iteration it into ring stage st
  auto stage_in = [&](int it, int st) {
    const int head = kvh * rep + it / nqt, q0 = (qt_lo + it % nqt) * BQ;
    const size_t row_off = ((size_t)batch * p.h + head) * p.s;
    load_rows<HDP>(p, qs + st * BQ * LD, static_cast<const T*>(p.q) + row_off * p.hd, q0, BQ);
    load_rows<HDP>(p, dos + st * BQ * LD, static_cast<const T*>(p.dout) + row_off * p.hd, q0,
                   BQ);
    for (int i = threadIdx.x; i < BQ; i += THREADS) {
      const int gr = q0 + i;
      lse_s[st * 64 + i] = gr < p.s ? p.lse[row_off + gr] : -INFINITY;
      delta_s[st * 64 + i] = gr < p.s ? p.delta[row_off + gr] : 0.f;
    }
  };

  load_rows<HDP>(p, ks, K, k0, BKV);
  load_rows<HDP>(p, vs, V, k0, BKV);
  if (n_it > 0) stage_in(0, 0);
  cp_async_commit();

  Acc dk[NCF], dv[NCF];
#pragma unroll
  for (int n = 0; n < NCF; ++n) {
    wmma::fill_fragment(dk[n], 0.f);
    wmma::fill_fragment(dv[n], 0.f);
  }
  // lanes 2r and 2r+1 share key row r of this warp; query columns interleave
  const int row = lane / 2, half = lane % 2, gkey = k0 + r0 + row;

  for (int it = 0; it < n_it; ++it) {
    const int st = ST == 2 ? it & 1 : 0;
    cp_async_wait<0>();
    __syncthreads();  // stage it landed; every warp is done with the other stage
    if (ST == 2) {
      if (it + 1 < n_it) stage_in(it + 1, st ^ 1);
      cp_async_commit();
    }
    const T* q_t = qs + st * BQ * LD;
    const T* do_t = dos + st * BQ * LD;
    const float* lse_t = lse_s + st * 64;
    const float* delta_t = delta_s + st * 64;
    const int q0 = (qt_lo + it % nqt) * BQ;

    // logits^T = K Q^T and dp^T = V dO^T for this warp's 16 keys
    two_products<HDP>(ks + r0 * LD, q_t, vs + r0 * LD, do_t, ss, dps);
    __syncwarp();
#pragma unroll 4
    for (int j = 0; j < BQ / 2; ++j) {
      const int c = 2 * j + half;
      float prob;
      const float ds = grad_logit(p, ss[row * LDS + c], dps[row * LDS + c], q0 + c, gkey,
                                  lse_t[c], delta_t[c], prob);
      pts[row * LDP + c] = from_f<T>(prob);
      dsts[row * LDP + c] = from_f<T>(ds);
    }
    __syncwarp();

    // dv += p^T dout, dk += ds^T q over this block's output columns
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      RowA fp, fds;
      wmma::load_matrix_sync(fp, pts + kk * 16, LDP);
      wmma::load_matrix_sync(fds, dsts + kk * 16, LDP);
#pragma unroll
      for (int n = 0; n < NCF; ++n) {
        RowB fb;
        wmma::load_matrix_sync(fb, do_t + kk * 16 * LD + c0 + n * 16, LD);
        wmma::mma_sync(dv[n], fp, fb, dv[n]);
        wmma::load_matrix_sync(fb, q_t + kk * 16 * LD + c0 + n * 16, LD);
        wmma::mma_sync(dk[n], fds, fb, dk[n]);
      }
    }
    if (ST == 1) {
      __syncthreads();  // every warp is done with the single stage
      if (it + 1 < n_it) stage_in(it + 1, 0);
      cp_async_commit();
    }
  }

  cp_async_wait<0>();
  __syncthreads();  // the rings are free: stage the fp32 outputs there
  float* stage = reinterpret_cast<float*>(smem + L::RING_OFF) + warp * 16 * NC;
  store_rows<NC>(p, dk, p.scale, stage, static_cast<T*>(p.dk) + kv_off, k0 + r0, c0);
  store_rows<NC>(p, dv, 1.f, stage, static_cast<T*>(p.dv) + kv_off, k0 + r0, c0);
}

template <int HDP>
cudaError_t launch_dq(const Args& p, cudaStream_t stream) {
  static std::atomic<unsigned long long> smem_allowed{0};
  const cudaError_t err = allow_max_dynamic_smem(dq_kernel<HDP>, smem_allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.s + BQ - 1) / BQ, p.h, p.b);
  dq_kernel<HDP><<<grid, THREADS, Layout<HDP>::BYTES, stream>>>(p);
  return cudaGetLastError();
}

template <int HDP>
cudaError_t launch_dkv(const Args& p, cudaStream_t stream) {
  static std::atomic<unsigned long long> smem_allowed{0};
  const cudaError_t err = allow_max_dynamic_smem(dkv_kernel<HDP>, smem_allowed);
  if (err != cudaSuccess) return err;
  const int chunks = HDP <= 128 ? 1 : HDP / 128;
  const dim3 grid((p.s + BKV - 1) / BKV * chunks, p.hkv, p.b);
  dkv_kernel<HDP><<<grid, THREADS, Layout<HDP>::BYTES, stream>>>(p);
  return cudaGetLastError();
}
}  // namespace tc

// ------------------------------------------------------- fp32 SIMT path ---
namespace simt {

template <int HDP>
__device__ __forceinline__ void load_rows(const Args& p, float* dst, const float* src, int row0,
                                          int nrows) {
  constexpr int LDH = HDP + 1;
  for (int e = threadIdx.x; e < nrows * HDP; e += THREADS) {
    const int r = e / HDP, c = e % HDP, gr = row0 + r;
    dst[r * LDH + c] = (gr < p.s && c < p.hd) ? src[(size_t)gr * p.hd + c] : 0.f;
  }
}

// dq kernel: Q, dO (64 rows), a BK-row K and V tile, the ds tile, delta.
template <int HDP, int BK>
struct DqLayout {
  static constexpr int LDH = HDP + 1, LDS = BK + 1;
  static constexpr int DO_OFF = BQ * LDH, K_OFF = 2 * BQ * LDH, V_OFF = K_OFF + BK * LDH;
  static constexpr int S_OFF = V_OFF + BK * LDH, D_OFF = S_OFF + BQ * LDS;
  static constexpr size_t BYTES = sizeof(float) * (D_OFF + BQ);
};

// dk/dv kernel: K, V (64 rows), a BQ2-row Q and dO tile, p^T and ds^T, lse and delta.
template <int HDP, int BQ2>
struct DkvLayout {
  static constexpr int LDH = HDP + 1, LDS = BQ2 + 1;
  static constexpr int V_OFF = BKV * LDH, Q_OFF = 2 * BKV * LDH, DO_OFF = Q_OFF + BQ2 * LDH;
  static constexpr int P_OFF = DO_OFF + BQ2 * LDH, DS_OFF = P_OFF + BKV * LDS;
  static constexpr int L_OFF = DS_OFF + BKV * LDS, D_OFF = L_OFF + BQ2;
  static constexpr size_t BYTES = sizeof(float) * (D_OFF + BQ2);
};

template <int HDP, int BK>
__global__ void __launch_bounds__(THREADS) dq_kernel(Args p) {
  using L = DqLayout<HDP, BK>;
  constexpr int LDH = L::LDH, LDS = L::LDS, SC = BK / 8, OC = HDP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  float* qs = sm;
  float* dos = sm + L::DO_OFF;
  float* ks = sm + L::K_OFF;
  float* vs = sm + L::V_OFF;
  float* ss = sm + L::S_OFF;
  float* dl = sm + L::D_OFF;
  const int tid = threadIdx.x, ty = tid / 8, tx = tid % 8, warp = tid / 32, lane = tid % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ, head = blockIdx.y, batch = blockIdx.z;
  const int kvh = head / (p.h / p.hkv);
  const size_t row_off = ((size_t)batch * p.h + head) * p.s;
  const size_t kv_off = ((size_t)batch * p.hkv + kvh) * p.s * p.hd;
  const float* Q = static_cast<const float*>(p.q) + row_off * p.hd;
  const float* dO = static_cast<const float*>(p.dout) + row_off * p.hd;
  const float* O = static_cast<const float*>(p.o) + row_off * p.hd;
  const float* K = static_cast<const float*>(p.k) + kv_off;
  const float* V = static_cast<const float*>(p.v) + kv_off;
  int kt_lo, kt_hi;
  key_range(p, q0, BK, kt_lo, kt_hi);

  load_rows<HDP>(p, qs, Q, q0, BQ);
  load_rows<HDP>(p, dos, dO, q0, BQ);
  // delta = rowsum(dout * out): warp w takes rows 16w.., lanes over the head dim
  for (int r = 0; r < 16; ++r) {
    const int lr = warp * 16 + r, gr = q0 + lr;
    float acc = 0.f;
    if (gr < p.s)
      for (int c = lane; c < p.hd; c += 32) acc += dO[(size_t)gr * p.hd + c] * O[(size_t)gr * p.hd + c];
    acc = warp_sum(acc);
    if (lane == 0) {
      dl[lr] = acc;
      if (gr < p.s) p.delta[row_off + gr] = acc;
    }
  }
  __syncthreads();
  float lse[4], delta[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = q0 + ty * 4 + i;
    lse[i] = gr < p.s ? p.lse[row_off + gr] : -INFINITY;
    delta[i] = dl[ty * 4 + i];
  }

  float acc[4][OC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.f;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    __syncthreads();  // the previous tile's K and ds are read
    load_rows<HDP>(p, ks, K, kt * BK, BK);
    load_rows<HDP>(p, vs, V, kt * BK, BK);
    __syncthreads();

    float sa[4][SC], pa[4][SC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < SC; ++c) sa[i][c] = pa[i][c] = 0.f;
#pragma unroll 2
    for (int d = 0; d < HDP; ++d) {
      float a[4], g[4], kb[SC], vb[SC];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = qs[(ty * 4 + i) * LDH + d];
        g[i] = dos[(ty * 4 + i) * LDH + d];
      }
#pragma unroll
      for (int c = 0; c < SC; ++c) {
        kb[c] = ks[(tx + 8 * c) * LDH + d];
        vb[c] = vs[(tx + 8 * c) * LDH + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < SC; ++c) {
          sa[i][c] = fmaf(a[i], kb[c], sa[i][c]);
          pa[i][c] = fmaf(g[i], vb[c], pa[i][c]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < SC; ++c) {
        float prob;
        ss[(ty * 4 + i) * LDS + tx + 8 * c] = grad_logit(
            p, sa[i][c], pa[i][c], q0 + ty * 4 + i, kt * BK + tx + 8 * c, lse[i], delta[i], prob);
      }
    __syncthreads();

    // dq += ds k
#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = ss[(ty * 4 + i) * LDS + j];
#pragma unroll
      for (int c = 0; c < OC; ++c) {
        const float kv = ks[j * LDH + tx + 8 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(dsv[i], kv, acc[i][c]);
      }
    }
  }
  float* dQ = static_cast<float*>(p.dq) + row_off * p.hd;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = q0 + ty * 4 + i;
    if (gr >= p.s) continue;
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      const int gc = tx + 8 * c;
      if (gc < p.hd) dQ[(size_t)gr * p.hd + gc] = acc[i][c] * p.scale;
    }
  }
}

template <int HDP, int BQ2>
__global__ void __launch_bounds__(THREADS) dkv_kernel(Args p) {
  using L = DkvLayout<HDP, BQ2>;
  constexpr int LDH = L::LDH, LDS = L::LDS, SC = BQ2 / 8;
  constexpr int NC = HDP < 128 ? HDP : 128, OC = NC / 8, CHUNKS = HDP / NC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  float* ks = sm;
  float* vs = sm + L::V_OFF;
  float* qs = sm + L::Q_OFF;
  float* dos = sm + L::DO_OFF;
  float* pt = sm + L::P_OFF;
  float* dst = sm + L::DS_OFF;
  float* lse_s = sm + L::L_OFF;
  float* delta_s = sm + L::D_OFF;
  const int tid = threadIdx.x, ty = tid / 8, tx = tid % 8;
  const int k0 = (blockIdx.x / CHUNKS) * BKV, c0 = (blockIdx.x % CHUNKS) * NC;
  const int kvh = blockIdx.y, batch = blockIdx.z, rep = p.h / p.hkv;
  const size_t kv_off = ((size_t)batch * p.hkv + kvh) * p.s * p.hd;
  int qt_lo, qt_hi;
  query_range(p, k0, BQ2, qt_lo, qt_hi);
  const int nqt = qt_hi - qt_lo, n_it = rep * nqt;

  load_rows<HDP>(p, ks, static_cast<const float*>(p.k) + kv_off, k0, BKV);
  load_rows<HDP>(p, vs, static_cast<const float*>(p.v) + kv_off, k0, BKV);

  float dk[4][OC], dv[4][OC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < OC; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int head = kvh * rep + it / nqt, q0 = (qt_lo + it % nqt) * BQ2;
    const size_t row_off = ((size_t)batch * p.h + head) * p.s;
    __syncthreads();  // the previous tile's Q, dO, p^T and ds^T are read
    load_rows<HDP>(p, qs, static_cast<const float*>(p.q) + row_off * p.hd, q0, BQ2);
    load_rows<HDP>(p, dos, static_cast<const float*>(p.dout) + row_off * p.hd, q0, BQ2);
    for (int i = tid; i < BQ2; i += THREADS) {
      const int gr = q0 + i;
      lse_s[i] = gr < p.s ? p.lse[row_off + gr] : -INFINITY;
      delta_s[i] = gr < p.s ? p.delta[row_off + gr] : 0.f;
    }
    __syncthreads();

    // logits^T = K Q^T and dp^T = V dO^T: key rows ty*4.., query columns tx + 8c
    float sa[4][SC], pa[4][SC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < SC; ++c) sa[i][c] = pa[i][c] = 0.f;
#pragma unroll 2
    for (int d = 0; d < HDP; ++d) {
      float a[4], g[4], qb[SC], ob[SC];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = ks[(ty * 4 + i) * LDH + d];
        g[i] = vs[(ty * 4 + i) * LDH + d];
      }
#pragma unroll
      for (int c = 0; c < SC; ++c) {
        qb[c] = qs[(tx + 8 * c) * LDH + d];
        ob[c] = dos[(tx + 8 * c) * LDH + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < SC; ++c) {
          sa[i][c] = fmaf(a[i], qb[c], sa[i][c]);
          pa[i][c] = fmaf(g[i], ob[c], pa[i][c]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < SC; ++c) {
        const int qc = tx + 8 * c;
        float prob;
        const float ds = grad_logit(p, sa[i][c], pa[i][c], q0 + qc, k0 + ty * 4 + i,
                                    lse_s[qc], delta_s[qc], prob);
        pt[(ty * 4 + i) * LDS + qc] = prob;
        dst[(ty * 4 + i) * LDS + qc] = ds;
      }
    __syncthreads();

    // dv += p^T dout, dk += ds^T q over this block's output columns
#pragma unroll 2
    for (int j = 0; j < BQ2; ++j) {
      float pv[4], dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = pt[(ty * 4 + i) * LDS + j];
        dsv[i] = dst[(ty * 4 + i) * LDS + j];
      }
#pragma unroll
      for (int c = 0; c < OC; ++c) {
        const float ov = dos[j * LDH + c0 + tx + 8 * c];
        const float qv = qs[j * LDH + c0 + tx + 8 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv[i][c] = fmaf(pv[i], ov, dv[i][c]);
          dk[i][c] = fmaf(dsv[i], qv, dk[i][c]);
        }
      }
    }
  }
  float* dK = static_cast<float*>(p.dk) + kv_off;
  float* dV = static_cast<float*>(p.dv) + kv_off;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = k0 + ty * 4 + i;
    if (gr >= p.s) continue;
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      const int gc = c0 + tx + 8 * c;
      if (gc < p.hd) {
        dK[(size_t)gr * p.hd + gc] = dk[i][c] * p.scale;
        dV[(size_t)gr * p.hd + gc] = dv[i][c];
      }
    }
  }
}

template <int HDP, int BK>
cudaError_t launch_dq(const Args& p, cudaStream_t stream) {
  static std::atomic<unsigned long long> smem_allowed{0};
  const cudaError_t err = allow_max_dynamic_smem(dq_kernel<HDP, BK>, smem_allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.s + BQ - 1) / BQ, p.h, p.b);
  dq_kernel<HDP, BK><<<grid, THREADS, DqLayout<HDP, BK>::BYTES, stream>>>(p);
  return cudaGetLastError();
}

template <int HDP, int BQ2>
cudaError_t launch_dkv(const Args& p, cudaStream_t stream) {
  static std::atomic<unsigned long long> smem_allowed{0};
  const cudaError_t err = allow_max_dynamic_smem(dkv_kernel<HDP, BQ2>, smem_allowed);
  if (err != cudaSuccess) return err;
  const int chunks = HDP <= 128 ? 1 : HDP / 128;
  const dim3 grid((p.s + BKV - 1) / BKV * chunks, p.hkv, p.b);
  dkv_kernel<HDP, BQ2><<<grid, THREADS, DkvLayout<HDP, BQ2>::BYTES, stream>>>(p);
  return cudaGetLastError();
}
}  // namespace simt

inline cudaError_t validate(int b, int h, int hkv, int s, int hd) {
  if (b <= 0 || h <= 0 || hkv <= 0 || s <= 0 || hd <= 0 || hd > 256 || h % hkv != 0 ||
      h > 65535 || b > 65535)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

inline int is_aligned(int hd, std::initializer_list<const void*> ptrs) {
  if (hd % 8 != 0) return 0;
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return 0;
  return 1;
}

}  // namespace flash_bwd
}  // namespace ssp

// All tensors contiguous: q, o, dout, dq [b, h, s, hd]; k, v, dk, dv
// [b, hkv, s, hd] in one dtype (fp32 or bf16); lse and delta fp32 [b, h, s].
// window <= 0 and softcap <= 0 mean none; hd up to 256. The dq kernel writes
// delta, which the dk/dv kernel reads: launch them in that order on one stream.
extern "C" int ssp_flash_attention_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const float* lse,
                                          float* delta, void* dq, int b, int h, int hkv, int s,
                                          int hd, float scale, int causal, int window,
                                          float softcap, void* stream) {
  using namespace ssp;
  using namespace ssp::flash_bwd;
  cudaError_t err = validate(b, h, hkv, s, hd);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args p{q, k, v, o, dout, lse, delta, dq, nullptr, nullptr, b, h, hkv, s, hd,
               scale, causal, window, softcap, is_aligned(hd, {q, k, v, dout})};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    if (hd <= 64) err = tc::launch_dq<64>(p, st);
    else if (hd <= 80) err = tc::launch_dq<80>(p, st);
    else if (hd <= 128) err = tc::launch_dq<128>(p, st);
    else err = tc::launch_dq<256>(p, st);
  } else if (dtype == kF32) {
    if (hd <= 64) err = simt::launch_dq<64, 64>(p, st);
    else if (hd <= 80) err = simt::launch_dq<80, 64>(p, st);
    else if (hd <= 128) err = simt::launch_dq<128, 64>(p, st);
    else err = simt::launch_dq<256, 32>(p, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" int ssp_flash_attention_bwd_dkv(int dtype, const void* q, const void* k,
                                           const void* v, const void* dout, const float* lse,
                                           const float* delta, void* dk, void* dv, int b, int h,
                                           int hkv, int s, int hd, float scale, int causal,
                                           int window, float softcap, void* stream) {
  using namespace ssp;
  using namespace ssp::flash_bwd;
  cudaError_t err = validate(b, h, hkv, s, hd);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args p{q, k, v, nullptr, dout, lse, const_cast<float*>(delta), nullptr, dk, dv,
               b, h, hkv, s, hd, scale, causal, window, softcap,
               is_aligned(hd, {q, k, v, dout})};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    if (hd <= 64) err = tc::launch_dkv<64>(p, st);
    else if (hd <= 80) err = tc::launch_dkv<80>(p, st);
    else if (hd <= 128) err = tc::launch_dkv<128>(p, st);
    else err = tc::launch_dkv<256>(p, st);
  } else if (dtype == kF32) {
    if (hd <= 64) err = simt::launch_dkv<64, 64>(p, st);
    else if (hd <= 80) err = simt::launch_dkv<80, 64>(p, st);
    else if (hd <= 128) err = simt::launch_dkv<128, 64>(p, st);
    else err = simt::launch_dkv<256, 32>(p, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
