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
// - dq kernel: one block per (batch, query head, query tile). Its prologue
//   computes delta = rowsum(dout * out) in fp32 for the tile's rows and
//   stores it for the dk/dv kernel. It walks the key tiles the causal mask
//   and the window leave, recomputes p = exp(logit - lse) and
//   ds = p * (dp - delta) with dp = dout . v (times 1 - tanh^2 under a
//   softcap), and accumulates ds k in fp32.
// - dk/dv kernel: one block per (batch, KV head, key tile), which walks
//   every member of the query group and every query tile that reaches the key
//   tile: dv += p^T dout, dk += ds^T q, both in fp32. The GQA group sum
//   happens inside the block, K/V are never repeated and no atomics are used,
//   so the backward is deterministic (the same bits on every run).
//
// Numerics follow the Pallas kernels: fp32 logits, softcap on the scaled
// logits before the mask, p and ds rounded to the operand dtype before their
// products (fp32 accumulate), dq and dk scaled once at the end. A row that no
// key reaches has lse = -inf and gets p = 0 (the Pallas denominator guard);
// rows and columns past s are masked, never read as data.
//
// - bf16 (namespace wg): Hopper's wgmma with TMA loads, the layout of the
//   forward (csrc/flash_attention.cu): one producer warpgroup and two
//   consumer warpgroups of 64 rows (setmaxnreg moves registers to the
//   consumers). The block's resident pair (Q and dO for dq, K and V for dk/dv,
//   128 rows) arrives once; the other pair streams through a ring of 2-4
//   stages, one producer thread issuing TMA loads of 64-column boxes
//   (128-byte swizzled) through 3-D tensor maps over [b*heads, s, hd], with
//   full/empty mbarrier pairs. The dq kernel's prologue reads each row of
//   dout and out once (a quad of threads per row, 16-byte loads) for delta,
//   while the ring fills. It computes S = Q K^T and dP = dO V^T with both
//   operands in shared memory, forms P and dS in registers and issues
//   dQ += dS K with dS as the register A operand and K read MN-major from
//   the staged tile. The dk/dv kernel works transposed: S^T = K Q^T and
//   dP^T = V dO^T, P^T from lse per column and dS^T = P^T (dP^T - delta) in
//   registers, then dV += P^T dO and dK += dS^T Q with dO and Q read
//   MN-major; a second producer warp stages each query tile's (lse, delta)
//   pairs beside it. Two warpgroups of 64 key rows give dK and dV 64 fp32
//   registers each at head_dim 128; query tiles of 32 rows keep the
//   products of the next tile in registers beside them. In both kernels the
//   two products of tile i+1 are issued before the accumulating products of
//   tile i (csrc/hopper.cuh two_product_pipeline), so the elementwise step
//   overlaps them; p = 2^(raw * scale * log2(e) - lse * log2(e)) is one FFMA
//   and one SFU op. At head_dim 256 the dk/dv kernel splits the output
//   columns over two blocks (128 each), and stages hold 32 rows. The
//   elementwise mask runs only on diagonal, window-edge and ragged tiles.
//   Shapes TMA cannot take (hd % 8 != 0, a base off 16 bytes) run the same
//   kernels with the producer warpgroup filling the same stages by element
//   loads.
// - fp32: SIMT in exact fp32 (no TF32), 128 threads, thread (ty, tx) owning
//   rows ty*4.. and strided columns tx + 8c, as the forward.
//
// What bounds it on the H100: the function needs 10*hd FLOPs per unmasked
// (query, key) pair (logits, dp, dq, dk, dv: 2*hd each, as the Pallas cost
// estimate counts) against q, k, v, o, dout, dq, dk, dv moved once, so it is
// operations-bound at every LLM shape. The two kernels execute 14*hd (both
// recompute the logits and dp: the price of no atomics and no fp32 dq
// scratch); the design feeds the tensor cores from TMA-filled shared memory
// and keeps the elementwise step in registers, overlapped with the other
// products. Left for later: one kernel over key tiles that also emits dq
// (10*hd, needs a deterministic reduction of dq partials).

#include <cmath>
#include <cstdint>
#include <initializer_list>

#include "common.cuh"
#include "hopper.cuh"

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
  int tma;        // bf16: the producer loads by TMA (else by elements)
};

// Key tiles [lo, hi) of width bk that query rows [r_lo, r_end) reach.
__device__ __forceinline__ void key_tiles(const Args& p, int r_lo, int r_end, int bk, int& lo, int& hi) {
  const int n = (p.s + bk - 1) / bk;
  hi = p.causal ? min(n, (r_end - 1) / bk + 1) : n;
  lo = (p.causal && p.window > 0) ? max(0, r_lo - p.window + 1) / bk : 0;
}

// Query tiles [lo, hi) of height bq that reach key rows [k_lo, k_end).
__device__ __forceinline__ void query_tiles(const Args& p, int k_lo, int k_end, int bq, int& lo, int& hi) {
  const int n = (p.s + bq - 1) / bq;
  lo = p.causal ? k_lo / bq : 0;
  hi = n;
  if (p.causal && p.window > 0) hi = min(n, (k_end - 1 + p.window - 1) / bq + 1);
}

// False where the mask removes the pair (query row, key col), or past s.
__device__ __forceinline__ bool keep(const Args& p, int row, int col) {
  bool ok = col < p.s && row < p.s;
  if (p.causal) {
    ok = ok && col <= row;
    if (p.window > 0) ok = ok && (row - col < p.window);
  }
  return ok;
}

// True when the mask removes some pair of query rows [r0, r0 + nr) x key
// columns [c0, c0 + nc), or the tile reaches past s.
__device__ __forceinline__ bool tile_masked(const Args& p, int r0, int nr, int c0, int nc) {
  if (c0 + nc > p.s || r0 + nr > p.s) return true;
  if (!p.causal) return false;
  if (c0 + nc - 1 > r0) return true;
  return p.window > 0 && r0 + nr - 1 - c0 >= p.window;
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
  prob = keep(p, row, col) && lse != -INFINITY ? expf(x - lse) : 0.f;
  return prob * (dp - delta) * dcap;
}

// ------------------------------------------------ bf16: wgmma + TMA -------
namespace wg {
using namespace ::ssp::hopper;
using T = __nv_bfloat16;
constexpr int BLOCK = 128;     // rows of the resident pair: two consumer warpgroups of 64
constexpr int THREADS = 384;   // producer warpgroup + two consumer warpgroups
constexpr int PRODUCER_THREADS = 128;
constexpr int CONSUMER_WARPS = 8;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int LAUNCH_REGS = (PRODUCER_THREADS * PRODUCER_REGS + 256 * CONSUMER_REGS + THREADS - 1) / THREADS;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int SMEM_LIMIT = 227 * 1024;  // shared memory a block may opt into

// Shared memory of both kernels: the resident pair (2 x NB boxes of BLOCK
// rows), then STAGES stages of the streamed pair (2 x NB boxes of ROWS rows,
// then ROWS float pairs of per-row statistics when STATS), then the barriers.
template <int HDP, int STREAM_ROWS, bool STATS>
struct Cfg {
  static constexpr int ROWS = STREAM_ROWS;
  static constexpr int NB = HDP / 64;
  static constexpr int RES_BOX = BLOCK * 128, RES = 2 * NB * RES_BOX;
  static constexpr int BOX = ROWS * 128;
  static constexpr int TILES = 2 * NB * BOX;
  static constexpr int STAGE = (TILES + (STATS ? 2 * ROWS * 4 : 0) + 1023) / 1024 * 1024;
  static constexpr int FIT = (SMEM_LIMIT - RES - 2048) / STAGE;
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr size_t SMEM = (size_t)RES + STAGES * STAGE + (2 * STAGES + 1) * sizeof(uint64_t) + 1024;
  // a consumer holds two stages at a time; head_dim 256 has room for only
  // those two in the dk/dv kernel, so its next load waits for a release
  static_assert(STAGES >= 2 && SMEM <= SMEM_LIMIT, "the ring needs two stages");
};
template <int HDP>
using DqCfg = Cfg<HDP, HDP == 256 ? 32 : 64, false>;  // streamed: K and V tiles
template <int HDP>
using DkvCfg = Cfg<HDP, 32, true>;  // streamed: Q and dO tiles, lse, delta

// p (the probability) and ds of one pair from its raw q.k product and dp, with
// lse2 = lse * log2(e); p = 0 where `masked` and the mask removes the pair, or
// for a row that no key reaches. Rows past s carry lse2 = +inf, so p = 0.
// Without a softcap p = 2^(raw * scale * log2(e) - lse2): one FFMA, one SFU op.
__device__ __forceinline__ float grad_pair(const Args& p, float raw, float dp, float lse2,
                                           float delta, bool masked, int row, int col,
                                           float& prob) {
  float dcap = 1.f;
  if (p.softcap > 0.f) {
    const float t = tanhf(raw * p.scale / p.softcap);
    prob = fast_exp2(p.softcap * LOG2E * t - lse2);
    dcap = 1.f - t * t;
  } else {
    prob = fast_exp2(fmaf(raw, p.scale * LOG2E, -lse2));
  }
  if (masked && !(keep(p, row, col) && lse2 != -INFINITY)) prob = 0.f;
  return prob * (dp - delta) * dcap;
}

// The producer side shared by both kernels: stage the resident pair once
// (on res_full), then n_it stages of the streamed pair. Tensor maps or element
// loads (p.tma); `where(it, row0, mat)` names the streamed rows of iteration it.
// `stats(dst, row0, mat, i0, stride)`, when the kernel has them, writes the
// stage's per-row statistics from thread i0 of `stride` threads (the second
// warp under TMA, every producer thread with element loads).
template <int HDP, int ROWS, bool STATS, typename Where, typename Stats>
__device__ __forceinline__ void produce(const Args& p, unsigned char* smem, uint64_t* full,
                                        uint64_t* empty, uint64_t* res_full,
                                        const CUtensorMap* map_r0, const CUtensorMap* map_r1,
                                        const CUtensorMap* map_s0, const CUtensorMap* map_s1,
                                        const void* src_r0, const void* src_r1,
                                        const void* src_s0, const void* src_s1, int res_mat,
                                        int res_row0, int n_it, Where where, Stats stats) {
  using C = Cfg<HDP, ROWS, STATS>;
  constexpr int NB = C::NB;
  const int tid = threadIdx.x;
  unsigned char* ring = smem + C::RES;
  if (p.tma) {
    if (tid == 0) {
      mbar_expect_tx(res_full, C::RES);
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        tma_load_3d(smem + b * C::RES_BOX, map_r0, 64 * b, res_row0, res_mat, res_full);
        tma_load_3d(smem + (NB + b) * C::RES_BOX, map_r1, 64 * b, res_row0, res_mat, res_full);
      }
    }
  } else {
    fill_rows<BLOCK, HDP, PRODUCER_THREADS>(src_r0, smem, res_mat, res_row0, p.s, p.hd);
    fill_rows<BLOCK, HDP, PRODUCER_THREADS>(src_r1, smem + NB * C::RES_BOX, res_mat, res_row0, p.s,
                                            p.hd);
    fence_proxy_async();
    mbar_arrive(res_full);
  }
  for (int it = 0; it < n_it; ++it) {
    const int s = it % C::STAGES;
    int row0, mat;
    where(it, row0, mat);
    if (it >= C::STAGES) mbar_wait(&empty[s], ((it / C::STAGES) + 1) & 1);
    unsigned char* st = ring + s * C::STAGE;
    if (p.tma) {
      if (tid == 0) {
        mbar_expect_tx(&full[s], C::TILES);
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          tma_load_3d(st + b * C::BOX, map_s0, 64 * b, row0, mat, &full[s]);
          tma_load_3d(st + (NB + b) * C::BOX, map_s1, 64 * b, row0, mat, &full[s]);
        }
      } else if constexpr (STATS) {  // the second producer warp
        stats(st + C::TILES, row0, mat, tid - 32, 32);
        mbar_arrive(&full[s]);
      }
    } else {
      fill_rows<ROWS, HDP, PRODUCER_THREADS>(src_s0, st, mat, row0, p.s, p.hd);
      fill_rows<ROWS, HDP, PRODUCER_THREADS>(src_s1, st + NB * C::BOX, mat, row0, p.s, p.hd);
      if constexpr (STATS) stats(st + C::TILES, row0, mat, tid, PRODUCER_THREADS);
      fence_proxy_async();
      mbar_arrive(&full[s]);
    }
  }
}

// Issue the two products of one tile, both operands K-major in shared memory:
// s = A0 B0^T and d = A1 B1^T over HDP (A: a consumer's 64-row slab of the
// resident pair, B: the streamed tile's N rows); the caller fences, commits
// and waits.
template <int HDP, int N>
__device__ __forceinline__ void issue_two(float (&s)[N / 2], float (&d)[N / 2], uint32_t a0,
                                          uint32_t a1, uint32_t b0, uint32_t b1, int a_box,
                                          int b_box) {
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    const int off = (kk / 4) * a_box + (kk % 4) * 32, boff = (kk / 4) * b_box + (kk % 4) * 32;
    wgmma_ss(s, smem_desc(a0 + off), smem_desc(b0 + boff), kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    const int off = (kk / 4) * a_box + (kk % 4) * 32, boff = (kk / 4) * b_box + (kk % 4) * 32;
    wgmma_ss(d, smem_desc(a1 + off), smem_desc(b1 + boff), kk > 0);
  }
}

// bf16 A fragments of the K steps of a 64 x N fp32 accumulator.
template <int N>
__device__ __forceinline__ void to_frags(const float (&acc)[N / 2], uint32_t (&f)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) f[kk][r] = pack_bf16(acc[8 * kk + 2 * r], acc[8 * kk + 2 * r + 1]);
}

// grid (heads, batch, query tiles from the last).
template <int HDP>
__global__ void __launch_bounds__(THREADS, 1)
    dq_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_do,
              const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
              const Args p) {
  using C = DqCfg<HDP>;
  constexpr int BK = C::ROWS, NB = C::NB;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = smem + C::RES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + C::STAGES * C::STAGE);
  uint64_t* empty = full + C::STAGES;
  uint64_t* res_full = empty + C::STAGES;

  const int head = blockIdx.x, batch = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BLOCK;
  const int bh = batch * p.h + head, bkv = batch * p.hkv + head / (p.h / p.hkv);
  int kt_lo, kt_hi;
  key_tiles(p, q0, min(q0 + BLOCK, p.s), BK, kt_lo, kt_hi);
  const int n_it = kt_hi - kt_lo;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], p.tma ? 1 : PRODUCER_THREADS);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    mbar_init(res_full, p.tma ? 1 : PRODUCER_THREADS);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < PRODUCER_THREADS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (p.tma && threadIdx.x != 0) return;
    produce<HDP, BK, false>(
        p, smem, full, empty, res_full, &map_q, &map_do, &map_k, &map_v, p.q, p.dout, p.k, p.v, bh,
        q0, n_it, [&](int it, int& row0, int& mat) { row0 = (kt_lo + it) * BK; mat = bkv; },
        [](unsigned char*, int, int, int, int) {});
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wgi = threadIdx.x / 128 - 1, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = q0 + 64 * wgi;
  const int row_a = r0 + 16 * warp + g, row_b = row_a + 8;
  int my_lo = kt_lo, my_hi = kt_lo;
  if (r0 < p.s) key_tiles(p, r0, min(r0 + 64, p.s), BK, my_lo, my_hi);
  const size_t row_off = (size_t)bh * p.s;

  // delta = rowsum(dout * out) of rows row_a and row_b: the four threads of a
  // quad split each row's columns (16-byte loads, all in flight, where the
  // rows allow them), then a quad sum; stored for the dk/dv kernel.
  float delta_a, delta_b;
  {
    const T* dO = static_cast<const T*>(p.dout) + row_off * p.hd;
    const T* O = static_cast<const T*>(p.o) + row_off * p.hd;
    const bool vec = p.hd % 32 == 0 && reinterpret_cast<uintptr_t>(dO) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(O) % 16 == 0;
    const int quarter = p.hd / 4;
    float acc[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = h ? row_b : row_a;
      if (row >= p.s) continue;
      const T* a_row = dO + (size_t)row * p.hd;
      const T* b_row = O + (size_t)row * p.hd;
      if (vec) {
#pragma unroll
        for (int i = 0; i < HDP / 32; ++i) {
          if (8 * i >= quarter) break;
          const int c = t * quarter + 8 * i;
          const uint4 x = *reinterpret_cast<const uint4*>(a_row + c);
          const uint4 y = *reinterpret_cast<const uint4*>(b_row + c);
          const __nv_bfloat162* xa = reinterpret_cast<const __nv_bfloat162*>(&x);
          const __nv_bfloat162* ya = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float2 u = __bfloat1622float2(xa[k]), w = __bfloat1622float2(ya[k]);
            acc[h] = fmaf(u.x, w.x, fmaf(u.y, w.y, acc[h]));
          }
        }
      } else {
        for (int c = t; c < p.hd; c += 4) acc[h] += to_f(a_row[c]) * to_f(b_row[c]);
      }
    }
    delta_a = quad_sum(acc[0]);
    delta_b = quad_sum(acc[1]);
    if (t == 0) {
      if (row_a < p.s) p.delta[row_off + row_a] = delta_a;
      if (row_b < p.s) p.delta[row_off + row_b] = delta_b;
    }
  }
  const float lse2_a = row_a < p.s ? p.lse[row_off + row_a] * LOG2E : INFINITY;
  const float lse2_b = row_b < p.s ? p.lse[row_off + row_b] * LOG2E : INFINITY;

  float dq[HDP / 2], sacc[BK / 2], dpacc[BK / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) dq[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sacc[i] = dpacc[i] = 0.f;
  uint32_t dsf[BK / 16][4];
  const uint32_t q_addr = smem_u32(smem) + wgi * 64 * 128;
  const uint32_t do_addr = q_addr + NB * C::RES_BOX;
  const auto k_addr = [&](int s) { return smem_u32(ring + s * C::STAGE); };
  const auto release = [&](int s) {
    if (lane == 0) mbar_arrive(&empty[s]);
  };
  const auto issue_sdp = [&](int s) {
    issue_two<HDP, BK>(sacc, dpacc, q_addr, do_addr, k_addr(s), k_addr(s) + NB * C::BOX, C::RES_BOX,
                       C::BOX);
  };
  // dQ += dS K of stage s, dS from dsf (K read MN-major)
  const auto issue_dq = [&](int s) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<1>(dq, dsf[kk], smem_desc_mn(k_addr(s) + kk * 2048, C::BOX), 1);
  };
  // p and ds of key tile kt from sacc and dpacc; ds lands in dpacc
  const auto grads = [&](int kt) {
    const int c0 = kt * BK;
    const bool masked = tile_masked(p, r0, 64, c0, BK);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          float prob;
          dpacc[i] = grad_pair(p, sacc[i], dpacc[i], h ? lse2_b : lse2_a, h ? delta_b : delta_a,
                               masked, h ? row_b : row_a, c0 + 8 * j + 2 * t + e, prob);
        }
  };
  mbar_wait(res_full, 0);

  // Tiles outside this warpgroup's range go back at once; in the range the
  // elementwise step of tile i+1 runs while the tensor cores do dQ += dS K
  // of tile i.
  const auto skip = [&](int it) {  // a tile outside the range: hand it back
    mbar_wait(&full[it % C::STAGES], (it / C::STAGES) & 1);
    release(it % C::STAGES);
  };
  const int first = my_lo - kt_lo, mine = my_hi - my_lo;
  for (int it = 0; it < first; ++it) skip(it);
  two_product_pipeline(
      mine,
      [&](int i) {
        const int it = first + i;
        mbar_wait(&full[it % C::STAGES], (it / C::STAGES) & 1);
        return it % C::STAGES;
      },
      [&] {
        fence_regs(sacc);
        fence_regs(dpacc);
      },
      [&] { fence_regs(dq); }, issue_sdp, [&](int i) { grads(my_lo + i); }, issue_dq,
      [&](int) { to_frags<BK>(dpacc, dsf); }, release);
  for (int it = first + max(mine, 0); it < n_it; ++it) skip(it);
  store_acc_rows(static_cast<T*>(p.dq) + row_off * p.hd, dq, p.scale, p.scale, row_a, p.s, p.hd, 0,
                 t);
}

// grid (KV heads, batch, key tiles x column chunks).
template <int HDP>
__global__ void __launch_bounds__(THREADS, 1)
    dkv_kernel(const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
               const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_do,
               const Args p) {
  using C = DkvCfg<HDP>;
  constexpr int BQ2 = C::ROWS, NB = C::NB;
  constexpr int NC = HDP < 128 ? HDP : 128, CHUNKS = HDP / NC;  // output columns of a block
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = smem + C::RES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + C::STAGES * C::STAGE);
  uint64_t* empty = full + C::STAGES;
  uint64_t* res_full = empty + C::STAGES;

  const int kvh = blockIdx.x, batch = blockIdx.y, rep = p.h / p.hkv;
  const int k0 = (blockIdx.z / CHUNKS) * BLOCK, c0 = (blockIdx.z % CHUNKS) * NC;
  const int bkv = batch * p.hkv + kvh;
  int qt_lo, qt_hi;
  query_tiles(p, k0, min(k0 + BLOCK, p.s), BQ2, qt_lo, qt_hi);
  const int nqt = qt_hi - qt_lo, n_it = rep * nqt;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], p.tma ? 1 + 32 : PRODUCER_THREADS);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    mbar_init(res_full, p.tma ? 1 : PRODUCER_THREADS);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < PRODUCER_THREADS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    // TMA: thread 0 issues the loads, the second warp stages lse and delta
    if (p.tma && threadIdx.x != 0 && threadIdx.x / 32 != 1) return;
    produce<HDP, BQ2, true>(
        p, smem, full, empty, res_full, &map_k, &map_v, &map_q, &map_do, p.k, p.v, p.q, p.dout,
        bkv, k0, n_it,
        [&](int it, int& row0, int& mat) {
          row0 = (qt_lo + it % nqt) * BQ2;
          mat = batch * p.h + kvh * rep + it / nqt;
        },
        [&](unsigned char* dst, int row0, int mat, int i0, int stride) {
          float2* st = reinterpret_cast<float2*>(dst);  // (lse * log2(e), delta) per row
          const size_t off = (size_t)mat * p.s;
          for (int r = i0; r < BQ2; r += stride) {
            const int gr = row0 + r;  // +inf past s gives p = 0
            st[r] = gr < p.s ? make_float2(p.lse[off + gr] * LOG2E, p.delta[off + gr])
                             : make_float2(INFINITY, 0.f);
          }
        });
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wgi = threadIdx.x / 128 - 1, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wk0 = k0 + 64 * wgi;  // this warpgroup's first key row
  const int key_a = wk0 + 16 * warp + g, key_b = key_a + 8;
  int my_lo = qt_lo, my_hi = qt_lo;
  if (wk0 < p.s) query_tiles(p, wk0, min(wk0 + 64, p.s), BQ2, my_lo, my_hi);

  float dk[NC / 2], dv[NC / 2], sacc[BQ2 / 2], dpacc[BQ2 / 2];
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BQ2 / 2; ++i) sacc[i] = dpacc[i] = 0.f;
  uint32_t pf[BQ2 / 16][4], dsf[BQ2 / 16][4];
  const uint32_t k_addr = smem_u32(smem) + wgi * 64 * 128;
  const uint32_t v_addr = k_addr + NB * C::RES_BOX;
  const auto q_addr = [&](int s) { return smem_u32(ring + s * C::STAGE); };
  const auto release = [&](int s) {
    if (lane == 0) mbar_arrive(&empty[s]);
  };
  // dV += P^T dO and dK += dS^T Q of stage s (dO and Q read MN-major)
  const auto issue_dkv = [&](int s) {
    const uint32_t col = q_addr(s) + (c0 / 64) * C::BOX;
#pragma unroll
    for (int kk = 0; kk < BQ2 / 16; ++kk) {
      wgmma_rs<1>(dv, pf[kk], smem_desc_mn(col + NB * C::BOX + kk * 2048, C::BOX), 1);
      wgmma_rs<1>(dk, dsf[kk], smem_desc_mn(col + kk * 2048, C::BOX), 1);
    }
  };
  // p^T into sacc and ds^T into dpacc for query tile q0 of stage s
  const auto grads = [&](int s, int q0) {
    const uint32_t stats = smem_u32(ring + s * C::STAGE + C::TILES);
    const bool masked = tile_masked(p, q0, BQ2, wk0, 64);
#pragma unroll
    for (int j = 0; j < BQ2 / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cq = 8 * j + 2 * t + e;  // query column of the tile
        float l2, dl;  // this query's lse * log2(e) and delta
        asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];" : "=f"(l2), "=f"(dl) : "r"(stats + 8 * cq));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h + e;
          float prob;
          dpacc[i] = grad_pair(p, sacc[i], dpacc[i], l2, dl, masked, q0 + cq, h ? key_b : key_a, prob);
          sacc[i] = prob;
        }
      }
  };
  mbar_wait(res_full, 0);

  // As the dq kernel, for each member of the query group in turn: the
  // elementwise step of tile i+1 runs while the tensor cores do the dV and dK
  // products of tile i (a member's last products finish before the next
  // member's tiles, so no stage is held across tiles this warpgroup skips).
  const auto skip = [&](int it) {  // a tile outside the range: hand it back
    mbar_wait(&full[it % C::STAGES], (it / C::STAGES) & 1);
    release(it % C::STAGES);
  };
  const int first = my_lo - qt_lo, mine = my_hi - my_lo;
  for (int member = 0; member < rep; ++member) {
    const int base = member * nqt;
    for (int it = base; it < base + first; ++it) skip(it);
    two_product_pipeline(
        mine,
        [&](int i) {
          const int it = base + first + i;
          mbar_wait(&full[it % C::STAGES], (it / C::STAGES) & 1);
          return it % C::STAGES;
        },
        [&] {
          fence_regs(sacc);
          fence_regs(dpacc);
        },
        [&] {
          fence_regs(dk);
          fence_regs(dv);
        },
        [&](int s) {
          issue_two<HDP, BQ2>(sacc, dpacc, k_addr, v_addr, q_addr(s), q_addr(s) + NB * C::BOX,
                              C::RES_BOX, C::BOX);
        },
        [&](int i) {
          const int it = base + first + i;
          grads(it % C::STAGES, (my_lo + i) * BQ2);
        },
        issue_dkv,
        [&](int) {
          to_frags<BQ2>(sacc, pf);
          to_frags<BQ2>(dpacc, dsf);
        },
        release);
    for (int it = base + first + max(mine, 0); it < base + nqt; ++it) skip(it);
  }
  const size_t kv_off = (size_t)bkv * p.s * p.hd;
  store_acc_rows(static_cast<T*>(p.dk) + kv_off, dk, p.scale, p.scale, key_a, p.s, p.hd, c0, t);
  store_acc_rows(static_cast<T*>(p.dv) + kv_off, dv, 1.f, 1.f, key_a, p.s, p.hd, c0, t);
}

template <typename Kernel>
cudaError_t prepare(Kernel kern, std::atomic<unsigned long long>& smem_allowed,
                    std::atomic<int>& regs_checked) {
  cudaError_t err = allow_max_dynamic_smem(kern, smem_allowed);
  if (err != cudaSuccess) return err;
  return check_launch_regs(kern, LAUNCH_REGS, regs_checked);
}

template <int HDP>
cudaError_t launch_dq(const Args& p, cudaStream_t stream) {
  using C = DqCfg<HDP>;
  const auto kern = dq_kernel<HDP>;
  static std::atomic<unsigned long long> smem_allowed{0};
  static std::atomic<int> regs_checked{0};
  cudaError_t err = prepare(kern, smem_allowed, regs_checked);
  if (err != cudaSuccess) return err;
  CUtensorMap mq{}, mdo{}, mk{}, mv{};
  if (p.tma) {
    const uint64_t bq = (uint64_t)p.b * p.h, bkv = (uint64_t)p.b * p.hkv;
    const bool ok = encode_3d_bf16(&mq, p.q, bq, p.s, p.hd, BLOCK) &&
                    encode_3d_bf16(&mdo, p.dout, bq, p.s, p.hd, BLOCK) &&
                    encode_3d_bf16(&mk, p.k, bkv, p.s, p.hd, C::ROWS) &&
                    encode_3d_bf16(&mv, p.v, bkv, p.s, p.hd, C::ROWS);
    if (!ok) return cudaErrorNotSupported;  // never a quiet switch to element loads
  }
  const dim3 grid(p.h, p.b, (p.s + BLOCK - 1) / BLOCK);
  kern<<<grid, THREADS, C::SMEM, stream>>>(mq, mdo, mk, mv, p);
  return cudaGetLastError();
}

template <int HDP>
cudaError_t launch_dkv(const Args& p, cudaStream_t stream) {
  using C = DkvCfg<HDP>;
  const auto kern = dkv_kernel<HDP>;
  static std::atomic<unsigned long long> smem_allowed{0};
  static std::atomic<int> regs_checked{0};
  cudaError_t err = prepare(kern, smem_allowed, regs_checked);
  if (err != cudaSuccess) return err;
  CUtensorMap mk{}, mv{}, mq{}, mdo{};
  if (p.tma) {
    const uint64_t bq = (uint64_t)p.b * p.h, bkv = (uint64_t)p.b * p.hkv;
    const bool ok = encode_3d_bf16(&mk, p.k, bkv, p.s, p.hd, BLOCK) &&
                    encode_3d_bf16(&mv, p.v, bkv, p.s, p.hd, BLOCK) &&
                    encode_3d_bf16(&mq, p.q, bq, p.s, p.hd, C::ROWS) &&
                    encode_3d_bf16(&mdo, p.dout, bq, p.s, p.hd, C::ROWS);
    if (!ok) return cudaErrorNotSupported;
  }
  const int chunks = HDP <= 128 ? 1 : HDP / 128;
  const dim3 grid(p.hkv, p.b, (p.s + BLOCK - 1) / BLOCK * chunks);
  kern<<<grid, THREADS, C::SMEM, stream>>>(mk, mv, mq, mdo, p);
  return cudaGetLastError();
}
}  // namespace wg

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
  key_tiles(p, q0, min(q0 + BQ, p.s), BK, kt_lo, kt_hi);

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
  query_tiles(p, k0, min(k0 + BKV, p.s), BQ2, qt_lo, qt_hi);
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

// bf16 operands TMA can load: hd % 8 == 0 and 16-byte bases.
inline int tma_ok(int hd, std::initializer_list<const void*> ptrs) {
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
               scale, causal, window, softcap, tma_ok(hd, {q, k, v, dout})};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    if (hd <= 64) err = wg::launch_dq<64>(p, st);
    else if (hd <= 128) err = wg::launch_dq<128>(p, st);
    else err = wg::launch_dq<256>(p, st);
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
               tma_ok(hd, {q, k, v, dout})};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    if (hd <= 64) err = wg::launch_dkv<64>(p, st);
    else if (hd <= 128) err = wg::launch_dkv<128>(p, st);
    else err = wg::launch_dkv<256>(p, st);
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
