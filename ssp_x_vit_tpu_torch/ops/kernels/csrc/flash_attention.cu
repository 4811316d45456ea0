// Flash attention forward: softmax(q k^T * scale [softcap] [causal] [window]) v
// for q [b, h, s, hd] and k, v [b, hkv, s, hd] (GQA-native: query head h reads
// KV head h / (h / hkv); K/V are never repeated in device memory).
//
// Replaces the three Pallas forwards of
//   ssp_x_vit_tpu/ops/pallas/flash_attention.py : flash_attention
//     (_flash_forward, _flash_forward_multihead, _flash_forward_streaming)
// which are one function in three on-chip-memory regimes. Here it is one
// kernel per dtype: a block owns query rows of one (batch, head), walks the
// key/value tiles it needs and keeps an online softmax per query row (running
// max and sum in fp32, fp32 output accumulator, one divide per row at the
// end, as the Pallas kernel divides after P V). Numerics follow the Pallas
// kernel and sdpa_reference: fp32 logits, softcap on the scaled logits before
// the mask, mask by absolute row and column (col <= row, row - col < window,
// col < s; row shifted by q_offset, the ring hop's query chunk sitting
// q_offset keys after its key chunk), p rounded to v's dtype before P V, the row sum taken in fp32.
//
// Key tiles wholly above the diagonal or wholly outside the window are
// skipped, so causal attention costs about half the rectangle and a window
// O(s * window). A row may see a tile in which all its keys are masked (the
// oldest tile of a window): its running max stays -inf and the update is
// guarded, so no NaN arises.
//
// - bf16 (namespace wg): Hopper's wgmma with TMA loads. A block is one
//   producer warpgroup and two consumer warpgroups of 64 query rows each
//   (128 rows; setmaxnreg moves registers from the producer to the
//   consumers). One producer thread loads the Q tile once and keeps a ring of
//   4 K/V stages of 64 keys full by TMA through 3-D tensor maps over
//   [b*heads, s, hd] (64-column boxes, 128-byte swizzled as wgmma reads them;
//   rows past s and columns past hd arrive as zeros, and a box never reads
//   the next head). Full/empty mbarrier pairs order the ring. A consumer
//   warpgroup computes S = Q K^T with both operands in shared memory into
//   fp32 registers and runs the softmax on those registers: a thread holds
//   rows g and g+8 of its warp's 16, so the row max and sum are quad
//   shuffles and no logits tile exists in shared memory; the max is taken on
//   the raw products and p = 2^(raw * scale * log2(e) - m) is one FFMA and
//   one SFU op. O is rescaled in registers, P is rounded to bf16 in registers
//   (the accumulator layout of S is wgmma's A-fragment layout) and
//   O += P V takes P as the register A operand and V MN-major from the same
//   staged tile (no transpose copy). S of tile i+1 is issued before P V of
//   tile i (csrc/hopper.cuh two_product_pipeline), so the softmax of one tile
//   runs while the tensor cores do the other's P V. The elementwise mask runs
//   only on diagonal, window-edge and ragged tiles. The grid's slowest index
//   walks the query tiles from the last, so the heaviest causal tiles start
//   first. Head dims pad to 64 / 128 / 256 in shared memory only (80 runs the
//   128 tile); at 256 a stage holds 32 keys so O (128 registers) fits.
//   Shapes TMA cannot take (hd % 8 != 0, a base off 16 bytes) run the same
//   kernel with the producer warpgroup filling the same swizzled stages by
//   element loads; shapes that meet TMA's rules always take TMA, and a
//   tensor map that cannot be encoded fails the launch (no second path).
// - fp32: SIMT in exact fp32 (no TF32): 128 threads, thread (ty, tx) owns
//   query rows ty*4.. and strided columns tx + 8c of the logits tile and of O.
//
// With a non-null lse pointer (the training path) each row also stores
// m + log(l), its log-sum-exp, which the backward kernels
// (csrc/flash_attention_bwd.cu) use to recompute the probabilities.
//
// What bounds it on the H100: 4*hd FLOPs per unmasked (query, key) pair
// against q, k, v and o read or written once: operations-bound at every LLM
// shape (Llama-2-7B b=1 s=2048: 34 GFLOP against 67 MB). The design keeps the
// tensor cores fed from shared memory that TMA fills without thread
// instructions and keeps every elementwise step in registers, overlapped with
// the other product. Left for later: the softmax's SFU and FP32 work is
// close to the products' time per tile (an exp per product of 64 x 64 x
// 128), and the block is not persistent (one wave per ~132 query tiles).

#include <cmath>
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

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
  int tma;        // bf16: the producer loads by TMA (else by elements)
  int q_offset;   // >= 0: query row r sits at position r + q_offset of the keys
};

// Key tiles [lo, hi) of width bk that query rows [r_lo, r_end) need (lo == hi:
// none, when the window's band at the query offset misses every key).
__device__ __forceinline__ void key_tiles(const Args& p, int r_lo, int r_end, int bk, int& lo, int& hi) {
  const int n_tiles = (p.s + bk - 1) / bk;
  hi = p.causal ? min(n_tiles, (r_end - 1 + p.q_offset) / bk + 1) : n_tiles;
  lo = (p.causal && p.window > 0) ? min(hi, max(0, r_lo + p.q_offset - p.window + 1) / bk) : 0;
}

// Key tiles of width bk that the query rows [q0, q0 + BQ) need.
__device__ __forceinline__ void tile_range(const Args& p, int q0, int bk, int& lo, int& hi) {
  key_tiles(p, q0, min(q0 + BQ, p.s), bk, lo, hi);
}

// False where the mask removes (row, col); the mask sees row + q_offset.
__device__ __forceinline__ bool keep(const Args& p, int row, int col) {
  bool ok = col < p.s;
  if (p.causal) {
    const int r = row + p.q_offset;
    ok = ok && col <= r;
    if (p.window > 0) ok = ok && (r - col < p.window);
  }
  return ok;
}

// True when the mask removes some pair of rows [r0, r0 + nr) x columns [c0, c0 + nc).
__device__ __forceinline__ bool tile_masked(const Args& p, int r0, int nr, int c0, int nc) {
  if (c0 + nc > p.s) return true;
  if (!p.causal) return false;
  const int r = r0 + p.q_offset;
  if (c0 + nc - 1 > r) return true;
  return p.window > 0 && r + nr - 1 - c0 >= p.window;
}

// Scaled, soft-capped logit of (row, col), or -inf where the mask removes it.
__device__ __forceinline__ float logit(const Args& p, float raw, int row, int col) {
  float x = raw * p.scale;
  if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
  return keep(p, row, col) ? x : -INFINITY;
}

// ------------------------------------------------ bf16: wgmma + TMA -------
namespace wg {
using namespace ::ssp::hopper;
using T = __nv_bfloat16;
constexpr int BLOCK_Q = 128;  // query rows of a block: two consumer warpgroups of 64
constexpr int THREADS = 384;  // producer warpgroup + two consumer warpgroups
constexpr int PRODUCER_THREADS = 128;
constexpr int CONSUMER_WARPS = 8;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
// Registers per thread at launch that let setmaxnreg move CONSUMER_REGS to
// both consumer warpgroups from what the producer gives up.
constexpr int LAUNCH_REGS = (PRODUCER_THREADS * PRODUCER_REGS + 256 * CONSUMER_REGS + THREADS - 1) / THREADS;
constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;

constexpr int SMEM_LIMIT = 227 * 1024;  // shared memory a block may opt into

template <int HDP>
struct Cfg {
  static constexpr int NB = HDP / 64;               // 64-column boxes of a row
  static constexpr int BK = HDP == 256 ? 32 : 64;  // keys per stage (256: O takes 128 registers)
  static constexpr int Q_BOX = BLOCK_Q * 128;       // one box of the block's query rows
  static constexpr int KV_BOX = BK * 128;
  static constexpr int Q_BYTES = NB * Q_BOX;
  static constexpr int STAGE = 2 * NB * KV_BOX;     // K boxes, then V boxes
  static constexpr int FIT = (SMEM_LIMIT - Q_BYTES - 2048) / STAGE;
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr size_t SMEM = (size_t)Q_BYTES + STAGES * STAGE + (2 * STAGES + 1) * sizeof(uint64_t) + 1024;
  // the consumers hold two stages at a time: a third lets the next load run
  static_assert(STAGES >= 3 && SMEM <= SMEM_LIMIT, "the ring needs three stages");
};

// grid (heads, batch, query tiles from the last).
template <int HDP>
__global__ void __launch_bounds__(THREADS, 1)
    fwd_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_v, const Args p) {
  using C = Cfg<HDP>;
  constexpr int BK = C::BK, NB = C::NB;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* qs = smem;
  unsigned char* ring = smem + C::Q_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + C::STAGES * C::STAGE);
  uint64_t* empty = full + C::STAGES;
  uint64_t* q_full = empty + C::STAGES;

  const int head = blockIdx.x, batch = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BLOCK_Q;
  const int bh = batch * p.h + head, bkv = batch * p.hkv + head / (p.h / p.hkv);
  int kt_lo, kt_hi;
  key_tiles(p, q0, min(q0 + BLOCK_Q, p.s), BK, kt_lo, kt_hi);
  const int n_it = kt_hi - kt_lo;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], p.tma ? 1 : PRODUCER_THREADS);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    mbar_init(q_full, p.tma ? 1 : PRODUCER_THREADS);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < PRODUCER_THREADS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (p.tma && threadIdx.x != 0) return;
    if (p.tma) {
      mbar_expect_tx(q_full, C::Q_BYTES);
#pragma unroll
      for (int b = 0; b < NB; ++b) tma_load_3d(qs + b * C::Q_BOX, &map_q, 64 * b, q0, bh, q_full);
    } else {
      fill_rows<BLOCK_Q, HDP, PRODUCER_THREADS>(p.q, qs, bh, q0, p.s, p.hd);
      fence_proxy_async();
      mbar_arrive(q_full);
    }
    for (int it = 0; it < n_it; ++it) {
      const int s = it % C::STAGES, k0 = (kt_lo + it) * BK;
      if (it >= C::STAGES) mbar_wait(&empty[s], ((it / C::STAGES) + 1) & 1);
      unsigned char* st = ring + s * C::STAGE;
      if (p.tma) {
        mbar_expect_tx(&full[s], C::STAGE);
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          tma_load_3d(st + b * C::KV_BOX, &map_k, 64 * b, k0, bkv, &full[s]);
          tma_load_3d(st + (NB + b) * C::KV_BOX, &map_v, 64 * b, k0, bkv, &full[s]);
        }
      } else {
        fill_rows<BK, HDP, PRODUCER_THREADS>(p.k, st, bkv, k0, p.s, p.hd);
        fill_rows<BK, HDP, PRODUCER_THREADS>(p.v, st + NB * C::KV_BOX, bkv, k0, p.s, p.hd);
        fence_proxy_async();
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wgi = threadIdx.x / 128 - 1, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = q0 + 64 * wgi;  // this warpgroup's first query row
  const int row_a = r0 + 16 * warp + g, row_b = row_a + 8;
  int my_lo = kt_lo, my_hi = kt_lo;  // a warpgroup wholly past s computes nothing
  if (r0 < p.s) key_tiles(p, r0, min(r0 + 64, p.s), BK, my_lo, my_hi);
  const float sl2 = p.scale * LOG2E;
  float o[HDP / 2], sacc[BK / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sacc[i] = 0.f;
  uint32_t pf[BK / 16][4];
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;  // max in log2 units
  float alpha_a = 1.f, alpha_b = 1.f;
  const uint32_t q_addr = smem_u32(qs) + wgi * 64 * 128;
  const auto k_addr = [&](int s) { return smem_u32(ring + s * C::STAGE); };
  const auto release = [&](int s) {
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with the stage
  };
  // S = Q K^T of stage s into sacc (issued, not waited for)
  const auto issue_s = [&](int s) {
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      const int off = (kk % 4) * 32;  // 16 columns further inside the 128-byte row
      wgmma_ss(sacc, smem_desc(q_addr + (kk / 4) * C::Q_BOX + off),
               smem_desc(k_addr(s) + (kk / 4) * C::KV_BOX + off), kk > 0);
    }
  };
  // O += P V of stage s, P from pf (issued, not waited for)
  const auto issue_pv = [&](int s) {
    const uint32_t v_addr = k_addr(s) + NB * C::KV_BOX;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<1>(o, pf[kk], smem_desc_mn(v_addr + kk * 2048, C::KV_BOX), 1);
  };
  // Online softmax of key tile kt in sacc: updates m, l (log2 units) and the
  // factors alpha that O must take before this tile's P V; sacc becomes p.
  // Without a softcap the max is taken on the raw products (the scale is
  // positive) and p = 2^(raw * scale * log2(e) - m) is one FFMA and one SFU op.
  const auto softmax = [&](int kt) {
    const int c0 = kt * BK;
    if (tile_masked(p, r0, 64, c0, BK)) {  // the mask only where the tile needs one
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = c0 + 8 * j + 2 * t + e;
          if (!keep(p, row_a, col)) sacc[4 * j + e] = -INFINITY;
          if (!keep(p, row_b, col)) sacc[4 * j + 2 + e] = -INFINITY;
        }
    }
    float mul = sl2;
    if (p.softcap > 0.f) {  // log2-unit logits in place; tanh keeps -inf at -cap
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        sacc[i] = sacc[i] == -INFINITY ? -INFINITY
                                       : p.softcap * LOG2E * tanhf(sacc[i] * p.scale / p.softcap);
      mul = 1.f;
    }
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mx_a = fmaxf(mx_a, sacc[4 * j + e]);
        mx_b = fmaxf(mx_b, sacc[4 * j + 2 + e]);
      }
    const float mn_a = fmaxf(m_a, quad_max(mx_a) * mul), mn_b = fmaxf(m_b, quad_max(mx_b) * mul);
    // a row whose keys are all masked so far keeps max -inf: base 0 gives p = 0
    const float base_a = mn_a == -INFINITY ? 0.f : mn_a, base_b = mn_b == -INFINITY ? 0.f : mn_b;
    alpha_a = fast_exp2(m_a - base_a);  // 0 while m is -inf
    alpha_b = fast_exp2(m_b - base_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sacc[4 * j + e] = fast_exp2(fmaf(sacc[4 * j + e], mul, -base_a));
        sacc[4 * j + 2 + e] = fast_exp2(fmaf(sacc[4 * j + 2 + e], mul, -base_b));
        sum_a += sacc[4 * j + e];
        sum_b += sacc[4 * j + 2 + e];
      }
    l_a = l_a * alpha_a + sum_a;  // this thread's columns; the quad's sum at the end
    l_b = l_b * alpha_b + sum_b;
  };
  const auto rescale_and_pack = [&]() {
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      o[4 * j] *= alpha_a;
      o[4 * j + 1] *= alpha_a;
      o[4 * j + 2] *= alpha_b;
      o[4 * j + 3] *= alpha_b;
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) pf[kk][r] = pack_bf16(sacc[8 * kk + 2 * r], sacc[8 * kk + 2 * r + 1]);
  };

  mbar_wait(q_full, 0);
  // Tiles outside this warpgroup's range go back at once; in the range the
  // softmax of tile i+1 runs while the tensor cores do P V of tile i.
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
      [&] { fence_regs(sacc); }, [&] { fence_regs(o); }, issue_s,
      [&](int i) { softmax(my_lo + i); }, issue_pv, [&](int) { rescale_and_pack(); }, release);
  for (int it = first + max(mine, 0); it < n_it; ++it) skip(it);

  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  if (p.lse != nullptr && t == 0) {
    if (row_a < p.s) p.lse[(size_t)bh * p.s + row_a] = l_a > 0.f ? m_a * LN2 + logf(l_a) : -INFINITY;
    if (row_b < p.s) p.lse[(size_t)bh * p.s + row_b] = l_b > 0.f ? m_b * LN2 + logf(l_b) : -INFINITY;
  }
  const float inv_a = l_a > 0.f ? 1.f / l_a : 0.f, inv_b = l_b > 0.f ? 1.f / l_b : 0.f;
  store_acc_rows(static_cast<T*>(p.o) + (size_t)bh * p.s * p.hd, o, inv_a, inv_b, row_a, p.s,
                 p.hd, 0, t);
}

template <int HDP>
cudaError_t launch(const Args& p, cudaStream_t stream) {
  using C = Cfg<HDP>;
  const auto kern = fwd_kernel<HDP>;
  static std::atomic<unsigned long long> smem_allowed{0};
  cudaError_t err = allow_max_dynamic_smem(kern, smem_allowed);
  if (err != cudaSuccess) return err;
  static std::atomic<int> regs_checked{0};
  if ((err = check_launch_regs(kern, LAUNCH_REGS, regs_checked)) != cudaSuccess) return err;
  CUtensorMap mq{}, mk{}, mv{};
  if (p.tma) {
    const uint64_t bq = (uint64_t)p.b * p.h, bkv = (uint64_t)p.b * p.hkv;
    const bool ok = encode_3d_bf16(&mq, p.q, bq, p.s, p.hd, BLOCK_Q) &&
                    encode_3d_bf16(&mk, p.k, bkv, p.s, p.hd, C::BK) &&
                    encode_3d_bf16(&mv, p.v, bkv, p.s, p.hd, C::BK);
    // The shapes meet TMA's rules: an encoder that cannot be found or refuses
    // them is an error, never a quiet switch to the element-load producer.
    if (!ok) return cudaErrorNotSupported;
  }
  const dim3 grid(p.h, p.b, (p.s + BLOCK_Q - 1) / BLOCK_Q);
  kern<<<grid, THREADS, C::SMEM, stream>>>(mq, mk, mv, p);
  return cudaGetLastError();
}
}  // namespace wg

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
// one dtype. window <= 0 and softcap <= 0 mean none. hd up to 256. q_offset
// (>= 0) shifts every query row's position in the causal and window masks. lse, when
// not null, receives the fp32 [b, h, s] log-sum-exp of each row's logits (-inf
// for a row with no key) for the backward kernels; the no-grad callers pass null.
extern "C" int ssp_flash_attention(int dtype, const void* q, const void* k, const void* v,
                                   void* o, int b, int h, int hkv, int s, int hd, float scale,
                                   int causal, int window, float softcap, float* lse,
                                   int q_offset, void* stream) {
  using namespace ssp;
  using namespace ssp::flash;
  if (b <= 0 || h <= 0 || hkv <= 0 || s <= 0 || hd <= 0 || hd > 256 || h % hkv != 0 ||
      h > 65535 || b > 65535 || q_offset < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto is16 = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; };
  const int tma = hd % 8 == 0 && is16(q) && is16(k) && is16(v);
  const Args p{q, k, v, o, lse, b, h, hkv, s, hd, scale, causal, window, softcap, tma, q_offset};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kBF16) {
    if (hd <= 64) err = wg::launch<64>(p, st);
    else if (hd <= 128) err = wg::launch<128>(p, st);
    else err = wg::launch<256>(p, st);
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
