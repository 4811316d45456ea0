// MLA decode layer on Hopper: the new latent row written into the pool, then
// decode attention over that pool, in one launch (replaces
// ssp_x_vit_tpu/ops/pallas/paged_attention.py:243 _paged_pallas_grouped and
// :349 _paged_pallas_grouped_q8 as ssp_x_vit_tpu/llm/paged_mla.py:290 calls
// them, paged_attention(q_cat, pool_l, pool_l, page_tables, seq_lens + 1),
// with the row write before it, paged_pool_write at :280: Pallas :541 / :587
// and the quantizer _quantize_token_kv at :469).
//
// What it computes, as paged_mla_attention_write_plain: for sequence i, the
// row new_row[i] (D = 576: kv_lora_rank 512 + rope 64) goes to slot pos =
// positions[i] of its pages (a slot outside the table: row 0 of trash page 0;
// int8 pools: codes and scale of _quantize_token_kv), then for each of nq
// heads the softmax over keys k <= pos of scale * q . row(k), times row(k),
// of which the first 512 columns (all the caller reads) are written. The pool
// is [A, 1, P, ps, 576] bf16, or int8 codes with one fp32 scale per row (a
// row's value is code * scale rounded to bf16, as the plain version reads it).
//
// What bounds it on the H100: each live row (1152 bytes bf16, 580 int8) is
// read once for 2 * nq * (576 + 512) operations: at 128 heads 242 FLOP per
// bf16 byte, just under the card's ridge (295), 480 per int8 byte, above it.
// Inside an SM, a 32-key tile's chain (its copy, S, the softmax, the hand-off
// of P, P V) bounds each CTA; PERF.md has the measured split. What the
// mma.sync kernel (csrc/paged_mla.cu, 16 heads a block) lost at these shapes,
// and what this design does about it:
//   - a row left L2 once per 16 heads: here a CTA holds 64 heads on the M of
//     wgmma; the two head groups of a run are neighbours in launch order, so
//     the second reads a tile from L2 (measured free: no multicast);
//   - the queries were re-staged per tile: here the scorer loads 24 of the
//     36 k-steps of its 64 x 576 queries once, as wgmma A fragments in
//     registers, and TMA stages the other 12 once (24 KB);
//   - loads did not overlap the products: here 32-key tiles stay in flight
//     on full/empty mbarriers, each tile's page-table entries read a tile
//     ahead of its copy. bf16: a 5-stage ring that mixer thread 0 fills by
//     TMA over the pool (one 3D box {64 columns, 32 rows, 9 column boxes} a
//     tile where pages hold 32 keys or more, else a 64-column 2D box per page
//     piece), 128-byte swizzled as wgmma reads it; a stage goes back as soon
//     as its P V is done. int8: codes and scales by cp.async.bulk per page
//     piece into a 4-stage ring that the scorer's thread 0 fills, which the
//     mixers dequantize (code * scale, rounded to bf16) into 3 swizzled
//     stages two tiles ahead (the dequantization is the int8 path's longest
//     step, so the mixers issue no copies there);
//   - mma.sync with fragments gathered by scalar shared loads: here each
//     product runs once on wgmma. The scorer warpgroup computes S = Q K^T
//     (m64n32k16, 36 k-steps, K from shared memory), keeps the online
//     softmax in registers (quad shuffles, 2^x of a folded scale) and hands
//     P, rounded to bf16 in the A-fragment layout, and each row's rescale
//     factor to two mixer warpgroups through a 6 KB record (p_full / p_empty
//     mbarriers); each mixer rescales its accumulator and adds P V
//     (m64n256k16, V read MN-major from the staged tile) on its half of the
//     512 output columns (128 fp32 registers a thread; setmaxnreg moves
//     registers from the scorer to the mixers). S of tile n+1 runs while the
//     mixers add tile n;
//   - all 576 columns of P V: here only the 512 the caller reads;
//   - runs combined by the last block to finish through a global workspace:
//     here a sequence's runs for one head group are one cluster (at most 8
//     CTAs; the plan, paged_mla.py mla_hopper_plan, picks the run count from
//     the card's cluster capacity and the queries' re-read per run). Each
//     run keeps its O, m and l in shared memory; run r sums rows
//     [64 r / runs, 64 (r + 1) / runs) over all runs in run order, reading
//     the others' shared memory, so two calls give the same bits;
//   - two launches a layer (the write, then the attention): here the mixers
//     of the head-group-0 CTA of the run that holds pos write the new row
//     (run 0 writes a slot outside the table), and every CTA of that run puts
//     the row into its own staged tile (bf16: the scorer over the TMA'd row;
//     int8: the dequantization, from the codes it quantized); nothing in the
//     launch reads the written row from memory.
//
// Dispatch (ops/kernels/paged_mla.py paged_mla_attention_write): this kernel
// takes bf16 and int8 pools with D = 576, 512 output columns, a head count
// that is a multiple of 64 and pages of a power of two of at least 8 keys;
// fp32 pools, other head counts and other widths go to csrc/paged_mla.cu.
#include "common.cuh"
#include "hopper.cuh"

#include <cmath>
#include <cstdint>
#include <mutex>

namespace ssp {
namespace mlah {
using namespace ::ssp::hopper;

// Must match POOL_CODES in ops/kernels/build.py.
enum PoolType { kPoolF32 = 0, kPoolBF16 = 1, kPoolI8 = 2 };

constexpr int D = 576;             // must match HOPPER_DIM in ops/kernels/paged_mla.py
constexpr int NB = D / 64;          // 64-column boxes of a row
constexpr int VC = 512;             // output columns (HOPPER_V_COLS)
constexpr int HEADS = 64;           // query heads of a CTA (HOPPER_HEADS)
constexpr int BK = 32;              // keys of a tile (HOPPER_TILE)
// warpgroup 0: the scorer (its thread 0 also copies Q and the int8 codes);
// 1, 2: the mixers (256 output columns each; they also copy bf16 tiles, write
// the new row and dequantize int8 tiles). The mixers' m64n256 accumulators
// need 158+ registers a thread at compile time, so the CTA has 384 threads.
constexpr int THREADS = 384, WG = 128, MIXER_THREADS = 256;
constexpr int MIXER_WARPS = 8;
constexpr int SCORER_REGS = 152, MIXER_REGS = 176;
constexpr int LAUNCH_REGS = (WG * SCORER_REGS + MIXER_THREADS * MIXER_REGS + THREADS - 1) / THREADS;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int SMEM_LIMIT = 227 * 1024;
constexpr int Q_BOX = HEADS * 128;                        // 64 columns of the CTA's queries
constexpr int KV_BOX = BK * 128;                          // one 64-column box of a tile
constexpr int STAGE = NB * KV_BOX;                        // a bf16 tile, 36 KB
constexpr int CODE_BYTES = BK * D, CODE_STAGE = CODE_BYTES + BK * 4;  // int8 codes, then scales
constexpr int QR = 24;         // k-steps of S whose Q fragments the scorer keeps in registers
// the rest of Q (columns 16 QR ..) staged for S's shared-memory k-steps: 24 KB
constexpr int Q_SMEM = (NB - QR / 4) * Q_BOX;
static_assert(QR % 4 == 0, "Q's staged part is whole 64-column boxes");
constexpr int REC_WORDS = 12;  // a scorer thread's P fragments (8 words), its two rows' factors
constexpr int MAX_RUNS = 8;    // runs of a sequence's keys: one cluster (the portable size)
constexpr int ORS = VC + 8;    // row stride (floats) of a run's O in shared memory for the combine
// named barriers (0 is __syncthreads)
constexpr int BAR_SCORER = 1, BAR_ALL = 2, BAR_MIXERS = 3;

template <bool Q8>
struct Cfg {
  static constexpr int STAGES = Q8 ? 3 : 5;       // bf16 tiles
  static constexpr int CODE_STAGES = Q8 ? 4 : 0;
  static constexpr int RING = Q_SMEM;             // offsets from the 1024-aligned base
  static constexpr int CODES = RING + STAGES * STAGE;
  static constexpr int REC = CODES + CODE_STAGES * CODE_STAGE;
  static constexpr int NEW = REC + WG * REC_WORDS * 4;  // int8: the new row's values
  static constexpr int ML = NEW + (Q8 ? 2 * D : 0);     // the scorer's m and l per row
  static constexpr int BARS = ML + 2 * HEADS * 4;
  static constexpr int NBARS = 2 * STAGES + 2 * CODE_STAGES + 3;
  static constexpr size_t SMEM = BARS + NBARS * 8 + 1024;
  static_assert(SMEM <= SMEM_LIMIT, "shared memory");
  static_assert(RING + STAGES * STAGE >= HEADS * ORS * 4, "the combine's O fits over Q and the ring");
};

struct Params {
  const void* q;            // [b, nq, 576] bf16
  const void* new_row;      // [b, 1, 576] bf16
  void* pool;               // [A, 1, P, ps, 576] bf16 or int8 codes
  float* scales;            // int8 pools: [A, 1, P, ps]
  const int* page_table;    // [b, mp]
  const int* positions;     // [b]
  __nv_bfloat16* out;       // [b, nq, 512]
  int nq, ps, mp;
  long long num_pages;
  int layer;
  float scale;
  int pps, splits;
};

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Every thread of every CTA of the cluster; shared-memory writes before it
// are seen by the cluster's reads after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" :::
                   "memory");
}
// The address of this CTA's shared-memory location `addr` in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t at_rank(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
__device__ __forceinline__ float ld_cluster(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ float4 ld_cluster4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// The quantizer of int8 pools, as csrc/paged_attention.cu's: scale = amax /
// 127 (1 where amax == 0), code = clip(round-half-to-even(x / scale), +-127).
__device__ __forceinline__ float kv_scale(float amax) { return amax > 0.f ? amax / 127.0f : 1.0f; }
__device__ __forceinline__ float kv_code(float x, float scale) {
  return fminf(fmaxf(rintf(x / scale), -127.f), 127.f);
}

// Signed byte k of a 32-bit word, as a float (the word stays in a register).
__device__ __forceinline__ float code_at(uint32_t w, int k) {
  return static_cast<float>(static_cast<int>(w << (24 - 8 * k)) >> 24);
}

// grid (head groups, runs, sequences): the two groups of a run are neighbours.
template <bool Q8>
__global__ void __launch_bounds__(THREADS, 1)
    mla_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_pool,
               const Params p) {
  using C = Cfg<Q8>;
  constexpr int STAGES = C::STAGES, CS = Q8 ? C::CODE_STAGES : 1;
  constexpr int SEGS = BK / 8;  // the most page pieces of a tile (pages of 8 keys)
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* qs = smem;
  unsigned char* ring = smem + C::RING;
  uint4* rec = reinterpret_cast<uint4*>(smem + C::REC);  // [128 scorer threads][3]
  __nv_bfloat16* s_new = reinterpret_cast<__nv_bfloat16*>(smem + C::NEW);
  float* s_ml = reinterpret_cast<float*>(smem + C::ML);  // m [64], then l [64]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::BARS);  // a bf16 tile is staged
  uint64_t* empty = full + STAGES;    // bf16: the mixers are done with a tile
  uint64_t* cfull = empty + STAGES;   // int8: the code ring
  uint64_t* cempty = cfull + (Q8 ? CS : 0);
  uint64_t* q_full = cempty + (Q8 ? CS : 0);
  uint64_t* p_full = q_full + 1;      // a P record is written
  uint64_t* p_empty = p_full + 1;     // both mixers have read it
  __shared__ float s_red[MIXER_WARPS];

  const int grp = blockIdx.x, run = blockIdx.y, i = blockIdx.z;
  const int cap = p.mp * p.ps;
  const int pos = p.positions[i];
  const bool in_table = pos >= 0 && pos < cap;
  const int len = pos >= cap ? cap : pos + 1;  // no key for pos < 0
  const int span = p.pps * p.ps;
  const int k_lo = run * span, k_hi = min(len, k_lo + span);
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;
  const bool fold = in_table && pos / span == run;  // this run scores key pos
  const bool writer = grp == 0 && (in_table ? fold : run == 0);
  const int h0 = grp * HEADS;
  const int* table = p.page_table + static_cast<long long>(i) * p.mp;
  const long long layer_row0 = static_cast<long long>(p.layer) * p.num_pages * p.ps;
  const int seg = p.ps < BK ? p.ps : BK;  // keys of one page piece of a tile
  // The table entries of tile n's pieces, read a tile ahead of its copies
  // and not used until then, so the copying thread does not wait on them.
  const auto pages_of = [&](int n, int (&pg)[SEGS]) {
    const int k0 = k_lo + n * BK;
#pragma unroll
    for (int u = 0; u < SEGS; ++u)
      if (u * seg < BK) pg[u] = table[min((k0 + u * seg) / p.ps, p.mp - 1)];
  };
  // the pool row of piece u of tile n (page 0 past the table: a tile's tail
  // past the sequence is copied, then masked)
  const auto piece_row = [&](int n, int u, const int (&pg)[SEGS]) {
    const int k = k_lo + n * BK + u * seg;
    return layer_row0 + static_cast<long long>(k / p.ps < p.mp ? pg[u] : 0) * p.ps + k % p.ps;
  };
  // Tile n's copies: bf16, by TMA into stage n % STAGES once both mixers are
  // done with tile n - STAGES (mixer thread 0 issues them); int8, codes and
  // scales into code stage n % CS once the mixers dequantized tile n - CS
  // from it (the scorer's thread 0 issues them: the mixers' dequantization is
  // the int8 path's longest step).
  const auto copy_tile = [&](int n, const int (&pg)[SEGS]) {
    if constexpr (Q8) {
      const int c = n % CS;
      if (n >= CS) mbar_wait(&cempty[c], ((n / CS) + 1) & 1);
      unsigned char* cst = smem + C::CODES + c * CODE_STAGE;
      mbar_expect_tx(&cfull[c], CODE_STAGE);
#pragma unroll
      for (int u = 0; u < SEGS; ++u) {
        if (u * seg >= BK) break;
        const long long row = piece_row(n, u, pg);
        bulk_load(cst + u * seg * D, static_cast<const int8_t*>(p.pool) + row * D, seg * D, &cfull[c]);
        bulk_load(cst + CODE_BYTES + u * seg * 4, p.scales + row, seg * 4, &cfull[c]);
      }
    } else {
      const int s = n % STAGES;
      if (n >= STAGES) mbar_wait(&empty[s], ((n / STAGES) + 1) & 1);
      unsigned char* st = ring + s * STAGE;
      mbar_expect_tx(&full[s], STAGE);
      if (seg == BK) {  // a whole tile in one 3D box: [9 column boxes][32 rows][128 bytes]
        tma_load_3d(st, &map_pool, 0, static_cast<int>(piece_row(n, 0, pg)), 0, &full[s]);
        return;
      }
#pragma unroll
      for (int u = 0; u < SEGS; ++u) {  // pages under 32 keys: a 2D box per piece and 64 columns
        if (u * seg >= BK) break;
        const int row = static_cast<int>(piece_row(n, u, pg));
#pragma unroll
        for (int b = 0; b < NB; ++b)
          tma_load(st + b * KV_BOX + u * seg * 128, &map_pool, 64 * b, row, &full[s]);
      }
    }
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], Q8 ? MIXER_THREADS : 1);
      mbar_init(&empty[s], MIXER_WARPS);
    }
    if constexpr (Q8)
      for (int c = 0; c < CS; ++c) {
        mbar_init(&cfull[c], 1);
        mbar_init(&cempty[c], MIXER_THREADS);
      }
    mbar_init(q_full, 1);
    mbar_init(p_full, WG);
    mbar_init(p_empty, MIXER_THREADS);
    mbar_init_fence();
  }
  __syncthreads();

  const int role = threadIdx.x / WG;  // 0 scorer, 1-2 mixers
  const int wt = threadIdx.x % WG, warp = wt / 32, lane = wt % 32;
  const int g = lane / 4, t = lane % 4;
  const int row_a = 16 * warp + g, row_b = row_a + 8;  // this thread's heads (of the CTA's 64)
  __nv_bfloat16* out = p.out + (static_cast<long long>(i) * p.nq + h0) * VC;
  // More than one run: the runs of (sequence, head group) are one cluster,
  // CTA rank = run. Each run's O [64][ORS] (from offset 0: Q and the ring
  // are done) and m, l (s_ml) stay in its shared memory; run r sums rows
  // [64 r / runs, 64 (r + 1) / runs) over all runs in run order, reading the
  // others' shared memory, and stores them.
  float* s_o = reinterpret_cast<float*>(smem);
  const auto combine = [&]() {
    const int r0 = run * HEADS / p.splits, rows = (run + 1) * HEADS / p.splits - r0;
    float* s_w = reinterpret_cast<float*>(rec);  // [MAX_RUNS][64] weights, then 1 / l [64]
    cluster_sync();                              // every run's O, m and l are in place
    if (threadIdx.x < rows) {
      const uint32_t m_addr = smem_u32(s_ml + r0 + threadIdx.x);
      float mz[MAX_RUNS], mx = -INFINITY;
#pragma unroll
      for (int z = 0; z < MAX_RUNS; ++z) {
        mz[z] = z < p.splits ? ld_cluster(at_rank(m_addr, z)) : -INFINITY;
        mx = fmaxf(mx, mz[z]);
      }
      float l = 0.f;
#pragma unroll
      for (int z = 0; z < MAX_RUNS; ++z) {
        const float w = mz[z] == -INFINITY ? 0.f : fast_exp2(mz[z] - mx);
        s_w[z * HEADS + threadIdx.x] = w;
        if (z < p.splits) l += w * ld_cluster(at_rank(m_addr + HEADS * 4, z));
      }
      s_w[MAX_RUNS * HEADS + threadIdx.x] = l > 0.f ? 1.f / l : 0.f;
    }
    named_sync(BAR_ALL, THREADS);
    for (int u = threadIdx.x; u < rows * (VC / 4); u += THREADS) {
      const int rl = u / (VC / 4), c = (u % (VC / 4)) * 4;
      const uint32_t addr = smem_u32(s_o + (r0 + rl) * ORS + c);
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int z = 0; z < MAX_RUNS; ++z) {
        if (z >= p.splits) break;
        const float4 v = ld_cluster4(at_rank(addr, z));
        const float w = s_w[z * HEADS + rl];
        acc.x += w * v.x;
        acc.y += w * v.y;
        acc.z += w * v.z;
        acc.w += w * v.w;
      }
      const float inv = s_w[MAX_RUNS * HEADS + rl];
      uint2 packed;
      packed.x = pack_bf16(acc.x * inv, acc.y * inv);
      packed.y = pack_bf16(acc.z * inv, acc.w * inv);
      *reinterpret_cast<uint2*>(out + (r0 + rl) * VC + c) = packed;
    }
    cluster_sync();  // the others are done reading this run's shared memory
  };

  if (role == 0) {
    // the scorer: S = Q K^T of each tile, the online softmax, P to the mixers;
    // thread 0 also copies Q and (int8) the codes
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(SCORER_REGS));
    int nxt[SEGS];  // int8: the pages of the next code tile thread 0 copies
    if (wt == 0 && n_tiles > 0) {
      mbar_expect_tx(q_full, Q_SMEM);
#pragma unroll
      for (int b = QR / 4; b < NB; ++b)
        tma_load(qs + (b - QR / 4) * Q_BOX, &map_q, 64 * b, i * p.nq + h0, q_full);
      if constexpr (Q8) {
        for (int n = 0; n < min(n_tiles, CS); ++n) {
          pages_of(n, nxt);
          copy_tile(n, nxt);
        }
        if (CS < n_tiles) pages_of(CS, nxt);
      }
    }
    const float sl2 = p.scale * LOG2E;
    float sacc[BK / 2], m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
    const uint32_t q_addr = smem_u32(qs);
    // Q's first QR k-steps as A fragments in registers, loaded from global
    // memory (rows 16 warp + g (+8), columns 16 kk + 2t (+8)): S then reads
    // only K from shared memory there
    uint32_t qf[QR][4];
    const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + (static_cast<long long>(i) * p.nq + h0) * D;
#pragma unroll
    for (int kk = 0; kk < QR; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        qf[kk][r] = *reinterpret_cast<const uint32_t*>(qg + (row_a + 8 * (r & 1)) * D + 16 * kk + 2 * t +
                                                       8 * (r >> 1));
    if (n_tiles > 0) mbar_wait(q_full, 0);
    for (int n = 0; n < n_tiles; ++n) {
      const int s = n % STAGES, k0 = k_lo + n * BK;
      mbar_wait(&full[s], (n / STAGES) & 1);
      if constexpr (!Q8) {
        if (fold && pos >= k0 && pos < k0 + BK) {  // the new row over what TMA read
          const uint32_t* src = reinterpret_cast<const uint32_t*>(
              static_cast<const __nv_bfloat16*>(p.new_row) + static_cast<long long>(i) * D);
          unsigned char* st = ring + s * STAGE;
          for (int c = wt; c < D / 2; c += WG)
            *reinterpret_cast<uint32_t*>(st + (c / 32) * KV_BOX + swz(pos - k0, (c % 32) * 4)) = src[c];
          fence_proxy_async();
          named_sync(BAR_SCORER, WG);
        }
      }
      const uint32_t k_addr = smem_u32(ring + s * STAGE);
      fence_regs(sacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t kd = smem_desc(k_addr + (kk / 4) * KV_BOX + (kk % 4) * 32);
        if (kk < QR)
          wgmma_rs<0>(sacc, qf[kk], kd, kk > 0);
        else
          wgmma_ss(sacc, smem_desc(q_addr + (kk / 4 - QR / 4) * Q_BOX + (kk % 4) * 32), kd, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);
      if (k0 + BK > k_hi) {  // keys past the run's end
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (k0 + 8 * j + 2 * t + e >= k_hi) sacc[4 * j + e] = sacc[4 * j + 2 + e] = -INFINITY;
      }
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          mx_a = fmaxf(mx_a, sacc[4 * j + e]);
          mx_b = fmaxf(mx_b, sacc[4 * j + 2 + e]);
        }
      // every tile's first key is live, so the maxima are finite from here on
      const float mn_a = fmaxf(m_a, quad_max(mx_a) * sl2), mn_b = fmaxf(m_b, quad_max(mx_b) * sl2);
      const float alpha_a = fast_exp2(m_a - mn_a), alpha_b = fast_exp2(m_b - mn_b);  // 0 from -inf
      m_a = mn_a;
      m_b = mn_b;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sacc[4 * j + e] = fast_exp2(fmaf(sacc[4 * j + e], sl2, -mn_a));
          sacc[4 * j + 2 + e] = fast_exp2(fmaf(sacc[4 * j + 2 + e], sl2, -mn_b));
          sum_a += sacc[4 * j + e];
          sum_b += sacc[4 * j + 2 + e];
        }
      l_a = l_a * alpha_a + sum_a;  // this thread's columns; the quad's sum at the end
      l_b = l_b * alpha_b + sum_b;
      uint32_t w[REC_WORDS];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) w[4 * kk + r] = pack_bf16(sacc[8 * kk + 2 * r], sacc[8 * kk + 2 * r + 1]);
      w[8] = __float_as_uint(alpha_a);
      w[9] = __float_as_uint(alpha_b);
      w[10] = w[11] = 0u;
      if (n > 0) mbar_wait(p_empty, (n - 1) & 1);  // the mixers have read the last record
#pragma unroll
      for (int k = 0; k < 3; ++k)
        rec[wt * 3 + k] = make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
      mbar_arrive(p_full);
      if constexpr (Q8)  // code stage n % CS takes tile n + CS once tile n is dequantized
        if (wt == 0 && n + CS < n_tiles) {
          copy_tile(n + CS, nxt);
          if (n + CS + 1 < n_tiles) pages_of(n + CS + 1, nxt);
        }
    }
    l_a = quad_sum(l_a);
    l_b = quad_sum(l_b);
    if (t == 0) {
      s_ml[row_a] = m_a;
      s_ml[row_b] = m_b;
      s_ml[HEADS + row_a] = l_a;
      s_ml[HEADS + row_b] = l_b;
    }
    named_sync(BAR_ALL, THREADS);  // m and l for the mixers; Q and the ring are free
    if (p.splits > 1) combine();
    return;
  }

  // the mixers: O = alpha O + P V on columns [256 mw, 256 mw + 256); also the
  // new row, the bf16 copies and (int8) each tile's dequantization two ahead
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(MIXER_REGS));
  const int mw = role - 1, mt = threadIdx.x - WG;
  int cnxt[SEGS];  // bf16: the pages of the next tile mixer thread 0 copies
  if (!Q8 && mt == 0) {
    for (int n = 0; n < min(n_tiles, STAGES); ++n) {
      pages_of(n, cnxt);
      copy_tile(n, cnxt);
    }
    if (STAGES < n_tiles) pages_of(STAGES, cnxt);
  }
  if (writer || (Q8 && fold)) {  // the writer stores it; int8 folds quantize it for their tile
    const __nv_bfloat16* src = static_cast<const __nv_bfloat16*>(p.new_row) + static_cast<long long>(i) * D;
    const long long row =
        layer_row0 + (in_table ? static_cast<long long>(table[pos / p.ps]) * p.ps + pos % p.ps : 0);
    if constexpr (Q8) {
      float amax = 0.f;
      for (int d = mt; d < D; d += MIXER_THREADS) amax = fmaxf(amax, fabsf(__bfloat162float(src[d])));
      amax = warp_max(amax);
      if (lane == 0) s_red[mt / 32] = amax;
      named_sync(BAR_MIXERS, MIXER_THREADS);
      for (int w = 0; w < MIXER_WARPS; ++w) amax = fmaxf(amax, s_red[w]);
      const float sc = kv_scale(amax);
      int8_t* dst = static_cast<int8_t*>(p.pool) + row * D;
      for (int d = mt; d < D; d += MIXER_THREADS) {
        const float code = kv_code(__bfloat162float(src[d]), sc);
        if (writer) dst[d] = static_cast<int8_t>(code);
        s_new[d] = __float2bfloat16(code * sc);
      }
      if (writer && mt == 0) p.scales[row] = sc;
      named_sync(BAR_MIXERS, MIXER_THREADS);  // s_new is whole
    } else {
      uint32_t* dst = reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(p.pool) + row * D);
      const uint32_t* s32 = reinterpret_cast<const uint32_t*>(src);
      for (int c = mt; c < D / 2; c += MIXER_THREADS) dst[c] = s32[c];
    }
  }
  // int8: tile m's codes into bf16 stage m % STAGES (its last tile's P V and
  // S are done), key pos from s_new
  const auto dequant = [&](int m) {
    const int c = m % CS, s = m % STAGES, k0 = k_lo + m * BK;
    mbar_wait(&cfull[c], (m / CS) & 1);
    const unsigned char* cst = smem + C::CODES + c * CODE_STAGE;
    const float* sc = reinterpret_cast<const float*>(cst + CODE_BYTES);
    unsigned char* st = ring + s * STAGE;
    const int prow = fold && pos >= k0 && pos < k0 + BK ? pos - k0 : -1;
#pragma unroll 3
    for (int e = mt; e < BK * (D / 8); e += MIXER_THREADS) {
      const int r = e / (D / 8), col = (e % (D / 8)) * 8;
      uint4 w;
      if (r == prow) {
        w = *reinterpret_cast<const uint4*>(s_new + col);
      } else {
        const uint2 v = *reinterpret_cast<const uint2*>(cst + r * D + col);
        const float f = sc[r];
        w.x = pack_bf16(code_at(v.x, 0) * f, code_at(v.x, 1) * f);
        w.y = pack_bf16(code_at(v.x, 2) * f, code_at(v.x, 3) * f);
        w.z = pack_bf16(code_at(v.y, 0) * f, code_at(v.y, 1) * f);
        w.w = pack_bf16(code_at(v.y, 2) * f, code_at(v.y, 3) * f);
      }
      *reinterpret_cast<uint4*>(st + (col / 64) * KV_BOX + swz(r, (col % 64) * 2)) = w;
    }
    fence_proxy_async();
    mbar_arrive(&full[s]);
    mbar_arrive(&cempty[c]);
  };
  if constexpr (Q8)
    for (int m = 0; m < min(n_tiles, STAGES - 1); ++m) dequant(m);
  float o[VC / 4];
#pragma unroll
  for (int k = 0; k < VC / 4; ++k) o[k] = 0.f;
  uint32_t pf[BK / 16][4];
  for (int n = 0; n < n_tiles; ++n) {
    const int s = n % STAGES;
    mbar_wait(p_full, n & 1);
    const uint4 r0 = rec[wt * 3], r1 = rec[wt * 3 + 1], r2 = rec[wt * 3 + 2];
    mbar_arrive(p_empty);
    pf[0][0] = r0.x; pf[0][1] = r0.y; pf[0][2] = r0.z; pf[0][3] = r0.w;
    pf[1][0] = r1.x; pf[1][1] = r1.y; pf[1][2] = r1.z; pf[1][3] = r1.w;
    const float alpha_a = __uint_as_float(r2.x), alpha_b = __uint_as_float(r2.y);
    wgmma_wait<0>();  // int8: P V of the last tile is done with o and with its stage
    fence_regs(o);
#pragma unroll
    for (int j = 0; j < VC / 2 / 8; ++j) {
      o[4 * j] *= alpha_a;
      o[4 * j + 1] *= alpha_a;
      o[4 * j + 2] *= alpha_b;
      o[4 * j + 3] *= alpha_b;
    }
    // the staged tile: complete before the scorer used it (bf16: TMA; int8:
    // these threads' own stores)
    if constexpr (!Q8) mbar_wait(&full[s], (n / STAGES) & 1);
    const uint32_t v_addr = smem_u32(ring + s * STAGE) + mw * (VC / 2 / 64) * KV_BOX;
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<1>(o, pf[kk], smem_desc_mn(v_addr + kk * 2048, KV_BOX), 1);
    wgmma_commit();
    if constexpr (Q8) {  // into the stage of tile n - 1, while the tensor cores add tile n
      if (n + STAGES - 1 < n_tiles) dequant(n + STAGES - 1);
    } else {  // bf16: the stage takes tile n + STAGES as soon as P V is done with it
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(&empty[s]);
      if (mt == 0 && n + STAGES < n_tiles) {
        copy_tile(n + STAGES, cnxt);
        if (n + STAGES + 1 < n_tiles) pages_of(n + STAGES + 1, cnxt);
      }
    }
  }
  wgmma_wait<0>();
  fence_regs(o);
  named_sync(BAR_ALL, THREADS);
  const int col0 = mw * (VC / 2);
  if (p.splits == 1) {
    const float l_a = s_ml[HEADS + row_a], l_b = s_ml[HEADS + row_b];
    store_acc_rows(out, o, l_a > 0.f ? 1.f / l_a : 0.f, l_b > 0.f ? 1.f / l_b : 0.f, row_a, HEADS,
                   VC, col0, t);
    return;
  }
#pragma unroll
  for (int j = 0; j < VC / 2 / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(s_o + (row_a + 8 * h) * ORS + col0 + 8 * j + 2 * t) =
          make_float2(o[4 * j + 2 * h], o[4 * j + 2 * h + 1]);
  combine();
}

// Tensor maps of pools, kept across calls: a decode step launches once per
// layer over the same pool, and the encoder's cost would be paid each time.
struct MapEntry {
  const void* base;
  uint64_t rows;
  uint32_t box_rows;
  int device;
  CUtensorMap map;
};

// The pool as TMA sees it: for pages of at least BK keys, a 3D map {64
// columns, rows, 9 column boxes} (strides 1152 and 128 bytes) whose BK-row
// box is a whole tile in the stage's layout; for smaller pages, a 2D map
// [rows, 576] with boxes of 64 columns by box_rows rows.
bool encode_pool(CUtensorMap* map, const void* base, uint64_t rows, uint32_t box_rows) {
  if (box_rows != BK) return encode_2d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, D, rows, 2 * D, 64, box_rows);
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {64, rows, NB}, strides[2] = {2 * D, 128};
  const cuuint32_t box[3] = {64, BK, NB}, elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool pool_map(CUtensorMap* map, const void* base, uint64_t rows, uint32_t box_rows) {
  static std::mutex mu;
  static MapEntry cache[16];
  static int next = 0;
  const int device = current_device();
  std::lock_guard<std::mutex> lock(mu);
  for (const MapEntry& e : cache)
    if (e.base == base && e.rows == rows && e.box_rows == box_rows && e.device == device) {
      *map = e.map;
      return true;
    }
  if (!encode_pool(map, base, rows, box_rows)) return false;
  cache[next] = MapEntry{base, rows, box_rows, device, *map};
  next = (next + 1) % 16;
  return true;
}

// A launch of `grid` whose `runs` CTAs along y form one cluster.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg{};
  cudaLaunchAttribute attr[1];
  ClusterLaunch(dim3 grid, int runs, size_t smem, cudaStream_t stream) {
    cfg.gridDim = grid;
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = runs;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// The kernel, opted into its shared memory and checked for setmaxnreg's
// launch registers once per card.
template <bool Q8>
cudaError_t ready() {
  static std::atomic<unsigned long long> smem_allowed{0};
  cudaError_t err = allow_max_dynamic_smem(mla_kernel<Q8>, smem_allowed);
  if (err != cudaSuccess) return err;
  static std::atomic<int> regs_checked{0};
  return check_launch_regs(mla_kernel<Q8>, LAUNCH_REGS, regs_checked);
}

template <bool Q8>
int max_clusters(int runs) {
  if (ready<Q8>() != cudaSuccess) return 0;
  ClusterLaunch l(dim3(1, runs, 1), runs, Cfg<Q8>::SMEM, nullptr);
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, mla_kernel<Q8>, &l.cfg) == cudaSuccess ? n : 0;
}

template <bool Q8>
cudaError_t launch(const Params& p, int b, uint64_t pool_rows, cudaStream_t stream) {
  cudaError_t err = ready<Q8>();
  if (err != cudaSuccess) return err;
  CUtensorMap mq{}, mp{};
  const uint32_t seg = p.ps < BK ? p.ps : BK;
  // The shapes meet TMA's rules (the wrapper's dispatch): an encoder that
  // cannot be found or refuses them is an error, never another path.
  if (!encode_2d(&mq, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p.q, D, (uint64_t)b * p.nq, 2 * D, 64, HEADS))
    return cudaErrorNotSupported;
  if (!Q8 && !pool_map(&mp, p.pool, pool_rows, seg)) return cudaErrorNotSupported;
  ClusterLaunch l(dim3(p.nq / HEADS, p.splits, b), p.splits, Cfg<Q8>::SMEM, stream);
  err = cudaLaunchKernelEx(&l.cfg, mla_kernel<Q8>, mq, mp, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace mlah
}  // namespace ssp

// The most clusters of `runs` CTAs (1-8) of the kernel for `pool_type` that
// the current card holds at once (0 on an error).
extern "C" int ssp_paged_mla_hopper_clusters(int pool_type, int runs) {
  using namespace ssp::mlah;
  if (runs < 1 || runs > MAX_RUNS) return 0;
  return pool_type == kPoolI8 ? max_clusters<true>(runs) : max_clusters<false>(runs);
}

// The MLA decode layer in one launch: new_row [b, 1, 576] (bf16) into slot
// positions[i] of layer `layer` of the pool [layers, 1, P, ps, 576] (bf16, or
// int8 codes with fp32 `scales` [layers, 1, P, ps]; a slot outside the table
// [b, mp]: row 0 of trash page 0), then out [b, nq, 512] (bf16) = the first
// 512 columns of softmax_k(scale * q . row(k)) row(k) over keys k <=
// positions[i] (all mp * ps past the table). nq a multiple of 64; ps a power
// of two >= 8. The keys run in `splits` runs (at most 8, one cluster) of
// `pages_per_split` pages, whole 32-key tiles each when splits > 1.
extern "C" int ssp_paged_mla_hopper_write(int pool_type, const void* q, const void* new_row,
                                          void* pool, void* scales, const void* page_table,
                                          const void* positions, void* out, int b, int nq, int ps,
                                          int mp, long long num_pages, int layers, int layer,
                                          float scale, int pages_per_split, int splits,
                                          void* stream_ptr) {
  using namespace ssp::mlah;
  const bool q8 = pool_type == kPoolI8;
  const uint64_t pool_rows = (uint64_t)layers * num_pages * ps;
  const auto aligned = [](const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; };
  if (b <= 0 || b > 65535 || nq <= 0 || nq % HEADS || nq / HEADS > 65535 || ps < 8 ||
      (ps & (ps - 1)) || mp <= 0 || num_pages <= 0 || layers <= 0 || layer < 0 || layer >= layers ||
      pool_rows >= 0x7fffffffULL || (long long)mp * ps > 0x7fffffff || pages_per_split <= 0 ||
      splits <= 0 || splits > MAX_RUNS || (long long)pages_per_split * splits < mp ||
      (splits > 1 && (long long)pages_per_split * ps % BK) ||
      (pool_type != kPoolBF16 && pool_type != kPoolI8) || q8 != (scales != nullptr) ||
      !aligned(q) || !aligned(new_row) || !aligned(pool) || !aligned(out) || (q8 && !aligned(scales)))
    return cudaErrorInvalidValue;
  const Params p{q, new_row, pool, static_cast<float*>(scales), static_cast<const int*>(page_table),
                 static_cast<const int*>(positions), static_cast<__nv_bfloat16*>(out), nq, ps, mp,
                 num_pages, layer, scale, pages_per_split, splits};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return q8 ? launch<true>(p, b, pool_rows, stream) : launch<false>(p, b, pool_rows, stream);
}
