// Paged decode attention over one MLA latent pool (replaces
// ssp_x_vit_tpu/ops/pallas/paged_attention.py's paged_attention_pallas as
// llm/paged_mla.py calls it: q_cat against one pool that is both K and V,
// nkv = 1, nq query heads, rows of D = kv_lora_rank + qk_rope_head_dim).
//
// What it computes, as paged_attention_plain(q, pool, pool, ...): for each
// sequence i and head h, softmax over the keys pos < seq_lens[i] (through the
// page table) of scale * q[i, h] . row(pos), times row(pos), of which the
// first v_cols columns are written. The pool is [A, 1, P, ps, D] (layer
// `layer`); fp32 and bf16 pools hold values, int8 pools codes with one fp32
// scale per row (a row's value is code * scale, rounded to bf16, as the plain
// version dequantizes).
//
// Write-and-attend (with new_row; the MLA decode layer in one launch): row
// pos = positions[i] gets new_row[i] first (int8 pools: the quantizer of
// csrc/paged_attention.cu; a slot outside the table: row 0 of trash page 0,
// by run 0), and the keys are pos <= positions[i]. The blocks of the run
// that holds pos build the row as the pool will hold it, head group 0's
// block writes it, and each puts it into its own staged tile over what it
// read. This kernel serves the write-and-attend call for fp32 pools (their
// 1e-5 limit rules out bf16 tensor cores), head counts that are not a
// multiple of 64 and widths other than DeepSeek-V2/V3's 576 / 512; the rest
// goes to csrc/paged_mla_hopper.cu (ops/kernels/paged_mla.py dispatches by
// shape and dtype alone).
//
// What bounds it: every live row is read once and used for 4 * nq * D
// operations. At DeepSeek-V3 widths (nq 128, D 576) that is 242 FLOP per
// bf16 byte, near the card's ridge, so the products run on the tensor cores:
// mma.sync m16n8k16 (bf16 in, fp32 accumulate) with 16 query heads on M.
//
// Design (one block of 8 warps per (group of 16 heads, key run, sequence)):
//   - the keys split into runs of whole pages (paged_mla.py mla_split_plan,
//     from the shapes alone); the block walks its run in tiles of 64 keys,
//     staged in shared memory once and used for both products (the row is
//     the key and the value);
//   - S = Q K^T: warp w scores keys 8w..8w+7 of the tile over all D columns;
//     the scaled fp32 scores go to shared memory, where warp w keeps the
//     online softmax of heads 2w, 2w+1 (fp32 max, sum and rescale factor) and
//     writes p, rounded to bf16, as the A operand of the second product;
//   - O += P V: warp w owns the output columns 8n..8n+7 for n = w, w + 8, ...
//     in registers (the C fragments), rescaled by the factor, then adds the
//     tile's product;
//   - fp32 pools run the same tiles and fragment ownership with fp32 FMAs
//     (tensor-core bf16 would break the fp32 tolerance);
//   - more than one run: each writes its fp32 partial state (m, l and the
//     unnormalized output), and the last block of a (sequence, group) to
//     finish (a ticket counter, set back to 0) combines them in run order, so
//     every call gives the same bits.
// Tiles are loaded by all threads without overlap with the products: the
// rows of a tile's keys are looked up once, then fp32 and bf16 rows arrive by
// 16-byte cp.async copies all in flight at once, int8 codes through registers
// four loads at a time; two blocks share an SM (the largest shared-memory
// carveout). Keys past a sequence's length are zero-filled and masked. The
// served DeepSeek-V3 shapes take the wgmma kernel (csrc/paged_mla_hopper.cu);
// this one stays simple for the shapes it serves.
#include "common.cuh"

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <type_traits>

namespace ssp {
namespace {

// Must match POOL_CODES in ops/kernels/build.py.
enum PoolType { kPoolF32 = 0, kPoolBF16 = 1, kPoolI8 = 2 };

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kHeads = 16;    // query heads of one block (the M of the mma)
constexpr int kTile = 64;     // keys per tile (8 warps x 8)
constexpr int kMaxDim = 576;  // must match MLA_MAX_DIM in ops/kernels/paged_mla.py
constexpr int kMaxNt = kMaxDim / 8 / kWarps;  // 8-column output tiles per warp

struct Params {
  const void* q;
  const void* pool;
  const float* scales;    // int8 pools, else null
  const int* page_table;
  const int* seq_lens;    // with new_row: the positions of the new rows
  const void* new_row;    // write-and-attend: [b, 1, D] in q's dtype, else null
  void* out;              // [b, nq, v_cols]
  float* partial;         // [b, groups, splits, kHeads * (v_cols + 2)] when splits > 1
  int* tickets;           // [b, groups] when splits > 1, 0 on entry and on exit
  int nq, groups, D, Dp, v_cols, ps, mp;
  long long num_pages;
  int layer;
  float scale;
  int pages_per_split, splits;
};

template <typename T> struct Tile;
template <> struct Tile<float> { static constexpr int kPad = 4; };
template <> struct Tile<__nv_bfloat16> { static constexpr int kPad = 8; };

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

template <typename TT>
__host__ __device__ inline int row_stride(int Dp) { return Dp + Tile<TT>::kPad; }

template <typename TT>
__host__ __device__ inline size_t smem_bytes(int Dp) {
  const int rs = row_stride<TT>(Dp);
  const int ps = kTile + Tile<TT>::kPad;
  return static_cast<size_t>(kTile + kHeads) * rs * sizeof(TT) + kHeads * ps * sizeof(TT) +
         kHeads * kTile * sizeof(float) + 3 * kHeads * sizeof(float) +
         kTile * sizeof(long long) + rs * sizeof(TT);
}

// The quantizer of int8 pools, as csrc/paged_attention.cu's: scale = amax /
// 127 (1 where amax == 0), code = clip(round-half-to-even(x / scale), +-127).
__device__ __forceinline__ float kv_scale(float amax) { return amax > 0.f ? amax / 127.0f : 1.0f; }
__device__ __forceinline__ float kv_code(float x, float scale) {
  return fminf(fmaxf(rintf(x / scale), -127.f), 127.f);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Eight int8 codes of a pool row (in registers) into the bf16 tile: code *
// scale, rounded to bf16, as the plain version dequantizes.
template <typename TT>
__device__ __forceinline__ void dequant8(const int8_t* codes, float scale, TT* dst) {
#pragma unroll
  for (int j = 0; j < 8; ++j) dst[j] = from_f<TT>(static_cast<float>(codes[j]) * scale);
}

template <typename TQ, typename TP>
__global__ void __launch_bounds__(kThreads)
mla_kernel(Params p) {
  using TT = typename std::conditional<std::is_same<TP, float>::value, float,
                                       __nv_bfloat16>::type;
  constexpr bool kMma = std::is_same<TT, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const int rs = row_stride<TT>(p.Dp), prs = kTile + Tile<TT>::kPad;
  TT* s_k = reinterpret_cast<TT*>(smem);                    // [kTile][rs]
  TT* s_q = s_k + kTile * rs;                                // [kHeads][rs]
  TT* s_p = s_q + kHeads * rs;                               // [kHeads][prs]
  float* s_s = reinterpret_cast<float*>(s_p + kHeads * prs);  // [kHeads][kTile]
  float* s_m = s_s + kHeads * kTile;
  float* s_l = s_m + kHeads;
  float* s_a = s_l + kHeads;
  long long* s_row = reinterpret_cast<long long*>(s_a + kHeads);  // [kTile], 8-byte aligned
  TT* s_new = reinterpret_cast<TT*>(s_row + kTile);  // write-and-attend: the new row as read back

  // the head groups of one (sequence, run) are neighbours in launch order, so
  // the run's rows come from L2 after the first group reads them
  const int grp = blockIdx.x, split = blockIdx.y, i = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int D = p.D, Dp = p.Dp, cpr = D / 8;
  const int h0 = grp * kHeads;

  // Q of the 16 heads (zero rows past nq, zero columns past D), and the
  // tile's pad columns, which no load writes.
  for (int idx = tid; idx < kHeads * Dp; idx += kThreads) {
    const int r = idx / Dp, d = idx % Dp;
    float v = 0.f;
    if (h0 + r < p.nq && d < D)
      v = to_f(static_cast<const TQ*>(p.q)[(static_cast<long long>(i) * p.nq + h0 + r) * D + d]);
    s_q[r * rs + d] = from_f<TT>(v);
  }
  for (int idx = tid; idx < kTile * (Dp - D); idx += kThreads)
    s_k[(idx / (Dp - D)) * rs + D + idx % (Dp - D)] = from_f<TT>(0.f);
  if (tid < kHeads) {
    s_m[tid] = -INFINITY;
    s_l[tid] = 0.f;
  }

  // write-and-attend: key pos = positions[i] lies in one run, whose blocks
  // put the new row into their tile (fold) and whose head group 0 writes it to
  // the pool (a slot outside the table: row 0 of trash page 0, by run 0)
  const int cap = p.mp * p.ps, span = p.pages_per_split * p.ps;
  const int pos = p.seq_lens[i];
  const bool write = p.new_row != nullptr, in_table = pos >= 0 && pos < cap;
  const int len = !write ? min(pos, cap) : pos >= cap ? cap : pos + 1;
  const bool fold = write && in_table && pos / span == split;
  const bool writer = write && grp == 0 && (in_table ? fold : split == 0);
  const int k_lo = split * span;
  const int k_hi = min(len, k_lo + span);
  const int* table = p.page_table + static_cast<long long>(i) * p.mp;
  const TP* pool = static_cast<const TP*>(p.pool) +
                   static_cast<long long>(p.layer) * p.num_pages * p.ps * D;
  const float* scales = p.scales == nullptr ? nullptr
                        : p.scales + static_cast<long long>(p.layer) * p.num_pages * p.ps;
  if (fold || writer) {
    // the new row as the pool will hold it (int8: quantized, then read back
    // as code * scale in bf16), written to the pool by the writer
    const TQ* src = static_cast<const TQ*>(p.new_row) + static_cast<long long>(i) * D;
    const long long row = in_table ? static_cast<long long>(table[pos / p.ps]) * p.ps + pos % p.ps : 0;
    TP* dst = const_cast<TP*>(pool) + row * D;
    if constexpr (std::is_same<TP, int8_t>::value) {
      float amax = 0.f;
      for (int d = tid; d < D; d += kThreads) amax = fmaxf(amax, fabsf(to_f(src[d])));
      amax = warp_max(amax);
      if (lane == 0) s_s[warp] = amax;
      __syncthreads();
      for (int w = 0; w < kWarps; ++w) amax = fmaxf(amax, s_s[w]);
      const float sc = kv_scale(amax);
      for (int d = tid; d < D; d += kThreads) {
        const float code = kv_code(to_f(src[d]), sc);
        if (writer) dst[d] = static_cast<int8_t>(code);
        s_new[d] = from_f<TT>(code * sc);
      }
      if (writer && tid == 0) const_cast<float*>(scales)[row] = sc;
    } else {
      for (int d = tid; d < D; d += kThreads) {
        const TP v = from_f<TP>(to_f(src[d]));
        if (writer) dst[d] = v;
        s_new[d] = v;
      }
    }
    __syncthreads();  // s_new is whole, and s_s free again
  }

  float acc[kMaxNt][4];
#pragma unroll
  for (int n = 0; n < kMaxNt; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const int n_tiles_out = p.v_cols / 8;

  for (int k0 = k_lo; k0 < k_hi; k0 += kTile) {
    __syncthreads();  // the previous tile's products are done with s_k, s_p, s_row
    if (tid < kTile) {  // the pool row of each key of the tile (-1: past the run)
      const int pos = k0 + tid;
      s_row[tid] = pos < k_hi ? static_cast<long long>(table[pos / p.ps]) * p.ps + pos % p.ps
                              : -1;
    }
    __syncthreads();
    if constexpr (std::is_same<TP, int8_t>::value) {
      // codes through registers (each converted to bf16 with its row's scale),
      // four 8-byte loads in flight before the first store
      constexpr int kBatch = 4;
      for (int idx0 = tid; idx0 < kTile * cpr; idx0 += kBatch * kThreads) {
        uint2 v[kBatch];
        float sc[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int idx = idx0 + u * kThreads;
          const long long row = idx < kTile * cpr ? s_row[idx / cpr] : -1;
          v[u] = row >= 0 ? __ldg(reinterpret_cast<const uint2*>(pool + row * D) + idx % cpr)
                          : make_uint2(0u, 0u);
          sc[u] = row >= 0 ? __ldg(scales + row) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int idx = idx0 + u * kThreads;
          if (idx < kTile * cpr)
            dequant8<TT>(reinterpret_cast<const int8_t*>(&v[u]), sc[u],
                         s_k + (idx / cpr) * rs + (idx % cpr) * 8);
        }
      }
    } else {
      // fp32 and bf16 rows: 16-byte asynchronous copies straight into the
      // tile, all in flight at once; keys past the run are zero-filled
      constexpr int kPer = 16 / sizeof(TP);
      const int c16 = D / kPer;
      for (int idx = tid; idx < kTile * c16; idx += kThreads) {
        const int key = idx / c16, c = idx % c16;
        const long long row = s_row[key];
        cp_async16(s_k + key * rs + c * kPer, pool + (row >= 0 ? row * D + c * kPer : 0),
                   row >= 0);
      }
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    if (fold && pos >= k0 && pos < k0 + kTile) {  // key pos: the new row over what was read
      for (int d = tid; d < D; d += kThreads) s_k[(pos - k0) * rs + d] = s_new[d];
      __syncthreads();
    }

    // S = Q K^T for keys 8 * warp .. 8 * warp + 7 of the tile
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    const int kb = warp * 8;
    if constexpr (kMma) {
      for (int d0 = 0; d0 < Dp; d0 += 16) {
        uint32_t a[4];
        a[0] = ld32(s_q + g * rs + d0 + 2 * t);
        a[1] = ld32(s_q + (g + 8) * rs + d0 + 2 * t);
        a[2] = ld32(s_q + g * rs + d0 + 2 * t + 8);
        a[3] = ld32(s_q + (g + 8) * rs + d0 + 2 * t + 8);
        mma_bf16(s, a, ld32(s_k + (kb + g) * rs + d0 + 2 * t),
                 ld32(s_k + (kb + g) * rs + d0 + 2 * t + 8));
      }
    } else {
      const TT* q0 = s_q + g * rs;
      const TT* q1 = s_q + (g + 8) * rs;
      const TT* k0r = s_k + (kb + 2 * t) * rs;
      const TT* k1r = k0r + rs;
      for (int d = 0; d < D; ++d) {
        const float a0 = to_f(q0[d]), a1 = to_f(q1[d]), b0 = to_f(k0r[d]), b1 = to_f(k1r[d]);
        s[0] = fmaf(a0, b0, s[0]);
        s[1] = fmaf(a0, b1, s[1]);
        s[2] = fmaf(a1, b0, s[2]);
        s[3] = fmaf(a1, b1, s[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = g + (j >> 1) * 8, key = kb + 2 * t + (j & 1);
      s_s[r * kTile + key] = k0 + key < k_hi ? s[j] * p.scale : -INFINITY;
    }
    __syncthreads();

    // online softmax of heads 2 * warp, 2 * warp + 1 (each lane two keys)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = warp * 2 + rr;
      const float x0 = s_s[r * kTile + lane], x1 = s_s[r * kTile + lane + 32];
      const float m_old = s_m[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(x0, x1)));
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      s_p[r * prs + lane] = from_f<TT>(p0);
      s_p[r * prs + lane + 32] = from_f<TT>(p1);
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        s_a[r] = alpha;
        s_l[r] = s_l[r] * alpha + sum;
        s_m[r] = m_new;
      }
    }
    __syncthreads();

    // O = alpha O + P V on this warp's output columns
    const float al0 = s_a[g], al1 = s_a[g + 8];
#pragma unroll
    for (int n = 0; n < kMaxNt; ++n) {
      const int nt = warp + n * kWarps;
      if (nt >= n_tiles_out) break;
      acc[n][0] *= al0;
      acc[n][1] *= al0;
      acc[n][2] *= al1;
      acc[n][3] *= al1;
      if constexpr (kMma) {
        const int col = nt * 8 + g;
#pragma unroll
        for (int k16 = 0; k16 < kTile; k16 += 16) {
          uint32_t a[4];
          a[0] = ld32(s_p + g * prs + k16 + 2 * t);
          a[1] = ld32(s_p + (g + 8) * prs + k16 + 2 * t);
          a[2] = ld32(s_p + g * prs + k16 + 2 * t + 8);
          a[3] = ld32(s_p + (g + 8) * prs + k16 + 2 * t + 8);
          const TT* v = s_k + (k16 + 2 * t) * rs + col;
          const uint32_t b0 = pack_bf16(v[0], v[rs]);
          const uint32_t b1 = pack_bf16(v[8 * rs], v[9 * rs]);
          mma_bf16(acc[n], a, b0, b1);
        }
      } else {
        const int col = nt * 8 + 2 * t;
        const TT* p0r = s_p + g * prs;
        const TT* p1r = s_p + (g + 8) * prs;
        for (int key = 0; key < kTile; ++key) {
          const float pa = to_f(p0r[key]), pb = to_f(p1r[key]);
          const float v0 = to_f(s_k[key * rs + col]), v1 = to_f(s_k[key * rs + col + 1]);
          acc[n][0] = fmaf(pa, v0, acc[n][0]);
          acc[n][1] = fmaf(pa, v1, acc[n][1]);
          acc[n][2] = fmaf(pb, v0, acc[n][2]);
          acc[n][3] = fmaf(pb, v1, acc[n][3]);
        }
      }
    }
  }
  __syncthreads();

  TQ* out = static_cast<TQ*>(p.out);
  if (p.splits == 1) {
    const float l0 = s_l[g], l1 = s_l[g + 8];
    const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f, inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
#pragma unroll
    for (int n = 0; n < kMaxNt; ++n) {
      const int nt = warp + n * kWarps;
      if (nt >= n_tiles_out) break;
      const int col = nt * 8 + 2 * t;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int h = h0 + g + (j >> 1) * 8;
        if (h < p.nq)
          out[(static_cast<long long>(i) * p.nq + h) * p.v_cols + col + (j & 1)] =
              from_f<TQ>(acc[n][j] * ((j >> 1) ? inv1 : inv0));
      }
    }
    return;
  }

  // a run's partial state: m [kHeads], l [kHeads], then the unnormalized
  // output [kHeads][v_cols]
  const int VC = p.v_cols, stride = kHeads * (VC + 2);
  const long long base = static_cast<long long>(i) * p.groups + grp;
  float* part = p.partial + (base * p.splits + split) * stride;
  if (tid < kHeads) {
    part[tid] = s_m[tid];
    part[kHeads + tid] = s_l[tid];
  }
#pragma unroll
  for (int n = 0; n < kMaxNt; ++n) {
    const int nt = warp + n * kWarps;
    if (nt >= n_tiles_out) break;
    const int col = nt * 8 + 2 * t;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      part[2 * kHeads + (g + (j >> 1) * 8) * VC + col + (j & 1)] = acc[n][j];
  }
  __threadfence();
  __syncthreads();
  __shared__ int last;
  if (tid == 0) {
    int* ticket = p.tickets + base;
    last = atomicAdd(ticket, 1) == p.splits - 1;
    if (last) *ticket = 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the last run combines all runs in run order: weights exp(m_z - m) into
  // s_s [splits][kHeads] (at most kTile runs fit), the total l into s_l
  const float* part0 = p.partial + base * p.splits * stride;
  if (tid < kHeads) {
    float m = -INFINITY;
    for (int z = 0; z < p.splits; ++z) m = fmaxf(m, __ldcg(part0 + z * stride + tid));
    float l = 0.f;
    for (int z = 0; z < p.splits; ++z) {
      const float mz = __ldcg(part0 + z * stride + tid);
      const float w = mz == -INFINITY ? 0.f : expf(mz - m);
      s_s[z * kHeads + tid] = w;
      l += w * __ldcg(part0 + z * stride + kHeads + tid);
    }
    s_l[tid] = l > 0.f ? 1.f / l : 0.f;
  }
  __syncthreads();
  for (int idx = tid; idx < kHeads * VC; idx += kThreads) {
    const int r = idx / VC;
    if (h0 + r >= p.nq) continue;
    float v = 0.f;
    for (int z = 0; z < p.splits; ++z) {
      const float w = s_s[z * kHeads + r];
      if (w != 0.f) v += w * __ldcg(part0 + z * stride + 2 * kHeads + idx);
    }
    out[(static_cast<long long>(i) * p.nq + h0 + r) * VC + idx % VC] = from_f<TQ>(v * s_l[r]);
  }
}

template <typename TQ, typename TP>
cudaError_t launch(const Params& p, int b, cudaStream_t stream) {
  using TT = typename std::conditional<std::is_same<TP, float>::value, float,
                                       __nv_bfloat16>::type;
  static std::atomic<unsigned long long> opted{0};
  cudaError_t err = allow_shared_blocks(mla_kernel<TQ, TP>, opted);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.groups, p.splits, b);
  mla_kernel<TQ, TP><<<grid, kThreads, smem_bytes<TT>(p.Dp), stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ssp

// Decode attention over layer `layer` of the MLA latent pool [A, 1, P, ps, D]:
// out[b, nq, v_cols] (q's dtype) = the first v_cols columns of
// softmax_pos(scale * q . row(pos)) row(pos) over the keys pos < seq_lens[i]
// through page_table [b, mp]. With new_row ([b, 1, D] in q's dtype), seq_lens
// holds positions: row positions[i] is written first (int8 pools quantize it;
// a slot outside the table: row 0 of trash page 0) and the keys are pos <=
// positions[i]. fp32 pools take fp32 q, bf16 pools bf16 q, int8 pools (codes
// with `scales` [A, 1, P, ps]) bf16 q. D <= 576 and v_cols <= D multiples of
// 8. The keys run in `splits` runs of `pages_per_split` pages (splits *
// pages_per_split >= mp, at most 64 runs); splits > 1 takes `workspace` (fp32,
// b * groups * splits * 16 * (v_cols + 2), groups = ceil(nq / 16)) and
// `tickets` (int32 [b * groups], all 0; 0 again after).
extern "C" int ssp_paged_mla_attention(int q_dtype, int pool_type, const void* q,
                                       const void* pool, const void* scales,
                                       const void* page_table, const void* seq_lens,
                                       const void* new_row, void* out, int b, int nq, int D,
                                       int v_cols, int ps, int mp, long long num_pages,
                                       int layer, float scale, int pages_per_split, int splits,
                                       float* workspace, int* tickets, void* stream_ptr) {
  using namespace ssp;
  if (b <= 0 || b > 65535 || nq <= 0 || D <= 0 || D > kMaxDim || D % 8 || ps <= 0 || mp <= 0 ||
      v_cols <= 0 || v_cols > D || v_cols % 8 ||
      pages_per_split <= 0 || splits <= 0 || splits > kTile || splits > 65535 ||
      (long long)pages_per_split * splits < mp || (long long)mp * ps > 0x7fffffff ||
      (splits > 1 && (workspace == nullptr || tickets == nullptr)) ||
      (pool_type == kPoolI8) != (scales != nullptr))
    return cudaErrorInvalidValue;
  const int groups = (nq + kHeads - 1) / kHeads;
  if (groups > 65535) return cudaErrorInvalidValue;
  const Params p{q, pool, static_cast<const float*>(scales), static_cast<const int*>(page_table),
                 static_cast<const int*>(seq_lens), new_row, out, workspace, tickets, nq, groups,
                 D, round_up(D, 16), v_cols, ps, mp, num_pages, layer, scale, pages_per_split,
                 splits};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (pool_type == kPoolI8)
    return q_dtype == kBF16 ? launch<__nv_bfloat16, int8_t>(p, b, stream) : cudaErrorInvalidValue;
  if (q_dtype == kF32 && pool_type == kPoolF32) return launch<float, float>(p, b, stream);
  if (q_dtype == kBF16 && pool_type == kPoolBF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(p, b, stream);
  return cudaErrorInvalidValue;
}
