// The tile pipeline of the weight-only quantized GEMMs: quant_gemm.cu runs all
// of its products through it, quant_fused_mlp.cu its wide (m > 16) path.
//
//   out[m, n] = (x[m, k] @ w) * scale[n]     fp32 accumulator and scale
//
// x and out are fp32 or bf16 (one dtype). The weight source is either
//   - one matrix: int8 [k, n] (bits 8), or split-half packed int4 [k/2, n]
//     (bits 4; the layout is described in quant_gemm.cu), or
//   - a pair (w1 set, bits 8): gate and up weights of the same output columns,
//     and the epilogue stores out = silu(g * scale) * (u * scale1) (the
//     SwiGLU of quant_fused_mlp.cu).
//
// bf16 (namespace wg) runs on Hopper's wgmma with TMA loads, "swap AB":
// out^T = w^T x^T, so the weight is wgmma's A operand (64 output columns per
// instruction) and the activation rows are its N (16, 32, 64 or 128 per tile,
// whichever first holds m, so a few rows no longer pad to 128).
//   - A block is one producer warpgroup and two consumer warpgroups
//     (setmaxnreg moves registers from the first to the others). One producer
//     thread keeps a ring of 4-6 stages full with TMA, each stage a 64-deep K
//     step: the activation tile [rows, 64] lands 128-byte swizzled as wgmma
//     reads it from shared memory, the raw weight bytes land as two
//     128-column boxes, 128-byte swizzled so the consumers' reads below are
//     free of bank conflicts. Full/empty mbarrier pairs order the ring.
//   - A consumer warpgroup owns 128 output columns (a pair: 64 columns of
//     gate and the same 64 of up) as two 64-row wgmma blocks. Each thread
//     reads its weight bytes with four 32-bit loads per 16-deep K step (a
//     pair: eight 16-bit loads),
//     turns them into bf16 A fragments in registers (int8 codes through the
//     fp32 magic-number trick, int4 nibbles through the bf16 one; both exact),
//     and issues wgmma with fp32 accumulators in registers; the convert of
//     step j+1 overlaps the products of step j. No bf16 weight tile exists
//     in shared memory.
//   - int4 walks stored rows: one staged byte tile feeds both K halves, its
//     low nibbles against activation columns [k0, k0+64), its high nibbles
//     against [K/2+k0, ...), so each packed byte passes through L2 and shared
//     memory once.
//   - The epilogue works on the registers: with swap AB a thread holds whole
//     output columns, so the column scale (and for a pair silu(g) * u, g and u
//     in the same thread) needs no shared-memory round trip.
//   - TMA needs 16-byte aligned bases and row strides (x: k % 8 == 0, int4
//     k % 16 == 0; w: n % 16 == 0). Other shapes (2SSP-pruned k = 8190 or
//     682, n = 250, f = 8253, an x that starts off 16 bytes) run the same
//     kernel with the producer warpgroup filling the same swizzled stages by
//     element loads. Shapes that meet the rules always take TMA: if the tensor
//     maps cannot be encoded the launch returns cudaErrorNotSupported.
// fp32 (namespace f32) runs a SIMT 64x64x32 tile in exact fp32.
//
// A single matrix splits K (plan() below) when the output tiles alone leave
// SMs idle; the splits' fp32 partial sums are added in order by a second
// pass, so the result is the same bits on every run (no atomics). A pair
// never splits: its epilogue needs the whole sums.

#pragma once

#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace ssp {
namespace qtile {
// Internal linkage: each library that includes this header owns its kernels
// and the once-per-device attribute calls of the launchers (a static of a
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
  int k_chunk;            // split-K: rows of the K loop per blockIdx.z (bf16 int4: stored rows)
  int tma;                // bf16: the producer loads by TMA (else by elements)
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

template <bool PAIR>
cudaError_t launch(const Args& p, int splits, cudaStream_t s) {
  constexpr int cols = tile_cols<PAIR>(BN);
  const dim3 grid((p.n + cols - 1) / cols, (p.m + BM - 1) / BM, splits);
  kernel<PAIR><<<grid, THREADS, 0, s>>>(p);
  return cudaGetLastError();
}
}  // namespace f32

// ---------------------------------------------------------------- bf16 ----
namespace wg {
using namespace ::ssp::hopper;
using T = __nv_bfloat16;
constexpr int BK = 64;                  // K rows per stage (stored rows for int4)
constexpr int W_BOX = BK * 128;         // one weight box: 64 rows x 128 bytes
constexpr int THREADS = 384;            // producer warpgroup + two consumer warpgroups
constexpr int PRODUCER_THREADS = 128;
constexpr int CONSUMER_WARPS = 8;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
// Registers per thread at launch that let setmaxnreg move CONSUMER_REGS to
// both consumer warpgroups from what the producer gives up.
constexpr int LAUNCH_REGS = (PRODUCER_THREADS * PRODUCER_REGS + 256 * CONSUMER_REGS + THREADS - 1) / THREADS;

template <int BITS, int BN>
struct Cfg {
  static constexpr int NX = BITS == 4 ? 2 : 1;  // activation tiles per stage (int4: both K halves)
  static constexpr int X_TILE = BN * 128;       // BN rows x 64 bf16
  static constexpr int STAGE = NX * X_TILE + 2 * W_BOX;
  static constexpr int STAGES = 200 * 1024 / STAGE < 6 ? 200 * 1024 / STAGE : 6;
  static constexpr size_t SMEM = (size_t)STAGES * STAGE + 2 * STAGES * sizeof(uint64_t) + 1024;
  static_assert(STAGES >= 4, "the ring needs at least 4 stages");
};

// Output columns of one block: two consumer warpgroups of 128 (a pair: 64 of each matrix).
template <bool PAIR>
__host__ __device__ constexpr int block_cols() {
  return PAIR ? 128 : 256;
}

// Activation rows of one tile (wgmma's N) for m rows.
inline int act_tile(int m) { return m <= 16 ? 16 : m <= 32 ? 32 : m <= 64 ? 64 : 128; }

// bf16x2 of two int8 codes: byte j of qa (low half) and of qb, where q = raw ^ 0x80808080.
// 0x4B000000 | u is the float 2^23 + u, so subtracting 2^23 + 128 leaves u - 128.
__device__ __forceinline__ uint32_t int8_pair(uint32_t qa, uint32_t qb, int j) {
  const float fa = __uint_as_float(__byte_perm(qa, 0x4B000000u, 0x7540u | j)) - 8388736.f;
  const float fb = __uint_as_float(__byte_perm(qb, 0x4B000000u, 0x7540u | j)) - 8388736.f;
  const __nv_bfloat162 v = __floats2bfloat162_rn(fa, fb);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The two bf16x2 of byte j of qa and qb (q = raw ^ 0x80808080) as packed int4:
// lo from the low nibbles (biased +8), hi from the high nibbles (flipped to
// biased +8 by the xor). 0x4300 | u is the bf16 128 + u; 136 = 128 + 8.
__device__ __forceinline__ void int4_pairs(uint32_t qa, uint32_t qb, int j, uint32_t& lo,
                                           uint32_t& hi) {
  const uint32_t q = __byte_perm(qa, qb, j | (j << 4) | ((4 + j) << 8) | ((4 + j) << 12));
  const uint32_t l = (q & 0x000F000Fu) | 0x43004300u, h = ((q >> 4) & 0x000F000Fu) | 0x43004300u;
  const __nv_bfloat162 bias = __floats2bfloat162_rn(136.f, 136.f);
  const __nv_bfloat162 vl = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&l), bias);
  const __nv_bfloat162 vh = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&h), bias);
  lo = *reinterpret_cast<const uint32_t*>(&vl);
  hi = *reinterpret_cast<const uint32_t*>(&vh);
}

// A fragments of one 16-deep K step at stage row kr = 16 * step + 2 * (lane % 4).
// Thread (warp w, lane g*4+t) supplies rows g and g+8 of warp w's 16 rows in
// both 64-row blocks: for a single matrix the four consecutive output columns
// 32w + 4g .. +3 of its warpgroup's box (block b, row half h = column 2b + h),
// for a pair columns 16w + 2g + h of the gate (block 0) and up (block 1)
// boxes. Each K row is one 32-bit word, byte 2b + h.
template <int BITS, bool PAIR>
__device__ __forceinline__ void load_frags(const unsigned char* wst, int box, int col, int kr,
                                           uint32_t (&fr)[BITS == 4 ? 2 : 1][2][4]) {
  uint32_t q[4];
  const int rows[4] = {kr, kr + 1, kr + 8, kr + 9};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t word;
    if constexpr (PAIR) {
      const uint32_t g = *reinterpret_cast<const uint16_t*>(wst + swz(rows[i], col));
      const uint32_t u = *reinterpret_cast<const uint16_t*>(wst + W_BOX + swz(rows[i], col));
      word = g | (u << 16);
    } else {
      word = *reinterpret_cast<const uint32_t*>(wst + box * W_BOX + swz(rows[i], col));
    }
    q[i] = word ^ 0x80808080u;
  }
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // reg h: K rows kr, kr+1 (q0, q1); reg 2 + h: K rows kr+8, kr+9 (q2, q3)
      if constexpr (BITS == 4) {
        int4_pairs(q[0], q[1], 2 * b + h, fr[0][b][h], fr[1][b][h]);
        int4_pairs(q[2], q[3], 2 * b + h, fr[0][b][2 + h], fr[1][b][2 + h]);
      } else {
        fr[0][b][h] = int8_pair(q[0], q[1], 2 * b + h);
        fr[0][b][2 + h] = int8_pair(q[2], q[3], 2 * b + h);
      }
    }
}

// The producer warpgroup without TMA: the same swizzled stage, filled by
// element loads (zeros outside the matrices), then made visible to wgmma.
// Thread tid loads K column tid % 64 of the activation rows and column tid
// of both weight boxes, so neighbouring threads read neighbouring bytes.
template <int BITS, bool PAIR, int BN>
__device__ void fill_stage(const Args& p, unsigned char* st, int m0, int n0, int r) {
  using C = Cfg<BITS, BN>;
  static_assert(PRODUCER_THREADS == 128 && PRODUCER_THREADS % BK == 0, "one thread per box column");
  const int tid = threadIdx.x, k_rows = BITS == 4 ? p.k / 2 : p.k, c = tid % BK;
  const T zero = __float2bfloat16(0.f);
#pragma unroll
  for (int half = 0; half < C::NX; ++half) {
    // int4: the high nibbles' activation columns start at K/2
    const T* src = static_cast<const T*>(p.x) + half * (p.k / 2) + r + c;
    const bool k_in = r + c < k_rows;
    for (int row = tid / BK; row < BN; row += PRODUCER_THREADS / BK)
      *reinterpret_cast<T*>(st + half * C::X_TILE + swz(row, 2 * c)) =
          k_in && m0 + row < p.m ? src[(size_t)(m0 + row) * p.k] : zero;
  }
  unsigned char* wst = st + C::NX * C::X_TILE;
#pragma unroll
  for (int box = 0; box < 2; ++box) {
    const int gc = n0 + (PAIR ? 0 : box * 128) + tid;
    const signed char* src = (PAIR && box ? p.w1 : p.w) + gc;
    for (int row = 0; row < BK; ++row)
      wst[box * W_BOX + swz(row, tid)] =
          r + row < k_rows && gc < p.n ? static_cast<unsigned char>(src[(size_t)(r + row) * p.n]) : 0;
  }
  fence_proxy_async();
}

// Store the columns this thread holds: the pair's SwiGLU, the scaled output
// or this split's partial sums. acc[b][4j + 2h + e] is output column (b, h)
// at activation row 8j + 2t + e.
template <bool PAIR, int BN>
__device__ __forceinline__ void store_tile(const Args& p, float (&acc)[2][BN / 2], int m0, int nb,
                                           int t) {
  T* out = static_cast<T*>(p.out);
  if constexpr (PAIR) {
    float gs[2], us[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      gs[h] = nb + h < p.n ? p.scale[nb + h] : 0.f;
      us[h] = nb + h < p.n ? p.scale1[nb + h] : 0.f;
    }
    const bool vec = p.n % 2 == 0 && nb + 1 < p.n;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int gm = m0 + 8 * j + 2 * t + e;
        if (gm >= p.m) continue;
        float v[2];
#pragma unroll
        for (int h = 0; h < 2; ++h)
          v[h] = silu(acc[0][4 * j + 2 * h + e] * gs[h]) * (acc[1][4 * j + 2 * h + e] * us[h]);
        T* dst = out + (size_t)gm * p.n + nb;
        if (vec) {
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v[0], v[1]);
        } else {
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (nb + h < p.n) dst[h] = __float2bfloat16(v[h]);
        }
      }
    return;
  }
  float* part = p.partial ? p.partial + (size_t)blockIdx.z * p.m * p.n : nullptr;
  float sc[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) sc[c] = nb + c < p.n ? p.scale[nb + c] : 0.f;
  const bool vec = p.n % 4 == 0 && nb + 3 < p.n;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int gm = m0 + 8 * j + 2 * t + e;
      if (gm >= p.m) continue;
      const float v[4] = {acc[0][4 * j + e], acc[0][4 * j + 2 + e], acc[1][4 * j + e],
                          acc[1][4 * j + 2 + e]};
      const size_t o = (size_t)gm * p.n + nb;
      if (part) {
        if (vec) {
          *reinterpret_cast<float4*>(part + o) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (nb + c < p.n) part[o + c] = v[c];
        }
      } else if (vec) {
        const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0] * sc[0], v[1] * sc[1]);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2] * sc[2], v[3] * sc[3]);
        uint2 pack;
        pack.x = *reinterpret_cast<const uint32_t*>(&lo);
        pack.y = *reinterpret_cast<const uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(out + o) = pack;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (nb + c < p.n) out[o + c] = __float2bfloat16(v[c] * sc[c]);
      }
    }
}

// grid (activation row tiles, column blocks, K splits).
template <int BITS, bool PAIR, int BN>
__global__ void __launch_bounds__(THREADS, 1)
    kernel(const __grid_constant__ CUtensorMap map_x0, const __grid_constant__ CUtensorMap map_x1,
           const __grid_constant__ CUtensorMap map_w0, const __grid_constant__ CUtensorMap map_w1,
           const Args p) {
  using C = Cfg<BITS, BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::STAGES * C::STAGE);
  uint64_t* empty = full + C::STAGES;
  const int m0 = blockIdx.x * BN, n0 = blockIdx.y * block_cols<PAIR>();
  const int k_rows = BITS == 4 ? p.k / 2 : p.k;
  const int r_lo = blockIdx.z * p.k_chunk, r_hi = min(k_rows, r_lo + p.k_chunk);
  const int kt_count = (r_hi - r_lo + BK - 1) / BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], p.tma ? 1 : PRODUCER_THREADS);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < PRODUCER_THREADS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (p.tma && threadIdx.x != 0) return;
    for (int kt = 0; kt < kt_count; ++kt) {
      const int s = kt % C::STAGES, r = r_lo + kt * BK;
      if (kt >= C::STAGES) mbar_wait(&empty[s], ((kt / C::STAGES) + 1) & 1);
      unsigned char* st = smem + s * C::STAGE;
      if (!p.tma) {
        fill_stage<BITS, PAIR, BN>(p, st, m0, n0, r);
        mbar_arrive(&full[s]);
        continue;
      }
      mbar_expect_tx(&full[s], C::STAGE);
      tma_load(st, &map_x0, r, m0, &full[s]);
      if constexpr (BITS == 4) tma_load(st + C::X_TILE, &map_x1, r, m0, &full[s]);
      unsigned char* wst = st + C::NX * C::X_TILE;
      tma_load(wst, &map_w0, n0, r, &full[s]);
      tma_load(wst + W_BOX, PAIR ? &map_w1 : &map_w0, PAIR ? n0 : n0 + 128, r, &full[s]);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wgi = threadIdx.x / 128 - 1, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int col = PAIR ? 64 * wgi + 16 * warp + 2 * g : 32 * warp + 4 * g;  // byte column in a box
  float acc[2][BN / 2];
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[b][i] = 0.f;
  uint32_t frag[2][C::NX][2][4];
  for (int kt = 0; kt < kt_count; ++kt) {
    const int s = kt % C::STAGES;
    mbar_wait(&full[s], (kt / C::STAGES) & 1);
    const unsigned char* st = smem + s * C::STAGE;
    const uint32_t xs = smem_u32(st);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // the buffer written here was read by step kk-2, complete since step kk-1's wait
      load_frags<BITS, PAIR>(st + C::NX * C::X_TILE, wgi, col, kk * 16 + 2 * t, frag[kk & 1]);
      wgmma_fence();
#pragma unroll
      for (int half = 0; half < C::NX; ++half) {
        const uint64_t desc = smem_desc(xs + half * C::X_TILE + kk * 32);
        wgmma_rs<0>(acc[0], frag[kk & 1][half][0], desc, 1);
        wgmma_rs<0>(acc[1], frag[kk & 1][half][1], desc, 1);
      }
      wgmma_commit();
      wgmma_wait<1>();
      // every product of the previous stage is complete: hand its slot back
      if (kk == 0 && kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % C::STAGES]);
    }
  }
  wgmma_wait<0>();
  fence_regs(acc[0]);
  fence_regs(acc[1]);
  const int nb = n0 + (PAIR ? 64 * wgi + 16 * warp + 2 * g : 128 * wgi + 32 * warp + 4 * g);
  store_tile<PAIR, BN>(p, acc, m0, nb, t);
}

// True when every operand meets TMA's alignment (16-byte bases and row strides).
inline bool tma_ok(const Args& p) {
  const auto is16 = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; };
  return is16(p.x) && p.k % (p.bits == 4 ? 16 : 8) == 0 && is16(p.w) && p.n % 16 == 0 &&
         (p.w1 == nullptr || is16(p.w1));
}

template <int BITS, bool PAIR, int BN>
cudaError_t launch_bn(Args p, int splits, cudaStream_t s) {
  using C = Cfg<BITS, BN>;
  const auto kern = kernel<BITS, PAIR, BN>;
  static std::atomic<unsigned long long> smem_allowed{0};
  cudaError_t err = allow_max_dynamic_smem(kern, smem_allowed);
  if (err != cudaSuccess) return err;
  static std::atomic<int> regs_checked{0};
  if ((err = check_launch_regs(kern, LAUNCH_REGS, regs_checked)) != cudaSuccess) return err;
  CUtensorMap mx0{}, mx1{}, mw0{}, mw1{};
  if (p.tma) {
    const int kx = BITS == 4 ? p.k / 2 : p.k, k_rows = kx;
    const T* x = static_cast<const T*>(p.x);
    bool ok = encode_2d(&mx0, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, kx, p.m, 2ull * p.k, BK, BN) &&
              (BITS == 8 || encode_2d(&mx1, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x + p.k / 2, kx, p.m,
                                   2ull * p.k, BK, BN)) &&
              encode_2d(&mw0, CU_TENSOR_MAP_DATA_TYPE_UINT8, p.w, p.n, k_rows, p.n, 128, BK) &&
              (!PAIR || encode_2d(&mw1, CU_TENSOR_MAP_DATA_TYPE_UINT8, p.w1, p.n, k_rows, p.n, 128, BK));
    // The shapes passed tma_ok: an encoder that cannot be found or refuses them
    // is an error, never a quiet switch to the element-load producer.
    if (!ok) return cudaErrorNotSupported;
  }
  const dim3 grid((p.m + BN - 1) / BN, (p.n + block_cols<PAIR>() - 1) / block_cols<PAIR>(), splits);
  kern<<<grid, THREADS, C::SMEM, s>>>(mx0, mx1, mw0, mw1, p);
  return cudaGetLastError();
}

template <int BITS, bool PAIR>
cudaError_t launch(const Args& p, int splits, cudaStream_t s) {
  switch (act_tile(p.m)) {
    case 16: return launch_bn<BITS, PAIR, 16>(p, splits, s);
    case 32: return launch_bn<BITS, PAIR, 32>(p, splits, s);
    case 64: return launch_bn<BITS, PAIR, 64>(p, splits, s);
    default: return launch_bn<BITS, PAIR, 128>(p, splits, s);
  }
}
}  // namespace wg

// ---------------------------------------------------------------- host ----
struct Plan {
  int splits, chunk;  // K splits and the rows of the K loop in each
};

// The split plan of a single matrix: a pure function of the shapes and the SM
// count, so a workspace query and the launch agree. bf16 splits the rows its
// K loop walks (int4: stored rows) into at most one wave of blocks.
inline Plan plan(int dtype, int bits, int m, int n, int k) {
  Plan pl{};
  if (dtype == kF32) {
    split_k((long long)((m + f32::BM - 1) / f32::BM) * ((n + f32::BN - 1) / f32::BN), k, f32::BK,
            pl.splits, pl.chunk);
    return pl;
  }
  const int bn = wg::act_tile(m), rows = bits == 4 ? k / 2 : k;
  const long long tiles = (long long)((m + bn - 1) / bn) * ((n + wg::block_cols<false>() - 1) / wg::block_cols<false>());
  const int k_tiles = (rows + wg::BK - 1) / wg::BK;
  const long long want = tiles >= sm_count() ? 1 : sm_count() / tiles;
  const int splits = static_cast<int>(std::max(1LL, std::min({want, (long long)k_tiles / 2, 16LL})));
  pl.chunk = (k_tiles + splits - 1) / splits * wg::BK;
  pl.splits = (rows + pl.chunk - 1) / pl.chunk;
  return pl;
}

inline Plan no_split(int k) { return Plan{1, k}; }

// fp32 workspace (in floats) that a launch with this plan needs; 0 = none.
inline long long workspace_floats(const Plan& pl, int m, int n) {
  return pl.splits > 1 ? (long long)pl.splits * m * n : 0;
}

// The pass that sums the splits' partials in order and scales them.
template <typename T>
cudaError_t reduce_splits(const Args& p, const Plan& pl, const float* workspace, cudaStream_t s) {
  const size_t mn = (size_t)p.m * p.n;
  scale_reduce_kernel<T><<<static_cast<unsigned>((mn + 255) / 256), 256, 0, s>>>(
      workspace, p.scale, static_cast<T*>(p.out), p.m, p.n, pl.splits);
  return cudaGetLastError();
}

// Launch the tiles of a single matrix p (T = float or __nv_bfloat16, BITS =
// p.bits) with plan pl, and the pass that sums the splits when there are
// several. `workspace` holds workspace_floats(pl, m, n) floats.
template <typename T, int BITS>
cudaError_t launch(Args p, const Plan& pl, float* workspace, cudaStream_t s) {
  const bool split = pl.splits > 1;
  if ((split && workspace == nullptr) || p.w1 || p.bits != BITS) return cudaErrorInvalidValue;
  p.partial = split ? workspace : nullptr;
  p.k_chunk = pl.chunk;
  cudaError_t err;
  if constexpr (sizeof(T) == 4) {
    err = f32::launch<false>(p, pl.splits, s);
  } else {
    p.tma = wg::tma_ok(p) ? 1 : 0;
    err = wg::launch<BITS, false>(p, pl.splits, s);
  }
  if (err != cudaSuccess || !split) return err;
  return reduce_splits<T>(p, pl, workspace, s);
}

// Launch the tiles of a pair (int8 w and w1, whole K: the SwiGLU epilogue
// needs the whole sums).
template <typename T>
cudaError_t launch_pair(Args p, cudaStream_t s) {
  if (p.w1 == nullptr || p.bits != 8) return cudaErrorInvalidValue;
  p.partial = nullptr;
  p.k_chunk = p.k;
  if constexpr (sizeof(T) == 4) return f32::launch<true>(p, 1, s);
  p.tma = wg::tma_ok(p) ? 1 : 0;
  return wg::launch<8, true>(p, 1, s);
}

}  // namespace
}  // namespace qtile
}  // namespace ssp
