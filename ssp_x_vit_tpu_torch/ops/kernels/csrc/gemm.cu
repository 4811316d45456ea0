// Tiled GEMM with the fused epilogues of the ViT block kernels, plus the
// LayerNorm pass that feeds it.
//
// Replaces the matrix products inside the Pallas kernels
//   ssp_x_vit_tpu/ops/pallas/fused_attn_block.py : _kernel_v2 / _kernel
//     (LN1 -> QKV projection, out projection + gated residual)
//   ssp_x_vit_tpu/ops/pallas/fused_ffn.py : _ffn_block_kernel / _ffn_kernel
//     (LN2 -> fc1 -> GELU -> importance stats -> neuron mask, fc2 + gated residual)
//
// C[M, N] = epilogue(A[M, K] @ B[K, N]); A and C row-major activations, B a
// row-major [in, out] weight (the JAX layout).
//
//   epilogue  0 (bias):      c = gate * (acc + bias), gate as below, null = 1
//                            (a tensor-parallel rank's partial of a gated
//                            branch, whose residual another rank adds)
//             1 (gelu):      h = gelu_erf(acc + bias); stats[img, n] += h^2 over
//                            the rows of image img (pre-mask, fp32);
//                            c = h * mask[n]
//             2 (residual):  c = resid + gate * (acc + bias), gate read from a
//                            device pointer (no host sync per block).
//
// ssp_layer_norm writes y = LN(x) in the operand dtype (fp32 statistics, as the
// Pallas kernels compute y in fp32 and cast it to x.dtype before the product).
//
// What bounds it on the H100: at ViT widths (M = b*197; K, N >= 768) the
// products are compute-bound (~200-400 FLOP per byte moved), so the tensor
// cores' rate is the target. Fed from L2, the tile's loads set the main
// loop's rate (without the epilogue: ~420 TFLOP/s at 128 x 128, ~580 at
// 128 x 256), so the bf16 tile is 128 x 256 where that leaves no SM idle.
//
// - bf16 (namespace wg): Hopper's wgmma with TMA loads. One persistent block
//   per SM walks 128 x BN output tiles (BN = 256, or 128 where 256-wide
//   tiles would leave more of the card idle: proj and fc2 at ViT-B). A block
//   is one producer warpgroup and two consumer warpgroups of 64 rows each
//   (setmaxnreg: 40 / 232 registers). One producer thread keeps a ring of
//   4-6 stages of 64-deep K steps full by TMA: the A tile [128, 64] lands
//   128-byte swizzled K-major, the B tile [64, BN] as BN / 64 boxes of 64
//   columns, read by wgmma MN-major as it lies (no transposed copy of the
//   weight); the ring runs on across tiles, so the next tile's stages arrive
//   during an epilogue. Full/empty mbarrier pairs order it. A second
//   producer warp stages each tile's bias and mask in shared memory (fp32)
//   and prefetches its residual rows into L2. Each consumer issues m64nBNk16
//   wgmma with both operands in shared memory and keeps the fp32 tile in
//   registers; the epilogue works on those registers: each chunk's loads
//   go out before any of its stores, and a quad trades values so that each
//   lane stores (and loads the residual as) 16 consecutive bytes of a row.
//   The kernel is compiled per epilogue (bias, GELU, GELU + stats,
//   residual): with the kind fixed the epilogue is straight-line code. The
//   epilogue does not overlap the products (both warpgroups share the tile).
//   Shapes TMA cannot take (K or N not a multiple of 8, an operand off 16
//   bytes) run one generic 128-wide kernel whose producer warps fill the
//   same swizzled stages by element loads; shapes that meet TMA's rules
//   always take TMA, and a tensor map that cannot be encoded fails the
//   launch.
// - fp32 (namespace f32): a SIMT 64x64 tile with 4x8 outputs per thread, so
//   fp32 stays exact fp32 (no TF32); its epilogue goes through an fp32 tile
//   in shared memory.
//
// Stats: M-tiles may span images; rows are never padded and no stats row is
// shared between images. The fp32 kernel walks each column of its tile in
// shared memory in row order, one atomicAdd per (image, column) run. The
// bf16 kernel sums each column over the rows of each image in a warp's
// 16-row slab from registers (a reduce-scatter over the 8 row lanes) and
// flushes one atomicAdd per (image, column) of the slab; images shorter than
// 16 rows (three in a slab) take the generic kernel, one atomicAdd per
// element. The atomics make the stats' summation order, and so their last
// bits, vary from run to run.
//
// When the output tiles make less than two waves on the card (small batches,
// e.g. the b=1 latency forward), K is split: each split (a work unit of its
// own) writes fp32 partial sums to a caller-allocated workspace and one
// elementwise kernel sums them and applies the epilogue.

#include <algorithm>
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace ssp {

enum Epilogue { kEpiBias = 0, kEpiGelu = 1, kEpiResidual = 2 };

struct GemmArgs {
  const void* a;
  const void* b;
  void* c;
  int m, n, k;
  int epi;
  const void* bias;   // [n] or null
  const void* resid;  // [m, n] (residual epilogue)
  const float* gate;  // scalar on device (bias and residual epilogues), null = 1
  const float* mask;  // [n] fp32 or null (gelu epilogue)
  float* stats;       // [m / seq, n] fp32 or null (gelu epilogue)
  int seq;            // rows per image, for stats
  float* partial;     // split-K: [splits, m, n] fp32 partial sums, null = no split
  int k_chunk;        // split-K: K range of blockIdx.z, a multiple of the K tile
  int pairs;          // bf16 stores: 2 = rows of c and resid 16-byte aligned (n % 8 == 0),
                      // 1 = 4-byte aligned pairs of c (n even), 0 = single outputs
};

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// One output element from its fp32 sum: bias, then the epilogue, stored to C.
// Returns the pre-mask GELU activation (the stats input), else 0.
template <typename T>
__device__ __forceinline__ float epilogue_element(const GemmArgs& p, float gate, int gr, int gc,
                                                  float v) {
  T* C = static_cast<T*>(p.c);
  const T* bias = static_cast<const T*>(p.bias);
  if (bias) v += to_f(bias[gc]);
  const size_t o = (size_t)gr * p.n + gc;
  if (p.epi == kEpiGelu) {
    const float h = gelu_erf(v);
    C[o] = from_f<T>(p.mask ? h * p.mask[gc] : h);
    return h;
  }
  if (p.epi == kEpiResidual)
    C[o] = from_f<T>(to_f(static_cast<const T*>(p.resid)[o]) + gate * v);
  else
    C[o] = from_f<T>(gate * v);
  return 0.f;
}

// Epilogue over a BM x BN fp32 tile in shared memory (row stride ldc), then
// the stats pass; under split-K, the raw tile goes to this split's partial
// sums instead. Needs THREADS == 2 * BN.
template <typename T, int BM, int BN, int THREADS>
__device__ void epilogue(const GemmArgs& p, float* cs, int ldc, int m0, int n0) {
  const int tid = threadIdx.x;
  if (p.partial) {
    float* part = p.partial + (size_t)blockIdx.z * p.m * p.n;
    for (int e = tid; e < BM * BN; e += THREADS) {
      const int r = e / BN, c = e % BN, gr = m0 + r, gc = n0 + c;
      if (gr < p.m && gc < p.n) part[(size_t)gr * p.n + gc] = cs[r * ldc + c];
    }
    return;
  }
  const float gate = p.gate ? *p.gate : 1.f;
  for (int e = tid; e < BM * BN; e += THREADS) {
    const int r = e / BN, c = e % BN, gr = m0 + r, gc = n0 + c;
    if (gr >= p.m || gc >= p.n) continue;
    // keep the pre-mask activation for the stats pass
    cs[r * ldc + c] = epilogue_element<T>(p, gate, gr, gc, cs[r * ldc + c]);
  }
  if (p.stats) {
    __syncthreads();
    // thread (half, c) walks rows [half*BM/2, (half+1)*BM/2) of column c.
    const int c = tid % BN, half = tid / BN, gc = n0 + c;
    if (gc < p.n) {
      float sum = 0.f;
      int img = -1;
      for (int r = half * (BM / 2); r < (half + 1) * (BM / 2); ++r) {
        const int gr = m0 + r;
        if (gr >= p.m) break;
        const int im = gr / p.seq;
        if (im != img) {
          if (img >= 0) atomicAdd(&p.stats[(size_t)img * p.n + gc], sum);
          img = im;
          sum = 0.f;
        }
        const float h = cs[r * ldc + c];
        sum = fmaf(h, h, sum);
      }
      if (img >= 0) atomicAdd(&p.stats[(size_t)img * p.n + gc], sum);
    }
  }
}

// Split-K: sum the partials of one element, then the same epilogue; stats
// take one atomicAdd per element.
template <typename T>
__global__ void split_reduce_kernel(GemmArgs p, int splits) {
  const size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  const size_t mn = (size_t)p.m * p.n;
  if (e >= mn) return;
  float v = 0.f;
  for (int z = 0; z < splits; ++z) v += p.partial[z * mn + e];
  const int gr = static_cast<int>(e / p.n), gc = static_cast<int>(e % p.n);
  const float h = epilogue_element<T>(p, p.gate ? *p.gate : 1.f, gr, gc, v);
  if (p.stats) atomicAdd(&p.stats[(size_t)(gr / p.seq) * p.n + gc], h * h);
}

// ---------------------------------------------------------------- fp32 ----
// SIMT: 64x64x32 tiles, 128 threads, thread (ty, tx) owns rows ty*4+r and
// columns tx+8*c.
namespace f32 {
constexpr int BM = 64, BN = 64, BK = 32, THREADS = 128;

__global__ void __launch_bounds__(THREADS) gemm_kernel(GemmArgs p) {
  __shared__ float as[BM][BK + 1];
  __shared__ float bs[BK][BN];
  __shared__ float cs[BM][BN + 4];
  const float* A = static_cast<const float*>(p.a);
  const float* B = static_cast<const float*>(p.b);
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
      bs[r][c] = (gr < p.k && gc < p.n) ? B[(size_t)gr * p.n + gc] : 0.f;
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
namespace wg {
// Internal linkage: the launchers' once-per-device statics belong to this library.
namespace {
using namespace ::ssp::hopper;
using T = __nv_bfloat16;
constexpr int BM = 128, BK = 64;
constexpr int THREADS = 384;  // producer warpgroup + two consumer warpgroups of 64 rows
constexpr int PRODUCER_THREADS = 128, CONSUMER_WARPS = 8;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
// Registers a thread at launch that let setmaxnreg move CONSUMER_REGS to both
// consumer warpgroups from what the producer gives up.
constexpr int LAUNCH_REGS = (PRODUCER_THREADS * PRODUCER_REGS + 256 * CONSUMER_REGS + THREADS - 1) / THREADS;
constexpr int A_TILE = BM * 128;  // 128 rows x 64 K values, 128-byte rows
constexpr int B_BOX = BK * 128;   // 64 K rows x 64 N values

// BN output columns a tile: 256 reads a quarter fewer bytes from L2 per
// product than 128; 128 where 256-wide tiles would leave more of the card idle.
template <int BN>
struct Cfg {
  static constexpr int STAGE = A_TILE + (BN / 64) * B_BOX;
  static constexpr int STAGES = 200 * 1024 / STAGE;  // 4 at BN = 256, 6 at 128
  // the ring, its full/empty barriers and the side barriers, then two slots
  // of a tile's bias and mask in fp32
  static constexpr size_t BARS = (size_t)STAGES * STAGE + 2 * STAGES * sizeof(uint64_t);
  static constexpr size_t SIDE = BARS + 4 * sizeof(uint64_t);
  static constexpr size_t SMEM = SIDE + 2 * 2 * BN * sizeof(float) + 1024;
};

// The producer warpgroup's loading threads without TMA (f = index among the
// NF of them): K step k0 of A and B into the stage at st, swizzled as TMA
// writes it, zeros outside the matrices. Neighbouring threads load
// neighbouring columns.
template <int BN, int NF>
__device__ void fill_stage(const GemmArgs& p, unsigned char* st, int m0, int n0, int k0, int f) {
  const T* A = static_cast<const T*>(p.a);
  const T* B = static_cast<const T*>(p.b);
  const T zero = __float2bfloat16(0.f);
#pragma unroll 4
  for (int e = f; e < BM * BK; e += NF) {
    const int row = e / BK, c = e % BK, gr = m0 + row, gc = k0 + c;
    *reinterpret_cast<T*>(st + swz(row, 2 * c)) = gr < p.m && gc < p.k ? A[(size_t)gr * p.k + gc] : zero;
  }
#pragma unroll 4
  for (int e = f; e < BK * BN; e += NF) {
    const int r = e / BN, c = e % BN, gr = k0 + r, gc = n0 + c;
    *reinterpret_cast<T*>(st + A_TILE + (c / 64) * B_BOX + swz(r, 2 * (c % 64))) =
        gr < p.k && gc < p.n ? B[(size_t)gr * p.n + gc] : zero;
  }
}

// One halving exchange across lanes `mask` apart: v[0, H) keeps the half of
// v[0, 2H) that `bit` selects, plus the partner's same half.
template <int H>
__device__ __forceinline__ void halve(float* v, int bit, int mask) {
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float mine = bit ? v[H + i] : v[i], other = bit ? v[i] : v[H + i];
    v[i] = mine + __shfl_xor_sync(0xffffffffu, other, mask);
  }
}

// Sums over the 8 row lanes g of a warp (lanes t, t + 4, ..., t + 28) of N
// values a lane, by halving exchanges (N - N / 8 shuffles): afterwards lane g
// holds the sums of entries [g * N / 8, (g + 1) * N / 8) in v[0, N / 8).
template <int N>
__device__ __forceinline__ void rows_reduce_scatter(float (&v)[N], int g) {
  halve<N / 2>(v, (g >> 2) & 1, 16);
  halve<N / 4>(v, (g >> 1) & 1, 8);
  halve<N / 8>(v, g & 1, 4);
}

// A work unit: output tile (m0, n0), K steps [k_lo, k_lo + steps * BK) and
// the split z it belongs to.
struct Unit {
  int m0, n0, k_lo, steps, z;
};

template <int BN>
__device__ __forceinline__ Unit unit_of(const GemmArgs& p, int u) {
  const int n_tiles = (p.n + BN - 1) / BN, tiles = n_tiles * ((p.m + BM - 1) / BM);
  const int r = u % tiles;
  Unit w;
  w.z = u / tiles;
  w.m0 = (r / n_tiles) * BM;
  w.n0 = (r % n_tiles) * BN;
  w.k_lo = w.z * p.k_chunk;
  w.steps = (min(p.k, w.k_lo + p.k_chunk) - w.k_lo + BK - 1) / BK;
  return w;
}

// The epilogue of one warp's 16-row slab [r0, r0 + 16) of a tile from its
// accumulator registers (acc[4j + 2h + e]: row r0 + g + 8h, column n0 + 8j +
// 2t + e): this split's partial sums, or the epilogue with its stores and
// the stats. Each chunk's bias, mask and residual are loaded before any of
// its stores (loads placed after stores would wait for them, one L2 round
// trip each). Where the rows are 16-byte aligned (p.pairs == 2), a quad
// trades values so that each lane stores 8 consecutive outputs of one row.
// Stats: the slab's valid rows span images img_lo.. (warp-uniform); up to
// two images, each column's sum over the slab's rows of each image is taken
// by shuffles and flushed by one atomicAdd; more (images of fewer than 16
// rows) take one atomicAdd per element.
// Epilogue kinds a kernel is compiled for: one of them, or kAny (read from
// the arguments at run time; the element-load kernel, which is rare).
enum EpiKind { kBias, kGelu, kGeluStats, kResidual, kAny };

inline int epi_kind(const GemmArgs& p) {
  if (p.epi == kEpiGelu) return p.stats ? kGeluStats : kGelu;
  return p.epi == kEpiResidual ? kResidual : kBias;
}

template <int BN, int E>
__device__ __forceinline__ void store_slab(const GemmArgs& p, const Unit& w, const float (&acc)[BN / 2],
                                           int r0, int g, int t, float gate, const float* sbias,
                                           const float* smask) {
  const int row_a = r0 + g, row_b = row_a + 8;
  if (p.partial) {
    float* part = p.partial + (size_t)w.z * p.m * p.n;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int gc = w.n0 + 8 * j + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gr = h ? row_b : row_a;
        if (gr >= p.m || gc >= p.n) continue;
        float* dst = part + (size_t)gr * p.n + gc;
        dst[0] = acc[4 * j + 2 * h];
        if (gc + 1 < p.n) dst[1] = acc[4 * j + 2 * h + 1];
      }
    }
    return;
  }
  const T* resid = static_cast<const T*>(p.resid);
  T* C = static_cast<T*>(p.c);
  constexpr bool ANY = E == kAny;
  const bool gelu = ANY ? p.epi == kEpiGelu : E == kGelu || E == kGeluStats;
  const bool residual = ANY ? p.epi == kEpiResidual : E == kResidual;
  const bool stats = ANY ? p.stats != nullptr : E == kGeluStats;
  const bool slab_in = r0 < p.m;
  const int img_lo = r0 / p.seq;
  const int span = min(r0 + 15, p.m - 1) / p.seq - img_lo;  // images past img_lo in the slab
  const int split_row = (img_lo + 1) * p.seq;               // first row of the next image
  constexpr int CH = 8;  // 8-column groups j per chunk (one per row lane in the stats sums)
#pragma unroll
  for (int j0 = 0; j0 < BN / 8; j0 += CH) {
    uint32_t res[CH][2];  // the residual as bf16 pairs, laid out as out below
    if (residual) {
      if (p.pairs == 2) {
        // lane t loads 8 columns of one row, then the quad trades them into
        // the accumulator's layout (the inverse of the stores' transpose)
        const int gr = t < 2 ? row_a : row_b;
#pragma unroll
        for (int jj = 0; jj < CH; jj += 2) {
          const int gc = w.n0 + 8 * (j0 + jj + t % 2);
          uint4 q = make_uint4(0u, 0u, 0u, 0u);
          if (gr < p.m && gc < p.n) q = *reinterpret_cast<const uint4*>(resid + (size_t)gr * p.n + gc);
          uint32_t v[4] = {q.x, q.y, q.z, q.w};
          quad_transpose(v, t);
          res[jj][0] = v[0];
          res[jj + 1][0] = v[1];
          res[jj][1] = v[2];
          res[jj + 1][1] = v[3];
        }
      } else {
#pragma unroll
        for (int jj = 0; jj < CH; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int gr = h ? row_b : row_a, gc = w.n0 + 8 * (j0 + jj) + 2 * t;
            const T* src = resid + (size_t)gr * p.n + gc;
            const T zero = __float2bfloat16(0.f);
            const __nv_bfloat162 pair = __halves2bfloat162(gr < p.m && gc < p.n ? src[0] : zero,
                                                           gr < p.m && gc + 1 < p.n ? src[1] : zero);
            res[jj][h] = *reinterpret_cast<const uint32_t*>(&pair);
          }
      }
    }
    uint32_t out[CH][2];  // the chunk's outputs as bf16 pairs: [jj][h]
    float sq[CH][2][2];   // stats: [jj][image of the slab][column e]
#pragma unroll
    for (int jj = 0; jj < CH; ++jj) {
      const int j = j0 + jj, c = 8 * j + 2 * t, gc = w.n0 + c;
      sq[jj][0][0] = sq[jj][0][1] = sq[jj][1][0] = sq[jj][1][1] = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gr = h ? row_b : row_a;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] = acc[4 * j + 2 * h + e] + sbias[c + e];
          if (gelu) {
            const float hv = gelu_erf(v[e]);
            if (stats) {  // selects, no branches: the rows of each image of the slab
              const float s2 = gr < p.m && gc + e < p.n ? hv * hv : 0.f;
              sq[jj][0][e] += gr >= split_row ? 0.f : s2;
              sq[jj][1][e] += gr >= split_row ? s2 : 0.f;
            }
            v[e] = hv * smask[c + e];
          } else if (residual) {
            const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(&res[jj][h]);
            v[e] = (e ? __high2float(r) : __low2float(r)) + gate * v[e];
          } else {
            v[e] *= gate;  // 1 unless a gated partial asks for it
          }
        }
        const __nv_bfloat162 pair = __floats2bfloat162_rn(v[0], v[1]);
        out[jj][h] = *reinterpret_cast<const uint32_t*>(&pair);
      }
    }
    if (stats && slab_in && (!ANY || span <= 1)) {
      // The chunk's column sums over the slab's rows: row lane g ends with
      // those of column group j0 + g (CH == 8), one atomicAdd each.
      const int gc = w.n0 + 8 * (j0 + g) + 2 * t;
      float* dst = p.stats + (size_t)img_lo * p.n + gc;
      if (span == 0) {
        float v[2 * CH];
#pragma unroll
        for (int jj = 0; jj < CH; ++jj) {
          v[2 * jj] = sq[jj][0][0];
          v[2 * jj + 1] = sq[jj][0][1];
        }
        rows_reduce_scatter(v, g);
        if (gc < p.n) atomicAdd(dst, v[0]);
        if (gc + 1 < p.n) atomicAdd(dst + 1, v[1]);
      } else {
        float v[4 * CH];
#pragma unroll
        for (int jj = 0; jj < CH; ++jj)
#pragma unroll
          for (int k = 0; k < 4; ++k) v[4 * jj + k] = sq[jj][k / 2][k % 2];
        rows_reduce_scatter(v, g);
        if (gc < p.n) {
          atomicAdd(dst, v[0]);
          atomicAdd(dst + p.n, v[2]);
        }
        if (gc + 1 < p.n) {
          atomicAdd(dst + 1, v[1]);
          atomicAdd(dst + p.n + 1, v[3]);
        }
      }
    }
    if (p.pairs == 2) {
      // lane t stores columns 8 (j0 + jj + t % 2) .. +7 of row (t < 2 ? a : b)
      const int gr = t < 2 ? row_a : row_b;
#pragma unroll
      for (int jj = 0; jj < CH; jj += 2) {
        uint32_t v[4] = {out[jj][0], out[jj + 1][0], out[jj][1], out[jj + 1][1]};
        quad_transpose(v, t);
        const int gc = w.n0 + 8 * (j0 + jj + t % 2);
        if (gr < p.m && gc < p.n)  // n % 8 == 0: the 8 columns are all in
          *reinterpret_cast<uint4*>(C + (size_t)gr * p.n + gc) = make_uint4(v[0], v[1], v[2], v[3]);
      }
      continue;
    }
#pragma unroll
    for (int jj = 0; jj < CH; ++jj) {
      const int gc = w.n0 + 8 * (j0 + jj) + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gr = h ? row_b : row_a;
        if (gr >= p.m || gc >= p.n) continue;
        T* dst = C + (size_t)gr * p.n + gc;
        if (p.pairs && gc + 1 < p.n) {
          *reinterpret_cast<uint32_t*>(dst) = out[jj][h];
        } else {
          const __nv_bfloat162 pair = *reinterpret_cast<const __nv_bfloat162*>(&out[jj][h]);
          dst[0] = __low2bfloat16(pair);
          if (gc + 1 < p.n) dst[1] = __high2bfloat16(pair);
        }
      }
    }
  }
  // Images of fewer than 16 rows: one atomicAdd per element, in the generic
  // kernel only (its own pass re-reads acc, which would keep every
  // accumulator live through the specialised kernels' epilogues).
  if (ANY && stats && slab_in && span > 1) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int gr = h ? row_b : row_a, c = 8 * j + 2 * t + e, gc = w.n0 + c;
          if (gr >= p.m || gc >= p.n) continue;
          const float hv = gelu_erf(acc[4 * j + 2 * h + e] + sbias[c]);
          atomicAdd(&p.stats[(size_t)(gr / p.seq) * p.n + gc], hv * hv);
        }
  }
}

// Persistent blocks, one per SM, walk the units u = blockIdx.x + i * gridDim.x;
// both consumer warpgroups take every unit (rows [0, 64) and [64, 128) of its
// tile). The ring runs on across units, so the producer fills the next
// tile's stages during this tile's epilogue.
template <int BN, bool TMA, int E>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
                const GemmArgs p, int units) {
  using C = Cfg<BN>;
  constexpr int STAGES = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * C::STAGE);
  uint64_t* empty = full + STAGES;
  uint64_t* side_full = empty + STAGES;  // a tile's bias and mask, per slot
  uint64_t* side_empty = side_full + 2;
  float* side = reinterpret_cast<float*>(smem + C::SIDE);  // [slot][bias, mask][BN]
  constexpr int LOADERS = TMA ? 1 : PRODUCER_THREADS - 32;  // warp 1 fills the side slots
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], LOADERS);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&side_full[s], 32);
      mbar_init(&side_empty[s], CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < PRODUCER_THREADS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int pwarp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (pwarp == 1) {  // the bias and mask of unit i, in fp32, into slot i % 2
      const T* bias = static_cast<const T*>(p.bias);
      for (int i = 0, u = blockIdx.x; u < units; ++i, u += gridDim.x) {
        const Unit w = unit_of<BN>(p, u);
        if (i >= 2) mbar_wait(&side_empty[i & 1], ((i >> 1) + 1) & 1);
        float* sb = side + (i & 1) * 2 * BN;
        for (int c = lane; c < BN; c += 32) {
          const int gc = w.n0 + c;
          sb[c] = bias && gc < p.n ? to_f(bias[gc]) : 0.f;
          sb[BN + c] = p.mask && gc < p.n ? p.mask[gc] : 1.f;
        }
        mbar_arrive(&side_full[i & 1]);
        if (p.resid != nullptr && p.partial == nullptr) {
          // the tile's residual rows into L2 while the products run, 128 bytes a prefetch
          const T* resid = static_cast<const T*>(p.resid);
          const int seg = min(BN, p.n - w.n0) * 2;  // bytes of a row in this tile
          for (int e = lane; e < BM * ((seg + 127) / 128); e += 32) {
            const int r = e / ((seg + 127) / 128), cb = (e % ((seg + 127) / 128)) * 128;
            if (w.m0 + r < p.m)
              asm volatile("prefetch.global.L2 [%0];\n" ::"l"(
                  reinterpret_cast<const char*>(resid + (size_t)(w.m0 + r) * p.n + w.n0) + cb));
          }
        }
      }
      return;
    }
    if (TMA && threadIdx.x != 0) return;
    const int f = threadIdx.x - (pwarp > 1 ? 32 : 0);  // index among the loading threads
    int it = 0;  // stages filled so far
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit w = unit_of<BN>(p, u);
      for (int kt = 0; kt < w.steps; ++kt, ++it) {
        const int s = it % STAGES, k0 = w.k_lo + kt * BK;
        if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) + 1) & 1);
        unsigned char* st = smem + s * C::STAGE;
        if constexpr (TMA) {
          mbar_expect_tx(&full[s], C::STAGE);
          tma_load(st, &map_a, k0, w.m0, &full[s]);
#pragma unroll
          for (int b = 0; b < BN / 64; ++b)
            tma_load(st + A_TILE + b * B_BOX, &map_b, w.n0 + 64 * b, k0, &full[s]);
        } else {
          fill_stage<BN, LOADERS>(p, st, w.m0, w.n0, k0, f);
          fence_proxy_async();
          mbar_arrive(&full[s]);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wgi = threadIdx.x / 128 - 1, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const float gate = p.gate ? *p.gate : 1.f;
  int it = 0;  // stages consumed so far
  for (int i = 0, u = blockIdx.x; u < units; ++i, u += gridDim.x) {
    const Unit w = unit_of<BN>(p, u);
    float acc[BN / 2];
#pragma unroll
    for (int k = 0; k < BN / 2; ++k) acc[k] = 0.f;
    for (int kt = 0; kt < w.steps; ++kt, ++it) {
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      const uint32_t a_addr = smem_u32(smem + s * C::STAGE) + wgi * 64 * 128;
      const uint32_t b_addr = smem_u32(smem + s * C::STAGE + A_TILE);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_ss<1>(acc, smem_desc(a_addr + kk * 32), smem_desc_mn(b_addr + kk * 2048, B_BOX), 1);
      wgmma_commit();
      wgmma_wait<1>();
      // the products of the previous stage are complete: hand its slot back
      if (kt > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
    mbar_wait(&side_full[i & 1], (i >> 1) & 1);
    const float* sb = side + (i & 1) * 2 * BN;
    store_slab<BN, E>(p, w, acc, w.m0 + 64 * wgi + 16 * warp, lane / 4, lane % 4, gate, sb, sb + BN);
    if (lane == 0) mbar_arrive(&side_empty[i & 1]);
  }
}

template <int BN, bool TMA, int E>
cudaError_t launch_t(const GemmArgs& p, long long units, cudaStream_t s) {
  const auto kern = gemm_kernel<BN, TMA, E>;
  static std::atomic<unsigned long long> smem_allowed{0};
  cudaError_t err = allow_max_dynamic_smem(kern, smem_allowed);
  if (err != cudaSuccess) return err;
  static std::atomic<int> regs_checked{0};
  if ((err = check_launch_regs(kern, LAUNCH_REGS, regs_checked)) != cudaSuccess) return err;
  CUtensorMap ma{}, mb{};
  if (TMA) {
    const bool ok =
        encode_2d(&ma, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p.a, p.k, p.m, 2ull * p.k, BK, BM) &&
        encode_2d(&mb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p.b, p.n, p.k, 2ull * p.n, 64, BK);
    // The shapes meet TMA's rules: an encoder that cannot be found or refuses
    // them is an error, never a quiet switch to the element-load producer.
    if (!ok) return cudaErrorNotSupported;
  }
  const int grid = static_cast<int>(std::min<long long>(units, sm_count()));
  kern<<<grid, THREADS, Cfg<BN>::SMEM, s>>>(ma, mb, p, static_cast<int>(units));
  return cudaGetLastError();
}

// Tile width for (m, n): the one whose rounds of tiles over the SMs take the
// fewest columns of work (a tie goes to 256).
inline int tile_cols(int m, int n) {
  const long long m_tiles = (m + BM - 1) / BM, sms = sm_count();
  long long best = -1;
  int pick = 256;
  for (const int bn : {256, 128}) {
    const long long rounds = (m_tiles * ((n + bn - 1) / bn) + sms - 1) / sms;
    if (best < 0 || rounds * bn < best) {
      best = rounds * bn;
      pick = bn;
    }
  }
  return pick;
}

template <int BN, int E>
cudaError_t launch_tma(const GemmArgs& p, long long units, cudaStream_t s) {
  return launch_t<BN, true, E>(p, units, s);
}

// TMA shapes take the kernel compiled for their tile width and epilogue; the
// element-load kernel is one, 128 wide, for every epilogue, and also takes
// stats over images shorter than 16 rows (the specialised kernels assume a
// warp's 16 rows hold at most two images).
inline cudaError_t launch(const GemmArgs& p, bool tma, int splits, cudaStream_t s) {
  const bool generic = !tma || (p.stats && p.seq < 16);
  const int bn = generic ? 128 : tile_cols(p.m, p.n);
  const long long units = (long long)((p.n + bn - 1) / bn) * ((p.m + BM - 1) / BM) * splits;
  if (generic) return launch_t<128, false, kAny>(p, units, s);
  switch (epi_kind(p) + 8 * (bn == 256)) {
    case kBias: return launch_tma<128, kBias>(p, units, s);
    case kGelu: return launch_tma<128, kGelu>(p, units, s);
    case kGeluStats: return launch_tma<128, kGeluStats>(p, units, s);
    case kResidual: return launch_tma<128, kResidual>(p, units, s);
    case 8 + kBias: return launch_tma<256, kBias>(p, units, s);
    case 8 + kGelu: return launch_tma<256, kGelu>(p, units, s);
    case 8 + kGeluStats: return launch_tma<256, kGeluStats>(p, units, s);
    default: return launch_tma<256, kResidual>(p, units, s);
  }
}
}  // namespace
}  // namespace wg

// LayerNorm, one warp per row: fp32 mean, then the mean squared deviation (two
// passes, as layer_norm in ops/common.py); y cast to the operand dtype.
template <typename T>
__global__ void layer_norm_kernel(const T* x, const T* g, const T* b, T* y, int m, int n,
                                  float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32, lane = threadIdx.x % 32;
  if (row >= m) return;
  const T* xr = x + (size_t)row * n;
  float s = 0.f;
  for (int i = lane; i < n; i += 32) s += to_f(xr[i]);
  const float mu = warp_sum(s) / n;
  float q = 0.f;
  for (int i = lane; i < n; i += 32) {
    const float d = to_f(xr[i]) - mu;
    q = fmaf(d, d, q);
  }
  const float rstd = rsqrtf(warp_sum(q) / n + eps);
  T* yr = y + (size_t)row * n;
  for (int i = lane; i < n; i += 32)
    yr[i] = from_f<T>((to_f(xr[i]) - mu) * rstd * to_f(g[i]) + to_f(b[i]));
}

}  // namespace ssp

extern "C" int ssp_layer_norm(int dtype, const void* x, const void* g, const void* b, void* y,
                              int m, int n, float eps, void* stream) {
  using namespace ssp;
  const int rows_per_block = 8;
  const dim3 grid((m + rows_per_block - 1) / rows_per_block);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    layer_norm_kernel<float><<<grid, 32 * rows_per_block, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g),
        static_cast<const float*>(b), static_cast<float*>(y), m, n, eps);
  else
    layer_norm_kernel<__nv_bfloat16><<<grid, 32 * rows_per_block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g),
        static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(y), m, n, eps);
  return static_cast<int>(cudaGetLastError());
}

namespace ssp {
// Split count of a GEMM of this dtype and shape (policy in common.cuh).
int split_count(int dtype, int m, int n, int k) {
  const int bm = dtype == kF32 ? f32::BM : wg::BM, bn = dtype == kF32 ? f32::BN : wg::tile_cols(m, n);
  const int bk = dtype == kF32 ? f32::BK : wg::BK;
  return split_count((long long)((m + bm - 1) / bm) * ((n + bn - 1) / bn), k, bk);
}
}  // namespace ssp

// fp32 workspace (in floats) that ssp_gemm needs for these shapes; 0 = none.
extern "C" long long ssp_gemm_workspace_floats(int dtype, int m, int n, int k) {
  const int splits = ssp::split_count(dtype, m, n, k);
  return splits > 1 ? (long long)splits * m * n : 0;
}

extern "C" int ssp_gemm(int dtype, const void* a, const void* b, void* c, int m, int n, int k,
                        int epi, const void* bias, const void* resid, const float* gate,
                        const float* mask, float* stats, int seq, float* workspace,
                        void* stream) {
  using namespace ssp;
  const int bk = dtype == kF32 ? f32::BK : wg::BK;
  const int k_tiles = (k + bk - 1) / bk;
  const int splits = workspace ? split_count(dtype, m, n, k) : 1;
  const int k_chunk = std::max(1, (k_tiles + splits - 1) / splits) * bk;
  const int nsplit = std::max(1, (k + k_chunk - 1) / k_chunk);
  const bool split = nsplit > 1;
  const auto aligned = [](const void* ptr, uintptr_t bytes) {
    return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
  };
  const int pairs = n % 8 == 0 && aligned(c, 16) && (resid == nullptr || aligned(resid, 16)) ? 2
                    : n % 2 == 0 && aligned(c, 4) ? 1 : 0;
  GemmArgs p{a, b, c, m, n, k, epi, bias, resid, gate, mask, stats, seq,
             split ? workspace : nullptr, k_chunk, pairs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stats) {
    const cudaError_t err = cudaMemsetAsync(stats, 0, sizeof(float) * (size_t)(m / seq) * n, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaError_t err;
  if (dtype == kF32) {
    const dim3 grid((n + f32::BN - 1) / f32::BN, (m + f32::BM - 1) / f32::BM, nsplit);
    f32::gemm_kernel<<<grid, f32::THREADS, 0, s>>>(p);
    err = cudaGetLastError();
  } else {
    // TMA needs 16-byte aligned bases and row strides (K and N multiples of 8).
    const bool tma = k % 8 == 0 && n % 8 == 0 && aligned(a, 16) && aligned(b, 16);
    err = wg::launch(p, tma, nsplit, s);
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

extern "C" const char* ssp_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
