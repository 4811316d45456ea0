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
// bf16 against 90 MB of gate and up weights), and no atomic adds into sums:
// every sum is taken in a fixed order, so a result is the same bits on every
// run.
//
// - bf16, m <= 16 (decode, speculative windows, beams): the weight stream, two
//   launches per call. Bytes bound it, so the design streams each weight byte
//   once at the card's rate and keeps everything else off that stream's path:
//   - swap AB, as the wide tiles: the int8 weight is the A operand (output
//     columns are its rows), dequantised to bf16 in registers
//     (qgemm_tile.cuh's load_frags; integer codes are exact in bf16 and the
//     products exact in fp32), the activation rows are B, 8 of them a
//     product (m <= 8) or 16 (m <= 16), read from the activation tile that
//     TMA zero-fills past m. The products are warp-level mma.sync m16n8k16:
//     at N = 8 a warpgroup's wgmma m64n8k16 waits out a fixed latency per
//     16-deep step (on an H100 that made the stream slower than the wide
//     tiles), while each warp's mma.sync runs on its own; load_frags builds
//     the same A fragment for both;
//   - one producer thread keeps a 6-stage TMA ring full (each stage a 64-deep
//     K step: two 128-column boxes of one matrix side by side, 16 KB, so every
//     weight row is read as one 256-byte run, which streams markedly faster
//     on an H100 than 128-byte runs from each of two matrices; and the
//     [N, 64] activation tile, 1-2 KB); two consumer warpgroups own 128
//     columns each;
//   - a persistent grid of one block per SM walks (column tile, matrix, K
//     split) tiles, splits fastest, so the ring runs on across tiles and a
//     column tile's tiles run side by side. K is split because the column
//     tiles alone leave SMs idle (phase 1 at f = 11008: 2 x 43 tiles of 256
//     columns; phase 2 at d = 4096: 16); plan() picks the split that balances
//     the tiles over the SMs from the shapes alone;
//   - the splits are summed inside the launch: each tile stores its fp32
//     partial sums, takes a ticket (an acquire-release add on a counter that
//     the last one sets back to 0), and the last tile of a column tile adds
//     the partials of each matrix in split order, with every load of a split
//     in flight at once, then applies silu(g * gs) * (u * us) (phase 1: gate
//     and up are the two matrices) or * ds (phase 2) and stores. So no sum
//     depends on which block finished last;
//   - phase 2 is a programmatic dependent launch: its blocks start on the SMs
//     phase 1's blocks leave and load their first ring of weights before
//     griddepcontrol.wait, which holds every read of h until phase 1 is done.
//   Shapes that break TMA's 16-byte rules (a 2SSP-pruned f = 8253, d = 682,
//   an x that starts off 16 bytes) run the same kernel with the producer
//   warpgroup filling the stages by element loads (qgemm_tile.cuh's
//   fill_stage); shapes that meet them always take TMA, and a tensor map
//   that cannot be encoded is an error. What holds it back now: the
//   consumer's int8 -> bf16 converts (~2.5 instructions a weight; at m = 16
//   the consumer alone takes most of the call) and each phase's last tiles,
//   whose split sums nothing overlaps.
// - fp32, m <= 16: a SIMT skinny product (fp32 is not the served dtype at 7B
//   width, and wgmma has no fp32 inputs). A block owns 64 output columns of
//   one weight matrix and 8 activation rows; its 256 threads stream the
//   weight rows, 8 bytes per thread and four rows in flight, against x rows
//   staged in shared memory as fp32; the warps reduce in warp order, K is
//   split when the tiles make less than two waves, and two more passes sum
//   the splits in order and apply the epilogues (4 launches).
// - m > 16 (prefill): the tile pipeline of qgemm_tile.cuh, which quant_gemm.cu
//   runs too (bf16: wgmma with the int8 weight converted to bf16 in registers
//   as the A operand, TMA loads into a 4-6 stage ring; fp32: a 64x64x32 SIMT
//   tile). Phase 1 gives it gq and uq as a pair: each consumer warpgroup
//   multiplies the gate and the up columns of the same f columns, so g and u
//   of an output sit in one thread and the epilogue computes h from the
//   registers. Phase 2 is the int8 dequant GEMM of quant_gemm.cu, with its
//   split-K plan.

#include <algorithm>
#include <cstdint>

#include "common.cuh"
#include "qgemm_tile.cuh"

namespace ssp {
namespace fm {
// Internal linkage, as qgemm_tile.cuh: each loaded library owns its kernels
// and their once-per-device attribute calls.
namespace {

constexpr int kSkinnyMaxM = 16;

// ------------------------------------------------- weight stream (bf16) ----
namespace sw {
using namespace ::ssp::hopper;
using T = __nv_bfloat16;
using qtile::wg::W_BOX;
constexpr int BK = qtile::wg::BK;       // K rows per stage
constexpr int THREADS = 384;            // producer warpgroup + two consumer warpgroups
constexpr int PRODUCER_THREADS = 128;
constexpr int CONSUMER_THREADS = 256;
constexpr int CONSUMER_WARPS = 8;

template <int BN>
struct Cfg {
  static constexpr int X_TILE = BN * 128;       // [BN rows, 64] bf16, as fill_stage lays it out
  static constexpr int STAGE = X_TILE + 2 * W_BOX;
  static constexpr int STAGES = 6;
  static constexpr size_t SMEM = (size_t)STAGES * STAGE + 2 * STAGES * sizeof(uint64_t) + 1024;
  static_assert(SMEM <= 232448, "the ring must fit one block's shared memory");
};

// One phase's walk: column tiles x K splits, each split `chunk` rows deep.
struct Plan {
  int col_tiles, splits, chunk, grid;
};

struct Args {
  qtile::Args q;  // operands (bits 8); q.partial: [matrix][split][m][n] fp32, q.k_chunk = chunk
  int splits, col_tiles;
  int* tickets;   // [col_tiles] counters, 0 on entry and on exit
};

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMER_THREADS) : "memory");
}

// D[16, 8] += A[16, 16] B[16, 8], bf16 in, fp32 D in registers (one warp). A's
// fragment is a warp's share of a wgmma A operand (qtile::wg::load_frags): rows
// g and g+8, K 2t, 2t+1 and 2t+8, 2t+9; B's is K 2t, 2t+1 (b0) and 2t+8, 2t+9
// (b1) of column g; d[2h + e] is row g + 8h, column 2t + e.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A persistent block walks tiles blockIdx.x, blockIdx.x + gridDim.x, ...;
// tile t is K split t % splits of matrix (t / splits) % MATS of column tile
// t / (splits * MATS), so a column tile's tiles run side by side and most
// column tiles are summed while later ones stream. A tile is 256 columns of one
// matrix: two 128-byte boxes side by side, so every weight row is read as one
// 256-byte run. PAIR: phase 1 (gate and up are the matrices, h out; the last
// of a column tile's 2 * splits tiles applies the SwiGLU); else phase 2 (out).
template <bool PAIR, int BN>
__global__ void __launch_bounds__(THREADS, 1)
    kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w0,
           const __grid_constant__ CUtensorMap map_w1, const Args a) {
  using C = Cfg<BN>;
  constexpr int COLS = qtile::wg::block_cols<false>();  // output columns of a tile
  constexpr int MATS = PAIR ? 2 : 1;
  const qtile::Args& p = a.q;
  extern __shared__ unsigned char smem_raw[];
  __shared__ int last_flag;
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::STAGES * C::STAGE);
  uint64_t* empty = full + C::STAGES;
  const int tiles = a.splits * MATS * a.col_tiles;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], p.tma ? 1 : PRODUCER_THREADS);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // Phase 1 lets phase 2 be scheduled at once (programmatic dependent launch):
  // phase 2's blocks take the SMs that phase 1's blocks leave and stream their
  // first weights while phase 1 ends; griddepcontrol.wait then holds every read
  // of h (and every store) until phase 1 has completed and its stores are visible.
  if constexpr (PAIR) {
    if (threadIdx.x == 0) asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  }
  if (threadIdx.x < PRODUCER_THREADS) {
    if (p.tma && threadIdx.x != 0) return;
    if (!p.tma) asm volatile("griddepcontrol.wait;\n" ::: "memory");
    qtile::Args one = p;  // the tile's matrix as a single one, for the element loads
    one.w1 = nullptr;
    int it = 0;
    bool waited = false;  // the first ring of stages gets its weights before the wait, x after it
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int mat = (tile / a.splits) % MATS, n0 = tile / (a.splits * MATS) * COLS;
      const int r_lo = tile % a.splits * p.k_chunk, r_hi = min(p.k, r_lo + p.k_chunk);
      one.w = mat ? p.w1 : p.w;
      const CUtensorMap* map_w = mat ? &map_w1 : &map_w0;
      for (int r = r_lo; r < r_hi; r += BK, ++it) {
        const int s = it % C::STAGES;
        if (p.tma && it == C::STAGES) {  // the ring's weights are in flight: now h
          asm volatile("griddepcontrol.wait;\n" ::: "memory");
          waited = true;
          // x of the first ring of stages (the walk's first K rows, as issued)
          int jt = 0;
          for (int t2 = blockIdx.x; t2 < tiles && jt < C::STAGES; t2 += gridDim.x) {
            const int r2_lo = t2 % a.splits * p.k_chunk, r2_hi = min(p.k, r2_lo + p.k_chunk);
            for (int r2 = r2_lo; r2 < r2_hi && jt < C::STAGES; r2 += BK, ++jt)
              tma_load(smem + jt * C::STAGE, &map_x, r2, 0, &full[jt]);
          }
        }
        if (it >= C::STAGES) mbar_wait(&empty[s], ((it / C::STAGES) + 1) & 1);
        unsigned char* st = smem + s * C::STAGE;
        if (!p.tma) {
          qtile::wg::fill_stage<8, false, BN>(one, st, 0, n0, r);
          mbar_arrive(&full[s]);
          continue;
        }
        mbar_expect_tx(&full[s], C::STAGE);
        if (waited) tma_load(st, &map_x, r, 0, &full[s]);
        unsigned char* wst = st + C::X_TILE;
        tma_load(wst, map_w, n0, r, &full[s]);
        tma_load(wst + W_BOX, map_w, n0 + 128, r, &full[s]);
      }
    }
    if (p.tma && !waited) {  // a walk shorter than the ring
      asm volatile("griddepcontrol.wait;\n" ::: "memory");
      int jt = 0;
      for (int t2 = blockIdx.x; t2 < tiles; t2 += gridDim.x) {
        const int r2_lo = t2 % a.splits * p.k_chunk, r2_hi = min(p.k, r2_lo + p.k_chunk);
        for (int r2 = r2_lo; r2 < r2_hi; r2 += BK, ++jt)
          tma_load(smem + jt * C::STAGE, &map_x, r2, 0, &full[jt]);
      }
    }
    return;
  }
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  const int ctid = threadIdx.x - PRODUCER_THREADS;
  const int wgi = ctid / 128, warp = (ctid / 32) % 4, lane = ctid % 32;
  const int g = lane / 4, t = lane % 4;
  const int col = 32 * warp + 4 * g;  // byte column in the warpgroup's box
  const size_t mn = (size_t)p.m * p.n;
  float* part = p.partial;
  T* out = static_cast<T*>(p.out);
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int ct = tile / (a.splits * MATS), mat = (tile / a.splits) % MATS;
    const int split = tile % a.splits;
    const int n0 = ct * COLS, r_lo = split * p.k_chunk, r_hi = min(p.k, r_lo + p.k_chunk);
    const int kt_count = (r_hi - r_lo + BK - 1) / BK;
    float acc[2][BN / 2];
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[b][i] = 0.f;
    for (int kt = 0; kt < kt_count; ++kt, ++it) {
      const int s = it % C::STAGES;
      mbar_wait(&full[s], (it / C::STAGES) & 1);
      const unsigned char* st = smem + s * C::STAGE;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t frag[1][2][4];
        qtile::wg::load_frags<8, false>(st + C::X_TILE, wgi, col, kk * 16 + 2 * t, frag);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          // B: activation row 8j + g, K 2t, 2t+1 and 2t+8, 2t+9 of this step
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(st + swz(8 * j + g, 32 * kk + 4 * t));
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(st + swz(8 * j + g, 32 * kk + 4 * t + 16));
#pragma unroll
          for (int b = 0; b < 2; ++b)
            mma_16816(*reinterpret_cast<float(*)[4]>(&acc[b][4 * j]), frag[0][b], b0, b1);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // this tile's fp32 partial sums: acc[b][4j + 2h + e] is column nb + 2b + h,
    // activation row 8j + 2t + e
    float* tile_part = part + (size_t)(mat * a.splits + split) * mn;
    const int nb = n0 + 128 * wgi + 32 * warp + 4 * g;
    const bool vec = p.n % 4 == 0;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int gm = 8 * j + 2 * t + e;
        if (gm >= p.m) continue;
        const float v[4] = {acc[0][4 * j + e], acc[0][4 * j + 2 + e], acc[1][4 * j + e],
                            acc[1][4 * j + 2 + e]};
        float* dst = tile_part + (size_t)gm * p.n + nb;
        if (vec && nb + 3 < p.n) {
          *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (nb + c < p.n) dst[c] = v[c];
        }
      }
    // the block's stores, then the ticket: bar.sync orders them before thread
    // 0's acquire-release add, which publishes them and, for the last tile,
    // makes the other tiles' partials visible
    consumer_sync();
    if (ctid == 0) {
      int old;
      asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                   : "=r"(old)
                   : "l"(a.tickets + ct)
                   : "memory");
      const int last = old == MATS * a.splits - 1;
      if (last) a.tickets[ct] = 0;  // every tile of this column tile has arrived: ready for the next call
      last_flag = last;
    }
    consumer_sync();
    if (!last_flag) continue;
    // the last tile of this column tile: sum each matrix's partials in split
    // order, then the epilogue. The loads carry no branch (clamped addresses,
    // a select after), so a thread's loads of several splits are in flight together.
    constexpr int UNITS = BN * COLS / 4 / CONSUMER_THREADS;  // 4-column units a thread sums
    constexpr int PER_ROW = COLS / 4;
    float s0[UNITS][4], s1[UNITS][4];
    size_t off[UNITS];
    bool in[UNITS];
#pragma unroll
    for (int q = 0; q < UNITS; ++q) {
      const int u = ctid + q * CONSUMER_THREADS, row = u / PER_ROW, gc = n0 + 4 * (u % PER_ROW);
      in[q] = row < p.m && gc < p.n;
      off[q] = in[q] ? (size_t)row * p.n + gc : 0;
#pragma unroll
      for (int c = 0; c < 4; ++c) s0[q][c] = s1[q][c] = 0.f;
    }
    if (vec) {  // n % 4 == 0: whole 16-byte units
#pragma unroll 2
      for (int z = 0; z < a.splits; ++z) {
        float4 v[MATS][UNITS];
#pragma unroll
        for (int mi = 0; mi < MATS; ++mi)
#pragma unroll
          for (int q = 0; q < UNITS; ++q)
            v[mi][q] = __ldcg(reinterpret_cast<const float4*>(part + (size_t)(mi * a.splits + z) * mn + off[q]));
#pragma unroll
        for (int mi = 0; mi < MATS; ++mi)
#pragma unroll
          for (int q = 0; q < UNITS; ++q) {
            float(&sum)[4] = mi ? s1[q] : s0[q];
            sum[0] += v[mi][q].x;
            sum[1] += v[mi][q].y;
            sum[2] += v[mi][q].z;
            sum[3] += v[mi][q].w;
          }
      }
    } else {
      for (int z = 0; z < a.splits; ++z)
#pragma unroll
        for (int mi = 0; mi < MATS; ++mi)
#pragma unroll
          for (int q = 0; q < UNITS; ++q) {
            const int gc = n0 + 4 * ((ctid + q * CONSUMER_THREADS) % PER_ROW);
            float(&sum)[4] = mi ? s1[q] : s0[q];
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (in[q] && gc + c < p.n) sum[c] += __ldcg(part + (size_t)(mi * a.splits + z) * mn + off[q] + c);
          }
    }
#pragma unroll
    for (int q = 0; q < UNITS; ++q) {
      if (!in[q]) continue;
      const int gc = n0 + 4 * ((ctid + q * CONSUMER_THREADS) % PER_ROW);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (gc + c >= p.n) continue;
        const float v = PAIR ? qtile::silu(s0[q][c] * p.scale[gc + c]) * (s1[q][c] * p.scale1[gc + c])
                             : s0[q][c] * p.scale[gc + c];
        out[off[q] + c] = __float2bfloat16(v);
      }
    }
  }
}

// The walk of one phase over `mats` matrices of n columns and k rows, 256
// columns a tile: the split (1-16) whose slowest block walks the fewest K
// steps, a tile costing one step more than its depth (its partials and
// epilogue); ties keep fewer splits. A pure function of the shapes and the SM
// count.
inline Plan plan(int mats, int n, int k) {
  const int sms = sm_count(), cols = qtile::wg::block_cols<false>();
  Plan pl{(n + cols - 1) / cols, 1, 0, 0};
  const int k_steps = (k + BK - 1) / BK;
  long long best = -1;
  for (int want = 1; want <= std::min(16, k_steps); ++want) {
    const int steps = (k_steps + want - 1) / want, splits = (k_steps + steps - 1) / steps;
    const long long tiles = (long long)pl.col_tiles * mats * splits;
    const long long cost = (tiles + sms - 1) / sms * (steps + 1);
    if (best < 0 || cost < best) {
      best = cost;
      pl.splits = splits;
      pl.chunk = steps * BK;
    }
  }
  pl.grid = static_cast<int>(std::min<long long>((long long)pl.col_tiles * mats * pl.splits, sms));
  return pl;
}

template <bool PAIR, int BN>
cudaError_t launch(const Args& a, const Plan& pl, cudaStream_t s) {
  using C = Cfg<BN>;
  const qtile::Args& p = a.q;
  const auto kern = kernel<PAIR, BN>;
  static std::atomic<unsigned long long> smem_allowed{0};
  cudaError_t err = allow_max_dynamic_smem(kern, smem_allowed);
  if (err != cudaSuccess) return err;
  CUtensorMap mx{}, mw0{}, mw1{};
  if (p.tma) {
    const bool ok =
        encode_2d(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p.x, p.k, p.m, 2ull * p.k, BK, BN) &&
        encode_2d(&mw0, CU_TENSOR_MAP_DATA_TYPE_UINT8, p.w, p.n, p.k, p.n, 128, BK) &&
        (!PAIR || encode_2d(&mw1, CU_TENSOR_MAP_DATA_TYPE_UINT8, p.w1, p.n, p.k, p.n, 128, BK));
    // The shapes passed tma_ok: an encoder that cannot be found or refuses them
    // is an error, never a quiet switch to the element-load producer.
    if (!ok) return cudaErrorNotSupported;
  }
  // phase 2 may start under phase 1's tail (see the kernel)
  cudaLaunchAttribute attr{};
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(pl.grid);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = PAIR ? 0 : 1;
  err = cudaLaunchKernelEx(&cfg, kern, mx, mw0, mw1, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Phase 1 (h = silu(x gq * gs) * (x uq * us)) and phase 2 (out = h dq * ds).
template <int BN>
cudaError_t run(const Plan& p1, const Plan& p2, const void* x, const signed char* gq,
                const float* gs, const signed char* uq, const float* us, const signed char* dq,
                const float* ds, T* h, T* out, int m, int d, int f, float* ws, int* tickets,
                cudaStream_t s) {
  qtile::Args q1{x, gq, uq, gs, us, h, m, f, d, 8, ws, p1.chunk, 0};
  q1.tma = qtile::wg::tma_ok(q1) ? 1 : 0;
  cudaError_t err = launch<true, BN>(Args{q1, p1.splits, p1.col_tiles, tickets}, p1, s);
  if (err != cudaSuccess) return err;
  qtile::Args q2{h, dq, nullptr, ds, nullptr, out, m, d, f, 8, ws, p2.chunk, 0};
  q2.tma = qtile::wg::tma_ok(q2) ? 1 : 0;
  return launch<false, BN>(Args{q2, p2.splits, p2.col_tiles, tickets}, p2, s);
}
}  // namespace sw

// ------------------------------------------------------ skinny (fp32) ----
namespace sk {
constexpr int ROWS = 8, NT = 64, THREADS = 256, KC = 512;
constexpr int PASS = THREADS / (NT / 8);  // weight rows one pass of the block covers: 32

struct Args {
  const float* x;         // [m, k]
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
__global__ void __launch_bounds__(THREADS) kernel(Args p) {
  __shared__ float xs[ROWS][KC];
  __shared__ float red[THREADS / 32][ROWS][NT];
  const int n0 = blockIdx.x * NT, split = blockIdx.y;
  const int mat = blockIdx.z / p.row_groups, r0 = (blockIdx.z % p.row_groups) * ROWS;
  const int rows = min(ROWS, p.m - r0);
  const signed char* w = mat ? p.w1 : p.w0;
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
      xs[r][c] = (r < rows && c < kn) ? p.x[(size_t)(r0 + r) * p.k + kc + c] : 0.f;
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

// Sum the splits in order; h = silu(g * gs) * (u * us) (gate partials, then up).
__global__ void swiglu_reduce_kernel(const float* part, const float* gs, const float* us, float* h,
                                     int m, int n, int splits) {
  const size_t mn = (size_t)m * n;
  const size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  if (e >= mn) return;
  float g = 0.f, u = 0.f;
  for (int z = 0; z < splits; ++z) g += part[z * mn + e];
  for (int z = 0; z < splits; ++z) u += part[(splits + z) * mn + e];
  const int col = static_cast<int>(e % n);
  h[e] = qtile::silu(g * gs[col]) * (u * us[col]);
}
}  // namespace sk

// The launch plan of one call: a pure function of the shapes and the SM count,
// so the workspace and ticket queries and the launch agree.
struct Plan {
  enum Route { kStream, kSkinny, kWide } route;
  int row_groups;              // skinny
  int splits1, chunk1;         // skinny phase 1
  int splits2, chunk2;         // skinny phase 2
  sw::Plan s1, s2;             // weight stream phases 1 and 2
  qtile::Plan wide2;           // wide phase 2 (wide phase 1 is a pair and does not split)
  long long ws_floats, tickets;
};

inline Plan plan_for(int dtype, int m, int d, int f, int wide) {
  Plan pl{};
  if (m <= kSkinnyMaxM && !wide && dtype == kBF16) {
    pl.route = Plan::kStream;
    pl.s1 = sw::plan(2, f, d);
    pl.s2 = sw::plan(1, d, f);
    pl.ws_floats = std::max(2LL * pl.s1.splits * m * f, (long long)pl.s2.splits * m * d);
    pl.tickets = std::max(pl.s1.col_tiles, pl.s2.col_tiles);
    return pl;
  }
  if (m <= kSkinnyMaxM && !wide) {
    pl.route = Plan::kSkinny;
    pl.row_groups = (m + sk::ROWS - 1) / sk::ROWS;
    split_k(2LL * pl.row_groups * ((f + sk::NT - 1) / sk::NT), d, sk::PASS, pl.splits1, pl.chunk1);
    split_k((long long)pl.row_groups * ((d + sk::NT - 1) / sk::NT), f, sk::PASS, pl.splits2,
            pl.chunk2);
    pl.ws_floats = std::max(2LL * pl.splits1 * m * f, (long long)pl.splits2 * m * d);
    return pl;
  }
  pl.route = Plan::kWide;
  pl.wide2 = qtile::plan(dtype, 8, m, d, f);
  pl.ws_floats = qtile::workspace_floats(pl.wide2, m, d);
  return pl;
}

cudaError_t run_skinny(const Plan& pl, const float* x, const signed char* gq, const float* gs,
                       const signed char* uq, const float* us, const signed char* dq,
                       const float* ds, float* h, float* out, int m, int d, int f, float* ws,
                       cudaStream_t s) {
  const auto al8 = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 8 == 0; };
  sk::Args a1{x, gq, uq, ws, m, f, d, pl.chunk1, pl.splits1, pl.row_groups,
              f % 8 == 0 && al8(gq) && al8(uq)};
  sk::kernel<<<dim3((f + sk::NT - 1) / sk::NT, pl.splits1, 2 * pl.row_groups), sk::THREADS, 0,
               s>>>(a1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t mf = (size_t)m * f, md = (size_t)m * d;
  sk::swiglu_reduce_kernel<<<static_cast<unsigned>((mf + 255) / 256), 256, 0, s>>>(
      ws, gs, us, h, m, f, pl.splits1);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  sk::Args a2{h, dq, nullptr, ws, m, d, f, pl.chunk2, pl.splits2, pl.row_groups,
              d % 8 == 0 && al8(dq)};
  sk::kernel<<<dim3((d + sk::NT - 1) / sk::NT, pl.splits2, pl.row_groups), sk::THREADS, 0, s>>>(
      a2);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  qtile::scale_reduce_kernel<float><<<static_cast<unsigned>((md + 255) / 256), 256, 0, s>>>(
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

}  // namespace
}  // namespace fm
}  // namespace ssp

// fp32 workspace (in floats) that ssp_fused_mlp_int8 needs for these shapes; 0 = none.
extern "C" long long ssp_fused_mlp_int8_workspace_floats(int dtype, int m, int d, int f, int wide) {
  return ssp::fm::plan_for(dtype, m, d, f, wide).ws_floats;
}

// int32 ticket counters that ssp_fused_mlp_int8 needs for these shapes (0 =
// none). They must be 0 before the call and are 0 again after it, so one
// zeroed buffer serves every call on a stream.
extern "C" long long ssp_fused_mlp_int8_tickets(int dtype, int m, int d, int f, int wide) {
  return ssp::fm::plan_for(dtype, m, d, f, wide).tickets;
}

// out[m, d] = (silu((x @ gq) * gs) * ((x @ uq) * us)) @ dq * ds, through h [m, f].
// wide = 1 takes the tile pipeline at any m. It is a measurement hook only: the
// yardstick of the weight stream at m <= 16 (bf16 m <= 16 takes the weight
// stream, fp32 m <= 16 the SIMT skinny product). The serving path never sets it.
extern "C" int ssp_fused_mlp_int8(int dtype, const void* x, const void* gq, const float* gs,
                                  const void* uq, const float* us, const void* dq,
                                  const float* ds, void* h, void* out, int m, int d, int f,
                                  int wide, float* workspace, int* tickets, void* stream) {
  using namespace ssp;
  using namespace ssp::fm;
  if (m <= 0 || d <= 0 || f <= 0 || (dtype != kF32 && dtype != kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan pl = plan_for(dtype, m, d, f, wide);
  if ((pl.ws_floats > 0 && workspace == nullptr) || (pl.tickets > 0 && tickets == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* g = static_cast<const signed char*>(gq);
  const auto* u = static_cast<const signed char*>(uq);
  const auto* dn = static_cast<const signed char*>(dq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kF32) {
    auto* hh = static_cast<float*>(h);
    auto* oo = static_cast<float*>(out);
    err = pl.route == Plan::kSkinny
              ? run_skinny(pl, static_cast<const float*>(x), g, gs, u, us, dn, ds, hh, oo, m, d, f,
                           workspace, s)
              : run_wide<float>(pl, x, g, gs, u, us, dn, ds, hh, oo, m, d, f, workspace, s);
  } else {
    auto* hh = static_cast<__nv_bfloat16*>(h);
    auto* oo = static_cast<__nv_bfloat16*>(out);
    if (pl.route == Plan::kStream)
      err = m <= 8 ? sw::run<8>(pl.s1, pl.s2, x, g, gs, u, us, dn, ds, hh, oo, m, d, f, workspace,
                                tickets, s)
                   : sw::run<16>(pl.s1, pl.s2, x, g, gs, u, us, dn, ds, hh, oo, m, d, f, workspace,
                                 tickets, s);
    else
      err = run_wide<__nv_bfloat16>(pl, x, g, gs, u, us, dn, ds, hh, oo, m, d, f, workspace, s);
  }
  return static_cast<int>(err);
}
